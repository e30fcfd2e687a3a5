"""``HybridBlock.hybridize()`` of the port (``gluon/block.py`` ``CachedOp``)
against the JAX build's hybridized blocks, on the CPU, and its contracts
on the card.

Each parity case builds the same block in both packages with explicit
prefixes, draws every parameter from one numpy stream into both (never
``mx.random``: the streams differ), hybridizes both and runs the same
inputs: outputs, gradients of a seeded projection of them for the inputs
and every parameter, and BatchNorm's moving statistics, within 1e-5 of
the largest magnitude in f32.  Mirrors ``tests/test_gluon.py:66-130``.
The port's own contracts: one cache entry per input signature, one tape
node per call (several calls under one ``record()``, shared weights),
second-order gradients, invalidation, inlining of hybridized children,
deferred shapes, dropout's recompute, threads, ``mx.engine.bulk``, and
serving a hybridized block.  The card's tests (``-m cuda``) hold a replay
bit for bit against eager, fresh dropout masks per replay, outputs across
replays, a parameter moved to a new address, an op that splits the graph,
a capture that fails, and two threads on two streams; and ROADMAP C11: a
failed capture replaces the generators registered with it and forgets
every graph that holds one, so ``mx.random`` stays usable.
"""
import threading

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.gluon import block as tblock

REL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = rel * max(1.0, np.abs(want).max())
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= bound, (what, err, bound)


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _flat(o)]
    return [out]


def _load(jnet, tnet, seed=0, scale=0.3):
    """Draw every parameter of ``jnet`` (shapes resolved) from a seeded
    stream, the moving variances positive, and copy them into ``tnet``."""
    rs = np.random.RandomState(seed)
    tparams = tnet.collect_params()
    for name, p in jnet.collect_params().items():
        arr = (rs.standard_normal(p.shape) * scale).astype(np.float32)
        if name.endswith("running_var"):
            arr = np.abs(arr) + 0.5
        p.set_data(jmx.nd.array(arr))
        tparams[name]._load_init(arr, tmx.cpu())


def _pair(build, *probe_inputs, seed=0):
    """(JAX block, port block), both hybridized, with the same weights;
    ``probe_inputs`` resolve the JAX block's deferred shapes in predict
    mode."""
    jnet, tnet = build(jmx), build(tmx)
    jnet.initialize()
    if probe_inputs:
        jnet(*[jmx.nd.array(a) for a in probe_inputs])
    _load(jnet, tnet, seed)
    jnet.hybridize()
    tnet.hybridize()
    return jnet, tnet


def _run(m, net, inputs, fn=None, seed=3, train=True, calls=1):
    """Outputs of ``calls`` calls of ``fn(net, *arrays)`` under one
    ``record()``, the gradients of a seeded projection of all of them for
    each input and parameter, and every parameter after (moving
    statistics)."""
    fn = fn or (lambda net, *a: net(*a))
    arrays = [m.nd.array(a) for a in inputs]
    for a in arrays:
        a.attach_grad()
    rs = np.random.RandomState(seed)
    outs = []
    with m.autograd.record(train_mode=train):
        loss = None
        for _ in range(calls):
            for o in _flat(fn(net, *arrays)):
                outs.append(o)
                term = (o * m.nd.array(rs.standard_normal(o.shape).astype(
                    np.float32))).sum()
                loss = term if loss is None else loss + term
    loss.backward()
    grads = {n: p.grad().asnumpy() for n, p in net.collect_params().items()
             if p.grad_req != "null"}
    params = {n: p.data().asnumpy() for n, p in net.collect_params().items()}
    return ([o.asnumpy() for o in outs], [a.grad.asnumpy() for a in arrays],
            grads, params)


def _compare(jnet, tnet, inputs, **kw):
    want = _run(jmx, jnet, inputs, **kw)
    got = _run(tmx, tnet, inputs, **kw)
    assert len(got[0]) == len(want[0])
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        _close(g, w, what="output %d" % i)
    for g, w in zip(got[1], want[1]):
        _close(g, w, what="input grad")
    assert sorted(got[2]) == sorted(want[2])
    for n in want[2]:
        _close(got[2][n], want[2][n], what=n)
    for n in want[3]:
        _close(got[3][n], want[3][n], what=n)
    return got


def _x(*shape, seed=1):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _mlp(m, prefix="mlp_"):
    net = m.gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(m.gluon.nn.Dense(16, activation="relu"))
        net.add(m.gluon.nn.Dense(4))
    return net


def _convnet(m, prefix="cnn_"):
    nn = m.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Conv2D(8, kernel_size=3, padding=1, activation="relu"))
        net.add(nn.MaxPool2D(2))
        net.add(nn.Conv2D(16, kernel_size=3, padding=1))
        net.add(nn.BatchNorm())
        net.add(nn.Activation("relu"))
        net.add(nn.GlobalAvgPool2D())
        net.add(nn.Flatten())
        net.add(nn.Dense(10))
    return net


# -- tests/test_gluon.py:66-130 against the JAX build --------------------------

def test_deferred_init_and_hybridize_matches_jax():
    """test_gluon.py:66: deferred shapes, eager then hybridized.  The port
    hybridizes before its first call: the CachedOp resolves the deferred
    shapes with one eager pass (JAX block.py:577-579)."""
    x = _x(3, 7)
    jnet = _mlp(jmx)
    jnet.initialize()
    y0 = jnet(jmx.nd.array(x)).asnumpy()
    jnet.hybridize()
    want = jnet(jmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(y0, want, rtol=1e-5, atol=1e-5)
    tnet = _mlp(tmx)
    tnet.initialize()
    tnet.hybridize()
    assert tnet(tmx.nd.array(x)).shape == (3, 4)      # deferred, resolved
    _load(jnet, tnet)
    _close(tnet(tmx.nd.array(x)).asnumpy(), jnet(jmx.nd.array(x)).asnumpy())


def test_hybrid_training_matches_jax():
    """test_gluon.py:79: three SGD steps of a hybridized MLP."""
    def build(m):
        net = m.gluon.nn.HybridSequential(prefix="m_")
        with net.name_scope():
            net.add(m.gluon.nn.Dense(8, activation="relu", in_units=6))
            net.add(m.gluon.nn.Dense(3, in_units=8))
        return net

    jnet, tnet = _pair(build)
    x = _x(4, 6)
    label = np.array([0, 1, 2, 1], np.float32)
    losses = []
    for m, net in ((jmx, jnet), (tmx, tnet)):
        loss_fn = m.gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = m.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 0.1})
        cur = []
        for _ in range(3):
            with m.autograd.record():
                L = loss_fn(net(m.nd.array(x)), m.nd.array(label))
            L.backward()
            trainer.step(4)
            cur.append(float(L.mean().asscalar()))
        losses.append(cur)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    for n, p in jnet.collect_params().items():
        _close(tnet.collect_params()[n].data().asnumpy(), p.data().asnumpy(),
               what=n)


def test_conv_pool_stack_matches_jax():
    """test_gluon.py:109, predict mode and a recorded training call."""
    x = _x(2, 3, 16, 16)
    jnet, tnet = _pair(_convnet, x)
    with tmx.autograd.predict_mode():
        got = tnet(tmx.nd.array(x))
    assert got.shape == (2, 10)
    _close(got.asnumpy(), jnet(jmx.nd.array(x)).asnumpy())
    _compare(jnet, tnet, [x])


def test_batchnorm_moving_stats_match_jax():
    """test_gluon.py:124: one recorded call blends the moving statistics
    once, hybridized as eagerly."""
    def build(m):
        return m.gluon.nn.BatchNorm(in_channels=4, prefix="bn_")

    x = (_x(8, 4, 3, 3) * 3 + 1).astype(np.float32)
    jnet, tnet = _pair(build)
    for m, net in ((jmx, jnet), (tmx, tnet)):
        with m.autograd.record():
            net(m.nd.array(x))
    for n in ("bn_running_mean", "bn_running_var"):
        _close(tnet.collect_params()[n].data().asnumpy(),
               jnet.collect_params()[n].data().asnumpy(), what=n)


def test_conv_batchnorm_training_moving_stats_after_three_calls():
    """Trap a: three recorded training calls with backward; the moving
    statistics blend once a call (not again in the backward's recompute)
    and match the JAX build's and the port's eager run."""
    def build(m):
        nn = m.gluon.nn
        net = nn.HybridSequential(prefix="cb_")
        with net.name_scope():
            net.add(nn.Conv2D(6, 3, padding=1, in_channels=3),
                    nn.BatchNorm(in_channels=6), nn.Activation("relu"),
                    nn.Conv2D(4, 3, padding=1, in_channels=6),
                    nn.BatchNorm(in_channels=4))
        return net

    x = _x(4, 3, 6, 6)
    jnet, tnet = _pair(build)
    eager = build(tmx)
    eager.initialize()
    _load(jnet, eager)
    for _ in range(3):
        got = _compare(jnet, tnet, [x])
        want = _run(tmx, eager, [x])
    for n, v in want[3].items():
        np.testing.assert_array_equal(got[3][n], v, err_msg=n)
    stats = tnet.collect_params()["cb_batchnorm0_running_mean"].data()
    assert np.abs(stats.asnumpy()).max() > 0


def test_lstm_layer_hybridized_matches_jax():
    def build(m):
        return m.gluon.rnn.LSTM(6, num_layers=2, input_size=4,
                                prefix="lstm_")

    jnet, tnet = _pair(build)
    x = _x(5, 3, 4)
    _compare(jnet, tnet, [x])
    # with states: (outputs, [h, c]) through the nested input format
    states = [_x(2, 3, 6, seed=5), _x(2, 3, 6, seed=6)]

    def with_states(net, x, h, c):
        return net(x, [h, c])

    _compare(jnet, tnet, [x] + states, fn=with_states)


def _lm(m, vocab=23, d=16, heads=2, ffn=32, layers=2, seq=8):
    gluon, nn = m.gluon, m.gluon.nn

    class Block(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.ln1 = nn.LayerNorm(in_channels=d)
                self.attn = nn.MultiHeadAttention(d, heads, causal=True,
                                                  use_bias=False)
                self.ln2 = nn.LayerNorm(in_channels=d)
                self.fc1 = nn.Dense(ffn, flatten=False, in_units=d,
                                    use_bias=False)
                self.fc2 = nn.Dense(d, flatten=False, in_units=ffn,
                                    use_bias=False)

        def hybrid_forward(self, F, x):
            x = x + self.attn(self.ln1(x))
            return x + self.fc2(F.Activation(self.fc1(self.ln2(x)),
                                             act_type="relu"))

    class LM(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.embed = nn.Embedding(vocab, d)
                self.pos = self.params.get("pos_embed", shape=(seq, d))
                self.blocks = nn.HybridSequential(prefix="blocks_")
                with self.blocks.name_scope():
                    for _ in range(layers):
                        self.blocks.add(Block())
                self.ln_f = nn.LayerNorm(in_channels=d)
                self.head = nn.Dense(vocab, flatten=False, in_units=d,
                                     use_bias=False)

        def hybrid_forward(self, F, tokens, pos):
            h = self.embed(tokens) + F.expand_dims(pos, axis=0)
            return self.head(self.ln_f(self.blocks(h)))

    return LM(prefix="lm_")


def test_small_transformer_lm_hybridized_matches_jax():
    """B1's path through a hybridized LM: logits and every gradient."""
    tokens = np.random.RandomState(2).randint(0, 23, (2, 8)).astype(
        np.float32)
    jnet, tnet = _pair(_lm, tokens)

    def loss(net, t):
        return net(t)

    want = _run(jmx, jnet, [tokens], fn=loss)
    got = _run(tmx, tnet, [tokens], fn=loss)
    _close(got[0][0], want[0][0], rel=1e-4, what="logits")
    for n in want[2]:
        _close(got[2][n], want[2][n], rel=1e-4, what=n)


class _Multi:
    """A block of several outputs, one nested, and an optional input."""

    @staticmethod
    def build(m):
        class Multi(m.gluon.HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.d = m.gluon.nn.Dense(3, in_units=4)

            def hybrid_forward(self, F, x, y=None):
                h = self.d(x)
                second = h * 2 if y is None else h * y
                return h, [F.tanh(h), second]

        return Multi(prefix="multi_")


def test_several_outputs_and_a_none_input():
    jnet, tnet = _pair(_Multi.build)
    x, y = _x(2, 4), _x(2, 3, seed=4)
    for args in ([x], [x, y]):
        _compare(jnet, tnet, args)
    with tmx.autograd.predict_mode():
        out = tnet(tmx.nd.array(x), None)
    assert isinstance(out, tuple) or isinstance(out, list)
    assert isinstance(out[1], list) and len(out[1]) == 2
    # (x) and (x, y) in training, (x, None) in predict mode
    assert len(tnet._cached_op._entries) == 3


def test_nested_hybridized_children_inline():
    """Trap e: a hybridized child of a hybridized parent runs inside the
    parent's program (one CachedOp call); a child hybridized alone under
    an eager parent has a CachedOp of its own."""
    x = _x(4, 3, 8, 8)
    jnet, tnet = _pair(_convnet, x)
    tblock.reset_cached_op_stats()
    _compare(jnet, tnet, [x])
    assert tblock.cached_op_stats()["calls"] == 1
    assert all(c._cached_op is None for c in tnet._children)
    tnet.hybridize(False)
    tnet[0].hybridize()
    tblock.reset_cached_op_stats()
    _compare(jnet, tnet, [x])
    assert tblock.cached_op_stats()["calls"] == 1
    assert tnet._cached_op is None and tnet[0]._cached_op is not None


def test_three_calls_under_one_record():
    """Trap c: shared weights, three tape nodes, each with its own
    inputs; an unrolled use feeds one call's output to the next."""
    def build(m):
        return m.gluon.nn.Dense(5, in_units=5, activation="tanh",
                                prefix="sh_")

    jnet, tnet = _pair(build)
    x = _x(3, 5)
    _compare(jnet, tnet, [x], calls=3)
    _compare(jnet, tnet, [x], fn=lambda net, a: net(net(net(a))))


def test_second_order_gradient_matches_jax_and_eager():
    """Trap j: ``grad(create_graph=True)`` through a hybridized block, then
    a backward of the gradient's norm."""
    def build(m):
        return m.gluon.nn.Dense(3, in_units=4, prefix="so_")

    jnet, tnet = _pair(build)
    x = _x(2, 4)
    results = []
    tblock.reset_cached_op_stats()
    for m, net in ((jmx, jnet), (tmx, tnet)):
        a = m.nd.array(x)
        a.attach_grad()
        with m.autograd.record():
            y = m.nd.tanh(net(a))
            g = m.autograd.grad([m.nd.sum(y)], [a], create_graph=True,
                                retain_graph=True)[0]
            z = (g * g).sum()
        z.backward()
        results.append((g.asnumpy(), a.grad.asnumpy()))
    _close(results[1][0], results[0][0], what="grad")
    _close(results[1][1], results[0][1], what="grad of grad")
    assert np.abs(results[1][1]).max() > 0
    # on the CPU every backward recomputes eagerly, counted: the
    # create_graph one, then the one z's backward takes through tanh's
    # derivative into the block's output
    assert tblock.cached_op_stats()["eager_backwards"] == 2


def test_invalidation_after_cast_new_child_and_hybridize():
    """Trap g: ``cast``, a new child and a second ``hybridize()`` each give
    a fresh CachedOp; a parameter written in place is read by the next
    call."""
    net = _mlp(tmx)
    net.initialize()
    net.hybridize()
    x = tmx.nd.array(_x(2, 5))
    net(x)
    first = net._cached_op
    assert first is not None and len(first._entries) == 1
    net.hybridize()
    assert net._cached_op is None
    net(x)
    net.add(tmx.gluon.nn.Dense(2))
    net[2].initialize()
    assert net._cached_op is None
    assert net(x).shape == (2, 2)
    net.cast("float16")
    assert net._cached_op is None
    assert net(tmx.nd.array(_x(2, 5), dtype="float16")).dtype == np.float16
    net.cast("float32")
    w = net[0].weight
    before = net(x).asnumpy()
    w.set_data(w.data().asnumpy() * 0.5)
    after = net(x).asnumpy()
    net.hybridize(False)
    np.testing.assert_array_equal(after, net(x).asnumpy())
    assert not np.array_equal(before, after)


def test_load_params_is_read_by_the_next_call(tmp_path):
    net = _mlp(tmx)
    net.initialize()
    net.hybridize()
    x = tmx.nd.array(_x(2, 5))
    want = net(x).asnumpy()
    path = str(tmp_path / "mlp.params")
    net.save_params(path)
    for p in net.collect_params().values():
        p.set_data(np.zeros(p.shape, np.float32))
    assert np.abs(net(x).asnumpy()).max() == 0
    net.load_params(path, tmx.cpu())
    np.testing.assert_array_equal(net(x).asnumpy(), want)


def test_one_cache_entry_per_input_signature():
    net = _mlp(tmx)
    net.initialize()
    net.hybridize()
    for b in (2, 3, 2, 3, 5):
        net(tmx.nd.array(_x(b, 5)))
    assert len(net._cached_op._entries) == 3
    with tmx.autograd.train_mode():
        net(tmx.nd.array(_x(2, 5)))
    assert len(net._cached_op._entries) == 4
    net(tmx.nd.array(_x(2, 5)))
    assert len(net._cached_op._entries) == 4


def test_dropout_recompute_draws_the_forward_mask():
    """Trap b: the backward's recompute draws the mask its forward drew
    (the gradients equal an eager call's from the same seed), and two
    training calls draw two masks."""
    def build():
        nn = tmx.gluon.nn
        net = nn.HybridSequential(prefix="do_")
        with net.name_scope():
            net.add(nn.Dense(32, in_units=8), nn.Dropout(0.5),
                    nn.Dense(3, in_units=32))
        net.initialize()
        return net

    x = _x(6, 8)
    eager, hyb = build(), build()
    for n, p in eager.collect_params().items():
        hyb.collect_params()[n].set_data(p.data().asnumpy())
    hyb.hybridize()
    runs = []
    for net in (eager, hyb):
        tmx.random.seed(11)
        runs.append(_run(tmx, net, [x]))
    for g, w in zip(runs[1][0] + runs[1][1], runs[0][0] + runs[0][1]):
        np.testing.assert_array_equal(g, w)
    for n in runs[0][2]:
        np.testing.assert_array_equal(runs[1][2][n], runs[0][2][n])
    with tmx.autograd.record():
        a, b = hyb(tmx.nd.array(x)), hyb(tmx.nd.array(x))
    assert not np.array_equal(a.asnumpy(), b.asnumpy())


def test_outputs_survive_the_next_call():
    """Trap d."""
    net = _mlp(tmx)
    net.initialize()
    net.hybridize()
    y1 = net(tmx.nd.array(_x(2, 5, seed=1)))
    keep = y1.asnumpy().copy()
    net(tmx.nd.array(_x(2, 5, seed=2)))
    np.testing.assert_array_equal(y1.asnumpy(), keep)


def test_input_written_after_forward_makes_backward_raise():
    net = _mlp(tmx)
    net.initialize()
    net.hybridize()
    x = tmx.nd.array(_x(2, 5))
    x.attach_grad()
    with tmx.autograd.record():
        y = net(x)
    x[:] = 0
    with pytest.raises(RuntimeError, match="in-place"):
        y.backward()


def test_two_threads_get_eager_results():
    """Trap k, on the CPU: two threads calling one hybridized block."""
    net = _convnet(tmx)
    net.initialize()
    xs = [_x(2, 3, 16, 16, seed=s) for s in (1, 2)]
    net(tmx.nd.array(xs[0]))
    want = [net(tmx.nd.array(x)).asnumpy() for x in xs]
    net.hybridize()
    bad = []

    def work(i):
        with tmx.cpu():
            for _ in range(10):
                got = net(tmx.nd.array(xs[i])).asnumpy()
                if not np.array_equal(got, want[i]):
                    bad.append(i)

    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad


def test_call_inside_bulk_flushes_and_matches():
    """Trap l: a hybridized call inside ``mx.engine.bulk`` flushes the open
    segment first and returns what it returns outside."""
    from incubator_mxnet_tpu_torch import engine
    net = _mlp(tmx)
    net.initialize()
    net.hybridize()
    x = tmx.nd.array(_x(2, 5))
    want = net(x * 2 + 1).asnumpy()
    engine.reset_flush_stats()
    with engine.bulk(16):
        h = x * 2 + 1
        assert type(h._slot) is engine._Pending
        got = net(h)
        assert engine.flush_stats()["causes"]["read"] == 1
    np.testing.assert_array_equal(got.asnumpy(), want)


def test_trainers_and_functionalize_inline_the_cached_op():
    """Trap e: ``DataParallelTrainer`` and ``functionalize`` run the
    forward under shadows, never through the CachedOp."""
    net = _mlp(tmx)
    net.initialize()
    net.hybridize()
    x = tmx.nd.array(_x(4, 5))
    net(x)
    tblock.reset_cached_op_stats()
    fn, params = net.serving_fn(x)
    out = fn(params, x._data)
    assert tblock.cached_op_stats()["calls"] == 0
    np.testing.assert_array_equal(out.numpy(), net(x).asnumpy())
    tr = tmx.parallel.DataParallelTrainer(
        net, tmx.gluon.loss.L2Loss(), "sgd", {"learning_rate": 0.1})
    tblock.reset_cached_op_stats()
    tr.step(x, tmx.nd.array(_x(4, 4)))
    assert tblock.cached_op_stats()["calls"] == 0


def test_hybridized_block_served_through_server():
    from incubator_mxnet_tpu_torch import serving
    jnet, tnet = _pair(_mlp, _x(1, 5))
    xs = [_x(5, seed=s) for s in range(5)]
    with serving.Server(max_batch=4, max_wait_ms=3) as srv:
        srv.load("m", block=tnet, example=tmx.nd.array(xs[0][None]))
        outs = [srv.submit("m", x).get(timeout=60) for x in xs]
    for x, y in zip(xs, outs):
        np.testing.assert_array_equal(
            y, tnet(tmx.nd.array(x[None])).asnumpy()[0])
        _close(y, jnet(jmx.nd.array(x[None])).asnumpy()[0])


def test_ops_that_cannot_live_in_a_graph():
    """Trap h and i: the ops registered ``deferrable=False`` split a
    hybridized block's graph; ``RNN`` is one of them (its capture failed
    on the card, see ``ops/rnn.py``'s docstring)."""
    from incubator_mxnet_tpu_torch.ops import registry
    for name in ("_linalg_syevd", "CTCLoss", "RNN"):
        assert not registry.get_op(name).deferrable, name
    assert registry.get_op("FullyConnected").deferrable
    assert registry.get_op("MultiBoxDetection").deferrable


def test_infer_shape_resolves_deferred_shapes():
    """``HybridBlock.infer_shape`` fills the deferred shapes, as MXNet's
    does; the JAX build's leaves them deferred (``forward_eager_infer`` is
    a stub, block.py:513-516; ROADMAP, reference-side faults)."""
    x = _x(3, 7)
    for m in (jmx, tmx):
        net = _mlp(m)
        net.initialize()
        net.infer_shape(m.nd.array(x))
        w = net.collect_params()["mlp_dense0_weight"]
        if m is tmx:
            assert w.shape == (16, 7)
        else:
            assert w.shape == (16, 0)


def test_each_call_is_a_profiler_span(tmp_path):
    """The span ``CachedOp(<block name>)`` holds each hybridized call and
    the op spans of its program."""
    import json
    from incubator_mxnet_tpu_torch import profiler
    net = _mlp(tmx)
    net.initialize()
    net.hybridize()
    x = tmx.nd.array(_x(2, 5))
    net(x)                                   # resolves the deferred shapes
    fname = str(tmp_path / "cached_op.json")
    profiler.set_config(filename=fname, profile_imperative=True)
    profiler.set_state("run")
    try:
        for _ in range(2):
            net(x).asnumpy()
    finally:
        profiler.set_state("stop")
    profiler.dump()
    profiler.dumps(reset=True)
    with open(fname) as f:
        events = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    spans = [e for e in events if e["name"] == "CachedOp(mlp)"]
    assert len(spans) == 2
    fc = [e for e in events if e["name"] == "FullyConnected"]
    assert len(fc) == 4 and all(
        any(s["ts"] <= e["ts"] <= s["ts"] + s["dur"] for s in spans)
        for e in fc)


# -- C11: a failed capture leaves mx.random usable ------------------------------

def test_dropped_generators_are_replaced_and_forgotten():
    """What a failed capture does with the generators registered with it
    (``engine.drop_generators``), driven on the CPU with stand-in entries:
    the device's framework generator is replaced by a fresh one at the
    state given, which the next draw continues from; every cached graph
    (the bulk caches and each CachedOp's forward and backward graphs) that
    registered it goes, with the CachedOp entries keyed on it and a
    backward generator among them."""
    from incubator_mxnet_tpu_torch import engine, random_state
    cpu = torch.device("cpu")
    tmx.random.seed(11)
    gen = random_state.generator(cpu)
    tmx.nd.random.uniform(shape=(5,))
    state = gen.get_state()
    want_gen = torch.Generator()
    want_gen.set_state(state)
    want = torch.rand(4, generator=want_gen)
    other = torch.Generator()
    net = tmx.gluon.nn.Dense(2, in_units=3, prefix="c11_")
    net.initialize()
    net.hybridize()
    net(tmx.nd.ones((1, 3)))
    cop = net._cached_op

    def graph(gens):
        return engine._Graph(lambda xs: xs, [torch.zeros(1)], gens, cpu)
    key = next(iter(cop._entries))      # keyed on the framework generator
    assert key[5] == id(gen)
    live_key = key[:5] + (id(other),) + key[6:]
    cop._entries[live_key] = cop._entries[key]
    cop._graphs.update(dead=graph([gen]), live=graph([other]))
    cop._bwd_graphs.update(dead=graph([gen]))
    cop._bwd_gens.update(dead=gen, live=other)
    engine._replay_cache["dead"] = graph([gen])
    engine._replay_cache["live"] = graph([other])
    engine._seg_vjp_cache["dead"] = graph([gen])
    try:
        engine.drop_generators([gen], [state])
        fresh = random_state.generator(cpu)
        assert fresh is not gen
        assert torch.equal(torch.rand(4, generator=fresh), want)
        assert "dead" not in engine._replay_cache and \
            "dead" not in engine._seg_vjp_cache
        assert "live" in engine._replay_cache
        assert set(cop._graphs) == {"live"} and not cop._bwd_graphs
        assert set(cop._bwd_gens) == {"live"}
        assert list(cop._entries) == [live_key]
    finally:
        engine._replay_cache.pop("live")
        tmx.random.seed(0)


def test_a_seeded_scope_generator_is_replaced_too():
    from incubator_mxnet_tpu_torch import random_state
    cpu = torch.device("cpu")
    with random_state.use_generator(5):
        gen = random_state.generator(cpu)
        state = gen.get_state()
        torch.rand(3, generator=gen)
        fresh = random_state.replace_generator(gen, state)
        assert random_state.generator(cpu) is fresh
        want = torch.Generator()
        want.manual_seed(5)
        assert torch.equal(torch.rand(3, generator=fresh),
                           torch.rand(3, generator=want))
    assert random_state.replace_generator(torch.Generator(), state) is None


# -- the card ------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_card_contracts(card):
    """chip_smoke's contracts of hybridize on the card: a replay bit-equal
    to eager (deterministic algorithms), fresh dropout masks per replay,
    an output surviving the next replay, a moved parameter recaptured and
    read, two threads on two streams, a graph split around an op that
    cannot be captured, and a failed capture raising."""
    import chip_smoke as cs
    res = cs.hybrid_card_contracts(tmx, cs.card_line())
    assert res["ok"], res


@pytest.mark.cuda
def test_card_failed_capture_leaves_random_usable(card):
    """ROADMAP C11 on the card: a hybridized block with Dropout whose
    capture fails at an op registered deferrable=True that waits for the
    card raises MXNetError naming the block; the next ``nd.random.uniform``
    works and equals an eager run of the same calls from the same seed;
    a second hybridized block with Dropout captures and replays bit-equal
    to eager.  The same for a bulk segment (``mx.engine.bulk``)."""
    import chip_smoke as cs
    res = cs.c11_contract(tmx, cs.card_line(), shape=(32, 64))
    for what in ("CachedOp", "bulk"):
        r = res[what]
        assert r["raised"] and r["names_it"], r
        assert r["draw_equal_to_eager"] and r["generator_replaced"], r
        assert r["second_block_bit_equal"] and r["masks_differ"], r
