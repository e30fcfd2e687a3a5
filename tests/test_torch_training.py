"""The training slice in the PyTorch port against the JAX build, on the CPU.

The gate: the decoder LM of bench_transformer.py at the tests' small widths
(tests/test_torch_lm.py ``SMALL``) trains 5 steps from the same f32 weights
(``convert.load_numpy_params``) on the same tokens and labels, with
SoftmaxCrossEntropyLoss and SGD with momentum 0.9 at lr 0.05 (the bench's
optimizer), through ``gluon.Trainer`` (record, backward, step) and through
``DataParallelTrainer`` on a one-device mesh.  Bounds, f32: each step's loss
within 2e-6 relative and every weight within 1e-6 absolute after 5 steps
(the same f32 operations; matrix products and flash attention's two passes
sum in other orders, a few f32 ulps a step).  bf16 compute with f32 master
weights (``dtype='bfloat16'``): each loss within 5e-3 relative and every
weight within 2e-2 absolute, since XLA fuses the jitted step's bf16
elementwise ops and keeps some of their intermediates in f32 where the
port's eager ops round each one (2^-8 relative a rounding), and the
differences compound over 5 steps.

Also: Parameter grad buffers (write, add, null; zero_grad), the Trainer's
kvstore rule, the trainer's dtype rules, and autograd.grad with
create_graph against jax.grad of jax.grad.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.parallel import DataParallelTrainer as JaxDPT
from incubator_mxnet_tpu.parallel import make_mesh as jax_make_mesh
from incubator_mxnet_tpu_torch.convert import load_numpy_params, numpy_params
from incubator_mxnet_tpu_torch.models import TransformerLM

from test_torch_lm import SMALL, _jax_lm

BATCH, STEPS = 2, 5
OPT = {"learning_rate": 0.05, "momentum": 0.9}


@pytest.fixture(scope="module")
def start():
    """(tokens, labels, f32 weights by name) of the JAX model."""
    jmx.random.seed(0)   # set up before conftest's per-test seeding
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, SMALL["vocab"], (BATCH, SMALL["seq_len"]))
    labels = rs.randint(0, SMALL["vocab"],
                        (BATCH, SMALL["seq_len"])).astype(np.float32)
    jnet = _jax_lm(**SMALL)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(tokens))
    params = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    return tokens, labels, params


def _jax_net(params):
    jnet = _jax_lm(**SMALL)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(np.zeros((1, SMALL["seq_len"]))))
    by_suffix = {n.split("_", 1)[1]: a for n, a in params.items()}
    for name, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(by_suffix[name.split("_", 1)[1]]))
    return jnet


def _port_net(params):
    tnet = TransformerLM(**SMALL)
    load_numpy_params(tnet, params, tmx.cpu())
    return tnet


def _by_suffix(net, weights):
    return {n[len(net.prefix):]: a for n, a in weights.items()}


def _compare(jnet, jweights, tnet, tweights, atol):
    want = _by_suffix(jnet, jweights)
    got = _by_suffix(tnet, tweights)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


def test_gluon_trainer_trajectory_matches_jax(start):
    tokens, labels, params = start
    jnet = _jax_net(params)
    jtr = jmx.gluon.Trainer(jnet.collect_params(), "sgd", dict(OPT))
    jloss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    want = []
    for _ in range(STEPS):
        with jmx.autograd.record():
            loss = jloss_fn(jnet(jmx.nd.array(tokens)), jmx.nd.array(labels))
        loss.backward()
        jtr.step(BATCH)
        want.append(loss.asnumpy())
    with tmx.cpu():
        tnet = _port_net(params)
        ttr = tmx.gluon.Trainer(tnet.collect_params(), "sgd", dict(OPT))
        tloss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
        got = []
        for _ in range(STEPS):
            with tmx.autograd.record():
                loss = tloss_fn(tnet(tmx.nd.array(tokens, dtype="int32")),
                                tmx.nd.array(labels))
            loss.backward()
            ttr.step(BATCH)
            got.append(loss.asnumpy())
    assert want[-1].mean() < want[0].mean()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-6, atol=0)
    _compare(jnet, {n: p.data().asnumpy() for n, p in
                    jnet.collect_params().items()},
             tnet, numpy_params(tnet), 1e-6)


def _trainer_run(m, net, tokens, labels, steps, **trainer_kw):
    """``steps`` recorded steps of ``net`` through ``m.gluon.Trainer``;
    returns the trainer and the weights after each step."""
    tr = m.gluon.Trainer(net.collect_params(), "sgd", dict(OPT),
                         **trainer_kw)
    loss_fn = m.gluon.loss.SoftmaxCrossEntropyLoss()
    x = m.nd.array(tokens, dtype="int32")
    y = m.nd.array(labels)
    trail = []
    for _ in range(steps):
        with m.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        tr.step(BATCH)
        trail.append({n: p.data().asnumpy()
                      for n, p in net.collect_params().items()})
    return tr, trail


@pytest.mark.parametrize("update_on_kvstore", [True, False])
def test_gluon_trainer_with_a_store_matches_no_store_and_jax(
        start, update_on_kvstore):
    """``kvstore=mx.kv.create("device")``: the update on the store (push
    the gradients, pull the weights) or here (push and pull the
    gradients).  After every step the weights equal the path without a
    store bit for bit, and after the last the JAX build's Trainer given
    the same store within 1e-6, as the gate test above."""
    tokens, labels, params = start
    jnet = _jax_net(params)
    _, jtrail = _trainer_run(jmx, jnet, tokens, labels, 3,
                             kvstore=jmx.kv.create("device"),
                             update_on_kvstore=update_on_kvstore)
    with tmx.cpu():
        tnet = _port_net(params)
        store = tmx.kv.create("device")
        tr, got = _trainer_run(tmx, tnet, tokens, labels, 3, kvstore=store,
                               update_on_kvstore=update_on_kvstore)
        _, plain = _trainer_run(tmx, _port_net(params), tokens, labels, 3,
                                kvstore=None)
    assert tr._kvstore_obj is store
    assert tr._update_on_kvstore == update_on_kvstore
    assert (store._updater is not None) == update_on_kvstore
    for g, w in zip(got, plain):
        for (n, a), b in zip(sorted(g.items()), [v for _, v in
                                                 sorted(w.items())]):
            np.testing.assert_array_equal(a, b, err_msg=n)
    _compare(jnet, jtrail[-1], tnet, got[-1], 1e-6)


@pytest.mark.parametrize("update_on_kvstore", [True, False])
def test_trainer_states_through_the_store(tmp_path, update_on_kvstore):
    """``save_states``/``load_states`` go through the store when the update
    runs there: a trainer restored from the file continues bit-equal."""
    rs = np.random.RandomState(5)
    w0 = rs.randn(3, 4).astype(np.float32)
    xs = [rs.randn(2, 4).astype(np.float32) for _ in range(4)]

    def make(weight):
        net = tmx.gluon.nn.Dense(3, in_units=4, use_bias=False)
        net.initialize()
        net.weight.set_data(tmx.nd.array(weight))
        tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9},
                               kvstore=tmx.kv.create("device"),
                               update_on_kvstore=update_on_kvstore)
        return net, tr

    def step(net, tr, x):
        with tmx.autograd.record():
            loss = (net(tmx.nd.array(x)) ** 2).sum()
        loss.backward()
        tr.step(2)

    with tmx.cpu():
        a, ta = make(w0)
        for x in xs[:2]:
            step(a, ta, x)
        ta.save_states(str(tmp_path / "t.states"))
        b, tb = make(a.weight.data().asnumpy())
        tb.load_states(str(tmp_path / "t.states"))
        assert tb._update_on_kvstore == update_on_kvstore
        for x in xs[2:]:
            step(a, ta, x)
            step(b, tb, x)
        np.testing.assert_array_equal(b.weight.data().asnumpy(),
                                      a.weight.data().asnumpy())
        if update_on_kvstore:
            assert tb._optimizer is tb._kvstore_obj._updater.optimizer
            with pytest.raises(tmx.MXNetError, match="update_on_kvstore"):
                tb.update(2)


def _dpt_run(start, dtype, optimizer="sgd", opt_params=OPT):
    tokens, labels, params = start
    jnet = _jax_net(params)
    jtr = JaxDPT(jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer,
                 dict(opt_params), mesh=jax_make_mesh({"dp": 1},
                                                      jax.devices()[:1]),
                 dtype=dtype)
    jx = jmx.nd.array(tokens, dtype=np.int32)
    jy = jmx.nd.array(labels)
    want = [float(np.asarray(jtr.step(jx, jy))) for _ in range(STEPS)]
    jtr.sync_params()
    with tmx.cpu():
        tnet = _port_net(params)
        mesh = tmx.parallel.make_mesh({"dp": 1}, [tmx.cpu()])
        ttr = tmx.parallel.DataParallelTrainer(
            tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer,
            dict(opt_params), mesh=mesh, dtype=dtype)
        x = tmx.nd.array(tokens, dtype="int32")
        y = tmx.nd.array(labels)
        got = []
        for _ in range(STEPS):
            loss = ttr.step(x, y)
            assert loss.shape == () and loss.dtype == np.float32
            got.append(float(loss.asscalar()))
        before_sync = numpy_params(tnet)
        ttr.sync_params()
    # the Block keeps its weights until sync_params
    given = {n.split("_", 1)[1]: a for n, a in params.items()}
    for k, a in before_sync.items():
        np.testing.assert_array_equal(a, given[k[len(tnet.prefix):]])
    return jnet, tnet, want, got


# Adam divides by sqrt(v) + epsilon: at the default 1e-8 a weight whose
# gradient is near 1e-8 moves by lr·g/(|g| + 1e-8), where an f32 ulp of g
# moves the step by percents; epsilon 1e-3 keeps the step's relative error
# that of the gradient
@pytest.mark.parametrize("optimizer,opt_params", [
    ("sgd", OPT), ("adam", {"learning_rate": 0.003, "wd": 0.01,
                            "epsilon": 1e-3})],
    ids=["sgd_momentum", "adam"])
def test_data_parallel_trainer_trajectory_matches_jax_f32(start, optimizer,
                                                         opt_params):
    jnet, tnet, want, got = _dpt_run(start, None, optimizer, opt_params)
    assert want[-1] < want[0]
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)
    _compare(jnet, {n: p.data().asnumpy() for n, p in
                    jnet.collect_params().items()},
             tnet, numpy_params(tnet), 1e-6)


def test_data_parallel_trainer_bf16_stays_near_jax(start):
    jnet, tnet, want, got = _dpt_run(start, "bfloat16")
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=0)
    _compare(jnet, {n: p.data().asnumpy() for n, p in
                    jnet.collect_params().items()},
             tnet, numpy_params(tnet), 2e-2)


def test_data_parallel_trainer_dtype_rules(start, monkeypatch):
    """bf16 compute: trainable f32 weights enter the forward in bf16 and
    their gradients come back in f32; a frozen weight is never cast; int32
    ids are never cast; the output reaches the loss in f32."""
    tokens, labels, params = start
    seen = {}
    with tmx.cpu():
        tnet = _port_net(params)
        frozen = tnet.ln_f.gamma
        frozen.grad_req = "null"
        embed = tnet.embed

        def spy_embed(F, x, weight):
            seen["ids"], seen["table"] = x._data.dtype, weight._data.dtype
            return F.Embedding(x, weight, **embed._kwargs)
        monkeypatch.setattr(embed, "hybrid_forward", spy_embed)
        ln_f = tnet.ln_f

        def spy_ln(F, x, gamma, beta):
            seen["gamma"], seen["beta"] = gamma._data.dtype, beta._data.dtype
            return F.LayerNorm(x, gamma, beta, **ln_f._kwargs)
        monkeypatch.setattr(ln_f, "hybrid_forward", spy_ln)

        class SpyLoss(tmx.gluon.loss.SoftmaxCrossEntropyLoss):
            def hybrid_forward(self, F, pred, label, sample_weight=None):
                seen["pred"] = pred._data.dtype
                return super().hybrid_forward(F, pred, label)

        ttr = tmx.parallel.DataParallelTrainer(tnet, SpyLoss(), "sgd",
                                               dict(OPT), dtype="bfloat16")
        ttr.step(tmx.nd.array(tokens, dtype="int32"), tmx.nd.array(labels))
    assert seen == {"ids": torch.int32, "table": torch.bfloat16,
                    "gamma": torch.float32, "beta": torch.bfloat16,
                    "pred": torch.float32}
    name = frozen.name
    assert name not in ttr._trainable and ttr._params[name].dtype == \
        torch.float32
    assert all(s[0].dtype == torch.float32 for s in ttr._opt_state.values())


def test_data_parallel_trainer_learning_rate_and_mesh(start):
    _, _, params = start
    with tmx.cpu():
        tnet = _port_net(params)
        ttr = tmx.parallel.DataParallelTrainer(
            tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", dict(OPT))
        assert ttr.learning_rate == 0.05
        ttr.set_learning_rate(0.01)
        assert ttr.learning_rate == 0.01
        two = tmx.parallel.make_mesh({"dp": 2}, [tmx.cpu(0), tmx.cpu(1)])
        with pytest.raises(tmx.MXNetError, match="Queue A item 7"):
            tmx.parallel.DataParallelTrainer(
                tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), mesh=two)
    with pytest.raises(ValueError):
        tmx.parallel.pure_optimizer("rmsprop")


# ---------------------------------------------------------------------------
# Parameter grad buffers and the Trainer around them
# ---------------------------------------------------------------------------

def _dense_grads(mx, req, steps):
    net = mx.gluon.nn.Dense(3, in_units=4, prefix="fc_")
    net.initialize(mx.init.Xavier())
    w = net.collect_params()["fc_weight"]
    w.set_data(mx.nd.array(np.arange(12, dtype=np.float32).reshape(3, 4)
                           / 10))
    w.grad_req = req
    x = mx.nd.array(np.random.RandomState(1).standard_normal((2, 4))
                    .astype(np.float32))
    for _ in range(steps):
        with mx.autograd.record():
            y = net(x)
        y.backward()
    return net, w


@pytest.mark.parametrize("req", ["write", "add"])
def test_parameter_grad_buffers_match_jax(req):
    _, jw = _dense_grads(jmx, req, 3)
    with tmx.cpu():
        net, tw = _dense_grads(tmx, req, 3)
        np.testing.assert_allclose(tw.grad().asnumpy(), jw.grad().asnumpy(),
                                   rtol=1e-6, atol=1e-6)
        assert len(tw.list_grad()) == 1 and tw.list_grad()[0] is tw.grad()
        net.collect_params().zero_grad()
        assert not tw.grad().asnumpy().any()
        jw.zero_grad()
        assert not jw.grad().asnumpy().any()


def test_parameter_grad_req_null():
    with tmx.cpu():
        _, w = _dense_grads(tmx, "null", 1)
        with pytest.raises(RuntimeError, match="grad_req='null'"):
            w.grad()
        with pytest.raises(RuntimeError, match="grad_req='null'"):
            w.list_grad()
        assert not w.data()._data.requires_grad
        w.grad_req = "write"
        assert not w.grad().asnumpy().any()
        with pytest.raises(ValueError):
            w.grad_req = "sometimes"
        w.zero_grad()


def test_trainer_kvstore_rule_and_learning_rate():
    with tmx.cpu():
        net = tmx.gluon.nn.Dense(2, in_units=3)
        net.initialize()
        for kv in ("device", "local", None):
            tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1}, kvstore=kv)
            tr.step(1)      # no store: nothing to reduce, the update runs
            assert tr._kvstore_obj is None and not tr._update_on_kvstore
        store = tmx.kv.create("local")
        tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1}, kvstore=store)
        tr.step(1)          # a store object: the update runs on it
        assert tr._kvstore_obj is store and tr._update_on_kvstore
        tr.set_learning_rate(0.2)
        assert tr.learning_rate == 0.2
        tr = tmx.gluon.Trainer(net.collect_params(), "sgd", kvstore="dist_sync")
        with pytest.raises(tmx.MXNetError, match="item 7"):
            tr.step(1)


def test_trace_params_runs_the_forward_on_shadows():
    with tmx.cpu():
        net = tmx.gluon.nn.Dense(2, in_units=3, use_bias=False, prefix="d_")
        net.initialize()
        x = tmx.nd.array(np.ones((1, 3), np.float32))
        shadow = {"d_weight": tmx.nd.array(np.full((2, 3), 2.0, np.float32))}
        with net._trace_params(shadow):
            np.testing.assert_array_equal(net(x).asnumpy(), [[6.0, 6.0]])
        assert net._trace_shadows is None
        assert not np.array_equal(net(x).asnumpy(), [[6.0, 6.0]])


def test_second_order_grad_matches_jax():
    """autograd.grad(create_graph=True), then backward through the
    gradient: against jax.grad of jax.grad of the same function."""
    xs = np.array([0.3, -1.2, 0.8, 2.0], np.float32)
    ws = np.array([1.0, -0.5, 2.0, 0.25], np.float32)

    def f(x):
        return (jnp.tanh(x) * x * x).sum()
    want = np.asarray(jax.grad(lambda x: (jax.grad(f)(x) * ws).sum())(
        jnp.asarray(xs)))
    with tmx.cpu():
        x = tmx.nd.array(xs)
        x.attach_grad()
        with tmx.autograd.record():
            y = tmx.nd.sum(tmx.nd.Activation(x, act_type="tanh") * x * x)
            (g1,) = tmx.autograd.grad(y, [x], create_graph=True)
            z = tmx.nd.sum(g1 * tmx.nd.array(ws))
        z.backward()
        np.testing.assert_allclose(x.grad.asnumpy(), want, rtol=1e-5,
                                   atol=1e-6)
        # third order: d/dx of sum(d²/dx² sum(x⁴)) = 24x
        x2 = tmx.nd.array(xs)
        x2.attach_grad()
        with tmx.autograd.record():
            y = tmx.nd.sum(x2 * x2 * x2 * x2)
            (g1,) = tmx.autograd.grad(y, [x2], create_graph=True)
            (g2,) = tmx.autograd.grad(tmx.nd.sum(g1), [x2],
                                      create_graph=True)
            w = tmx.nd.sum(g2)
        w.backward()
        np.testing.assert_allclose(x2.grad.asnumpy(), 24 * xs, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
def test_card_data_parallel_trainer_matches_cpu(start, dtype):
    """The same 3 steps on the card (flash kernel forward, ported backward,
    TF32 off) and on the CPU: f32 losses within 1e-5 relative and weights
    within 1e-4 (products in other orders); bf16 compute within the bf16
    bounds of the JAX comparison (5e-3, 2e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tokens, labels, params = start
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = []
        for ctx in (tmx.cpu(), tmx.gpu(0)):
            with ctx:
                net = TransformerLM(**SMALL)
                load_numpy_params(net, params, ctx)
                tr = tmx.parallel.DataParallelTrainer(
                    net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                    dict(OPT), dtype=dtype)
                x = tmx.nd.array(tokens, dtype="int32")
                y = tmx.nd.array(labels)
                losses = [float(tr.step(x, y).asscalar()) for _ in range(3)]
                tr.sync_params()
                runs.append((losses, {n.split("_", 1)[1]: a for n, a in
                                      numpy_params(net).items()}))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    (want_l, want_w), (got_l, got_w) = runs
    rtol, atol = (1e-5, 1e-4) if dtype is None else (5e-3, 2e-2)
    np.testing.assert_allclose(got_l, want_l, rtol=rtol, atol=0)
    for k in want_w:
        np.testing.assert_allclose(got_w[k], want_w[k], rtol=0, atol=atol,
                                   err_msg=k)
