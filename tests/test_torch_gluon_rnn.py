"""``gluon.rnn``, ``gluon.contrib.rnn`` and Gluon's ``CTCLoss`` of the port
against the JAX build, on the CPU.

Each case builds the same block in both packages with explicit prefixes,
draws every parameter from one numpy stream into the JAX block and copies
it into the port's by name, then runs the same inputs: outputs and final
states, and the gradients of a random projection of them with respect to
the input and every parameter.  Bound: 1e-5 of the largest magnitude of
each array, in f32.  Mirrors ``tests/test_gluon.py:192, :287, :308, :331``
and ``tests/test_gluon_contrib.py:27``; dropout and zoneout are held in
inference (masks cannot match ``jax.random``) and by their own contracts in
training.  Also ``convert.load_numpy_params`` on a layer and a cell, a
layer inside ``mx.engine.bulk``, and ``bench_lstm.py``'s net and
``word_lm.py``'s loop trained 3 steps at a small size against the JAX
build.

The JAX build's ``unroll`` with ``valid_length`` under layout ``NTC``
returns (T, N, C) and its ``BidirectionalCell`` raises there (ROADMAP,
reference-side faults); the port returns MXNet's (N, T, C), held against
the JAX build's transposed.
"""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.convert import load_numpy_params

REL = 1e-5
T, N, C, H = 5, 3, 4, 6


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


def _pair(build, seed=0, scale=0.3, probe=None):
    """(JAX block, port block) built by ``build(m)``; the JAX block's
    parameters drawn from a seeded stream (after ``probe(m, net)`` resolved
    deferred shapes), the port's copied from them by name."""
    jnet, tnet = build(jmx), build(tmx)
    jnet.initialize()
    if probe is not None:
        probe(jmx, jnet)
    rs = np.random.RandomState(seed)
    jparams = jnet.collect_params()
    tparams = tnet.collect_params()
    assert list(jparams.keys()) == list(tparams.keys())
    for name, p in jparams.items():
        arr = (rs.standard_normal(p.shape) * scale).astype(np.float32)
        p.set_data(jmx.nd.array(arr))
        tparams[name]._load_init(arr, tmx.cpu())
    return jnet, tnet


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _flat(o)]
    return [out]


def _run(m, net, fn, inputs, seed=3, train=False):
    """Outputs of ``fn(m, net, *arrays)``, and the gradients of a seeded
    random projection of them for each input and parameter."""
    arrays = [m.nd.array(a) for a in inputs]
    for a in arrays:
        a.attach_grad()
    rs = np.random.RandomState(seed)
    with m.autograd.record(train_mode=train):
        outs = _flat(fn(m, net, *arrays))
        loss = None
        for o in outs:
            term = (o * m.nd.array(rs.standard_normal(o.shape).astype(
                np.float32))).sum()
            loss = term if loss is None else loss + term
    loss.backward()
    grads = {n: p.grad().asnumpy() for n, p in net.collect_params().items()
             if p.grad_req != "null"}
    return ([o.asnumpy() for o in outs], [a.grad.asnumpy() for a in arrays],
            grads)


def _compare(build, fn, inputs, probe=None):
    jnet, tnet = _pair(build, probe=probe)
    want = _run(jmx, jnet, fn, inputs)
    got = _run(tmx, tnet, fn, inputs)
    assert len(got[0]) == len(want[0])
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        _close(g, w, what="output %d" % i)
    for g, w in zip(got[1], want[1]):
        _close(g, w, what="input grad")
    assert sorted(got[2]) == sorted(want[2])
    for n in want[2]:
        _close(got[2][n], want[2][n], what=n)
    return got


def _seq(layout, seed=1, t=T, n=N, c=C):
    shape = (t, n, c) if layout == "TNC" else (n, t, c)
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


LAYERS = [("RNN", dict(activation="relu")), ("RNN", dict(activation="tanh")),
          ("LSTM", {}), ("GRU", {})]


@pytest.mark.parametrize("bidirectional", (False, True))
@pytest.mark.parametrize("layout", ("TNC", "NTC"))
@pytest.mark.parametrize("kind,kw", LAYERS,
                         ids=["rnn_relu", "rnn_tanh", "lstm", "gru"])
def test_layer_matches_jax(kind, kw, layout, bidirectional):
    def build(m):
        return getattr(m.gluon.rnn, kind)(
            H, num_layers=2, layout=layout, bidirectional=bidirectional,
            input_size=C, prefix="layer_", **kw)

    x = _seq(layout)
    got = _compare(build, lambda m, net, x: net(x), [x])
    assert got[0][0].shape == x.shape[:2] + ((1 + bidirectional) * H,)


@pytest.mark.parametrize("kind", ("LSTM", "GRU"))
def test_layer_with_states_matches_jax(kind):
    """``layer(x, states)`` returns (outputs, [hy, cy]): given states
    and their gradients too."""
    def build(m):
        return getattr(m.gluon.rnn, kind)(H, num_layers=2, input_size=C,
                                         bidirectional=True, prefix="st_")

    n_states = 2 if kind == "LSTM" else 1
    rs = np.random.RandomState(4)
    states = [rs.standard_normal((4, N, H)).astype(np.float32)
              for _ in range(n_states)]
    got = _compare(build, lambda m, net, x, *s: net(x, list(s)),
                   [_seq("TNC")] + states)
    assert len(got[0]) == 1 + n_states


def test_layer_deferred_input_size_matches_jax():
    def build(m):
        return m.gluon.rnn.LSTM(H, num_layers=2, layout="NTC",
                                prefix="deferred_")

    x = _seq("NTC")
    _compare(build, lambda m, net, x: net(x), [x],
             probe=lambda m, net: net(m.nd.array(x)))


@pytest.mark.parametrize("cell,kw", [("RNNCell", dict(activation="relu")),
                                     ("RNNCell", {}), ("LSTMCell", {}),
                                     ("GRUCell", {})],
                         ids=["rnn_relu", "rnn_tanh", "lstm", "gru"])
@pytest.mark.parametrize("layout", ("TNC", "NTC"))
def test_cell_unroll_matches_jax(cell, kw, layout):
    def build(m):
        return getattr(m.gluon.rnn, cell)(H, input_size=C, prefix="cell_",
                                         **kw)

    got = _compare(build, lambda m, net, x: net.unroll(
        T, x, layout=layout, merge_outputs=True), [_seq(layout)])
    assert got[0][0].shape == _seq(layout).shape[:2] + (H,)


def test_cell_step_and_unmerged_unroll_match_jax():
    """One step by ``cell(x, states)`` and an unroll into a list."""
    def build(m):
        return m.gluon.rnn.LSTMCell(H, input_size=C, prefix="step_")

    step_in = _seq("TNC")[0]
    _compare(build, lambda m, net, x, h, c: net(x, [h, c]),
             [step_in, step_in[:, :1].repeat(H, 1), step_in[:, 1:2].repeat(
                 H, 1)])
    got = _compare(build, lambda m, net, x: net.unroll(
        T, x, layout="NTC", merge_outputs=False), [_seq("NTC")])
    assert len(got[0]) == T + 2


def test_sequential_residual_dropout_zoneout_match_jax_in_inference():
    def build(m):
        r = m.gluon.rnn
        stack = r.SequentialRNNCell(prefix="seq_")
        with stack.name_scope():
            stack.add(r.LSTMCell(H, input_size=C, prefix="a_"))
            stack.add(r.DropoutCell(0.5, prefix="d_"))
            stack.add(r.ResidualCell(r.GRUCell(H, input_size=H,
                                               prefix="b_")))
            stack.add(r.ZoneoutCell(r.RNNCell(H, input_size=H, prefix="c_"),
                                    zoneout_outputs=0.3, zoneout_states=0.2))
        return stack

    got = _compare(build, lambda m, net, x: net.unroll(
        T, x, layout="NTC", merge_outputs=True), [_seq("NTC")])
    assert len(got[0]) == 1 + 4


@pytest.mark.parametrize("layout", ("TNC", "NTC"))
def test_bidirectional_cell_matches_jax(layout):
    def build(m):
        r = m.gluon.rnn
        return r.BidirectionalCell(r.LSTMCell(H, input_size=C, prefix="l_"),
                                   r.GRUCell(H, input_size=C, prefix="r_"))

    got = _compare(build, lambda m, net, x: net.unroll(
        T, x, layout=layout, merge_outputs=True), [_seq(layout)])
    assert got[0][0].shape[-1] == 2 * H and len(got[0]) == 1 + 2 + 1


VALID = np.array([3, 5, 1], np.float32)


def _unroll_blocked_states(layout):
    """``unroll`` with ``valid_length``; the final states through
    ``BlockGrad`` (the JAX build's come off the tape: ROADMAP,
    reference-side faults)."""
    def fn(m, net, x, vl):
        out, states = net.unroll(T, x, layout=layout, valid_length=vl)
        if m is jmx and layout == "NTC":   # its (T, N, C) as MXNet's
            out = m.nd.swapaxes(out, dim1=0, dim2=1)
        return [out] + [m.nd.BlockGrad(s) for s in states]
    return fn


@pytest.mark.parametrize("layout", ("TNC", "NTC"))
def test_unroll_valid_length_matches_jax(layout):
    """Steps past each sequence's length give 0, and each final state is
    the one at the sequence's last valid step, whose gradient reaches the
    steps before it in the port."""
    def build(m):
        return m.gluon.rnn.LSTMCell(H, input_size=C, prefix="vl_")

    got = _compare(build, _unroll_blocked_states(layout),
                   [_seq(layout), VALID])
    out = got[0][0] if layout == "TNC" else got[0][0].swapaxes(0, 1)
    for i, n in enumerate(VALID.astype(int)):
        assert not out[n:, i].any() and out[n - 1, i].any()
    _, tnet = _pair(build)
    _, grads, _ = _run(tmx, tnet, lambda m, net, x, vl: net.unroll(
        T, x, layout="TNC", valid_length=vl)[1], [_seq("TNC"), VALID])
    for i, n in enumerate(VALID.astype(int)):
        assert grads[0][:n, i].all() and not grads[0][n:, i].any()


def test_bidirectional_valid_length_matches_jax():
    """TNC against the JAX build; NTC (where the JAX build raises) against
    the port's own TNC run."""
    def build(m):
        r = m.gluon.rnn
        return r.BidirectionalCell(r.LSTMCell(H, input_size=C, prefix="l_"),
                                   r.LSTMCell(H, input_size=C, prefix="r_"))

    x = _seq("TNC")
    got = _compare(build, _unroll_blocked_states("TNC"), [x, VALID])
    jnet, tnet = _pair(build)
    ntc = _run(tmx, tnet, _unroll_blocked_states("NTC"),
               [x.swapaxes(0, 1), VALID])
    _close(ntc[0][0].swapaxes(0, 1), got[0][0])
    for g, w in zip(ntc[0][1:], got[0][1:]):
        _close(g, w)
    with pytest.raises(TypeError):
        jnet.unroll(T, jmx.nd.array(x.swapaxes(0, 1)), layout="NTC",
                    valid_length=jmx.nd.array(VALID))


def test_residual_cell_unroll_matches_jax():
    def build(m):
        return m.gluon.rnn.ResidualCell(m.gluon.rnn.GRUCell(
            C, input_size=C, prefix="res_"))

    for merge in (True, False):
        _compare(build, lambda m, net, x: net.unroll(
            T, x, layout="NTC", merge_outputs=merge), [_seq("NTC")])


def test_layer_matches_unrolled_cells():
    """The fused layer and the same weights unrolled as cells, layer by
    layer (cuDNN's gate order is the cells' slicing): test_gluon.py:308
    for LSTM and GRU, two layers, both directions."""
    x = tmx.nd.array(_seq("TNC"))
    for kind, cell in (("LSTM", "LSTMCell"), ("GRU", "GRUCell")):
        layer = getattr(tmx.gluon.rnn, kind)(H, num_layers=2, input_size=C,
                                             bidirectional=True, prefix="f_")
        layer.initialize(tmx.init.Xavier())
        lp = layer.collect_params()
        want = x
        for i, c_in in enumerate((C, 2 * H)):
            bi = tmx.gluon.rnn.BidirectionalCell(*[
                getattr(tmx.gluon.rnn, cell)(H, input_size=c_in,
                                             prefix="%s%d_" % (d, i))
                for d in "lr"])
            bi.initialize()
            for name, p in bi.collect_params().items():
                p.set_data(lp["f_" + name].data())
            want, _ = bi.unroll(T, want, layout="TNC", merge_outputs=True)
        _close(layer(x).asnumpy(), want.asnumpy())


def test_begin_state_and_surface():
    layer = tmx.gluon.rnn.LSTM(H, num_layers=3, bidirectional=True)
    st = layer.begin_state(2, ctx=tmx.cpu())
    assert [s.shape for s in st] == [(6, 2, H)] * 2
    assert layer.state_info(2)[0]["__layout__"] == "LNC"
    cell = tmx.gluon.rnn.LSTMCell(H)
    assert [s.shape for s in cell.begin_state(4)] == [(4, H), (4, H)]
    with pytest.raises(NotImplementedError):
        tmx.gluon.rnn.BidirectionalCell(cell, tmx.gluon.rnn.LSTMCell(H))(
            None, [])
    with pytest.raises(AssertionError):
        tmx.gluon.rnn.LSTM(H, layout="TCN")
    z = tmx.gluon.rnn.ZoneoutCell(tmx.gluon.rnn.RNNCell(H))
    with pytest.raises(AssertionError):
        z.base_cell.begin_state(2)
    assert len(z.begin_state(batch_size=2)) == 1
    public = [{n for n in dir(m.gluon.rnn) if not n.startswith("_")}
              for m in (tmx, jmx)]
    assert public[0] >= public[1] - {"rnn_cell", "rnn_layer"}


def test_zoneout_and_dropout_cells_in_training():
    """Training draws: the same seed repeats a run; zoneout keeps the
    previous output where its mask is 0, dropout zeroes."""
    x = tmx.nd.array(_seq("NTC", t=8, n=16, c=H))

    def run(cell, seed):
        tmx.random.seed(seed)
        with tmx.autograd.train_mode():
            return cell.unroll(8, x, layout="NTC", merge_outputs=True)[
                0].asnumpy()

    z = tmx.gluon.rnn.ZoneoutCell(tmx.gluon.rnn.RNNCell(H, input_size=H),
                                  zoneout_outputs=0.5)
    z.initialize()
    a, b = run(z, 1), run(z, 1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, run(z, 2))
    kept_prev = (a[:, 1:] == a[:, :-1]).mean()
    assert 0.3 < kept_prev < 0.7
    d = tmx.gluon.rnn.DropoutCell(0.5)
    out = run(d, 3)
    assert 0.4 < (out == 0).mean() < 0.6


def test_lstmp_cell_matches_jax():
    def build(m):
        return m.gluon.contrib.rnn.LSTMPCell(hidden_size=8, projection_size=3,
                                             input_size=C, prefix="p_")

    got = _compare(build, lambda m, net, x: net.unroll(
        T, x, layout="NTC", merge_outputs=True), [_seq("NTC")])
    assert got[0][0].shape == (N, T, 3)
    assert got[0][1].shape == (N, 3) and got[0][2].shape == (N, 8)


def test_variational_dropout_cell():
    """test_gluon_contrib.py:27 in the port, and the JAX build's result in
    inference."""
    def build(m):
        return m.gluon.contrib.rnn.VariationalDropoutCell(
            m.gluon.rnn.RNNCell(6, input_size=4, prefix="v_"),
            drop_inputs=0.3, drop_states=0.3, drop_outputs=0.5)

    x = np.random.RandomState(2).randn(2, 3, 4).astype(np.float32)
    _compare(build, lambda m, net, x: net.unroll(
        3, x, layout="NTC", merge_outputs=True), [x])
    vd = build(tmx)
    vd.initialize(tmx.init.Xavier())
    with tmx.autograd.record(train_mode=True):
        outs, _ = vd.unroll(3, tmx.nd.array(x), merge_outputs=False)
    masks = [(o.asnumpy() == 0) for o in outs]
    assert masks[0].sum() > 0
    assert all((m == masks[0]).all() for m in masks[1:])
    first = vd.drop_outputs_mask
    with tmx.autograd.record(train_mode=True):
        vd.unroll(3, tmx.nd.array(x), merge_outputs=False)
    assert vd.drop_outputs_mask is not first
    assert repr(vd) == "VariationalDropoutCell(p_in=0.3, p_state=0.3, " \
        "p_out=0.5)"


@pytest.mark.parametrize("lengths", (False, True))
def test_ctc_loss_block_matches_jax(lengths):
    """Gluon's CTCLoss at TNC/NT against the JAX build; NTC and TN (where
    the JAX build's ``F.swapaxes(pred, 0, 1)`` raises: ROADMAP,
    reference-side faults) against the port's TNC/NT results."""
    rs = np.random.RandomState(5)
    pred = rs.standard_normal((10, N, 5)).astype(np.float32)
    label = np.array([[1, 2, 2, 0], [3, 0, 0, 0], [4, 1, 3, 2]], np.float32)
    rest = [np.array([10, 7, 9], np.float32),
            np.array([3, 1, 4], np.float32)] if lengths else []

    def build(layout, label_layout):
        return lambda m: m.gluon.loss.CTCLoss(layout, label_layout,
                                              weight=0.5)

    def fn(m, net, *a):
        return net(*a)

    got = _compare(build("TNC", "NT"), fn, [pred, label] + rest)
    assert got[0][0].shape == (N,)
    for layout, label_layout in (("NTC", "NT"), ("TNC", "TN"),
                                 ("NTC", "TN")):
        p = pred.swapaxes(0, 1).copy() if layout == "NTC" else pred
        lab = label.T.copy() if label_layout == "TN" else label
        _, tnet = _pair(build(layout, label_layout))
        other = _run(tmx, tnet, fn, [p, lab] + rest)
        _close(other[0][0], got[0][0])
        _close(other[1][0], got[1][0].swapaxes(0, 1)
               if layout == "NTC" else got[1][0])
    with pytest.raises(TypeError):
        jmx.gluon.loss.CTCLoss()(jmx.nd.array(pred.swapaxes(0, 1)),
                                 jmx.nd.array(label))


def test_load_numpy_params_carries_a_layer_and_a_cell():
    """Weights leave the JAX build as host arrays by name and enter the
    port's auto-named layer and cell (deferred shapes included): the two
    packages then compute the same outputs."""
    x = _seq("NTC")
    for build in (lambda m: m.gluon.rnn.GRU(H, num_layers=2, layout="NTC"),
                  lambda m: m.gluon.rnn.LSTMCell(H)):
        jnet = build(jmx)
        jnet.initialize(jmx.init.Xavier())
        run = (lambda m, net: net(m.nd.array(x))) if isinstance(
            jnet, jmx.gluon.rnn.GRU) else (lambda m, net: net.unroll(
                T, m.nd.array(x), layout="NTC", merge_outputs=True)[0])
        want = run(jmx, jnet).asnumpy()
        tnet = build(tmx)
        load_numpy_params(tnet, {n: p.data().asnumpy() for n, p in
                                 jnet.collect_params().items()}, tmx.cpu())
        _close(run(tmx, tnet).asnumpy(), want)


def test_layer_inside_bulk_is_bit_equal_to_eager():
    """A gluon.rnn.LSTM between deferred ops in ``mx.engine.bulk``: the
    RNN op runs eagerly there (not deferrable), bit-equal to a run outside
    any scope, forward and backward."""
    layer = tmx.gluon.rnn.LSTM(H, num_layers=2, layout="NTC", input_size=C)
    layer.initialize(tmx.init.Xavier())
    x = tmx.nd.array(_seq("NTC"))

    def step(bulk):
        x.attach_grad()
        with tmx.autograd.record():
            if bulk:
                with tmx.engine.bulk(64):
                    y = (layer(x * 2.0) + 1.0).sum()
            else:
                y = (layer(x * 2.0) + 1.0).sum()
        y.backward()
        return y.asnumpy(), x.grad.asnumpy(), \
            layer.l0_i2h_weight.grad().asnumpy()

    for got, want in zip(step(True), step(False)):
        np.testing.assert_array_equal(got, want)


# bench_lstm.py's net and word_lm.py's loop at a small size
SMALL_LM = dict(vocab=40, embed=8, hidden=12, seq=6, batch=4)


def word_lm(m, vocab, embed, hidden, layers=2, prefix="wordlm_"):
    """bench_lstm.py:40-52 and word_lm.py:55-65's net, in package ``m``."""
    class WordLM(m.gluon.HybridBlock):
        def __init__(self):
            super().__init__(prefix=prefix)
            with self.name_scope():
                self.embed = m.gluon.nn.Embedding(vocab, embed)
                self.lstm = m.gluon.rnn.LSTM(hidden, num_layers=layers,
                                             layout="NTC", input_size=embed)
                self.proj = m.gluon.nn.Dense(vocab, flatten=False,
                                             in_units=hidden)

        def hybrid_forward(self, F, x):
            return self.proj(self.lstm(self.embed(x)))

    return WordLM()


def _lm_data(seed=0):
    rs = np.random.RandomState(seed)
    s = SMALL_LM
    shape = (3, s["batch"], s["seq"])
    return rs.randint(0, s["vocab"], shape), \
        rs.randint(0, s["vocab"], shape).astype(np.float32)


def test_bench_lstm_net_trains_like_jax():
    """bench_lstm.py's step (DataParallelTrainer, SoftmaxCrossEntropyLoss,
    sgd at lr 0.5) 3 times, f32: each loss within 1e-5 relative, every
    weight after within 1e-5."""
    from incubator_mxnet_tpu.parallel import DataParallelTrainer as JaxDPT
    from incubator_mxnet_tpu.parallel import make_mesh
    import jax
    s = SMALL_LM
    jnet, tnet = _pair(lambda m: word_lm(m, s["vocab"], s["embed"],
                                         s["hidden"]))
    xs, ys = _lm_data()
    jtr = JaxDPT(jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                 {"learning_rate": 0.5},
                 mesh=make_mesh({"dp": 1}, jax.devices()[:1]))
    ttr = tmx.parallel.DataParallelTrainer(
        tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        {"learning_rate": 0.5})
    for x, y in zip(xs, ys):
        want = float(np.asarray(jtr.step(jmx.nd.array(x, dtype=np.int32),
                                         jmx.nd.array(y))))
        got = float(ttr.step(tmx.nd.array(x, dtype="int32"),
                             tmx.nd.array(y)).asnumpy())
        assert abs(got - want) <= 1e-5 * abs(want)
    jtr.sync_params()
    ttr.sync_params()
    tparams = tnet.collect_params()
    for name, p in jnet.collect_params().items():
        _close(tparams[name].data().asnumpy(), p.data().asnumpy(), what=name)


def test_word_lm_loop_trains_like_jax():
    """word_lm.py:108-136's loop (gluon.Trainer adam at lr 0.003, the state
    carried across BPTT windows and detached each step) 3 windows, f32."""
    s = SMALL_LM
    xs, ys = _lm_data(1)

    def train(m, net):
        tr = m.gluon.Trainer(net.collect_params(), "adam",
                             {"learning_rate": 0.003})
        loss_fn = m.gluon.loss.SoftmaxCrossEntropyLoss()
        state = net.lstm.begin_state(s["batch"], ctx=m.cpu())
        losses = []
        for x, y in zip(xs, ys):
            with m.autograd.record():
                out, state = net.lstm(net.embed(m.nd.array(x)), state)
                loss = loss_fn(net.proj(out), m.nd.array(y))
            loss.backward()
            tr.step(s["batch"])
            state = [st.detach() for st in state]
            losses.append(loss.asnumpy())
        return losses, state

    jnet, tnet = _pair(lambda m: word_lm(m, s["vocab"], s["embed"],
                                         s["hidden"]))
    want, jstate = train(jmx, jnet)
    got, tstate = train(tmx, tnet)
    for g, w in zip(got, want):
        _close(g, w)
    for g, w in zip(tstate, jstate):
        _close(g.asnumpy(), w.asnumpy())
    tparams = tnet.collect_params()
    for name, p in jnet.collect_params().items():
        _close(tparams[name].data().asnumpy(), p.data().asnumpy(), what=name)
