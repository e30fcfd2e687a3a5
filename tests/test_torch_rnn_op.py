"""The fused ``RNN`` op and ``CTCLoss`` of the port against the JAX build,
on the CPU (the plain route), and the cuDNN route against the plain one on
the card.

The same numpy inputs go through ``incubator_mxnet_tpu.ops.rnn`` (forward,
and gradients by ``jax.vjp``) and the port's op (forward, and gradients by
torch's autograd through the plain loop): every mode, one and two layers,
both directions, ``state_outputs``, and the final cell-state clip.  Bound:
1e-5 of the largest magnitude of each output, forward and gradient, in f32.

``CTCLoss`` (``torch.nn.functional.ctc_loss`` in the port, a log-space
``lax.scan`` in the JAX build) in both padding modes, with and without
lengths, loss and data gradient within 1e-5 relative, for non-empty labels.
An empty label is held to warp-ctc's value (the probability of all blanks),
with the JAX build's ln 2 too many asserted beside it; an infeasible label
gives ``inf`` in the port and the JAX build's finite sentinel value.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.ops import rnn as jrnn
from incubator_mxnet_tpu_torch.ops import rnn as trnn

REL = 1e-5
T, N, I, H = 7, 3, 5, 4
MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def rnn_inputs(mode, layers, bidirectional, t=T, n=N, i=I, h=H, seed=0,
               scale=0.5):
    """numpy inputs of the op in ``_rnn_argnames`` order, and its params."""
    params = dict(state_size=h, num_layers=layers, bidirectional=bidirectional,
                  mode=mode)
    shapes = trnn._rnn_param_shapes((t, n, i), params)
    rs = np.random.RandomState(seed)
    arrays = []
    for name in trnn._rnn_argnames(params):
        shape = (t, n, i) if name == "data" else shapes[name]
        arrays.append((rs.standard_normal(shape) * scale).astype(np.float32))
    return arrays, params


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    bound = rel * max(1.0, np.abs(want).max())
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= bound, (err, bound)


def _jax_rnn(arrays, params, cot):
    def f(*xs):
        return jrnn._rnn(*xs, **params)
    outs, vjp = jax.vjp(f, *[jnp.asarray(a) for a in arrays])
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in vjp(
        tuple(jnp.asarray(c) for c in cot))]


def _port_rnn(arrays, params, cot, fn=trnn.rnn_op):
    xs = [torch.tensor(a, requires_grad=True) for a in arrays]
    outs = fn(*xs, **params)
    pairs = [(o, torch.tensor(c)) for o, c in zip(outs, cot)
             if o.requires_grad]
    torch.autograd.backward(*zip(*pairs))
    return [o.detach().numpy() for o in outs], [x.grad.numpy() for x in xs]


def _cotangents(arrays, params, seed=7):
    out_shapes = [s for s, _ in trnn._rnn_infer(
        [(a.shape, a.dtype) for a in arrays], params, False)]
    rs = np.random.RandomState(seed)
    return [rs.standard_normal(s).astype(np.float32) for s in out_shapes]


@pytest.mark.parametrize("layers", (1, 2))
@pytest.mark.parametrize("bidirectional", (False, True))
@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_matches_jax(mode, bidirectional, layers):
    arrays, params = rnn_inputs(mode, layers, bidirectional)
    cot = _cotangents(arrays, params)
    if mode != "lstm":
        cot[2] = np.zeros_like(cot[2])
    jout, jgrad = _jax_rnn(arrays, params, cot)
    before = trnn.rnn_op.plain_calls
    tout, tgrad = _port_rnn(arrays, params, cot)
    assert trnn.rnn_op.plain_calls - before == layers
    for g, w in zip(tout, jout):
        _close(g, w)
    for g, w in zip(tgrad, jgrad):
        _close(g, w)


@pytest.mark.parametrize("mode", ("lstm", "gru"))
def test_rnn_op_state_outputs_through_nd(mode):
    """``nd.RNN`` shows one output, or (out, hy[, cy]) with
    ``state_outputs``, in both packages; names and inferred shapes agree."""
    arrays, params = rnn_inputs(mode, 2, True)
    for so in (False, True):
        p = dict(params, state_outputs=so)
        got = tmx.nd.RNN(*[tmx.nd.array(a) for a in arrays], **p)
        want = jmx.nd.RNN(*[jmx.nd.array(a) for a in arrays], **p)
        got = got if isinstance(got, list) else [got]
        want = want if isinstance(want, list) else [want]
        assert len(got) == len(want) == (3 if so else 1)
        for g, w in zip(got, want):
            _close(g.asnumpy(), w.asnumpy())
    op = tmx.ops.registry.get_op("RNN")
    jop = jmx.ops.registry.get_op("RNN")
    assert op.arg_names(params) == jop.fargnames(params)
    assert op.infer([(a.shape, a.dtype) for a in arrays], params) == [
        ((T, N, 2 * H), np.dtype("float32")),
        ((4, N, H), np.dtype("float32")), ((4, N, H), np.dtype("float32"))]


def test_rnn_op_clips_only_the_final_cell_state():
    """``lstm_state_clip_min/max`` clip ``cy`` after the recurrence, as the
    JAX build does: ``out`` and ``hy`` are those of the unclipped run, and
    the gradient through ``cy`` stops where it was clipped."""
    arrays, params = rnn_inputs("lstm", 2, True, scale=1.5)
    clip = dict(params, lstm_state_clip_min=-0.2, lstm_state_clip_max=0.3)
    cot = _cotangents(arrays, params)
    jout, jgrad = _jax_rnn(arrays, clip, cot)
    tout, tgrad = _port_rnn(arrays, clip, cot)
    free, _ = _port_rnn(arrays, params, cot)
    for g, w in zip(tout, jout):
        _close(g, w)
    for g, w in zip(tgrad, jgrad):
        _close(g, w)
    np.testing.assert_array_equal(tout[0], free[0])
    np.testing.assert_array_equal(tout[1], free[1])
    np.testing.assert_array_equal(tout[2], np.clip(free[2], -0.2, 0.3))
    assert (np.abs(free[2]) > 0.3).any() and tout[2].max() <= 0.3


def test_rnn_op_mixed_dtypes_compute_in_the_weights_dtype():
    """f32 states with bf16 data and weights: the op casts the states and
    computes in bf16 (the cuDNN route wants one dtype)."""
    arrays, params = rnn_inputs("lstm", 1, False)
    xs = [torch.tensor(a) for a in arrays]
    xs = [xs[0].bfloat16(), xs[1], xs[2]] + [x.bfloat16() for x in xs[3:]]
    out, hy, cy = trnn.rnn_op(*xs, **params)
    assert out.dtype == hy.dtype == cy.dtype == torch.bfloat16
    want = trnn.rnn_op(*[x.bfloat16() for x in xs], **params)
    assert all(torch.equal(a, b) for a, b in zip((out, hy, cy), want))


def test_rnn_op_dropout_between_layers():
    """Training with ``p > 0`` drops each layer's output but the last with
    the framework generator: the same seed gives the same result, another
    seed another one, inference and ``p = 0`` none."""
    arrays, params = rnn_inputs("lstm", 3, False, t=16, n=32, h=64)
    params = dict(params, p=0.4)
    nds = [tmx.nd.array(a) for a in arrays]

    def run(seed, train=True):
        tmx.random.seed(seed)
        with tmx.autograd.record(train_mode=train):
            return tmx.nd.RNN(*nds, **params).asnumpy()

    a, b, c = run(3), run(3), run(4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    infer = run(3, train=False)
    plain = tmx.nd.RNN(*nds, **dict(params, p=0.0)).asnumpy()
    np.testing.assert_array_equal(infer, plain)
    op = tmx.ops.registry.get_op("RNN")
    assert op.draws(params, True) and not op.draws(params, False)
    assert not op.draws(dict(params, num_layers=1), True)


def test_rnn_op_dropout_keep_rate():
    """The mask between layers keeps 1 - p of the elements, each kept one
    divided by 1 - p: one layer's output is read back through a second
    layer that copies its input (identity weights, tanh(x) ≈ x small)."""
    p, h = 0.3, 256
    arrays, params = rnn_inputs("rnn_relu", 2, False, t=64, n=64, i=h, h=h)
    params = dict(params, p=p)
    x = np.abs(arrays[0]) + 0.5
    arrays[0] = x
    eye = np.eye(h, dtype=np.float32)
    zero = np.zeros((h, h), np.float32)
    arrays[2:6] = [eye, zero, eye, zero]       # i2h = I, h2h = 0 per layer
    arrays[6:] = [np.zeros(h, np.float32)] * 4
    tmx.random.seed(5)
    with tmx.autograd.train_mode():
        out = tmx.nd.RNN(*[tmx.nd.array(a) for a in arrays],
                         **params).asnumpy()
    kept = out != 0
    assert abs(kept.mean() - (1 - p)) < 0.01
    np.testing.assert_allclose(out[kept], (x / (1 - p))[kept], rtol=1e-6)


def test_rnn_op_backward_under_record_inference_mode():
    """``record(train_mode=False)`` then ``backward()``: the gradient of
    the inference forward (the JAX build's)."""
    arrays, params = rnn_inputs("lstm", 2, True)
    nds = [tmx.nd.array(a) for a in arrays]
    for a in nds:
        a.attach_grad()
    with tmx.autograd.record(train_mode=False):
        out = tmx.nd.RNN(*nds, **params)
    out.backward()
    cot = [np.ones(out.shape, np.float32)] + [
        np.zeros(s, np.float32) for s, _ in trnn._rnn_infer(
            [(a.shape, a.dtype) for a in arrays], params, False)[1:]]
    _, jgrad = _jax_rnn(arrays, params, cot)
    for a, w in zip(nds, jgrad):
        _close(a.grad.asnumpy(), w)


def test_rnn_op_runs_eagerly_inside_bulk():
    """``RNN`` and ``CTCLoss`` are not deferrable: inside ``mx.engine.bulk``
    they run at once, after their pending inputs, bit-equal to eager."""
    assert not tmx.ops.registry.get_op("RNN").deferrable
    assert not tmx.ops.registry.get_op("CTCLoss").deferrable
    arrays, params = rnn_inputs("gru", 2, True)
    nds = [tmx.nd.array(a) for a in arrays]
    want = tmx.nd.RNN(*nds, **params).asnumpy()
    with tmx.engine.bulk(16):
        x = nds[0] * 1.0
        got = tmx.nd.RNN(x, *nds[1:], **params)
    np.testing.assert_array_equal(got.asnumpy(), want)


def test_route_is_chosen_by_device_and_dtype():
    """cuDNN for CUDA tensors of the dtypes the card checks, the plain loop
    for everything else (a CPU or meta tensor, an f64 CUDA tensor)."""
    assert trnn._CUDNN_DTYPES == (torch.float32, torch.bfloat16,
                                  torch.float16)
    for dt in (torch.float32, torch.bfloat16, torch.float16, torch.float64):
        assert trnn._route(torch.empty(0, dtype=dt)) == "plain"
        assert trnn._route(torch.empty(0, dtype=dt, device="meta")) == \
            "plain"


def test_rnn_reference_is_the_plain_route_and_counts_nothing():
    arrays, params = rnn_inputs("lstm", 2, True)
    xs = [torch.tensor(a) for a in arrays]
    before = (trnn.rnn_op.cudnn_calls, trnn.rnn_op.plain_calls)
    ref = trnn._rnn_reference(*xs, **params)
    assert (trnn.rnn_op.cudnn_calls, trnn.rnn_op.plain_calls) == before
    got = trnn.rnn_op(*xs, **params)
    assert all(torch.equal(a, b) for a, b in zip(ref, got))
    assert trnn._route(xs[0]) == "plain"
    assert trnn._route(torch.empty(0, device="meta")) == "plain"


# ---------------------------------------------------------------------------
# CTCLoss
# ---------------------------------------------------------------------------

CT, CN, CC = 12, 4, 6


def ctc_inputs(blank_label, seed=0, lengths=False):
    rs = np.random.RandomState(seed)
    data = rs.standard_normal((CT, CN, CC)).astype(np.float32)
    lo, hi = (1, CC) if blank_label == "first" else (0, CC - 1)
    pad = 0 if blank_label == "first" else -1
    lab_len = np.array([4, 2, 3, 1])
    label = np.full((CN, 5), pad, np.float32)
    for i, n in enumerate(lab_len):
        label[i, :n] = rs.randint(lo, hi, n)
    label[0, 1] = label[0, 2]                  # a repeated label
    extra = {}
    if lengths:
        extra = dict(data_lengths=np.array([12, 9, 10, 5], np.float32),
                     label_lengths=lab_len.astype(np.float32))
    return data, label, extra


def _ctc(pkg, data, label, extra, blank_label, grad=True):
    kw = dict(blank_label=blank_label)
    arrays = [pkg.nd.array(data), pkg.nd.array(label)]
    if extra:
        arrays += [pkg.nd.array(extra["data_lengths"]),
                   pkg.nd.array(extra["label_lengths"])]
        kw.update(use_data_lengths=True, use_label_lengths=True)
    if not grad:
        return pkg.nd.CTCLoss(*arrays, **kw).asnumpy(), None
    arrays[0].attach_grad()
    with pkg.autograd.record():
        loss = pkg.nd.CTCLoss(*arrays, **kw)
    loss.backward()
    return loss.asnumpy(), arrays[0].grad.asnumpy()


@pytest.mark.parametrize("lengths", (False, True))
@pytest.mark.parametrize("blank_label", ("first", "last"))
def test_ctc_loss_matches_jax(blank_label, lengths):
    data, label, extra = ctc_inputs(blank_label, lengths=lengths)
    tl, tg = _ctc(tmx, data, label, extra, blank_label)
    jl, jg = _ctc(jmx, data, label, extra, blank_label)
    assert tl.shape == (CN,) and np.isfinite(tl).all()
    _close(tl, jl)
    _close(tg, jg)
    if lengths:     # steps past a sample's data length take no gradient
        np.testing.assert_array_equal(tg[9:, 1], 0.0)


@pytest.mark.parametrize("alias", ("ctc_loss", "_contrib_CTCLoss",
                                   "_contrib_ctc_loss"))
def test_ctc_loss_aliases(alias):
    data, label, _ = ctc_inputs("first")
    want = tmx.nd.CTCLoss(tmx.nd.array(data), tmx.nd.array(label)).asnumpy()
    fn = getattr(tmx.nd, alias)
    np.testing.assert_array_equal(
        fn(tmx.nd.array(data), tmx.nd.array(label)).asnumpy(), want)
    assert tmx.ops.registry.get_op(alias) is tmx.ops.registry.get_op(
        "CTCLoss")
    short = alias[len("_contrib_"):] if alias.startswith("_contrib_") else \
        None
    if short:
        assert getattr(tmx.nd.contrib, short)


def _all_blanks(data, t, blank):
    lp = data - np.log(np.exp(data.astype(np.float64)).sum(-1,
                                                            keepdims=True))
    return -lp[:t, blank].sum()


@pytest.mark.parametrize("blank_label", ("first", "last"))
def test_ctc_loss_empty_label_is_warp_ctc_value(blank_label):
    """An empty label's loss is -log of the all-blank path (warp-ctc, so
    MXNet); the JAX build's ``_ctc_single`` adds ln 2 there (ROADMAP,
    reference-side faults)."""
    rs = np.random.RandomState(1)
    data = rs.standard_normal((6, 2, 5)).astype(np.float32)
    pad = 0 if blank_label == "first" else -1
    label = np.full((2, 3), pad, np.float32)
    label[1, :2] = (1, 3)
    blank = 0 if blank_label == "first" else 4
    tl, tg = _ctc(tmx, data, label, {}, blank_label)
    jl, _ = _ctc(jmx, data, label, {}, blank_label, grad=False)
    want = _all_blanks(data[:, 0].astype(np.float64), 6, blank)
    assert abs(tl[0] - want) <= 1e-5 * want
    assert abs(jl[0] - (want - math.log(2.0))) <= 1e-5 * want
    _close(tl[1:], jl[1:])
    assert np.isfinite(tg).all()


def test_ctc_loss_infeasible_label_is_inf():
    """A label that needs more steps than the data has: ``inf`` in the
    port (torch's ``ctc_loss``, zero_infinity off); the JAX build returns
    a finite value near its -1e30 sentinel."""
    rs = np.random.RandomState(2)
    data = rs.standard_normal((3, 1, 5)).astype(np.float32)
    label = np.array([[1, 1, 2]], np.float32)      # needs 4 steps
    tl, _ = _ctc(tmx, data, label, {}, "first", grad=False)
    jl, _ = _ctc(jmx, data, label, {}, "first", grad=False)
    assert np.isinf(tl[0]) and tl[0] > 0
    assert np.isfinite(jl[0]) and jl[0] > 1e29


def test_ctc_loss_bf16_computes_in_f32():
    data, label, _ = ctc_inputs("first")
    d16 = torch.tensor(data).bfloat16()
    got = trnn._ctc_loss(d16, torch.tensor(label))
    want = trnn._ctc_loss(d16.float(), torch.tensor(label))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())
    op = tmx.ops.registry.get_op("CTCLoss")
    assert op.infer([(data.shape, np.float32), (label.shape, np.float32)],
                    {}) == [((CN,), np.float32)]


# ---------------------------------------------------------------------------
# on the card: the cuDNN route against the plain one (chip_smoke 13a)
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "bfloat16", "float16"))
@pytest.mark.parametrize("mode", MODES)
def test_card_cudnn_route_matches_plain(card, mode, dtype):
    """chip_smoke's 13a at its small shape: out, hy, cy and the gradients
    of data, states and every weight on the cuDNN route against the plain
    loop in f64 on the same CUDA tensors (rnn_relu's gradients in 16 bits
    against the plain loop in their dtype), each within RNN_TOL, uni- and
    bidirectional, 2 layers."""
    import chip_smoke as cs
    for bidirectional in (False, True):
        row = cs.rnn_route_case(tmx, mode, bidirectional, dtype,
                                cs.RNN_SMALL)
        assert row["route"] == "cudnn" and row["calls"]["cudnn"] == 2
        assert row["ok"], row


@pytest.mark.cuda
def test_card_backward_after_inference_record(card):
    """``record(train_mode=False)`` then ``backward()`` on the cuDNN route
    (cuDNN's backward refuses a forward made in inference mode)."""
    arrays, params = rnn_inputs("lstm", 2, True)
    with tmx.gpu(0):
        nds = [tmx.nd.array(a) for a in arrays]
        for a in nds:
            a.attach_grad()
        before = trnn.rnn_op.cudnn_calls
        with tmx.autograd.record(train_mode=False):
            out = tmx.nd.RNN(*nds, **params)
        out.backward()
        assert trnn.rnn_op.cudnn_calls - before == 2
    want = tmx.nd.array(np.ones(out.shape, np.float32), ctx=tmx.cpu())
    cpu = [tmx.nd.array(a, ctx=tmx.cpu()) for a in arrays]
    for a in cpu:
        a.attach_grad()
    with tmx.autograd.record():
        ref = tmx.nd.RNN(*cpu, **params)
    ref.backward(want)
    for g, w in zip(nds, cpu):
        _close(g.grad.asnumpy(), w.grad.asnumpy(), rel=1e-4)
