"""The Gluon losses of the port against the JAX build, on the CPU: every
loss of ``gluon/loss.py`` but ``CTCLoss`` (held in
``tests/test_torch_gluon_rnn.py`` with the RNN ops), forward and
the gradient of the summed loss with respect to the prediction, in f32,
with ``weight`` and ``sample_weight`` where the loss takes them, and both
``from_sigmoid``/``from_logits`` and both label formats.

Bound: 1e-5 relative to each output's largest value, forward and
gradient (the same registry ops in the same order; softrelu's exp and
log1p and log_softmax's sum are XLA's and ATen's own implementations).
"""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

REL = 1e-5
B, K = 6, 5


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _x(shape, seed, lo=None, hi=None):
    rs = np.random.RandomState(seed)
    if lo is not None:
        return rs.uniform(lo, hi, shape).astype(np.float32)
    x = rs.standard_normal(shape) * 2
    return np.where(np.abs(x) < 1e-2, 0.37, x).astype(np.float32)


def _signs(shape, seed):
    return np.where(np.random.RandomState(seed).rand(*shape) < 0.5, -1.0,
                    1.0).astype(np.float32)


def _bits(shape, seed):
    return (np.random.RandomState(seed).rand(*shape) < 0.5).astype(
        np.float32)


def _probs(shape, seed):
    p = _x(shape, seed, 0.05, 1.0)
    return p / p.sum(-1, keepdims=True)


SW = _x((B, 1), 9, 0.5, 1.5)
# (id, class name, kwargs, pred, other inputs, sample_weight)
CASES = [
    ("L1Loss", "L1Loss", {}, _x((B, K), 0), [_x((B, K), 1)], None),
    ("L1Loss_weighted", "L1Loss", dict(weight=0.7), _x((B, K), 0),
     [_x((B * K,), 1)], SW),
    ("SigmoidBCE_logits", "SigmoidBinaryCrossEntropyLoss", {},
     _x((B, K), 0), [_bits((B, K), 1)], SW),
    ("SigmoidBCE_from_sigmoid", "SigmoidBinaryCrossEntropyLoss",
     dict(from_sigmoid=True, weight=2.0), _x((B, K), 0, 0.05, 0.95),
     [_bits((B, K), 1)], None),
    ("SigmoidBCELoss_alias", "SigmoidBCELoss", {}, _x((B, K), 2),
     [_x((B, K), 3, 0.0, 1.0)], None),
    ("KLDivLoss_log_probs", "KLDivLoss", {}, np.log(_probs((B, K), 0)),
     [_probs((B, K), 1)], SW),
    ("KLDivLoss_logits", "KLDivLoss", dict(from_logits=False, weight=0.5),
     _x((B, K), 0), [_probs((B, K), 1)], None),
    ("HuberLoss", "HuberLoss", {}, _x((B, K), 0), [_x((B, K), 1)], SW),
    ("HuberLoss_rho", "HuberLoss", dict(rho=2.5, weight=1.5),
     _x((B, K), 0), [_x((B, K), 1)], None),
    ("HingeLoss", "HingeLoss", {}, _x((B, K), 0), [_signs((B, K), 1)], SW),
    ("HingeLoss_margin", "HingeLoss", dict(margin=2.0), _x((B, K), 0),
     [_signs((B, K), 1)], None),
    ("SquaredHingeLoss", "SquaredHingeLoss", dict(weight=0.3),
     _x((B, K), 0), [_signs((B, K), 1)], SW),
    ("LogisticLoss_signed", "LogisticLoss", {}, _x((B, K), 0),
     [_signs((B, K), 1)], SW),
    ("LogisticLoss_binary", "LogisticLoss", dict(label_format="binary"),
     _x((B, K), 0), [_bits((B, K), 1)], None),
    ("TripletLoss", "TripletLoss", {}, _x((B, K), 0),
     [_x((B, K), 1), _x((B, K), 2)], None),
    ("TripletLoss_margin", "TripletLoss", dict(margin=4.0, weight=0.5),
     _x((B, 2, 3), 0), [_x((B, 6), 1), _x((B, 2, 3), 2)], None),
    ("L2Loss", "L2Loss", {}, _x((B, K), 0), [_x((B, K), 1)], SW),
    ("SoftmaxCELoss_dense", "SoftmaxCrossEntropyLoss",
     dict(sparse_label=False), _x((B, K), 0), [_probs((B, K), 1)], SW),
]


def _run(mx, name, kwargs, pred, others, sw):
    loss_fn = getattr(mx.gluon.loss, name)(**kwargs)
    p = mx.nd.array(pred)
    p.attach_grad()
    args = [mx.nd.array(o) for o in others]
    if sw is not None:
        args.append(mx.nd.array(sw))
    with mx.autograd.record():
        loss = loss_fn(p, *args)
        total = mx.nd.sum(loss)
    total.backward()
    return loss.asnumpy(), p.grad.asnumpy()


def _close(got, want):
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= REL * scale


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_loss_matches_jax(case):
    _, name, kwargs, pred, others, sw = case
    want = _run(jmx, name, kwargs, pred, others, sw)
    got = _run(tmx, name, kwargs, pred, others, sw)
    for g, w in zip(got, want):
        _close(g, w)
    assert got[0].shape == (pred.shape[0],)


def test_loss_surface():
    assert tmx.gluon.loss.SigmoidBCELoss is \
        tmx.gluon.loss.SigmoidBinaryCrossEntropyLoss
    assert "HuberLoss(batch_axis=0, w=None)" == repr(
        tmx.gluon.loss.HuberLoss())
    with pytest.raises(ValueError, match="signed or binary"):
        tmx.gluon.loss.LogisticLoss(label_format="pm1")
    with pytest.raises(TypeError, match="weight must be a number"):
        tmx.gluon.loss.L1Loss(weight=tmx.nd.ones((1,)))(
            tmx.nd.ones((2, 2)), tmx.nd.ones((2, 2)))
    assert issubclass(tmx.gluon.loss.CTCLoss, tmx.gluon.loss.Loss)


def test_batch_axis_one():
    pred, label = _x((3, B, 2), 0), _x((3, B, 2), 1)
    outs = [_run(mx, "L1Loss", dict(batch_axis=1), pred, [label], None)
            for mx in (jmx, tmx)]
    for g, w in zip(outs[1], outs[0]):
        _close(g, w)
    assert outs[1][0].shape == (B,)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_card_losses_match_cpu(card):
    """chip_smoke's phase 8d losses: each at (256, 1000) on CUDA tensors
    against the port's CPU result, under sync-debug mode "error"."""
    import chip_smoke as cs
    cs.losses_on_card(tmx, np.random.default_rng(cs.SEED))
