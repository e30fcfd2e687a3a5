"""The SSD ops of the port (``ops/vision.py``: ``MultiBoxPrior``,
``MultiBoxTarget``, ``MultiBoxDetection``, ``box_nms`` and their
``_contrib_`` names) against the JAX build on the CPU.

The JAX tests' cases (``tests/test_vision_ops.py:27-80, :163-197`` and
``tests/test_detection.py:160``) run on the port, and seeded random inputs
through both packages: class ids, masks and picks exactly, boxes and
offsets within 1e-6 of their magnitude in f32 (the log in the offsets and
a fused multiply-add in XLA's decode round differently).  Hard-negative
mining's tie order (a stable sort, as ``jnp.argsort``) is pinned, and so
is the one place the port differs on purpose: a padded label row claims no
anchor (ROADMAP, reference-side faults).
"""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

REL = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _both(name, arrays, **params):
    """The op ``name`` of ``nd`` on the same arrays in both packages:
    (port outputs, JAX outputs) as lists of numpy arrays."""
    def run(m):
        fn = getattr(m.nd, name) if "." not in name else getattr(
            m.nd.contrib, name.split(".")[1])
        out = fn(*[m.nd.array(a) for a in arrays], **params)
        out = out if isinstance(out, (list, tuple)) else [out]
        return [o.asnumpy() for o in out]
    return run(tmx), run(jmx)


def _close(got, want, rel=REL, what=""):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = rel * max(1.0, np.abs(want).max())
    err = np.abs(got.astype(np.float64) - want).max() if got.size else 0.0
    assert err <= bound, (what, err, bound)


def _anchors(h=4, w=5, sizes=(0.3, 0.55), ratios=(1.0, 2.0, 0.5)):
    data = np.zeros((1, 3, h, w), np.float32)
    return jmx.nd.MultiBoxPrior(jmx.nd.array(data), sizes=sizes,
                                ratios=ratios).asnumpy()


def _labels(rs, b, m, valid):
    lab = np.full((b, m, 5), -1.0, np.float32)
    for i in range(b):
        for j in range(valid[i]):
            x0, y0 = rs.uniform(0, 0.6, 2)
            s = rs.uniform(0.15, 0.4)
            lab[i, j] = [rs.randint(0, 3), x0, y0, x0 + s, y0 + s]
    return lab


# -- the JAX build's cases -----------------------------------------------------

def test_multibox_prior_jax_case():
    data = tmx.nd.zeros((1, 8, 4, 4))
    anchors = tmx.nd.MultiBoxPrior(data, sizes=(0.5, 0.25), ratios=(1, 2))
    assert anchors.shape == (1, 4 * 4 * 3, 4)
    np.testing.assert_allclose(anchors.asnumpy()[0, 0],
                               [0.125 - 0.25, 0.125 - 0.25,
                                0.125 + 0.25, 0.125 + 0.25], atol=1e-6)


def test_multibox_target_jax_case():
    anchors = np.array([[[0.0, 0.0, 0.5, 0.5], [0.5, 0.5, 1.0, 1.0]]],
                       np.float32)
    label = np.array([[[1, 0.5, 0.5, 1.0, 1.0], [-1, 0, 0, 0, 0]]],
                     np.float32)
    got, want = _both("MultiBoxTarget", [anchors, label,
                                         np.zeros((1, 3, 2), np.float32)])
    ct = got[2][0]
    assert ct[1] == 2.0 and ct[0] == 0.0
    lm = got[1][0].reshape(2, 4)
    assert lm[1].sum() == 4 and lm[0].sum() == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_multibox_detection_jax_case():
    anchors = np.array([[[0.1, 0.1, 0.4, 0.4], [0.6, 0.6, 0.9, 0.9]]],
                       np.float32)
    cls_prob = np.array([[[0.1, 0.8], [0.9, 0.1], [0.0, 0.1]]], np.float32)
    got, want = _both("MultiBoxDetection",
                      [cls_prob, np.zeros((1, 8), np.float32), anchors],
                      nms_threshold=0.5)
    det = got[0][0]
    kept = det[det[:, 0] >= 0]
    assert kept[0][0] == 0.0
    np.testing.assert_allclose(kept[0][2:], [0.1, 0.1, 0.4, 0.4], atol=1e-5)
    _close(got[0], want[0])


def test_box_nms_jax_case():
    boxes = np.array([[[0.9, 0.0, 0.0, 1.0, 1.0],
                       [0.8, 0.05, 0.05, 1.0, 1.0],
                       [0.7, 2.0, 2.0, 3.0, 3.0]]], np.float32)
    got, want = _both("box_nms", [boxes], overlap_thresh=0.5, coord_start=1,
                      score_index=0)
    v = got[0][0]
    assert v[0][0] == pytest.approx(0.9) and v[1][0] == pytest.approx(0.7)
    assert v[2][0] == -1.0
    np.testing.assert_array_equal(got[0], want[0])


def test_negative_mining_jax_case():
    """test_vision_ops.py:163: 3 x 1 hardest negatives kept as background,
    the rest ignored."""
    rs = np.random.RandomState(0)
    xs, ys_ = np.meshgrid(np.arange(4) / 4.0, np.arange(4) / 4.0)
    anchors = np.stack([xs.ravel(), ys_.ravel(), xs.ravel() + 0.25,
                        ys_.ravel() + 0.25], 1)[None].astype(np.float32)
    label = np.array([[[0, 0.0, 0.0, 0.25, 0.25]]], np.float32)
    cls_pred = rs.rand(1, 2, 16).astype(np.float32)
    got, want = _both("MultiBoxTarget", [anchors, label, cls_pred],
                      negative_mining_ratio=3.0, negative_mining_thresh=0.5)
    c = got[2][0]
    assert (c == 1).sum() == 1 and (c == 0).sum() == 3
    assert (c == -1).sum() == 12
    e = np.exp(cls_pred[0] - cls_pred[0].max(0, keepdims=True))
    bg = (e / e.sum(0))[0]
    hardest = set(np.argsort(np.where(np.arange(16) == 0, np.inf, bg))[:3])
    assert set(np.where(c == 0)[0]) == hardest
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_negative_mining_ties_keep_anchor_order():
    """Equal background probabilities rank in anchor order (a stable sort,
    ``jnp.argsort``'s), so the first candidates win the slots."""
    xs, ys_ = np.meshgrid(np.arange(4) / 4.0, np.arange(4) / 4.0)
    anchors = np.stack([xs.ravel(), ys_.ravel(), xs.ravel() + 0.25,
                        ys_.ravel() + 0.25], 1)[None].astype(np.float32)
    label = np.array([[[0, 0.75, 0.75, 1.0, 1.0]]], np.float32)
    cls_pred = np.zeros((1, 2, 16), np.float32)       # every prob ties
    got, want = _both("MultiBoxTarget", [anchors, label, cls_pred],
                      negative_mining_ratio=2.0)
    c = got[2][0]
    assert c[15] == 1
    assert list(np.where(c == 0)[0]) == [0, 1]
    np.testing.assert_array_equal(got[2], want[2])


def test_ssd_shaped_train_step_matches_jax():
    """test_detection.py:160: conv features, MultiBoxPrior/Target, losses
    and gradients, through both packages."""
    rng = np.random.RandomState(4)
    b, na = 2, 4
    x = rng.randn(b, 3, 32, 32).astype(np.float32)
    ws = [(rng.randn(*s) * 0.1).astype(np.float32)
          for s in ((8, 3, 3, 3), (na * 4, 8, 3, 3), (na * 4, 8, 3, 3))]
    labels = np.full((b, 2, 5), -1, np.float32)
    labels[:, 0] = [0, 0.1, 0.1, 0.5, 0.5]

    def run(m):
        nd = m.nd
        w, wc, wl = (nd.array(a) for a in ws)
        for a in (w, wc, wl):
            a.attach_grad()
        with m.autograd.record():
            feat = nd.Convolution(nd.array(x), w, kernel=(3, 3),
                                  num_filter=8, pad=(1, 1), stride=(2, 2),
                                  no_bias=True)
            anchors = nd.contrib.MultiBoxPrior(feat, sizes=(0.3, 0.6),
                                               ratios=(1.0, 2.0, 0.5))
            cls_pred = nd.Convolution(feat, wc, kernel=(3, 3),
                                      num_filter=na * 4, pad=(1, 1),
                                      no_bias=True)
            cls_pred = nd.transpose(nd.reshape(nd.transpose(
                cls_pred, axes=(0, 2, 3, 1)), shape=(b, -1, 4)),
                axes=(0, 2, 1))
            loc_pred = nd.Convolution(feat, wl, kernel=(3, 3),
                                      num_filter=na * 4, pad=(1, 1),
                                      no_bias=True)
            loc_pred = nd.reshape(nd.transpose(loc_pred, axes=(0, 2, 3, 1)),
                                  shape=(b, -1))
            lt, lm, ct = nd.contrib.MultiBoxTarget(anchors, nd.array(labels),
                                                   cls_pred)
            loss = nd.sum(nd.abs(loc_pred * lm - lt))
        loss.backward()
        return [loss.asnumpy(), lt.asnumpy(), lm.asnumpy(), ct.asnumpy()] + \
            [a.grad.asnumpy() for a in (w, wc, wl)]

    got, want = run(tmx), run(jmx)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    for i in (0, 1, 4, 5, 6):
        _close(got[i], want[i], rel=1e-5, what=i)
    assert np.abs(got[6]).sum() > 0


# -- seeded inputs through both packages ---------------------------------------

@pytest.mark.parametrize("kw", [dict(sizes=(0.5, 0.25), ratios=(1, 2)),
                                dict(sizes=(0.3, 0.55), ratios=(1.0, 2.0, 0.5),
                                     clip=True),
                                dict(sizes=(0.2,), ratios=(1.0, 3.0),
                                     steps=(0.1, 0.2), offsets=(0.3, 0.7))])
def test_multibox_prior_matches_jax(kw):
    data = np.zeros((2, 3, 5, 7), np.float32)
    got, want = _both("MultiBoxPrior", [data], **kw)
    assert got[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    alias, _ = _both("contrib.MultiBoxPrior", [data], **kw)
    np.testing.assert_array_equal(alias[0], got[0])


TARGET_CASES = [dict(), dict(overlap_threshold=0.3),
                dict(negative_mining_ratio=3.0),
                dict(negative_mining_ratio=2.0, minimum_negative_samples=7,
                     negative_mining_thresh=0.4, ignore_label=-2.0),
                dict(variances=(0.2, 0.2, 0.1, 0.1))]


@pytest.mark.parametrize("kw", TARGET_CASES)
def test_multibox_target_matches_jax(kw):
    rs = np.random.RandomState(7)
    anchors = _anchors()
    n = anchors.shape[1]
    label = _labels(rs, 3, 4, valid=(1, 3, 4))
    pred = rs.randn(3, 3, n).astype(np.float32)
    got, want = _both("MultiBoxTarget", [anchors, label, pred], **kw)
    assert [g.shape for g in got] == [(3, 4 * n), (3, 4 * n), (3, n)]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    _close(got[0], want[0], what="loc_target")


@pytest.mark.parametrize("kw", [dict(), dict(nms_topk=6, threshold=0.3),
                                dict(background_id=1, clip=False,
                                     nms_threshold=0.3),
                                dict(variances=(0.2, 0.2, 0.1, 0.1))])
def test_multibox_detection_matches_jax(kw):
    rs = np.random.RandomState(8)
    anchors = _anchors()
    n = anchors.shape[1]
    probs = rs.rand(2, 4, n).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    loc = (rs.randn(2, 4 * n) * 0.5).astype(np.float32)
    got, want = _both("MultiBoxDetection", [probs, loc, anchors], **kw)
    assert got[0].shape == (2, n, 6)
    np.testing.assert_array_equal(got[0][..., 0], want[0][..., 0])
    np.testing.assert_array_equal(got[0][..., 1], want[0][..., 1])
    _close(got[0], want[0], what="boxes")
    assert (got[0][..., 0] >= 0).sum() > 2


@pytest.mark.parametrize("kw", [dict(coord_start=2, score_index=1),
                                dict(topk=5, in_format="center",
                                     overlap_thresh=0.3, valid_thresh=0.5),
                                dict(overlap_thresh=0.7, coord_start=1,
                                     score_index=0, valid_thresh=0.2)])
def test_box_nms_matches_jax(kw):
    rs = np.random.RandomState(9)
    data = rs.rand(2, 3, 20, 6).astype(np.float32)
    data[..., 4:] = data[..., 2:4] + rs.rand(2, 3, 20, 2) * 0.5
    got, want = _both("box_nms", [data], **kw)
    np.testing.assert_array_equal(got[0], want[0])
    alias, _ = _both("contrib.box_nms", [data], **kw)
    np.testing.assert_array_equal(alias[0], got[0])


def test_nms_keeps_the_first_of_equal_scores():
    boxes = np.array([[[0.5, 0.0, 0.0, 1.0, 1.0],
                       [0.5, 0.0, 0.0, 1.0, 1.0],
                       [0.5, 2.0, 2.0, 3.0, 3.0]]], np.float32)
    got, want = _both("box_nms", [boxes], coord_start=1, score_index=0)
    v = got[0][0]
    np.testing.assert_array_equal(v[0], boxes[0, 0])
    np.testing.assert_array_equal(v[1], boxes[0, 2])
    assert (v[2] == -1).all()
    np.testing.assert_array_equal(got[0], want[0])


def test_a_padded_row_claims_no_anchor():
    """A valid ground truth whose best anchor is anchor 0 claims it, though
    a padded row (class -1, IoU -1 everywhere, best anchor 0) follows it.
    The JAX build's scatter lets the padded row's False win
    (``.at[best_anchor].set(valid)``, vision.py:142); the port follows
    MXNet, where only valid rows match."""
    anchors = np.array([[[0.0, 0.0, 0.3, 0.3], [0.5, 0.5, 1.0, 1.0]]],
                       np.float32)
    # IoU with anchor 0 is 0.09/0.25: below the threshold, so only the
    # claim makes it positive
    label = np.array([[[1, 0.0, 0.0, 0.5, 0.5], [-1, -1, -1, -1, -1]]],
                     np.float32)
    got, want = _both("MultiBoxTarget", [anchors, label,
                                         np.zeros((1, 3, 2), np.float32)])
    assert got[2][0].tolist() == [2.0, 0.0]
    assert want[2][0].tolist() == [0.0, 0.0]


# -- the registry --------------------------------------------------------------

SSD_NAMES = {"MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection",
             "box_nms"}
# what the JAX build's ops/vision.py registers and the port does not: none
# since item 9b
LATER_VISION = set()
# the modules whose every registered name the port carries with the same
# registration
CHECKED_MODULES = ("incubator_mxnet_tpu.ops.vision",
                   "incubator_mxnet_tpu.ops.quantization")


def _contract(op):
    """What a registration promises: names, arities, output counts,
    gradients, the symbolic hooks and the parameters' defaults."""
    return dict(
        name=op.name, num_inputs=op.num_inputs, num_outputs=op.num_outputs,
        num_visible_outputs=op.num_visible_outputs,
        differentiable=op.differentiable, needs_rng=bool(op.needs_rng),
        takes_is_train=op.takes_is_train,
        nograd_inputs=tuple(op.nograd_inputs),
        mutate_inputs=tuple(op.mutate_inputs),
        input_names=None if op.input_names is None else tuple(
            op.input_names),
        aux_input_names=tuple(op.aux_input_names),
        fargnames=op.fargnames is not None,
        finfer_params=op.finfer_params is not None,
        fvisible=op.fvisible is not None,
        fnum_outputs=op.fnum_outputs is not None,
        defaults=dict(op._defaults))


def test_every_ssd_name_is_registered():
    """Every name that the JAX build's ops/vision.py and ops/quantization.py
    register (the SSD ops, items 9b and 11a) is in the port, each on the
    Operator the JAX build puts it on, with the same registration: arity,
    output counts, gradients, input names, symbolic hooks and parameter
    defaults.  Each is deferrable (static shapes), so bulking and
    hybridize() capture it."""
    from incubator_mxnet_tpu.ops import registry as jreg
    from incubator_mxnet_tpu_torch.ops import registry as treg
    names = {n for n, o in jreg._REGISTRY.items()
             if o.fcompute.__module__ in CHECKED_MODULES}
    ssd = SSD_NAMES | {"_contrib_" + n for n in SSD_NAMES}
    assert ssd <= names
    assert len(names) == 35        # 8 SSD, 18 of item 9b, 9 of item 11a
    assert names - set(treg._REGISTRY) == LATER_VISION
    for n in names:
        j, t = jreg._REGISTRY[n], treg._REGISTRY[n]
        assert _contract(t) == _contract(j), n
        assert t.deferrable, n
        for other in names:
            if jreg._REGISTRY[other] is j:
                assert treg._REGISTRY[other] is t, (n, other)
    for n in ssd:
        assert not treg._REGISTRY[n].differentiable, n
    # the fargnames, finfer_params and fnum_outputs answer as the JAX
    # build's
    for n, params in [("_contrib_DeformableConvolution", {"no_bias": True}),
                      ("_contrib_DeformableConvolution", {}),
                      ("_contrib_DeformablePSROIPooling", {"no_trans": True}),
                      ("_contrib_DeformablePSROIPooling", {}),
                      ("_contrib_quantized_conv", {"no_bias": False}),
                      ("_contrib_quantized_fully_connected", {})]:
        j, t = jreg._REGISTRY[n], treg._REGISTRY[n]
        assert t.arg_names(params) == j.arg_names(params), n
    for n, shape, params in [
            ("_contrib_DeformableConvolution", (2, 8, 5, 5),
             {"num_filter": 4, "num_group": 2, "kernel": (3, 3)}),
            ("_contrib_quantized_conv", (2, 8, 5, 5),
             {"num_filter": 4, "kernel": (3, 3)}),
            ("_contrib_quantized_fully_connected", (2, 3, 4),
             {"num_hidden": 5})]:
        assert treg._REGISTRY[n].finfer_params(shape, params) == \
            jreg._REGISTRY[n].finfer_params(shape, params), n
    for flag in (True, False):
        p = {"output_score": flag}
        assert treg._REGISTRY["Proposal"].fnum_outputs(p) == \
            jreg._REGISTRY["Proposal"].fnum_outputs(p)
