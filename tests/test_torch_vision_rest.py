"""The rest of the vision ops of the port (``ops/vision.py``: ROI pooling,
``ROIAlign``, ``Proposal``/``MultiProposal``, the samplers,
``Correlation``, ``Crop``, the deformable convolution and the
position-sensitive ROI poolings) against the JAX build on the CPU.

The same seeded numpy inputs go through both packages.  Tolerances: f32
outputs and gradients within 1e-5 of their largest magnitude (the JAX
build's XLA code fuses multiplies into adds and sums in other orders);
integer outputs, kept index sets and top counts exactly.  The cases of
``tests/test_vision_ops.py`` and ``tests/test_detection.py:16-126`` that
touch these ops run here as parity tests; the card tests (``cuda``) hold
each family on the card against the port on the CPU.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.base import MXNetError

REL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _rs(seed):
    return np.random.RandomState(seed)


def _fn(m, name):
    if name.startswith("contrib."):
        return getattr(m.nd.contrib, name[len("contrib."):])
    return getattr(m.nd, name)


def _run(m, name, arrays, params, grads=(), seed=7, head=0):
    """``name`` on ``arrays`` in package ``m``: (outputs, gradients of the
    inputs ``grads`` for a seeded head gradient of output ``head``)."""
    xs = [m.nd.array(a, dtype=a.dtype) for a in arrays]
    for i in grads:
        xs[i].attach_grad()
    with m.autograd.record():
        out = _fn(m, name)(*xs, **params)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    if grads:
        ct = _rs(seed).standard_normal(outs[head].shape).astype(np.float32)
        outs[head].backward(m.nd.array(ct))
    return ([o.asnumpy() for o in outs],
            [xs[i].grad.asnumpy() for i in grads])


def _both(name, arrays, params, grads=()):
    return _run(tmx, name, arrays, params, grads), \
        _run(jmx, name, arrays, params, grads)


def _close(got, want, rel=REL, what=""):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not got.size:
        return
    bound = rel * max(np.abs(want).max(), 1e-30)
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= bound, (what, err, bound)


def _parity(name, arrays, params, grads=(), rel=REL):
    (go, gg), (wo, wg) = _both(name, arrays, params, grads)
    for i, (g, w) in enumerate(zip(go, wo)):
        _close(g, w, rel, "output %d" % i)
    for i, (g, w) in zip(grads, zip(gg, wg)):
        _close(g, w, rel, "gradient of input %d" % i)
    return go, gg


def _rois(rs, r, n, h_img, w_img, lo=0.0):
    """Seeded ROIs [batch, x1, y1, x2, y2] within an image of h_img x
    w_img pixels (from ``lo``, which may be negative)."""
    out = np.zeros((r, 5), np.float32)
    for i in range(r):
        x1, x2 = np.sort(rs.uniform(lo, w_img, 2))
        y1, y2 = np.sort(rs.uniform(lo, h_img, 2))
        out[i] = [rs.randint(0, n), x1, y1, x2, y2]
    return out


# -- ROI pooling ---------------------------------------------------------------

def test_roi_pooling_jax_case():
    data = np.arange(64, dtype=np.float32).reshape(1, 1, 8, 8)
    rois = np.array([[0, 0, 0, 7, 7]], np.float32)
    out, _ = _parity("ROIPooling", [data, rois],
                     dict(pooled_size=(2, 2), spatial_scale=1.0))
    np.testing.assert_array_equal(out[0][0, 0], [[27, 31], [59, 63]])


@pytest.mark.parametrize("shape,pooled,scale,lo", [
    ((2, 3, 12, 15), (3, 4), 0.25, 0.0),
    ((2, 4, 19, 23), (7, 7), 0.5, 0.0),
    # ROIs reaching past the map: bins larger than their window, the rest
    # from the range-max table, and bins with no cell of the map
    ((1, 3, 10, 13), (5, 3), 1.0, -8.0),
    ((2, 2, 9, 9), (2, 2), 1.5, -4.0),
])
def test_roi_pooling_matches_jax(shape, pooled, scale, lo):
    rs = _rs(sum(shape))
    n, c, h, w = shape
    data = rs.standard_normal(shape).astype(np.float32)
    rois = _rois(rs, 9, n, (h + 6) / scale, (w + 6) / scale, lo / scale)
    _parity("ROIPooling", [data, rois],
            dict(pooled_size=pooled, spatial_scale=scale), grads=(0,))


def test_roi_pooling_ties_split_the_gradient_as_jax():
    """A map of zeros with a few equal maxima (as after a relu): the
    gradient of a bin splits evenly among its equal maxima, as
    ``jnp.max``'s does, and an empty bin gives 0."""
    data = np.zeros((1, 2, 8, 8), np.float32)
    data[0, 0, 1, 1] = data[0, 0, 2, 3] = data[0, 1, 5, 5] = 1.0
    rois = np.array([[0, 0, 0, 7, 7], [0, 1, 1, 3, 3], [0, 40, 40, 50, 50]],
                    np.float32)
    out, grads = _parity("ROIPooling", [data, rois],
                         dict(pooled_size=(2, 2), spatial_scale=1.0),
                         grads=(0,))
    assert (out[0][2] == 0).all()


def test_roi_pooling_rounds_half_to_even():
    """Scaled corners on exact halves round to even (``jnp.round``), which
    the registry's ``round`` (half away from zero) would not."""
    data = np.arange(100, dtype=np.float32).reshape(1, 1, 10, 10)
    rois = np.array([[0, 8, 24, 40, 56], [0, 24, 8, 72, 40]], np.float32)
    out, _ = _parity("ROIPooling", [data, rois],
                     dict(pooled_size=(2, 2), spatial_scale=1 / 16.))
    # the first ROI: x1 = 0.5 -> 0, y1 = 1.5 -> 2, x2 = 2.5 -> 2, y2 =
    # 3.5 -> 4 (half to even), so its bin (0, 0) is rows 2-3, columns 0-1
    # (half away from zero: columns 1-2)
    assert out[0][0, 0, 0, 0] == data[0, 0, 2:4, 0:2].max()
    assert out[0][0, 0, 0, 0] != data[0, 0, 2:4, 1:3].max()


# -- ROIAlign --------------------------------------------------------------------

def test_roi_align_jax_case():
    out, _ = _parity("ROIAlign", [np.ones((1, 2, 8, 8), np.float32),
                                  np.array([[0, 1, 1, 5, 5]], np.float32)],
                     dict(pooled_size=(3, 3), spatial_scale=1.0))
    assert out[0].shape == (1, 2, 3, 3)
    np.testing.assert_allclose(out[0], 1.0, rtol=1e-5)


@pytest.mark.parametrize("name", ["ROIAlign", "contrib.ROIAlign"])
@pytest.mark.parametrize("sr", [1, 2, 3])
def test_roi_align_matches_jax(name, sr):
    rs = _rs(10 + sr)
    data = rs.standard_normal((2, 3, 11, 13)).astype(np.float32)
    rois = _rois(rs, 7, 2, 50.0, 60.0, -6.0)
    _parity(name, [data, rois], dict(pooled_size=(3, 4), spatial_scale=0.25,
                                     sample_ratio=sr), grads=(0,))


# -- Proposal ------------------------------------------------------------------

def test_proposal_jax_case():
    b, a, h, w = 1, 2, 4, 4
    rs = _rs(0)
    cls_prob = rs.rand(b, 2 * a, h, w).astype(np.float32)
    bbox_pred = (rs.randn(b, 4 * a, h, w) * 0.1).astype(np.float32)
    im_info = np.array([[64, 64, 1.0]], np.float32)
    params = dict(rpn_pre_nms_top_n=12, rpn_post_nms_top_n=5,
                  feature_stride=16, scales=(2, 4), ratios=(1.0,))
    (got, _), (want, _) = _both("Proposal", [cls_prob, bbox_pred, im_info],
                                params)
    assert got[0].shape == (5, 5)
    assert (got[0][:, 0] == 0).all()
    assert (got[0][:, 1:] >= 0).all() and (got[0][:, 1:] <= 64).all()
    _close(got[0], want[0], 1e-6)


def _rpn_inputs(seed, b, h, w, stride=16, scales=(2, 4),
                ratios=(0.5, 1, 2)):
    """RPN outputs whose decode is exact in f32: center offsets in
    multiples of 1/64 and log sizes of 0, over anchors of integer sides,
    so every box corner, area and intersection is a short dyadic number
    and every IoU is one correctly rounded division of equal operands in
    both packages.  NMS is discontinuous: an ulp of ``exp`` or of a fused
    multiply-add (XLA fuses the decode's, torch does not) can flip an IoU
    that sits at the threshold; with these inputs nothing rounds before
    the IoU, so the kept sets must be equal.  ``test_proposal_jax_case``
    covers the rounding ``exp``.  Returns (cls_prob, bbox_pred,
    im_info)."""
    rs = _rs(seed)
    n_a = len(scales) * len(ratios)
    cls = rs.rand(b, 2 * n_a, h, w).astype(np.float32)
    d = np.zeros((b, n_a, 4, h, w), np.float32)
    d[:, :, :2] = rs.randint(-24, 25, (b, n_a, 2, h, w)) / 64.0
    info = np.array([[h * stride, w * stride, 1.0]] * b, np.float32)
    return cls, d.reshape(b, 4 * n_a, h, w), info


@pytest.mark.parametrize("name", ["Proposal", "contrib.Proposal",
                                  "MultiProposal", "contrib.MultiProposal"])
@pytest.mark.parametrize("threshold", [0.7, 0.3])
def test_proposal_keeps_the_jax_sets(name, threshold):
    """Two images; the kept ROIs, their order and their scores equal."""
    cls, d, info = _rpn_inputs(5, 2, 5, 6)
    params = dict(rpn_pre_nms_top_n=120, rpn_post_nms_top_n=40,
                  threshold=threshold, rpn_min_size=16, scales=(2, 4),
                  ratios=(0.5, 1, 2), feature_stride=16, output_score=True)
    (got, _), (want, _) = _both(name, [cls, d, info], params)
    assert got[0].shape == (80, 5) and got[1].shape == (80, 1)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert (got[1] > 0).sum() > 10


def test_proposal_min_size_and_ties_in_anchor_order():
    """Every box below the minimum size scores -1e30, so they tie: the
    pre-NMS cut keeps them in anchor order, as ``lax.top_k``."""
    rs = _rs(9)
    cls = rs.rand(1, 4, 3, 3).astype(np.float32)
    d = np.full((1, 8, 3, 3), -3.0, np.float32)      # every box shrinks
    d[0, :4, 0, 0] = 0.0                             # but one
    info = np.array([[48, 48, 1.0]], np.float32)
    params = dict(rpn_pre_nms_top_n=10, rpn_post_nms_top_n=6,
                  scales=(2,), ratios=(0.5, 2), feature_stride=16,
                  output_score=True)
    (got, _), (want, _) = _both("Proposal", [cls, d, info], params)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_proposal_reads_no_iou_loss():
    """Neither package reads ``iou_loss`` (ROADMAP, reference-side
    faults): the deltas decode as center offsets either way."""
    cls, d, info = _rpn_inputs(6, 1, 4, 4)
    params = dict(rpn_pre_nms_top_n=50, rpn_post_nms_top_n=10,
                  scales=(2, 4), ratios=(0.5, 1, 2))
    plain, _ = _run(tmx, "Proposal", [cls, d, info], params)
    with_iou, _ = _run(tmx, "Proposal", [cls, d, info],
                       dict(params, iou_loss=True))
    ref, _ = _run(jmx, "Proposal", [cls, d, info],
                  dict(params, iou_loss=True))
    np.testing.assert_array_equal(plain[0], with_iou[0])
    _close(with_iou[0], ref[0], 1e-6)


# -- sampling ops --------------------------------------------------------------

def test_bilinear_sampler_identity_jax_case():
    data = _rs(0).randn(1, 2, 5, 5).astype(np.float32)
    xs = np.linspace(-1, 1, 5, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs)
    grid = np.stack([gx, gy])[None].astype(np.float32)
    out, _ = _parity("BilinearSampler", [data, grid], {})
    np.testing.assert_allclose(out[0], data, rtol=1e-5, atol=1e-5)


def test_bilinear_sampler_matches_jax():
    """Samples inside, across and outside the map; gradients of the data
    and of the grid (test_vision_ops.py:149)."""
    rs = _rs(2)
    data = rs.standard_normal((2, 3, 6, 7)).astype(np.float32)
    grid = rs.uniform(-1.3, 1.3, (2, 2, 5, 4)).astype(np.float32)
    _, (gdata, _) = _parity("BilinearSampler", [data, grid], {},
                            grads=(0, 1))
    assert np.abs(gdata).sum() > 0


@pytest.mark.parametrize("kind", ["affine", "warp"])
def test_grid_generator_matches_jax(kind):
    rs = _rs(3)
    if kind == "affine":
        x = (np.tile([1, 0, 0, 0, 1, 0], (2, 1)) +
             0.2 * rs.standard_normal((2, 6))).astype(np.float32)
        params = dict(transform_type="affine", target_shape=(5, 7))
    else:
        x = rs.standard_normal((2, 2, 4, 6)).astype(np.float32)
        params = dict(transform_type="warp")
    _parity("GridGenerator", [x], params, grads=(0,))


def test_grid_generator_warp_jax_case():
    out, _ = _parity("GridGenerator", [np.zeros((1, 2, 4, 4), np.float32)],
                     dict(transform_type="warp"))
    np.testing.assert_allclose(out[0][0, 0, 0], np.linspace(-1, 1, 4),
                               atol=1e-6)


def test_spatial_transformer_matches_jax():
    rs = _rs(4)
    data = rs.standard_normal((2, 3, 6, 6)).astype(np.float32)
    ident = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), (2, 1))
    out, _ = _parity("SpatialTransformer", [data, ident],
                     dict(target_shape=(6, 6), transform_type="affine",
                          sampler_type="bilinear"))
    np.testing.assert_allclose(out[0], data, rtol=1e-5, atol=1e-5)
    loc = (ident + 0.3 * rs.standard_normal((2, 6))).astype(np.float32)
    _parity("SpatialTransformer", [data, loc], dict(target_shape=(4, 5)),
            grads=(0, 1))


# -- Correlation ---------------------------------------------------------------

def test_correlation_self_jax_case():
    data = np.ones((1, 4, 6, 6), np.float32)
    out, _ = _parity("Correlation", [data, data],
                     dict(max_displacement=1, pad_size=1))
    assert out[0].shape[1] == 9


@pytest.mark.parametrize("d,s1,s2,pad,mult", [
    (2, 1, 1, 2, True),
    (3, 2, 2, 3, True),
    # a pad below the displacement: the roll wraps around the padded map
    (2, 1, 1, 1, True),
    (3, 1, 2, 0, False),
    (2, 2, 1, 2, False),
])
def test_correlation_matches_jax(d, s1, s2, pad, mult):
    rs = _rs(d * 10 + s1 + pad)
    a = rs.standard_normal((2, 5, 7, 9)).astype(np.float32)
    b = rs.standard_normal((2, 5, 7, 9)).astype(np.float32)
    _parity("Correlation", [a, b], dict(max_displacement=d, stride1=s1,
                                        stride2=s2, pad_size=pad,
                                        is_multiply=mult), grads=(0, 1))


def test_correlation_kernel_size_other_than_one_raises():
    """The JAX build reads no ``kernel_size`` (its kernel_size=3 result is
    its kernel_size=1 result, a reference-side fault in ROADMAP); the port
    computes kernel_size=1 as the JAX build does and raises otherwise."""
    rs = _rs(5)
    a, b = (rs.standard_normal((1, 3, 5, 5)).astype(np.float32)
            for _ in range(2))
    params = dict(max_displacement=1, pad_size=1)
    one, _ = _run(jmx, "Correlation", [a, b], dict(params, kernel_size=1))
    three, _ = _run(jmx, "Correlation", [a, b], dict(params, kernel_size=3))
    np.testing.assert_array_equal(one[0], three[0])
    with pytest.raises(MXNetError, match="kernel_size"):
        _run(tmx, "Correlation", [a, b], dict(params, kernel_size=3))


# -- Crop ------------------------------------------------------------------------

def test_crop_jax_case():
    x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    out, _ = _parity("Crop", [x, np.zeros((1, 1, 2, 2), np.float32)],
                     dict(num_args=2, center_crop=True))
    np.testing.assert_array_equal(out[0][0, 0], [[5, 6], [9, 10]])


@pytest.mark.parametrize("params,like", [
    (dict(offset=(1, 2), h_w=(3, 2)), False),
    (dict(num_args=2, offset=(2, 1)), True),
    (dict(h_w=(3, 3), center_crop=True), False),
])
def test_crop_matches_jax(params, like):
    rs = _rs(6)
    arrays = [rs.standard_normal((2, 3, 6, 5)).astype(np.float32)]
    if like:
        arrays.append(np.zeros((2, 3, 4, 3), np.float32))
    _parity("Crop", arrays, params, grads=(0,))


# -- deformable convolution ----------------------------------------------------

def test_deformable_conv_zero_offset_matches_conv():
    """test_detection.py:16."""
    rng = _rs(0)
    x = rng.randn(2, 4, 8, 8).astype(np.float32)
    w = rng.randn(6, 4, 3, 3).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    off = np.zeros((2, 18, 8, 8), np.float32)
    params = dict(kernel=(3, 3), num_filter=6, pad=(1, 1))
    out, _ = _parity("contrib.DeformableConvolution", [x, off, w, b], params)
    ref = tmx.nd.Convolution(tmx.nd.array(x), tmx.nd.array(w),
                             tmx.nd.array(b), **params).asnumpy()
    np.testing.assert_allclose(out[0], ref, rtol=1e-4, atol=1e-4)


def test_deformable_conv_integer_offset_shifts():
    """test_detection.py:31: an offset of (0, 1) reads one pixel right."""
    rng = _rs(1)
    x = rng.randn(1, 2, 6, 6).astype(np.float32)
    w = rng.randn(3, 2, 1, 1).astype(np.float32)
    off = np.zeros((1, 2, 6, 6), np.float32)
    off[:, 1] = 1.0
    out, _ = _parity("contrib.DeformableConvolution", [x, off, w],
                     dict(kernel=(1, 1), num_filter=3, no_bias=True))
    shifted = np.zeros_like(x)
    shifted[..., :-1] = x[..., 1:]
    ref = tmx.nd.Convolution(tmx.nd.array(shifted), tmx.nd.array(w),
                             kernel=(1, 1), num_filter=3,
                             no_bias=True).asnumpy()
    np.testing.assert_allclose(out[0][..., :-1], ref[..., :-1], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name", ["DeformableConvolution",
                                  "contrib.DeformableConvolution"])
@pytest.mark.parametrize("conf", [
    dict(kernel=(2, 2), pad=(1, 1), no_bias=True),
    dict(kernel=(3, 3), pad=(2, 2), dilate=(2, 2), num_deformable_group=2),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_group=2,
         num_deformable_group=2),
])
def test_deformable_conv_matches_jax(name, conf):
    """Gradients of data, offset, weight (and bias) (test_detection.py:50)."""
    rs = _rs(len(conf))
    c, f = 4, 6
    x = rs.standard_normal((2, c, 7, 8)).astype(np.float32)
    kh, kw = conf["kernel"]
    sh, sw = conf.get("stride", (1, 1))
    dh, dw = conf.get("dilate", (1, 1))
    ph, pw = conf["pad"]
    ho = (7 + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    wo = (8 + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    dg = conf.get("num_deformable_group", 1)
    off = (rs.standard_normal((2, 2 * dg * kh * kw, ho, wo)) * 1.5) \
        .astype(np.float32)
    w = rs.standard_normal((f, c // conf.get("num_group", 1), kh, kw)) \
        .astype(np.float32)
    arrays = [x, off, w]
    if not conf.get("no_bias"):
        arrays.append(rs.standard_normal(f).astype(np.float32))
    _parity(name, arrays, dict(conf, num_filter=f),
            grads=tuple(range(len(arrays))))


# -- position-sensitive ROI pooling ----------------------------------------------

def test_psroi_pooling_jax_case():
    """test_detection.py:69: constant channels return their own index."""
    od, k = 2, 3
    data = np.zeros((1, od * k * k, 12, 12), np.float32)
    for c in range(od * k * k):
        data[0, c] = c
    out, _ = _parity("contrib.PSROIPooling",
                     [data, np.array([[0, 0, 0, 11, 11]], np.float32)],
                     dict(spatial_scale=1.0, output_dim=od, pooled_size=k))
    want = np.arange(od * k * k, dtype=np.float32).reshape(od, k, k)
    np.testing.assert_array_equal(out[0][0], want)


@pytest.mark.parametrize("name", ["PSROIPooling", "contrib.PSROIPooling"])
@pytest.mark.parametrize("shape,k,gs,scale,lo", [
    ((2, 3, 15, 17), 3, 3, 0.5, 0.0),
    ((1, 2, 9, 11), 3, 2, 1.0, 0.0),
    # ROIs past the map: the rest of a bin from the integral image
    ((2, 2, 14, 10), 4, 4, 1.0, -10.0),
])
def test_psroi_pooling_matches_jax(name, shape, k, gs, scale, lo):
    n, od, h, w = shape
    rs = _rs(h + w)
    data = rs.standard_normal((n, od * gs * gs, h, w)).astype(np.float32)
    rois = _rois(rs, 8, n, (h + 8) / scale, (w + 8) / scale, lo / scale)
    _parity(name, [data, rois], dict(spatial_scale=scale, output_dim=od,
                                     pooled_size=k, group_size=gs),
            grads=(0,))


def test_deformable_psroi_pooling_jax_case():
    """test_detection.py:90: zero offsets equal ``no_trans``."""
    od, k = 2, 2
    data = _rs(3).randn(1, od * k * k, 10, 10).astype(np.float32)
    rois = np.array([[0, 1, 1, 8, 8]], np.float32)
    params = dict(spatial_scale=1.0, output_dim=od, pooled_size=k,
                  group_size=k, part_size=k, sample_per_part=2,
                  trans_std=0.1)
    out, _ = _parity("contrib.DeformablePSROIPooling",
                     [data, rois, np.zeros((1, 2, k, k), np.float32)],
                     params)
    out2, _ = _parity("contrib.DeformablePSROIPooling", [data, rois],
                      dict(params, no_trans=True))
    assert out[0].shape == (1, od, k, k)
    np.testing.assert_allclose(out[0], out2[0], rtol=1e-5)


@pytest.mark.parametrize("name", ["DeformablePSROIPooling",
                                  "contrib.DeformablePSROIPooling"])
@pytest.mark.parametrize("classes,k,part,spp", [(1, 3, 3, 2), (2, 2, 3, 3)])
def test_deformable_psroi_pooling_matches_jax(name, classes, k, part, spp):
    rs = _rs(classes * 10 + k)
    od = 2 * classes
    data = rs.standard_normal((2, od * k * k, 11, 12)).astype(np.float32)
    rois = _rois(rs, 5, 2, 11 / 0.5, 12 / 0.5, -4.0)
    trans = rs.standard_normal((5, 2 * classes, part, part)) \
        .astype(np.float32)
    _parity(name, [data, rois, trans],
            dict(spatial_scale=0.5, output_dim=od, pooled_size=k,
                 group_size=k, part_size=part, sample_per_part=spp,
                 trans_std=0.3), grads=(0, 2))


def test_deformable_psroi_pooling_top_count_is_hidden():
    """Two outputs, one visible (the JAX build's registration): the
    executor sees the sample counts, ``nd`` returns the pooled map."""
    from incubator_mxnet_tpu_torch.ops.registry import get_op
    rs = _rs(4)
    data = rs.standard_normal((1, 8, 6, 6)).astype(np.float32)
    rois = np.array([[0, -3, 1, 5, 9]], np.float32)
    params = dict(spatial_scale=1.0, output_dim=2, pooled_size=2,
                  part_size=2, sample_per_part=2, no_trans=True)
    out = tmx.nd.contrib.DeformablePSROIPooling(
        tmx.nd.array(data), tmx.nd.array(rois), **params)
    assert isinstance(out, tmx.nd.NDArray) and out.shape == (1, 2, 2, 2)
    op = get_op("_contrib_DeformablePSROIPooling")
    got = op.fcompute(torch.tensor(data), torch.tensor(rois), **params)
    want = jmx.ops.registry.get_op("_contrib_DeformablePSROIPooling") \
        .fcompute(jmx.nd.array(data)._read(), jmx.nd.array(rois)._read(),
                  **params)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# -- shapes on meta tensors ------------------------------------------------------

META_CASES = [
    ("ROIPooling", [(2, 3, 9, 9), (4, 5)], dict(pooled_size=(3, 3),
                                                spatial_scale=0.5)),
    ("ROIAlign", [(2, 3, 9, 9), (4, 5)], dict(pooled_size=(2, 3))),
    ("Proposal", [(2, 24, 4, 5), (2, 48, 4, 5), (2, 3)],
     dict(rpn_pre_nms_top_n=30, rpn_post_nms_top_n=7, output_score=True)),
    ("BilinearSampler", [(2, 3, 5, 6), (2, 2, 4, 4)], {}),
    ("GridGenerator", [(2, 6)], dict(target_shape=(3, 4))),
    ("SpatialTransformer", [(2, 3, 5, 6), (2, 6)], dict(target_shape=(3,
                                                                       4))),
    ("Correlation", [(1, 4, 6, 7), (1, 4, 6, 7)],
     dict(max_displacement=2, pad_size=2, stride2=2)),
    ("Crop", [(1, 2, 6, 6), (1, 2, 3, 4)], dict(num_args=2)),
    ("_contrib_DeformableConvolution", [(1, 4, 6, 6), (1, 18, 6, 6),
                                        (5, 4, 3, 3), (5,)],
     dict(kernel=(3, 3), pad=(1, 1), num_filter=5)),
    ("_contrib_PSROIPooling", [(1, 18, 8, 8), (3, 5)],
     dict(output_dim=2, pooled_size=3)),
    ("_contrib_DeformablePSROIPooling", [(1, 8, 8, 8), (3, 5), (3, 2, 2, 2)],
     dict(output_dim=2, pooled_size=2, sample_per_part=2, trans_std=0.1)),
]


@pytest.mark.parametrize("name,shapes,params", META_CASES,
                         ids=[c[0] for c in META_CASES])
def test_output_shapes_infer_on_meta_as_jax(name, shapes, params):
    """Every op of the slice runs on meta tensors (static shapes: bulking
    and ``hybridize()`` may capture it) and infers the JAX build's output
    shapes and dtypes."""
    from incubator_mxnet_tpu_torch.ops.registry import get_op
    got = get_op(name).infer([(s, "float32") for s in shapes], params)
    want = jmx.ops.registry.get_op(name).infer(
        [(s, np.float32) for s in shapes], params)
    assert [(tuple(s), np.dtype(d)) for s, d in got] == \
        [(tuple(s), np.dtype(d)) for s, d in want]


# -- the slice as a whole: a small detection net ----------------------------------

def _det_weights(rs, c, n_a):
    return dict(
        trunk=(rs.standard_normal((c, 3, 3, 3)) * 0.3).astype(np.float32),
        rpn=(rs.standard_normal((c, c, 3, 3)) * 0.1).astype(np.float32),
        cls=(rs.standard_normal((2 * n_a, c, 1, 1)) * 0.3).astype(np.float32),
        box=(rs.standard_normal((4 * n_a, c, 1, 1)) * 0.02)
        .astype(np.float32),
        fc=(rs.standard_normal((5, c * 9)) * 0.1).astype(np.float32))


def _detect(m, x, wts, info, roi_op):
    """Faster R-CNN in miniature through ``nd``: a stride-4 trunk, the RPN,
    ``MultiProposal``, the ROI op at 1/4 and a class head; the head's
    gradient reaches the trunk through the ROI op."""
    nd = m.nd
    ws = {k: nd.array(v) for k, v in wts.items()}
    for v in ws.values():
        v.attach_grad()
    with m.autograd.record():
        feat = nd.relu(nd.Convolution(nd.array(x), ws["trunk"], kernel=(3, 3),
                                      stride=(4, 4), pad=(1, 1),
                                      num_filter=wts["trunk"].shape[0],
                                      no_bias=True))
        r = nd.relu(nd.Convolution(feat, ws["rpn"], kernel=(3, 3), pad=(1, 1),
                                   num_filter=wts["rpn"].shape[0],
                                   no_bias=True))
        n_a = wts["cls"].shape[0] // 2
        score = nd.Convolution(r, ws["cls"], kernel=(1, 1), num_filter=2 * n_a,
                               no_bias=True)
        b, _, h, w = score.shape
        prob = nd.reshape(nd.softmax(nd.reshape(score, shape=(b, 2, -1)),
                                     axis=1), shape=(b, 2 * n_a, h, w))
        deltas = nd.Convolution(r, ws["box"], kernel=(1, 1),
                                num_filter=4 * n_a, no_bias=True)
        rois = nd.contrib.MultiProposal(
            prob, deltas, nd.array(info), rpn_pre_nms_top_n=40,
            rpn_post_nms_top_n=12, threshold=0.7, rpn_min_size=4,
            scales=(1, 2), ratios=(0.5, 1, 2), feature_stride=4)
        pooled = roi_op(nd, feat, rois)
        logits = nd.FullyConnected(pooled, ws["fc"], num_hidden=5,
                                   no_bias=True)
        loss = nd.sum(logits * logits)
    loss.backward()
    return rois.asnumpy(), logits.asnumpy(), {k: v.grad.asnumpy()
                                              for k, v in ws.items()}


@pytest.mark.parametrize("roi", ["pool", "align"])
def test_small_detection_net_matches_jax(roi):
    """The slice end to end: kept ROI sets equal, logits and every weight's
    gradient within 1e-5 of their magnitude (the RPN's weights get none:
    Proposal is not differentiable, in both packages)."""
    rs = _rs(11)
    x = rs.standard_normal((2, 3, 32, 40)).astype(np.float32)
    wts = _det_weights(rs, 8, 6)
    info = np.array([[32, 40, 1.0], [32, 40, 1.0]], np.float32)
    if roi == "pool":
        def roi_op(nd, f, r):
            return nd.ROIPooling(f, r, pooled_size=(3, 3), spatial_scale=0.25)
    else:
        def roi_op(nd, f, r):
            return nd.contrib.ROIAlign(f, r, pooled_size=(3, 3),
                                       spatial_scale=0.25, sample_ratio=2)
    got = _detect(tmx, x, wts, info, roi_op)
    want = _detect(jmx, x, wts, info, roi_op)
    np.testing.assert_array_equal(got[0][:, 0], want[0][:, 0])
    _close(got[0], want[0], 1e-6, "rois")
    _close(got[1], want[1], REL, "logits")
    for k in wts:
        _close(got[2][k], want[2][k], REL, k)
    assert np.abs(got[2]["trunk"]).sum() > 0


# -- on the card -------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


CARD_CASES = [
    ("ROIPooling", lambda rs: [rs.standard_normal((2, 8, 19, 23))
                               .astype(np.float32),
                               _rois(rs, 12, 2, 60, 60, -10)],
     dict(pooled_size=(7, 7), spatial_scale=0.5), (0,)),
    ("ROIAlign", lambda rs: [rs.standard_normal((2, 8, 19, 23))
                             .astype(np.float32),
                             _rois(rs, 12, 2, 60, 60, -10)],
     dict(pooled_size=(7, 7), spatial_scale=0.5), (0,)),
    ("contrib.PSROIPooling", lambda rs: [rs.standard_normal((2, 18, 19, 23))
                                        .astype(np.float32),
                                        _rois(rs, 12, 2, 60, 60, -10)],
     dict(output_dim=2, pooled_size=3, spatial_scale=0.5), (0,)),
    ("contrib.DeformablePSROIPooling",
     lambda rs: [rs.standard_normal((2, 18, 19, 23)).astype(np.float32),
                 _rois(rs, 12, 2, 60, 60, -10),
                 rs.standard_normal((12, 2, 3, 3)).astype(np.float32)],
     dict(output_dim=2, pooled_size=3, part_size=3, sample_per_part=4,
          trans_std=0.1, spatial_scale=0.5), (0, 2)),
    ("contrib.DeformableConvolution",
     lambda rs: [rs.standard_normal((2, 8, 9, 10)).astype(np.float32),
                 rs.standard_normal((2, 36, 9, 10)).astype(np.float32),
                 rs.standard_normal((6, 8, 3, 3)).astype(np.float32),
                 rs.standard_normal(6).astype(np.float32)],
     dict(kernel=(3, 3), pad=(2, 2), dilate=(2, 2), num_filter=6,
          num_deformable_group=2), (0, 1, 2, 3)),
    ("Correlation", lambda rs: [rs.standard_normal((2, 6, 9, 11))
                                .astype(np.float32) for _ in range(2)],
     dict(max_displacement=4, stride2=2, pad_size=3), (0, 1)),
    ("BilinearSampler", lambda rs: [rs.standard_normal((2, 3, 9, 11))
                                    .astype(np.float32),
                                    rs.uniform(-1.2, 1.2, (2, 2, 6, 7))
                                    .astype(np.float32)], {}, (0, 1)),
    ("GridGenerator", lambda rs: [rs.standard_normal((2, 2, 6, 7))
                                  .astype(np.float32)],
     dict(transform_type="warp"), (0,)),
    ("SpatialTransformer", lambda rs: [
        rs.standard_normal((2, 3, 9, 11)).astype(np.float32),
        (np.tile([1, 0, 0, 0, 1, 0], (2, 1)) + 0.2 *
         rs.standard_normal((2, 6))).astype(np.float32)],
     dict(target_shape=(5, 6)), (0, 1)),
    ("Crop", lambda rs: [rs.standard_normal((2, 3, 9, 11))
                         .astype(np.float32)],
     dict(h_w=(4, 5), center_crop=True), (0,)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,make,params,grads", CARD_CASES,
                         ids=[c[0] for c in CARD_CASES])
def test_card_op_matches_cpu(name, make, params, grads):
    """Each family on the card against the port on the CPU, forward and
    gradients, within 1e-5 of their magnitude (TF32 off: the deformable
    contraction and the affine grid run in f32)."""
    _card()
    arrays = make(_rs(21))
    want = _run(tmx, name, arrays, params, grads)
    with tmx.gpu(0):
        got = _run(tmx, name, arrays, params, grads)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        _close(g, w)


@pytest.mark.cuda
def test_card_proposal_keeps_the_cpu_sets():
    _card()
    cls, d, info = _rpn_inputs(5, 2, 5, 6)
    params = dict(rpn_pre_nms_top_n=120, rpn_post_nms_top_n=40,
                  scales=(2, 4), ratios=(0.5, 1, 2), output_score=True)
    want, _ = _run(tmx, "MultiProposal", [cls, d, info], params)
    with tmx.gpu(0):
        got, _ = _run(tmx, "MultiProposal", [cls, d, info], params)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
