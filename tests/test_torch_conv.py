"""Convolution, Deconvolution, Pooling and Flatten in the PyTorch port against
the JAX build, on the CPU.

Both packages get the same seeded numpy inputs; the port runs through its
``nd`` surface under ``autograd.record()`` and ``backward(head gradient)``,
the JAX build through the registered op and ``jax.vjp``.  Bounds:

* f32 convolutions (forward, d data, d weight, d bias): |Δ| <= 1e-5 of
  the largest |value| of the result: both sum the same f32 products (up to
  C·prod(kernel) of them, or N·spatial for d weight) in other orders,
  ~1e-7 relative each, and a sum of a few hundred products keeps that
  within 1e-6 of its largest terms;
* bf16 convolutions: the product is accumulated in f32 and rounded to bf16,
  then the bias is added and the sum rounded again; summation orders
  differ, so a value near a rounding boundary may round one ulp apart at
  each of the two roundings: |Δ| <= 2^-6 of the largest |value| (two ulps
  at the top binade); the bf16 bias gradient is held against the f32 sum
  of the same bf16 cotangent, rounded once (|Δ| <= 2^-8 of the largest
  |value|), not against the JAX build, whose vjp sums the cotangent in
  bf16 with every add rounded (5.84 summed as 6.47 over 400 terms);
* max pooling copies input values, and its gradient goes to each window's
  first maximum in both (XLA's select-and-scatter, torch's index): exact,
  ties included (the all-zero case);
* avg / sum / lp pooling in f32: 1e-6 of the largest |value| (sums of at
  most 27 terms in other orders, a power and a root); in bf16 2^-6 of the
  largest |value|: the JAX build's reduce_window may round its running sum
  to bf16 at every add of a 3x3 window, the port's once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.ops.registry import get_op as jax_op

F32_REL = 1e-5
BF16_REL = 2.0 ** -6
POOL_REL = {"float32": 1e-6, "bfloat16": 2.0 ** -6}


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _jdt(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def _jax(name, arrays, params, ct, dtype):
    """(output, gradients) of the JAX op by jax.vjp, as f32 numpy."""
    fn = jax_op(name).fcompute
    out, vjp = jax.vjp(lambda *a: fn(*a, **params),
                       *[jnp.asarray(a, _jdt(dtype)) for a in arrays])
    grads = vjp(jnp.asarray(ct, _jdt(dtype)))
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def _port(name, arrays, params, ct, dtype):
    """(output, gradients) of the port's op through ``nd``, record and
    backward."""
    nds = [tmx.nd.array(a, dtype=dtype) for a in arrays]
    for a in nds:
        a.attach_grad()
    with tmx.autograd.record():
        out = getattr(tmx.nd, name)(*nds, **params)
    out.backward(tmx.nd.array(ct, dtype=dtype))
    assert out.dtype == nds[0].dtype
    return out.asnumpy(), [a.grad.asnumpy() for a in nds]


def _check_conv(got, got_g, want, want_g, ct, dtype, bias):
    rel = F32_REL if dtype == "float32" else BF16_REL
    _close(got, want, rel)
    for g, w in zip(got_g[:2], want_g[:2]):
        _close(g, w, rel)
    if bias:
        if dtype == "bfloat16":
            cb = torch.tensor(ct).to(torch.bfloat16).float()
            exact = cb.sum(dim=[0] + list(range(2, cb.ndim)))
            _close(got_g[2], exact.to(torch.bfloat16).float().numpy(),
                   2.0 ** -8)
        else:
            _close(got_g[2], want_g[2], rel)


def _close(got, want, rel):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, rel * scale)


def _rs(seed):
    return np.random.RandomState(seed)


# (data shape, weight shape, bias, params): 1-d, 2-d and 3-d, stride,
# dilate, pad, groups, with and without bias
CONV_CASES = [
    ((2, 3, 11), (4, 3, 3), True, dict(kernel=(3,), stride=(2,), pad=(1,))),
    ((2, 4, 9, 10), (6, 4, 3, 3), True,
     dict(kernel=(3, 3), stride=(2, 1), pad=(1, 2), dilate=(1, 2))),
    ((2, 4, 8, 8), (6, 2, 3, 3), False,
     dict(kernel=(3, 3), pad=(1, 1), num_group=2)),
    ((2, 8, 7, 7), (8, 1, 3, 3), True,
     dict(kernel=(3, 3), stride=(2, 2), num_group=8)),
    ((2, 16, 8, 8), (32, 16, 1, 1), True, dict(kernel=(1, 1), stride=(2, 2))),
    ((1, 2, 5, 6, 7), (3, 2, 3, 2, 3), True,
     dict(kernel=(3, 2, 3), stride=(1, 2, 2), pad=(1, 0, 1),
          dilate=(2, 1, 1))),
]
CONV_IDS = ["1d-stride-pad", "2d-dilate-pad", "2d-groups-nobias",
            "2d-depthwise", "2d-1x1-stride", "3d"]


def _conv_inputs(name, dshape, wshape, bias, params, seed=0):
    rs = _rs(seed)
    params = dict(params, num_filter=wshape[1] * params.get("num_group", 1)
                  if name == "Deconvolution" else wshape[0],
                  no_bias=not bias)
    arrays = [rs.standard_normal(dshape).astype(np.float32),
              rs.standard_normal(wshape).astype(np.float32)]
    if bias:
        arrays.append(rs.standard_normal((params["num_filter"],))
                      .astype(np.float32))
    return arrays, params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dshape,wshape,bias,params", CONV_CASES,
                         ids=CONV_IDS)
def test_convolution_matches_jax(dshape, wshape, bias, params, dtype):
    arrays, params = _conv_inputs("Convolution", dshape, wshape, bias, params)
    fn = jax_op("Convolution").fcompute
    shape = fn(*[jnp.asarray(a) for a in arrays], **params).shape
    ct = _rs(1).standard_normal(shape).astype(np.float32)
    want, want_g = _jax("Convolution", arrays, params, ct, dtype)
    got, got_g = _port("Convolution", arrays, params, ct, dtype)
    _check_conv(got, got_g, want, want_g, ct, dtype, bias)


# Deconvolution: weight (in, out / groups, *kernel), adj below the stride
DECONV_CASES = [
    ((2, 3, 6), (3, 4, 3), True, dict(kernel=(3,), stride=(2,), pad=(1,),
                                      adj=(1,))),
    ((2, 4, 5, 6), (4, 3, 4, 3), True,
     dict(kernel=(4, 3), stride=(2, 3), pad=(1, 1), adj=(0, 2))),
    ((2, 4, 5, 5), (4, 2, 3, 3), False,
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), dilate=(2, 1))),
    ((1, 2, 3, 4, 3), (2, 3, 2, 3, 2), True,
     dict(kernel=(2, 3, 2), stride=(2, 1, 2), pad=(0, 1, 0))),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dshape,wshape,bias,params", DECONV_CASES,
                         ids=["1d-adj", "2d-stride-adj", "2d-dilate-nobias",
                              "3d"])
def test_deconvolution_matches_jax(dshape, wshape, bias, params, dtype):
    arrays, params = _conv_inputs("Deconvolution", dshape, wshape, bias,
                                  params)
    fn = jax_op("Deconvolution").fcompute
    shape = fn(*[jnp.asarray(a) for a in arrays], **params).shape
    ct = _rs(1).standard_normal(shape).astype(np.float32)
    want, want_g = _jax("Deconvolution", arrays, params, ct, dtype)
    got, got_g = _port("Deconvolution", arrays, params, ct, dtype)
    _check_conv(got, got_g, want, want_g, ct, dtype, bias)


def test_convolution_second_order_grad_matches_jax():
    """``autograd.grad(create_graph=True)`` through Convolution, then a
    backward through that gradient: the autograd Function's backward is
    itself differentiable.  Against jax.grad of jax.grad, 1e-5 of the
    largest value (f32 sums in other orders, twice)."""
    rs = _rs(12)
    x = rs.standard_normal((2, 3, 6, 6)).astype(np.float32)
    w = rs.standard_normal((4, 3, 3, 3)).astype(np.float32)
    p = dict(kernel=(3, 3), pad=(1, 1), num_filter=4, no_bias=True)

    def f(xx, ww):
        return jnp.sum(jnp.tanh(jax_op("Convolution").fcompute(xx, ww, **p)))
    want = np.asarray(jax.grad(lambda ww: jnp.sum(
        jax.grad(f)(jnp.asarray(x), ww) ** 2))(jnp.asarray(w)))
    xt, wt = tmx.nd.array(x), tmx.nd.array(w)
    xt.attach_grad()
    wt.attach_grad()
    with tmx.autograd.record():
        y = tmx.nd.sum(tmx.nd.Activation(tmx.nd.Convolution(xt, wt, **p),
                                         act_type="tanh"))
        (gx,) = tmx.autograd.grad(y, [xt], create_graph=True)
        z = tmx.nd.sum(gx * gx)
    z.backward()
    _close(wt.grad.asnumpy(), want, F32_REL)


def test_tf32_guard_holds_across_threads(monkeypatch):
    """Convolutions of 8 threads at once (more than the cores here, with a
    short switch interval): every one runs with TF32 off, and the
    caller's setting (on) is back once all have left."""
    import sys
    import threading
    seen = []
    real = torch.ops.aten.convolution

    def spy(*a):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real(*a)
    monkeypatch.setattr(torch.ops.aten, "convolution", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    x = torch.tensor(_rs(13).standard_normal((1, 2, 6, 6)), dtype=torch.float32)
    w = torch.tensor(_rs(14).standard_normal((3, 2, 3, 3)), dtype=torch.float32)
    from incubator_mxnet_tpu_torch.ops import nn as tnn
    conv = tnn._convolution

    def work():
        for _ in range(50):
            conv(x, w, kernel=(3, 3), no_bias=True)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert len(seen) == 400 and not any(seen)
    assert torch.backends.cudnn.allow_tf32 is True


def test_matmul_tf32_guard_holds_across_threads(monkeypatch):
    """Flash attention's f32 backward in torch ops from 8 threads at once
    (short switch interval): every product runs with cuBLAS's TF32 off,
    and the caller's setting (on) is back once all have left.  The
    products' guard is the convolutions' guard class over the matmul
    flag."""
    import sys
    import threading
    from incubator_mxnet_tpu_torch.ops import _precision
    from incubator_mxnet_tpu_torch.ops import attention as tatt
    from incubator_mxnet_tpu_torch.ops import nn as tnn
    assert isinstance(tatt._f32_products, _precision.FlagOff)
    assert type(tatt._f32_products) is type(tnn._f32_convolutions)
    seen = []
    real = torch.matmul

    def spy(*a, **k):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(*a, **k)
    monkeypatch.setattr(torch, "matmul", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    q, k, v, g = (torch.tensor(_rs(20 + i).standard_normal((1, 1, 4, 8)),
                               dtype=torch.float32) for i in range(4))
    out = torch.zeros_like(q)
    tatt._flash_backward(q, k, v, out, g, True, 0.35)
    per_call = len(seen)
    assert per_call > 0
    del seen[:]

    def work():
        for _ in range(60):
            tatt._flash_backward(q, k, v, out, g, True, 0.35)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert len(seen) == 8 * 60 * per_call and not any(seen)
    assert torch.backends.cuda.matmul.allow_tf32 is True


def test_grouped_deconvolution_is_one_deconvolution_per_group():
    """MXNet's grouped Deconvolution: group g maps input channels
    [g·I/G, (g+1)·I/G) through weight rows of the same range to output
    channels [g·O/G, (g+1)·O/G).  The JAX build raises for num_group > 1
    (its lax call pairs the IOHW weight with the wrong feature axis), so
    the port is held against its own ungrouped Deconvolution, group by
    group."""
    rs = _rs(9)
    x = rs.standard_normal((2, 4, 5, 5)).astype(np.float32)
    w = rs.standard_normal((4, 3, 3, 3)).astype(np.float32)
    b = rs.standard_normal((6,)).astype(np.float32)
    p = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 0))
    got = tmx.nd.Deconvolution(tmx.nd.array(x), tmx.nd.array(w),
                               tmx.nd.array(b), num_filter=6, num_group=2,
                               no_bias=False, **p).asnumpy()
    parts = [tmx.nd.Deconvolution(
        tmx.nd.array(x[:, 2 * g:2 * g + 2]), tmx.nd.array(w[2 * g:2 * g + 2]),
        tmx.nd.array(b[3 * g:3 * g + 3]), num_filter=3, no_bias=False,
        **p).asnumpy() for g in range(2)]
    np.testing.assert_allclose(got, np.concatenate(parts, axis=1),
                               rtol=0, atol=1e-5)


def test_convolution_runs_with_tf32_off_and_restores_the_setting(
        monkeypatch):
    """The scoped guard turns cuDNN's TF32 off around the forward's
    ``aten.convolution`` and the backward's ``aten.convolution_backward``
    (which reads the setting when the backward runs), and restores the
    caller's setting after each."""
    seen = []
    for name in ("convolution", "convolution_backward"):
        real = getattr(torch.ops.aten, name)

        def spy(*a, _real=real, _name=name):
            seen.append((_name, torch.backends.cudnn.allow_tf32))
            return _real(*a)
        monkeypatch.setattr(torch.ops.aten, name, spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    arrays, params = _conv_inputs("Convolution", *CONV_CASES[1])
    shape = jax_op("Convolution").fcompute(
        *[jnp.asarray(a) for a in arrays], **params).shape
    _port("Convolution", arrays, params, np.ones(shape, np.float32),
          "float32")
    assert seen == [("convolution", False), ("convolution_backward", False)]
    assert torch.backends.cudnn.allow_tf32 is True


# (shape, params): every pool type, valid / full / global, count_include_pad
POOL_CASES = [
    ((2, 3, 9, 8), dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1))),
    ((2, 3, 9, 8), dict(kernel=(3, 2), stride=(2, 3), pad=(1, 0),
                        pooling_convention="full")),
    ((2, 3, 7, 7), dict(kernel=(3, 3), global_pool=True)),
    ((2, 3, 10), dict(kernel=(3,), stride=(2,), pad=(1,),
                      pooling_convention="full")),
    ((1, 2, 5, 6, 7), dict(kernel=(2, 3, 2), stride=(2, 2, 1), pad=(1, 1, 0))),
]
POOL_IDS = ["2d-valid", "2d-full", "2d-global", "1d-full", "3d-valid"]


def _pool_case(shape, params, pool_type, count_include_pad):
    params = dict(params, pool_type=pool_type)
    if pool_type == "avg":
        params["count_include_pad"] = count_include_pad
    x = _rs(2).standard_normal(shape).astype(np.float32)
    shape_out = jax_op("Pooling").fcompute(jnp.asarray(x), **params).shape
    ct = _rs(3).standard_normal(shape_out).astype(np.float32)
    return x, params, ct


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool_type,count_include_pad",
                         [("max", True), ("avg", True), ("avg", False),
                          ("sum", True), ("lp", True)],
                         ids=["max", "avg", "avg-excl-pad", "sum", "lp"])
@pytest.mark.parametrize("shape,params", POOL_CASES, ids=POOL_IDS)
def test_pooling_matches_jax(shape, params, pool_type, count_include_pad,
                             dtype):
    x, params, ct = _pool_case(shape, params, pool_type, count_include_pad)
    if pool_type == "lp":
        x = np.abs(x) + 0.5      # the root's gradient stays finite
    want, (want_g,) = _jax("Pooling", [x], params, ct, dtype)
    got, (got_g,) = _port("Pooling", [x], params, ct, dtype)
    if pool_type == "max":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_g, want_g)
    else:
        _close(got, want, POOL_REL[dtype])
        _close(got_g, want_g, POOL_REL[dtype])


def test_pooling_full_is_not_ceil_mode():
    """The two shapes of the probe: at (1,1,5,5), kernel 2, stride 2, pad 1
    the JAX build gives 4x4 where torch's ceil_mode gives 3x3; at (1,1,6,6),
    kernel 3, stride 2, pad 1, avg, the shapes agree but torch's divisor
    differs by up to 0.138.  The port follows the JAX build."""
    x = np.arange(25, dtype=np.float32).reshape(1, 1, 5, 5)
    p = dict(kernel=(2, 2), stride=(2, 2), pad=(1, 1),
             pooling_convention="full", pool_type="max")
    want = np.asarray(jax_op("Pooling").fcompute(jnp.asarray(x), **p))
    got = tmx.nd.Pooling(tmx.nd.array(x), **p).asnumpy()
    assert want.shape == got.shape == (1, 1, 4, 4)
    np.testing.assert_array_equal(got, want)
    ceil = torch.nn.functional.max_pool2d(torch.tensor(x), 2, 2, 1,
                                          ceil_mode=True)
    assert tuple(ceil.shape) == (1, 1, 3, 3)

    x = _rs(4).standard_normal((1, 1, 6, 6)).astype(np.float32)
    p = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
             pooling_convention="full", pool_type="avg")
    want = np.asarray(jax_op("Pooling").fcompute(jnp.asarray(x), **p))
    got = tmx.nd.Pooling(tmx.nd.array(x), **p).asnumpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    ceil = torch.nn.functional.avg_pool2d(torch.tensor(x), 3, 2, 1,
                                          ceil_mode=True).numpy()
    assert ceil.shape == want.shape
    assert np.abs(ceil - want).max() > 0.05


def test_max_pooling_ties_route_to_the_first_element():
    """All zeros (ResNet's stem max-pools post-relu zeros): every window is
    a tie, and both packages send its gradient to the window's first
    element."""
    x = np.zeros((1, 1, 4, 4), np.float32)
    p = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max")
    ct = np.arange(1, 5, dtype=np.float32).reshape(1, 1, 2, 2)
    want, (want_g,) = _jax("Pooling", [x], p, ct, "float32")
    got, (got_g,) = _port("Pooling", [x], p, ct, "float32")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_g, want_g)
    assert got_g[0, 0, 0, 0] == 1.0 and got_g.sum() == ct.sum()


@pytest.mark.parametrize("pool_type", ["max", "sum", "avg"])
def test_integer_pooling_matches_jax(pool_type):
    """Integer max pooling pads with iinfo.min, the sums with 0; avg
    divides into float32, as the JAX build."""
    x = _rs(5).randint(-50, 50, (2, 2, 7, 6)).astype(np.int32)
    p = dict(kernel=(3, 2), stride=(2, 2), pad=(1, 1), pool_type=pool_type,
             pooling_convention="full")
    want = np.asarray(jax_op("Pooling").fcompute(jnp.asarray(x), **p))
    got = tmx.nd.Pooling(tmx.nd.array(x, dtype="int32"), **p).asnumpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_flatten_matches_jax():
    x = _rs(6).standard_normal((2, 3, 4, 5)).astype(np.float32)
    ct = _rs(7).standard_normal((2, 60)).astype(np.float32)
    want, (want_g,) = _jax("Flatten", [x], {}, ct, "float32")
    got, (got_g,) = _port("Flatten", [x], {}, ct, "float32")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_g, want_g)
    a = tmx.nd.array(x)
    out = tmx.nd.flatten(a)
    out[:] = 0                      # a result never aliases its input
    assert a.asnumpy().any()
    with tmx.cpu():
        layer = tmx.gluon.nn.Flatten()
        assert layer(a).shape == (2, 60) and repr(layer) == "Flatten"


def _layer_pair(make):
    import incubator_mxnet_tpu as jmx
    return make(jmx.gluon.nn), make(tmx.gluon.nn)


@pytest.mark.parametrize("make,shape", [
    (lambda nn: nn.Conv1D(4, 3, strides=2, padding=1), (2, 3, 9)),
    (lambda nn: nn.Conv2D(6, (3, 2), strides=(2, 1), padding=(1, 0),
                          dilation=(1, 2), groups=2, use_bias=False,
                          activation="relu"), (2, 4, 8, 9)),
    (lambda nn: nn.Conv3D(3, 2, in_channels=2), (1, 2, 4, 5, 4)),
    (lambda nn: nn.Conv1DTranspose(4, 3, strides=2, padding=1,
                                   output_padding=1), (2, 3, 5)),
    (lambda nn: nn.Conv2DTranspose(4, 3, strides=2, padding=1,
                                   output_padding=1), (2, 4, 4, 5)),
    (lambda nn: nn.Conv3DTranspose(2, 2, strides=2), (1, 3, 3, 2, 3)),
    (lambda nn: nn.MaxPool1D(3, 2, 1, ceil_mode=True), (2, 3, 10)),
    (lambda nn: nn.MaxPool2D(3, 2, 1), (2, 3, 9, 8)),
    (lambda nn: nn.MaxPool3D(2), (1, 2, 4, 5, 4)),
    (lambda nn: nn.AvgPool1D(2), (2, 3, 9)),
    (lambda nn: nn.AvgPool2D(3, 2, 1, ceil_mode=True), (2, 3, 9, 8)),
    (lambda nn: nn.AvgPool3D(2, ceil_mode=True), (1, 2, 5, 5, 3)),
    (lambda nn: nn.GlobalMaxPool1D(), (2, 3, 9)),
    (lambda nn: nn.GlobalMaxPool2D(), (2, 3, 5, 4)),
    (lambda nn: nn.GlobalMaxPool3D(), (1, 2, 3, 4, 3)),
    (lambda nn: nn.GlobalAvgPool1D(), (2, 3, 9)),
    (lambda nn: nn.GlobalAvgPool2D(), (2, 3, 5, 4)),
    (lambda nn: nn.GlobalAvgPool3D(), (1, 2, 3, 4, 3)),
], ids=["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
        "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
        "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
        "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
        "GlobalAvgPool2D", "GlobalAvgPool3D"])
def test_conv_layers_match_jax(make, shape):
    """Every layer of conv_layers.py: the same parameter names and shapes
    (deferred ``in_channels`` resolved from the input), the same
    ``__repr__``, and the same output from the JAX build's weights."""
    import incubator_mxnet_tpu as jmx
    jl, tl = _layer_pair(make)
    x = _rs(8).standard_normal(shape).astype(np.float32)
    jl.initialize(jmx.init.Xavier())
    want = jl(jmx.nd.array(x)).asnumpy()
    tl.initialize()
    tl(tmx.nd.array(x))
    jp, tp = jl.collect_params(), tl.collect_params()
    assert [n[len(jl.prefix):] for n in jp.keys()] == \
        [n[len(tl.prefix):] for n in tp.keys()]
    for (_, j), (_, t) in zip(jp.items(), tp.items()):
        assert j.shape == t.shape
        t.set_data(tmx.nd.array(j.data().asnumpy()))
    assert repr(tl) == repr(jl)
    _close(tl(tmx.nd.array(x)).asnumpy(), want, F32_REL)


def test_layout_other_than_nc_first_raises():
    with pytest.raises(ValueError, match="NCHW"):
        tmx.gluon.nn.MaxPool2D(layout="NHWC")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("dshape,wshape,bias,params", CONV_CASES,
                         ids=CONV_IDS)
def test_card_convolution_f32_matches_cpu(dshape, wshape, bias, params):
    """f32 on the card, with torch's TF32 default (on) around the call: the
    op's guard keeps cuDNN in f32, so forward and gradients stay within
    F32_REL of the CPU (a TF32 product is off by ~5e-4)."""
    _card()
    arrays, params = _conv_inputs("Convolution", dshape, wshape, bias, params)
    shape = jax_op("Convolution").fcompute(
        *[jnp.asarray(a) for a in arrays], **params).shape
    ct = _rs(1).standard_normal(shape).astype(np.float32)
    want, want_g = _port("Convolution", arrays, params, ct, "float32")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with tmx.gpu(0):
            got, got_g = _port("Convolution", arrays, params, ct, "float32")
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    _close(got, want, F32_REL)
    for g, w in zip(got_g, want_g):
        _close(g, w, F32_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("pool_type", ["max", "avg", "sum"])
def test_card_pooling_matches_cpu(pool_type):
    """Pooling on the card, full convention, and max pooling's ties (all
    zeros) routed to each window's first element as on the CPU."""
    _card()
    for x in (np.zeros((2, 3, 9, 8), np.float32),
              _rs(10).standard_normal((2, 3, 9, 8)).astype(np.float32)):
        p = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                 pool_type=pool_type, pooling_convention="full")
        shape = jax_op("Pooling").fcompute(jnp.asarray(x), **p).shape
        ct = _rs(11).standard_normal(shape).astype(np.float32)
        want, (want_g,) = _port("Pooling", [x], p, ct, "float32")
        with tmx.gpu(0):
            got, (got_g,) = _port("Pooling", [x], p, ct, "float32")
        _close(got, want, POOL_REL["float32"])
        _close(got_g, want_g, POOL_REL["float32"])
        if pool_type == "max":
            np.testing.assert_array_equal(got_g, want_g)
