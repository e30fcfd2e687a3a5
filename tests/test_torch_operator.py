"""Custom operators in the PyTorch port against the JAX build, on the CPU.

The op under test is ``rtc_softmax``, defined once in ``chip_smoke.py``
(``register_rtc_softmax``): on the card it launches runtime-compiled
kernels, and on a CPU array, as here, it runs their plain PyTorch versions.
Its forward and the gradient it sends through ``FullyConnected`` into W are
held against two oracles of the JAX build: ``nd.Custom`` with the same body
written in numpy, and ``SoftmaxOutput`` (grad p - onehot(label), trap A3).
Tolerance 1e-5: both sides sum the same f32 products in other orders.
The ``cuda`` cases run the same comparisons on gpu(0), where the op
launches its NVRTC kernels, and skip without a card.
"""
import numpy as np
import pytest
import torch

import chip_smoke
import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.base import MXNetError

TOL = dict(rtol=1e-5, atol=1e-5)
N, D, V = 64, 64, 97


@pytest.fixture(autouse=True)
def _on_cpu():
    chip_smoke.register_rtc_softmax(tmx)
    with tmx.cpu():
        yield


def _softmax_np(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


class _NumpySoftmax(jmx.operator.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        self.assign(out_data[0], req[0],
                    jmx.nd.array(_softmax_np(in_data[0].asnumpy())))

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        p = out_data[0].asnumpy()
        label = in_data[1].asnumpy().astype(np.int64)
        self.assign(in_grad[0], req[0],
                    jmx.nd.array(p - np.eye(p.shape[1], dtype=p.dtype)[label]))


@jmx.operator.register("np_softmax_output")
class _NumpySoftmaxProp(jmx.operator.CustomOpProp):
    def __init__(self):
        super().__init__(need_top_grad=False)

    def list_arguments(self):
        return ["data", "label"]

    def infer_shape(self, in_shape):
        return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return _NumpySoftmax()


def _data(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((N, D)).astype(np.float32),
            (rs.standard_normal((V, D)) * 0.1).astype(np.float32),
            (rs.standard_normal(V) * 0.1).astype(np.float32),
            rs.randint(0, V, N).astype(np.float32))


def _head(mx, out_fn, h, w, b, label, steps=1, lr=0.0):
    """``steps`` SGD steps of FullyConnected -> out_fn; returns the first p,
    the first W.grad and W after the steps."""
    H, W, B, L = (mx.nd.array(a) for a in (h, w, b, label))
    first = None
    for _ in range(steps):
        W.attach_grad()
        with mx.autograd.record():
            p = out_fn(mx, mx.nd.FullyConnected(H, W, B, num_hidden=V), L)
        p.backward()
        if first is None:
            first = (p.asnumpy(), W.grad.asnumpy())
        mx.nd.sgd_update(W, W.grad, lr=lr, out=W)
    return first[0], first[1], W.asnumpy()


def _rtc(mx, z, label):
    return mx.nd.Custom(z, label, op_type="rtc_softmax")


def _np_custom(mx, z, label):
    return mx.nd.Custom(z, label, op_type="np_softmax_output")


def _softmax_output(mx, z, label):
    return mx.nd.SoftmaxOutput(z, label)


@pytest.mark.parametrize("oracle", [_np_custom, _softmax_output],
                         ids=["jax_custom_numpy", "jax_SoftmaxOutput"])
def test_rtc_softmax_matches_jax(oracle):
    args = _data()
    want_p, want_g, _ = _head(jmx, oracle, *args)
    got_p, got_g, _ = _head(tmx, _rtc, *args)
    np.testing.assert_allclose(got_p, want_p, **TOL)
    np.testing.assert_allclose(got_g, want_g, **TOL)
    z = torch.from_numpy(args[0] @ args[1].T + args[2])
    np.testing.assert_allclose(got_p, chip_smoke.softmax_plain(z).numpy(),
                               **TOL)


def test_head_sgd_trajectory_matches_jax():
    args = _data(1)
    want = _head(jmx, _softmax_output, *args, steps=3, lr=0.05)[2]
    got = _head(tmx, _rtc, *args, steps=3, lr=0.05)[2]
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(got - args[1]).max() > 1e-2     # the steps moved W


# -- on the card: the rtc kernels, not the plain branch ------------------------

@pytest.fixture
def card_kernels():
    """rtc_softmax registered with its NVRTC kernels, arrays on gpu(0), TF32
    off so the GEMMs stay f32 as on the JAX side."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernels = chip_smoke.rtc_module(tmx)[1]
    chip_smoke.register_rtc_softmax(tmx, kernels)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    with tmx.gpu(0):
        yield kernels
    torch.backends.cuda.matmul.allow_tf32 = prev


def _softmax_launches(kernels):
    return [kernels[n].launches for n in ("softmax_fwd", "softmax_bwd")]


@pytest.mark.cuda
@pytest.mark.parametrize("oracle", [_np_custom, _softmax_output],
                         ids=["jax_custom_numpy", "jax_SoftmaxOutput"])
def test_rtc_kernels_on_card_match_jax(card_kernels, oracle):
    args = _data()
    want_p, want_g, _ = _head(jmx, oracle, *args)
    got_p, got_g, _ = _head(tmx, _rtc, *args)
    assert _softmax_launches(card_kernels) == [1, 1]
    np.testing.assert_allclose(got_p, want_p, **TOL)
    np.testing.assert_allclose(got_g, want_g, **TOL)


@pytest.mark.cuda
def test_head_sgd_trajectory_on_card_matches_jax(card_kernels):
    args = _data(1)
    want = _head(jmx, _softmax_output, *args, steps=3, lr=0.05)[2]
    got = _head(tmx, _rtc, *args, steps=3, lr=0.05)[2]
    assert _softmax_launches(card_kernels) == [3, 3]
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(got - args[1]).max() > 1e-2     # the steps moved W


@pytest.mark.cuda
def test_rtc_softmax_on_card_without_kernels_raises(card_kernels):
    chip_smoke.register_rtc_softmax(tmx)
    with pytest.raises(MXNetError, match="needs the rtc kernels"):
        tmx.nd.Custom(tmx.nd.zeros((2, 3)), tmx.nd.zeros(2),
                      op_type="rtc_softmax")


# softmax_fwd's launch geometry: whole warps; the one-read path exactly when
# the row is a whole number of float4 and fits the block's registers, on the
# least block that holds it
@pytest.mark.parametrize("c", [1, 4, 97, 1000, 1024, 16384, 16385, 32768,
                               32772, 40000])
def test_softmax_geometry(c):
    block, shared, one_read = chip_smoke.softmax_geometry(c)
    per_thread = 4 * chip_smoke.SOFTMAX_VEC
    assert block % 32 == 0 and 32 <= block <= 1024 and shared == 0
    assert one_read == (c % 4 == 0 and c <= per_thread * 1024)
    if one_read:
        assert block * per_thread >= c > (block - 32) * per_thread
    else:
        assert block == chip_smoke.SOFTMAX_THREADS


# softmax_fwd on the card at the geometry of its path, both of its paths
# (16385: c % 4 != 0; 40000: past the registers), rows of magnitude up to
# 80, against softmax_plain at the rtc phase's bound
@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 1000, 16384, 16385, 40000])
def test_softmax_fwd_widths_on_card(card_kernels, c):
    rs = np.random.RandomState(c)
    z = tmx.nd.array(rs.uniform(-80, 80, (6, c)).astype(np.float32),
                     ctx=tmx.gpu(0))
    p = tmx.nd.empty((6, c), ctx=tmx.gpu(0))
    block, shared, _ = chip_smoke.softmax_geometry(c)
    card_kernels["softmax_fwd"].launch([z, p, c], tmx.gpu(0), (6,), (block,),
                                       shared)
    torch.cuda.synchronize()
    want = chip_smoke.softmax_plain(z._data)
    assert (p._data - want).abs().max().item() <= \
        chip_smoke.RTC_TOLERANCE["softmax_fwd"]


# softmax_bwd's launch geometry: whole warps, at most BWD_THREADS, each
# thread at most BWD_VEC float4 (or elements) of a row unless the block is
# full, rows enough for about BWD_BLOCK_ELEMENTS elements, float4 exactly
# when c % 4 == 0
@pytest.mark.parametrize("c", [1, 3, 4, 97, 1000, 1024, 16384, 16385, 40000,
                               1 << 20])
def test_softmax_bwd_geometry(c):
    block, rows, vec = chip_smoke.softmax_bwd_geometry(c)
    assert vec == (c % 4 == 0)
    assert block % 32 == 0 and 32 <= block <= chip_smoke.BWD_THREADS
    units = c // 4 if vec else c
    assert block * chip_smoke.BWD_VEC >= units or \
        block == chip_smoke.BWD_THREADS
    assert block == 32 or (block - 32) * chip_smoke.BWD_VEC < units
    assert rows >= 1
    assert rows * c <= max(chip_smoke.BWD_BLOCK_ELEMENTS, c)
    assert (rows + 1) * c > chip_smoke.BWD_BLOCK_ELEMENTS


# axpy's launch geometry: one pass of float4 covers n (its loop strides over
# the grid anyway), at least one block
@pytest.mark.parametrize("n", [1, 3, 8, 4095, 4096, 4097, 2 ** 26 + 3])
def test_axpy_geometry(n):
    grid, block = chip_smoke.axpy_geometry(n)
    assert block == chip_smoke.AXPY_THREADS and grid >= 1
    span = 4 * chip_smoke.AXPY_VEC * block
    assert grid * span >= n > (grid - 1) * span or grid == 1


def _card_base_offset(t, offset):
    """``t`` copied into a flat buffer ``offset`` floats in (a view whose
    base is 16-byte aligned only when offset % 4 == 0)."""
    flat = torch.empty(t.numel() + offset, device=t.device)
    flat[offset:] = t.reshape(-1)
    return flat[offset:].view(t.shape)


# softmax_bwd on the card at the geometry of its path: float4 rows (1000,
# 16384, 40000), scalar rows (1, 16385) and an unaligned base, bit for bit
# against softmax_bwd_plain (p - 1.0 is one IEEE op, p - 0.0 a copy)
@pytest.mark.cuda
@pytest.mark.parametrize("c,offset", [(1, 0), (1000, 0), (16384, 0),
                                      (16385, 0), (40000, 0), (16384, 1)])
def test_softmax_bwd_widths_on_card(card_kernels, c, offset):
    rows = 37
    rs = np.random.RandomState(c + offset)
    p = _card_base_offset(torch.from_numpy(
        rs.uniform(0, 1, (rows, c)).astype(np.float32)).cuda(), offset)
    label = rs.randint(0, c, rows)
    label[:2] = (0, c - 1)                       # both ends of the row
    lab = tmx.nd.array(label.astype(np.float32), ctx=tmx.gpu(0))
    dz = tmx.nd.empty((rows, c), ctx=tmx.gpu(0))
    block, per, _ = chip_smoke.softmax_bwd_geometry(c)
    card_kernels["softmax_bwd"].launch(
        [tmx.nd.NDArray(p), lab, dz, rows, c], tmx.gpu(0), (-(-rows // per),),
        (block,))
    torch.cuda.synchronize()
    assert torch.equal(dz._data, chip_smoke.softmax_bwd_plain(p, lab._data))


# axpy on the card: the scalar tail alone (n = 1, 3), float4 only (8), both
# at the timing size (2^26 + 3), and unaligned bases; bit for bit
@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(1, 0), (3, 0), (8, 0), (2 ** 26 + 3, 0),
                                      (1027, 1)])
def test_axpy_on_card(card_kernels, n, offset):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(n)
    x, y = (_card_base_offset(torch.randn(n, generator=gen, device="cuda"),
                              offset) for _ in range(2))
    o = tmx.nd.empty((n,), ctx=tmx.gpu(0))
    grid, block = chip_smoke.axpy_geometry(n)
    card_kernels["axpy"].launch([tmx.nd.NDArray(x), tmx.nd.NDArray(y), o, n],
                                tmx.gpu(0), (grid,), (block,))
    torch.cuda.synchronize()
    assert torch.equal(o._data, 2 * x + y)


class _TwoOut:
    """Outputs (2x, x + 1); input grad 2·g0 + g1.  Written on the NDArray
    surface both packages share."""

    @staticmethod
    def register(mx, name, seen):
        class Op(mx.operator.CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                self.assign(out_data[0], req[0], in_data[0] * 2.0)
                self.assign(out_data[1], req[1], in_data[0] + 1.0)

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                seen.append(list(req))
                self.assign(in_grad[0], req[0],
                            out_grad[0] * 2.0 + out_grad[1])

        class Prop(mx.operator.CustomOpProp):
            def list_outputs(self):
                return ["double", "plus1"]

            def create_operator(self, ctx, in_shapes, in_dtypes):
                return Op()

        mx.operator.register(name)(Prop)


def test_two_output_custom_op_matches_jax():
    rs = np.random.RandomState(3)
    x0 = rs.standard_normal((4, 5)).astype(np.float32)
    heads = [rs.standard_normal((4, 5)).astype(np.float32) for _ in range(2)]
    res = {}
    for mx in (jmx, tmx):
        seen = []
        _TwoOut.register(mx, "two_out", seen)
        x = mx.nd.array(x0)
        x.attach_grad()
        with mx.autograd.record():
            y0, y1 = mx.nd.Custom(x, op_type="two_out")
        mx.autograd.backward([y0, y1], [mx.nd.array(g) for g in heads])
        res[mx] = (y0.asnumpy(), y1.asnumpy(), x.grad.asnumpy())
    for g, w in zip(res[tmx], res[jmx]):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(res[tmx][2], 2 * heads[0] + heads[1], **TOL)
    assert "two_out" in tmx.operator.get_all_registered_operators()


def test_input_without_grad_gets_null_req():
    seen = []
    _TwoOut.register(tmx, "two_out_req", seen)
    x, y = tmx.nd.ones((2, 3)), tmx.nd.ones((2, 3))
    x.attach_grad()
    with tmx.autograd.record():
        a, _ = tmx.nd.Custom(x, op_type="two_out_req")
        b, _ = tmx.nd.Custom(y * 1.0, op_type="two_out_req")
        z = a + b
    z.backward()
    assert seen == [["write"]]          # only x's branch needs a gradient
    np.testing.assert_array_equal(x.grad.asnumpy(), np.full((2, 3), 2.0))


@pytest.mark.parametrize("req,want", [("null", 1.0), ("write", 5.0),
                                      ("inplace", 5.0), ("add", 6.0)])
def test_assign_honours_req(req, want):
    dst = tmx.nd.ones((2, 2))
    tmx.operator.CustomOp().assign(dst, req, tmx.nd.full((2, 2), 5.0))
    np.testing.assert_array_equal(dst.asnumpy(), np.full((2, 2), want))


def test_assign_unknown_req_raises():
    with pytest.raises(ValueError):
        tmx.operator.CustomOp().assign(tmx.nd.ones(2), "bogus", tmx.nd.ones(2))


def test_unknown_op_type_raises():
    with pytest.raises(MXNetError, match="not registered"):
        tmx.nd.Custom(tmx.nd.ones(2), op_type="no_such_op")
    with pytest.raises(TypeError):
        tmx.nd.Custom(tmx.nd.ones(2))


def test_outside_record_builds_no_graph():
    h, w, b, label = _data()
    p = tmx.nd.Custom(tmx.nd.array(h @ w.T + b), tmx.nd.array(label),
                      op_type="rtc_softmax")
    assert not p._data.requires_grad
    np.testing.assert_allclose(p.asnumpy().sum(-1), np.ones(N), **TOL)
