"""Flash attention in the PyTorch port against the JAX build, and its
hand-written CUDA kernel against the plain version.

The CPU cases feed the same seeded numpy inputs to the JAX build's
``flash_attention`` (on the CPU it takes its own jnp reference,
ops/attention.py:149-152) and to the port's, which on a CPU tensor takes
its plain PyTorch version.  A plain emulation of the bf16 kernel's
arithmetic (csrc/flash_attention_sm90.cu: S in f32 from bf16 products, P
split into two bf16 halves) is held against the JAX build under a
per-element bound, and the same emulation with P rounded to bf16 once must
break it.  So is the f32 route's (csrc/flash_attention_f32_sm90.cu: every
f32 operand split into three bf16 pieces, six products for each f32
product) at the f32 bound 2e-5, and with one piece it must break 1e-4.  The
``cuda`` cases hold the kernel against the plain version and the JAX build
on the card; they skip without one:

    python -m pytest -m cuda tests/test_torch_attention.py
"""
import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.ops.attention import flash_attention as jax_flash
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ops import attention as tatt

# (B, H, Sq, Sk, D), causal — the chip smoke's shapes, with the serving
# shape (8, 32, 1024, 1024, 128) cut to one (batch, head) pair on the CPU
CASES = [
    ((2, 4, 256, 256, 64), False),
    ((2, 4, 256, 256, 64), True),
    ((1, 2, 128, 256, 64), True),
    ((1, 2, 256, 128, 64), True),
    ((1, 3, 40, 40, 24), False),
    ((1, 3, 40, 40, 24), True),
    ((1, 1, 1024, 1024, 128), True),
]
# on the card also the head-dim buckets (D = 32, 96, 128; D = 20 is padded
# to 24 by the wrapper) and the tile edges (Sk = 1, 65, 200; Sq > Sk)
EDGE_CASES = [
    ((2, 3, 192, 192, 32), True),
    ((1, 2, 200, 200, 96), False),
    ((1, 2, 64, 1, 128), False),
    ((1, 2, 64, 1, 128), True),      # 63 rows see no key
    ((1, 2, 65, 65, 128), True),
    ((1, 2, 300, 200, 128), True),   # Sq > Sk at D = 128
    ((1, 2, 77, 77, 20), True),
]
# head dims 129-256: two output slices a block column, 160 and 192 with the
# last Q/K panel and the second slice's second V panel never loaded
WIDE_CASES = [
    ((1, 2, 200, 200, 160), True),
    ((2, 2, 130, 130, 192), False),
    ((1, 2, 256, 256, 256), True),
    ((1, 1, 77, 300, 256), True),    # Sq < Sk, ragged rows and keys
]
CARD_CASES = CASES[:-1] + [((8, 32, 1024, 1024, 128), True)] + EDGE_CASES + \
    WIDE_CASES


def _ids(cases):
    return ["%dx%dx%dx%dx%d%s" % (s + ("_causal" if c else "",))
            for s, c in cases]


IDS = _ids(CASES)
CARD_IDS = _ids(CARD_CASES)
# the per-element bound of the bf16 kernel against the f32 result: one bf16
# rounding (2^-9 relative) plus as much again for the f32 arithmetic; the
# f16 kernel's is the same with f16's 2^-12 rounding
BF16_REL, BF16_ABS = 2.0 ** -8, 5e-5
F16_REL = 2.0 ** -11


def _inputs(shape, seed=0):
    b, h, sq, sk, d = shape
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((b, h, sq, d)).astype(np.float32),
            rs.standard_normal((b, h, sk, d)).astype(np.float32),
            rs.standard_normal((b, h, sk, d)).astype(np.float32))


def _jax_flash(q, k, v, causal, dtype="float32"):
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    return np.asarray(jax_flash(*args, causal).astype(jnp.float32))


def _bf16_values(*arrays, dtype=torch.bfloat16):
    """The numpy arrays rounded to bf16 (or ``dtype``), as float32 numpy
    arrays."""
    return [torch.from_numpy(x).to(dtype).float().numpy() for x in arrays]


def _violations(out, ref, rel=BF16_REL):
    """Elements of ``out`` outside rel·|ref| + 5e-5 of ``ref`` (rel 2^-8 for
    bf16, 2^-11 for f16: one rounding to the type, and as much again)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return int((np.abs(out - ref) > rel * np.abs(ref) + BF16_ABS).sum())


def _panel_matmul(a, b, panel):
    """a @ b in f32 as the wide kernels accumulate it: the products of each
    ``panel`` columns of a (rows of b) summed in the order of the panels
    (``panel`` None: one product)."""
    if panel is None:
        return torch.matmul(a, b)
    acc = None
    for c0 in range(0, a.shape[-1], panel):
        term = torch.matmul(a[..., c0:c0 + panel], b[..., c0:c0 + panel, :])
        acc = term if acc is None else acc + term
    return acc


def _bf16_kernel_emulation(q, k, v, causal, split=True, block_n=64,
                           dtype=torch.bfloat16, panel=None):
    """The 16-bit kernel's arithmetic in plain PyTorch (test-only), for
    ``dtype`` bf16 or f16: q, k, v of that type; S = Q·Kᵀ in f32 from exact
    products (``panel`` 64: summed panel by panel, as route A of
    csrc/flash_attention_wide_sm90.cu streams Q and K at D > 256; its
    256-column output slices each see the whole S, so they change no
    value); an online softmax in log2 units over tiles of ``block_n`` keys;
    O += P_hi·V + P_lo·V with P_hi = T(P) and P_lo = T(P - P_hi), products
    in f32 (``split`` False: O += T(P)·V, the design the split avoids); o
    rounded to the type once."""
    qf, kf, vf = (t.to(dtype).float() for t in (q, k, v))
    sq, sk, d = qf.shape[-2], kf.shape[-2], qf.shape[-1]
    scale_log2 = (1.0 / np.sqrt(d)) * 1.4426950408889634
    rows = torch.arange(sq)[:, None]
    m = torch.full(qf.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for n0 in range(0, sk, block_n):
        kt, vt = kf[..., n0:n0 + block_n, :], vf[..., n0:n0 + block_n, :]
        x = _panel_matmul(qf, kt.transpose(-1, -2), panel) * scale_log2
        if causal:
            cols = torch.arange(n0, n0 + kt.shape[-2])[None, :]
            x = x.masked_fill(cols > rows + sk - sq, -1e30)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        p_hi = p.to(dtype).float()
        if split:
            p_lo = (p - p_hi).to(dtype).float()
            acc = acc * alpha + (torch.matmul(p_hi, vt) + torch.matmul(p_lo, vt))
        else:
            acc = acc * alpha + torch.matmul(p_hi, vt)
        m = m_new
    return (acc / l.clamp_min(1e-20)).to(dtype)


# The six products of the f32 route's split, in the kernel's issue order
# (small terms first, hh last): (piece of A, piece of B), 0 = h, 1 = m, 2 = l
F32_PRODUCTS = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))
LOG2E = 1.4426950408889634


def _pieces(x, n):
    """``x`` as ``n`` bf16 pieces (float32 tensors): each the rounding of what
    the earlier ones left."""
    out, rest = [], x
    for _ in range(n):
        out.append(rest.to(torch.bfloat16).float())
        rest = rest - out[-1]
    return out


def _split_matmul(a, b, pieces, panel=None):
    """a @ b as the kernel computes it from ``pieces`` bf16 pieces of each
    operand: the products of F32_PRODUCTS whose ranks add up to less than
    ``pieces`` (all six for 3, hh alone for 1), each exact, summed in f32 in
    the kernel's order: each product over the whole of a's columns in turn;
    or (``panel`` 64, route B of csrc/flash_attention_wide_sm90.cu) a walk
    over the panels of columns with the small products of each panel, then
    a second walk adding hh panel by panel."""
    pa, pb = _pieces(a, pieces), _pieces(b, pieces)
    acc = None
    if panel is None:
        for i, j in F32_PRODUCTS:
            if i + j < pieces:
                term = torch.matmul(pa[i], pb[j])
                acc = term if acc is None else acc + term
        return acc
    cols = range(0, a.shape[-1], panel)
    for small in (True, False):
        for c0 in cols:
            for i, j in F32_PRODUCTS:
                if i + j < pieces and ((i, j) != (0, 0)) == small:
                    term = torch.matmul(pa[i][..., c0:c0 + panel],
                                        pb[j][..., c0:c0 + panel, :])
                    acc = term if acc is None else acc + term
    return acc


def _f32_split_kernel_emulation(q, k, v, causal, pieces=3, block_n=64,
                                panel=None):
    """The f32 kernel's arithmetic in plain PyTorch (test-only): q scaled in
    f32 and split, as k and v, into ``pieces`` bf16 pieces; S = Q·Kᵀ from
    the split products into f32 (``panel`` 64: panel by panel, as route B
    streams Q's and K's planes at D > 256; its 256-column output slices
    each see the whole S); an online softmax in log2 units over tiles of
    ``block_n`` keys; O += P·V with P split the same way; o in f32."""
    q, k, v = (t.to(torch.float32) for t in (q, k, v))
    sq, sk, d = q.shape[-2], k.shape[-2], q.shape[-1]
    qs = q * (1.0 / np.sqrt(d))
    rows = torch.arange(sq)[:, None]
    m = torch.full(q.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for n0 in range(0, sk, block_n):
        kt, vt = k[..., n0:n0 + block_n, :], v[..., n0:n0 + block_n, :]
        x = _split_matmul(qs, kt.transpose(-1, -2), pieces, panel) * LOG2E
        if causal:
            cols = torch.arange(n0, n0 + kt.shape[-2])[None, :]
            x = x.masked_fill(cols > rows + sk - sq, -1e30)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _split_matmul(p, vt, pieces)
        m = m_new
    return acc / l.clamp_min(1e-20)


# f32: the two packages sum the same f32 products in other orders
@pytest.mark.parametrize("shape,causal", CASES, ids=IDS)
def test_cpu_f32_matches_jax(shape, causal):
    q, k, v = _inputs(shape)
    want = _jax_flash(q, k, v, causal)
    got = tatt.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


# bf16 inputs round identically on both sides; both compute in f32 and round
# the result to bf16 once, so they differ by at most one bf16 step (|o| < 4)
@pytest.mark.parametrize("shape,causal", CASES[:6], ids=IDS[:6])
def test_cpu_bf16_matches_jax(shape, causal):
    q, k, v = _inputs(shape, seed=1)
    want = _jax_flash(q, k, v, causal, "bfloat16")
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = tatt.flash_attention(tq, tk, tv, causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2e-2)


# the split-P arithmetic of the bf16 kernel holds every element to one bf16
# rounding of the JAX build's f32 result on the same (bf16-valued) inputs
@pytest.mark.parametrize("shape,causal", CASES, ids=IDS)
def test_cpu_split_p_emulation_matches_jax(shape, causal):
    q, k, v = _bf16_values(*_inputs(shape, seed=6))
    want = _jax_flash(q, k, v, causal)
    got = _bf16_kernel_emulation(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert _violations(got.float().numpy(), want) == 0


# negative control: P rounded to bf16 once breaks the same bound at >= 1% of
# elements, so the bound tells the two designs apart
@pytest.mark.parametrize("shape,causal", CASES, ids=IDS)
def test_cpu_bf16_p_breaks_the_bound(shape, causal):
    q, k, v = _bf16_values(*_inputs(shape, seed=6))
    want = _jax_flash(q, k, v, causal)
    got = _bf16_kernel_emulation(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal, split=False)
    assert _violations(got.float().numpy(), want) >= 0.01 * want.size


# the f32 route's arithmetic (three bf16 pieces, six products) holds the f32
# bound of test_cpu_f32_matches_jax against the JAX build
@pytest.mark.parametrize("shape,causal", CASES, ids=IDS)
def test_cpu_f32_split_emulation_matches_jax(shape, causal):
    q, k, v = _inputs(shape, seed=9)
    want = _jax_flash(q, k, v, causal)
    got = _f32_split_kernel_emulation(
        *(torch.from_numpy(x) for x in (q, k, v)), causal)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


# negative control: one bf16 piece (a plain bf16 product) breaks 1e-4 at
# every shape, so the bound tells the designs apart
@pytest.mark.parametrize("shape,causal", CASES, ids=IDS)
def test_cpu_f32_one_piece_breaks_the_bound(shape, causal):
    q, k, v = _inputs(shape, seed=9)
    want = _jax_flash(q, k, v, causal)
    got = _f32_split_kernel_emulation(
        *(torch.from_numpy(x) for x in (q, k, v)), causal, pieces=1)
    assert np.abs(got.numpy() - want).max() > 1e-4


# f16 inputs round identically on both sides; both compute in f32 and round
# the result to f16 once, so they differ by at most one f16 step (|o| < 4)
@pytest.mark.parametrize("shape,causal", CASES[:6], ids=IDS[:6])
def test_cpu_f16_matches_jax(shape, causal):
    q, k, v = _inputs(shape, seed=1)
    want = _jax_flash(q, k, v, causal, "float16")
    tq, tk, tv = (torch.from_numpy(x).to(torch.float16) for x in (q, k, v))
    got = tatt.flash_attention(tq, tk, tv, causal)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2e-3)


# the f16 kernel's arithmetic (P split into two f16 halves) holds every
# element within one f16 rounding, 2^-11·|ref| + 5e-5, of the JAX build's f32
# result on the same (f16-valued) inputs, which the JAX build in f16 rounds
# once to f16
@pytest.mark.parametrize("shape,causal", CASES, ids=IDS)
def test_cpu_f16_split_p_emulation_matches_jax(shape, causal):
    q, k, v = _bf16_values(*_inputs(shape, seed=6), dtype=torch.float16)
    want = _jax_flash(q, k, v, causal)
    got = _bf16_kernel_emulation(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal, dtype=torch.float16)
    assert got.dtype == torch.float16 and tuple(got.shape) == want.shape
    assert _violations(got.float().numpy(), want, F16_REL) == 0


# negative control: P rounded to f16 once breaks the f16 bound at >= 0.05% of
# elements (0.07% to 3.3% at these shapes), so the bound tells the designs
# apart
@pytest.mark.parametrize("shape,causal", CASES, ids=IDS)
def test_cpu_f16_p_breaks_the_bound(shape, causal):
    q, k, v = _bf16_values(*_inputs(shape, seed=6), dtype=torch.float16)
    want = _jax_flash(q, k, v, causal)
    got = _bf16_kernel_emulation(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal, split=False, dtype=torch.float16)
    assert _violations(got.float().numpy(), want, F16_REL) >= \
        0.0005 * want.size


# head dims above 256, the wide routes' arithmetic: S summed panel by panel
# (64 columns) at D = 320, Sq = Sk, Sq > Sk (rows that see no key) and not
# causal with Sq < Sk
WIDE_EMU_CASES = [((1, 2, 200, 200, 320), True),
                  ((1, 1, 150, 100, 320), True),
                  ((1, 2, 130, 150, 320), False)]
WIDE_EMU_IDS = _ids(WIDE_EMU_CASES)
HALF = {"bf16": (torch.bfloat16, BF16_REL, 0.01),
        "f16": (torch.float16, F16_REL, 0.0005)}


# route A: the split of P holds every element to one rounding of the JAX
# build's f32 result, and P rounded once breaks that bound (at >= 1% of the
# elements in bf16, >= 0.05% in f16, as at D <= 256)
@pytest.mark.parametrize("split", [True, False], ids=["split", "unsplit"])
@pytest.mark.parametrize("half", list(HALF))
@pytest.mark.parametrize("shape,causal", WIDE_EMU_CASES, ids=WIDE_EMU_IDS)
def test_cpu_wide_16bit_emulation_against_jax(shape, causal, half, split):
    dtype, rel, share = HALF[half]
    q, k, v = _bf16_values(*_inputs(shape, seed=16), dtype=dtype)
    want = _jax_flash(q, k, v, causal)
    got = _bf16_kernel_emulation(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal, split=split, dtype=dtype, panel=64)
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    bad = _violations(got.float().numpy(), want, rel)
    if split:
        assert bad == 0
    else:
        assert bad >= share * want.size


# route B: three pieces, six products a panel, within the f32 bound 2e-5 of
# the JAX build; one piece breaks 1e-4
@pytest.mark.parametrize("pieces", [3, 1], ids=["three_pieces", "one_piece"])
@pytest.mark.parametrize("shape,causal", WIDE_EMU_CASES, ids=WIDE_EMU_IDS)
def test_cpu_wide_f32_split_emulation_against_jax(shape, causal, pieces):
    q, k, v = _inputs(shape, seed=17)
    want = _jax_flash(q, k, v, causal)
    got = _f32_split_kernel_emulation(
        *(torch.from_numpy(x) for x in (q, k, v)), causal, pieces=pieces,
        panel=64)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    err = np.abs(got.numpy() - want).max()
    assert err <= 2e-5 if pieces == 3 else err > 1e-4


MIXES = [("bfloat16", "float32", "float16"), ("float32", "bfloat16", "bfloat16"),
         ("float16", "float16", "float32")]


def _mixed(arrays, dtypes):
    """numpy arrays as (JAX, torch) inputs of the given dtypes."""
    return ([jnp.asarray(x, t) for x, t in zip(arrays, dtypes)],
            [torch.from_numpy(x).to(getattr(torch, t))
             for x, t in zip(arrays, dtypes)])


# a mix of dtypes: both promote to f32, compute there and return q's dtype;
# they differ by one rounding to q's dtype (2e-2 in bf16, 2e-3 in f16 at
# |o| < 4) or f32 sums in other orders (2e-5)
@pytest.mark.parametrize("dtypes", MIXES, ids=["_".join(m) for m in MIXES])
def test_cpu_mixed_dtypes_match_jax(dtypes):
    shape, causal = (1, 2, 64, 80, 40), True
    jargs, targs = _mixed(_inputs(shape, seed=12), dtypes)
    want = jax_flash(*jargs, causal)
    got = tatt.flash_attention(*targs, causal)
    assert str(want.dtype) == dtypes[0] and got.dtype == targs[0].dtype
    tol = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 2e-3}[dtypes[0]]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), rtol=0,
                               atol=tol)


# the split pass's plain version: three bf16 planes that carry x·mul to
# 2^-24 relative, zero columns up to a multiple of 8, (3, B*H, S, Dp)
@pytest.mark.parametrize("shape,mul", [((2, 3, 40, 20), 1.0),
                                       ((1, 2, 64, 128), 0.125),
                                       ((1, 1, 5, 1), 1.0)],
                         ids=["d20", "d128_scaled", "d1"])
def test_cpu_split_f32_planes(shape, mul):
    rs = np.random.RandomState(10)
    x = torch.from_numpy((rs.standard_normal(shape) *
                          10.0 ** rs.uniform(-3, 3, shape)).astype(np.float32))
    planes = tatt.split_f32(x, mul)
    b, h, s, d = shape
    dp = -(-d // 8) * 8
    assert planes.dtype == torch.bfloat16 and tuple(planes.shape) == (
        3, b * h, s, dp)
    assert not planes[..., d:].any()
    want = (x * mul).reshape(b * h, s, d).double()
    got = planes[..., :d].double().sum(0)
    assert ((got - want).abs() <= 2.0 ** -24 * want.abs()).all()
    assert (planes[1].float().abs() <= 2.0 ** -8 *
            planes[0].float().abs()).all()


# the planes of head dims above 256 (route B's input) against the JAX
# build's q·scale in f32, which its kernel reads: plane 0 is that value
# rounded to bf16, and the three carry it to 2^-24 relative
@pytest.mark.parametrize("d", [320, 512])
def test_cpu_split_f32_reference_matches_jax_at_wide_head_dims(d):
    rs = np.random.RandomState(18)
    x = rs.standard_normal((1, 2, 70, d)).astype(np.float32)
    scale = np.float32(1.0 / np.sqrt(d))
    want = np.asarray(jnp.asarray(x) * scale).reshape(2, 70, d)
    planes = tatt._split_f32_reference(torch.from_numpy(x), float(scale))
    assert tuple(planes.shape) == (3, 2, 70, d)
    np.testing.assert_array_equal(
        planes[0].float().numpy(),
        np.asarray(jnp.asarray(want).astype(jnp.bfloat16).astype(
            jnp.float32)))
    got = planes.double().sum(0).numpy()
    assert (np.abs(got - want) <= 2.0 ** -24 * np.abs(want)).all()


def test_rows_without_visible_keys_average_v():
    q, k, v = _inputs((1, 2, 256, 128, 64), seed=2)
    out = tatt.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True).numpy()
    # Sq - Sk = 128 rows see no key: the -1e30 sentinel makes them uniform
    np.testing.assert_allclose(out[:, :, :128],
                               np.broadcast_to(v.mean(axis=2, keepdims=True),
                                               (1, 2, 128, 64)),
                               rtol=0, atol=1e-5)
    assert np.isfinite(out).all()


def test_causal_anchor_is_bottom_right_not_sdpa():
    # ROADMAP trap A0: SDPA's is_causal anchors the diagonal top-left
    q, k, v = (torch.from_numpy(x) for x in _inputs((1, 2, 128, 256, 64), 3))
    ours = tatt.flash_attention(q, k, v, causal=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                            is_causal=True)
    assert (ours - sdpa).abs().max().item() > 0.1
    mask = torch.ones(128, 256, dtype=torch.bool).tril(256 - 128)
    explicit = torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask)
    np.testing.assert_allclose(ours.numpy(), explicit.numpy(), atol=2e-5)


def test_op_surface_matches_jax():
    q, k, v = _inputs((2, 2, 48, 48, 16), seed=4)
    want = jmx.nd._contrib_FlashAttention(
        jmx.nd.array(q), jmx.nd.array(k), jmx.nd.array(v), causal=True,
        scale=0.3).asnumpy()
    with tmx.cpu():
        got = tmx.nd._contrib_FlashAttention(
            tmx.nd.array(q), tmx.nd.array(k), tmx.nd.array(v), causal=True,
            scale=0.3)
    assert got.context == tmx.cpu()
    np.testing.assert_allclose(got.asnumpy(), want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(
        tmx.nd.flash_attention(tmx.nd.array(q, ctx=tmx.cpu()),
                               tmx.nd.array(k, ctx=tmx.cpu()),
                               tmx.nd.array(v, ctx=tmx.cpu())).asnumpy(),
        jmx.nd.flash_attention(jmx.nd.array(q), jmx.nd.array(k),
                               jmx.nd.array(v)).asnumpy(), rtol=0, atol=2e-5)


# what the kernel takes: every mix of f32, bf16 and f16 (route code 0 for the
# f32 route, 1 bf16, 2 f16) at head dims up to 256, and any of them above 256
# (route code 3, the wide route); it raises on D = 0, float64 and integer
# inputs
@pytest.mark.parametrize("bad,err", [
    ("head_dim", 3), ("float16", 2), ("mixed_dtype", 0),
    ("int", TypeError), ("float64", TypeError), ("head_dim_256", 1),
    ("head_dim_0", ValueError),
])
def test_kernel_argument_checks(bad, err):
    d = {"head_dim": 257, "head_dim_256": 256, "head_dim_0": 0}.get(bad, 16)
    q = torch.zeros(1, 1, 8, d)
    k = torch.zeros(1, 1, 8, q.shape[-1])
    v = k.clone()
    if bad == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif bad in ("mixed_dtype", "head_dim_256"):
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        if bad == "head_dim_256":
            q = q.to(torch.bfloat16)
    elif bad == "int":
        q = q.to(torch.int32)
    elif bad == "float64":
        q, k, v = q.double(), k.double(), v.double()
    if isinstance(err, int):
        assert tatt._kernel_dtype_code(q, k, v) == err
        return
    with pytest.raises(err):
        if bad == "int":
            tatt.flash_attention(q, k, v)
        else:
            tatt._kernel_dtype_code(q, k, v)


class _StubLibrary:
    """The flash library's C entry points, recording each call (name, and
    the head dim it was given) and returning success."""

    def __init__(self):
        self.calls = []

    def _entry(name, d_index):
        def call(self, *args):
            self.calls.append((name, args[d_index]))
            return 0
        return call

    flash_attention_bf16 = _entry("flash_attention_bf16", 7)
    flash_attention_f16 = _entry("flash_attention_f16", 7)
    flash_attention_f32 = _entry("flash_attention_f32", 7)
    flash_attention_f32_split = _entry("flash_attention_f32_split", 9)

    def flash_attention_error_string(self, err):
        return b"stub"


@pytest.fixture
def stub_library(monkeypatch):
    """The CUDA wrapper on CPU tensors with the library stubbed: the route
    logic runs, the kernels do not (outputs are uninitialized)."""
    lib = _StubLibrary()
    monkeypatch.setattr(tatt.cuda_build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return lib


# the wrapper's routing on a CUDA tensor, with the library stubbed: each
# dtype mix and head dim takes its route, the 16-bit routes get D padded to
# a multiple of 8, a mix returns q's dtype through the f32 route
@pytest.mark.parametrize("dtypes,d,entry,kernel_d", [
    (("bfloat16",) * 3, 128, "flash_attention_bf16", 128),
    (("float16",) * 3, 20, "flash_attention_f16", 24),
    (("float16",) * 3, 256, "flash_attention_f16", 256),
    (("bfloat16",) * 3, 160, "flash_attention_bf16", 160),
    (("float32",) * 3, 192, "flash_attention_f32", 192),
    (("bfloat16", "float32", "float16"), 64, "flash_attention_f32", 64),
    (("float32", "bfloat16", "bfloat16"), 250, "flash_attention_f32", 250),
], ids=["bf16", "f16_d20", "f16_d256", "bf16_d160", "f32_d192",
        "mixed_bf16_f32_f16", "mixed_f32_bf16_d250"])
def test_cuda_routing_with_stubbed_library(stub_library, dtypes, d, entry,
                                           kernel_d):
    q, k, v = (torch.zeros(1, 2, 8, d, dtype=getattr(torch, t))
               for t in dtypes)
    before = (tatt.flash_attention.launches, tatt.flash_attention.f16_launches,
              tatt.flash_attention.mixed_launches)
    out = tatt._flash_forward_cuda(q, k, v, True, 0.125)
    assert stub_library.calls == [(entry, kernel_d)]
    assert out.dtype == q.dtype and tuple(out.shape) == (1, 2, 8, d)
    mixed = len(set(dtypes)) > 1
    assert (tatt.flash_attention.launches, tatt.flash_attention.f16_launches,
            tatt.flash_attention.mixed_launches) == (
        before[0] + 1, before[1] + (entry == "flash_attention_f16"),
        before[2] + mixed)


# D = 0, float64 and integers raise before any launch (D = 257 takes the
# wide route: tests/test_torch_flash_backward.py)
@pytest.mark.parametrize("dtype,d,err", [(torch.bfloat16, 0, ValueError),
                                         (torch.int32, 257, TypeError),
                                         (torch.float64, 64, TypeError)])
def test_cuda_wrapper_raises_past_its_range(stub_library, dtype, d, err):
    q = torch.zeros(1, 1, 8, d, dtype=dtype)
    with pytest.raises(err):
        tatt._flash_forward_cuda(q, q, q, False, 0.1)
    assert stub_library.calls == []


def test_device_and_shape_checks():
    q = torch.zeros(1, 1, 8, 16)
    with pytest.raises(ValueError, match="different devices"):
        tatt.flash_attention(q, q.to("meta"), q)
    with pytest.raises(ValueError):
        tatt.flash_attention(q, torch.zeros(1, 1, 8, 8), torch.zeros(1, 1, 8, 8))
    with pytest.raises(ValueError):
        tatt.flash_attention(q[0], q[0], q[0])
    # neither CPU nor CUDA: no plain fallback, the wrapper raises
    m = q.to("meta")
    with pytest.raises(MXNetError):
        tatt.flash_attention(m, m, m)


def test_kernel_backward_is_not_ported():
    """The autograd Function's backward on the CPU path (and on the card for
    f32, mixes, D > 128 and ``create_graph``) is the ported ``_flash_bwd``:
    ``_flash_backward`` on the saved inputs and output.  16-bit inputs on
    the card take the backward kernel (tests/test_torch_flash_backward.py)."""
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _inputs((1, 2, 24, 40, 8), seed=9))
    out = tatt._FlashAttentionFunction.apply(q, k, v, True, 0.3)
    g = torch.ones_like(out)
    got = torch.autograd.grad(out, [q, k, v], g)
    want = tatt._flash_backward(q.detach(), k.detach(), v.detach(),
                                out.detach(), g, True, 0.3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_cpu_path_does_not_count_launches():
    q, k, v = (torch.from_numpy(x) for x in _inputs((1, 1, 16, 16, 8)))
    before = tatt.flash_attention.launches
    tatt.flash_attention(q, k, v)
    assert tatt.flash_attention.launches == before


# ---------------------------------------------------------------------------
# on the card: the kernel against the plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = prev


# kernel vs plain (f32 from the same inputs): f32 sums in other orders stay
# far below 1e-4; bf16 output is one rounding of the f32 result, 7.8e-3 at
# |o| < 4, within 2e-2, and every bf16 element within 2^-8·|ref| + 5e-5; f16
# output one rounding, 9.8e-4 at |o| < 4, within 2e-3, and every element
# within 2^-11·|ref| + 5e-5
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 2e-3)],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("shape,causal", CARD_CASES, ids=CARD_IDS)
def test_card_kernel_matches_plain(card, shape, causal, dtype, tol):
    q, k, v = (torch.from_numpy(x).to(card, dtype)
               for x in _inputs(shape, seed=5))
    before = tatt.flash_attention.launches, tatt.flash_attention.f16_launches
    out = tatt.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert (tatt.flash_attention.launches,
            tatt.flash_attention.f16_launches) == (
        before[0] + 1, before[1] + (dtype == torch.float16))
    assert out.dtype == dtype and out.is_cuda
    assert tuple(out.shape) == tuple(q.shape)
    ref = tatt._attention_reference(q.float(), k.float(), v.float(), causal)
    assert (out.float() - ref).abs().max().item() <= tol
    if dtype != torch.float32:
        rel = BF16_REL if dtype == torch.bfloat16 else F16_REL
        assert _violations(out.float().cpu().numpy(), ref.cpu().numpy(),
                           rel) == 0


# the bf16 kernel against the JAX build (CPU jax, f32 on the same
# bf16-valued numpy inputs), element by element
@pytest.mark.cuda
def test_card_bf16_kernel_matches_jax(card):
    shape, causal = (1, 2, 1024, 1024, 128), True
    q, k, v = _bf16_values(*_inputs(shape, seed=7))
    want = _jax_flash(q, k, v, causal)
    got = tatt.flash_attention(*(torch.from_numpy(x).to(card, torch.bfloat16)
                                 for x in (q, k, v)), causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert _violations(got.float().cpu().numpy(), want) == 0


# the f16 kernel against the JAX build (CPU jax, f32 on the same f16-valued
# inputs: the JAX build in f16 rounds this result once), element by element
# at one f16 rounding, 2^-11·|ref| + 5e-5
@pytest.mark.cuda
def test_card_f16_kernel_matches_jax(card):
    shape, causal = (1, 2, 1024, 1024, 128), True
    q, k, v = _bf16_values(*_inputs(shape, seed=7), dtype=torch.float16)
    want = _jax_flash(q, k, v, causal)
    got = tatt.flash_attention(*(torch.from_numpy(x).to(card, torch.float16)
                                 for x in (q, k, v)), causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.float16
    assert _violations(got.float().cpu().numpy(), want, F16_REL) == 0


# head dims 160, 192 and 256 on each route against the JAX build: the 16-bit
# routes element by element at their rounding bounds, the f32 route at the
# f32 bound of the CPU comparison
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("d", [160, 192, 256])
def test_card_wide_head_dims_match_jax(card, d, dtype):
    shape, causal = (1, 2, 384, 384, d), True
    q, k, v = _bf16_values(*_inputs(shape, seed=13), dtype=dtype)
    want = _jax_flash(q, k, v, causal)
    got = tatt.flash_attention(*(torch.from_numpy(x).to(card, dtype)
                                 for x in (q, k, v)), causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    got = got.float().cpu().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    else:
        rel = BF16_REL if dtype == torch.bfloat16 else F16_REL
        assert _violations(got, want, rel) == 0


# a mix of dtypes on the card: the f32 route (three split launches, each
# input read at its own dtype, one mixed launch), q's dtype out, against the
# plain version and the JAX build at one rounding to q's dtype
@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", MIXES, ids=["_".join(m) for m in MIXES])
def test_card_mixed_dtypes_match_plain_and_jax(card, dtypes):
    shape, causal = (2, 3, 256, 320, 96), True
    jargs, targs = _mixed(_inputs(shape, seed=14), dtypes)
    targs = [t.to(card) for t in targs]
    before = (tatt.flash_attention.mixed_launches, tatt.split_f32.launches)
    got = tatt.flash_attention(*targs, causal)
    torch.cuda.synchronize()
    assert (tatt.flash_attention.mixed_launches, tatt.split_f32.launches) == (
        before[0] + 1, before[1] + 3)
    assert got.dtype == targs[0].dtype
    tol = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-3}[dtypes[0]]
    ref = tatt._attention_reference(*targs, causal)
    assert (got.float() - ref.float()).abs().max().item() <= tol
    want = np.asarray(jax_flash(*jargs, causal).astype(jnp.float32))
    np.testing.assert_allclose(got.float().cpu().numpy(), want, rtol=0,
                               atol=tol)


# the split pass reads bf16 and f16 inputs at their own dtype, bit for bit
# against its plain version (a 16-bit value splits exactly)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_card_split_16bit_inputs_match_plain(card, dtype):
    rs = np.random.RandomState(15)
    x = torch.from_numpy(rs.standard_normal((2, 77, 3, 200)).astype(
        np.float32)).to(card, dtype).transpose(1, 2)
    got = tatt.split_f32(x, 0.0625)
    torch.cuda.synchronize()
    assert torch.equal(got, tatt._split_f32_reference(x, 0.0625))


# a contiguous view that starts 2 bytes into its storage: TMA reads from
# 16-byte aligned bases, so the wrapper copies it first
@pytest.mark.cuda
def test_card_bf16_unaligned_view(card):
    q, k, v = (torch.from_numpy(x).to(card, torch.bfloat16)
               for x in _inputs((1, 2, 64, 64, 64), seed=8))
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=card)
    flat[1:] = q.reshape(-1)
    qv = flat[1:].view(q.shape)
    assert qv.is_contiguous() and qv.data_ptr() % 16
    out = tatt.flash_attention(qv, k, v, causal=True)
    ref = tatt._attention_reference(q.float(), k.float(), v.float(), True)
    assert _violations(out.float().cpu().numpy(), ref.cpu().numpy()) == 0


# the f32 route against the JAX build (CPU jax, f32 on the same numpy
# inputs) at the f32 bound of the CPU comparison
@pytest.mark.cuda
def test_card_f32_kernel_matches_jax(card):
    shape, causal = (1, 2, 1024, 1024, 128), True
    q, k, v = _inputs(shape, seed=7)
    want = _jax_flash(q, k, v, causal)
    before = tatt.flash_attention.f32_launches, tatt.split_f32.launches
    got = tatt.flash_attention(*(torch.from_numpy(x).to(card)
                                 for x in (q, k, v)), causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert (tatt.flash_attention.f32_launches,
            tatt.split_f32.launches) == (before[0] + 1, before[1] + 3)
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0, atol=2e-5)


# the split pass on the card equals its plain version bit for bit (the same
# roundings and exact subtractions), from a strided view and with padding
@pytest.mark.cuda
@pytest.mark.parametrize("d,mul", [(20, 0.125), (128, 1.0)])
def test_card_split_f32_matches_plain(card, d, mul):
    rs = np.random.RandomState(11)
    x = torch.from_numpy(rs.standard_normal((2, 77, 3, d)).astype(
        np.float32)).to(card).transpose(1, 2)          # (B, H, S, D), strided
    got = tatt.split_f32(x, mul)
    torch.cuda.synchronize()
    want = tatt._split_f32_reference(x, mul)
    assert got.shape == want.shape and torch.equal(got, want)


# f32 views: a base 4 bytes into its storage (no 16-byte loads there) and
# the split-heads transpose at D = 20, read through their strides
@pytest.mark.cuda
@pytest.mark.parametrize("view", ["unaligned", "split_heads"])
def test_card_f32_views(card, view):
    if view == "unaligned":
        q, k, v = (torch.from_numpy(x).to(card)
                   for x in _inputs((1, 2, 64, 64, 64), seed=8))
        flat = torch.empty(q.numel() + 1, device=card)
        flat[1:] = q.reshape(-1)
        q = flat[1:].view(q.shape)
        assert q.is_contiguous() and q.data_ptr() % 16
    else:
        x = torch.randn(2, 150, 3 * 4, 20, device=card)   # (B, S, 3H, D)
        q, k, v = (t.transpose(1, 2) for t in x.split(4, dim=2))
        assert not q.is_contiguous()
    out = tatt.flash_attention(q, k, v, causal=True)
    ref = tatt._attention_reference(q, k, v, causal=True)
    assert out.dtype == torch.float32 and out.is_contiguous()
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_card_strided_inputs_and_no_silent_grad(card):
    x = torch.randn(2, 96, 4, 32, device=card)          # (B, S, H, D)
    q = x.transpose(1, 2)                                # not contiguous
    out = tatt.flash_attention(q, q, q, causal=True)
    ref = tatt._attention_reference(q, q, q, causal=True)
    assert (out - ref).abs().max().item() <= 1e-4
    qg = q.detach().requires_grad_()
    tatt.flash_attention(qg, qg, qg).sum().backward()
    qr = q.detach().requires_grad_()
    tatt._attention_reference(qr, qr, qr).sum().backward()
    assert (qg.grad - qr.grad).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_card_recorded_attention_backward_raises(card):
    """Under the port's record() on the card, backward through the kernel
    fills the grad buffer with the ported backward's gradient: the plain
    version's under torch autograd (f32, TF32 off) within 1e-4."""
    data = _inputs((1, 2, 64, 64, 32))[0]
    x = tmx.nd.array(data, ctx=tmx.gpu(0))
    x.attach_grad()
    with tmx.autograd.record():
        y = tmx.nd.flash_attention(x, x, x, causal=True)
    y.backward()
    xr = torch.from_numpy(data).to(card).requires_grad_()
    tatt._attention_reference(xr, xr, xr, True).sum().backward()
    assert x.grad.asnumpy().any()
    np.testing.assert_allclose(x.grad.asnumpy(), xr.grad.cpu().numpy(),
                               rtol=0, atol=1e-4)
