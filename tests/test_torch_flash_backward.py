"""The backward of flash attention in the PyTorch port against ``jax.vjp`` of
the JAX build's ``flash_attention``, its hand-written kernel, and the
forward's route for head dims above 256.

The JAX build's backward is ``_flash_bwd`` (ops/attention.py:168-242), jnp
under XLA on every backend.  The port's has two routes behind one
``torch.autograd.Function``: on the card, 16-bit inputs (all bf16 or all
f16) at head dims up to 128 take the kernel
``csrc/flash_attention_bwd_sm90.cu``; everything else, and every CPU
tensor, takes the same two chunked passes in torch ops
(``ops/attention.py`` ``_flash_backward``).  The same seeded numpy q, k, v
and head gradient go to both builds.  Bounds of the torch ops: f32 1e-5
absolute (the same f32 products summed in other orders; gradients here are
below ~5 in magnitude); bf16 and f16 within one ulp of the dtype at each
element's magnitude plus one ulp at 2^-6 (both compute in f32 and round once
to the input's dtype, so two f32 results a few f32 ulps apart may round to
neighbouring 16-bit values, and values near zero cancel).

The kernel cannot run here: ``_bf16_backward_kernel_emulation`` replays its
arithmetic (16-bit operands, f32 products, P and dS split into two halves of
the type, its tile order) and is held against ``jax.vjp`` at the kernel's
bound on the card, 2^-7 of each gradient's largest magnitude (plus 1e-5 for
a gradient that vanishes); with P and dS
rounded once (``split=False``) it must break that bound on keys that share
an offset, where dQ = dS·K cancels.  A stubbed library shows the routing of
both backward routes and of the forward's route for head dims above 256.
The ``cuda`` tests hold the kernels against the plain version and the JAX
build on the card:

    python -m pytest -m cuda tests/test_torch_flash_backward.py
"""
import contextlib
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.ops.attention import flash_attention as jax_flash
from incubator_mxnet_tpu_torch.ops import attention as tatt

# (B, H, Sq, Sk, D), causal
CASES = [
    ((1, 2, 64, 64, 20), False),
    ((1, 2, 64, 64, 20), True),
    ((1, 2, 48, 192, 16), True),     # Sq < Sk; Sk = 192 runs three chunks
    ((1, 2, 200, 128, 16), True),    # Sq > Sk: 72 rows see no key
    ((2, 1, 65, 65, 8), True),       # Sk = 65: one chunk of 65
    ((1, 1, 40, 130, 320), True),    # D = 320, the wide route's head dims
]
IDS = ["%dx%dx%dx%dx%d%s" % (s + ("_causal" if c else "",)) for s, c in CASES]
MANTISSA = {torch.bfloat16: 7, torch.float16: 10}


def _inputs(shape, seed=0):
    b, h, sq, sk, d = shape
    rs = np.random.RandomState(seed)
    return [rs.standard_normal(s).astype(np.float32)
            for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d),
                      (b, h, sq, d))]


def _jax_grads(q, k, v, g, causal, dtype="float32"):
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    out, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal), *args)
    grads = vjp(jnp.asarray(g, dtype))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _port_grads(q, k, v, g, causal, dtype=torch.float32, device="cpu"):
    q, k, v = (torch.from_numpy(x).to(device, dtype).requires_grad_()
               for x in (q, k, v))
    out = tatt.flash_attention(q, k, v, causal)
    grads = torch.autograd.grad(out, [q, k, v],
                                torch.from_numpy(g).to(device, dtype))
    return [t.detach().float().cpu().numpy() for t in (out, *grads)]


def _ulp(x, mantissa):
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -6)))
    return 2.0 ** (e - mantissa)


@pytest.mark.parametrize("shape,causal", CASES, ids=IDS)
def test_backward_matches_jax_vjp_f32(shape, causal):
    q, k, v, g = _inputs(shape)
    want = _jax_grads(q, k, v, g, causal)
    got = _port_grads(q, k, v, g, causal)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("shape,causal", [CASES[1], CASES[3]],
                         ids=[IDS[1], IDS[3]])
def test_backward_matches_jax_vjp_half(shape, causal, dtype):
    q, k, v, g = (torch.from_numpy(x).to(dtype).float().numpy()
                  for x in _inputs(shape, seed=1))
    want = _jax_grads(q, k, v, g, causal, str(dtype).split(".")[1])
    got = _port_grads(q, k, v, g, causal, dtype)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        bound = _ulp(b, MANTISSA[dtype]) * 2
        assert (np.abs(a - b) <= bound).all(), name


def test_backward_dtypes_follow_each_input():
    q, k, v, g = _inputs((1, 1, 16, 24, 8), seed=2)
    qt = torch.from_numpy(q).to(torch.bfloat16).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    vt = torch.from_numpy(v).to(torch.float16).requires_grad_()
    out = tatt.flash_attention(qt, kt, vt, True)
    assert out.dtype == torch.bfloat16
    dq, dk, dv = torch.autograd.grad(out, [qt, kt, vt],
                                     torch.from_numpy(g).to(torch.bfloat16))
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16, torch.float32,
                                              torch.float16)


def test_rows_without_keys_give_masked_logits_no_gradient():
    """Sq > Sk, causal: rows 0..Sq-Sk-1 see no key and average V uniformly;
    their logits are constants of the forward, so dq there is 0 (ds is
    zeroed at masked logits), while dv still takes their uniform weights."""
    q, k, v, g = _inputs((1, 1, 24, 8, 4), seed=3)
    want = _jax_grads(q, k, v, g, True)
    got = _port_grads(q, k, v, g, True)
    assert not got[1][0, 0, :16].any()
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-5)


def test_backward_keeps_the_tf32_setting():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _port_grads(*_inputs((1, 1, 8, 8, 4)), False)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_second_derivative_matches_jax():
    """The backward is made of torch ops, so create_graph differentiates it:
    d/dq of sum(dq · w) against jax.grad of the same through the JAX
    build's custom_vjp."""
    q, k, v, w = _inputs((1, 1, 12, 16, 4), seed=4)

    def jax_fn(qa):
        gq = jax.grad(lambda a: (jax_flash(a, jnp.asarray(k), jnp.asarray(v),
                                           True) ** 2).sum())(qa)
        return (gq * jnp.asarray(w)).sum()
    want = np.asarray(jax.grad(jax_fn)(jnp.asarray(q)))
    qt = torch.from_numpy(q).requires_grad_()
    out = tatt.flash_attention(qt, torch.from_numpy(k), torch.from_numpy(v),
                               True)
    (gq,) = torch.autograd.grad((out ** 2).sum(), [qt], create_graph=True)
    (got,) = torch.autograd.grad((gq * torch.from_numpy(w)).sum(), [qt])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_recorded_attention_fills_the_grad_buffer():
    q, k, v, _ = _inputs((1, 2, 32, 32, 16), seed=5)
    want = _jax_grads(q, k, v, np.ones_like(q), True)
    with tmx.cpu():
        x = tmx.nd.array(q)
        x.attach_grad()
        with tmx.autograd.record():
            y = tmx.nd.flash_attention(x, tmx.nd.array(k), tmx.nd.array(v),
                                       causal=True)
        y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), want[1], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the 16-bit backward kernel's arithmetic, replayed on the CPU
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634
KERNEL_TILE = 64      # the kernel's key and query tiles
# the kernel's bound on the card: 2^-7 of each gradient's largest magnitude,
# plus 1e-5 for a gradient that vanishes by cancellation (at Sk = 1 a row's P
# is 1, so dS = dP - delta, two f32 sums of the same products in other
# orders: a few ulps of |dP| ~ 10, below 1e-6 after the scale)
BACKWARD_REL, BACKWARD_ABS = 2.0 ** -7, 1e-5
# Keys that share an offset leave P unchanged (the offset adds a constant to
# each row's logits), but dQ = dS·K then sums terms much larger than dQ that
# cancel. dS rounded once to the type (2^-9 relative in bf16, 2^-12 in f16)
# loses that cancellation at 2^(mantissa - 3) and breaks the bound; its two
# halves (2^-17, 2^-22) keep it.
KEY_OFFSET = {torch.bfloat16: 16.0, torch.float16: 128.0}
EMU_CASES = [
    ((1, 2, 64, 64, 20), False),
    ((1, 2, 64, 64, 20), True),
    ((1, 2, 48, 192, 128), True),    # Sq < Sk
    ((1, 2, 200, 128, 20), True),    # Sq > Sk: 72 rows see no key
    ((2, 1, 65, 65, 128), True),     # Sk = 65: a ragged key tile
    ((1, 2, 64, 64, 128), False),
]
EMU_IDS = ["%dx%dx%dx%dx%d%s" % (s + ("_causal" if c else "",))
           for s, c in EMU_CASES]
HALF = [torch.bfloat16, torch.float16]
HALF_IDS = ["bf16", "f16"]


def _bf16_backward_kernel_emulation(q, k, v, g, out, causal, split=True,
                                    dtype=torch.bfloat16):
    """The backward kernel's arithmetic (csrc/flash_attention_bwd_sm90.cu) in
    plain PyTorch (test-only), for ``dtype`` bf16 or f16: q, k, v, g and out
    of that type; S = Q·Kᵀ and dP = g·Vᵀ in f32 from exact products; each
    row's max m and sum l in log2 units by the online scan over 64-key tiles,
    masked logits at the -1e30 sentinel; P = exp2(x - m) / max(l, 1e-20);
    delta = sum(g·out) in f32; dS = P·(dP - delta)·scale, 0 at masked
    logits; dQ summed over key tiles, dK and dV over query tiles, each
    product as T(X)·Y + T(X - T(X))·Y with f32 products (``split`` False:
    T(X)·Y, the design the split avoids); each gradient rounded to the type
    once."""
    qf, kf, vf, gf, of = (torch.tensor(t).to(dtype).float()
                          for t in (q, k, v, g, out))
    sq, sk, d = qf.shape[-2], kf.shape[-2], qf.shape[-1]
    scale = 1.0 / math.sqrt(d)
    x = torch.matmul(qf, kf.transpose(-1, -2)) * (scale * LOG2E)
    masked = torch.zeros((sq, sk), dtype=torch.bool)
    if causal:
        masked = torch.arange(sk)[None, :] > torch.arange(sq)[:, None] + \
            sk - sq
        x = x.masked_fill(masked, -1e30)
    m = torch.full(qf.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    for n0 in range(0, sk, KERNEL_TILE):
        xt = x[..., n0:n0 + KERNEL_TILE]
        m_new = torch.maximum(m, xt.amax(-1, keepdim=True))
        l = l * torch.exp2(m - m_new) + torch.exp2(xt - m_new).sum(
            -1, keepdim=True)
        m = m_new
    p = torch.exp2(x - m) / l.clamp_min(1e-20)
    delta = (gf * of).sum(-1, keepdim=True)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = (p * (dp - delta) * scale).masked_fill(masked, 0.0)

    def halves(t):
        hi = t.to(dtype).float()
        return (hi, (t - hi).to(dtype).float()) if split else (hi,)

    dq = torch.zeros_like(qf)
    for n0 in range(0, sk, KERNEL_TILE):
        for part in halves(ds[..., n0:n0 + KERNEL_TILE]):
            dq = dq + torch.matmul(part, kf[..., n0:n0 + KERNEL_TILE, :])
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for i0 in range(0, sq, KERNEL_TILE):
        rows = slice(i0, i0 + KERNEL_TILE)
        for part in halves(p[..., rows, :]):
            dv = dv + torch.matmul(part.transpose(-1, -2), gf[..., rows, :])
        for part in halves(ds[..., rows, :]):
            dk = dk + torch.matmul(part.transpose(-1, -2), qf[..., rows, :])
    return [t.to(dtype) for t in (dq, dk, dv)]


def _half_case(shape, causal, dtype, key_offset=0.0, seed=10):
    """Seeded inputs (keys shifted by ``key_offset``) rounded to ``dtype`` as
    f32 numpy, and the JAX build's out, dq, dk, dv from ``jax.vjp`` in that
    dtype."""
    q, k, v, g = _inputs(shape, seed)
    q, k, v, g = (torch.from_numpy(x).to(dtype).float().numpy()
                  for x in (q, k + np.float32(key_offset), v, g))
    return (q, k, v, g), _jax_grads(q, k, v, g, causal,
                                    str(dtype).split(".")[1])


def _bound_ratios(got, want):
    """Each gradient's max abs error over the bound 2^-7·max|grad| + 1e-5."""
    return [float(np.abs(np.asarray(a, np.float64) - b).max() /
                  (BACKWARD_REL * np.abs(b).max() + BACKWARD_ABS))
            for a, b in zip(got, want)]


@pytest.mark.parametrize("key_offset", [False, True], ids=["", "key_offset"])
@pytest.mark.parametrize("dtype", HALF, ids=HALF_IDS)
@pytest.mark.parametrize("shape,causal", EMU_CASES, ids=EMU_IDS)
def test_cpu_backward_kernel_emulation_matches_jax_vjp(shape, causal, dtype,
                                                       key_offset):
    (q, k, v, g), (out, *want) = _half_case(
        shape, causal, dtype, KEY_OFFSET[dtype] if key_offset else 0.0)
    got = _bf16_backward_kernel_emulation(q, k, v, g, out, causal,
                                          dtype=dtype)
    ratios = _bound_ratios([t.float().numpy() for t in got], want)
    assert max(ratios) <= 1.0, dict(zip(("dq", "dk", "dv"), ratios))


@pytest.mark.parametrize("dtype", HALF, ids=HALF_IDS)
@pytest.mark.parametrize("shape,causal", EMU_CASES, ids=EMU_IDS)
def test_cpu_backward_unsplit_emulation_breaks_the_bound(shape, causal,
                                                         dtype):
    """The negative control: P and dS rounded once to the type break the
    bound that their two halves keep, on keys that share an offset."""
    (q, k, v, g), (out, *want) = _half_case(shape, causal, dtype,
                                            KEY_OFFSET[dtype])
    got = _bf16_backward_kernel_emulation(q, k, v, g, out, causal,
                                          split=False, dtype=dtype)
    assert _bound_ratios([t.float().numpy() for t in got], want)[0] > 1.0


# ---------------------------------------------------------------------------
# the backward's routes and the forward's route for head dims above 256,
# with the library stubbed (CPU tensors)
# ---------------------------------------------------------------------------

class _StubLibrary:
    """Records the C entry point called and the head dim it was given (and,
    for the forward, whether it got a stats buffer; for the backward, which
    of its nine pointers are not 16-byte aligned)."""

    def __init__(self):
        self.calls = []

    def _backward(name):
        def call(self, *args):
            # q, k, v, out, g, dq, dk, dv, stats, batch_heads, sq, sk, d, ...
            self.calls.append((name, args[12],
                               [i for i in range(9) if args[i] % 16]))
            return 0
        return call

    flash_attention_bwd_bf16 = _backward("flash_attention_bwd_bf16")
    flash_attention_bwd_f16 = _backward("flash_attention_bwd_f16")

    def _forward(name):
        def call(self, *args):
            # q, k, v, o, batch_heads, sq, sk, d, ...; the 16-bit routes'
            # stats buffer (None when serving) at 10
            self.calls.append((name, args[7],
                               len(args) == 12 and args[10] is not None))
            return 0
        return call

    flash_attention_bf16 = _forward("flash_attention_bf16")
    flash_attention_f16 = _forward("flash_attention_f16")
    flash_attention_f32 = _forward("flash_attention_f32")
    flash_attention_wide_bf16 = _forward("flash_attention_wide_bf16")
    flash_attention_wide_f16 = _forward("flash_attention_wide_f16")
    flash_attention_wide_f32 = _forward("flash_attention_wide_f32")

    def flash_attention_error_string(self, err):
        return b"stub"


@pytest.fixture
def stub_library(monkeypatch):
    lib = _StubLibrary()
    monkeypatch.setattr(tatt.cuda_build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return lib


# head dims above 256: all-16-bit inputs reach route A with D padded to a
# multiple of 8; f32 and a mix reach split_f32 (q times its scale, k, v, each
# at its own dtype) and route B; every one counts as a wide launch
@pytest.mark.parametrize("dtypes,d,entry,kernel_d", [
    (("bfloat16",) * 3, 257, "flash_attention_wide_bf16", 264),
    (("float32",) * 3, 320, "flash_attention_wide_f32", 320),
    (("float16",) * 3, 512, "flash_attention_wide_f16", 512),
    (("bfloat16", "float32", "float16"), 384, "flash_attention_wide_f32",
     384),
], ids=["bf16_d257", "f32_d320", "f16_d512", "mixed_d384"])
def test_wide_head_dims_reach_the_wide_entry_point(stub_library, monkeypatch,
                                                   dtypes, d, entry,
                                                   kernel_d):
    splits = []
    plain_split = tatt.split_f32
    monkeypatch.setattr(tatt, "split_f32", lambda x, mul=1.0: splits.append(
        (x.dtype, mul)) or plain_split(x, mul))
    q, k, v = (torch.zeros(1, 2, 8, d, dtype=getattr(torch, t))
               for t in dtypes)
    fa = tatt.flash_attention
    counters = ("launches", "wide_launches", "wide16_launches",
                "wide_f32_launches", "mixed_launches", "f32_launches",
                "f16_launches")
    before = [getattr(fa, c) for c in counters]
    assert tatt._kernel_dtype_code(q, k, v) == tatt._WIDE
    out = tatt._flash_forward_cuda(q, k, v, True, 0.05)
    route_b = entry == "flash_attention_wide_f32"
    assert stub_library.calls == [(entry, kernel_d, False)]
    assert splits == ([(q.dtype, 0.05), (k.dtype, 1.0), (v.dtype, 1.0)]
                      if route_b else [])
    assert out.dtype == q.dtype and tuple(out.shape) == (1, 2, 8, d)
    mixed = len(set(dtypes)) > 1
    assert [getattr(fa, c) - b for c, b in zip(counters, before)] == [
        1, 1, int(not route_b), int(route_b), int(mixed), 0, 0]


# each dtype mix, head dim and grad mode takes its backward route: 16-bit at
# D <= 128 the kernel (D padded to a multiple of 8, aligned contiguous
# copies) over the row stats its forward wrote, everything else the torch
# ops; strided views as the split-heads transpose leaves them. The forward
# keeps the stats whenever the kernel could take the gradient.
@pytest.mark.parametrize("dtypes,d,create_graph,forward,stats,backward,"
                         "kernel_d", [
    (("bfloat16",) * 3, 128, False, "flash_attention_bf16", True,
     "flash_attention_bwd_bf16", 128),
    (("float16",) * 3, 20, False, "flash_attention_f16", True,
     "flash_attention_bwd_f16", 24),
    (("bfloat16",) * 3, 64, False, "flash_attention_bf16", True,
     "flash_attention_bwd_bf16", 64),
    (("float32",) * 3, 64, False, "flash_attention_f32", False, None, 64),
    (("bfloat16", "float32", "float16"), 64, False, "flash_attention_f32",
     False, None, 64),
    (("bfloat16",) * 3, 160, False, "flash_attention_bf16", False, None, 160),
    (("float16",) * 3, 64, True, "flash_attention_f16", True, None, 64),
], ids=["bf16_d128", "f16_d20", "bf16_d64", "f32", "mixed", "bf16_d160",
        "f16_create_graph"])
def test_backward_routing_with_stubbed_library(stub_library, monkeypatch,
                                               dtypes, d, create_graph,
                                               forward, stats, backward,
                                               kernel_d):
    monkeypatch.setattr(tatt, "_on_card", lambda t: True)
    torch_route = []
    plain = tatt._flash_backward
    monkeypatch.setattr(tatt, "_flash_backward",
                        lambda *a: torch_route.append(1) or plain(*a))
    q, k, v, g = _inputs((1, 2, 8, 8, d), seed=11)
    q, k, v = (torch.from_numpy(x).to(getattr(torch, t)).transpose(1, 2)
               .contiguous().transpose(1, 2).requires_grad_()
               for x, t in zip((q, k, v), dtypes))
    fa = tatt.flash_attention
    before = (fa.backward_calls, fa.backward_kernel_launches,
              fa.backward_torch_calls)
    out = fa(q, k, v, True)
    grads = torch.autograd.grad(out, [q, k, v],
                                torch.from_numpy(g).to(out.dtype),
                                create_graph=create_graph)
    kernel = backward is not None
    assert stub_library.calls == [(forward, kernel_d, stats)] + (
        [(backward, kernel_d, [])] if kernel else [])
    assert torch_route == ([] if kernel else [1])
    assert (fa.backward_calls, fa.backward_kernel_launches,
            fa.backward_torch_calls) == (before[0] + 1, before[1] + kernel,
                                         before[2] + (not kernel))
    for grad, x in zip(grads, (q, k, v)):
        assert grad.dtype == x.dtype and grad.shape == x.shape
        assert grad.is_contiguous() or not kernel


def test_backward_launch_error_raises(stub_library, monkeypatch):
    """A failed launch of the backward kernel raises; nothing falls back to
    the torch ops."""
    monkeypatch.setattr(tatt, "_on_card", lambda t: True)
    monkeypatch.setattr(type(stub_library), "flash_attention_bwd_bf16",
                        lambda self, *args: 700)
    q = torch.zeros(1, 1, 8, 16, dtype=torch.bfloat16, requires_grad=True)
    before = tatt.flash_attention.backward_torch_calls
    out = tatt.flash_attention(q, q, q, True)
    with pytest.raises(tmx.base.MXNetError, match="flash_attention_bwd_bf16"):
        torch.autograd.grad(out, [q], torch.ones_like(out))
    assert tatt.flash_attention.backward_torch_calls == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = prev


# head dims above 256: D = 257 (padded to 264), 320 with Sq < Sk and Sq > Sk,
# 512 (Q resident in route A), and 1100, ragged and past route A's Q
# residency (12 panels, D <= 768), so Q streams beside K
WIDE_CARD = [((1, 2, 130, 130, 257), True), ((2, 2, 100, 150, 320), True),
             ((1, 2, 150, 100, 320), True), ((1, 2, 200, 200, 512), False),
             ((1, 2, 100, 130, 1100), True)]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-3}
# every 16-bit element within one rounding to the type of the f32 result
HALF_REL = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}


def _half_violations(got, ref, dtype):
    """Elements of ``got`` outside rel·|ref| + 5e-5 (rel 2^-8 bf16, 2^-11
    f16)."""
    return int(((got.float() - ref).abs() >
                HALF_REL[dtype] * ref.abs() + 5e-5).sum().item())


def _wide_counts():
    fa = tatt.flash_attention
    return (fa.wide_launches, fa.wide16_launches, fa.wide_f32_launches,
            tatt.split_f32.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL), ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("shape,causal", WIDE_CARD,
                         ids=["d257", "d320_sq_lt_sk", "d320_sq_gt_sk",
                              "d512", "d1100"])
def test_card_wide_route_matches_plain_and_jax(card, shape, causal, dtype):
    """Route A (bf16, f16) and route B (f32) against the plain version (f32
    from the same inputs) at the route bounds, 16-bit element by element,
    and against the JAX build at one rounding to the dtype (f32: 2e-5, the
    CPU comparison's bound)."""
    q, k, v, _ = (torch.from_numpy(x).to(dtype).float().numpy()
                  for x in _inputs(shape, seed=6))
    qt, kt, vt = (torch.from_numpy(x).to(card, dtype) for x in (q, k, v))
    before = _wide_counts()
    got = tatt.flash_attention(qt, kt, vt, causal)
    torch.cuda.synchronize()
    b = dtype == torch.float32
    assert [a - x for a, x in zip(_wide_counts(), before)] == [
        1, int(not b), int(b), 3 * int(b)]
    assert got.dtype == dtype and tuple(got.shape) == tuple(qt.shape)
    ref = tatt._attention_reference(qt.float(), kt.float(), vt.float(),
                                    causal)
    assert (got.float() - ref).abs().max().item() <= TOL[dtype]
    if not b:
        assert _half_violations(got, ref, dtype) == 0
    want = _jax_grads(q, k, v, np.zeros_like(q), causal)[0]
    atol = 2e-5 if b else TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(), want, rtol=0,
                               atol=atol)


WIDE_MIXES = [("bfloat16", "float32", "float16"),
              ("float16", "float16", "float32"),
              ("float32", "bfloat16", "bfloat16")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", WIDE_MIXES,
                         ids=["_".join(m) for m in WIDE_MIXES])
@pytest.mark.parametrize("d", [300, 320, 512])
def test_card_wide_route_mixed_dtypes(card, d, dtypes):
    """A mix above D = 256 takes route B (three split launches, each input
    at its own dtype), q's dtype out, at one rounding to q's dtype of the
    plain version."""
    q, k, v, _ = _inputs((1, 2, 96, 160, d), seed=7)
    qt, kt, vt = (torch.from_numpy(x).to(card, getattr(torch, t))
                  for x, t in zip((q, k, v), dtypes))
    before = _wide_counts()
    got = tatt.flash_attention(qt, kt, vt, True)
    torch.cuda.synchronize()
    assert [a - x for a, x in zip(_wide_counts(), before)] == [1, 0, 1, 3]
    ref = tatt._attention_reference(qt, kt, vt, True)
    assert got.dtype == qt.dtype
    tol = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-3}[dtypes[0]]
    assert (got.float() - ref.float()).abs().max().item() <= tol


def _sass_functions(opcode):
    """{function: count of ``opcode``} in the flash library's SASS
    (cuobjdump -sass)."""
    import os
    import re
    import shutil
    import subprocess
    from incubator_mxnet_tpu_torch import cuda_build
    cuda_build.load("flash_attention")
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass",
                          str(cuda_build.lib_path("flash_attention"))],
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if line.strip().startswith("Function :"):
            name = line.split(":", 1)[1].strip()
            counts[name] = 0
        elif name and re.search(r"\b%s\b" % opcode, line):
            counts[name] += 1
    return counts


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_fwd_wide16_kernelI13__nv_bfloat16",
                                    "flash_fwd_wide16_kernelI6__half",
                                    "flash_fwd_wide_f32_kernel"],
                         ids=["route_a_bf16", "route_a_f16", "route_b"])
def test_card_wide_kernels_run_on_the_tensor_cores(card, kernel):
    """Every instance of both wide kernels holds HGMMA (wgmma) in its
    SASS."""
    counts = {n: c for n, c in _sass_functions("HGMMA").items()
              if kernel in n}
    assert counts and all(counts.values()), counts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TOL), ids=["f32", "bf16", "f16"])
def test_card_wide_route_is_deterministic(card, dtype):
    """No atomics: two runs of either route give the same bits."""
    q, k, v = (torch.from_numpy(x).to(card, dtype)
               for x in _inputs((2, 4, 256, 256, 512), seed=15)[:3])
    runs = [tatt.flash_attention(q, k, v, True) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*runs)


@pytest.mark.cuda
def test_card_wide_routes_run_on_a_thread_without_a_context(card):
    """Routes A and B encode TMA maps, so they bind the operands' device
    first: on a thread that has made no CUDA call they give the main
    thread's bits."""
    import threading
    q, k, v = (torch.from_numpy(x).to(card, torch.bfloat16)
               for x in _inputs((1, 2, 128, 128, 320), seed=16)[:3])

    def run():
        return [tatt.flash_attention(q, k, v, True),
                tatt.flash_attention(q.float(), k.float(), v.float(), True)]

    want = run()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    spare = torch.empty(1 << 28, dtype=torch.uint8, device=card)
    del spare                    # 256 MiB back in the allocator's cache
    got = []
    worker = threading.Thread(target=lambda: got.append(run()))
    worker.start()
    worker.join()
    torch.cuda.synchronize()
    assert len(got) == 1
    for a, b in zip(got[0], want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", CASES, ids=IDS)
def test_card_backward_matches_jax(card, shape, causal):
    """The kernel's forward and the ported backward on the card against
    jax.vjp on the CPU, f32 (the forward kernel's 2e-5 bound; gradients
    1e-4: the products of the f32 route and of cuBLAS in other orders)."""
    q, k, v, g = _inputs(shape, seed=8)
    want = _jax_grads(q, k, v, g, causal)
    got = _port_grads(q, k, v, g, causal, device=card)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=2e-5)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


# the backward kernel: the smoke's 16-bit cases (the training shape cut to 4
# heads for the CPU's jax.vjp; Sq < Sk, Sq > Sk, Sk = 65, D = 20 and 64), and
# Sk = 1, D = 8 and 96, not causal
BWD_CARD_CASES = [
    ((1, 4, 1024, 1024, 128), True),
    ((1, 2, 128, 256, 64), True),
    ((1, 2, 256, 128, 64), True),      # 128 rows see no key
    ((2, 2, 65, 65, 64), True),
    ((1, 2, 77, 77, 20), True),        # D padded to 24
    ((1, 2, 64, 1, 128), True),        # Sk = 1: 63 rows see no key
    ((1, 2, 64, 1, 128), False),
    ((1, 2, 100, 100, 8), True),
    ((1, 2, 200, 200, 96), False),
    ((2, 3, 256, 256, 64), False),
]
BWD_CARD_IDS = ["%dx%dx%dx%dx%d%s" % (s + ("_causal" if c else "",))
                for s, c in BWD_CARD_CASES]


def _card_kernel_grads(card, q, k, v, g, causal, dtype):
    """dq, dk, dv by the backward kernel on the card (its launch counted,
    the torch ops not), as f32 numpy."""
    qt, kt, vt = (torch.from_numpy(x).to(card, dtype).requires_grad_()
                  for x in (q, k, v))
    fa = tatt.flash_attention
    before = fa.backward_kernel_launches, fa.backward_torch_calls
    out = fa(qt, kt, vt, causal)
    got = torch.autograd.grad(out, [qt, kt, vt],
                              torch.from_numpy(g).to(card, dtype))
    torch.cuda.synchronize()
    assert (fa.backward_kernel_launches, fa.backward_torch_calls) == (
        before[0] + 1, before[1])
    for a, x in zip(got, (qt, kt, vt)):
        assert a.dtype == dtype and a.shape == x.shape
        assert bool(torch.isfinite(a).all())
    return [a.float().cpu().numpy() for a in got]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF, ids=HALF_IDS)
@pytest.mark.parametrize("shape,causal", BWD_CARD_CASES, ids=BWD_CARD_IDS)
def test_card_backward_kernel_matches_plain_and_jax(card, shape, causal,
                                                    dtype):
    """The kernel within 2^-7 of each gradient's largest magnitude of
    autograd through the plain version in f32 (TF32 off) on the same 16-bit
    values, and of jax.vjp in the dtype."""
    (q, k, v, g), (_, *want) = _half_case(shape, causal, dtype, seed=12)
    got = _card_kernel_grads(card, q, k, v, g, causal, dtype)
    plain = [torch.from_numpy(x).to(card).requires_grad_() for x in (q, k, v)]
    ref = torch.autograd.grad(tatt._attention_reference(*plain, causal),
                              plain, torch.from_numpy(g).to(card))
    ratios = _bound_ratios(got, [r.cpu().numpy() for r in ref])
    assert max(ratios) <= 1.0, ratios
    ratios = _bound_ratios(got, want)
    assert max(ratios) <= 1.0, ratios


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF, ids=HALF_IDS)
@pytest.mark.parametrize("shape,causal", [EMU_CASES[2], EMU_CASES[4]],
                         ids=[EMU_IDS[2], EMU_IDS[4]])
def test_card_backward_kernel_keeps_the_split(card, shape, causal, dtype):
    """On keys that share an offset the kernel stays within the bound that
    P and dS rounded once break (the CPU's negative control).  As the
    emulation, it gets the JAX build's out: the offset multiplies delta's
    error into dQ, so one ulp of difference in a forward's rounded out
    would show there too."""
    (q, k, v, g), (out, *want) = _half_case(shape, causal, dtype,
                                            KEY_OFFSET[dtype])
    q, k, v, g, out = (torch.tensor(x).to(card, dtype)
                       for x in (q, k, v, g, out))
    scale = 1.0 / math.sqrt(shape[-1])
    stats = tatt._backward_stats(q)
    tatt._flash_forward_cuda(q, k, v, causal, scale, stats)
    before = tatt.flash_attention.backward_kernel_launches
    got = tatt._flash_backward_cuda(q, k, v, out, g, causal, scale, stats)
    torch.cuda.synchronize()
    assert tatt.flash_attention.backward_kernel_launches == before + 1
    ratios = _bound_ratios([t.float().cpu().numpy() for t in got], want)
    assert max(ratios) <= 1.0, ratios


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF, ids=HALF_IDS)
def test_card_backward_kernel_is_deterministic(card, dtype):
    """No atomics: two runs give the same bits."""
    q, k, v, g = _inputs((2, 4, 512, 512, 128), seed=13)
    runs = [_card_kernel_grads(card, q, k, v, g, True, dtype)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert np.array_equal(a, b)


@pytest.mark.cuda
def test_card_kernels_run_on_a_thread_without_a_context(card):
    """A thread that has made no CUDA call has no current context, and the
    caching allocator may serve all of a call's buffers without one (as on
    autograd's worker thread); the routes that encode TMA maps bind the
    operands' device first, so they give the main thread's bits there."""
    import threading
    q, k, v, g = (torch.from_numpy(x).to(card, torch.bfloat16)
                  for x in _inputs((1, 2, 128, 128, 64), seed=14))

    def run():
        stats = tatt._backward_stats(q)
        out = tatt._flash_forward_cuda(q, k, v, True, 0.125, stats)
        return [out, stats,
                tatt.flash_attention(q.float(), k.float(), v.float(), True),
                *tatt._flash_backward_cuda(q, k, v, out, g, True, 0.125,
                                           stats)]

    want = run()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    spare = torch.empty(1 << 28, dtype=torch.uint8, device=card)
    del spare                    # 256 MiB back in the allocator's cache
    got = []
    worker = threading.Thread(target=lambda: got.append(run()))
    worker.start()
    worker.join()
    torch.cuda.synchronize()
    assert len(got) == 1
    for a, b in zip(got[0], want):
        assert torch.equal(a, b)
