"""Flash attention: the hand-written Hopper kernel and its plain version.

Counterpart of ``incubator_mxnet_tpu/ops/attention.py``.  The TPU build runs
the Pallas kernel ``_flash_kernel`` (:56) on the chip and a jnp reference
elsewhere; the port runs a hand-written kernel on a CUDA tensor and the
plain PyTorch :func:`_attention_reference` on a CPU tensor.  Which path
runs follows only from the device of the tensors: for a CUDA tensor the
wrapper launches the kernel or raises, and never falls back.  The route
follows the dtypes, and every route runs on the tensor cores (wgmma and
TMA), at head dims 1..256: bfloat16 and float16 run
``csrc/flash_attention_sm90.cu`` (P split into two halves of the input's
type so the products stay f32-exact); float32, and any mix of float32,
bfloat16 and float16 (which the reference promotes to f32, returning q's
dtype), run the split pass :func:`split_f32` (each operand, read at its own
dtype, into three bf16 planes, plain version :func:`_split_f32_reference`)
and then ``csrc/flash_attention_f32_sm90.cu`` (six bf16 products for each
f32 product, as XLA computes ``Precision.HIGHEST`` on the TPU).
Head dims above 256, as the reference pads any head dim and runs it, run
``csrc/flash_attention_wide_sm90.cu`` (wgmma and TMA, Q and K streamed
through shared memory in 64-column panels, 256 output columns a block):
route A for all-bfloat16 or all-float16 inputs (the 16-bit route's split of
P), route B for float32 and any mix (the same split pass, then six bf16
products for each f32 product).  ``csrc/flash_attention.cu`` holds the
library's C entry points.

The backward is the reference's ``_flash_bwd`` (ops/attention.py:168-242),
which the JAX build runs as jnp under XLA.  Both devices go through one
``torch.autograd.Function``, whose backward takes one of two routes:

- the kernel, ``csrc/flash_attention_bwd_sm90.cu`` (:func:`_flash_backward_cuda`:
  dQ, dK and dV on wgmma over the row stats that the 16-bit forward kept,
  P and dS split into two halves and kept in registers), for CUDA tensors
  that are all bfloat16 or all float16 at head dims up to 128, when grad
  mode is off inside the backward (no ``create_graph``); it bumps
  ``flash_attention.backward_kernel_launches``;
- the torch ops of :func:`_flash_backward` (the same chunked passes as the
  reference, f32 with TF32 off, ``Precision.HIGHEST``) for everything else:
  every CPU tensor (it is the kernel's plain version), and on the card f32,
  dtype mixes, head dims above 128 and ``create_graph=True`` (a second
  derivative needs a differentiable backward); it bumps
  ``flash_attention.backward_torch_calls``.

Neither route falls back to the other: a build or launch failure of the
kernel raises ``MXNetError``.

Registered as op ``_contrib_FlashAttention`` (and its aliases), so the
eager NDArray surface and Gluon's ``MultiHeadAttention`` reach it.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from .. import cuda_build
from ._precision import f32_products as _f32_products
from .registry import register

_NEG_INF = -1e30
# the head dims of the routes in csrc/flash_attention_sm90.cu and
# csrc/flash_attention_f32_sm90.cu; above it the wide routes
_MAX_HEAD_DIM = 256
_WIDE = 3     # route code of the head dims above _MAX_HEAD_DIM
# the dtypes a kernel reads, by their code in the C entry points
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# every route loads rows by TMA, whose row stride is a multiple of 16 bytes:
# head dims are padded to a multiple of 8 bf16 columns
_COLUMNS = 8
_PIECES = 3   # bf16 planes of an f32 operand on the f32 route


def _attention_reference(q, k, v, causal=False, scale=None):
    """(B, H, Sq, D), (B, H, Sk, D) → (B, H, Sq, D), all math in float32.

    Plain copy of the JAX build's ``_attention_reference``
    (ops/attention.py:37-49): the causal mask is ``tril(k=sk-sq)``, anchored
    at the end of the key axis, and masked logits take the finite -1e30
    sentinel, so a row that sees no key averages V uniformly."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
        logits = logits.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs,
                        v.to(torch.float32)).to(q.dtype)


def _check_inputs(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes (B, H, S, D) tensors, got "
                         "shapes %s, %s, %s" % (tuple(q.shape), tuple(k.shape),
                                                tuple(v.shape)))
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v are on different devices "
                         "(%s, %s, %s)" % (q.device, k.device, v.device))
    for t in (q, k, v):
        if not t.is_floating_point():
            raise TypeError("flash_attention takes floating-point tensors, "
                            "got %s" % t.dtype)
    if k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError("flash_attention: q %s does not match k %s and v %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))


def _kernel_dtype_code(q, k, v):
    """Check what the CUDA kernel takes beyond :func:`_check_inputs` and
    return its route's code: 1 (all bfloat16) or 2 (all float16) for the
    16-bit kernel, 0 for the f32 route (all float32, or a mix), each at head
    dims up to 256; ``_WIDE`` (3) for head dims above 256, any dtype (route
    A or B by the dtypes, :func:`_flash_forward_wide`)."""
    for t in (q, k, v):
        if t.dtype not in _KERNEL_DTYPES:
            raise TypeError("the flash_attention kernel takes float32, "
                            "bfloat16 and float16 tensors, got %s, %s, %s"
                            % (q.dtype, k.dtype, v.dtype))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if d < 1:
        raise ValueError("the flash_attention kernel needs a head dim >= 1, "
                         "got %d" % d)
    if b * h < 1 or sq < 1 or sk < 1:
        raise ValueError("the flash_attention kernel needs B*H, Sq, Sk >= 1, "
                         "got shapes %s, %s" % (tuple(q.shape),
                                                tuple(k.shape)))
    if b * h >= 2 ** 31 or -(-sq // 64) > 65535:
        raise ValueError("flash_attention: B*H=%d or Sq=%d exceeds the "
                         "kernel's grid" % (b * h, sq))
    if d > _MAX_HEAD_DIM:
        return _WIDE
    if q.dtype == k.dtype == v.dtype:
        return _KERNEL_DTYPES[q.dtype]
    return 0


def _split_f32_reference(x, mul=1.0):
    """Plain version of :func:`split_f32`: ``x`` (B, H, S, D) float32 times
    ``mul`` as planes (3, B*H, S, Dp) bfloat16, Dp = D rounded up to a
    multiple of 8 with zero columns.  Plane 0 is bf16(x), plane 1 the
    rounding of what plane 0 left, plane 2 of what both left; the
    subtractions are exact in f32, so the three carry x to 24 bits."""
    b, h, s, d = x.shape
    dp = -(-d // _COLUMNS) * _COLUMNS
    rest = torch.nn.functional.pad(
        (x.to(torch.float32) * mul).reshape(b * h, s, d), (0, dp - d))
    planes = []
    for _ in range(_PIECES):
        planes.append(rest.to(torch.bfloat16))
        rest = rest - planes[-1].float()
    return torch.stack(planes)


def _raise_on(err, lib, entry):
    if err != 0:
        raise MXNetError("%s launch failed: CUDA error %d (%s)" % (
            entry, err, lib.flash_attention_error_string(err).decode()))


def split_f32(x, mul=1.0):
    """The f32 route's split pass: (B, H, S, D) float32, bfloat16 or float16
    times ``mul`` (in f32) into three bf16 planes (3, B*H, S, Dp), as
    :func:`_split_f32_reference`.

    A CUDA tensor goes through the kernel (``split3_kernel`` of
    ``csrc/flash_attention_f32_sm90.cu``, which reads ``x``'s strides and
    dtype, so neither a split-heads view nor a 16-bit input of a mix needs a
    copy) and bumps ``split_f32.launches``; a CPU tensor through the plain
    version.  Any head dim: the f32 route's up to 256 and route B's above."""
    if x.device.type == "cpu":
        return _split_f32_reference(x, mul)
    if x.device.type != "cuda":
        raise MXNetError("split_f32 runs on CUDA or CPU tensors, got device "
                         "%s" % x.device)
    if x.dtype not in _KERNEL_DTYPES or x.ndim != 4:
        raise TypeError("split_f32 takes a (B, H, S, D) float32, bfloat16 or "
                        "float16 tensor, got %s %s" % (x.dtype,
                                                       tuple(x.shape)))
    b, h, s, d = x.shape
    if x.numel() == 0:
        raise ValueError("split_f32 takes a non-empty tensor, got %s"
                         % (tuple(x.shape),))
    dp = -(-d // _COLUMNS) * _COLUMNS
    planes = torch.empty((_PIECES, b * h, s, dp), dtype=torch.bfloat16,
                         device=x.device)
    lib = cuda_build.load("flash_attention")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.flash_attention_f32_split(x.data_ptr(), *x.stride(),
                                            planes.data_ptr(), b, h, s, d,
                                            float(mul), _KERNEL_DTYPES[x.dtype],
                                            stream)
    _raise_on(err, lib, "flash_attention_f32_split")
    split_f32.launches += 1
    return planes


split_f32.launches = 0


def _attention_f32_planes(qp, kp, vp, shape, causal, lib):
    """The attention kernel over the planes of :func:`split_f32` (q's times
    its scale): the f32 route's up to D = 256, route B's above; ``shape`` is
    q's (B, H, Sq, D)."""
    b, h, sq, d = shape
    entry = "flash_attention_wide_f32" if d > _MAX_HEAD_DIM else \
        "flash_attention_f32"
    o = torch.empty((b, h, sq, d), dtype=torch.float32, device=qp.device)
    with torch.cuda.device(qp.device):
        stream = torch.cuda.current_stream(qp.device).cuda_stream
        err = getattr(lib, entry)(qp.data_ptr(), kp.data_ptr(),
                                  vp.data_ptr(), o.data_ptr(), b * h, sq,
                                  kp.shape[2], d, int(bool(causal)), stream)
    _raise_on(err, lib, entry)
    return o


def _flash_forward_f32(q, k, v, causal, scale, lib):
    """The f32 route (route B above D = 256): split q (times ``scale``, as
    the TPU kernel scales q), k and v, each at its own dtype, into bf16
    planes, then the six-product attention kernel; the f32 result in q's
    dtype, as the reference returns a mix."""
    o = _attention_f32_planes(split_f32(q, scale), split_f32(k), split_f32(v),
                              q.shape, causal, lib)
    if q.shape[-1] > _MAX_HEAD_DIM:
        flash_attention.wide_f32_launches += 1
    else:
        flash_attention.f32_launches += 1
    if not q.dtype == k.dtype == v.dtype:
        flash_attention.mixed_launches += 1
    return o.to(q.dtype)


def _flash_forward_16bit(q, k, v, causal, scale, lib, stats=None):
    """The bf16 or f16 route (route A above D = 256), on contiguous, 16-byte
    aligned copies of q, k, v with D padded to a multiple of 8; with
    ``stats`` (from :func:`_backward_stats`, D <= 128) it also writes each
    row's softmax stats for the backward kernel."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    # the split-heads transpose leaves q, k, v strided: one copy each, as
    # XLA's transpose is on the TPU
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    # zero columns of q and k add nothing to QKᵀ, and those of v give output
    # columns that are cut off again
    dk = -(-d // _COLUMNS) * _COLUMNS
    if dk != d:
        q, k, v = (torch.nn.functional.pad(t, (0, dk - d)) for t in (q, k, v))
    # TMA reads from 16-byte aligned bases; a view may start anywhere
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    o = torch.empty_like(q)
    wide = d > _MAX_HEAD_DIM
    entry = "flash_attention_%s%s" % (
        "wide_" if wide else "", "f16" if q.dtype == torch.float16 else "bf16")
    # the wide entries take no stats: the backward kernel's head dims end at
    # 128
    extra = () if wide else (None if stats is None else stats.data_ptr(),)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  o.data_ptr(), b * h, sq, sk, dk,
                                  float(scale), int(bool(causal)), *extra,
                                  stream)
    _raise_on(err, lib, entry)
    if wide:
        flash_attention.wide16_launches += 1
    elif q.dtype == torch.float16:
        flash_attention.f16_launches += 1
    return o if dk == d else o[..., :d].contiguous()


def _flash_forward_wide(q, k, v, causal, scale, lib):
    """Head dims above 256: all-bfloat16 or all-float16 inputs take route A
    (:func:`_flash_forward_16bit`), float32 and any mix route B
    (:func:`_flash_forward_f32`); both kernels are in
    ``csrc/flash_attention_wide_sm90.cu``."""
    if q.dtype == k.dtype == v.dtype and q.dtype != torch.float32:
        o = _flash_forward_16bit(q, k, v, causal, scale, lib)
    else:
        o = _flash_forward_f32(q, k, v, causal, scale, lib)
    flash_attention.wide_launches += 1
    return o


def _flash_forward_cuda(q, k, v, causal, scale, stats=None):
    """Launch the kernel's route for the dtypes and head dim of q, k, v on
    the current stream of q's device; ``stats`` (the 16-bit routes at head
    dims up to 128 only) receives the row stats of the backward kernel."""
    code = _kernel_dtype_code(q, k, v)
    lib = cuda_build.load("flash_attention")
    if code in (1, 2):
        o = _flash_forward_16bit(q, k, v, causal, scale, lib, stats)
    else:
        route = _flash_forward_wide if code == _WIDE else _flash_forward_f32
        o = route(q, k, v, causal, scale, lib)
    flash_attention.launches += 1
    return o


def _kv_block_size(sk):
    """The backward's key chunk: the largest power of two up to 1024 that
    divides ``sk``, else ``sk`` (the reference's ``_kv_block_size``, :155)."""
    for b in (1024, 512, 256, 128, 64):
        if sk % b == 0:
            return b
    return sk


def _flash_backward(q, k, v, out, g, causal, scale):
    """(dq, dk, dv) of flash attention, in q's, k's and v's dtypes: the
    reference's ``_flash_bwd`` (ops/attention.py:168-242) in torch ops.

    Two passes over key chunks of :func:`_kv_block_size`, never the whole
    (Sq x Sk) score matrix at once: pass 1 recovers each row's max ``m`` and
    sum ``l`` by an online scan, kept apart (m + log l would lose log l
    against the -1e30 sentinel of a row that sees no key); pass 2 rebuilds
    each chunk's P = exp(s - m) / l and accumulates dQ, and each chunk's dK
    and dV.  delta = (g·out).sum(-1).  ds is zeroed at masked logits: they
    are constants of the forward, so a row that sees no key (uniform P)
    gives them no gradient.  Everything runs in f32 with TF32 off."""
    f32 = torch.float32
    sq, sk = q.shape[2], k.shape[2]
    block = _kv_block_size(sk)
    with _f32_products():
        qf, kf, vf, gf = (t.to(f32) for t in (q, k, v, g))
        q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)

        def scores(i):
            kb = kf[:, :, i * block:(i + 1) * block]
            s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
            if not causal:
                return kb, s, None
            k_pos = i * block + torch.arange(block, device=q.device)[None, :]
            mask = q_pos >= k_pos
            return kb, s.masked_fill(~mask, _NEG_INF), mask

        m = torch.full(q.shape[:3], _NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros(q.shape[:3], dtype=f32, device=q.device)
        for i in range(sk // block):
            _, s, _ = scores(i)
            m_new = torch.maximum(m, s.amax(-1))
            l = l * torch.exp(m - m_new) + \
                torch.exp(s - m_new[..., None]).sum(-1)
            m = m_new
        l_inv = 1.0 / l.clamp_min(1e-20)
        delta = (gf * out.to(f32)).sum(-1)
        dq = torch.zeros_like(qf)
        dks, dvs = [], []
        for i in range(sk // block):
            kb, s, mask = scores(i)
            vb = vf[:, :, i * block:(i + 1) * block]
            p = torch.exp(s - m[..., None]) * l_inv[..., None]
            dvs.append(torch.matmul(p.transpose(-1, -2), gf))
            dp = torch.matmul(gf, vb.transpose(-1, -2))
            ds = p * (dp - delta[..., None]) * scale
            if mask is not None:
                ds = ds.masked_fill(~mask, 0.0)
            dq = dq + torch.matmul(ds, kb)
            dks.append(torch.matmul(ds.transpose(-1, -2), qf))
        dk = dks[0] if len(dks) == 1 else torch.cat(dks, dim=2)
        dv = dvs[0] if len(dvs) == 1 else torch.cat(dvs, dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# the backward kernel's head dims (its dK/dV blocks hold one 64-column slice
# of 64 keys and its dQ blocks all of D in registers)
_MAX_BACKWARD_HEAD_DIM = 128
# rows of the row stats are padded to the kernels' 128-row query blocks
_BACKWARD_ROWS = 128


def _backward_stats(q):
    """The buffer of the backward kernel's row stats for (B, H, Sq, D) ``q``:
    (B*H, Sq rounded up to 128, 4) f32, each row's (m, 1 / l) written by the
    16-bit forward kernel and delta by the backward's dQ kernel."""
    b, h, sq, _ = q.shape
    return torch.empty((b * h, -(-sq // _BACKWARD_ROWS) * _BACKWARD_ROWS, 4),
                       dtype=torch.float32, device=q.device)


def _on_card(t):
    """Is ``t`` on a CUDA card?  (The one device test of the backward's
    routing, so the CPU tests can drive that routing with a stubbed
    library.)"""
    return t.device.type == "cuda"


def _backward_kernel_inputs(q, k, v):
    """Can the backward kernel take these inputs?  CUDA tensors, all
    bfloat16 or all float16, head dim up to 128."""
    return (_on_card(q) and q.dtype == k.dtype == v.dtype and
            q.dtype in (torch.bfloat16, torch.float16) and
            q.shape[-1] <= _MAX_BACKWARD_HEAD_DIM)


def _flash_backward_cuda(q, k, v, out, g, causal, scale, stats):
    """(dq, dk, dv) by the backward kernel
    (``csrc/flash_attention_bwd_sm90.cu``), on contiguous, 16-byte aligned
    copies of q, k, v, out and g with the head dim padded to a multiple of 8
    (zero columns add nothing to S or dP, and their gradient columns are cut
    off again), over ``stats``, the row stats the forward wrote (see
    :func:`_backward_stats`)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dpad = -(-d // _COLUMNS) * _COLUMNS
    ins = []
    for t in (q, k, v, out, g.to(q.dtype)):
        t = t.contiguous()
        if dpad != d:
            t = torch.nn.functional.pad(t, (0, dpad - d))
        ins.append(t if t.data_ptr() % 16 == 0 else t.clone())
    grads = [torch.empty_like(t) for t in ins[:3]]
    entry = "flash_attention_bwd_f16" if q.dtype == torch.float16 else \
        "flash_attention_bwd_bf16"
    lib = cuda_build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, entry)(*(t.data_ptr() for t in ins + grads),
                                  stats.data_ptr(), b * h, sq, sk, dpad,
                                  float(scale), int(bool(causal)), stream)
    _raise_on(err, lib, entry)
    flash_attention.backward_kernel_launches += 1
    if dpad != d:
        grads = [t[..., :d].contiguous() for t in grads]
    return tuple(grads)


class _FlashAttentionFunction(torch.autograd.Function):
    """Flash attention under autograd, on either device: the forward is the
    kernel on a CUDA tensor and the plain version on a CPU tensor; the
    backward is the backward kernel for inputs it takes
    (:func:`_backward_kernel_inputs`) when grad mode is off inside the
    backward (it is on only under ``create_graph``), else
    :func:`_flash_backward`.  It saves the inputs as given,
    the output (no padded or contiguous copy of the 16-bit route) and, for
    the backward kernel, the row stats the forward wrote.  Under
    ``create_graph=True`` the backward is the torch ops, which are
    differentiable, so a second derivative goes through them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        stats = None
        if not _on_card(q):
            out = _attention_reference(q, k, v, causal, scale)
        else:
            # a gradient to come that the backward kernel can take: the
            # forward keeps each row's softmax stats for it
            if any(ctx.needs_input_grad[:3]) and \
                    _backward_kernel_inputs(q, k, v):
                stats = _backward_stats(q)
            out = _flash_forward_cuda(q, k, v, causal, scale, stats)
        ctx.save_for_backward(q, k, v, out, stats)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, stats = ctx.saved_tensors
        # a named span, so a profile can attribute the backward's kernels
        with torch.profiler.record_function("flash_attention_backward"):
            if _backward_kernel_inputs(q, k, v) and \
                    not torch.is_grad_enabled():
                dq, dk, dv = _flash_backward_cuda(q, k, v, out, grad_out,
                                                  ctx.causal, ctx.scale,
                                                  stats)
            else:
                dq, dk, dv = _flash_backward(q, k, v, out, grad_out,
                                             ctx.causal, ctx.scale)
                flash_attention.backward_torch_calls += 1
        flash_attention.backward_calls += 1
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None):
    """softmax(QKᵀ·scale)·V over (B, H, S, D) tensors.

    A CUDA tensor goes through the hand-written kernel (and bumps
    ``flash_attention.launches``; on the f32 route also
    ``flash_attention.f32_launches``, and for a mix of dtypes
    ``flash_attention.mixed_launches``; on the f16 route
    ``flash_attention.f16_launches``; at head dims above 256
    ``flash_attention.wide_launches`` and its route's
    ``wide16_launches`` (A: bf16, f16) or ``wide_f32_launches`` (B: f32,
    mixes)); a CPU tensor through the plain version.  The gradient takes
    the backward kernel or :func:`_flash_backward` as the module's docstring
    says
    (``flash_attention.backward_calls`` counts both,
    ``backward_kernel_launches`` and ``backward_torch_calls`` each route).
    ``scale`` defaults to 1/sqrt(D); with ``causal`` the diagonal is
    anchored at the end of the key axis.  The output has q's dtype."""
    _check_inputs(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type not in ("cpu", "cuda"):
        raise MXNetError("flash_attention runs on CUDA or CPU tensors, got "
                         "device %s" % q.device)
    return _FlashAttentionFunction.apply(q, k, v, bool(causal), float(scale))


flash_attention.launches = 0
flash_attention.f32_launches = 0
flash_attention.f16_launches = 0
flash_attention.mixed_launches = 0
flash_attention.wide_launches = 0
flash_attention.wide16_launches = 0
flash_attention.wide_f32_launches = 0
flash_attention.backward_calls = 0
flash_attention.backward_kernel_launches = 0
flash_attention.backward_torch_calls = 0


@register("_contrib_FlashAttention", num_inputs=3,
          aliases=("flash_attention", "_contrib_DotProductAttention"))
def _flash_attention_op(q, k, v, causal=False, scale=None):
    """Registered op wrapper — (B, H, S, D) inputs."""
    return flash_attention(q, k, v, causal, scale)
