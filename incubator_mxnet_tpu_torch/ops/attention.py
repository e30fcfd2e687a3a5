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
``csrc/flash_attention.cu`` holds the library's C entry points.

Registered as op ``_contrib_FlashAttention`` (and its aliases), so the
eager NDArray surface and Gluon's ``MultiHeadAttention`` reach it.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from .. import cuda_build
from .registry import register

_NEG_INF = -1e30
_MAX_HEAD_DIM = 256
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
    return its route's dtype code: 1 (all bfloat16) or 2 (all float16) for
    the 16-bit kernel, 0 for the f32 route (all float32, or a mix)."""
    for t in (q, k, v):
        if t.dtype not in _KERNEL_DTYPES:
            raise TypeError("the flash_attention kernel takes float32, "
                            "bfloat16 and float16 tensors, got %s, %s, %s"
                            % (q.dtype, k.dtype, v.dtype))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if not 1 <= d <= _MAX_HEAD_DIM:
        raise ValueError("the flash_attention kernel takes head dims 1..%d, "
                         "got %d" % (_MAX_HEAD_DIM, d))
    if b * h < 1 or sq < 1 or sk < 1:
        raise ValueError("the flash_attention kernel needs B*H, Sq, Sk >= 1, "
                         "got shapes %s, %s" % (tuple(q.shape),
                                                tuple(k.shape)))
    if b * h >= 2 ** 31 or -(-sq // 64) > 65535:
        raise ValueError("flash_attention: B*H=%d or Sq=%d exceeds the "
                         "kernel's grid" % (b * h, sq))
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
    version."""
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
    if not 1 <= d <= _MAX_HEAD_DIM or x.numel() == 0:
        raise ValueError("split_f32 takes head dims 1..%d and a non-empty "
                         "tensor, got %s" % (_MAX_HEAD_DIM, tuple(x.shape)))
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
    """The f32 route's attention kernel over the planes of :func:`split_f32`
    (q's times its scale); ``shape`` is q's (B, H, Sq, D)."""
    b, h, sq, d = shape
    o = torch.empty((b, h, sq, d), dtype=torch.float32, device=qp.device)
    with torch.cuda.device(qp.device):
        stream = torch.cuda.current_stream(qp.device).cuda_stream
        err = lib.flash_attention_f32(qp.data_ptr(), kp.data_ptr(),
                                      vp.data_ptr(), o.data_ptr(), b * h, sq,
                                      kp.shape[2], d, int(bool(causal)),
                                      stream)
    _raise_on(err, lib, "flash_attention_f32")
    return o


def _flash_forward_f32(q, k, v, causal, scale, lib):
    """The f32 route: split q (times ``scale``, as the TPU kernel scales q),
    k and v, each at its own dtype, into bf16 planes, then the six-product
    attention kernel; the f32 result in q's dtype, as the reference returns
    a mix."""
    o = _attention_f32_planes(split_f32(q, scale), split_f32(k), split_f32(v),
                              q.shape, causal, lib)
    flash_attention.f32_launches += 1
    if not q.dtype == k.dtype == v.dtype:
        flash_attention.mixed_launches += 1
    return o.to(q.dtype)


def _flash_forward_16bit(q, k, v, causal, scale, lib):
    """The bf16 or f16 route, on contiguous, 16-byte aligned copies of
    q, k, v."""
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
    entry = "flash_attention_f16" if q.dtype == torch.float16 else \
        "flash_attention_bf16"
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  o.data_ptr(), b * h, sq, sk, dk,
                                  float(scale), int(bool(causal)), stream)
    _raise_on(err, lib, entry)
    if q.dtype == torch.float16:
        flash_attention.f16_launches += 1
    return o if dk == d else o[..., :d].contiguous()


def _flash_forward_cuda(q, k, v, causal, scale):
    """Launch the kernel's route for the dtypes of q, k, v on the current
    stream of q's device."""
    code = _kernel_dtype_code(q, k, v)
    lib = cuda_build.load("flash_attention")
    route = _flash_forward_f32 if code == 0 else _flash_forward_16bit
    o = route(q, k, v, causal, scale, lib)
    flash_attention.launches += 1
    return o


class _FlashAttentionFunction(torch.autograd.Function):
    """The kernel under autograd.  Its backward is not ported yet."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        return _flash_forward_cuda(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "flash_attention backward on CUDA is not ported yet: it comes "
            "with the training slice, which ports _flash_bwd "
            "(incubator_mxnet_tpu/ops/attention.py:168)")


def flash_attention(q, k, v, causal=False, scale=None):
    """softmax(QKᵀ·scale)·V over (B, H, S, D) tensors.

    A CUDA tensor goes through the hand-written kernel (and bumps
    ``flash_attention.launches``; on the f32 route also
    ``flash_attention.f32_launches``, and for a mix of dtypes
    ``flash_attention.mixed_launches``; on the f16 route
    ``flash_attention.f16_launches``); a CPU tensor through the plain
    version.
    ``scale`` defaults to 1/sqrt(D); with ``causal`` the diagonal is
    anchored at the end of the key axis.  The output has q's dtype."""
    _check_inputs(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _attention_reference(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise MXNetError("flash_attention runs on CUDA or CPU tensors, got "
                         "device %s" % q.device)
    return _FlashAttentionFunction.apply(q, k, v, bool(causal), float(scale))


flash_attention.launches = 0
flash_attention.f32_launches = 0
flash_attention.f16_launches = 0
flash_attention.mixed_launches = 0


@register("_contrib_FlashAttention", num_inputs=3,
          aliases=("flash_attention", "_contrib_DotProductAttention"))
def _flash_attention_op(q, k, v, causal=False, scale=None):
    """Registered op wrapper — (B, H, S, D) inputs."""
    return flash_attention(q, k, v, causal, scale)
