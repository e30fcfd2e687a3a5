"""Flash attention: the hand-written Hopper kernel and its plain version.

Counterpart of ``incubator_mxnet_tpu/ops/attention.py``.  The TPU build runs
the Pallas kernel ``_flash_kernel`` (:56) on the chip and a jnp reference
elsewhere; the port runs a hand-written kernel on a CUDA tensor and the
plain PyTorch :func:`_attention_reference` on a CPU tensor.  Which path
runs follows only from the device of the tensors: for a CUDA tensor the
wrapper launches the kernel or raises, and never falls back.  The kernel's
C entry point picks its route by dtype: bfloat16 runs
``csrc/flash_attention_sm90.cu`` (wgmma and TMA, P split into two bf16
halves so the products stay f32-exact), float32 ``csrc/flash_attention.cu``
(f32 on the CUDA cores).

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
_MAX_HEAD_DIM = 128
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the bf16 route loads rows by TMA, whose row stride is a multiple of 16 bytes
_BF16_COLUMNS = 8


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
    return its dtype code."""
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KERNEL_DTYPES:
        raise TypeError("the flash_attention kernel takes q, k, v all float32 "
                        "or all bfloat16, got %s, %s, %s"
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
    return _KERNEL_DTYPES[q.dtype]


def _flash_forward_cuda(q, k, v, causal, scale):
    """Launch ``flash_attention_fwd`` on the current stream of q's device."""
    code = _kernel_dtype_code(q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    # the split-heads transpose leaves q, k, v strided: one copy each, as
    # XLA's transpose is on the TPU
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    dk = d
    if q.dtype == torch.bfloat16:
        # zero columns of q and k add nothing to QKᵀ, and those of v give
        # output columns that are cut off again
        dk = -(-d // _BF16_COLUMNS) * _BF16_COLUMNS
        if dk != d:
            q, k, v = (torch.nn.functional.pad(t, (0, dk - d))
                       for t in (q, k, v))
        # TMA reads from 16-byte aligned bases; a view may start anywhere
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
    o = torch.empty_like(q)
    lib = cuda_build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(),
                                      v.data_ptr(), o.data_ptr(), b * h, sq,
                                      sk, dk, float(scale), int(bool(causal)),
                                      code, stream)
    if err != 0:
        raise MXNetError("flash_attention_fwd launch failed: CUDA error %d "
                         "(%s)" % (err, lib.flash_attention_error_string(err)
                                   .decode()))
    flash_attention.launches += 1
    return o if dk == d else o[..., :d].contiguous()


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
    ``flash_attention.launches``); a CPU tensor through the plain version.
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


@register("_contrib_FlashAttention", num_inputs=3,
          aliases=("flash_attention", "_contrib_DotProductAttention"))
def _flash_attention_op(q, k, v, causal=False, scale=None):
    """Registered op wrapper — (B, H, S, D) inputs."""
    return flash_attention(q, k, v, causal, scale)
