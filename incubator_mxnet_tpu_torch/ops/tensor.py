"""Shape-manipulation, indexing and creation operators.

Counterpart of ``incubator_mxnet_tpu/ops/tensor.py`` and ``ops/init_ops.py``,
limited to the ops the decoder-LM and ResNet paths and the
NDArray surface use.  Reshape/transpose/slice return torch views; ``ndarray.invoke``
copies them so results never alias inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import torch_dtype
from .registry import register


def infer_reshape(src_shape, target, reverse=False):
    """MXNet Reshape special codes (ref: matrix_op-inl.h ReshapeParam docs):

    0 = copy this dim; -1 = infer; -2 = copy all remaining dims;
    -3 = merge next two dims; -4 = split next dim by the following two values.
    """
    src = list(src_shape)
    tgt = list(target)
    if reverse:
        src = src[::-1]
        tgt = [t for t in tgt[::-1]]
        # -4's two split factors travel with it; reversing swaps them
        out = infer_reshape(src, tgt, reverse=False)
        return tuple(out[::-1])
    out = []
    i = 0  # index into src
    j = 0
    while j < len(tgt):
        t = tgt[j]
        if t == 0:
            out.append(src[i]); i += 1
        elif t == -1:
            out.append(-1); i += 1  # placeholder; src cursor advance is heuristic
        elif t == -2:
            out.extend(src[i:]); i = len(src)
        elif t == -3:
            out.append(src[i] * src[i + 1]); i += 2
        elif t == -4:
            a, b = tgt[j + 1], tgt[j + 2]
            d = src[i]
            if a == -1:
                a = d // b
            if b == -1:
                b = d // a
            out.extend([a, b]); i += 1; j += 2
        else:
            out.append(t)
            # advance src cursor heuristically (only matters for 0/-1 codes)
            if i < len(src):
                i += 1
        j += 1
    known = 1
    for d in out:
        if d != -1:
            known *= d
    total = int(np.prod(src_shape)) if src_shape else 1
    return tuple(d if d != -1 else total // max(known, 1) for d in out)


def checked_reshape(src_shape, target, reverse=False):
    """:func:`infer_reshape`, raising ``ValueError`` when the element count
    changes."""
    new_shape = infer_reshape(src_shape, target, reverse)
    size = int(np.prod(src_shape)) if src_shape else 1
    if int(np.prod(new_shape)) != size:
        raise ValueError("cannot reshape %s into %s" % (tuple(src_shape),
                                                        new_shape))
    return new_shape


@register("Reshape", num_inputs=1, aliases=("reshape",))
def _reshape(data, shape=(), reverse=False):
    """ref: src/operator/tensor/matrix_op.cc Reshape"""
    return data.reshape(checked_reshape(data.shape, shape, reverse))


@register("Flatten", num_inputs=1, aliases=("flatten",))
def _flatten(data):
    """ref: matrix_op.cc Flatten: every axis after the first into one."""
    return data.reshape(data.shape[0], -1)


@register("transpose", num_inputs=1)
def _transpose(data, axes=()):
    """ref: matrix_op.cc transpose (no axes: reverse them all)"""
    return data.permute(*(axes if axes else range(data.ndim - 1, -1, -1)))


@register("expand_dims", num_inputs=1)
def _expand_dims(data, axis=0):
    return data.unsqueeze(axis)


@register("slice_axis", num_inputs=1)
def _slice_axis(data, axis=0, begin=0, end=None):
    """ref: matrix_op.cc slice_axis"""
    axis = axis % data.ndim
    n = data.shape[axis]
    b = begin if begin >= 0 else begin + n
    e = n if end is None else (end if end >= 0 else end + n)
    return data.narrow(axis, b, e - b)


@register("Embedding", num_inputs=2, nograd_inputs=(0,),
          input_names=("data", "weight"))
def _embedding(data, weight, input_dim=0, output_dim=0, dtype="float32",
               sparse_grad=False):
    """ref: indexing_op.cc Embedding — gather rows of weight.

    Out-of-range ids are clamped to the table, as in the reference and the
    JAX build (ops/tensor.py:258-261); ``F.embedding`` would raise."""
    idx = data.to(torch.int64).clamp(0, weight.shape[0] - 1)
    return weight[idx]


def _fill_value(dtype):
    """What ``jnp.take_along_axis`` (mode "fill") returns for an index out
    of range: NaN for floats, the lowest value of a signed integer type, the
    highest of an unsigned one, True for bool."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


@register("batch_take", num_inputs=2, nograd_inputs=(1,), aliases=("pick",))
def _pick(data, index, axis=1, keepdims=False):
    """ref: indexing_op.cc pick/batch_take — ``data`` at ``index`` along
    ``axis``, as the JAX build's ``take_along_axis`` (ops/tensor.py:238-245):
    ``index`` holds floats (truncated, NaN as 0) or ints, one per position of
    the other axes; an index in [-n, -1] counts from the end, and one outside
    [-n, n) gives :func:`_fill_value` (NaN for floats).  The range check is
    elementwise on the device, so it never waits for the card."""
    axis = axis % data.ndim
    n = data.shape[axis]
    if index.is_floating_point():
        index = torch.nan_to_num(index, nan=0.0).clamp(-2.0 ** 31,
                                                       2.0 ** 31 - 1)
    idx = index.to(torch.int64).unsqueeze(axis)
    valid = (idx >= -n) & (idx < n)
    safe = torch.where(valid, torch.where(idx < 0, idx + n, idx), 0)
    out = torch.take_along_dim(data, safe, dim=axis)
    out = torch.where(valid, out, torch.full((), _fill_value(data.dtype),
                                             dtype=data.dtype,
                                             device=data.device))
    return out if keepdims else out.squeeze(axis)


@register("Cast", num_inputs=1, aliases=("cast",))
def _cast(data, dtype="float32"):
    return data.to(torch_dtype(dtype))


@register("_zeros", num_inputs=0, aliases=("zeros",))
def _zeros(shape=(), dtype="float32", device=None):
    return torch.zeros(shape, dtype=torch_dtype(dtype), device=device)


@register("zeros_like", num_inputs=1, differentiable=False)
def _zeros_like(data):
    """ref: init_ops.py:42 zeros_like."""
    return torch.zeros_like(data)


@register("_ones", num_inputs=0, aliases=("ones",))
def _ones(shape=(), dtype="float32", device=None):
    return torch.ones(shape, dtype=torch_dtype(dtype), device=device)


@register("_full", num_inputs=0, aliases=("full",))
def _full(shape=(), value=0.0, dtype="float32", device=None):
    return torch.full(shape, value, dtype=torch_dtype(dtype), device=device)
