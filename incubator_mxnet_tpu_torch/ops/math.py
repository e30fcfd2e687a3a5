"""Elementwise arithmetic and index reductions.

Counterpart of the binary broadcast family of
``incubator_mxnet_tpu/ops/math.py`` (:22, aliases :45), its scalar ops
(:87), ``square``, the reductions ``sum`` and ``mean`` with ``axis``,
``keepdims`` and ``exclude`` (``_reg_reduce`` :220),
``argmax`` (:246), and the comparisons (``_BINARY_CMP`` :33-38,
``_SCALAR_CMP`` :100-107) — the ops the NDArray operators, the decoder LM's
residual adds and greedy decode, and the Gluon losses use.
"""
from __future__ import annotations

import torch

from .registry import register

_BINARY = {
    "broadcast_add": torch.add,
    "broadcast_sub": torch.sub,
    "broadcast_mul": torch.mul,
    "broadcast_div": torch.div,
}

_ALIASES = {
    "broadcast_add": ("elemwise_add", "_plus", "_add"),
    "broadcast_sub": ("elemwise_sub", "_minus", "_sub"),
    "broadcast_mul": ("elemwise_mul", "_mul"),
    "broadcast_div": ("elemwise_div", "_div"),
}


def _reg_binary(name, fn):
    def fcompute(lhs, rhs, _fn=fn):
        return _fn(lhs, rhs)
    fcompute.__doc__ = "Broadcasting binary op %s (ref: src/operator/tensor/elemwise_binary_broadcast_op*.cc)" % name
    register(name, num_inputs=2, aliases=_ALIASES[name])(fcompute)


for _n, _f in _BINARY.items():
    _reg_binary(_n, _f)


_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
}


def scalar_like(data, scalar):
    """``scalar`` in ``data``'s dtype, as ``jnp.asarray(scalar, data.dtype)``
    in the JAX build (ops/math.py:113).  On a floating array it is a 0-dim
    tensor on the array's device, so a bf16 or f16 op sees the scalar
    rounded to that dtype (a Python float would enter the op at f32) and a
    division stays a division (CUDA multiplies by the reciprocal of a host
    scalar); an integer array takes ``int(scalar)``."""
    if not data.is_floating_point():
        return int(scalar)
    return torch.full((), float(scalar), dtype=data.dtype, device=data.device)


def _reg_scalar(name, fn):
    def fcompute(data, scalar=0.0, _fn=fn):
        return _fn(data, scalar_like(data, scalar))
    fcompute.__doc__ = "Scalar op %s (ref: elemwise_binary_scalar_op_basic.cc)" % name
    register(name, num_inputs=1)(fcompute)


for _n, _f in _SCALAR.items():
    _reg_scalar(_n, _f)


# MXNet's comparisons return 0/1 in the left operand's dtype, not bools
_BINARY_CMP = {
    "broadcast_equal": (torch.eq, ("_equal",)),
    "broadcast_not_equal": (torch.ne, ("_not_equal",)),
    "broadcast_greater": (torch.gt, ("_greater",)),
    "broadcast_greater_equal": (torch.ge, ("_greater_equal",)),
    "broadcast_lesser": (torch.lt, ("_lesser",)),
    "broadcast_lesser_equal": (torch.le, ("_lesser_equal",)),
}
_SCALAR_CMP = {
    "_equal_scalar": torch.eq,
    "_not_equal_scalar": torch.ne,
    "_greater_scalar": torch.gt,
    "_greater_equal_scalar": torch.ge,
    "_lesser_scalar": torch.lt,
    "_lesser_equal_scalar": torch.le,
}


def _reg_compare(name, fn, aliases):
    def fcompute(lhs, rhs, _fn=fn):
        # both operands promote as in jnp (f16 with bf16 meets in f32)
        return _fn(lhs, rhs).to(lhs.dtype)
    fcompute.__doc__ = "Broadcasting comparison %s (ref: elemwise_binary_broadcast_op_logic.cc)" % name
    register(name, num_inputs=2, aliases=aliases,
             differentiable=False)(fcompute)


def _reg_scalar_compare(name, fn):
    def fcompute(data, scalar=0.0, _fn=fn):
        """The JAX build compares with ``float(scalar)``, a weak float: a
        floating array meets it rounded to its own dtype, an integer or bool
        array meets it in float32, as jnp promotes ``int32`` with a Python
        float."""
        if data.is_floating_point():
            return _fn(data, scalar_like(data, scalar)).to(data.dtype)
        s = torch.full((), float(scalar), dtype=torch.float32,
                       device=data.device)
        return _fn(data.to(torch.float32), s).to(data.dtype)
    fcompute.__doc__ = "Scalar comparison %s (ref: elemwise_binary_scalar_op_logic.cc)" % name
    register(name, num_inputs=1, differentiable=False)(fcompute)


for _n, (_f, _a) in _BINARY_CMP.items():
    _reg_compare(_n, _f, _a)
for _n, _f in _SCALAR_CMP.items():
    _reg_scalar_compare(_n, _f)


@register("negative", num_inputs=1)
def _negative(data):
    return -data


@register("square", num_inputs=1)
def _square(data):
    return data * data


def _norm_axis(axis, ndim, exclude=False):
    """The reduced axes (ref: ops/math.py:208 ``_norm_axis``)."""
    if axis is None:
        ax = tuple(range(ndim))
    elif isinstance(axis, int):
        ax = (axis % ndim,)
    else:
        ax = tuple(a % ndim for a in axis)
    if exclude:
        ax = tuple(i for i in range(ndim) if i not in ax)
    return ax


_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32)


def _sum(data, ax, keepdims):
    """A sum over ``ax`` as ``jnp.sum``: a 16-bit array accumulates in f32
    and rounds once to its dtype; a signed integer or bool array sums to
    int32 and an unsigned one to uint32 (the JAX build's default integer
    widths, wrapping as they do); int64 stays int64."""
    if data.dtype in (torch.bfloat16, torch.float16):
        return data.sum(dim=ax, keepdim=keepdims,
                        dtype=torch.float32).to(data.dtype)
    if data.dtype in _UNSIGNED:
        # torch has no uint32 accumulator: int64 holds the sum, and the
        # cast wraps it modulo 2^32 as a uint32 accumulator would
        return data.sum(dim=ax, keepdim=keepdims,
                        dtype=torch.int64).to(torch.uint32)
    if not data.is_floating_point() and data.dtype != torch.int64:
        return data.sum(dim=ax, keepdim=keepdims, dtype=torch.int32)
    return data.sum(dim=ax, keepdim=keepdims)


def _mean(data, ax, keepdims):
    """``jnp.mean``: the f32 sum (for a 16-bit array too) over the count,
    rounded once to the array's dtype."""
    n = 1
    for a in ax:
        n *= data.shape[a]
    s = data.sum(dim=ax, keepdim=keepdims, dtype=torch.float32)
    return (s / n).to(data.dtype if data.is_floating_point()
                      else torch.float32)


_REDUCE = {"sum": (_sum, ("sum_axis",)), "mean": (_mean, ())}


def _reg_reduce(name, fn, aliases):
    def fcompute(data, axis=None, keepdims=False, exclude=False, _fn=fn):
        ax = _norm_axis(axis, data.ndim, exclude)
        if not ax:                  # nothing to reduce, as jnp over ()
            return data
        return _fn(data, ax, keepdims)
    fcompute.__doc__ = "Reduction %s (ref: src/operator/tensor/broadcast_reduce_op_value.cc)" % name
    register(name, num_inputs=1, aliases=aliases)(fcompute)


for _n, (_f, _a) in _REDUCE.items():
    _reg_reduce(_n, _f, _a)


@register("argmax", num_inputs=1)
def _argmax(data, axis=None, keepdims=False):
    """ref: broadcast_reduce_op_index.cc. Returns float32 like MXNet."""
    if axis is None:
        out = torch.argmax(data.reshape(-1))
        if keepdims:
            out = out.reshape((1,) * data.ndim)
    else:
        out = torch.argmax(data, dim=axis, keepdim=keepdims)
    return out.to(torch.float32)
