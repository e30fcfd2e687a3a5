"""Elementwise arithmetic and index reductions.

Counterpart of the binary broadcast family of
``incubator_mxnet_tpu/ops/math.py`` (:22, aliases :45), its scalar ops
(:87) and ``argmax`` (:246) — the ops the NDArray operators and the
decoder LM's residual adds and greedy decode use.
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


@register("negative", num_inputs=1)
def _negative(data):
    return -data


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
