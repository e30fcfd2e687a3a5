"""Creation operators (ref: src/operator/tensor/init_op.cc).

Counterpart of ``incubator_mxnet_tpu/ops/init_ops.py``.  A creation op
(``num_inputs=0``) takes the ``device`` of the call's context, which
``ndarray.invoke`` supplies.  ``arange`` takes its values from numpy on the
host, as ``jnp.arange`` with a step does (one copy to the device);
``linspace`` follows ``jnp.linspace``'s arithmetic on the device.  The JAX
build runs without 64-bit types, so ``shape_array`` and ``size_array``
give int32.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import torch_dtype
from .registry import register


@register("_zeros", num_inputs=0, differentiable=False, aliases=("zeros",))
def _zeros(shape=(), dtype="float32", device=None):
    return torch.zeros(shape, dtype=torch_dtype(dtype), device=device)


@register("_ones", num_inputs=0, differentiable=False, aliases=("ones",))
def _ones(shape=(), dtype="float32", device=None):
    return torch.ones(shape, dtype=torch_dtype(dtype), device=device)


@register("_full", num_inputs=0, differentiable=False, aliases=("full",))
def _full(shape=(), value=0.0, dtype="float32", device=None):
    return torch.full(shape, value, dtype=torch_dtype(dtype), device=device)


@register("_arange", num_inputs=0, differentiable=False, aliases=("arange",))
def _arange(start=0.0, stop=None, step=1.0, repeat=1, infer_range=False,
            dtype="float32", device=None):
    """``np.arange(start, stop, step)`` in ``dtype`` (bfloat16: computed in
    float32 and rounded), each value ``repeat`` times.  ``infer_range``
    (the symbolic graph's stop from a shape) has no meaning eagerly and is
    ignored, as in the JAX build."""
    dt = torch_dtype(dtype)
    host = np.float32 if dt is torch.bfloat16 else dtype
    out = torch.from_numpy(np.arange(start, stop, step, dtype=host))
    out = out.to(device=device, dtype=dt)
    if repeat != 1:
        out = torch.repeat_interleave(out, int(repeat))
    return out


@register("_eye", num_inputs=0, differentiable=False, aliases=("eye",))
def _eye(N=0, M=0, k=0, dtype="float32", device=None):
    """An N x M (M = 0: N x N) array with ones on diagonal ``k``."""
    n, m = int(N), int(M) if M else int(N)
    rows = torch.arange(n, device=device)[:, None] + int(k)
    return (rows == torch.arange(m, device=device)[None, :]).to(
        torch_dtype(dtype))


@register("_linspace", num_inputs=0, differentiable=False,
          aliases=("linspace",))
def _linspace(start=0.0, stop=1.0, num=50, endpoint=True, dtype="float32",
              device=None):
    """``jnp.linspace`` as XLA computes it: start·(1 - t) + stop·t for
    t = i·(1 / div) in the computation dtype (float32 for an integer ``dtype``, then floored),
    with ``stop`` itself as the last value when ``endpoint``."""
    dt = torch_dtype(dtype)
    comp = dt if dt.is_floating_point else torch.float32
    num = int(num)

    def scalar(v):
        return torch.full((), float(v), dtype=torch.float32,
                          device=device).to(comp)
    a, b = scalar(start), scalar(stop)
    div = num - 1 if endpoint else num
    if num > 1:
        # XLA turns the division by div into a product with 1 / div
        t = torch.arange(div, dtype=comp, device=device) * (
            1 / torch.full((), div, dtype=comp, device=device))
        out = a * (1 - t) + b * t
        if endpoint:
            out = torch.cat([out, b.reshape(1)])
    else:
        out = a.reshape(1)[:num]
    if not dt.is_floating_point:
        out = torch.floor(out)
    return out.to(dt)


@register("zeros_like", num_inputs=1, differentiable=False)
def _zeros_like(data):
    """ref: init_ops.py:42 zeros_like."""
    return torch.zeros_like(data)


@register("ones_like", num_inputs=1, differentiable=False)
def _ones_like(data):
    return torch.ones_like(data)


def _int32_vector(values, device):
    """Host integers as an int32 vector made on ``device`` (one fill per
    value, no copy from the host)."""
    if not values:
        return torch.zeros((0,), dtype=torch.int32, device=device)
    return torch.stack([torch.full((), int(v), dtype=torch.int32,
                                   device=device) for v in values])


@register("shape_array", num_inputs=1, differentiable=False)
def _shape_array(data):
    """ref: elemwise_unary_op_basic.cc shape_array (int32, as the JAX
    build without 64-bit types)."""
    return _int32_vector(data.shape, data.device)


@register("size_array", num_inputs=1, differentiable=False)
def _size_array(data):
    """ref: elemwise_unary_op_basic.cc size_array (int32, as shape_array)."""
    return _int32_vector([data.numel()], data.device)
