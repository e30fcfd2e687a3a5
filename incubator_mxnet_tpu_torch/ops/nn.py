"""Core neural-network operators of the decoder-LM path.

Counterpart of ``incubator_mxnet_tpu/ops/nn.py``: ``FullyConnected`` (:70),
``LayerNorm`` (:356), ``Activation`` (:394) and ``softmax`` (:432).  The
products go to ``torch.matmul``, as the JAX build left them to XLA.
"""
from __future__ import annotations

import torch

from .math import scalar_like
from .registry import register


@register("FullyConnected", num_inputs=None,
          input_names=("data", "weight", "bias"))
def _fully_connected(data, weight, bias=None, num_hidden=0, no_bias=False,
                     flatten=True):
    """y = x·Wᵀ + b (ref: fully_connected.cc:1).  The product runs in the
    promoted dtype of x and W, as ``preferred_element_type`` does at
    ops/nn.py:76."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    dt = torch.promote_types(x.dtype, weight.dtype)
    out = torch.matmul(x.to(dt), weight.to(dt).t())
    if not no_bias and bias is not None:
        out = out + bias
    return out


@register("LayerNorm", num_inputs=3, input_names=("data", "gamma", "beta"))
def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """ref: src/operator/nn/layer_norm.cc — biased variance.  Op by op in
    the data's dtype, as the JAX build (ops/nn.py:358-365): mean and var
    accumulate in f32 and round once to that dtype (``var_mean`` of a bf16
    or f16 tensor does so, as ``jnp.mean``/``jnp.var`` do), then
    ``(x - mean)·rsqrt(var + eps)`` with eps in that dtype, then
    ``·gamma + beta``, each step rounded; gamma and beta of another dtype
    promote the last two steps, as in jnp.  rsqrt rounds as XLA's does: in
    f32, once, for bf16 (ATen's CPU bf16 rsqrt rounds twice); for f16 XLA
    takes 1 / sqrt with the sqrt rounded to f16."""
    var, mean = torch.var_mean(data, dim=axis, keepdim=True, correction=0)
    var = var + scalar_like(data, eps)
    if data.dtype == torch.float16:
        inv = 1.0 / torch.sqrt(var)
    else:
        inv = torch.rsqrt(var.float()).to(data.dtype)
    out = (data - mean) * inv
    bshape = [1] * data.ndim
    bshape[axis] = data.shape[axis]
    return out * gamma.reshape(bshape) + beta.reshape(bshape)


@register("Activation", num_inputs=1)
def _activation(data, act_type="relu"):
    """ref: activation.cc.  sigmoid and softrelu follow ``jax.nn.sigmoid``
    (1 / (1 + exp(-x))) and ``jax.nn.softplus`` (max(x, 0) +
    log1p(exp(-|x|))) op by op, so bf16 and f16 round where the JAX build
    does."""
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return 1.0 / (torch.exp(-data) + 1.0)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        out = torch.clamp_min(data, 0) + torch.log1p(torch.exp(-data.abs()))
        return torch.where(torch.isnan(data), data, out)
    if act_type == "softsign":
        return torch.nn.functional.softsign(data)
    raise ValueError("unknown act_type %r" % act_type)


@register("softmax", num_inputs=1)
def _softmax(data, axis=-1, temperature=None):
    """ref: src/operator/nn/softmax.cc.  As ``jax.nn.softmax``: exp(x - max)
    in the data's dtype, its sum accumulated in f32 and rounded once to
    that dtype, then the division."""
    x = data / scalar_like(data, temperature) if temperature else data
    e = torch.exp(x - x.amax(dim=axis, keepdim=True))
    return e / e.sum(dim=axis, keepdim=True, dtype=torch.float32).to(e.dtype)
