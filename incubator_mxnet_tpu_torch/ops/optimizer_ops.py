"""Optimizer-update operators.

Counterpart of ``incubator_mxnet_tpu/ops/optimizer_ops.py``: ``sgd_update``
(:27), ``sgd_mom_update`` (:72), ``nag_mom_update`` (:82),
``mp_sgd_update`` (:92), ``mp_sgd_mom_update`` (:102), ``adam_update``
(:112), ``rmsprop_update`` (:125), ``rmspropalex_update`` (:138),
``ftrl_update`` (:157), ``ftml_update`` (:177), ``signsgd_update`` (:192)
and ``signum_update`` (:202), with the registry's own formulas (``_prep_grad`` :20), never ``torch.optim``, whose momentum
buffer keeps ``m·buf + g`` and applies lr at update time (ROADMAP trap A2).
As in the reference, an update is an op: ``nd.sgd_update(w, g, lr=...,
out=w)`` writes the new weight, and the state outputs (momentum, Adam's
moments, the f32 master weight of the ``mp_`` ops) are written back in
place (``mutate_inputs``).  Updates are never recorded.  The row-sparse
``_sparse_sgd_*`` updates wait for the sparse arrays (ROADMAP item 10).  Scalars round to a
16-bit array's dtype, as the JAX build's weakly typed scalars do; the
``mp_`` ops keep an f32 master copy of a bf16 or f16 weight, compute in f32
and round the new weight once.
"""
from __future__ import annotations

import torch

from .math import scalar_like
from .registry import register

_HALF = (torch.bfloat16, torch.float16)


def _c(t, x):
    """Scalar ``x`` as the JAX build applies it to array ``t``: rounded to a
    16-bit dtype, a plain float otherwise (f32 ops round it to f32 alike).
    A divisor is ``scalar_like`` at any dtype: CUDA multiplies by the
    reciprocal of a host scalar, which is not the division."""
    return scalar_like(t, x) if t.dtype in _HALF else x


def _clip(g, bound):
    """g clipped to [-bound, bound] when ``bound`` is set and positive."""
    if bound is not None and bound > 0:
        return torch.clamp(g, -_c(g, bound), _c(g, bound))
    return g


def _prep_grad(grad, wd, weight, rescale_grad, clip_gradient):
    g = _clip(grad * _c(grad, rescale_grad), clip_gradient)
    return g + _c(weight, wd) * weight


@register("sgd_update", num_inputs=2, differentiable=False, mutate_inputs=(0,))
def _sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, lazy_update=True):
    """ref: optimizer_op.cc sgd_update: w -= lr·(clip(rescale·g) + wd·w)"""
    g = _prep_grad(grad, wd, weight, rescale_grad, clip_gradient)
    return weight - _c(g, lr) * g


@register("sgd_mom_update", num_inputs=3, differentiable=False, num_outputs=2,
          num_visible_outputs=1, mutate_inputs=(0, 2))
def _sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    """ref: optimizer_op.cc sgd_mom_update: mom = m·mom − lr·g; w += mom"""
    g = _prep_grad(grad, wd, weight, rescale_grad, clip_gradient)
    new_mom = _c(mom, momentum) * mom - _c(g, lr) * g
    return weight + new_mom, new_mom


@register("mp_sgd_update", num_inputs=3, differentiable=False, num_outputs=2,
          num_visible_outputs=1, mutate_inputs=(0, 2))
def _mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, lazy_update=True):
    """ref: optimizer_op.cc mp_sgd_update — the update on the f32 master
    copy, the new weight its rounding to the weight's dtype."""
    g32 = _prep_grad(grad.to(torch.float32), wd, weight32, rescale_grad,
                     clip_gradient)
    new_w32 = weight32 - lr * g32
    return new_w32.to(weight.dtype), new_w32


@register("mp_sgd_mom_update", num_inputs=4, differentiable=False,
          num_outputs=3, num_visible_outputs=1, mutate_inputs=(0, 2, 3))
def _mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                       lazy_update=True):
    """ref: optimizer_op.cc mp_sgd_mom_update — momentum and the master copy
    in f32."""
    g32 = _prep_grad(grad.to(torch.float32), wd, weight32, rescale_grad,
                     clip_gradient)
    new_mom = momentum * mom - lr * g32
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


@register("adam_update", num_inputs=4, differentiable=False, num_outputs=3,
          num_visible_outputs=1, mutate_inputs=(0, 2, 3))
def _adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                 lazy_update=True):
    """ref: optimizer_op.cc adam_update (bias correction folded into lr by the
    Optimizer, as python/mxnet/optimizer.py Adam.update does)."""
    g = _prep_grad(grad, wd, weight, rescale_grad, clip_gradient)
    new_mean = _c(mean, beta1) * mean + _c(g, 1 - beta1) * g
    new_var = _c(var, beta2) * var + _c(g, 1 - beta2) * (g * g)
    new_w = weight - _c(weight, lr) * new_mean / (
        torch.sqrt(new_var) + _c(new_var, epsilon))
    return new_w, new_mean, new_var


@register("nag_mom_update", num_inputs=3, differentiable=False, num_outputs=2,
          num_visible_outputs=1, mutate_inputs=(0, 2))
def _nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    """Nesterov momentum (ref: optimizer.py NAG): mom = m·mom + g;
    w -= lr·(g + m·mom)."""
    g = _prep_grad(grad, wd, weight, rescale_grad, clip_gradient)
    new_mom = _c(mom, momentum) * mom + g
    return weight - _c(g, lr) * (g + _c(g, momentum) * new_mom), new_mom


@register("rmsprop_update", num_inputs=3, differentiable=False,
          num_outputs=2, num_visible_outputs=1, mutate_inputs=(0, 2))
def _rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.95, epsilon=1e-8,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                    clip_weights=-1.0):
    """ref: optimizer_op.cc rmsprop_update: n = γ·n + (1 - γ)·g²;
    w -= lr·g / sqrt(n + ε), clipped to ``clip_weights``."""
    g = _prep_grad(grad, wd, weight, rescale_grad, clip_gradient)
    new_n = _c(n, gamma1) * n + _c(g, 1 - gamma1) * (g * g)
    new_w = weight - _c(g, lr) * g / torch.sqrt(new_n + _c(new_n, epsilon))
    return _clip(new_w, clip_weights), new_n


@register("rmspropalex_update", num_inputs=5, differentiable=False,
          num_outputs=4, num_visible_outputs=1, mutate_inputs=(0, 2, 3, 4))
def _rmspropalex_update(weight, grad, n, g, delta, lr=0.001, gamma1=0.95,
                        gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0, clip_weights=-1.0):
    """ref: optimizer_op.cc rmspropalex_update (Graves' centred variant):
    n and g are running means of g² and g; delta = γ₂·delta -
    lr·g / sqrt(n - g² + ε); w += delta."""
    gr = _prep_grad(grad, wd, weight, rescale_grad, clip_gradient)
    new_n = _c(n, gamma1) * n + _c(gr, 1 - gamma1) * (gr * gr)
    new_g = _c(g, gamma1) * g + _c(gr, 1 - gamma1) * gr
    new_delta = _c(delta, gamma2) * delta - _c(gr, lr) * gr / torch.sqrt(
        new_n - new_g * new_g + _c(new_n, epsilon))
    return _clip(weight + new_delta, clip_weights), new_n, new_g, new_delta


@register("ftrl_update", num_inputs=4, differentiable=False, num_outputs=3,
          num_visible_outputs=1, mutate_inputs=(0, 2, 3))
def _ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0):
    """ref: optimizer_op.cc ftrl_update (FTRL-proximal)."""
    g = _clip(grad * _c(grad, rescale_grad), clip_gradient)
    new_n = n + g * g
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / scalar_like(n, lr)
    new_z = z + g - sigma * weight
    shrunk = -(new_z - torch.sign(new_z) * _c(new_z, lamda1)) / (
        (_c(new_n, beta) + torch.sqrt(new_n)) / scalar_like(new_n, lr) +
        _c(new_n, wd))
    new_w = torch.where(new_z.abs() <= _c(new_z, lamda1),
                        torch.zeros_like(weight), shrunk)
    return new_w, new_z, new_n


@register("ftml_update", num_inputs=5, differentiable=False, num_outputs=4,
          num_visible_outputs=1, mutate_inputs=(0, 2, 3, 4))
def _ftml_update(weight, grad, d, v, z, lr=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0, clip_grad=-1.0):
    """ref: optimizer_op.cc ftml_update (FTML, Zheng and Kwok 2017) at
    step ``t``."""
    g = _clip(grad * _c(grad, rescale_grad) + _c(weight, wd) * weight,
              clip_grad)
    new_v = _c(v, beta2) * v + _c(g, 1 - beta2) * (g * g)
    d_t = _c(new_v, (1 - beta1 ** t) / lr) * (
        torch.sqrt(new_v / scalar_like(new_v, 1 - beta2 ** t)) +
        _c(new_v, epsilon))
    sigma = d_t - _c(d, beta1) * d
    new_z = _c(z, beta1) * z + _c(g, 1 - beta1) * g - sigma * weight
    return -new_z / d_t, d_t, new_v, new_z


@register("signsgd_update", num_inputs=2, differentiable=False,
          mutate_inputs=(0,))
def _signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0):
    """ref: optimizer_op.cc signsgd_update: w -= lr·(sign(g) + wd·w)."""
    g = _clip(grad * _c(grad, rescale_grad), clip_gradient)
    return weight - _c(weight, lr) * (torch.sign(g) + _c(weight, wd) * weight)


@register("signum_update", num_inputs=3, differentiable=False, num_outputs=2,
          num_visible_outputs=1, mutate_inputs=(0, 2))
def _signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    """ref: optimizer_op.cc signum_update: mom = m·mom - (1 - m)·(g +
    wd·w); w = (1 - lr·wd_lh)·w + lr·sign(mom)."""
    g = _clip(grad * _c(grad, rescale_grad), clip_gradient)
    new_mom = _c(mom, momentum) * mom - _c(mom, 1 - momentum) * (
        g + _c(weight, wd) * weight)
    new_w = _c(weight, 1 - lr * wd_lh) * weight + \
        _c(weight, lr) * torch.sign(new_mom)
    return new_w, new_mom
