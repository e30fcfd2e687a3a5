"""Random sampling operators (ref: src/operator/random/sample_op.cc,
multisample_op.cc).

Counterpart of ``incubator_mxnet_tpu/ops/random_ops.py`` (:22-109): the
ten ``_random_*`` / ``_sample_*`` ops with the JAX build's aliases and
``dtype`` parameter.  Each op ``needs_rng``: ``ndarray.invoke`` passes the
framework generator of the output's device (``random_state.generator``),
and every draw goes through it, never through torch's default generator,
so ``mx.random.seed`` and ``random_state.use_generator`` reach it.  The
streams are not ``jax.random``'s (ROADMAP trap A4): tests compare the two
packages by distribution.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register


def _dt(dtype):
    return torch_dtype(dtype if dtype not in (None, "None") else "float32")


def _shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def _empty(shape, dtype, device):
    return torch.empty(_shape(shape), dtype=_dt(dtype), device=device)


def standard_gamma(alpha, shape, device, generator):
    """Gamma(alpha, 1) draws in f32 (``torch._standard_gamma``, which takes
    the generator; ``torch.distributions.Gamma`` would draw from torch's
    default one)."""
    conc = torch.full(_shape(shape), float(alpha), dtype=torch.float32,
                      device=device)
    return torch._standard_gamma(conc, generator=generator)


def uniform_in(t, low, high, generator):
    """Fill ``t`` with U[low, high) draws.  A 16-bit ``t`` takes f32 draws
    rounded to nearest and kept inside [low, high) in its dtype (a draw
    that rounds up to ``high`` takes the dtype's largest value below it):
    torch's own 16-bit ``uniform_`` sends such a draw to ``low`` instead,
    which moves the mean of U[-1, 3) in bf16 by 8e-3 (29 standard errors
    at 2^24 draws, on the card)."""
    if t.dtype not in (torch.bfloat16, torch.float16):
        return t.uniform_(low, high, generator=generator)
    u = torch.empty(t.shape, dtype=torch.float32, device=t.device).uniform_(
        low, high, generator=generator)
    lo, hi = (torch.tensor(v, dtype=t.dtype) for v in (low, high))
    if float(hi) >= high:
        hi = torch.nextafter(hi, lo)
    if float(lo) < low:
        lo = torch.nextafter(lo, hi)
    return t.copy_(torch.clamp(u.to(t.dtype), float(lo), float(hi)))


@register("_random_uniform", num_inputs=0, differentiable=False,
          needs_rng=True, aliases=("uniform", "random_uniform"))
def _uniform(low=0.0, high=1.0, shape=(), dtype="float32", device=None,
             generator=None):
    """U[low, high) in ``dtype``."""
    return uniform_in(_empty(shape, dtype, device), float(low), float(high),
                       generator)


@register("_random_normal", num_inputs=0, differentiable=False,
          needs_rng=True, aliases=("normal", "random_normal"))
def _normal(loc=0.0, scale=1.0, shape=(), dtype="float32", device=None,
            generator=None):
    return _empty(shape, dtype, device).normal_(float(loc), float(scale),
                                                generator=generator)


@register("_random_gamma", num_inputs=0, differentiable=False,
          needs_rng=True, aliases=("random_gamma",))
def _gamma(alpha=1.0, beta=1.0, shape=(), dtype="float32", device=None,
           generator=None):
    """Gamma with shape ``alpha`` and scale ``beta``."""
    g = standard_gamma(alpha, shape, device, generator) * float(beta)
    return g.to(_dt(dtype))


@register("_random_exponential", num_inputs=0, differentiable=False,
          needs_rng=True, aliases=("random_exponential",))
def _exponential(lam=1.0, shape=(), dtype="float32", device=None,
                 generator=None):
    """Exponential with rate ``lam``."""
    return _empty(shape, dtype, device).exponential_(float(lam),
                                                     generator=generator)


@register("_random_poisson", num_inputs=0, differentiable=False,
          needs_rng=True, aliases=("random_poisson",))
def _random_poisson(lam=1.0, shape=(), dtype="float32", device=None,
                    generator=None):
    rate = torch.full(_shape(shape), float(lam), dtype=torch.float32,
                      device=device)
    return torch.poisson(rate, generator=generator).to(_dt(dtype))


@register("_random_negative_binomial", num_inputs=0, differentiable=False,
          needs_rng=True, aliases=("random_negative_binomial",))
def _negative_binomial(k=1, p=1.0, shape=(), dtype="float32", device=None,
                       generator=None):
    """Failures before the ``k``-th success at success rate ``p``: Poisson
    at a Gamma(k, (1 - p) / p) rate, as the JAX build draws it."""
    lam = standard_gamma(k, shape, device, generator) * ((1 - p) / p)
    return torch.poisson(lam, generator=generator).to(_dt(dtype))


@register("_random_generalized_negative_binomial", num_inputs=0,
          differentiable=False, needs_rng=True,
          aliases=("random_generalized_negative_binomial",))
def _gen_negative_binomial(mu=1.0, alpha=1.0, shape=(), dtype="float32",
                           device=None, generator=None):
    """Mean ``mu``, dispersion ``alpha``: Poisson at a Gamma(1 / alpha,
    alpha·mu) rate."""
    lam = standard_gamma(1.0 / alpha, shape, device, generator) * \
        (alpha * mu)
    return torch.poisson(lam, generator=generator).to(_dt(dtype))


@register("_sample_multinomial", num_inputs=1, differentiable=False,
          needs_rng=True, aliases=("sample_multinomial",))
def _multinomial(data, shape=(), get_prob=False, dtype="int32",
                 generator=None):
    """ref: multisample_op.cc — class ids drawn from probability rows (a
    1-d ``data`` is one row): ``prod(shape)`` draws a row, with
    replacement, shaped ``data.shape[:-1] + shape``.  ``get_prob`` also
    returns each draw's log-probability, log(max(p, 1e-30)), in f32."""
    shape = _shape(shape)
    n = 1
    for s in shape:
        n *= s if s else 1
    rows = data.reshape(-1, data.shape[-1]).to(torch.float32)
    ids = torch.multinomial(rows, n, replacement=True, generator=generator)
    out = ids.reshape(tuple(data.shape[:-1]) + shape).to(torch_dtype(dtype))
    if get_prob:
        lp = torch.log(torch.clamp_min(rows, 1e-30)).gather(1, ids)
        return out, lp.reshape(out.shape)
    return out


def _per_row(first, second, shape, dtype, draw):
    """``first + draw·second`` with one draw of ``shape`` for every element
    of the parameter arrays (shaped ``first.shape + shape``)."""
    tgt = tuple(first.shape) + _shape(shape)
    bshape = tuple(first.shape) + (1,) * (len(tgt) - first.ndim)
    z = draw(torch.empty(tgt, dtype=_dt(dtype), device=first.device))
    return first.reshape(bshape) + z * second.reshape(bshape)


@register("_sample_uniform", num_inputs=2, differentiable=False,
          needs_rng=True)
def _sample_uniform(low, high, shape=(), dtype="float32", generator=None):
    """ref: multisample_op.cc — U[low_i, high_i) draws for each i."""
    return _per_row(low, high - low, shape, dtype,
                    lambda t: uniform_in(t, 0.0, 1.0, generator))


@register("_sample_normal", num_inputs=2, differentiable=False,
          needs_rng=True)
def _sample_normal(mu, sigma, shape=(), dtype="float32", generator=None):
    """ref: multisample_op.cc — N(mu_i, sigma_i) draws for each i."""
    return _per_row(mu, sigma, shape, dtype,
                    lambda t: t.normal_(generator=generator))
