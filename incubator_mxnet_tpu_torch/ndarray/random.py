"""``nd.random`` namespace (counterpart of
``incubator_mxnet_tpu/ndarray/random.py``; ref: python/mxnet/ndarray/random.py).

Each function invokes one of the sampling ops of ``ops/random_ops.py``;
the draws come from the framework generator of the output's device.
"""
from __future__ import annotations

from ..ops.registry import get_op
from .ndarray import NDArray, invoke

__all__ = ["uniform", "normal", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial",
           "multinomial", "shuffle"]


def _simple(op_name, params, shape, dtype, ctx, out):
    """One draw of ``shape`` in ``dtype`` on ``ctx``: the op normalises
    the shape and takes float32 for no dtype."""
    params = dict(params, shape=shape, dtype=dtype, ctx=ctx)
    return invoke(get_op(op_name), [], params, out=out)


def uniform(low=0, high=1, shape=None, dtype=None, ctx=None, out=None,
            **kwargs):
    """U[low, high): scalars give one draw of ``shape``; NDArrays ``low``
    and ``high`` give ``shape`` draws for each of their elements."""
    if isinstance(low, NDArray):
        return invoke(get_op("_sample_uniform"), [low, high],
                      {"shape": shape}, out=out)
    return _simple("_random_uniform", {"low": float(low),
                                       "high": float(high)},
                   shape, dtype, ctx, out)


def normal(loc=0, scale=1, shape=None, dtype=None, ctx=None, out=None,
           **kwargs):
    """N(loc, scale), scalars or NDArrays as for :func:`uniform`."""
    if isinstance(loc, NDArray):
        return invoke(get_op("_sample_normal"), [loc, scale],
                      {"shape": shape}, out=out)
    return _simple("_random_normal", {"loc": float(loc),
                                      "scale": float(scale)},
                   shape, dtype, ctx, out)


def gamma(alpha=1, beta=1, shape=None, dtype=None, ctx=None, out=None,
          **kwargs):
    return _simple("_random_gamma", {"alpha": float(alpha),
                                     "beta": float(beta)},
                   shape, dtype, ctx, out)


def exponential(lam=1, shape=None, dtype=None, ctx=None, out=None,
                **kwargs):
    return _simple("_random_exponential", {"lam": float(lam)}, shape, dtype,
                   ctx, out)


def poisson(lam=1, shape=None, dtype=None, ctx=None, out=None, **kwargs):
    return _simple("_random_poisson", {"lam": float(lam)}, shape, dtype,
                   ctx, out)


def negative_binomial(k=1, p=1, shape=None, dtype=None, ctx=None, out=None,
                      **kwargs):
    return _simple("_random_negative_binomial", {"k": int(k), "p": float(p)},
                   shape, dtype, ctx, out)


def generalized_negative_binomial(mu=1, alpha=1, shape=None, dtype=None,
                                  ctx=None, out=None, **kwargs):
    return _simple("_random_generalized_negative_binomial",
                   {"mu": float(mu), "alpha": float(alpha)}, shape, dtype,
                   ctx, out)


def multinomial(data, shape=None, get_prob=False, out=None, dtype="int32",
                **kwargs):
    return invoke(get_op("_sample_multinomial"), [data],
                  {"shape": shape, "get_prob": get_prob,
                   "dtype": dtype}, out=out)


def shuffle(data, **kwargs):
    return invoke(get_op("_shuffle"), [data], {})
