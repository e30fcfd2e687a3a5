"""Elementwise, broadcast, reduction and product operators.

Counterpart of ``incubator_mxnet_tpu/ops/math.py``: the binary broadcast
family (:22-62, with the logical ops and every alias), the scalar ops
(:87-107), the comparisons, the unary table ``_UNARY`` (:127-161) and its
zero-gradient half ``_UNARY_NODIFF`` (:163-171), ``clip`` and ``add_n``
(:189-201), the reductions (``_reg_reduce`` :220-234) and ``norm`` (:237),
the index reductions (:246-263), ``broadcast_to``/``broadcast_axis``
(:269-284), ``dot``, ``batch_dot`` and ``khatri_rao`` (:290-322),
``L2Normalization`` (:325) and ``smooth_l1`` (:338).

Dtypes follow the JAX build: a 16-bit op rounds where jnp rounds (scalars
as 0-dim tensors of the array's dtype, reductions accumulated in f32 and
rounded once), an op jnp computes in floating point takes an integer array
to float32, and integer sums, products and powers wrap as int32 does.
Where MXNet and the JAX build part, the port follows MXNet: ``gamma`` keeps
its sign, ``round`` rounds half away from zero, and the gradients of
``max``/``min``, ``clip`` and ``maximum``/``minimum`` at ties go whole to
each tied element (the JAX build splits them), as ROADMAP's
"Reference-side faults" lists.
"""
from __future__ import annotations

import math

import torch

from .registry import register


def _inexact(*ts):
    """Integer and bool tensors as float32, as jnp promotes the arguments
    of an op it computes in floating point."""
    out = tuple(t if t.is_floating_point() else t.to(torch.float32)
                for t in ts)
    return out if len(out) > 1 else out[0]


def _sum_to(g, shape):
    """``g`` summed over the axes broadcasting added to ``shape``."""
    lead = g.ndim - len(shape)
    if lead:
        g = g.sum(dim=tuple(range(lead)))
    ax = tuple(i for i, n in enumerate(shape) if n == 1 and g.shape[i] != 1)
    return g.sum(dim=ax, keepdim=True) if ax else g


def _mod(lhs, rhs):
    """``jnp.mod``: the remainder of the truncated division (``fmod``,
    exact) moved to the divisor's sign.  An integer divisor of 0 gives 0,
    as the JAX build's (it divides by 1 there), and so does -1, whose
    truncated remainder traps on ``INT_MIN`` in C."""
    dt = torch.result_type(lhs, rhs)
    lhs, rhs = lhs.to(dt), rhs.to(dt)
    if not dt.is_floating_point:
        rhs = torch.where((rhs == 0) | (rhs == -1), torch.ones_like(rhs), rhs)
    r = torch.fmod(lhs, rhs)
    fix = (r != 0) & ((r < 0) != (rhs < 0))
    return torch.where(fix, r + rhs, r)


def _int_power(base, exp, bits=6):
    """``jnp.power`` of integers: binary exponentiation over the low
    ``bits`` bits of the exponent, wrapping as int32 does, with 0 ** n = 0
    for n != 0 (``_pow_int_int``; a negative exponent's low bits count, so
    2 ** -1 is 2 ** 63, which wraps to 0, and 1 ** -1 is 1)."""
    acc = torch.where((base == 0) & (exp != 0), torch.zeros_like(base),
                      torch.ones_like(base))
    for k in range(bits):
        acc = torch.where(((exp >> k) & 1) != 0, acc * base, acc)
        base = base * base
    return acc


def _power(lhs, rhs):
    """``jnp.power``: ``torch.pow`` on floating operands, the JAX build's
    integer exponentiation (:func:`_int_power`) on integer ones."""
    dt = torch.result_type(lhs, rhs)
    if dt.is_floating_point:
        return torch.pow(lhs, rhs)
    lhs, rhs = torch.broadcast_tensors(lhs.to(dt), rhs.to(dt))
    return _int_power(lhs, rhs)


def _hypot(lhs, rhs):
    """``jnp.hypot`` op by op in the operands' floating dtype:
    hi·sqrt(1 + (lo/hi)²) with hi, lo the larger and smaller magnitude,
    0 where hi is 0, +inf where either is +inf."""
    x, y = _inexact(lhs, rhs)
    x, y = x.abs(), y.abs()
    inf = torch.isposinf(x) | torch.isposinf(y)
    hi, lo = torch.maximum(x, y), torch.minimum(x, y)
    zero = hi == 0
    r = torch.where(zero, hi, hi * torch.sqrt(
        1 + torch.square(lo / torch.where(zero, torch.ones_like(hi), hi))))
    return torch.where(inf, torch.full_like(r, math.inf), r)


class _Extremum(torch.autograd.Function):
    """``maximum``/``minimum`` of two operands with MXNet's gradient: the
    left operand takes the whole gradient where lhs >= rhs (maximum) or
    lhs <= rhs (minimum), the right one elsewhere
    (elemwise_binary_broadcast_op_extended.cc); the forward propagates NaN
    as jnp does."""

    @staticmethod
    def forward(ctx, lhs, rhs, is_max):
        ctx.save_for_backward(lhs, rhs)
        ctx.is_max = is_max
        return torch.maximum(lhs, rhs) if is_max else torch.minimum(lhs, rhs)

    @staticmethod
    def backward(ctx, g):
        lhs, rhs = ctx.saved_tensors
        left = lhs >= rhs if ctx.is_max else lhs <= rhs
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        gl = _sum_to(torch.where(left, g, zero), lhs.shape).to(lhs.dtype)
        gr = _sum_to(torch.where(left, zero, g), rhs.shape).to(rhs.dtype)
        return gl, gr, None


def _maximum(lhs, rhs):
    return _Extremum.apply(lhs, rhs, True)


def _minimum(lhs, rhs):
    return _Extremum.apply(lhs, rhs, False)


_BINARY = {
    "broadcast_add": torch.add,
    "broadcast_sub": torch.sub,
    "broadcast_mul": torch.mul,
    "broadcast_div": torch.div,
    "broadcast_mod": _mod,
    "broadcast_power": _power,
    "broadcast_maximum": _maximum,
    "broadcast_minimum": _minimum,
    "broadcast_hypot": _hypot,
}

_ALIASES = {
    "broadcast_add": ("elemwise_add", "_plus", "_add"),
    "broadcast_sub": ("elemwise_sub", "_minus", "_sub"),
    "broadcast_mul": ("elemwise_mul", "_mul"),
    "broadcast_div": ("elemwise_div", "_div"),
    "broadcast_mod": ("_mod",),
    "broadcast_power": ("_power", "_pow"),
    "broadcast_maximum": ("_maximum",),
    "broadcast_minimum": ("_minimum",),
    "broadcast_hypot": ("_hypot",),
}


def _reg_binary(name, fn):
    def fcompute(lhs, rhs, _fn=fn):
        return _fn(lhs, rhs)
    fcompute.__doc__ = "Broadcasting binary op %s (ref: src/operator/tensor/elemwise_binary_broadcast_op*.cc)" % name
    register(name, num_inputs=2, aliases=_ALIASES[name])(fcompute)


for _n, _f in _BINARY.items():
    _reg_binary(_n, _f)


def _scalar_tensor(x, s):
    """``jnp.asarray(s, x.dtype)``: a 0-dim tensor of ``x``'s dtype on its
    device (an integer array truncates ``s``)."""
    if not x.is_floating_point():
        s = int(s)
    return torch.full((), s, dtype=x.dtype, device=x.device)


def _rpower_scalar(x, s):
    """``jnp.power(s, x)``: the scalar base raised to each element."""
    if x.is_floating_point():
        return torch.pow(s, x)
    return _int_power(s.expand(x.shape), x)


_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    # MXNet's rule at a tie (x >= s for maximum, x <= s for minimum) is
    # clamp's gradient
    "_maximum_scalar": torch.clamp_min,
    "_minimum_scalar": torch.clamp_max,
}
_SCALAR_TENSOR = {
    "_mod_scalar": lambda x, s: _mod(x, s),
    "_rmod_scalar": lambda x, s: _mod(s, x),
    "_rpower_scalar": _rpower_scalar,
    "_hypot_scalar": lambda x, s: _hypot(x, s),
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


def _reg_scalar_tensor(name, fn):
    def fcompute(data, scalar=0.0, _fn=fn):
        return _fn(data, _scalar_tensor(data, scalar))
    fcompute.__doc__ = "Scalar op %s (ref: elemwise_binary_scalar_op_extended.cc)" % name
    register(name, num_inputs=1)(fcompute)


for _n, _f in _SCALAR_TENSOR.items():
    _reg_scalar_tensor(_n, _f)


@register("_power_scalar", num_inputs=1)
def _power_scalar(data, scalar=0.0):
    """``jnp.power(x, s)`` with a scalar exponent (ref:
    elemwise_binary_scalar_op_extended.cc): an integer array raised to a
    negative integer raises as ``lax.integer_pow`` does, else it multiplies
    through every bit of the exponent."""
    if data.is_floating_point():
        return torch.pow(data, scalar_like(data, scalar))
    n = int(scalar)
    if n < 0:
        raise TypeError("Integers cannot be raised to negative powers, got "
                        "integer_pow(%s, %d)" % (data.dtype, n))
    return _int_power(data, torch.full_like(data, n),
                      bits=max(1, n.bit_length()))


# MXNet's comparisons return 0/1 in the left operand's dtype, not bools
_BINARY_CMP = {
    "broadcast_equal": (torch.eq, ("_equal",)),
    "broadcast_not_equal": (torch.ne, ("_not_equal",)),
    "broadcast_greater": (torch.gt, ("_greater",)),
    "broadcast_greater_equal": (torch.ge, ("_greater_equal",)),
    "broadcast_lesser": (torch.lt, ("_lesser",)),
    "broadcast_lesser_equal": (torch.le, ("_lesser_equal",)),
    "broadcast_logical_and": (torch.logical_and, ("_logical_and",)),
    "broadcast_logical_or": (torch.logical_or, ("_logical_or",)),
    "broadcast_logical_xor": (torch.logical_xor, ("_logical_xor",)),
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


def _cbrt(x):
    """The real cube root.  torch has none: |x|^(1/3) in float64, signed,
    then rounded once to ``x``'s dtype (within an ulp of ``lax.cbrt``)."""
    x64 = x.to(torch.float64)
    return (torch.sign(x64) * x64.abs().pow(1.0 / 3.0)).to(x.dtype)


def _gamma(x):
    """Γ(x) with its sign, as MXNet's ``gamma`` (mshadow_op.h tgamma):
    ±exp(lgamma(x)) in float64, negative on (-1, 0), (-3, -2), ..., rounded
    once to ``x``'s dtype.  The JAX build's exp(gammaln(x)) drops the sign
    (a reference-side fault)."""
    x64 = x.to(torch.float64)
    odd = torch.remainder(torch.floor(x64), 2) == 1
    sign = torch.where((x64 < 0) & odd, -1.0, 1.0).to(torch.float64)
    return (sign * torch.exp(torch.lgamma(x64))).to(x.dtype)


def _round(x):
    """MXNet's ``round`` (mshadow_op.h round): half away from zero, where
    ``jnp.round`` (the JAX build) rounds half to even; ``rint`` keeps
    half to even."""
    if not x.is_floating_point():
        return x
    t = torch.trunc(x)
    return torch.where((x - t).abs() >= 0.5, t + torch.sign(x), t)


def _int_identity(fn):
    """``fn`` on a floating array; an integer array is its own result, as
    jnp's ceil, floor and trunc give it back."""
    return lambda x: fn(x) if x.is_floating_point() else x


_UNARY = {
    "abs": torch.abs,
    "square": lambda x: x * x,
    "sqrt": lambda x: torch.sqrt(_inexact(x)),
    "rsqrt": lambda x: torch.rsqrt(_inexact(x)),
    "cbrt": lambda x: _cbrt(_inexact(x)),
    "rcbrt": lambda x: 1.0 / _cbrt(_inexact(x)),
    "exp": lambda x: torch.exp(_inexact(x)),
    "log": lambda x: torch.log(_inexact(x)),
    # as jnp: log(x)·f(1/ln 10) and log(x) / log(f(2)), f the dtype
    "log10": lambda x: torch.log(_inexact(x)) * scalar_like(
        _inexact(x), 0.4342944819032518),
    "log2": lambda x: torch.log(_inexact(x)) / torch.log(scalar_like(
        _inexact(x), 2.0)),
    "log1p": lambda x: torch.log1p(_inexact(x)),
    "expm1": lambda x: torch.expm1(_inexact(x)),
    "sin": lambda x: torch.sin(_inexact(x)),
    "cos": lambda x: torch.cos(_inexact(x)),
    "tan": lambda x: torch.tan(_inexact(x)),
    "arcsin": lambda x: torch.asin(_inexact(x)),
    "arccos": lambda x: torch.acos(_inexact(x)),
    "arctan": lambda x: torch.atan(_inexact(x)),
    "degrees": lambda x: _inexact(x) * scalar_like(_inexact(x),
                                                    180.0 / math.pi),
    "radians": lambda x: _inexact(x) * scalar_like(_inexact(x),
                                                    math.pi / 180.0),
    "sinh": lambda x: torch.sinh(_inexact(x)),
    "cosh": lambda x: torch.cosh(_inexact(x)),
    "tanh": lambda x: torch.tanh(_inexact(x)),
    "arcsinh": lambda x: torch.asinh(_inexact(x)),
    "arccosh": lambda x: torch.acosh(_inexact(x)),
    "arctanh": lambda x: torch.atanh(_inexact(x)),
    "reciprocal": lambda x: 1.0 / _inexact(x),
    "negative": torch.neg,
    # MXNet's relu_grad (x > 0): 0 at 0, where the JAX build passes 0.5
    "relu": torch.relu,
    # jax.nn.sigmoid and jax.nn.soft_sign op by op, as Activation does
    "sigmoid": lambda x: 1.0 / (torch.exp(-_inexact(x)) + 1.0),
    "softsign": lambda x: _inexact(x) / (_inexact(x).abs() + 1),
    "erf": lambda x: torch.erf(_inexact(x)),
    "gamma": lambda x: _gamma(_inexact(x)),
    "gammaln": lambda x: torch.lgamma(_inexact(x)),
}
_UNARY_NODIFF = {
    "sign": torch.sign,
    "rint": lambda x: torch.round(_inexact(x)),
    "round": _round,
    "ceil": _int_identity(torch.ceil),
    "floor": _int_identity(torch.floor),
    "trunc": _int_identity(torch.trunc),
    "fix": _int_identity(torch.trunc),
    "logical_not": lambda x: (x == 0).to(x.dtype),
}
_UNARY_ALIASES = {"negative": ("_np_negative",), "abs": ("_np_abs",)}


def _reg_unary(name, fn, differentiable):
    def fcompute(data, _fn=fn):
        return _fn(data)
    fcompute.__doc__ = "Unary op %s (ref: src/operator/tensor/elemwise_unary_op_basic.cc, mshadow_op.h)" % name
    register(name, num_inputs=1, differentiable=differentiable,
             aliases=_UNARY_ALIASES.get(name, ()))(fcompute)


for _n, _f in _UNARY.items():
    _reg_unary(_n, _f, True)
for _n, _f in _UNARY_NODIFF.items():
    _reg_unary(_n, _f, False)


def weak_scalar(data, value):
    """A Python float as jnp meets it in ``data op value``: rounded to a
    floating array's dtype, float32 beside an integer array (which the op
    then promotes)."""
    dt = data.dtype if data.is_floating_point() else torch.float32
    return torch.full((), float(value), dtype=dt, device=data.device)


@register("clip", num_inputs=1)
def _clip(data, a_min=0.0, a_max=1.0):
    """ref: src/operator/tensor/matrix_op.cc Clip.  An integer array gives
    float32, as ``jnp.clip`` with float bounds; the gradient passes on the
    closed range [a_min, a_max] (MXNet's clip_grad; the JAX build halves
    it at the bounds)."""
    return torch.clamp(_inexact(data), weak_scalar(data, a_min),
                       weak_scalar(data, a_max))


@register("add_n", num_inputs=None,
          aliases=("ElementWiseSum", "elemwise_sum", "_sum"))
def _add_n(*args):
    """Sum of N arrays, left to right (ref: src/operator/tensor/elemwise_sum.cc)."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


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
_HALF = (torch.bfloat16, torch.float16)


def _int_accumulator(data):
    """The accumulator dtype of an integer sum or product, as jnp's: int32
    for signed and bool, int64 (cast to uint32 after) for unsigned, int64
    for int64; ``None`` for a floating array."""
    if data.is_floating_point():
        return None
    if data.dtype in _UNSIGNED or data.dtype == torch.int64:
        return torch.int64
    return torch.int32


def _sum(data, ax, keepdims):
    """A sum over ``ax`` as ``jnp.sum``: a 16-bit array accumulates in f32
    and rounds once to its dtype; a signed integer or bool array sums to
    int32 and an unsigned one to uint32 (the JAX build's default integer
    widths, wrapping as they do); int64 stays int64."""
    if data.dtype in _HALF:
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


def _over_last(data, ax, keepdims, fn):
    """``fn(t, dim=-1)`` over the axes ``ax`` moved to the end and merged
    (for torch reductions that take one dim)."""
    rest = [i for i in range(data.ndim) if i not in ax]
    t = data.permute(*rest, *ax).reshape(
        [data.shape[i] for i in rest] + [-1])
    out = fn(t)
    if keepdims:
        out = out.reshape([1 if i in ax else n
                           for i, n in enumerate(data.shape)])
    return out


class _ProdLast(torch.autograd.Function):
    """The product over the last axis, in ``acc`` (None: the input's dtype).
    The gradient of each factor is the product of all the others, from
    exclusive cumulative products on both sides: exact at zeros, and free
    of the host sync of ``torch.prod``'s own backward on CUDA (which counts
    the zeros)."""

    @staticmethod
    def forward(ctx, t, acc):
        ctx.save_for_backward(t)
        ctx.acc = acc
        return t.prod(dim=-1, dtype=acc)

    @staticmethod
    def backward(ctx, g):
        (t,) = ctx.saved_tensors
        x = t if ctx.acc is None else t.to(ctx.acc)
        one = torch.ones_like(x[..., :1])
        left = torch.cumprod(torch.cat([one, x[..., :-1]], -1), -1)
        right = torch.flip(torch.cumprod(torch.cat(
            [one, torch.flip(x[..., 1:], (-1,))], -1), -1), (-1,))
        return (g.unsqueeze(-1).to(x.dtype) * left * right).to(t.dtype), None


def _prod(data, ax, keepdims):
    """``jnp.prod``: a 16-bit array multiplies in f32 and rounds once; an
    integer array multiplies in its accumulator (int32 wrapping; unsigned
    as uint32, through int64)."""
    acc = _int_accumulator(data)
    if data.dtype in _HALF:
        acc = torch.float32
    out = _over_last(data, ax, keepdims,
                     lambda t: _ProdLast.apply(t, acc)
                     if t.is_floating_point() else t.prod(dim=-1, dtype=acc))
    if data.dtype in _HALF:
        return out.to(data.dtype)
    if data.dtype in _UNSIGNED:
        return out.to(torch.uint32)
    return out


def _nansum(data, ax, keepdims):
    """``jnp.nansum``: NaNs count as 0."""
    if data.is_floating_point():
        data = torch.where(torch.isnan(data), torch.zeros_like(data), data)
    return _sum(data, ax, keepdims)


def _nanprod(data, ax, keepdims):
    """``jnp.nanprod``: NaNs count as 1."""
    if data.is_floating_point():
        data = torch.where(torch.isnan(data), torch.ones_like(data), data)
    return _prod(data, ax, keepdims)


class _ReduceExtremum(torch.autograd.Function):
    """``max``/``min`` over axes with MXNet's gradient: every element equal
    to its output takes the whole head gradient (broadcast_reduce_op_value.cc
    ``ReduceAxesBackwardUseInOut<eq>``); ``torch.amax`` and the JAX build
    split it among ties."""

    @staticmethod
    def forward(ctx, data, ax, keepdims, is_max):
        out = (torch.amax if is_max else torch.amin)(data, dim=ax,
                                                     keepdim=keepdims)
        ctx.save_for_backward(data, out)
        ctx.ax, ctx.keepdims = ax, keepdims
        return out

    @staticmethod
    def backward(ctx, g):
        data, out = ctx.saved_tensors
        if not ctx.keepdims:
            for a in sorted(ctx.ax):
                out, g = out.unsqueeze(a), g.unsqueeze(a)
        tied = data == out
        return (torch.where(tied, g, torch.zeros((), dtype=g.dtype,
                                                 device=g.device)),
                None, None, None)


_REDUCE = {
    "sum": (_sum, ("sum_axis",)),
    "mean": (_mean, ()),
    "prod": (_prod, ()),
    "nansum": (_nansum, ()),
    "nanprod": (_nanprod, ()),
    "max": (lambda d, ax, k: _ReduceExtremum.apply(d, ax, k, True),
            ("max_axis",)),
    "min": (lambda d, ax, k: _ReduceExtremum.apply(d, ax, k, False),
            ("min_axis",)),
}


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


@register("argmin", num_inputs=1, differentiable=False)
def _argmin(data, axis=None, keepdims=False):
    """ref: broadcast_reduce_op_index.cc.  Returns float32 like MXNet; the
    first index of a tie."""
    if axis is None:
        out = torch.argmin(data.reshape(-1))
        if keepdims:
            out = out.reshape((1,) * data.ndim)
    else:
        out = torch.argmin(data, dim=axis, keepdim=keepdims)
    return out.to(torch.float32)


@register("argmax_channel", num_inputs=1, differentiable=False)
def _argmax_channel(data):
    """argmax over axis 1, float32 (ref: broadcast_reduce_op_index.cc)."""
    return torch.argmax(data, dim=1).to(torch.float32)


@register("norm", num_inputs=1)
def _norm(data, ord=2, axis=None, keepdims=False):
    """L2 (or L1) norm, as the JAX build computes it: sqrt(sum(x²)) or
    sum(|x|) (ref: broadcast_reduce_op_value.cc L2Norm)."""
    ax = _norm_axis(axis, data.ndim)
    if ord == 1:
        return _sum(data.abs(), ax, keepdims)
    return torch.sqrt(_inexact(_sum(data * data, ax, keepdims)))


@register("broadcast_to", num_inputs=1)
def _broadcast_to(data, shape=()):
    """ref: broadcast_reduce_op_value.cc BroadcastTo (0 keeps a dim)."""
    return data.expand(tuple(s if s != 0 else d
                             for s, d in zip(shape, data.shape)))


@register("broadcast_axis", num_inputs=1, aliases=("broadcast_axes",))
def _broadcast_axis(data, axis=(), size=()):
    """ref: broadcast_reduce_op_value.cc broadcast_axis."""
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(data.shape)
    for a, n in zip(axes, sizes):
        tgt[a] = n
    return data.expand(tuple(tgt))


def _int_matmul(a, b, dtype):
    """The integer product ``jnp.matmul`` gives (int32 wrapping), which
    torch's CUDA matmul lacks: rows of ``a`` times ``b`` as a broadcast
    product summed in int64 (exact modulo 2^64, so modulo 2^32), a chunk
    of rows at a time, cast to ``dtype``."""
    a, b = a.to(torch.int64), b.to(torch.int64)
    m, k = a.shape[-2], a.shape[-1]
    batch = max(1, a[..., :1, :1].numel())
    rows = max(1, (1 << 24) // max(1, batch * k * b.shape[-1]))
    parts = [(a[..., i:i + rows, :, None] * b[..., None, :, :]).sum(-2)
             for i in range(0, m, rows)]
    return torch.cat(parts, dim=-2).to(dtype)


def _matmul(a, b):
    """``a @ b`` in the operands' promoted dtype, as FullyConnected's
    product (ops/nn.py; TF32 follows torch's setting)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    if not dt.is_floating_point:
        return _int_matmul(a, b, dt)
    return torch.matmul(a.to(dt), b.to(dt))


def _reverse_axes(t):
    return t.permute(*range(t.ndim - 1, -1, -1))


@register("dot", num_inputs=2)
def _dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """ref: dot-inl.h.  2-D x 2-D is a matrix product; N-d operands follow
    MXNet: lhs as (-1, its last axis) against rhs as (its first axis, -1),
    the result (lhs.shape[:-1] + rhs.shape[1:]); ``transpose_a``/``_b``
    reverse every axis of an operand first, as ``.T``."""
    a = _reverse_axes(lhs) if transpose_a else lhs
    b = _reverse_axes(rhs) if transpose_b else rhs
    if a.ndim == 1 and b.ndim == 1:
        return _matmul(a[None], b[:, None]).reshape(())
    out = _matmul(a.reshape(-1, a.shape[-1]), b.reshape(b.shape[0], -1))
    return out.reshape(tuple(a.shape[:-1]) + tuple(b.shape[1:]))


@register("batch_dot", num_inputs=2)
def _batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Batched matrix product (ref: dot-inl.h BatchDot)."""
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return _matmul(a, b)


@register("khatri_rao", num_inputs=None)
def _khatri_rao(*mats):
    """Column-wise Khatri-Rao product (ref: src/operator/contrib/krprod.h)."""
    out = mats[0]
    for m in mats[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[1])
    return out


@register("L2Normalization", num_inputs=1)
def _l2norm(data, eps=1e-10, mode="instance"):
    """data / sqrt(sum(data²) + eps) over the instance, channel or spatial
    axes (ref: src/operator/l2_normalization.cc)."""
    if mode == "instance":
        ax = tuple(range(1, data.ndim))
    elif mode == "channel":
        ax = (1,)
    else:
        ax = tuple(range(2, data.ndim))
    total = _sum(data * data, ax, True)
    return data / torch.sqrt(total + weak_scalar(total, eps))


@register("smooth_l1", num_inputs=1)
def _smooth_l1(data, scalar=1.0):
    """0.5·(σx)² where |x| < 1/σ², else |x| - 0.5/σ² (ref:
    src/operator/tensor/elemwise_binary_scalar_op_extended.cc)."""
    s2 = scalar * scalar
    absd = data.abs()
    return torch.where(absd < weak_scalar(data, 1.0 / s2),
                       weak_scalar(data, 0.5 * s2) * (data * data),
                       absd - weak_scalar(data, 0.5 / s2))
