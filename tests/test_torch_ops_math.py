"""The rest of ``ops/math.py`` in the port against the JAX build, on the CPU.

Every case feeds the same seeded numpy inputs to the JAX build's operator
(``fcompute`` and ``jax.vjp``) and to the port's registered operator
(through ``invoke`` under ``autograd.record()``), forward and, where the op
is differentiable, backward with the same head gradient.  Each case states
its bound in ulps of the output's dtype (``elem``: at each element's
|want|; ``max``: at max |want|, for outputs that cancel near zero):

* 0 for data movement, comparisons, integer ops and single IEEE operations;
* a few f32 ulps where XLA's and ATen's transcendentals or reductions are
  different implementations (or sum in another order);
* one 16-bit ulp where the f32 results round to either side.

Inputs stay off the points where MXNet and the JAX build differ (ties of
max/min, clip, maximum/minimum; relu at 0); those points have tests of
their own, pinning MXNet's rule, as do ``gamma`` (signed) and ``round``
(half away from zero).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.ops.registry import get_op as jax_op
from incubator_mxnet_tpu_torch.ops.registry import get_op as port_op

MANTISSA = {"float32": 23, "bfloat16": 7, "float16": 10}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "float16": jnp.float16, "int32": jnp.int32}


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def ulp(x, dtype):
    """The spacing of ``dtype`` at |x| (no finer than its smallest normal)."""
    x = np.abs(np.asarray(x, np.float64))
    lo = {"float32": -126, "bfloat16": -126, "float16": -14}[dtype]
    e = np.maximum(np.floor(np.log2(np.maximum(x, 2.0 ** lo))), lo)
    return 2.0 ** (e - MANTISSA[dtype])


def ulps(got, want, dtype, measure="elem"):
    """max |got - want| in ulps of ``dtype`` (NaN and inf must match)."""
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    ok = np.isfinite(want)
    assert np.array_equal(got[~ok & ~np.isnan(want)],
                          want[~ok & ~np.isnan(want)])
    err = np.abs(got[ok] - want[ok])
    if not err.size:
        return 0.0
    scale = ulp(want[ok], dtype) if measure == "elem" else \
        ulp(np.abs(want[ok]).max(), dtype)
    return float((err / scale).max())


def gen(kind, shape, seed, dtype="float32"):
    """Seeded inputs by domain, kept off exact zeros and ties."""
    rs = np.random.RandomState(seed)
    if dtype == "int32":
        lo, hi = {"pos": (1, 9), "small": (0, 5), "exp": (0, 4)}.get(
            kind, (-9, 10))
        return rs.randint(lo, hi, shape).astype(np.int32)
    u = rs.uniform(0.0, 1.0, shape)
    x = {"any": rs.standard_normal(shape) * 2,
         "pos": 0.5 + 2.5 * u,
         "unit": -0.9 + 1.8 * u,
         "gt1": 1.1 + 2.0 * u,
         "exp": 0.25 + 1.75 * u,
         "nonint": rs.standard_normal(shape) * 3,
         "small": rs.randint(0, 3, shape).astype(np.float64),
         "near1": 0.7 + 0.6 * u,
         # distinct multiples of 1/16, exact in bf16 and f16: no ties
         "distinct": (rs.permutation(int(np.prod(shape))).reshape(shape)
                      - np.prod(shape) / 2) / 16.0}[kind]
    if kind not in ("small", "distinct"):
        x = np.where(np.abs(x) < 1e-2, 0.37, x)
    if kind == "nonint":   # Γ's poles and its sign flips stay away
        x = np.where(np.abs(x - np.round(x)) < 0.05, x + 0.25, x)
    return x.astype(np.float32)


def to_jax(a, dtype):
    return jnp.asarray(a, dtype=JDT[dtype])


def to_port(a, dtype):
    return tmx.nd.array(a, dtype=dtype)


def jax_run(name, arrays, params, dtype, head_seed, grad_inputs):
    """The JAX build's output and the vjp of ``grad_inputs``, as one jitted
    program (the JAX build's eager ops run jitted too; one compile a case
    keeps these tests fast)."""
    op = jax_op(name)
    xs = [to_jax(a, dtype if a.dtype == np.float32 else "int32")
          for a in arrays]

    def fn(*diff):
        full = list(xs)
        for i, d in zip(grad_inputs, diff):
            full[i] = d
        out = op.fcompute(*full, **params)
        return out[0] if isinstance(out, tuple) else out
    diff = [xs[i] for i in grad_inputs]
    if not grad_inputs:
        return jax.jit(fn)(), None, None
    shape = jax.eval_shape(fn, *diff)
    head = gen("any", shape.shape, head_seed).astype(np.float32)

    def fwd_bwd(diff, h):
        out, vjp = jax.vjp(fn, *diff)
        return out, vjp(h)
    out, grads = jax.jit(fwd_bwd)(diff, jnp.asarray(head, shape.dtype))
    return out, grads, head


def port_run(name, arrays, params, dtype, head, grad_inputs):
    xs = [to_port(a, dtype if a.dtype == np.float32 else "int32")
          for a in arrays]
    for i in grad_inputs:
        xs[i].attach_grad()
    with tmx.autograd.record():
        out = tmx.nd.invoke(port_op(name), xs, dict(params))
    out = out[0] if isinstance(out, list) else out
    if not grad_inputs:
        return out, None
    out.backward(tmx.nd.NDArray(torch.from_numpy(np.array(head)).to(
        out._data.dtype)))
    return out, [xs[i].grad for i in grad_inputs]


def check_case(name, arrays, params, dtype, fwd, bwd, grad_inputs,
               head_seed=99):
    """Run one case on both sides and hold it to its bounds ((n, measure)
    each; ``bwd`` None: no gradient)."""
    want, jgrads, head = jax_run(name, arrays, params, dtype, head_seed,
                                 grad_inputs if bwd else ())
    got, pgrads = port_run(name, arrays, params, dtype, head,
                           grad_inputs if bwd else ())
    assert tmx.base.dtype_name(got._data.dtype) == str(want.dtype), \
        (got._data.dtype, want.dtype)
    gn, wn = got.asnumpy(), np.asarray(want.astype(jnp.float32)) \
        if want.dtype == jnp.bfloat16 else np.asarray(want)
    if gn.dtype.kind in "iub":
        np.testing.assert_array_equal(gn, wn.astype(gn.dtype))
    else:
        out_dtype = tmx.base.dtype_name(got._data.dtype)
        err = ulps(gn, wn, out_dtype, fwd[1])
        assert err <= fwd[0], "forward %.2f ulp > %s" % (err, fwd[0])
    if bwd:
        for pg, jg in zip(pgrads, jgrads):
            err = ulps(pg.asnumpy(), np.asarray(jg.astype(jnp.float32)),
                       tmx.base.dtype_name(pg._data.dtype), bwd[1])
            assert err <= bwd[0], "gradient %.2f ulp > %s" % (err, bwd[0])


E0 = (0, "elem")
HALF = ("bfloat16", "float16")


def el(n):
    return (n, "elem")


def mx_(n):
    return (n, "max")


# unary ops: (name, input domain, f32 (fwd, bwd), 16-bit (fwd, bwd), takes
# int32).  Bounds in ulps: 0 where the op is exact or one IEEE step in
# both; else XLA's and ATen's implementations (and gradient formulas)
# differ.  ``max`` where the values cancel (tanh's 1 - y², sigmoid's
# y(1 - y) at large |x|, lgamma and Γ' near their zeros, sin and cos).
# sigmoid's gradient: the JAX build differentiates lax.logistic as
# y·(1 - y), the port 1 / (1 + e^-x) op by op.  gammaln and gamma in f32:
# XLA's lgamma is 1.3e-6 from scipy's on these inputs, the port's 1.8e-8
# (test_gamma_and_gammaln_match_scipy holds the port to scipy).
UNARY = [
    ("abs", "any", (E0, E0), (E0, E0), True),
    ("_np_abs", "any", (E0, E0), (E0, E0), True),
    ("negative", "any", (E0, E0), (E0, E0), True),
    ("_np_negative", "any", (E0, E0), (E0, E0), True),
    ("square", "any", (E0, E0), (E0, E0), True),
    ("sqrt", "pos", (el(1), el(1)), (E0, el(1)), True),
    ("rsqrt", "pos", (el(1), el(3)), (el(1), el(3)), False),
    ("cbrt", "any", (el(1), el(2)), (el(1), el(2)), True),
    ("rcbrt", "any", (el(1), el(4)), (el(2), el(5)), True),
    ("exp", "any", (el(1), el(1)), (E0, E0), True),
    ("log", "pos", (el(1), el(1)), (E0, E0), True),
    ("log10", "pos", (el(2), el(1)), (el(1), el(1)), True),
    ("log2", "pos", (el(2), el(1)), (el(1), el(1)), True),
    ("log1p", "pos", (el(1), el(1)), (el(1), el(1)), True),
    ("expm1", "any", (el(2), el(3)), (el(1), el(4)), True),
    ("sin", "any", (mx_(1), mx_(1)), (mx_(1), mx_(1)), True),
    ("cos", "any", (mx_(1), mx_(1)), (mx_(1), mx_(1)), True),
    ("tan", "unit", (el(1), el(2)), (el(1), el(1)), True),
    ("arcsin", "unit", (el(1), el(2)), (el(1), el(2)), False),
    ("arccos", "unit", (el(1), el(2)), (el(1), el(2)), False),
    ("arctan", "any", (el(1), el(1)), (el(1), el(1)), True),
    ("degrees", "any", (E0, E0), (E0, E0), True),
    ("radians", "any", (E0, E0), (E0, E0), True),
    ("sinh", "any", (el(8), el(2)), (el(1), el(1)), True),
    ("cosh", "any", (el(8), el(2)), (el(1), el(1)), True),
    ("tanh", "any", (el(2), mx_(3)), (el(1), mx_(1)), True),
    ("arcsinh", "any", (el(1), el(1)), (el(1), el(2)), True),
    ("arccosh", "gt1", (el(2), el(2)), (el(1), el(2)), True),
    ("arctanh", "unit", (el(1), el(2)), (el(1), el(3)), False),
    ("reciprocal", "any", (E0, el(2)), (E0, el(2)), True),
    ("relu", "any", (E0, E0), (E0, E0), True),
    ("sigmoid", "any", (el(1), mx_(2)), (el(1), mx_(5)), False),
    ("softsign", "any", (E0, el(4)), (E0, el(4)), True),
    ("erf", "any", (el(3), el(2)), (el(1), el(2)), True),
    ("gammaln", "pos", (mx_(24), mx_(6)), (mx_(1), mx_(1)), True),
    ("gamma", "pos", (el(24), mx_(24)), (el(1), mx_(1)), True),
]


UNARY_CASES = [(c, dt) for c in UNARY
               for dt in ("float32", "bfloat16", "float16", "int32")
               if dt != "int32" or c[4]]


@pytest.mark.parametrize("case,dtype", UNARY_CASES,
                         ids=["%s-%s" % (c[0], dt) for c, dt in UNARY_CASES])
def test_unary_matches_jax(case, dtype):
    """Forward and gradient of each unary op; an int32 input runs the
    forward where the JAX build takes it (float32 out for the ops jnp
    computes in floating point, at the f32 bound)."""
    name, kind, f32b, halfb, _ = case
    x = gen(kind, (5, 7), 1, dtype)
    fwd, bwd = halfb if dtype in HALF else f32b
    check_case(name, [x], {}, dtype, fwd, None if dtype == "int32" else bwd,
               (0,))


def test_gamma_and_gammaln_match_scipy():
    """MXNet's gamma keeps Γ's sign (negative on (-1, 0), (-3, -2), ...);
    the JAX build's exp(gammaln(x)) loses it (a reference-side fault), so
    the port is held to scipy, in f32 to 2 ulps."""
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.7, -3.3, -0.01],
                 np.float32)
    got = tmx.nd.gamma(tmx.nd.array(x)).asnumpy()
    want = scipy.special.gamma(x.astype(np.float64))
    assert np.array_equal(np.sign(got), np.sign(want))
    assert ulps(got, want.astype(np.float32), "float32") <= 2
    jax_got = np.asarray(jax_op("gamma").fcompute(jnp.asarray(x)))
    assert (jax_got > 0).all()          # the reference-side fault
    y = gen("nonint", (6, 9), 3)
    got = tmx.nd.gammaln(tmx.nd.array(y)).asnumpy()
    want = scipy.special.gammaln(y.astype(np.float64))
    assert ulps(got, want.astype(np.float32), "float32", "max") <= 2
    g = tmx.nd.array(np.array([0.6, 1.7, -0.4], np.float32))
    g.attach_grad()
    with tmx.autograd.record():
        out = tmx.nd.gamma(g)
    out.backward()
    x64 = np.array([0.6, 1.7, -0.4])
    want = scipy.special.gamma(x64) * scipy.special.digamma(x64)
    np.testing.assert_allclose(g.grad.asnumpy(), want, rtol=2e-6)


def test_round_is_half_away_from_zero_and_rint_half_to_even():
    """MXNet's round: half away from zero; jnp.round (the JAX build) rounds
    half to even (a reference-side fault).  rint stays half to even."""
    x = np.array([2.5, -2.5, 0.5, -0.5, 1.5, 0.49999997, -3.5, 7.2, -7.7],
                 np.float32)
    for dtype in ("float32", "bfloat16", "float16"):
        xd = tmx.nd.array(x, dtype=dtype)
        want = np.sign(x) * np.floor(np.abs(xd.asnumpy()) + 0.5)
        want[5] = 0.0 if dtype == "float32" else want[5]
        np.testing.assert_array_equal(tmx.nd.round(xd).asnumpy(), want)
        np.testing.assert_array_equal(tmx.nd.rint(xd).asnumpy(),
                                      np.rint(xd.asnumpy()))
    jax_got = np.asarray(jax_op("round").fcompute(jnp.asarray(x[:5])))
    np.testing.assert_array_equal(jax_got, [2, -2, 0, -0, 2])
    i = np.array([3, -4], np.int32)
    assert tmx.nd.round(tmx.nd.array(i, dtype="int32")).asnumpy().tolist() \
        == [3, -4]


def no_ties(arrays, dtype):
    """Nudge the second array off equality with the first in ``dtype``
    (after rounding), so maximum/minimum/hypot never see a tie; returns
    how many places were nudged."""
    a, b = arrays[0], arrays[1]
    ra = to_port(a, dtype).asnumpy()
    nudged = 0
    for _ in range(4):
        rb = to_port(np.broadcast_to(b, np.broadcast_shapes(
            a.shape, b.shape)), dtype).asnumpy()
        tie = np.abs(np.broadcast_to(ra, rb.shape)) == np.abs(rb)
        if not tie.any() or b.shape != rb.shape:
            break
        nudged += int(tie.sum())
        b = np.where(tie, b + 0.375, b).astype(b.dtype)
    arrays[1] = b
    return nudged


# float16 rounds as bfloat16 does (one f32 result, one rounding): the
# unary table covers it; the rest run f32, bf16 and int32
ALL = ("float32", "bfloat16", "int32")
FLOATS = ("float32", "bfloat16")
# (id, op, params, [(domain, shape)], dtypes, f32 (fwd, bwd),
#  16-bit (fwd, bwd), inputs with a gradient)
CASES = [
    ("mod", "broadcast_mod", {}, [("any", (5, 7)), ("pos", (5, 7))], ALL,
     (E0, E0), (E0, E0), (0, 1)),
    ("mod_neg_divisor", "_mod", {}, [("any", (5, 7)), ("any", (5, 7))],
     FLOATS, (E0, E0), (E0, E0), (0, 1)),
    ("power", "broadcast_power", {}, [("pos", (5, 7)), ("any", (5, 7))],
     FLOATS, (el(2), el(2)), (el(1), el(1)), (0, 1)),
    ("power_int", "_power", {}, [("any", (5, 7)), ("exp", (5, 7))],
     ("int32",), (E0, E0), (E0, E0), ()),
    ("pow_alias", "_pow", {}, [("pos", (5, 7)), ("any", (5, 7))],
     ("float32",), (el(2), el(2)), (E0, E0), (0, 1)),
    ("maximum", "broadcast_maximum", {}, [("any", (5, 7)), ("any", (5, 7))],
     ALL, (E0, E0), (E0, E0), (0, 1)),
    ("minimum", "_minimum", {}, [("any", (5, 7)), ("any", (5, 7))], ALL,
     (E0, E0), (E0, E0), (0, 1)),
    # a broadcast operand's gradient is a sum, in another order
    ("maximum_broadcast", "broadcast_maximum", {}, [("any", (4, 1, 6)),
                                                    ("any", (1, 5, 6))],
     ("float32",), (E0, mx_(1)), (E0, E0), (0, 1)),
    ("minimum_broadcast", "_minimum", {}, [("any", (4, 5, 6)),
                                           ("any", (5, 6))],
     ("float32",), (E0, mx_(1)), (E0, E0), (0, 1)),
    ("maximum_alias", "_maximum", {}, [("any", (5, 7)), ("any", (5, 7))],
     ("float32",), (E0, E0), (E0, E0), (0, 1)),
    ("minimum_b", "broadcast_minimum", {}, [("any", (5, 7)),
                                            ("any", (5, 7))],
     ("float32",), (E0, E0), (E0, E0), (0, 1)),
    ("hypot", "broadcast_hypot", {}, [("any", (5, 7)), ("any", (5, 7))],
     ALL, (el(1), el(3)), (E0, el(1)), (0, 1)),
    ("hypot_alias", "_hypot", {}, [("any", (5, 7)), ("any", (1, 7))],
     ("float32",), (el(1), mx_(2)), (E0, E0), (0, 1)),
    ("logical_and", "broadcast_logical_and", {}, [("small", (5, 7)),
                                                  ("small", (5, 7))],
     ALL, (E0, E0), (E0, E0), ()),
    ("logical_or", "_logical_or", {}, [("small", (5, 7)), ("small", (7,))],
     ALL, (E0, E0), (E0, E0), ()),
    ("logical_xor", "broadcast_logical_xor", {}, [("small", (5, 7)),
                                                  ("small", (5, 7))],
     ALL, (E0, E0), (E0, E0), ()),
    ("logical_and_alias", "_logical_and", {}, [("small", (5, 7)),
                                               ("small", (5, 7))],
     ("float32",), (E0, E0), (E0, E0), ()),
    ("logical_xor_alias", "_logical_xor", {}, [("small", (5, 7)),
                                               ("small", (5, 7))],
     ("float32",), (E0, E0), (E0, E0), ()),
    ("mod_scalar", "_mod_scalar", {"scalar": 1.7}, [("any", (5, 7))], ALL,
     (E0, E0), (E0, E0), (0,)),
    ("mod_scalar_neg", "_mod_scalar", {"scalar": -3.0}, [("any", (5, 7))],
     ALL, (E0, E0), (E0, E0), (0,)),
    ("rmod_scalar", "_rmod_scalar", {"scalar": 2.5}, [("pos", (5, 7))],
     FLOATS, (E0, E0), (E0, E0), (0,)),
    ("rmod_scalar_int", "_rmod_scalar", {"scalar": 7}, [("pos", (5, 7))],
     ("int32",), (E0, E0), (E0, E0), ()),
    ("power_scalar", "_power_scalar", {"scalar": 2.5}, [("pos", (5, 7))],
     FLOATS, (el(1), el(3)), (E0, el(1)), (0,)),
    ("power_scalar_int", "_power_scalar", {"scalar": 3},
     [("any", (5, 7))], ("int32",), (E0, E0), (E0, E0), ()),
    ("rpower_scalar", "_rpower_scalar", {"scalar": 1.5}, [("any", (5, 7))],
     FLOATS, (el(1), el(2)), (el(1), el(1)), (0,)),
    ("rpower_scalar_int", "_rpower_scalar", {"scalar": 3},
     [("exp", (5, 7))], ("int32",), (E0, E0), (E0, E0), ()),
    ("maximum_scalar", "_maximum_scalar", {"scalar": 0.3},
     [("any", (5, 7))], ALL, (E0, E0), (E0, E0), (0,)),
    ("minimum_scalar", "_minimum_scalar", {"scalar": -0.3},
     [("any", (5, 7))], ALL, (E0, E0), (E0, E0), (0,)),
    ("hypot_scalar", "_hypot_scalar", {"scalar": 1.3}, [("any", (5, 7))],
     ALL, (el(1), el(2)), (E0, el(2)), (0,)),
    ("clip", "clip", {"a_min": -0.7, "a_max": 1.1}, [("any", (5, 7))],
     ALL, (E0, E0), (E0, E0), (0,)),
    ("add_n", "add_n", {}, [("any", (5, 7))] * 3, ALL, (E0, E0), (E0, E0),
     (0, 1, 2)),
    ("ElementWiseSum", "ElementWiseSum", {}, [("any", (5, 7))] * 2,
     ("float32",), (E0, E0), (E0, E0), (0, 1)),
    ("elemwise_sum", "elemwise_sum", {}, [("any", (5, 7))] * 4,
     ("float32",), (E0, E0), (E0, E0), (0, 1, 2, 3)),
    ("_sum", "_sum", {}, [("any", (5, 7))] * 2, ("float32",), (E0, E0),
     (E0, E0), (0, 1)),
]


def _case_arrays(case, dtype, seed=11):
    cid, name, params, specs = case[:4]
    arrays = [gen(kind, shape, seed + i, dtype)
              for i, (kind, shape) in enumerate(specs)]
    if name.split("_")[-1] in ("maximum", "minimum", "hypot") or \
            cid.startswith(("maximum", "minimum", "hypot")):
        if len(arrays) > 1:
            no_ties(arrays, dtype)
    if cid.startswith("clip"):
        lo, hi = params["a_min"], params["a_max"]
        r = to_port(arrays[0], dtype).asnumpy()
        assert not np.isin(r, [lo, hi]).any()
    return arrays


BINARY_CASES = [(c, dt) for c in CASES for dt in c[4]]


@pytest.mark.parametrize("case,dtype", BINARY_CASES,
                         ids=["%s-%s" % (c[0], dt) for c, dt in BINARY_CASES])
def test_binary_scalar_and_nary_match_jax(case, dtype):
    cid, name, params, specs, _, f32b, halfb, grads = case
    arrays = _case_arrays(case, dtype)
    fwd, bwd = halfb if dtype in HALF else f32b
    check_case(name, arrays, params, dtype, fwd,
               None if dtype == "int32" or not grads else bwd, grads)


R3 = (4, 5, 6)
# (id, op, params, [(domain, shape)], dtypes, f32 (fwd, bwd),
#  16-bit (fwd, bwd), inputs with a gradient): reductions, products and
# the rest; sums and products in another order than XLA's
REDUCE_CASES = [
    ("prod_all", "prod", {}, [("near1", (3, 4))], ALL, (mx_(4), mx_(4)),
     (el(1), mx_(1)), (0,)),
    ("prod_axis", "prod", {"axis": (0, 2), "keepdims": True},
     [("near1", R3)], ALL, (el(2), mx_(2)), (el(1), mx_(1)), (0,)),
    ("prod_exclude", "prod", {"axis": 1, "exclude": True},
     [("near1", R3)], ("float32", "int32"), (el(4), mx_(4)), (E0, E0),
     (0,)),
    ("nansum", "nansum", {"axis": 1}, [("any", R3)], ALL, (mx_(1), E0),
     (mx_(1), E0), (0,)),
    ("nanprod", "nanprod", {"axis": -1}, [("near1", R3)], ALL,
     (el(2), mx_(2)), (el(1), mx_(1)), (0,)),
    ("max_all", "max", {}, [("distinct", R3)], ALL, (E0, E0), (E0, E0),
     (0,)),
    ("max_axis", "max_axis", {"axis": 1, "keepdims": True},
     [("distinct", R3)], ALL, (E0, E0), (E0, E0), (0,)),
    ("min_axes", "min", {"axis": (0, 2)}, [("distinct", R3)], ALL,
     (E0, E0), (E0, E0), (0,)),
    ("min_axis_exclude", "min_axis", {"axis": 0, "exclude": True},
     [("distinct", R3)], ("float32",), (E0, E0), (E0, E0), (0,)),
    ("sum_axis", "sum_axis", {"axis": 2}, [("any", R3)], ("float32",),
     (mx_(1), E0), (E0, E0), (0,)),
    ("norm", "norm", {}, [("any", R3)], ALL, (el(2), el(2)),
     (el(1), el(1)), (0,)),
    ("norm_axis", "norm", {"axis": 1, "keepdims": True}, [("any", R3)],
     FLOATS, (el(2), el(2)), (el(1), el(2)), (0,)),
    ("norm_l1", "norm", {"ord": 1, "axis": (0, 2)}, [("any", R3)], ALL,
     (mx_(1), E0), (mx_(1), E0), (0,)),
    ("argmin", "argmin", {"axis": 1}, [("any", R3)], ALL, (E0, E0),
     (E0, E0), ()),
    ("argmin_all", "argmin", {"keepdims": True}, [("any", R3)],
     ("float32",), (E0, E0), (E0, E0), ()),
    ("argmax_channel", "argmax_channel", {}, [("any", R3)], ALL, (E0, E0),
     (E0, E0), ()),
    ("broadcast_to", "broadcast_to", {"shape": (4, 0, 6, 0)},
     [("any", (4, 1, 6, 1))], ALL, (E0, mx_(1)), (E0, None), (0,)),
    ("broadcast_to_new", "broadcast_to", {"shape": (3, 5)},
     [("any", (1, 5))], ("float32",), (E0, E0), (E0, E0), (0,)),
    ("broadcast_axis", "broadcast_axis", {"axis": (0, 2), "size": (3, 4)},
     [("any", (1, 5, 1))], ALL, (E0, mx_(1)), (E0, None), (0,)),
    ("broadcast_axes", "broadcast_axes", {"axis": 1, "size": 3},
     [("any", (2, 1))], ("float32",), (E0, E0), (E0, E0), (0,)),
    ("dot", "dot", {}, [("any", (6, 8)), ("any", (8, 5))], ALL,
     (mx_(2), mx_(2)), (mx_(1), mx_(1)), (0, 1)),
    ("dot_t", "dot", {"transpose_a": True, "transpose_b": True},
     [("any", (8, 6)), ("any", (5, 8))], ("float32", "int32"),
     (mx_(2), mx_(2)), (E0, E0), (0, 1)),
    ("dot_nd", "dot", {}, [("any", (2, 3, 4)), ("any", (4, 3, 2))],
     ("float32", "bfloat16", "int32"), (mx_(2), mx_(2)), (mx_(1), mx_(1)),
     (0, 1)),
    ("dot_nd_t", "dot", {"transpose_a": True},
     [("any", (4, 3, 2)), ("any", (4, 5))], ("float32",),
     (mx_(2), mx_(2)), (E0, E0), (0, 1)),
    ("dot_vec", "dot", {}, [("any", (9,)), ("any", (9,))],
     ("float32", "int32"), (mx_(2), mx_(2)), (E0, E0), (0, 1)),
    ("batch_dot", "batch_dot", {}, [("any", (3, 4, 5)), ("any", (3, 5, 2))],
     ALL, (mx_(2), mx_(2)), (mx_(1), mx_(1)), (0, 1)),
    ("batch_dot_t", "batch_dot", {"transpose_a": True, "transpose_b": True},
     [("any", (3, 5, 4)), ("any", (3, 2, 5))], ("float32", "int32"),
     (mx_(2), mx_(2)), (E0, E0), (0, 1)),
    ("khatri_rao", "khatri_rao", {}, [("any", (3, 4)), ("any", (2, 4)),
                                      ("any", (5, 4))], ALL,
     (el(1), mx_(1)), (el(1), mx_(2)), (0, 1, 2)),
    ("l2norm_instance", "L2Normalization", {}, [("any", R3)], FLOATS,
     (el(2), mx_(2)), (el(1), mx_(2)), (0,)),
    ("l2norm_channel", "L2Normalization", {"mode": "channel"},
     [("any", R3)], FLOATS, (el(2), mx_(3)), (el(2), mx_(2)), (0,)),
    ("l2norm_spatial", "L2Normalization", {"mode": "spatial", "eps": 1e-3},
     [("any", (2, 3, 4, 5))], ("float32",), (el(2), mx_(2)), (E0, E0),
     (0,)),
    ("smooth_l1", "smooth_l1", {}, [("any", (5, 7))], ALL, (E0, E0),
     (E0, E0), (0,)),
    ("smooth_l1_sigma", "smooth_l1", {"scalar": 2.0}, [("any", (5, 7))],
     FLOATS, (E0, E0), (E0, E0), (0,)),
]
REDUCE_PARAMS = [(c, dt) for c in REDUCE_CASES for dt in c[4]]


@pytest.mark.parametrize("case,dtype", REDUCE_PARAMS,
                         ids=["%s-%s" % (c[0], dt) for c, dt in REDUCE_PARAMS])
def test_reductions_products_and_rest_match_jax(case, dtype):
    """A broadcast's 16-bit gradient is a sum the JAX build rounds at every
    add (the port sums in f32): forward only there (bound None)."""
    cid, name, params, specs, _, f32b, halfb, grads = case
    arrays = _case_arrays(case, dtype)
    if cid in ("nansum", "nanprod") and dtype != "int32":
        arrays[0][1, 2, 3] = np.nan
        arrays[0][3, 0, 1] = np.nan
    fwd, bwd = halfb if dtype in HALF else f32b
    check_case(name, arrays, params, dtype, fwd,
               None if dtype == "int32" or not grads else bwd, grads)


def _grad_of(name, x, params=None, others=()):
    """The port's gradient of ``name`` at ``x`` (head ones), with the
    JAX build's beside it."""
    xt = tmx.nd.array(x)
    xt.attach_grad()
    with tmx.autograd.record():
        out = tmx.nd.invoke(port_op(name), [xt] + [tmx.nd.array(o)
                                                   for o in others],
                            dict(params or {}))
    out.backward(tmx.nd.ones_like(out))
    op = jax_op(name)
    _, vjp = jax.vjp(lambda v: op.fcompute(v, *[jnp.asarray(o)
                                               for o in others],
                                           **(params or {})),
                     jnp.asarray(x))
    want = vjp(jnp.ones(out.shape, jnp.float32))[0]
    return xt.grad.asnumpy(), np.asarray(want)


def test_tie_gradients_follow_mxnet():
    """At ties the JAX build splits the gradient (0.5 each); MXNet gives
    it whole to every tied element of max/min (data == out), passes it on
    clip's closed range [a_min, a_max], and gives maximum's to the left
    operand where lhs >= rhs (minimum's where lhs <= rhs).  The port
    follows MXNet; these are reference-side faults."""
    x = np.array([1.0, 3.0, 3.0], np.float32)
    got, jax_want = _grad_of("max", x)
    np.testing.assert_array_equal(got, [0, 1, 1])
    np.testing.assert_array_equal(jax_want, [0, 0.5, 0.5])
    got, _ = _grad_of("min", np.array([[2.0, -1.0, -1.0], [0.0, 5.0, 0.0]],
                                      np.float32), {"axis": 1})
    np.testing.assert_array_equal(got, [[0, 1, 1], [1, 0, 1]])
    got, jax_want = _grad_of("clip", np.array([0.0, 0.5, 1.0, 1.5, -0.2],
                                              np.float32),
                             {"a_min": 0.0, "a_max": 1.0})
    np.testing.assert_array_equal(got, [1, 1, 1, 0, 0])
    np.testing.assert_array_equal(jax_want[:3], [0.5, 1, 0.5])
    lhs = np.array([2.0, 1.0, 3.0], np.float32)
    rhs = np.array([2.0, 4.0, 1.0], np.float32)
    for name, left in (("broadcast_maximum", [1, 0, 1]),
                       ("broadcast_minimum", [1, 1, 0])):
        a, b = tmx.nd.array(lhs), tmx.nd.array(rhs)
        a.attach_grad()
        b.attach_grad()
        with tmx.autograd.record():
            out = getattr(tmx.nd, name)(a, b)
        out.backward(tmx.nd.ones_like(out))
        np.testing.assert_array_equal(a.grad.asnumpy(), left)
        np.testing.assert_array_equal(b.grad.asnumpy(), 1 - np.array(left))
    _, jax_want = _grad_of("broadcast_maximum", lhs, others=(rhs,))
    assert jax_want[0] == 0.5
    for name, s, want in (("_maximum_scalar", 1.0, [1, 1, 0]),
                          ("_minimum_scalar", 1.0, [0, 1, 1])):
        got, _ = _grad_of(name, np.array([2.0, 1.0, 0.0], np.float32),
                          {"scalar": s})
        np.testing.assert_array_equal(got, want)


def test_integer_edge_values_match_jax():
    """int32 mod by 0 and by -1 (INT_MIN too) gives 0, and a negative
    exponent takes the JAX build's 6-bit binary exponentiation (2 ** -1 =
    0, 1 ** -1 = 1, (-1) ** -1 = -1), without a trap or a raise; the
    scalar power with a negative exponent raises as the JAX build's."""
    lhs = np.array([5, -5, 7, 0, -2 ** 31, 3, -7, 2 ** 31 - 1], np.int32)
    rhs = np.array([0, 0, -1, 0, -1, 0, 2, -3], np.int32)
    for name in ("broadcast_mod", "broadcast_power"):
        r = rhs if name == "broadcast_mod" else np.array(
            [-1, -1, -1, -1, -2, 70, 31, -64], np.int32)
        got = getattr(tmx.nd, name)(tmx.nd.array(lhs, dtype="int32"),
                                    tmx.nd.array(r, dtype="int32"))
        want = jax_op(name).fcompute(jnp.asarray(lhs), jnp.asarray(r))
        assert got.asnumpy().dtype == np.int32
        np.testing.assert_array_equal(got.asnumpy(), np.asarray(want))
    p = tmx.nd.broadcast_power(tmx.nd.array(np.array([1, -1, 2, 0, -2],
                                                     np.int32),
                                            dtype="int32"),
                               tmx.nd.array(np.full(5, -1, np.int32),
                                            dtype="int32"))
    assert p.asnumpy().tolist() == [1, -1, 0, 0, 0]
    big = tmx.nd.array(np.array([3, -3], np.int32), dtype="int32")
    want = jax_op("_power_scalar").fcompute(jnp.asarray([3, -3], jnp.int32),
                                            scalar=70)
    np.testing.assert_array_equal(tmx.nd._power_scalar(big, scalar=70)
                                  .asnumpy(), np.asarray(want))
    with pytest.raises(TypeError):
        tmx.nd._power_scalar(big, scalar=-1)
    with pytest.raises(TypeError):
        jax_op("_power_scalar").fcompute(jnp.asarray([3], jnp.int32),
                                         scalar=-1)
    m = tmx.nd._mod_scalar(big, scalar=0)
    assert m.asnumpy().tolist() == [0, 0]


# names the JAX build registers in ops/math.py, ops/tensor.py and
# ops/init_ops.py that wait for a later item (ROADMAP names each): none
# since item 10 registered the sparse storage twins
LATER = {}


def test_every_array_op_of_the_jax_build_is_registered():
    """The set difference against the JAX registry: every name of the JAX
    build's math, tensor, init and rnn ops (RNN, CTCLoss and its aliases)
    is in the port but those of LATER, and each alias resolves to the same
    Operator as in the JAX build."""
    from incubator_mxnet_tpu.ops import registry as jreg
    from incubator_mxnet_tpu_torch.ops import registry as treg
    mods = ("incubator_mxnet_tpu.ops.math", "incubator_mxnet_tpu.ops.tensor",
            "incubator_mxnet_tpu.ops.init_ops", "incubator_mxnet_tpu.ops.rnn")
    names = {n for n, o in jreg._REGISTRY.items()
             if o.fcompute.__module__ in mods}
    assert names - set(treg._REGISTRY) == set(LATER)
    for n in names - set(LATER):
        j, t = jreg._REGISTRY[n], treg._REGISTRY[n]
        assert t.name == j.name, n
        assert t.differentiable == j.differentiable or n in (
            "argmax", "_zeros", "_ones", "_full", "zeros", "ones", "full"), n


SWEEP_FAMILIES = ("unary", "binary", "scalar", "reduction", "product",
                  "index", "shape", "ordering", "sequence")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("family", SWEEP_FAMILIES)
def test_card_sweep_family_matches_cpu(card, family):
    """chip_smoke's phase 7a for one family: each case on CUDA tensors
    against the port's CPU result, at the smoke's shapes and bounds, under
    sync-debug mode "error"."""
    import chip_smoke as cs
    rs = np.random.default_rng(cs.SEED)
    ran = 0
    for case in cs.sweep_cases():
        if case[0] == family:
            for dtype in case[4]:
                worst, bound = cs.sweep_case(tmx, case, dtype, rs)
                assert worst <= max(bound, 0)
                ran += 1
    assert ran


@pytest.mark.cuda
def test_card_integer_edges_and_creation_match_cpu(card):
    import chip_smoke as cs
    cs.integer_edges(tmx, tmx.gpu(0), tmx.cpu(), np, torch)
    cs.creation_sweep(tmx, tmx.gpu(0), tmx.cpu(), np)


def test_prod_gradient_at_zeros_matches_jax():
    """prod's gradient is the product of the other factors, exact where a
    factor is 0 (the port's exclusive cumulative products; no host sync
    on the card)."""
    x = np.array([[2.0, 0.0, 3.0, -1.5], [0.0, 4.0, 0.0, 1.0],
                  [1.5, 2.0, 0.5, -3.0]], np.float32)
    got, want = _grad_of("prod", x, {"axis": 1})
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], [0, -9, 0, 0])
