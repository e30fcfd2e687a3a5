"""Every op the port registers, in bfloat16 and float16, against the JAX build
in the same dtype, on the CPU.

Both packages get the same seeded numpy inputs, rounded to the dtype.  The
JAX build rounds after every op (XLA computes a bf16 or f16 op in f32 and
rounds its result); the port follows the same order of operations, so most
ops agree bit for bit.  Each case states its bound in ulps of the dtype:

* ``elem``: |got - want| <= n ulp(|want|), element by element;
* ``max``:  |got - want| <= n ulp(max |want|), for ops whose outputs cancel
  to near zero, where one ulp of an input moves a small output by many of
  its own ulps.

Where the bound is not 0 the table says why: XLA's and ATen's exp, log1p
and matrix products are different implementations (or sum in another
order), so a result that lies near a rounding boundary may round one ulp
apart, and XLA's f16 code rewrites some steps (a division by a constant
into a product with its rounded reciprocal, a product and a sum into one
fused multiply-add).
"""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

DTYPES = {"bfloat16": 7, "float16": 10}   # stored mantissa bits


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def ulp(x, dtype):
    """The spacing of ``dtype`` at |x| (f16 subnormals: 2^-24)."""
    x = np.abs(np.asarray(x, np.float64))
    e = np.floor(np.log2(np.maximum(x, 2.0 ** -126)))
    if dtype == "float16":
        e = np.maximum(e, -14)
    return 2.0 ** (e - DTYPES[dtype])


def ulps(got, want, dtype, measure="elem"):
    """max |got - want| in ulps of ``dtype``, at each element's |want|
    (``elem``) or at max |want| (``max``)."""
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    err = np.abs(got - want)[ok]
    scale = ulp(want[ok], dtype) if measure == "elem" else \
        ulp(np.abs(want[ok]).max(), dtype)
    return float((err / scale).max()) if err.size else 0.0


def _x(shape, seed, scale=4.0):
    return (np.random.RandomState(seed).standard_normal(shape) *
            scale).astype(np.float32)


def _np(a):
    return np.asarray(a.asnumpy(), np.float32)


# (name, f(nd, *arrays), input shapes, {dtype: (bound in ulps, measure)}, why)
EXACT = {"bfloat16": (0, "elem"), "float16": (0, "elem")}
OPS = [
    ("broadcast_add", lambda nd, a, b: nd.broadcast_add(a, b),
     [(4, 1, 32), (1, 8, 32)], EXACT, "one IEEE op, then one rounding"),
    ("broadcast_sub", lambda nd, a, b: nd.broadcast_sub(a, b),
     [(4, 8, 32), (8, 32)], EXACT, "one IEEE op, then one rounding"),
    ("broadcast_mul", lambda nd, a, b: nd.broadcast_mul(a, b),
     [(4, 8, 32), (32,)], EXACT, "one IEEE op, then one rounding"),
    ("broadcast_div", lambda nd, a, b: nd.broadcast_div(a, b),
     [(4, 8, 32), (4, 8, 32)], EXACT, "one IEEE op, then one rounding"),
    ("negative", lambda nd, a: nd.negative(a), [(64, 32)], EXACT, "exact"),
    ("scalar_chain",
     lambda nd, a: (2.5 - a) * 3.3 + a / 0.7 - 1.1 + 4.2 / (a * a + 1),
     [(64, 32)], {"bfloat16": (0, "elem"), "float16": (1, "max")},
     "the scalars rounded to the dtype, each op rounded; f16: XLA turns "
     "a / 0.7 into a * f16(1 / f16(0.7)), one ulp from the correctly "
     "rounded quotient the port computes, and the sums cancel near zero"),
    ("FullyConnected", lambda nd, a, w, b: nd.FullyConnected(
        a, w, b, num_hidden=48), [(16, 64), (48, 64), (48,)],
     {"bfloat16": (1, "max"), "float16": (1, "max")},
     "both accumulate the products in f32 and round once, in other orders: "
     "a sum near a rounding boundary rounds one ulp apart; the bias add "
     "can cancel, so the bound is at max |want|"),
    ("LayerNorm", lambda nd, a, g, b: nd.LayerNorm(a, g, b),
     [(16, 256), (256,), (256,)],
     {"bfloat16": (0, "elem"), "float16": (1, "max")},
     "bf16: the same roundings (mean and var sum 256 values in f32 in other "
     "orders, far below half a bf16 ulp apart); f16: XLA's f16 code "
     "contracts ·gamma + beta into one fused multiply-add, one rounding "
     "where the port rounds twice, and outputs cancel near zero"),
    ("LayerNorm_axis1", lambda nd, a, g, b: nd.LayerNorm(a, g, b, axis=1,
                                                         eps=1e-3),
     [(4, 48, 6), (48,), (48,)],
     {"bfloat16": (0, "elem"), "float16": (1, "max")},
     "as LayerNorm"),
    ("Activation_relu", lambda nd, a: nd.Activation(a, act_type="relu"),
     [(64, 32)], EXACT, "exact"),
    ("Activation_tanh", lambda nd, a: nd.Activation(a, act_type="tanh"),
     [(64, 32)], {"bfloat16": (1, "elem"), "float16": (1, "elem")},
     "tanh in f32 by two implementations, rounded once"),
    ("Activation_sigmoid", lambda nd, a: nd.Activation(a, act_type="sigmoid"),
     [(64, 32)], {"bfloat16": (1, "elem"), "float16": (1, "elem")},
     "exp by two implementations, then 1 + e and 1 / (1 + e) rounded alike"),
    ("Activation_softrelu",
     lambda nd, a: nd.Activation(a, act_type="softrelu"), [(64, 32)],
     {"bfloat16": (1, "elem"), "float16": (2, "elem")},
     "exp and log1p by two implementations; f16: XLA's f16 exp and log1p "
     "are not correctly rounded, and each may be one ulp apart"),
    ("Activation_softsign",
     lambda nd, a: nd.Activation(a, act_type="softsign"), [(64, 32)],
     EXACT, "abs, add and divide, each rounded"),
    ("softmax", lambda nd, a: nd.softmax(a, axis=-1), [(32, 96)],
     {"bfloat16": (2, "elem"), "float16": (2, "elem")},
     "exp by two implementations (one ulp), and the f32 sum in another "
     "order, whose one rounding may fall one ulp apart and move the row"),
    ("softmax_axis0_temperature",
     lambda nd, a: nd.softmax(a, axis=0, temperature=1.7), [(40, 24)],
     {"bfloat16": (2, "elem"), "float16": (2, "max")},
     "as softmax; f16: XLA turns x / 1.7 into x * f16(1 / f16(1.7)), one "
     "ulp of x / 1.7 from the port's quotient, which exp scales by |x|"),
    ("Cast_f32", lambda nd, a: nd.Cast(a, dtype="float32"), [(64, 32)],
     EXACT, "exact"),
    # the rest of ops/nn.py and ops/linalg.py (inference paths: Dropout and
    # rrelu draw only in training)
    ("InstanceNorm", lambda nd, a, g, b: nd.InstanceNorm(a, g, b),
     [(4, 6, 8, 8), (6,), (6,)],
     {"bfloat16": (0, "elem"), "float16": (1, "max")},
     "as LayerNorm: f16, XLA contracts ·gamma + beta into one FMA and "
     "outputs cancel near zero"),
    ("LRN", lambda nd, a: nd.LRN(a, nsize=3), [(2, 8, 6, 6)],
     {"bfloat16": (0, "elem"), "float16": (1, "elem")},
     "f16: pow by two implementations; the window sums round alike"),
    ("LeakyReLU_leaky", lambda nd, a: nd.LeakyReLU(a, slope=0.1),
     [(64, 32)], EXACT,
     "one product, then one rounding"),
    ("LeakyReLU_elu", lambda nd, a: nd.LeakyReLU(a, act_type="elu",
                                                 slope=0.7),
     [(64, 32)], {"bfloat16": (0, "elem"), "float16": (2, "elem")},
     "f16: XLA's f16 expm1 is not correctly rounded"),
    ("LeakyReLU_prelu", lambda nd, a, g: nd.LeakyReLU(a, g,
                                                      act_type="prelu"),
     [(4, 8, 16), (8,)], EXACT,
     "one product, then one rounding"),
    ("LeakyReLU_rrelu", lambda nd, a: nd.LeakyReLU(a, act_type="rrelu"),
     [(64, 32)], EXACT,
     "the midpoint slope rounded to the dtype, one product"),
    ("SoftmaxActivation", lambda nd, a: nd.SoftmaxActivation(
        a, mode="channel"), [(4, 24, 5)], EXACT,
     "as softmax, on these inputs no ulp apart"),
    ("UpSampling_nearest", lambda nd, a: nd.UpSampling(a, scale=2),
     [(2, 3, 8, 8)], EXACT,
     "copies"),
    ("Dropout_inference", lambda nd, a: nd.Dropout(a, p=0.3), [(64, 32)],
     EXACT,
     "identity"),
    ("LogisticRegressionOutput", lambda nd, a, b:
     nd.LogisticRegressionOutput(a, b), [(64, 32), (64, 32)], EXACT,
     "sigmoid op by op, as Activation's"),
    ("LinearRegressionOutput", lambda nd, a, b:
     nd.LinearRegressionOutput(a, b), [(64, 32), (64, 32)], EXACT,
     "identity"),
    ("linalg_gemm2", lambda nd, a, b: nd.linalg.gemm2(a, b, alpha=0.5),
     [(3, 16, 32), (3, 32, 8)], EXACT,
     "f32 accumulation, one rounding, alpha a power of two"),
    ("linalg_syrk", lambda nd, a: nd.linalg.syrk(a, transpose=True),
     [(3, 16, 8)], EXACT,
     "f32 accumulation, one rounding"),
    ("contrib_fft", lambda nd, a: nd.contrib.fft(a), [(4, 32)],
     EXACT,
     "computed in f32 and rounded once"),
]


def _inputs(name, shapes):
    arrays = [_x(s, seed=i) for i, s in enumerate(shapes)]
    if name.startswith("LayerNorm"):   # gamma ~ 1 + 0.1 N, beta ~ 0.1 N
        arrays[1] = 1 + arrays[1] / 40
        arrays[2] = arrays[2] / 40
    return arrays


def _run(mx, fn, arrays, dtype):
    return fn(mx.nd, *[mx.nd.array(a, dtype=dtype) for a in arrays])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name,fn,shapes,bounds,why", OPS,
                         ids=[o[0] for o in OPS])
def test_op_matches_jax_in_half_precision(name, fn, shapes, bounds, why,
                                          dtype):
    arrays = _inputs(name, shapes)
    want = _run(jmx, fn, arrays, dtype)
    got = _run(tmx, fn, arrays, dtype)
    assert got.shape == want.shape
    assert str(want.dtype) == tmx.base.dtype_name(got._data.dtype)
    bound, measure = bounds[dtype]
    assert ulps(_np(got), _np(want), dtype, measure) <= bound, why


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_embedding_and_cast_match_jax(dtype):
    rs = np.random.RandomState(3)
    table = _x((50, 16), seed=4)
    ids = rs.randint(-3, 53, (6, 7)).astype(np.float32)  # clamped at the ends
    want = jmx.nd.Embedding(jmx.nd.array(ids), jmx.nd.array(table, dtype=dtype),
                            input_dim=50, output_dim=16)
    got = tmx.nd.Embedding(tmx.nd.array(ids), tmx.nd.array(table, dtype=dtype),
                           input_dim=50, output_dim=16)
    np.testing.assert_array_equal(_np(got), _np(want))
    x = _x((8, 9), seed=5)
    want = jmx.nd.Cast(jmx.nd.array(x), dtype=dtype)
    got = tmx.nd.Cast(tmx.nd.array(x), dtype=dtype)
    assert tmx.base.dtype_name(got._data.dtype) == dtype
    np.testing.assert_array_equal(_np(got), _np(want))
