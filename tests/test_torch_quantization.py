"""INT8 quantized inference in the port (``ops/quantization.py`` and
``contrib/quantization.py``) against the JAX build on the CPU.

The same seeded numpy inputs go through both packages.  Every int8, uint8
and int32 output is held bit for bit, and so are the f32 ranges and the
dequantized values of one op (the port keeps XLA's f32 order of
operations: a constant divisor as a multiply by its f32 reciprocal, the
residual add's fused multiply-add).  Graphs calibrated in each package
from its own f32 layer outputs differ where a calibrated range differs by
an ulp, so the whole-model tests hold the int8 graph bit for bit under one
calibration table and the independently calibrated outputs within half an
int8 step of the output range.  The cases of ``tests/test_quantization.py``
run here as parity tests; the ``cuda`` tests hold the int8 ops and a
calibrated ResNet on the card bit for bit against the CPU.
"""
import logging

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.contrib import quantization as jqz
from incubator_mxnet_tpu_torch.contrib import quantization as tqz

import _torch_symbol_nets as nets

SILENT = logging.getLogger("test_torch_quantization")
SILENT.setLevel(logging.WARNING)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _rs(seed):
    return np.random.RandomState(seed)


def _op(m, name, arrays, **params):
    xs = [m.nd.array(a, dtype=np.asarray(a).dtype) for a in arrays]
    out = getattr(m.nd.contrib, name)(*xs, **params)
    out = out if isinstance(out, (list, tuple)) else [out]
    return [o.asnumpy() for o in out]


def _same(name, arrays, **params):
    """The op in both packages, every output bit for bit."""
    got, want = _op(tmx, name, arrays, **params), _op(jmx, name, arrays,
                                                      **params)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (i, g.dtype,
                                                           w.dtype)
        np.testing.assert_array_equal(g, w, err_msg="output %d" % i)
    return got


def _range(x):
    return [np.float32(x.min()), np.float32(x.max())]


def _q8(rs, shape):
    return rs.randint(-127, 128, shape).astype(np.int8)


# -- quantize, dequantize, requantize -------------------------------------------

def test_quantize_int8_roundtrip_jax_case():
    x = _rs(1).randn(5, 7).astype(np.float32)
    q, qmin, qmax = _same("quantize", [x] + _range(x), out_type="int8")
    assert q.dtype == np.int8
    r = max(abs(x.min()), abs(x.max()))
    assert abs(qmin + r) < 1e-5 and abs(qmax - r) < 1e-5
    deq = _same("dequantize", [q, qmin, qmax])[0]
    assert np.abs(deq - x).max() <= r / 127.0


def test_quantize_uint8_jax_case():
    x = np.linspace(0.0, 4.0, 32, dtype=np.float32).reshape(4, 8)
    q, qmin, qmax = _same("quantize", [x] + _range(x), out_type="uint8")
    assert q.dtype == np.uint8
    deq = _same("dequantize", [q, qmin, qmax])[0]
    assert np.abs(deq - x).max() <= 4.0 / 255.0


@pytest.mark.parametrize("out_type", ["int8", "uint8"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_dequantize_bit_equal(out_type, seed):
    """Seeded data over odd ranges (a range narrower than the data clips;
    all zeros gives codes of 0)."""
    rs = _rs(seed)
    x = (rs.standard_normal((64, 33)) * rs.uniform(0.01, 50)).astype(
        np.float32)
    for lo, hi in (_range(x), [np.float32(-0.3), np.float32(0.9)],
                   [np.float32(0), np.float32(0)]):
        q = _same("quantize", [x, lo, hi], out_type=out_type)
        _same("dequantize", q)


def test_dequantize_int32_accumulator_bit_equal():
    acc = _rs(3).randint(-2 ** 31, 2 ** 31 - 1, (50, 40)).astype(np.int32)
    _same("dequantize", [acc, np.float32(-17.5), np.float32(3.25)])


def test_requantize_calibrated_jax_case():
    acc = _rs(2).randint(-(2 ** 20), 2 ** 20, size=(3, 4)).astype(np.int32)
    r = 100.0
    real = acc.astype(np.float64) * (r / np.iinfo(np.int32).max)
    out, omin, omax = _same("requantize", [acc, np.float32(-r),
                                           np.float32(r)],
                            min_calib_range=-0.001, max_calib_range=0.001)
    assert out.dtype == np.int8 and abs(omax - 0.001) < 1e-9
    deq = out.astype(np.float64) * (0.001 / 127)
    assert np.abs(deq - np.clip(real, -0.001, 0.001)).max() <= 0.001 / 127


@pytest.mark.parametrize("calib", [None, (-0.7, 1.3), (-40.0, 5.0)])
def test_requantize_bit_equal(calib):
    rs = _rs(4)
    acc = rs.randint(-2 ** 30, 2 ** 30, (70, 30)).astype(np.int32)
    params = {} if calib is None else dict(min_calib_range=calib[0],
                                           max_calib_range=calib[1])
    _same("requantize", [acc, np.float32(-55.5), np.float32(61.0)], **params)


# -- quantized conv and FC -------------------------------------------------------

def _quantized_inputs(rs, shapes):
    """int8 arrays of ``shapes`` with their f32 ranges, quantized from
    seeded normal values through the JAX build's op."""
    out = []
    for s in shapes:
        x = rs.standard_normal(s).astype(np.float32)
        out.append(_op(jmx, "quantize", [x] + _range(x), out_type="int8"))
    return out


CONV_CASES = [
    ((2, 4, 8, 8), (6, 4, 3, 3), dict(kernel=(3, 3), pad=(1, 1))),
    ((2, 3, 12, 12), (8, 3, 7, 7), dict(kernel=(7, 7), stride=(2, 2),
                                        pad=(3, 3))),          # K = 147
    ((1, 8, 9, 7), (8, 4, 3, 3), dict(kernel=(3, 3), dilate=(2, 2),
                                      pad=(2, 1), num_group=2)),
    ((1, 16, 3, 3), (24, 16, 1, 1), dict(kernel=(1, 1))),        # M = 9
    ((2, 5, 10), (7, 5, 3), dict(kernel=(3,), stride=(2,))),       # 1-d
]


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dshape,wshape,params", CONV_CASES,
                         ids=[str(c[1]) for c in CONV_CASES])
def test_quantized_conv_bit_equal(dshape, wshape, params, bias):
    """The int32 accumulator of an int8 im2col product (padded to the
    shapes ``_int_mm`` takes) equals XLA's s8 x s8 -> s32 convolution."""
    rs = _rs(len(dshape) + wshape[0])
    (qd, dmin, dmax), (qw, wmin, wmax), (qb, bmin, bmax) = \
        _quantized_inputs(rs, [dshape, wshape, (wshape[0],)])
    conv = dict(params, num_filter=wshape[0], no_bias=not bias)
    arrays = [qd, qw, qb, dmin, dmax, wmin, wmax, bmin, bmax] if bias else \
        [qd, qw, dmin, dmax, wmin, wmax]
    out = _same("quantized_conv", arrays, **conv)
    assert out[0].dtype == np.int32


def test_quantized_conv_matches_float_jax_case():
    rng = _rs(4)
    d = rng.randn(2, 4, 8, 8).astype(np.float32)
    w = rng.randn(6, 4, 3, 3).astype(np.float32)
    (qd, dmin, dmax) = _op(tmx, "quantize", [d] + _range(d), out_type="int8")
    (qw, wmin, wmax) = _op(tmx, "quantize", [w] + _range(w), out_type="int8")
    out = _same("quantized_conv", [qd, qw, dmin, dmax, wmin, wmax],
                kernel=(3, 3), num_filter=6, pad=(1, 1), no_bias=True)
    got = _same("dequantize", out)[0]
    ref = tmx.nd.Convolution(tmx.nd.array(d), tmx.nd.array(w), kernel=(3, 3),
                             num_filter=6, pad=(1, 1),
                             no_bias=True).asnumpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 0.03


@pytest.mark.parametrize("flatten", [True, False])
@pytest.mark.parametrize("bias", [False, True])
def test_quantized_fully_connected_bit_equal(flatten, bias):
    rs = _rs(5)
    dshape = (4, 3, 10) if flatten else (3, 5, 30)
    (qd, dmin, dmax), (qw, wmin, wmax), (qb, bmin, bmax) = \
        _quantized_inputs(rs, [dshape, (9, 30), (9,)])
    arrays = [qd, qw, qb, dmin, dmax, wmin, wmax, bmin, bmax] if bias else \
        [qd, qw, dmin, dmax, wmin, wmax]
    _same("quantized_fully_connected", arrays, num_hidden=9,
          no_bias=not bias, flatten=flatten)


def test_quantized_fully_connected_matches_float_jax_case():
    rng = _rs(3)
    d, w, b = (rng.randn(*s).astype(np.float32) for s in ((4, 32), (8, 32),
                                                          (8,)))
    qs = [_op(tmx, "quantize", [x] + _range(x), out_type="int8")
          for x in (d, w, b)]
    out = _same("quantized_fully_connected",
                [qs[0][0], qs[1][0], qs[2][0], qs[0][1], qs[0][2], qs[1][1],
                 qs[1][2], qs[2][1], qs[2][2]], num_hidden=8, no_bias=False)
    assert out[0].dtype == np.int32
    got = _same("dequantize", out)[0]
    ref = d @ w.T + b
    assert np.abs(got - ref).max() / np.abs(ref).max() < 0.03


def test_bias_rescale_saturates_as_xla():
    """A bias whose rescaled value passes the int32 range saturates (XLA's
    conversion), where torch's own conversion is undefined."""
    rs = _rs(6)
    qd, qw = _q8(rs, (2, 8)), _q8(rs, (16, 8))
    qb = np.full(16, 127, np.int8)
    _same("quantized_fully_connected",
          [qd, qw, qb, np.float32(-1e-6), np.float32(1e-6),
           np.float32(-1e-6), np.float32(1e-6), np.float32(-1e3),
           np.float32(1e3)], num_hidden=16, no_bias=False)


# -- pooling, flatten, act, residual add -------------------------------------------

@pytest.mark.parametrize("params", [
    dict(kernel=(2, 2), stride=(2, 2), pool_type="max"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max"),
    dict(kernel=(3, 3), stride=(2, 2), pool_type="avg"),
    dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1), pool_type="avg",
         count_include_pad=False),
    dict(kernel=(2, 2), stride=(2, 2), pool_type="avg",
         pooling_convention="full"),
    dict(kernel=(7, 7), global_pool=True, pool_type="avg"),
])
def test_quantized_pooling_bit_equal(params):
    x = _q8(_rs(5), (2, 3, 7, 9))
    _same("quantized_pooling", [x, np.float32(-1.0), np.float32(1.0)],
          **params)


def test_quantized_pooling_jax_case():
    x = _rs(5).randint(-127, 128, size=(1, 2, 4, 4)).astype(np.int8)
    out, omin, omax = _same("quantized_pooling", [x, np.float32(-1.0),
                                                  np.float32(1.0)],
                            kernel=(2, 2), stride=(2, 2), pool_type="max")
    assert (out == x.reshape(1, 2, 2, 2, 2, 2).max(axis=(3, 5))).all()
    assert omin == -1.0 and omax == 1.0


def test_quantized_flatten_and_act_bit_equal():
    x = _q8(_rs(7), (3, 4, 5, 2))
    _same("quantized_flatten", [x, np.float32(-2.5), np.float32(0.5)])
    _same("quantized_act", [x, np.float32(-2.5), np.float32(0.5)],
          act_type="relu")


@pytest.mark.parametrize("ra,rb", [(1.3, 0.7), (3.1e-3, 17.0), (0.5, 0.5),
                                   (1e-9, 3.0), (5.0, 0.0)])
def test_quantized_elemwise_add_bit_equal(ra, rb):
    """XLA rounds lhs·ka + rhs·kb once (a fused multiply-add) and
    saturates at the int32 range; the port's codes are the same."""
    rs = _rs(8)
    lhs, rhs = _q8(rs, (300, 41)), _q8(rs, (300, 41))
    _same("quantized_elemwise_add",
          [lhs, rhs, np.float32(-ra), np.float32(ra), np.float32(-rb),
           np.float32(rb)])


def test_graph_pass_tables_match_jax():
    from incubator_mxnet_tpu.ops import quantization as jq
    from incubator_mxnet_tpu_torch.ops import quantization as tq
    assert tq.QUANTIZED_OP_MAP == jq.QUANTIZED_OP_MAP
    assert tq.NEED_REQUANTIZE == jq.NEED_REQUANTIZE
    for op, params in [("Pooling", {"pool_type": "sum"}),
                       ("Pooling", {}), ("Activation", {"act_type": "tanh"}),
                       ("Activation", {"act_type": "relu"}),
                       ("BatchNorm", {}), ("elemwise_add", {})]:
        assert tq.quantizable(op, params) == jq.quantizable(op, params)


# -- the graph pass and calibration ----------------------------------------------

def _small_cnn(m):
    data = m.sym.var("data")
    c1 = m.sym.Convolution(data, kernel=(3, 3), num_filter=8, pad=(1, 1),
                           name="conv0")
    a1 = m.sym.Activation(c1, act_type="relu", name="relu0")
    p1 = m.sym.Pooling(a1, kernel=(2, 2), stride=(2, 2), pool_type="max",
                       name="pool0")
    f = m.sym.Flatten(p1, name="flatten0")
    fc = m.sym.FullyConnected(f, num_hidden=10, name="fc0")
    return m.sym.softmax(fc, name="sm0")


def _ops(qsym):
    counts = {}
    for n in qsym._topo():
        if not n.is_variable():
            counts[n._op.name] = counts.get(n._op.name, 0) + 1
    return counts


def _nd(m, d):
    return {k: m.nd.array(v, dtype=np.asarray(v).dtype) for k, v in d.items()}


def _np(d):
    return {k: v.asnumpy() for k, v in d.items()}


def test_quantize_symbol_structure_matches_jax():
    """tests/test_quantization.py:130: the same rewrite, node for node."""
    with nets.fresh_names(tmx, jmx):
        tnet, jnet = _small_cnn(tmx), _small_cnn(jmx)
    params = [n for n in tnet.list_arguments() if n != "data"]
    for kw in ({}, {"excluded_sym_names": ["conv0"]}):
        tq = tqz.quantize_symbol(tnet, offline_params=params, **kw)
        jq = jqz.quantize_symbol(jnet, offline_params=params, **kw)
        assert _ops(tq) == _ops(jq)
        assert tq.list_arguments() == jq.list_arguments()
        assert tq.list_outputs() == jq.list_outputs()
    assert "conv0_weight_quantize_min" in tq.list_arguments() or \
        "Convolution" in _ops(tq)


def test_quantize_params_bit_equal():
    with nets.fresh_names(tmx, jmx):
        tnet, jnet = _small_cnn(tmx), _small_cnn(jmx)
    args, _ = nets.values(jnet, {"data": (4, 3, 16, 16)}, seed=9)
    params = {k: v for k, v in args.items() if k != "data"}
    tq = tqz.quantize_symbol(tnet, offline_params=list(params))
    jq = jqz.quantize_symbol(jnet, offline_params=list(params))
    got = _np(tqz.quantize_params(tq, _nd(tmx, params)))
    want = _np(jqz.quantize_params(jq, _nd(jmx, params)))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_optimal_threshold_matches_jax():
    rs = _rs(6)
    x = np.concatenate([rs.randn(100000) * 0.1, np.array([20.0, -20.0])]) \
        .astype(np.float32)
    got = tqz.get_optimal_threshold(x)
    assert got == jqz.get_optimal_threshold(x)
    assert 0.1 < got[3] < 20.0
    lo, hi = tqz.get_optimal_thresholds({"layer_output": [x]})[
        "layer_output"]
    assert lo == -hi and 0.1 < hi < 20.0


def test_optimal_thresholds_match_jax_layer_by_layer():
    """The per-layer search over several layers, an all-zero one among
    them (the JAX build's 1e-6), in the JAX build's order and values."""
    rs = _rs(12)
    layers = {"l%d_output" % i: (rs.standard_normal(3000) * (i + 1))
              .astype(np.float32) for i in range(4)}
    layers["zero_output"] = np.zeros(10, np.float32)
    got = tqz.get_optimal_thresholds(dict(layers), num_bins=1001)
    want = jqz.get_optimal_thresholds(dict(layers), num_bins=1001)
    assert list(got) == list(layers) and got == want
    assert got["zero_output"] == (-1e-6, 1e-6)


def _conv_bn_net(m):
    data = m.sym.var("data")
    c = m.sym.Convolution(data, kernel=(3, 3), num_filter=6, pad=(1, 1),
                          no_bias=True, name="convA")
    b = m.sym.BatchNorm(c, fix_gamma=False, eps=1e-3, name="bnA")
    r = m.sym.Activation(b, act_type="relu", name="reluA")
    c2 = m.sym.Convolution(r, kernel=(1, 1), num_filter=4, name="convB")
    b2 = m.sym.BatchNorm(c2, fix_gamma=True, eps=1e-3, name="bnB")
    return m.sym.Flatten(b2, name="flat")


def test_fold_batchnorm_bit_equal_and_preserves_inference():
    """tests/test_quantization.py:251: the folded weights and biases are
    the JAX build's bit for bit (both fold in numpy f32); the folded graph
    reproduces the unfolded inference output."""
    with nets.fresh_names(tmx, jmx):
        tnet, jnet = _conv_bn_net(tmx), _conv_bn_net(jmx)
    args, aux = nets.values(jnet, {"data": (2, 3, 8, 8)}, seed=0)
    x = args.pop("data")
    tf = tqz.fold_batchnorm(tnet, _nd(tmx, args), _nd(tmx, aux))
    jf = jqz.fold_batchnorm(jnet, _nd(jmx, args), _nd(jmx, aux))
    assert not tf[2] and not jf[2]
    assert "BatchNorm" not in _ops(tf[0])
    assert _ops(tf[0]) == _ops(jf[0])
    got, want = _np(tf[1]), _np(jf[1])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ref = tnet.bind(tmx.cpu(), {**_nd(tmx, args), "data": tmx.nd.array(x)},
                    aux_states=_nd(tmx, aux), grad_req="null") \
        .forward(is_train=False)[0].asnumpy()
    out = tf[0].bind(tmx.cpu(), {**tf[1], "data": tmx.nd.array(x)},
                     grad_req="null").forward(is_train=False)[0].asnumpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_fold_batchnorm_refuses_unsafe_patterns_as_jax():
    """tests/test_quantization.py:305: a shared weight and a BatchNorm over
    another axis do not fold, in either package."""
    def build(m):
        data = m.sym.var("data")
        w = m.sym.var("shared_weight")
        b1 = m.sym.BatchNorm(m.sym.Convolution(
            data, w, kernel=(1, 1), num_filter=4, no_bias=True,
            name="convS1"), fix_gamma=True, name="bnS1")
        b2 = m.sym.BatchNorm(m.sym.Convolution(
            data, w, kernel=(1, 1), num_filter=4, no_bias=True,
            name="convS2"), fix_gamma=True, name="bnS2")
        c3 = m.sym.Convolution(data, kernel=(1, 1), num_filter=5,
                               no_bias=True, name="convAx")
        return b1 + b2, m.sym.BatchNorm(c3, axis=3, fix_gamma=True,
                                        name="bnAx")
    with nets.fresh_names(tmx, jmx):
        tnets, jnets = build(tmx), build(jmx)
    for tn, jn in zip(tnets, jnets):
        args, aux = nets.values(jn, {"data": (2, 3, 5, 5)}, seed=1)
        args.pop("data")
        tf = tqz.fold_batchnorm(tn, _nd(tmx, args), _nd(tmx, aux))
        jf = jqz.fold_batchnorm(jn, _nd(jmx, args), _nd(jmx, aux))
        assert _ops(tf[0]) == _ops(jf[0]) and "BatchNorm" in _ops(tf[0])
        assert sorted(tf[2]) == sorted(jf[2]) and tf[2]


def _walk(m, qsym, args, x):
    """Every output of every node of ``qsym`` on ``x``, each op called
    alone through package ``m``'s ``invoke`` in topological order:
    {(node, output index): numpy}.  (The JAX build's Executor compiles the
    whole graph into one XLA program, which folds a calibrated range into
    the next op's constants and rounds products of ranges in another
    order; op by op, every code is the JAX build's.)"""
    invoke = m.ndarray.ndarray.invoke
    vals = {n: m.nd.array(v, dtype=np.asarray(v).dtype)
            for n, v in args.items()}
    vals["data"] = m.nd.array(x)
    cache, out = {}, {}
    for node in qsym._topo():
        if node.is_variable():
            cache[id(node)] = [vals[node.name]]
            continue
        ins = []
        for e in node._inputs:
            got = cache[id(e._base())]
            ins.append(got[min(e._out_index or 0, len(got) - 1)])
        res = invoke(node._op, ins, dict(node._params))
        res = res if isinstance(res, (list, tuple)) else [res]
        cache[id(node)] = list(res)
        for j, r in enumerate(res):
            out[(node._name, j)] = r.asnumpy()
    return out


def _hold_int8_graph(tq, jq, qargs, x):
    """The int8 graph op by op in both packages: every output of a
    quantization op (integer codes, f32 ranges, dequantized values) and of
    the min and max it reads bit for bit; an f32 op after the chain (the
    softmax) within 1e-6 of its magnitude."""
    got = _walk(tmx, tq, qargs, x)
    want = _walk(jmx, jq, qargs, x)
    assert sorted(got) == sorted(want)
    float_ops = {n._name for n in tq._topo() if not n.is_variable()
                 and not n._op.name.startswith("_contrib_")
                 and n._op.name not in ("min", "max")}
    ints = 0
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        if k[0] in float_ops:
            assert np.abs(got[k] - want[k]).max() <= \
                1e-6 * np.abs(want[k]).max(), k
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
        ints += got[k].dtype.kind == "i"
    assert ints > 0
    return got


@pytest.mark.parametrize("calib_mode", ["none", "naive", "entropy"])
def test_quantize_model_matches_jax(calib_mode):
    """tests/test_quantization.py:165 without the training: quantize_model
    in each package; the calibration tables within 1e-5 of each other
    (naive; entropy picks one of 8001 histogram edges), the int8 graph
    under one table bit for bit, and each package's own calibrated output
    within half an int8 step of the output's range of the JAX build's."""
    with nets.fresh_names(tmx, jmx):
        tnet, jnet = _small_cnn(tmx), _small_cnn(jmx)
    args, _ = nets.values(jnet, {"data": (16, 3, 16, 16)}, seed=7)
    calib = args.pop("data")
    x = _rs(8).standard_normal((4, 3, 16, 16)).astype(np.float32)
    kw = dict(calib_mode=calib_mode, num_calib_examples=16, logger=SILENT)
    tq, tqargs, _ = tqz.quantize_model(
        tnet, _nd(tmx, args), {}, ctx=tmx.cpu(),
        calib_data=tmx.io.NDArrayIter(data=calib, batch_size=8), **kw)
    # the layers a requantize reads (the port's default; the JAX build
    # collects every output and keeps these)
    read = set(tqz._requantized_outputs(tq))
    jq, jqargs, _ = jqz.quantize_model(
        jnet, _nd(jmx, args), {}, calib_layer=lambda n: n in read,
        calib_data=jmx.io.NDArrayIter(data=calib, batch_size=8), **kw)
    assert _ops(tq) == _ops(jq)
    qargs = _np(jqargs)
    for k, v in _np(tqargs).items():
        np.testing.assert_array_equal(v, qargs[k], err_msg=k)
    reqs = [(n._name, n._params) for g in (tq, jq) for n in g._topo()
            if not n.is_variable() and n._op.name == "_contrib_requantize"]
    table = {}
    for name, p in reqs:
        if calib_mode == "none":
            assert "min_calib_range" not in p
            continue
        table.setdefault(name, []).append((p["min_calib_range"],
                                           p["max_calib_range"]))
    for name, ((tlo, thi), (jlo, jhi)) in table.items():
        tol = 1e-5 if calib_mode == "naive" else 2.0 / 8001 * 1.01
        assert abs(thi - jhi) <= tol * abs(jhi), (name, thi, jhi)
        assert abs(tlo - jlo) <= tol * abs(jlo) + 1e-30, (name, tlo, jlo)
    # the JAX build's table in the port's graph: every intermediate equal
    th = {}
    for n in jq._topo():
        if not n.is_variable() and n._op.name == "_contrib_requantize" \
                and "min_calib_range" in n._params:
            th[n._inputs[0]._base()._name[len("quantized_"):] + "_output"] = (
                n._params["min_calib_range"], n._params["max_calib_range"])
    tq_same = tqz.set_calib_table(tqz.quantize_symbol(
        tnet, offline_params=list(args)), th)
    _hold_int8_graph(tq_same, jq, qargs, x)
    # each package's own calibration
    got = tq.bind(tmx.cpu(), {**tqargs, "data": tmx.nd.array(x)},
                  grad_req="null").forward(is_train=False)[0].asnumpy()
    want = jq.bind(jmx.cpu(), {**jqargs, "data": jmx.nd.array(x)},
                   grad_req="null").forward(is_train=False)[0].asnumpy()
    assert np.abs(got - want).max() <= 0.5 / 127 * np.abs(want).max() + 1e-6


def _calib_table(qsym):
    """{layer output name: (min, max)} of a calibrated int8 graph."""
    return {n._inputs[0]._base()._name[len("quantized_"):] + "_output":
            (n._params["min_calib_range"], n._params["max_calib_range"])
            for n in qsym._topo() if not n.is_variable()
            and n._op.name == "_contrib_requantize"
            and "min_calib_range" in n._params}


@pytest.mark.parametrize("calib_mode", ["naive", "entropy"])
def test_folded_resnet18_is_one_int8_chain_as_jax(calib_mode):
    """tests/test_quantization.py:352 on the port, and the whole slice: a
    folded, calibrated ResNet-18 thumbnail quantizes into one int8 chain
    (one ``_contrib_quantize``, one ``_contrib_dequantize``, relu and the
    residual add in int8), node for node the JAX build's.  ``naive``: both
    packages' ``quantize_model``, their tables within 1e-5; under the JAX
    build's table every int8 and int32 intermediate is the JAX build's,
    op by op, and the JAX build's compiled graph stays within two int8
    steps of the logits' range.  ``entropy`` (the JAX build's search takes
    ~4 s a layer, so not over all 30 here): the port's table in the JAX
    build's graph, op by op, and the two searches equal on two of the
    net's layer outputs.  The port's own logits stay within the JAX
    contract's bound of the folded f32 graph."""
    with nets.fresh_names(tmx, jmx):
        tpred = nets.resnet(tmx).get_internals()["fc1_output"]
        jpred = nets.resnet(jmx).get_internals()["fc1_output"]
    rs = _rs(0)
    shapes, _, aux_shapes = jpred.infer_shape(data=(2, 3, 32, 32))
    args = {n: (rs.randn(*s) * 0.1).astype(np.float32)
            for n, s in zip(jpred.list_arguments(), shapes) if n != "data"}
    aux = {n: (np.ones(s, np.float32) if "var" in n
               else np.zeros(s, np.float32))
           for n, s in zip(jpred.list_auxiliary_states(), aux_shapes)}
    tf = tqz.fold_batchnorm(tpred, _nd(tmx, args), _nd(tmx, aux))
    jf = jqz.fold_batchnorm(jpred, _nd(jmx, args), _nd(jmx, aux))
    calib = rs.uniform(-1, 1, (4, 3, 32, 32)).astype(np.float32)
    kw = dict(calib_mode=calib_mode, num_calib_examples=4, logger=SILENT)
    tq, tqargs, _ = tqz.quantize_model(
        tf[0], tf[1], {}, ctx=tmx.cpu(),
        calib_data=tmx.io.NDArrayIter(data=calib, batch_size=4), **kw)
    folded = list(_np(jf[1]))
    if calib_mode == "naive":
        jq, jqargs, _ = jqz.quantize_model(
            jf[0], jf[1], {},
            calib_data=jmx.io.NDArrayIter(data=calib, batch_size=4), **kw)
        table = _calib_table(jq)
        got = _calib_table(tq)
        assert sorted(got) == sorted(table)
        for k, (lo, hi) in table.items():
            assert abs(got[k][1] - hi) <= 1e-5 * abs(hi), k
            assert abs(got[k][0] - lo) <= 1e-5 * abs(lo), k
    else:
        table = _calib_table(tq)
        jq = jqz.set_calib_table(jqz.quantize_symbol(
            jf[0], offline_params=folded), table)
        jqargs = jqz.quantize_params(jq, jf[1])
        names = ["stage1_unit1_c1_conv_output", "stage4_unit2_out_output"]
        layers = jqz.collect_layer_outputs(
            jf[0], jmx.io.NDArrayIter(data=calib, batch_size=4), jmx.cpu(),
            jf[1], {}, include_layer=lambda n: n in names)
        for n in names:
            assert tqz.get_optimal_threshold(layers[n]) == \
                jqz.get_optimal_threshold(layers[n]), n
    counts = _ops(tq)
    assert counts == _ops(jq)
    assert counts["_contrib_quantize"] == 1
    assert counts["_contrib_dequantize"] == 1
    assert counts["_contrib_quantized_act"] > 0
    assert counts["_contrib_quantized_elemwise_add"] > 0
    x = rs.uniform(-1, 1, (4, 3, 32, 32)).astype(np.float32)
    tq_same = tqz.set_calib_table(tqz.quantize_symbol(
        tf[0], offline_params=folded), table)
    walked = _hold_int8_graph(tq_same, jq, _np(jqargs), x)
    if calib_mode == "naive":
        logits = jq.bind(jmx.cpu(), {**jqargs, "data": jmx.nd.array(x)},
                         grad_req="null").forward(is_train=False)[0] \
            .asnumpy()
        last = walked[(list(tq_same._topo())[-1]._name, 0)]
        assert np.abs(last - logits).max() <= 2.0 / 127 * \
            np.abs(logits).max()
    ref = tf[0].bind(tmx.cpu(), {**tf[1], "data": tmx.nd.array(x)},
                     grad_req="null").forward(is_train=False)[0].asnumpy()
    got = tq.bind(tmx.cpu(), {**tqargs, "data": tmx.nd.array(x)},
                  grad_req="null").forward(is_train=False)[0].asnumpy()
    assert np.abs(got - ref).mean() / (ref.std() + 1e-9) < 0.05


def _synthetic_task(rng, n, nclass=4, shape=(3, 16, 16)):
    """Separable images: class c gets a bright patch in quadrant c."""
    x = rng.randn(n, *shape).astype(np.float32) * 0.3
    y = rng.randint(0, nclass, size=n)
    h2, w2 = shape[1] // 2, shape[2] // 2
    for i, c in enumerate(y):
        r, col = divmod(int(c), 2)
        x[i, :, r * h2:(r + 1) * h2, col * w2:(col + 1) * w2] += 1.5
    return x, y.astype(np.float32)


@pytest.mark.parametrize("calib_mode", ["none", "naive", "entropy"])
def test_quantize_model_accuracy(calib_mode):
    """tests/test_quantization.py:165 on the port: a small CNN trained
    through Module.fit, quantized, loses at most 1% of its accuracy (the
    reference quantization suite's bar)."""
    rng = _rs(7)
    xtr, ytr = _synthetic_task(rng, 128)
    xte, yte = _synthetic_task(rng, 64)
    sym = tmx.sym
    data = sym.var("data")
    c1 = sym.Convolution(data, kernel=(3, 3), num_filter=8, pad=(1, 1),
                         name="conv0")
    a1 = sym.Activation(c1, act_type="relu", name="relu0")
    p1 = sym.Pooling(a1, kernel=(2, 2), stride=(2, 2), pool_type="max",
                     name="pool0")
    f = sym.Flatten(p1, name="flatten0")
    fc = sym.FullyConnected(f, num_hidden=4, name="fc0")
    tmx.random.seed(0)
    mod = tmx.mod.Module(symbol=sym.SoftmaxOutput(fc, name="softmax"),
                         context=tmx.cpu())
    mod.fit(tmx.io.NDArrayIter(data=xtr, label=ytr, batch_size=16,
                               shuffle=True), num_epoch=4,
            optimizer="sgd", optimizer_params={"learning_rate": 0.1})
    arg_params, aux_params = mod.get_params()
    pred_net = sym.softmax(fc, name="sm0")
    ref = pred_net.bind(tmx.cpu(), dict(arg_params, data=tmx.nd.array(xte)),
                        grad_req="null").forward(is_train=False)[0].asnumpy()
    fp32_acc = (ref.argmax(1) == yte).mean()
    assert fp32_acc > 0.9, "fp32 model failed to train (acc=%f)" % fp32_acc
    qsym, qparams, _ = tqz.quantize_model(
        pred_net, arg_params, aux_params, calib_mode=calib_mode,
        calib_data=tmx.io.NDArrayIter(data=xtr, batch_size=16),
        num_calib_examples=64, ctx=tmx.cpu(), logger=SILENT)
    if calib_mode != "none":
        reqs = [n for n in qsym._topo() if not n.is_variable()
                and n._op.name == "_contrib_requantize"]
        assert reqs and all("min_calib_range" in n._params for n in reqs)
    got = qsym.bind(tmx.cpu(), dict(qparams, data=tmx.nd.array(xte)),
                    grad_req="null").forward(is_train=False)[0].asnumpy()
    int8_acc = (got.argmax(1) == yte).mean()
    assert fp32_acc - int8_acc <= 0.01 + 1e-9, \
        "accuracy drop %.3f > 1%%" % (fp32_acc - int8_acc)


def test_quantized_graph_runs_through_module():
    """tests/test_quantization.py:228: the int8 graph binds through
    Module, with int8 parameters, and predicts as the f32 graph does."""
    net = _small_cnn(tmx)
    args, _ = nets.values(net, {"data": (4, 3, 16, 16)}, seed=9)
    x = args.pop("data")
    qsym = tqz.quantize_symbol(net, offline_params=list(args))
    qparams = tqz.quantize_params(qsym, _nd(tmx, args))
    mod = tmx.mod.Module(symbol=qsym, data_names=("data",), label_names=None,
                         context=tmx.cpu())
    mod.bind(data_shapes=[("data", (4, 3, 16, 16))], for_training=False)
    mod.set_params(qparams, {}, allow_missing=False)
    mod.forward(tmx.io.DataBatch(data=[tmx.nd.array(x)], label=None),
                is_train=False)
    got = mod.get_outputs()[0].asnumpy()
    ref = net.bind(tmx.cpu(), {**_nd(tmx, args), "data": tmx.nd.array(x)},
                   grad_req="null").forward(is_train=False)[0].asnumpy()
    assert (got.argmax(1) == ref.argmax(1)).all()


def test_quantize_model_defaults_to_the_current_context():
    """Calibration binds on ``current_context()``, the card by default
    (the JAX build's default is the CPU): under ``mx.cpu()`` it runs
    there."""
    import inspect
    src = inspect.getsource(tqz.quantize_model)
    assert "current_context()" in src
    net = _small_cnn(tmx)
    args, _ = nets.values(net, {"data": (8, 3, 16, 16)}, seed=2)
    calib = args.pop("data")
    qsym, _, _ = tqz.quantize_model(
        net, _nd(tmx, args), {}, calib_mode="naive", logger=SILENT,
        calib_data=tmx.io.NDArrayIter(data=calib, batch_size=8))
    assert _ops(qsym)["_contrib_requantize"] == 2


# -- on the card -------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


CARD_OPS = [
    ("quantize", lambda rs: [rs.standard_normal((64, 40)).astype(np.float32),
                             np.float32(-1.5), np.float32(2.0)],
     dict(out_type="int8")),
    ("quantize", lambda rs: [rs.standard_normal((64, 40)).astype(np.float32),
                             np.float32(-1.5), np.float32(2.0)],
     dict(out_type="uint8")),
    ("dequantize", lambda rs: [rs.randint(0, 256, (64, 40)).astype(np.uint8),
                               np.float32(-1.5), np.float32(2.0)], {}),
    ("requantize", lambda rs: [rs.randint(-2 ** 30, 2 ** 30, (64, 40))
                               .astype(np.int32), np.float32(-9.0),
                               np.float32(9.0)], {}),
    ("quantized_conv", lambda rs: [_q8(rs, (2, 3, 15, 15)),
                                   _q8(rs, (16, 3, 7, 7)), _q8(rs, (16,)),
                                   np.float32(-1), np.float32(2),
                                   np.float32(-0.5), np.float32(0.25),
                                   np.float32(-3), np.float32(3)],
     dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3), num_filter=16,
          no_bias=False)),
    ("quantized_conv", lambda rs: [_q8(rs, (1, 8, 5, 5)),
                                   _q8(rs, (8, 4, 3, 3)), np.float32(-1),
                                   np.float32(2), np.float32(-0.5),
                                   np.float32(0.25)],
     dict(kernel=(3, 3), dilate=(2, 2), pad=(2, 2), num_group=2,
          num_filter=8)),
    ("quantized_fully_connected", lambda rs: [
        _q8(rs, (3, 50)), _q8(rs, (10, 50)), np.float32(-1), np.float32(2),
        np.float32(-0.5), np.float32(0.25)], dict(num_hidden=10)),
    ("quantized_pooling", lambda rs: [_q8(rs, (2, 4, 9, 9)), np.float32(-1),
                                      np.float32(1)],
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max")),
    ("quantized_pooling", lambda rs: [_q8(rs, (2, 4, 7, 7)), np.float32(-1),
                                      np.float32(1)],
     dict(kernel=(7, 7), global_pool=True, pool_type="avg")),
    ("quantized_act", lambda rs: [_q8(rs, (2, 4, 7, 7)), np.float32(-1),
                                  np.float32(1)], {}),
    ("quantized_elemwise_add", lambda rs: [
        _q8(rs, (2, 4, 7, 7)), _q8(rs, (2, 4, 7, 7)), np.float32(-1.3),
        np.float32(1.3), np.float32(-0.7), np.float32(0.7)], {}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,make,params", CARD_OPS,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(CARD_OPS)])
def test_card_quantized_op_bit_equal_to_cpu(name, make, params):
    """Each int8 op on the card, bit for bit the CPU's: the int8 products
    through ``_int_mm`` (cuBLASLt), pooling and max on int8, the f32
    arithmetic in the same order."""
    _card()
    arrays = make(_rs(31))
    want = _op(tmx, name, arrays, **params)
    with tmx.gpu(0):
        got = _op(tmx, name, arrays, **params)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_card_calibrated_resnet18_bit_equal_to_cpu():
    """The folded ResNet-18 thumbnail calibrated on the CPU, then its int8
    graph on the card: every intermediate bit for bit the CPU's."""
    _card()
    pred = nets.resnet(tmx).get_internals()["fc1_output"]
    rs = _rs(0)
    shapes, _, aux_shapes = pred.infer_shape(data=(2, 3, 32, 32))
    args = {n: (rs.randn(*s) * 0.1).astype(np.float32)
            for n, s in zip(pred.list_arguments(), shapes) if n != "data"}
    aux = {n: (np.ones(s, np.float32) if "var" in n
               else np.zeros(s, np.float32))
           for n, s in zip(pred.list_auxiliary_states(), aux_shapes)}
    fsym, fargs, _ = tqz.fold_batchnorm(pred, _nd(tmx, args), _nd(tmx, aux))
    calib = rs.uniform(-1, 1, (4, 3, 32, 32)).astype(np.float32)
    qsym, qargs, _ = tqz.quantize_model(
        fsym, fargs, {}, ctx=tmx.cpu(), calib_mode="entropy", logger=SILENT,
        calib_data=tmx.io.NDArrayIter(data=calib, batch_size=4))
    x = rs.uniform(-1, 1, (4, 3, 32, 32)).astype(np.float32)
    want = _walk(tmx, qsym, _np(qargs), x)
    with tmx.gpu(0):
        got = _walk(tmx, qsym, _np(qargs), x)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
