"""Faults C4-C6 of the port against the JAX build, on the same numpy inputs:
``pick`` out of range (NaN, not a wrapped read), the integer dtypes of
``sum`` and ``nd.array``, and the comparison family (ops and NDArray
operators, 16-bit inputs included)."""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx


def _t(x, dtype=None):
    return tmx.nd.array(x, ctx=tmx.cpu(), dtype=dtype)


def _j(x, dtype=None):
    return jmx.nd.array(x, dtype=dtype)


def _same(t_out, j_out):
    """Port result equals the JAX build's in dtype and value (NaN in the
    same places); bf16 compares through f32, which holds it exactly."""
    assert str(t_out.dtype).replace("torch.", "") == \
        str(j_out.dtype).replace("torch.", ""), (t_out.dtype, j_out.dtype)
    a = np.asarray(t_out.asnumpy())
    b = np.asarray(j_out.asnumpy()).astype(a.dtype)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# -- C4: pick / batch_take -----------------------------------------------------

PICK_CASES = [
    ("float32", [5, -1, 2], 1),
    ("float32", [-5, 4, 0], 1),
    ("float32", [3, -4, 1], 1),
    ("float32", [7, 1, 2, -3], 0),
    ("float32", [np.nan, 1.5, 2.7], 1),
    ("bfloat16", [5, -1, 2], 1),
    ("float16", [4, -4, -5], 1),
    ("int32", [5, -1, 2], 1),
]


@pytest.mark.parametrize("dtype,index,axis", PICK_CASES)
def test_pick_out_of_range_matches_jax(dtype, index, axis):
    data = np.arange(12, dtype=np.float32).reshape(3, 4)
    got = tmx.nd.pick(_t(data, dtype), _t(index), axis=axis)
    want = jmx.nd.pick(_j(data, dtype), _j(index), axis=axis)
    _same(got, want)


def test_pick_keepdims_and_batch_take_alias():
    data = np.random.RandomState(0).randn(2, 3, 5).astype(np.float32)
    index = np.array([[0, 9, -2], [4, -6, 1]], np.float32)
    for keepdims in (False, True):
        got = tmx.nd.pick(_t(data), _t(index), axis=2, keepdims=keepdims)
        want = jmx.nd.pick(_j(data), _j(index), axis=2, keepdims=keepdims)
        _same(got, want)
    _same(tmx.nd.batch_take(_t(data), _t(index), axis=2),
          jmx.nd.batch_take(_j(data), _j(index), axis=2))


def test_cross_entropy_with_a_bad_label_is_nan_as_in_jax():
    """The loss that motivated C4: a label past the class count gives NaN
    on its row in both packages, not a finite wrong loss."""
    pred = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    label = np.array([1, 4, 2], np.float32)
    got = tmx.gluon.loss.SoftmaxCrossEntropyLoss()(_t(pred), _t(label))
    want = jmx.gluon.loss.SoftmaxCrossEntropyLoss()(_j(pred), _j(label))
    a, b = got.asnumpy(), want.asnumpy()
    assert np.isnan(a[1]) and np.isnan(b[1])
    np.testing.assert_allclose(a[[0, 2]], b[[0, 2]], rtol=1e-6, atol=1e-6)


def test_pick_gradient_skips_out_of_range_rows():
    data = np.random.RandomState(2).randn(3, 4).astype(np.float32)
    x = _t(data)
    x.attach_grad()
    with tmx.autograd.record():
        y = tmx.nd.pick(x, _t([1, 7, -1]))
    y.backward()
    want = np.zeros_like(data)
    want[0, 1] = want[2, 3] = 1.0
    np.testing.assert_array_equal(x.grad.asnumpy(), want)


@pytest.mark.cuda
def test_card_pick_matches_jax_without_a_host_sync():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    data = np.arange(12, dtype=np.float32).reshape(3, 4)
    index = [5, -1, 2]
    d = tmx.nd.array(data, ctx=tmx.gpu(0))
    i = tmx.nd.array(index, ctx=tmx.gpu(0))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = tmx.nd.pick(d, i)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _same(out, jmx.nd.pick(_j(data), _j(index)))


# -- C5: integer dtypes --------------------------------------------------------

@pytest.mark.parametrize("dtype", ["int32", "int8", "uint8", "int16",
                                   "float16", "bfloat16", "float32"])
@pytest.mark.parametrize("axis", [None, 1])
def test_sum_dtype_matches_jax(dtype, axis):
    data = np.arange(6, dtype=np.float32).reshape(2, 3) + 120
    _same(tmx.nd.sum(_t(data, dtype), axis=axis),
          jmx.nd.sum(_j(data, dtype), axis=axis))


@pytest.mark.parametrize("dtype", ["int32", "int8", "uint8"])
def test_mean_of_integers_matches_jax(dtype):
    data = np.arange(6, dtype=np.float32).reshape(2, 3)
    _same(tmx.nd.mean(_t(data, dtype), axis=0),
          jmx.nd.mean(_j(data, dtype), axis=0))


def test_integer_sum_wraps_as_jax():
    data = np.full((4,), 2 ** 30, np.int32)
    _same(tmx.nd.sum(_t(data)), jmx.nd.sum(_j(data)))


@pytest.mark.parametrize("np_dtype", [np.int64, np.uint64, np.float64,
                                      np.int32, np.uint8, np.float16])
def test_array_narrows_64_bit_numpy_as_jax(np_dtype):
    src = np.arange(5).astype(np_dtype)
    _same(_t(src), _j(src))
    assert tmx.nd.array([1, 2], ctx=tmx.cpu()).dtype == np.float32


def test_array_keeps_an_explicit_int64():
    src = np.arange(3, dtype=np.int64)
    assert _t(src, "int64").dtype == np.int64


# -- C6: comparisons -----------------------------------------------------------

OPS = ["broadcast_equal", "broadcast_not_equal", "broadcast_greater",
       "broadcast_greater_equal", "broadcast_lesser", "broadcast_lesser_equal"]
ALIASES = ["_equal", "_not_equal", "_greater", "_greater_equal", "_lesser",
           "_lesser_equal"]
SCALAR_OPS = ["_equal_scalar", "_not_equal_scalar", "_greater_scalar",
              "_greater_equal_scalar", "_lesser_scalar",
              "_lesser_equal_scalar"]
DTYPES = ["float32", "float16", "bfloat16", "int32", "uint8"]


def _cmp_inputs():
    rs = np.random.RandomState(3)
    a = rs.randint(0, 4, (3, 4)).astype(np.float32)
    b = rs.randint(0, 4, (1, 4)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", OPS + ALIASES)
def test_comparison_ops_match_jax(op, dtype):
    a, b = _cmp_inputs()
    _same(getattr(tmx.nd, op)(_t(a, dtype), _t(b, dtype)),
          getattr(jmx.nd, op)(_j(a, dtype), _j(b, dtype)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", SCALAR_OPS)
@pytest.mark.parametrize("scalar", [2.0, 2.4, 1.9999999999, -1.0])
def test_scalar_comparisons_match_jax(op, dtype, scalar):
    a = np.array([[0.0, 1.0, 2.0], [2.5, 3.0, 2.4]], np.float32)
    if dtype in ("int32", "uint8"):
        a = np.floor(a)
    _same(getattr(tmx.nd, op)(_t(a, dtype), scalar=scalar),
          getattr(jmx.nd, op)(_j(a, dtype), scalar=scalar))


@pytest.mark.parametrize("dtype", DTYPES)
def test_ndarray_comparison_operators_match_jax(dtype):
    a, b = _cmp_inputs()
    ta, tb, ja, jb = _t(a, dtype), _t(b, dtype), _j(a, dtype), _j(b, dtype)
    for f in (lambda x, y: x == y, lambda x, y: x != y, lambda x, y: x > y,
              lambda x, y: x >= y, lambda x, y: x < y, lambda x, y: x <= y,
              lambda x, y: x == 2, lambda x, y: x != 2.0,
              lambda x, y: x > 1.5, lambda x, y: x <= 2,
              lambda x, y: x == np.array([0, 1, 2, 3], np.float32)):
        _same(f(ta, tb), f(ja, jb))


def test_mixed_dtype_comparison_keeps_the_left_dtype():
    a, b = _cmp_inputs()
    for lt, rt in (("float32", "int32"), ("float16", "bfloat16"),
                   ("int32", "float32"), ("bfloat16", "float32")):
        _same(_t(a, lt) == _t(b, rt), _j(a, lt) == _j(b, rt))


def test_equal_arrays_compare_equal_not_by_identity():
    a = _t([1.0, 2.0, 3.0])
    b = _t([1.0, 2.0, 3.0])
    assert (a == b).asnumpy().tolist() == [1.0, 1.0, 1.0]
    assert (a != b).asnumpy().tolist() == [0.0, 0.0, 0.0]
    assert (a == None) is False  # noqa: E711 - the operator under test
    assert (a != None) is True  # noqa: E711
    assert hash(a) != hash(b) and hash(a) == hash(a)
    assert len({a, b}) == 2


def test_truth_value_of_a_comparison():
    a, b = _t([1.0]), _t([1.0])
    assert bool(a == b) and not bool(a != b)
    with pytest.raises(ValueError, match="ambiguous"):
        bool(_t([1.0, 2.0]) == _t([1.0, 2.0]))


def test_comparisons_record_no_gradient():
    x = _t([1.0, 2.0, 3.0])
    x.attach_grad()
    with tmx.autograd.record():
        y = (x > 1.5) * x
    y.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(), [0.0, 1.0, 1.0])
