"""NDArray and its ops in the PyTorch port, against the JAX build on the CPU.

Inputs come from a seeded numpy RandomState and go through both packages;
the probes are those of the build's verify recipe (bad reshape, asscalar
on a non-scalar, unknown op, view write-through, ``out=``, mixed numpy
operands).
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _x(shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


# (name, f(nd, *arrays), input shapes) run through each package's nd
OPS = [
    ("add", lambda nd, a, b: a + b, [(2, 3, 4), (1, 3, 4)]),
    ("sub", lambda nd, a, b: a - b, [(2, 3, 4), (2, 3, 4)]),
    ("mul", lambda nd, a, b: a * b, [(2, 3, 4), (4,)]),
    ("div", lambda nd, a, b: a / (b * b + 1), [(2, 3), (2, 3)]),
    ("scalars", lambda nd, a: (2.5 - a) * 3 + a / 2 - 1 + 4 / (a * a + 1),
     [(3, 5)]),
    ("neg", lambda nd, a: -a, [(3, 5)]),
    ("broadcast_add", lambda nd, a, b: nd.broadcast_add(a, b),
     [(2, 1, 4), (1, 3, 1)]),
    ("elemwise_mul", lambda nd, a, b: nd.elemwise_mul(a, b), [(3, 4), (3, 4)]),
    ("reshape_codes", lambda nd, a: nd.reshape(a, shape=(0, -3, -1)),
     [(2, 3, 4, 5)]),
    ("reshape_split", lambda nd, a: nd.Reshape(a, shape=(-4, 1, 2, -2)),
     [(2, 3, 4)]),
    ("transpose_axes", lambda nd, a: nd.transpose(a, axes=(0, 2, 1, 3)),
     [(2, 3, 4, 5)]),
    ("transpose_all", lambda nd, a: nd.transpose(a), [(2, 3, 4)]),
    ("expand_dims", lambda nd, a: nd.expand_dims(a, axis=1), [(3, 4)]),
    ("slice_axis", lambda nd, a: nd.slice_axis(a, axis=-1, begin=1, end=-1),
     [(2, 3, 6)]),
    ("slice_axis_open", lambda nd, a: nd.slice_axis(a, axis=1, begin=-2),
     [(2, 5, 3)]),
    ("argmax", lambda nd, a: nd.argmax(a, axis=-1), [(4, 7)]),
    ("argmax_keepdims", lambda nd, a: nd.argmax(a, axis=0, keepdims=True),
     [(4, 7)]),
    ("softmax", lambda nd, a: nd.softmax(a, axis=-1), [(3, 6)]),
    ("activation_tanh", lambda nd, a: nd.Activation(a, act_type="tanh"),
     [(3, 6)]),
    ("activation_softrelu", lambda nd, a: nd.Activation(a, act_type="softrelu"),
     [(3, 6)]),
    ("fully_connected_flatten",
     lambda nd, a, w, b: nd.FullyConnected(a, w, b, num_hidden=5),
     [(2, 3, 4), (5, 12), (5,)]),
    ("fully_connected_3d",
     lambda nd, a, w: nd.FullyConnected(a, w, no_bias=True, num_hidden=5,
                                        flatten=False),
     [(2, 3, 4), (5, 4)]),
    ("layer_norm", lambda nd, a, g, b: nd.LayerNorm(a, g, b), [(2, 3, 8), (8,),
                                                               (8,)]),
    ("layer_norm_axis1", lambda nd, a, g, b: nd.LayerNorm(a, g, b, axis=1,
                                                          eps=1e-3),
     [(2, 6, 4), (6,), (6,)]),
    ("cast", lambda nd, a: a.astype("float16").astype("float32"), [(3, 4)]),
]


@pytest.mark.parametrize("name,fn,shapes", OPS, ids=[o[0] for o in OPS])
def test_op_matches_jax(name, fn, shapes):
    arrays = [_x(s, seed=i) for i, s in enumerate(shapes)]
    want = fn(jmx.nd, *[jmx.nd.array(a) for a in arrays]).asnumpy()
    got = fn(tmx.nd, *[tmx.nd.array(a) for a in arrays])
    assert got.shape == want.shape
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got.asnumpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("maker", ["zeros", "ones", "full"])
def test_creation_matches_jax(maker):
    args = ((2, 3), 7.5) if maker == "full" else ((2, 3),)
    want = getattr(jmx.nd, maker)(*args).asnumpy()
    got = getattr(tmx.nd, maker)(*args)
    assert got.context == tmx.cpu() and got.dtype == np.float32
    np.testing.assert_array_equal(got.asnumpy(), want)
    assert tmx.nd.zeros(4, dtype="int32").dtype == np.int32


def test_array_dtypes():
    assert tmx.nd.array(np.zeros(3)).dtype == np.float32          # f64 → f32
    assert tmx.nd.array([1, 2]).dtype == np.float32
    assert tmx.nd.array(np.zeros(3, np.int32)).dtype == np.int32
    b = tmx.nd.array(np.array([1.5, 2.25, 3.0], np.float32), dtype="bfloat16")
    assert b.dtype == torch.bfloat16
    out = b.asnumpy()
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, [1.5, 2.25, 3.0])


def test_bad_reshape_raises():
    a = tmx.nd.zeros((2, 3))
    with pytest.raises(ValueError):
        a.reshape((4, 2))
    with pytest.raises(ValueError):
        tmx.nd.reshape(a, shape=(5,))


def test_asscalar():
    with pytest.raises(ValueError):
        tmx.nd.zeros((2,)).asscalar()
    assert tmx.nd.full((1,), 3.0).asscalar() == 3.0


def test_unknown_op_raises_attribute_error():
    with pytest.raises(AttributeError):
        tmx.nd.not_an_operator
    with pytest.raises(KeyError):
        tmx.ndarray.imperative_invoke("not_an_operator", tmx.nd.zeros((1,)))


def test_view_write_through():
    a = tmx.nd.array(np.arange(12, dtype=np.float32).reshape(3, 4))
    a[0][:] = 9
    a[1:3][0][1] = -1
    r = a.reshape((2, 6))
    r[1][:] = 5
    want = np.arange(12, dtype=np.float32).reshape(3, 4)
    want[0] = 9
    want[1, 1] = -1
    want.reshape(2, 6)[1] = 5
    np.testing.assert_array_equal(a.asnumpy(), want)
    # the JAX build agrees on the same probe
    j = jmx.nd.array(np.arange(12, dtype=np.float32).reshape(3, 4))
    j[0][:] = 9
    np.testing.assert_array_equal(j.asnumpy()[0], a.asnumpy()[0])


def test_op_results_do_not_alias_inputs():
    a = tmx.nd.array(_x((2, 3, 4)))
    before = a.asnumpy()
    for out in (tmx.nd.reshape(a, shape=(6, 4)), tmx.nd.transpose(a),
                tmx.nd.slice_axis(a, axis=0, begin=0, end=1),
                tmx.nd.expand_dims(a, axis=0), a.astype("float32")):
        out[:] = 0
    np.testing.assert_array_equal(a.asnumpy(), before)


def test_out_kwarg_stores():
    a, b = tmx.nd.array(_x((2, 3))), tmx.nd.array(_x((2, 3), 1))
    c = tmx.nd.zeros((2, 3))
    r = tmx.nd.broadcast_add(a, b, out=c)
    assert r is c
    np.testing.assert_allclose(c.asnumpy(), a.asnumpy() + b.asnumpy())
    base = tmx.nd.zeros((3, 2, 3))
    tmx.nd.broadcast_mul(a, b, out=base[1])      # through a view
    np.testing.assert_allclose(base.asnumpy()[1], a.asnumpy() * b.asnumpy())
    assert not base.asnumpy()[0].any() and not base.asnumpy()[2].any()


def test_mixed_numpy_operands_and_inplace():
    x = _x((2, 3))
    a = tmx.nd.array(x)
    np.testing.assert_allclose((a + x).asnumpy(), 2 * x)
    np.testing.assert_allclose((x - a).asnumpy(), 0 * x)
    a += 1
    a *= 2
    np.testing.assert_allclose(a.asnumpy(), (x + 1) * 2, rtol=1e-6)
    i = tmx.nd.array(np.array([1, 2, 3], np.int32))
    assert (i + 1).dtype == np.int32


def test_indexing_and_setitem():
    x = _x((4, 5))
    a = tmx.nd.array(x)
    np.testing.assert_array_equal(a[1:3].asnumpy(), x[1:3])
    np.testing.assert_array_equal(a[:, 2].asnumpy(), x[:, 2])
    np.testing.assert_array_equal(a[[0, 3]].asnumpy(), x[[0, 3]])
    idx = tmx.nd.array(np.array([2, 1], np.int32))
    np.testing.assert_array_equal(a[idx].asnumpy(), x[[2, 1]])
    a[:] = 0.5
    assert (a.asnumpy() == 0.5).all()
    a[:] = np.arange(5, dtype=np.float32)
    np.testing.assert_array_equal(a.asnumpy()[3], np.arange(5))
    a[2, 1] = 7
    assert a.asnumpy()[2, 1] == 7
    assert len(a) == 4 and a.size == 20 and a.ndim == 2


def test_copyto_context_and_waitall():
    a = tmx.nd.array(_x((2, 2)))
    b = a.copyto(tmx.cpu())
    b[:] = 0
    assert a.asnumpy().any()
    c = tmx.nd.zeros((2, 2))
    a.copyto(c)
    np.testing.assert_array_equal(c.asnumpy(), a.asnumpy())
    tmx.nd.waitall()
    a.wait_to_read()


# the six scalar ops on bf16 and f16 arrays: the scalar rounds to the array's
# dtype (jnp.asarray(scalar, dtype) in the JAX build), then one rounded op;
# bit for bit, but f16 division, where XLA multiplies by f16(1 / f16(s))
# (its rewrite of a division by a constant), one ulp from the correctly
# rounded quotient the port computes
SCALAR_OPS = [
    ("_plus_scalar", lambda a, s: a + s),
    ("_minus_scalar", lambda a, s: a - s),
    ("_rminus_scalar", lambda a, s: s - a),
    ("_mul_scalar", lambda a, s: a * s),
    ("_div_scalar", lambda a, s: a / s),
    ("_rdiv_scalar", lambda a, s: s / a),
]


@pytest.mark.parametrize("scalar", [0.001, 0.1, 7.3, 3])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("name,fn", SCALAR_OPS, ids=[n for n, _ in SCALAR_OPS])
def test_scalar_op_rounds_scalar_to_dtype(name, fn, dtype, scalar):
    x = _x((256,), seed=7) * 5
    want = np.asarray(fn(jmx.nd.array(x, dtype=dtype), scalar).asnumpy(),
                      np.float32)
    got = fn(tmx.nd.array(x, dtype=dtype), scalar)
    assert tmx.base.dtype_name(got._data.dtype) == dtype
    got = np.asarray(got.asnumpy(), np.float32)
    if dtype == "float16" and name == "_div_scalar":
        spacing = np.spacing(np.abs(want).astype(np.float16)).astype(np.float32)
        assert (np.abs(got - want) <= spacing).all()
    else:
        np.testing.assert_array_equal(got, want)


def test_scalar_op_on_int_array_stays_int():
    i = tmx.nd.array(np.array([1, 2, 7], np.int32))
    out = i * 2.5                      # the scalar is int(2.5), as jnp's
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out.asnumpy(), [2, 4, 14])
    np.testing.assert_array_equal(
        out.asnumpy(), (jmx.nd.array(np.array([1, 2, 7], np.int32)) *
                        2.5).asnumpy())
