"""The NDArray methods and ``nd`` functions that wrap the array surface,
in the port against the JAX build on the CPU (bit-equal: each wraps one
op or a view), and the view semantics of ``at``/``slice``/``expand_dims``."""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from test_torch_ops_math import gen


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _np(a):
    return np.asarray(a.asnumpy(), np.float32) if not np.isscalar(a) else a


X = gen("any", (3, 4, 5), 3)
METHODS = [
    ("T", lambda a: a.T),
    ("copy", lambda a: a.copy()),
    ("flatten", lambda a: a.flatten()),
    ("transpose", lambda a: a.transpose()),
    ("transpose_axes", lambda a: a.transpose((1, 0, 2))),
    ("transpose_args", lambda a: a.transpose(2, 0, 1)),
    ("expand_dims", lambda a: a.expand_dims(1)),
    ("expand_dims_neg", lambda a: a.expand_dims(-1)),
    ("reshape_like", lambda a: a.reshape_like(a.reshape((12, 5)))),
    ("sum", lambda a: a.sum()),
    ("sum_axis", lambda a: a.sum(axis=1, keepdims=True)),
    ("mean", lambda a: a.mean(axis=(0, 2))),
    ("max", lambda a: a.max(axis=2)),
    ("min", lambda a: a.min()),
    ("argmax", lambda a: a.argmax(axis=1)),
    ("argmin", lambda a: a.argmin(axis=0)),
    ("clip", lambda a: a.clip(-0.5, 0.8)),
    ("abs", lambda a: a.abs()),
    ("exp", lambda a: a.exp()),
    ("log", lambda a: a.abs().log()),
    ("sqrt", lambda a: a.abs().sqrt()),
    ("square", lambda a: a.square()),
    ("at", lambda a: a.at(1)),
    ("slice", lambda a: a.slice(1, 3)),
    ("mod", lambda a: a % 0.7),
    ("rmod", lambda a: 2.5 % (a.abs() + 1)),
    ("pow", lambda a: a.abs() ** 1.5),
    ("rpow", lambda a: 2.0 ** a),
    ("abs_op", lambda a: abs(a)),
    ("mod_nd", lambda a: a % (a.abs() + 0.5)),
    ("concatenate", lambda a: _mod(a).concatenate([a, a * 2], axis=1)),
    ("moveaxis", lambda a: _mod(a).moveaxis(a, 0, 2)),
]


def _mod(a):
    return tmx.nd if isinstance(a, tmx.nd.NDArray) else jmx.nd


@pytest.mark.parametrize("name,fn", METHODS, ids=[m[0] for m in METHODS])
def test_method_matches_jax(name, fn):
    got = fn(tmx.nd.array(X))
    want = fn(jmx.nd.array(X))
    assert got.shape == want.shape
    assert tmx.base.dtype_name(got._data.dtype) == str(want.dtype)
    if name in ("exp", "log", "sqrt", "pow", "rpow", "mean", "sum"):
        np.testing.assert_allclose(_np(got), _np(want), rtol=4e-7, atol=0)
    else:
        np.testing.assert_array_equal(_np(got), _np(want))


def test_scalar_properties_and_sync():
    a = tmx.nd.array(X)
    assert a.stype == "default"
    assert a.tostype("default") is a
    rsp = a.tostype("row_sparse")
    assert rsp.stype == "row_sparse" == jmx.nd.array(X).tostype(
        "row_sparse").stype
    np.testing.assert_array_equal(rsp.asnumpy(), a.asnumpy())
    assert a.as_nd_ndarray() is a
    assert a.as_in_context(tmx.cpu()) is a
    one = tmx.nd.array(np.array([2.5], np.float32))
    assert one.item() == 2.5 == jmx.nd.array(np.array([2.5])).item()
    a.wait_to_write()
    b = a.copy()
    b[:] = 0
    assert np.abs(a.asnumpy()).sum() > 0


def test_views_write_through():
    """``at`` and ``slice`` are views of axis 0 (a 1-d ``at`` keeps shape
    (1,)), as in the JAX build; writes through them reach the base; a
    negative ``at`` counts from the end and an index out of range raises."""
    a = tmx.nd.array(X.copy())
    a.at(1)[:] = 7.0
    a.slice(2, 3)[:] = -1.0
    want = X.copy()
    want[1] = 7.0
    want[2] = -1.0
    np.testing.assert_array_equal(a.asnumpy(), want)
    v = tmx.nd.array(np.arange(4, dtype=np.float32))
    assert v.at(2).shape == (1,) == jmx.nd.array(np.arange(4.0)).at(2).shape
    assert v.at(-1).asnumpy().tolist() == [3.0]
    with pytest.raises(IndexError):
        v.at(4)
    with pytest.raises(IndexError):
        v.slice(3, 1)
    e = a.expand_dims(0)
    e[0, 0, 0, 0] = 42.0
    assert a.asnumpy()[0, 0, 0] == 42.0


def test_onehot_encode_and_gradient_through_methods():
    idx = np.array([0, 3, 1], np.float32)
    out_t = tmx.nd.zeros((3, 4))
    out_j = jmx.nd.zeros((3, 4))
    tmx.nd.onehot_encode(tmx.nd.array(idx), out_t)
    jmx.nd.onehot_encode(jmx.nd.array(idx), out_j)
    np.testing.assert_array_equal(out_t.asnumpy(), out_j.asnumpy())
    for mx in (tmx, jmx):
        x = mx.nd.array(X)
        x.attach_grad()
        with mx.autograd.record():
            y = (x.T.exp().sum() + x.clip(-0.5, 0.8).square().mean()
                 + x.max(axis=1).sum())
        y.backward()
        if mx is tmx:
            got = x.grad.asnumpy()
        else:
            want = x.grad.asnumpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)
