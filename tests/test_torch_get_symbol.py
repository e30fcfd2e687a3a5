"""``autograd.get_symbol`` and ``sym.Custom`` on the port, on the CPU.

get_symbol: the op names in order and ``list_arguments()`` equal the JAX
build's ``trace_to_symbol`` for ``(x * 2).sum()`` and a two-layer
FullyConnected net; bound through the port's Executor with the arrays the
history started from, the port's Symbol gives the eager output, because
each node keeps its parameters; the JAX build's nodes keep none (a
reference-side fault), so its symbol does not.

sym.Custom: the contracts of ``tests/test_custom_rnn.py:38-63`` and one
forward and backward against the JAX build (within 1e-6 relative)."""
import gc
import weakref

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.autograd import _trace
from incubator_mxnet_tpu_torch.base import MXNetError

REL = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _scaled_sum(m, x):
    return (x * 2).sum()


def _two_layer(m, x, w1, b1, w2, b2):
    h = m.nd.FullyConnected(x, w1, b1, num_hidden=5)
    h = m.nd.relu(h)
    return m.nd.FullyConnected(h, w2, b2, num_hidden=3)


def _values(seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32)
            for s in ((4, 6), (5, 6), (5,), (3, 5), (3,))]


def _record(m, fn, vals):
    arrays = [m.nd.array(v) for v in vals]
    arrays[0].attach_grad()
    with m.autograd.record():
        out = fn(m, *arrays)
    return out


def _ops(sym):
    return [n._op.name for n in sym._topo() if not n.is_variable()]


CASES = {"scaled_sum": (_scaled_sum, 1), "two_layer": (_two_layer, 5)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_names_and_arguments_match_the_jax_build(name):
    fn, n = CASES[name]
    vals = _values(1)[:n]
    t = tmx.autograd.get_symbol(_record(tmx, fn, vals))
    j = jmx.autograd.get_symbol(_record(jmx, fn, vals))
    assert isinstance(t, tmx.sym.Symbol)
    assert _ops(t) == _ops(j)
    assert t.list_arguments() == j.list_arguments()


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_symbol_reproduces_the_eager_output(name):
    fn, n = CASES[name]
    vals = _values(2)[:n]
    out = _record(tmx, fn, vals)
    sym, arrays = _trace(out)
    ex = sym.bind(tmx.cpu(), {k: a.detach() for k, a in arrays.items()})
    got = ex.forward()[0].asnumpy()
    np.testing.assert_array_equal(got, out.asnumpy())


def test_port_keeps_params_the_jax_build_drops():
    vals = _values(3)[:1]
    t = tmx.autograd.get_symbol(_record(tmx, _scaled_sum, vals))
    j = jmx.autograd.get_symbol(_record(jmx, _scaled_sum, vals))
    tnode = [n for n in t._topo() if not n.is_variable()][0]
    jnode = [n for n in j._topo() if not n.is_variable()][0]
    assert tnode._op.name == jnode._op.name == "_mul_scalar"
    assert tnode._params["scalar"] == 2
    assert jnode._params == {}
    want = (vals[0] * 2).sum()
    try:
        jout = np.asarray(j.eval(ctx=jmx.cpu(),
                                 data0=jmx.nd.array(vals[0]))[0].asnumpy())
    except Exception:
        jout = None
    assert jout is None or not np.allclose(jout, want, rtol=1e-5)
    tout = t.eval(ctx=tmx.cpu(), data0=tmx.nd.array(vals[0]))[0].asnumpy()
    np.testing.assert_allclose(tout, want, rtol=1e-6)


def test_recorded_history_keeps_no_intermediate_alive():
    """The history ``get_symbol`` reads holds the calls, not the arrays
    between them: an intermediate the caller drops is freed, and the
    symbol still gives the eager output."""
    x = tmx.nd.array(_values(4)[0])
    x.attach_grad()
    with tmx.autograd.record():
        h = x * 2
        ref = weakref.ref(h)
        out = (tmx.nd.relu(h + 1) * 3).sum()
    del h
    gc.collect()
    assert ref() is None
    sym, arrays = _trace(out)
    assert list(arrays) == ["data0"] and arrays["data0"] is x
    got = sym.bind(tmx.cpu(), {"data0": x.detach()}).forward()[0]
    np.testing.assert_array_equal(got.asnumpy(), out.asnumpy())


def test_get_symbol_of_unrecorded_array_is_a_variable():
    x = tmx.nd.array(np.ones((2,), np.float32))
    s = tmx.autograd.get_symbol(x)
    assert s.list_arguments() == ["data0"]


# ---------------------------------------------------------------------------
# sym.Custom
# ---------------------------------------------------------------------------

def _register(m, name):
    class Sigmoid(m.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            self.assign(out_data[0], req[0], m.nd.array(
                1 / (1 + np.exp(-x)), ctx=in_data[0].context))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0].asnumpy()
            g = out_grad[0].asnumpy()
            self.assign(in_grad[0], req[0], m.nd.array(
                g * y * (1 - y), ctx=in_data[0].context))

    @m.operator.register(name)
    class SigmoidProp(m.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Sigmoid()

    return SigmoidProp


@pytest.fixture(scope="module")
def sigmoid():
    name = "torchport_testsigmoid"
    _register(tmx, name)
    _register(jmx, name)
    return name


def test_custom_op_symbol_graph(sigmoid):
    data = tmx.sym.var("data")
    s = tmx.sym.Custom(data, op_type=sigmoid, name="cust")
    assert s.list_arguments() == ["data"]
    assert s.infer_shape(data=(2, 3))[1] == [(2, 3)]
    exe = s.simple_bind(ctx=tmx.cpu(), data=(2, 3))
    x = tmx.nd.array(np.random.RandomState(0).randn(2, 3).astype(
        np.float32))
    out = exe.forward(is_train=True, data=x)[0]
    ref = 1 / (1 + np.exp(-x.asnumpy()))
    np.testing.assert_allclose(out.asnumpy(), ref, rtol=1e-5)
    exe.backward(tmx.nd.ones((2, 3)))
    np.testing.assert_allclose(exe.grad_dict["data"].asnumpy(),
                               ref * (1 - ref), rtol=1e-5)


def test_custom_op_nd_forward_backward(sigmoid):
    x = tmx.nd.array(np.array([[-1.0, 0.0, 2.0]], np.float32))
    x.attach_grad()
    with tmx.autograd.record():
        y = tmx.nd.Custom(x, op_type=sigmoid)
        loss = tmx.nd.sum(y)
    loss.backward()
    ref = 1 / (1 + np.exp(-x.asnumpy()))
    np.testing.assert_allclose(y.asnumpy(), ref, rtol=1e-5)
    np.testing.assert_allclose(x.grad.asnumpy(), ref * (1 - ref), rtol=1e-5)


def test_custom_op_registry_listing(sigmoid):
    assert sigmoid in tmx.operator.get_all_registered_operators()
    with pytest.raises(MXNetError):
        tmx.nd.Custom(tmx.nd.ones((1,)), op_type="not_registered")
    with pytest.raises(MXNetError):
        tmx.sym.Custom(tmx.sym.var("d"), op_type="not_registered")
    with pytest.raises(TypeError):
        tmx.sym.Custom(tmx.sym.var("d"))


def test_custom_op_is_not_deferred(sigmoid):
    x = tmx.nd.array(np.zeros((2,), np.float32))
    with tmx.engine.bulk(8):
        y = tmx.nd.Custom(x * 1.0, op_type=sigmoid)
        assert not tmx.engine._current().instructions   # flushed, eager
    np.testing.assert_allclose(y.asnumpy(), 0.5)


def test_custom_symbol_matches_the_jax_build(sigmoid):
    xv = np.random.RandomState(4).randn(3, 4).astype(np.float32)
    gv = np.random.RandomState(5).randn(3, 4).astype(np.float32)
    res = []
    for m in (tmx, jmx):
        s = m.sym.Custom(m.sym.var("data"), op_type=sigmoid, name="cust")
        exe = s.simple_bind(ctx=m.cpu(), data=(3, 4))
        out = exe.forward(is_train=True, data=m.nd.array(xv))[0].asnumpy()
        exe.backward(m.nd.array(gv))
        res.append((out, exe.grad_dict["data"].asnumpy()))
    for got, want in zip(*res):
        assert float(np.abs(got - want).max()) <= REL * float(
            np.abs(want).max())
