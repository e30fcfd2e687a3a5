"""The port's SequentialModule, PythonModule, PythonLossModule and
executor_manager on the CPU: the JAX build's contracts
(``tests/test_contrib_frontends.py:163-198, :215``), and the same
initial weights and batches through both packages, weights within 1e-6
of the largest reference value after 3 steps."""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.base import MXNetError

REL = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _toy():
    rng = np.random.RandomState(0)
    x = rng.randn(120, 10).astype(np.float32)
    w = rng.randn(10, 3).astype(np.float32)
    y = (x @ w).argmax(1).astype(np.float32)
    return x, y


def _nets(m):
    net1 = m.sym.Activation(m.sym.FullyConnected(
        m.sym.var("data"), num_hidden=16, name="fc1"), act_type="relu",
        name="relu1")
    net2 = m.sym.SoftmaxOutput(m.sym.FullyConnected(
        m.sym.var("data"), num_hidden=3, name="fc2"), name="softmax")
    return net1, net2


def test_sequential_module_trains():
    x, y = _toy()
    net1, net2 = _nets(tmx)
    seq = tmx.mod.SequentialModule()
    seq.add(tmx.mod.Module(net1, label_names=None, context=tmx.cpu())) \
       .add(tmx.mod.Module(net2, context=tmx.cpu()), take_labels=True,
            auto_wiring=True)
    it = tmx.io.NDArrayIter(x, y, batch_size=20, shuffle=True)
    seq.fit(it, num_epoch=12, optimizer="sgd",
            optimizer_params={"learning_rate": 0.5},
            initializer=tmx.init.Xavier())
    acc = seq.score(tmx.io.NDArrayIter(x, y, batch_size=20), "acc")[0][1]
    assert acc > 0.9
    assert seq.data_names == ["data"] and seq.output_names == [
        "softmax_output"]
    assert seq.label_shapes == [("softmax_label", (20,))]


def test_python_loss_module_trains():
    x, y = _toy()
    feat = tmx.sym.FullyConnected(tmx.sym.var("data"), num_hidden=3,
                                  name="fcp")
    seq = tmx.mod.SequentialModule()
    seq.add(tmx.mod.Module(feat, label_names=None, context=tmx.cpu())) \
       .add(tmx.mod.PythonLossModule(), take_labels=True)
    it = tmx.io.NDArrayIter(x, y, batch_size=20, shuffle=True)
    seq.fit(it, num_epoch=15, optimizer="sgd",
            optimizer_params={"learning_rate": 0.2},
            initializer=tmx.init.Xavier())
    seq.forward(tmx.io.DataBatch(data=[tmx.nd.array(x)],
                                 label=[tmx.nd.array(y)]), is_train=False)
    out = seq.get_outputs()[0].asnumpy()
    assert (out.argmax(1) == y).mean() > 0.9


def test_sequential_module_errors():
    with pytest.raises(ValueError):
        tmx.mod.SequentialModule().add(
            tmx.mod.PythonLossModule(), bogus=True)
    with pytest.raises(MXNetError):
        tmx.mod.SequentialModule().bind([("data", (2, 3))])


def _weights(m, mods):
    arg, aux = mods.get_params()
    return {n: v.asnumpy() for n, v in list(arg.items()) + list(aux.items())}


def _steps(m, seq, batches):
    for xb, yb in batches:
        seq.forward(m.io.DataBatch(data=[m.nd.array(xb)],
                                   label=[m.nd.array(yb)]), is_train=True)
        seq.backward()
        seq.update()
    return _weights(m, seq)


def _parity(build):
    x, y = _toy()
    rs = np.random.RandomState(5)
    batches = [(x[i * 20:(i + 1) * 20], y[i * 20:(i + 1) * 20])
               for i in range(3)]
    got, want = None, None
    for m in (tmx, jmx):
        seq, shapes = build(m)
        seq.bind([("data", (20, 10))], [("softmax_label", (20,))])
        params = {n: rs.randn(*s).astype(np.float32) * 0.3
                  for n, s in shapes.items()} if got is None else params
        seq.init_params(arg_params={n: m.nd.array(v)
                                    for n, v in params.items()})
        seq.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5})
        res = _steps(m, seq, batches)
        if got is None:
            got = res
        else:
            want = res
    assert sorted(got) == sorted(want)
    for n in want:
        scale = float(np.abs(want[n]).max())
        assert float(np.abs(got[n] - want[n]).max()) <= REL * scale, n


def test_sequential_module_matches_the_jax_build():
    def build(m):
        net1, net2 = _nets(m)
        seq = m.mod.SequentialModule()
        seq.add(m.mod.Module(net1, label_names=None, context=m.cpu()))
        seq.add(m.mod.Module(net2, context=m.cpu()), take_labels=True,
                auto_wiring=True)
        return seq, {"fc1_weight": (16, 10), "fc1_bias": (16,),
                     "fc2_weight": (3, 16), "fc2_bias": (3,)}
    _parity(build)


def test_python_loss_module_matches_the_jax_build():
    def build(m):
        feat = m.sym.FullyConnected(m.sym.var("data"), num_hidden=3,
                                    name="fcp")
        seq = m.mod.SequentialModule()
        seq.add(m.mod.Module(feat, label_names=None, context=m.cpu()))
        seq.add(m.mod.PythonLossModule(), take_labels=True)
        return seq, {"fcp_weight": (3, 10), "fcp_bias": (3,)}
    _parity(build)


def test_python_module_defaults():
    pm = tmx.mod.PythonModule(["data"], ["label"], ["out"])
    pm.bind([("data", (4, 7))], [("label", (4,))])
    assert pm.output_shapes == [("out", (4, 7))]
    assert pm.get_params() == ({}, {})
    pm.init_params()
    assert pm.params_initialized


@pytest.mark.parametrize("batch,work", [(10, [1, 1]), (9, [2, 1]),
                                        (7, [1, 2, 4]), (8, [1])])
def test_split_input_slice_matches_the_jax_build(batch, work):
    from incubator_mxnet_tpu.executor_manager import _split_input_slice as j
    from incubator_mxnet_tpu_torch.executor_manager import (
        _split_input_slice as t)
    assert t(batch, work) == j(batch, work)


def test_executor_manager_shim():
    from incubator_mxnet_tpu_torch.executor_manager import (
        _check_arguments, _split_input_slice)
    assert _split_input_slice(10, [1, 1]) == [slice(0, 5), slice(5, 10)]
    slices = _split_input_slice(9, [2, 1])
    assert slices[0] == slice(0, 6) and slices[1] == slice(6, 9)
    with pytest.raises(ValueError):
        _split_input_slice(1, [1, 1])
    net = tmx.sym.FullyConnected(tmx.sym.var("data"), num_hidden=2,
                                 name="fcx")
    _check_arguments(net)
    dup = tmx.sym.FullyConnected(tmx.sym.var("fcx_weight"), num_hidden=2,
                                 name="fcx")
    with pytest.raises(MXNetError):
        _check_arguments(dup)


def test_executor_manager_matches_the_jax_build():
    x, y = _toy()
    rs = np.random.RandomState(9)
    params = {"fc1_weight": rs.randn(16, 10).astype(np.float32),
              "fc1_bias": rs.randn(16).astype(np.float32)}
    grads = []
    for m in (tmx, jmx):
        net = m.sym.SoftmaxOutput(m.sym.FullyConnected(
            m.sym.var("data"), num_hidden=16, name="fc1"), name="softmax")
        it = m.io.NDArrayIter(x, y, batch_size=20)
        mgr = m.executor_manager.DataParallelExecutorManager(
            net, m.cpu(), it)
        assert mgr.param_names == ["fc1_weight", "fc1_bias"]
        mgr.set_params({n: m.nd.array(v) for n, v in params.items()}, {})
        mgr.load_data_batch(next(iter(it)))
        mgr.forward(is_train=True)
        mgr.backward()
        grads.append([g[0].asnumpy() for g in mgr.execgrp.grad_arrays])
    for g, w in zip(*grads):
        assert float(np.abs(g - w).max()) <= REL * float(np.abs(w).max())
