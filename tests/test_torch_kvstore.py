"""The port's single-card KVStore against the JAX build's, on the CPU: push
and pull of int and str keys with lists of 1-4 values (bit-equal: the
same f32 sums in the same order), an updater and ``set_optimizer`` (sgd,
adam) on the store, the optimizer-state file within each package,
``create_kvstore``'s resolution table, the paths that raise; and the
wiring of ``example/image-classification/common.py`` (``fit_module``,
``fit_gluon``) through a ``"device"`` store on both packages, the port's
side being ``chip_smoke.py``'s copy of it.  Card tests call phase 10's
functions of ``chip_smoke.py`` at small sizes."""
import collections
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.base import MXNetError

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent.parent
SHAPE = (3, 5)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _arrays(seed, n, dtype=np.float32):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal(SHAPE).astype(dtype) for _ in range(n)]


def _nd(m, a):
    return m.nd.array(a, dtype=a.dtype)


@pytest.mark.parametrize("key", [3, "w"])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_push_pull_matches_jax(key, n):
    """``push`` sums a list in its order into the store; ``pull`` writes
    the store's value into every out: bit-equal to the JAX build's."""
    init, = _arrays(0, 1)
    vals = _arrays(n, n)
    got = []
    for m in (jmx, tmx):
        kv = m.kv.create("device")
        kv.init(key, _nd(m, init))
        kv.push(key, [_nd(m, v) for v in vals] if n > 1 else _nd(m, vals[0]))
        outs = [m.nd.zeros(SHAPE) for _ in range(2)]
        kv.pull(key, out=outs)
        got.append([o.asnumpy() for o in outs])
    want = vals[0]
    for v in vals[1:]:
        want = want + v
    for j, t in zip(*got):
        np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(t, want)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_push_keeps_the_store_dtype_and_lists_of_keys(dtype):
    """Values of another dtype are summed in theirs and stored in the
    store's (f32); several keys in one call; push_many/pull_many."""
    keys = [0, "b", 2]
    inits = _arrays(10, 3)
    vals = [_arrays(20 + i, 2, np.dtype(dtype)) for i in range(3)]
    got = []
    for m in (jmx, tmx):
        kv = m.kv.create("local")
        kv.init(keys, [_nd(m, a) for a in inits])
        kv.push_many(keys, [[_nd(m, v) for v in vl] for vl in vals])
        outs = [[m.nd.zeros(SHAPE)] for _ in keys]
        kv.pull_many(keys, outs)
        got.append([o[0].asnumpy() for o in outs])
    for j, t, vl in zip(*got, vals):
        assert t.dtype == np.float32
        np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(t, (vl[0] + vl[1]).astype(np.float32))


def test_updater_on_the_store_matches_jax():
    """With an updater, each push updates the store's copy (server
    semantics), keyed by the int key."""
    init, = _arrays(30, 1)
    grads = _arrays(31, 4)
    got, seen = [], []
    for m in (jmx, tmx):
        kv = m.kv.create("device")
        kv.init(5, _nd(m, init))
        keys = []

        def upd(key, grad, stored, keys=keys):
            keys.append(key)
            stored[:] = stored * 0.5 + grad

        kv.set_updater(upd)
        for i in range(0, 4, 2):
            kv.push(5, [_nd(m, grads[i]), _nd(m, grads[i + 1])])
        out = m.nd.zeros(SHAPE)
        kv.pull(5, out=out)
        got.append(out.asnumpy())
        seen.append(keys)
    np.testing.assert_array_equal(got[1], got[0])
    assert seen[0] == seen[1] == [5, 5]


@pytest.mark.parametrize("name,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-3})])
def test_set_optimizer_matches_jax_and_the_updater_by_hand(name, params):
    """``set_optimizer``: each push is one update of the store's copy,
    bit-equal to ``opt.get_updater`` applied by hand in the port and
    within 1e-6 (relative) of the JAX build's store."""
    init, = _arrays(40, 1)
    grads = _arrays(41, 6)
    got = []
    for m in (jmx, tmx):
        kv = m.kv.create("device")
        kv.init("p", _nd(m, init))
        kv.set_optimizer(m.optimizer.create(name, rescale_grad=0.5,
                                            **params))
        for i in range(0, 6, 2):
            kv.push("p", [_nd(m, grads[i]), _nd(m, grads[i + 1])])
        out = m.nd.zeros(SHAPE)
        kv.pull("p", out=out)
        got.append(out.asnumpy())
    upd = tmx.optimizer.get_updater(
        tmx.optimizer.create(name, rescale_grad=0.5, **params))
    w = tmx.nd.array(init)
    for i in range(0, 6, 2):
        upd("p", tmx.nd.array(grads[i]) + tmx.nd.array(grads[i + 1]), w)
    np.testing.assert_array_equal(got[1], w.asnumpy())
    np.testing.assert_allclose(got[1], got[0], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_optimizer_state_file_round_trip(package, tmp_path):
    """``save_optimizer_states``/``load_optimizer_states`` within each
    package: a store restored from the file continues bit-equal."""
    m = jmx if package == "jax" else tmx
    init, = _arrays(50, 1)
    grads = _arrays(51, 4)

    def store(value):
        kv = m.kv.create("device")
        kv.init(0, _nd(m, value))
        kv.set_optimizer(m.optimizer.create("sgd", learning_rate=0.1,
                                            momentum=0.9))
        return kv

    a = store(init)
    for g in grads[:2]:
        a.push(0, _nd(m, g))
    path = str(tmp_path / "kv.states")
    a.save_optimizer_states(path)
    now = m.nd.zeros(SHAPE)
    a.pull(0, out=now)
    b = store(now.asnumpy())
    b.load_optimizer_states(path)
    for g in grads[2:]:
        a.push(0, _nd(m, g))
        b.push(0, _nd(m, g))
    outs = [m.nd.zeros(SHAPE) for _ in range(2)]
    a.pull(0, out=outs[0])
    b.pull(0, out=outs[1])
    np.testing.assert_array_equal(outs[1].asnumpy(), outs[0].asnumpy())


_Shape = collections.namedtuple("_Shape", "shape")


def _resolve(m, spec, num_device, big=False):
    if spec == "store":
        spec = m.kv.create("device")
    params = {"w": _Shape((17 * 1024 * 1024,) if big else (4, 4))}
    kv, on = m.kv.create_kvstore(spec, num_device, params)
    return (None if kv is None else kv.type), on


@pytest.mark.parametrize("env", [None, "0", "1", "x"])
@pytest.mark.parametrize("spec", [None, "local", "device", "nccl", "store"])
def test_create_kvstore_resolution_matches_jax(spec, env, monkeypatch):
    """(store type or None, update_on_kvstore) for None / a type name / a
    store object on one device, under MXNET_UPDATE_ON_KVSTORE unset, 0, 1
    and not a number; and a ``"local"`` store over two devices with a
    parameter above 16M elements keeps the update local."""
    if env is None:
        monkeypatch.delenv("MXNET_UPDATE_ON_KVSTORE", raising=False)
    else:
        monkeypatch.setenv("MXNET_UPDATE_ON_KVSTORE", env)
    assert _resolve(tmx, spec, 1) == _resolve(jmx, spec, 1)
    for big in (False, True):
        assert _resolve(tmx, "local", 2, big) == _resolve(jmx, "local", 2,
                                                          big)
    if env in (None, "1", "x"):
        assert _resolve(tmx, "local", 2, True) == ("local", False)
        assert _resolve(tmx, "store", 1) == ("device", True)


def test_identity_and_raising_paths():
    kv = tmx.kv.create("nccl")
    jkv = jmx.kv.create("nccl")
    assert (kv.type, kv.rank, kv.num_workers) == \
        (jkv.type, jkv.rank, jkv.num_workers) == ("device", 0, 1)
    assert tmx.kv.create().type == "local" == jmx.kv.create().type
    for name in ("local_update_cpu", "local_allreduce_cpu",
                 "local_allreduce_device"):
        assert tmx.kv.create(name).type == "local"
    assert kv.barrier() is None and kv.quiesce() == 0 == jkv.quiesce()
    assert kv.send_command_to_servers(0, "x") is None
    with pytest.raises(TypeError):
        tmx.kv.create(3)
    with pytest.raises(ValueError, match="Unknown KVStore type"):
        tmx.kv.create("tree")
    # without a launcher a dist store is rank 0 of 1, as in the JAX build
    for name in ("dist_sync", "dist_async", "dist_device_sync"):
        dkv, jdkv = tmx.kv.create(name), jmx.kv.create(name)
        assert (dkv.type, dkv.rank, dkv.num_workers) == \
            (jdkv.type, jdkv.rank, jdkv.num_workers) == (name, 0, 1)
        if name == "dist_async":
            dkv.close()
            jdkv.close()
    with pytest.raises(TypeError, match="kvstore must be"):
        tmx.kv.create_kvstore(3.0, 1, {})
    kv.init(0, tmx.nd.ones(SHAPE))
    with pytest.raises(ValueError, match="duplicate init"):
        kv.init(0, tmx.nd.ones(SHAPE))
    with pytest.raises(MXNetError, match="not been initialized"):
        kv.push(1, tmx.nd.ones(SHAPE))
    with pytest.raises(MXNetError, match="not been initialized"):
        kv.pull(1, out=tmx.nd.ones(SHAPE))
    # row_sparse_pull came with item 10 (tests/test_torch_sparse.py)
    with pytest.raises(MXNetError, match="not been initialized"):
        kv.row_sparse_pull(1, out=tmx.nd.ones(SHAPE),
                           row_ids=tmx.nd.array([0]))
    with pytest.raises(ValueError, match="row_ids"):
        kv.row_sparse_pull(0, out=tmx.nd.ones(SHAPE))
    with pytest.raises(MXNetError, match="item 12"):
        kv.set_gradient_compression({"type": "2bit"})
    with pytest.raises(MXNetError, match="set_optimizer"):
        kv.save_optimizer_states("unused")
    with pytest.raises(MXNetError, match="item 12"):
        tmx.gluon.Trainer([], "sgd", compression_params={"type": "2bit"})


# -- the wiring of example/image-classification/common.py ----------------------

def _jax_common():
    path = ROOT / "example" / "image-classification" / "common.py"
    spec = importlib.util.spec_from_file_location("_jax_common", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _numpy_xavier(m, seed):
    """``m.init.Xavier``'s stand-in: uniform Xavier draws from one numpy
    stream, so that both packages start from the same weights (their own
    generators differ)."""
    class NumpyXavier(m.init.Initializer):
        rs = np.random.RandomState(seed)

        def __init__(self, **kwargs):
            super().__init__(**kwargs)

        def _init_weight(self, name, arr):
            shape = arr.shape
            fan_in = int(np.prod(shape[1:]))
            fan_out = shape[0] * int(np.prod(shape[2:]))
            s = np.sqrt(6.0 / (fan_in + fan_out))
            arr[:] = self.rs.uniform(-s, s, shape).astype(np.float32)

    return NumpyXavier


def _mlp_symbol(m):
    data = m.sym.Variable("data")
    net = m.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = m.sym.Activation(net, act_type="relu", name="relu1")
    net = m.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return m.sym.SoftmaxOutput(net, name="softmax")


def _mlp_gluon(m):
    net = m.gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(m.gluon.nn.Flatten(), m.gluon.nn.Dense(16, activation="relu"),
                m.gluon.nn.Dense(4))
    return net


@pytest.mark.parametrize("surface", ["fit_module", "fit_gluon"])
def test_common_wiring_matches_jax(surface, monkeypatch):
    """The MLP through ``fit_module``/``fit_gluon`` with
    ``mx.kv.create("device")``: the port through chip_smoke.py's copy,
    the JAX build through common.py itself, from the same weights and
    batches: the same accuracy and final weights within 1e-5 (relative
    to the largest)."""
    common = _jax_common()
    rs = np.random.RandomState(3)
    x = rs.standard_normal((48, 1, 2, 3)).astype(np.float32)
    y = (x.reshape(48, -1).sum(1) > 0).astype(np.float32) * 2
    args = SimpleNamespace(batch_size=8, num_epochs=2, lr=0.05,
                           momentum=0.9, wd=1e-4, optimizer="sgd",
                           kv_store="device", disp_batches=3)
    monkeypatch.setattr(tmx.context.Context, "default_ctx",
                        staticmethod(tmx.cpu))
    weights = []
    for m in (jmx, tmx):
        xavier = _numpy_xavier(m, 9)
        monkeypatch.setattr(m.init, "Xavier", xavier)
        monkeypatch.setitem(m.initializer._INIT_REGISTRY, "numpyxavier",
                            xavier)
        train = m.io.NDArrayIter(x[:40], y[:40], 8,
                                 label_name="softmax_label")
        val = m.io.NDArrayIter(x[40:], y[40:], 8, label_name="softmax_label")
        if surface == "fit_module":
            net = _mlp_symbol(m)
            if m is jmx:
                acc = common.fit_module(net, train, val, args)
            else:
                acc = cs.fit_module(m, net, train, val, args,
                                    on_step=_MODULES.append)
            trail = [p.asnumpy() for _, p in sorted(
                _MODULES[-1].get_params()[0].items())]
        else:
            net = _mlp_gluon(m)
            if m is jmx:
                acc = common.fit_gluon(net, train, val, args)
            else:
                acc = cs.fit_gluon(m, net, train, val, args)
            trail = [p.data().asnumpy() for _, p in sorted(
                net.collect_params().items())]
        weights.append((acc, trail))
    (jacc, jw), (tacc, tw) = weights
    assert tacc == jacc
    assert len(tw) == len(jw) > 0
    for t, j in zip(tw, jw):
        err = np.abs(t - j).max() / max(np.abs(j).max(), 1e-30)
        assert err <= 1e-5, err


_MODULES = []


@pytest.fixture(autouse=True)
def _keep_jax_module(monkeypatch):
    """Keep the last Module (common.py returns only the accuracy), and
    apply MXNet 1.2's wd rule by name to the JAX build's optimizer as the
    port does (ROADMAP C8; the JAX build decays biases too)."""
    fit = jmx.mod.Module.fit

    def keeping_fit(self, *args, **kwargs):
        _MODULES.append(self)
        return fit(self, *args, **kwargs)

    init = jmx.optimizer.Optimizer.__init__

    def mxnet_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.set_wd_mult({})

    monkeypatch.setattr(jmx.mod.Module, "fit", keeping_fit)
    monkeypatch.setattr(jmx.optimizer.Optimizer, "__init__", mxnet_init)
    yield
    _MODULES.clear()


# -- phase 10 on the card --------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_card_store_push_pull_and_optimizer(card, monkeypatch):
    """10a at a small shape."""
    monkeypatch.setattr(cs, "KV_SHAPE", (64, 96))
    with tmx.gpu(0):
        out = cs.kv_on_card(tmx, "card test")
    assert all(out["sums"].values()) and all(out["updates"])
    assert out["states_round_trip"]


@pytest.mark.cuda
def test_card_baseline_config1_small(card, monkeypatch):
    """10b with fewer images: every net's steps bit-equal with and without
    a store on the card."""
    monkeypatch.setattr(cs, "MNIST_SYNTH", 200)
    monkeypatch.setattr(cs, "FIT_ARGS", dict(cs.FIT_ARGS, batch_size=16))
    with tmx.gpu(0):
        out = cs.baseline_config1(tmx, "card test")
    assert all(r["equal_steps"] == r["steps"] > 0 for r in out.values())


@pytest.mark.cuda
def test_card_baseline_config2_small(card, monkeypatch):
    """10c at 32x32 images, batch 8, 10 classes."""
    monkeypatch.setattr(cs, "IMAGENET_ARGS", dict(
        cs.IMAGENET_ARGS, batch_size=8, num_batches=3, num_classes=10))
    monkeypatch.setattr(cs, "IMAGENET_SHAPE", (3, 32, 32))
    with tmx.gpu(0):
        out = cs.baseline_config2(tmx, "card test")
    assert all(r["equal_steps"] == r["steps"] > 0 for r in out.values())
