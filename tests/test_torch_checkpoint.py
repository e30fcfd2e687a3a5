"""Checkpoints in the port against the JAX build, on the CPU: ``.params``
files (``nd.save``/``nd.load``/``nd.load_buffer``, byte for byte and
across the packages), ``ParameterDict``/``Block`` save and load,
``Trainer.save_states``/``load_states`` under a ``MultiFactorScheduler``
(a resumed run equals the uninterrupted one bit for bit, and follows the
JAX build's resumed run step by step), and serving's
``load_params_bytes``."""
import io
import json
import os
import struct
import warnings

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.serving import loader as jloader
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
from incubator_mxnet_tpu_torch.convert import load_numpy_params
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from incubator_mxnet_tpu_torch.serving import loader as tloader

DTYPES = ("float32", "float16", "uint8", "int8", "int32", "int64")


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _values(dtype, shape, seed):
    rs = np.random.RandomState(seed)
    if dtype.startswith("float"):
        return rs.standard_normal(shape).astype(dtype)
    lo, hi = (0, 255) if dtype == "uint8" else (-100, 100)
    return rs.randint(lo, hi, shape).astype(dtype)


def _arrays(pkg, named):
    """One array per dtype the format names (int64 only in the port: the
    JAX build holds no 64-bit arrays), plus a 0-d one."""
    out = {}
    for i, dt in enumerate(DTYPES):
        if dt == "int64" and pkg is jmx:
            continue
        out["p%d_%s" % (i, dt)] = pkg.nd.array(_values(dt, (2, 3 + i), i),
                                               dtype=dt)
    out["scalar"] = pkg.nd.array(np.array(1.5, np.float32))
    return out if named else list(out.values())


def _host(a):
    return np.asarray(a.asnumpy())


@pytest.mark.parametrize("named", [True, False], ids=["named", "list"])
def test_params_files_are_byte_identical(tmp_path, named):
    """The same CPU arrays and names give the same bytes from both
    packages (kCPU context, 0-d written as (1,))."""
    tp, jp = str(tmp_path / "t.params"), str(tmp_path / "j.params")
    tarr = _arrays(tmx, named)
    jarr = _arrays(jmx, named)
    if named:
        tarr.pop("p5_int64")
    else:
        tarr.pop(5)
    tmx.nd.save(tp, tarr)
    jmx.nd.save(jp, jarr)
    assert open(tp, "rb").read() == open(jp, "rb").read()


@pytest.mark.parametrize("named", [True, False], ids=["named", "list"])
def test_each_package_loads_the_others_file(tmp_path, named):
    """Port -> JAX and JAX -> port for every dtype the format names, with
    and without names; 64-bit ints load as int32 in both (no 64-bit
    types in the JAX build; the port's nd.array narrows alike)."""
    tp, jp = str(tmp_path / "t.params"), str(tmp_path / "j.params")
    tmx.nd.save(tp, _arrays(tmx, named))
    jmx.nd.save(jp, _arrays(jmx, named))
    for path in (tp, jp):
        got, want = tmx.nd.load(path), jmx.nd.load(path)
        if named:
            assert list(got) == list(want)
            got, want = list(got.values()), list(want.values())
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.context == tmx.cpu()
            assert tmx.base.dtype_name(g._data.dtype) == str(w.dtype)
            np.testing.assert_array_equal(_host(g), _host(w))
    loaded = tmx.nd.load(tp)
    src = _arrays(tmx, named)
    for g, s in zip(loaded.values() if named else loaded,
                    src.values() if named else src):
        np.testing.assert_array_equal(_host(g).reshape(-1),
                                      _host(s).reshape(-1))


def test_bfloat16_widens_with_a_warning(tmp_path):
    path = str(tmp_path / "bf.params")
    x = _values("float32", (3, 4), 9)
    with pytest.warns(UserWarning, match="bfloat16 has no MXNet 1.x"):
        tmx.nd.save(path, {"w": tmx.nd.array(x, dtype="bfloat16")})
    got = tmx.nd.load(path)["w"]
    assert got._data.dtype == torch.float32
    np.testing.assert_array_equal(
        _host(got), tmx.nd.array(x, dtype="bfloat16").asnumpy())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jmx.nd.save(str(tmp_path / "j.params"),
                    {"w": jmx.nd.array(x, dtype="bfloat16")})
    assert open(path, "rb").read() == \
        open(str(tmp_path / "j.params"), "rb").read()


def _container(records, names=()):
    out = [struct.pack("<QQQ", 0x112, 0, len(records))] + list(records)
    out.append(struct.pack("<Q", len(names)))
    for n in names:
        out += [struct.pack("<Q", len(n)), n.encode()]
    return b"".join(out)


def test_legacy_records_and_containers_load(tmp_path):
    """A V1 record (magic 0xF993FAC8, int64 dims), a pre-V1 record (ndim
    first, uint32 dims) and the JAX build's earlier npz container load in
    both packages alike; ``load_buffer`` equals ``load``."""
    a = _values("float32", (2, 3), 1)
    b = _values("int32", (4,), 2)
    v1 = (struct.pack("<IIqq", 0xF993FAC8, 2, 2, 3) + struct.pack("<iii", 1,
                                                                  0, 0)
          + a.tobytes())
    pre = struct.pack("<II", 1, 4) + struct.pack("<iii", 1, 0, 4) + \
        b.tobytes()
    buf = _container([v1, pre], ["a", "b"])
    path = str(tmp_path / "legacy.params")
    open(path, "wb").write(buf)
    for loaded in (tmx.nd.load(path), tmx.nd.load_buffer(buf)):
        np.testing.assert_array_equal(_host(loaded["a"]), a)
        np.testing.assert_array_equal(_host(loaded["b"]), b)
    want = jmx.nd.load(path)
    np.testing.assert_array_equal(_host(want["a"]), a)
    manifest = {"entries": [{"idx": 0, "name": "w", "stype": "default",
                             "shape": [2, 3]}]}
    npz = io.BytesIO()
    np.savez(npz, __manifest__=np.frombuffer(json.dumps(manifest).encode(),
                                             np.uint8), a0_data=a)
    npz_path = str(tmp_path / "old.params")
    open(npz_path, "wb").write(npz.getvalue())
    np.testing.assert_array_equal(_host(tmx.nd.load(npz_path)["w"]), a)
    np.testing.assert_array_equal(_host(jmx.nd.load(npz_path)["w"]), a)


def test_load_buffer_matches_load(tmp_path):
    """The contract of tests/test_serving.py::test_load_buffer_matches_load
    held for the port, and serving's load_params_bytes over it splits the
    arg:/aux: prefixes as the JAX build's."""
    path = str(tmp_path / "m.params")
    rs = np.random.RandomState(0)
    arrays = {"arg:fc_weight": rs.standard_normal((4, 3)).astype(np.float32),
              "arg:fc_bias": rs.standard_normal((4,)).astype(np.float32),
              "aux:bn_running_mean": rs.standard_normal((3,)).astype(
                  np.float32)}
    tmx.nd.save(path, {k: tmx.nd.array(v) for k, v in arrays.items()})
    raw = open(path, "rb").read()
    a, b = tmx.nd.load(path), tmx.nd.load_buffer(raw)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(_host(a[k]), _host(b[k]))
    args, aux = tloader.load_params_bytes(raw)
    jargs, jaux = jloader.load_params_bytes(raw)
    assert sorted(args) == sorted(jargs) == ["fc_bias", "fc_weight"]
    assert sorted(aux) == sorted(jaux) == ["bn_running_mean"]
    for k in args:
        np.testing.assert_array_equal(_host(args[k]), _host(jargs[k]))
    with pytest.raises(ValueError, match="named"):
        tloader.load_params_bytes(_container([]))


def test_sparse_record_raises_naming_item_10():
    """A row-sparse record written by hand (item 10 ported sparse storage:
    it loads, as in the JAX build); a record of an unknown storage type and
    a bad magic raise."""
    rec = (struct.pack("<Ii", 0xF993FAC9, 1) + struct.pack("<Iq", 1, 2)
           + struct.pack("<Iq", 1, 5) + struct.pack("<iii", 1, 0, 0)
           + struct.pack("<iIq", 6, 1, 2) + np.ones(2, np.float32).tobytes()
           + np.arange(2, dtype=np.int64).tobytes())
    got = tmx.nd.load_buffer(_container([rec]))[0]
    want = jmx.nd.load_buffer(_container([rec]))[0]
    assert got.stype == want.stype == "row_sparse"
    np.testing.assert_array_equal(_host(got.indices), [0, 1])
    np.testing.assert_array_equal(_host(got), _host(want))
    odd = struct.pack("<Ii", 0xF993FAC9, 3) + rec[8:]
    with pytest.raises(tmx.MXNetError, match="storage type 3"):
        tmx.nd.load_buffer(_container([odd]))
    with pytest.raises(ValueError, match="bad magic"):
        tmx.nd.load_buffer(struct.pack("<QQ", 7, 0))


@pytest.mark.parametrize("named", [True, False], ids=["named", "list"])
def test_sparse_params_bytes_equal_the_jax_build(tmp_path, named):
    """Row-sparse and CSR arrays (an empty one, an f16 one, a 3-d
    row-sparse one) beside a dense one: the port's ``.params`` bytes equal
    the JAX build's for the same arrays; each package loads the other's
    file to the same components; the legacy npz container's sparse
    entries load too."""
    rs = np.random.RandomState(0)
    a = rs.standard_normal((6, 4)).astype(np.float32)
    a *= rs.rand(6, 4) < 0.4
    a[2] = 0
    b = rs.standard_normal((5, 2, 3)).astype(np.float16)
    b[[0, 3]] = 0

    def arrays(m):
        sp = m.nd.sparse
        out = {"rsp": sp.row_sparse_array(a), "csr": sp.csr_matrix(a),
               "rsp3": m.nd.array(b, dtype="float16").tostype("row_sparse"),
               "empty": sp.zeros("csr", (3, 7)),
               "dense": m.nd.array(a)}
        return out if named else list(out.values())
    paths = {}
    for m, tag in ((tmx, "t"), (jmx, "j")):
        paths[tag] = str(tmp_path / ("%s.params" % tag))
        m.nd.save(paths[tag], arrays(m))
    raw = open(paths["t"], "rb").read()
    assert raw == open(paths["j"], "rb").read()
    for src in paths.values():
        got, want = tmx.nd.load(src), jmx.nd.load(src)
        pairs = zip(got.values(), want.values()) if named else \
            zip(got, want)
        for g, w in pairs:
            assert g.stype == w.stype
            np.testing.assert_array_equal(_host(g), _host(w))
            for k in ("indices", "indptr", "data"):
                if hasattr(w, k):
                    np.testing.assert_array_equal(_host(getattr(g, k)),
                                                  _host(getattr(w, k)))
    manifest = {"entries": [
        {"idx": 0, "name": "r", "stype": "row_sparse", "shape": [6, 4]},
        {"idx": 1, "name": "c", "stype": "csr", "shape": [6, 4]}]}
    jr, jc = jmx.nd.sparse.row_sparse_array(a), jmx.nd.sparse.csr_matrix(a)
    npz = io.BytesIO()
    np.savez(npz, __manifest__=np.frombuffer(json.dumps(manifest).encode(),
                                             np.uint8),
             a0_data=_host(jr.data), a0_indices=_host(jr.indices),
             a1_data=_host(jc.data), a1_indices=_host(jc.indices),
             a1_indptr=_host(jc.indptr))
    npz_path = str(tmp_path / "old.params")
    open(npz_path, "wb").write(npz.getvalue())
    got, want = tmx.nd.load(npz_path), jmx.nd.load(npz_path)
    for k, stype in (("r", "row_sparse"), ("c", "csr")):
        assert got[k].stype == want[k].stype == stype
        np.testing.assert_array_equal(_host(got[k]), a)
        np.testing.assert_array_equal(_host(want[k]), a)


def test_a_crash_before_the_rename_leaves_the_old_file(tmp_path,
                                                       monkeypatch):
    """save writes a temporary file, fsyncs it, then renames it over the
    target: a crash between the two leaves the old bytes and no
    temporary file."""
    path = str(tmp_path / "ck.params")
    tmx.nd.save(path, {"w": tmx.nd.array(np.ones(3, np.float32))})
    old = open(path, "rb").read()
    synced = []
    real_fsync = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: (synced.append(fd),
                                                 real_fsync(fd)))

    def crash(src, dst):
        raise OSError("crashed before the rename")
    monkeypatch.setattr(os, "replace", crash)
    with pytest.raises(OSError, match="before the rename"):
        tmx.nd.save(path, {"w": tmx.nd.array(np.zeros(3, np.float32))})
    assert synced and open(path, "rb").read() == old
    assert os.listdir(str(tmp_path)) == ["ck.params"]


# -- Block and ParameterDict --------------------------------------------------

def _mlp(pkg, seed, prefix="mlp_"):
    pkg.random.seed(seed)
    net = pkg.gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(16, activation="relu"))
        net.add(pkg.gluon.nn.Dense(10))
    net.initialize(pkg.init.Xavier())
    return net


def test_parameter_dict_prefixes_and_in_place_load(tmp_path):
    """save strips the prefix, load restores another; an initialized
    parameter is overwritten in place (same array, grad buffer kept);
    missing and extra names raise unless allowed."""
    path = str(tmp_path / "mlp.params")
    a = _mlp(tmx, 1)
    a(tmx.nd.array(np.ones((2, 8), np.float32)))
    a.save_params(path)
    names = sorted(tmx.nd.load(path))
    assert names == ["dense0_bias", "dense0_weight", "dense1_bias",
                     "dense1_weight"]
    b = _mlp(tmx, 2, prefix="other_")
    b(tmx.nd.array(np.ones((2, 8), np.float32)))
    w = b.collect_params()["other_dense0_weight"]
    before = w.data()
    b.load_params(path)
    assert w.data() is before and w.grad() is not None
    for (_, pa), (_, pb) in zip(sorted(a.collect_params().items()),
                                sorted(b.collect_params().items())):
        np.testing.assert_array_equal(pa.data().asnumpy(),
                                      pb.data().asnumpy())
    c = _mlp(tmx, 3, prefix="c_")
    c.collect_params().load(path, tmx.cpu(), restore_prefix="c_")
    assert c.collect_params()["c_dense1_bias"].shape == (10,)
    tmx.nd.save(path, {"dense0_weight": tmx.nd.zeros((16, 8)),
                       "extra": tmx.nd.zeros((1,))})
    with pytest.raises(ValueError, match="missing"):
        b.load_params(path)
    with pytest.raises(ValueError, match="not present"):
        b.load_params(path, allow_missing=True)
    b.load_params(path, allow_missing=True, ignore_extra=True)
    assert not b.collect_params()["other_dense0_weight"].data().asnumpy(
    ).any()


def _small_resnets():
    """The small ResNet of both packages with the same seeded weights (He
    scaled normals; BatchNorm statistics away from their defaults)."""
    rs = np.random.RandomState(0)
    x = rs.standard_normal((4, 3, 32, 32)).astype(np.float32)
    jnet = jvision.resnet50_v1(thumbnail=True, classes=10)
    jnet.initialize(jmx.init.Zero())
    with jmx.autograd.predict_mode():
        jnet(jmx.nd.array(x))
    params = {}
    for name, p in jnet.collect_params().items():
        shape = p.data().shape
        if name.endswith(("gamma", "running_var")):
            v = rs.uniform(0.5, 1.5, shape)
        elif name.endswith(("beta", "running_mean", "bias")):
            v = 0.1 * rs.standard_normal(shape)
        else:
            v = rs.standard_normal(shape) / np.sqrt(np.prod(shape[1:]) / 2)
        params[name] = v.astype(np.float32)
        p.set_data(jmx.nd.array(params[name]))
    tnet = tvision.resnet50_v1(thumbnail=True, classes=10)
    load_numpy_params(tnet, params, tmx.cpu())
    return x, jnet, tnet


def test_small_resnet_params_cross_between_the_packages(tmp_path):
    """A port-written file loaded into the JAX build's net gives the JAX
    build's logits, and the other way round (inference mode, the running
    statistics included)."""
    x, jnet, tnet = _small_resnets()
    with jmx.autograd.predict_mode():
        jlog = jnet(jmx.nd.array(x)).asnumpy()
    with tmx.autograd.predict_mode():
        tlog = tnet(tmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(tlog, jlog, rtol=0,
                               atol=1e-5 * np.abs(jlog).max())
    tp, jp = str(tmp_path / "t.params"), str(tmp_path / "j.params")
    tnet.save_params(tp)
    jnet.save_params(jp)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    j2 = jvision.resnet50_v1(thumbnail=True, classes=10)
    j2.load_params(tp, ctx=jmx.cpu())
    t2 = tvision.resnet50_v1(thumbnail=True, classes=10)
    t2.load_params(jp, ctx=tmx.cpu())
    with jmx.autograd.predict_mode():
        np.testing.assert_array_equal(j2(jmx.nd.array(x)).asnumpy(), jlog)
    with tmx.autograd.predict_mode():
        np.testing.assert_array_equal(t2(tmx.nd.array(x)).asnumpy(), tlog)


# -- resume ------------------------------------------------------------------

SCHED_STEPS = [2, 4]
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


def _trainer(pkg, net):
    sched = pkg.lr_scheduler.MultiFactorScheduler(step=list(SCHED_STEPS),
                                                  factor=0.1)
    return pkg.gluon.Trainer(net.collect_params(), "sgd",
                             dict(OPT, lr_scheduler=sched))


def _step(pkg, net, tr, x, y):
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    with pkg.autograd.record():
        loss = loss_fn(net(pkg.nd.array(x)), pkg.nd.array(y))
    loss.backward()
    tr.step(x.shape[0])
    return loss.asnumpy()


def _state(net, tr):
    """Every parameter (running statistics included), every momentum and
    the update count, as host values."""
    params = {n[len(net.prefix):]: p.data().asnumpy().copy()
              for n, p in net.collect_params().items()}
    moms = {}
    for i, s in tr._updaters[0].states.items():
        moms[i] = s.asnumpy().copy() if hasattr(s, "asnumpy") else \
            np.array(s)
    return params, moms, tr._optimizer.num_update


def _run(pkg, make_net, x, y, tmp_path, tag):
    """Run A: 3 steps, save_params + save_states, 3 more; run B: a net of
    another seed, load both, the same 3 steps.  Returns A's and B's
    states and losses, and B's state right after loading."""
    p = str(tmp_path / ("%s.params" % tag))
    s = str(tmp_path / ("%s.states" % tag))
    net = make_net(1)
    tr = _trainer(pkg, net)
    losses_a = [_step(pkg, net, tr, x, y) for _ in range(3)]
    net.save_params(p)
    tr.save_states(s)
    saved = _state(net, tr)
    lrs_a = []
    for _ in range(3):
        losses_a.append(_step(pkg, net, tr, x, y))
        lrs_a.append(tr._optimizer._get_lr(0))
    end_a = _state(net, tr)
    net_b = make_net(2)
    tr_b = _trainer(pkg, net_b)
    net_b.load_params(p, ctx=pkg.cpu())
    tr_b.load_states(s)
    loaded = _state(net_b, tr_b)
    losses_b, lrs_b = [], []
    for _ in range(3):
        losses_b.append(_step(pkg, net_b, tr_b, x, y))
        lrs_b.append(tr_b._optimizer._get_lr(0))
    return dict(saved=saved, loaded=loaded, end_a=end_a,
                end_b=_state(net_b, tr_b), losses_a=losses_a,
                losses_b=losses_b, lrs_a=lrs_a, lrs_b=lrs_b)


def _assert_states_equal(a, b):
    pa, ma, na = a
    pb, mb, nb = b
    assert na == nb and sorted(pa) == sorted(pb) and sorted(ma) == sorted(mb)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
    for k in ma:
        np.testing.assert_array_equal(ma[k], mb[k], err_msg=str(k))


def _mlp_data():
    rs = np.random.RandomState(5)
    return (rs.standard_normal((6, 8)).astype(np.float32),
            rs.randint(0, 10, (6,)).astype(np.float32))


@pytest.mark.parametrize("model", ["mlp", "small_resnet"])
def test_resumed_run_equals_the_uninterrupted_one(tmp_path, model):
    """Run B, resumed from A's files in a net of another seed, equals A
    bit for bit: the loaded state, every step's loss and learning rate
    (the schedule crosses the checkpoint: 0.1, 0.01, 0.001), and the end
    state."""
    if model == "mlp":
        x, y = _mlp_data()

        def make(seed):
            return _mlp(tmx, seed)
    else:
        rs = np.random.RandomState(1)
        x = rs.standard_normal((4, 3, 32, 32)).astype(np.float32)
        y = rs.randint(0, 10, (4,)).astype(np.float32)

        def make(seed):
            tmx.random.seed(seed)
            net = tvision.resnet50_v1(thumbnail=True, classes=10)
            net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
            return net
    r = _run(tmx, make, x, y, tmp_path, model)
    _assert_states_equal(r["saved"], r["loaded"])
    for la, lb in zip(r["losses_a"][3:], r["losses_b"]):
        np.testing.assert_array_equal(la, lb)
    assert r["lrs_a"] == r["lrs_b"]
    np.testing.assert_allclose(r["lrs_a"], [0.01, 0.001, 0.001], rtol=1e-12)
    _assert_states_equal(r["end_a"], r["end_b"])


def test_resumed_run_follows_the_jax_build_step_by_step(tmp_path):
    """The MLP's run B in both packages from the same file: the JAX build
    writes the checkpoint, the port loads it (the .params file crosses;
    the states file holds the JAX build's pickled objects, so the port's
    optimizer state is set from the JAX build's arrays), and each resumed
    step is taken from the JAX build's state before it: the same loss,
    learning rate, weights and momentum."""
    x, y = _mlp_data()
    r = _run(jmx, lambda seed: _mlp(jmx, seed), x, y, tmp_path, "jax")
    net = _mlp(tmx, 7)
    net(tmx.nd.array(x))
    tr = _trainer(tmx, net)
    p = str(tmp_path / "jax.params")
    net.load_params(p, ctx=tmx.cpu())
    tr._optimizer.num_update = r["saved"][2]
    tr._optimizer._index_update_count = dict.fromkeys(
        range(len(tr._params)), r["saved"][2])
    before = r["saved"]
    trajectory = list(zip(r["losses_b"], r["lrs_b"]))
    steps = [before]
    jnet = _mlp(jmx, 2)
    jtr = _trainer(jmx, jnet)
    jnet.load_params(p, ctx=jmx.cpu())
    jtr.load_states(str(tmp_path / "jax.states"))
    for _ in range(3):
        _step(jmx, jnet, jtr, x, y)
        steps.append(_state(jnet, jtr))
    for (loss_want, lr_want), b, after in zip(trajectory, steps, steps[1:]):
        params, moms, _ = b
        for n, prm in net.collect_params().items():
            prm.set_data(tmx.nd.array(params[n[len(net.prefix):]]))
        for i, m in moms.items():
            tr._updaters[0].ensure_state(i, tr._params[i].data())
            tr._updaters[0].states[i][:] = tmx.nd.array(m)
        loss = _step(tmx, net, tr, x, y)
        np.testing.assert_allclose(loss, loss_want, rtol=1e-6, atol=1e-7)
        assert tr._optimizer._get_lr(0) == pytest.approx(lr_want,
                                                         rel=1e-12)
        got = _state(net, tr)
        for k, v in after[0].items():
            np.testing.assert_allclose(got[0][k], v, rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        for i, v in after[1].items():
            np.testing.assert_allclose(got[1][i], v, rtol=1e-5, atol=1e-7)
        assert got[2] == after[2]
