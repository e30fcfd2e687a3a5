"""The port's Module API against the JAX build's, on the CPU: ``fit`` and
``score``, a forward/backward/update loop, ``predict``, input gradients,
``reshape``, optimizer-state files, ``BucketingModule``, the
``FeedForward`` shim, checkpoints written by either package and loaded by
the other, BatchNorm's moving statistics under ``fit``, the callbacks and
the monitor, and serving from a Module, a Symbol and symbol JSON.  Weights
within 1e-5 of the largest reference value (f32, nets without
BatchNorm)."""
import logging
import os

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import serving
from incubator_mxnet_tpu_torch.base import MXNetError

import _torch_symbol_nets as nets

REL = 1e-5
OPT = (("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-3))


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


@pytest.fixture(autouse=True)
def _mxnet_wd_rule(monkeypatch):
    """MXNet 1.2's ``Optimizer.__init__`` ends with ``set_lr_mult({})`` and
    ``set_wd_mult({})``, so under Module a parameter whose name ends in
    neither ``_weight`` nor ``_gamma`` gets wd 0.  The JAX build's leaves
    both dicts empty (every parameter decays; ROADMAP C8), so its side of
    these parity tests applies MXNet's rule by hand.  The nets here carry
    no ``__lr_mult__``/``__wd_mult__`` attributes, so the name rule is all
    of it."""
    init = jmx.optimizer.Optimizer.__init__

    def mxnet_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.set_wd_mult({})

    monkeypatch.setattr(jmx.optimizer.Optimizer, "__init__", mxnet_init)


def close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rel, "%.3e > %.0e" % (err, rel)


def _data(n=24, seed=0, classes=4):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((n, 5)).astype(np.float32),
            rs.randint(0, classes, n).astype(np.float32))


def _syms(name="mlp"):
    builder, _ = nets.NETS[name]
    with nets.fresh_names(jmx, tmx):
        return builder(jmx), builder(tmx)


def _params(sym, seed=1):
    args, aux = nets.values(sym, {"data": (6, 5), "softmax_label": (6,)},
                            seed, labels=4)
    return ({n: v for n, v in args.items() if n not in
             ("data", "softmax_label")}, aux)


def _modules(name="mlp", batch=6, seed=1, **bind):
    jsym, psym = _syms(name)
    args, aux = _params(psym, seed)
    shapes = [("data", (batch, 5))], [("softmax_label", (batch,))]
    pm = tmx.mod.Module(psym, context=tmx.cpu())
    jm = jmx.mod.Module(jsym, context=jmx.cpu())
    pm.bind(*shapes, **bind)
    jm.bind(*shapes, **bind)
    pm.set_params(args, aux)
    jm.set_params({n: jmx.nd.array(v) for n, v in args.items()},
                  {n: jmx.nd.array(v) for n, v in aux.items()})
    return pm, jm


def _iters(x, y, batch, **kw):
    return (jmx.io.NDArrayIter(x, y, batch_size=batch, **kw),
            tmx.io.NDArrayIter(x, y, batch_size=batch, **kw))


def _same_params(pm, jm, rel=REL):
    pa, pb = pm.get_params()
    ja, jb = jm.get_params()
    assert sorted(pa) == sorted(ja) and sorted(pb) == sorted(jb)
    for n in pa:
        close(pa[n].asnumpy(), ja[n].asnumpy(), rel)


def test_fit_and_score_match_jax():
    x, y = _data()
    jsym, psym = _syms()
    args, _ = _params(psym)
    jit, pit = _iters(x, y, 6)
    jm = jmx.mod.Module(jsym, context=jmx.cpu())
    pm = tmx.mod.Module(psym, context=tmx.cpu())
    jm.fit(jit, num_epoch=3, optimizer="sgd", optimizer_params=OPT,
           arg_params={n: jmx.nd.array(v) for n, v in args.items()},
           eval_metric="acc", kvstore=None)
    pm.fit(pit, num_epoch=3, optimizer="sgd", optimizer_params=OPT,
           arg_params=args, eval_metric="acc", kvstore="local")
    _same_params(pm, jm)
    jit.reset()
    pit.reset()
    want = dict(jm.score(jit, ["acc", "ce"]))
    got = dict(pm.score(pit, ["acc", "ce"]))
    assert got["accuracy"] == want["accuracy"]
    close(got["cross-entropy"], want["cross-entropy"])


def test_forward_backward_update_loop_matches_jax():
    x, y = _data(30, 3)
    pm, jm = _modules()
    for m in (pm, jm):
        m.init_optimizer(kvstore=None, optimizer="sgd",
                         optimizer_params=OPT)
    jit, pit = _iters(x, y, 6)
    for _ in range(2):
        for jb, pb in zip(jit, pit):
            jm.forward_backward(jb)
            jm.update()
            pm.forward(pb, is_train=True)
            pm.backward()
            pm.update()
            close(pm.get_outputs()[0].asnumpy(), jm.get_outputs()[0].asnumpy())
        jit.reset()
        pit.reset()
    _same_params(pm, jm)


def test_predict_and_iter_predict_match_jax():
    x, _ = _data(14, 4)
    pm, jm = _modules(for_training=False)
    jit, pit = _iters(x, None, 6)
    got, want = pm.predict(pit), jm.predict(jit)
    assert got.shape == (14, 4)
    close(got.asnumpy(), want.asnumpy())
    pit.reset()
    outs = list(pm.iter_predict(pit))
    assert [o[0][0].shape[0] for o in outs] == [6, 6, 2]
    close(np.concatenate([o[0][0].asnumpy() for o in outs]), want.asnumpy())
    nd_out = pm.predict(tmx.nd.array(x[:6]))
    close(nd_out.asnumpy(), want.asnumpy()[:6])
    lst = pm.predict(pit, merge_batches=False)
    assert len(lst) == 3 and lst[-1][0].shape == (2, 4)


def test_input_grads_match_jax():
    x, y = _data(6, 5)
    pm, jm = _modules(inputs_need_grad=True)
    batch_p = tmx.io.DataBatch([tmx.nd.array(x)], [tmx.nd.array(y)])
    batch_j = jmx.io.DataBatch([jmx.nd.array(x)], [jmx.nd.array(y)])
    pm.forward_backward(batch_p)
    jm.forward_backward(batch_j)
    close(pm.get_input_grads()[0].asnumpy(), jm.get_input_grads()[0].asnumpy())
    assert pm.output_shapes == [("softmax_output", (6, 4))]


def test_reshape_on_a_new_batch_size_matches_jax():
    """A batch of another size re-binds the module and keeps its trained
    weights (MXNet's reshape shares the arrays).  The JAX build's
    ``Module.reshape`` copies in its host parameters without syncing them
    from the executor first, so an update made since is lost; its
    ``get_params`` before each re-binding forward syncs them."""
    x, y = _data(7, 6)
    pm, jm = _modules()
    for m in (pm, jm):
        m.init_optimizer(kvstore=None, optimizer="sgd", optimizer_params=OPT)
    for n in (6, 3, 7):
        pb = tmx.io.DataBatch([tmx.nd.array(x[:n])], [tmx.nd.array(y[:n])])
        jb = jmx.io.DataBatch([jmx.nd.array(x[:n])], [jmx.nd.array(y[:n])])
        jm.get_params()
        pm.forward_backward(pb)
        pm.update()
        jm.forward_backward(jb)
        jm.update()
        assert pm.data_shapes[0].shape == (n, 5)
        close(pm.get_outputs()[0].asnumpy(), jm.get_outputs()[0].asnumpy())
    _same_params(pm, jm)
    pm.reshape([("data", (2, 5))], [("softmax_label", (2,))])
    assert pm._exec_group.execs[0].arg_dict["data"].shape == (2, 5)


def test_optimizer_states_round_trip(tmp_path):
    x, y = _data(24, 7)
    pit = tmx.io.NDArrayIter(x, y, batch_size=6)
    a, _ = _modules()
    a.init_optimizer(kvstore=None, optimizer="sgd", optimizer_params=OPT)
    batches = list(pit)
    for b in batches[:2]:
        a.forward_backward(b)
        a.update()
    a.save_checkpoint(str(tmp_path / "m"), 2, save_optimizer_states=True)
    b_mod = tmx.mod.Module.load(str(tmp_path / "m"), 2,
                                load_optimizer_states=True,
                                context=tmx.cpu())
    b_mod.bind([("data", (6, 5))], [("softmax_label", (6,))])
    b_mod.init_optimizer(kvstore=None, optimizer="sgd", optimizer_params=OPT)
    for m in (a, b_mod):
        for b in batches[2:]:
            m.forward_backward(b)
            m.update()
    for n, v in a.get_params()[0].items():
        np.testing.assert_array_equal(b_mod.get_params()[0][n].asnumpy(),
                                      v.asnumpy())
    a.save_optimizer_states(str(tmp_path / "s"))
    a.load_optimizer_states(str(tmp_path / "s"))


def _bucket_sym_gen(m):
    def sym_gen(key):
        data = m.sym.var("data")
        x = m.sym.FullyConnected(data, num_hidden=4, flatten=False,
                                 name="fc_shared")
        x = m.sym.Activation(x, act_type="relu")
        x = m.sym.FullyConnected(x, num_hidden=3, flatten=False,
                                 name="fc_out")
        x = m.sym.sum(x, axis=1, name="pool%d" % key)
        return m.sym.SoftmaxOutput(x, name="softmax"), ("data",), \
            ("softmax_label",)
    return sym_gen


def test_bucketing_module_matches_jax():
    rs = np.random.RandomState(8)
    init = {"fc_shared_weight": rs.randn(4, 2), "fc_shared_bias": rs.randn(4),
            "fc_out_weight": rs.randn(3, 4), "fc_out_bias": rs.randn(3)}
    init = {k: (0.5 * v).astype(np.float32) for k, v in init.items()}
    mods = []
    for m in (jmx, tmx):
        with nets.fresh_names(m):
            bm = m.mod.BucketingModule(_bucket_sym_gen(m),
                                       default_bucket_key=3,
                                       context=m.cpu())
            bm.bind([("data", (4, 3, 2))], [("softmax_label", (4,))])
            bm.init_params(initializer=m.init.Zero())
            bm.init_optimizer(kvstore=None, optimizer="sgd",
                              optimizer_params=OPT)
            mods.append(bm)
    for step, key in enumerate((3, 2, 3, 2)):
        x = rs.standard_normal((4, key, 2)).astype(np.float32)
        y = rs.randint(0, 3, 4).astype(np.float32)
        for k, (m, bm) in enumerate(zip((jmx, tmx), mods)):
            batch = m.io.DataBatch(
                [m.nd.array(x)], [m.nd.array(y)], bucket_key=key,
                provide_data=[m.io.DataDesc("data", (4, key, 2))],
                provide_label=[m.io.DataDesc("softmax_label", (4,))])
            if step == 0:
                bm.switch_bucket(key, batch.provide_data, batch.provide_label)
                cur = {n: m.nd.array(v) for n, v in init.items()
                       if n in bm._curr_module._param_names}
                bm._curr_module.set_params(cur, {}, allow_missing=True,
                                           force_init=True)
            bm.forward(batch, is_train=True)
            bm.backward()
            bm.update()
    for n in init:
        close(mods[1]._buckets[2]._exec_group.execs[0].arg_dict[n].asnumpy(),
              mods[0]._buckets[2]._exec_group.execs[0].arg_dict[n].asnumpy())
    # the buckets share the parameter arrays
    ex2 = mods[1]._buckets[2]._exec_group.execs[0]
    ex3 = mods[1]._buckets[3]._exec_group.execs[0]
    assert ex2.arg_dict["fc_shared_weight"] is ex3.arg_dict["fc_shared_weight"]
    assert mods[1].symbol.list_arguments() == \
        mods[0].symbol.list_arguments()


def test_feedforward_shim_matches_module():
    x, y = _data(24, 9)
    jsym, psym = _syms()
    args, _ = _params(psym)
    with pytest.warns(DeprecationWarning):
        ff = tmx.model.FeedForward(psym, ctx=tmx.cpu(), num_epoch=2,
                                   numpy_batch_size=6, arg_params=args,
                                   aux_params={}, learning_rate=0.1,
                                   momentum=0.9, wd=1e-3)
    ff.fit(x, y)
    jff = jmx.model.FeedForward(jsym, ctx=jmx.cpu(), num_epoch=2,
                                numpy_batch_size=6, arg_params={
                                    n: jmx.nd.array(v)
                                    for n, v in args.items()},
                                aux_params={}, learning_rate=0.1,
                                momentum=0.9, wd=1e-3)
    jff.fit(x, y)
    for n in args:
        close(ff.arg_params[n].asnumpy(), jff.arg_params[n].asnumpy())
    close(ff.predict(x), jff.predict(x))
    assert ff.score(tmx.io.NDArrayIter(x, y, batch_size=6)) == \
        jff.score(jmx.io.NDArrayIter(x, y, batch_size=6))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_cross_the_packages(tmp_path, writer):
    x, _ = _data(12, 10)
    pm, jm = _modules("mlp_bn", for_training=False)
    prefix = str(tmp_path / "ck")
    src = pm if writer == "port" else jm
    src.save_checkpoint(prefix, 3)
    assert os.path.exists(prefix + "-symbol.json")
    assert os.path.exists(prefix + "-0003.params")
    jl = jmx.mod.Module.load(prefix, 3, context=jmx.cpu())
    pl = tmx.mod.Module.load(prefix, 3, context=tmx.cpu())
    for m in (jl, pl):
        m.bind([("data", (6, 5))], [("softmax_label", (6,))],
               for_training=False)
    want = jl.predict(jmx.io.NDArrayIter(x, batch_size=6)).asnumpy()
    got = pl.predict(tmx.io.NDArrayIter(x, batch_size=6)).asnumpy()
    close(got, want)
    close(pm.predict(tmx.io.NDArrayIter(x, batch_size=6)).asnumpy(), want)
    sym, arg, aux = tmx.model.load_checkpoint(prefix, 3)
    assert sym.tojson() == pm.symbol.tojson()
    assert sorted(aux) == ["bn1_moving_mean", "bn1_moving_var"]
    tmx.model.save_checkpoint(prefix + "2", 1, sym, arg, aux)
    with open(prefix + "2-0001.params", "rb") as f2, \
            open(prefix + "-0003.params", "rb") as f1:
        assert f2.read() == f1.read()


def test_fit_moves_batchnorm_statistics_by_mxnet_formula():
    x, y = _data(6, 11)
    jsym, psym = _syms("mlp_bn")
    args, aux = _params(psym, 12)
    pm = tmx.mod.Module(psym, context=tmx.cpu())
    it = tmx.io.NDArrayIter(x, y, batch_size=6)
    pm.fit(it, num_epoch=1, arg_params=args, aux_params=aux,
           optimizer_params=OPT)
    h = x.astype(np.float64) @ args["fc1_weight"].T + args["fc1_bias"]
    mean = 0.9 * aux["bn1_moving_mean"] + 0.1 * h.mean(axis=0)
    var = 0.9 * aux["bn1_moving_var"] + 0.1 * h.var(axis=0)
    _, got = pm.get_params()
    close(got["bn1_moving_mean"].asnumpy(), mean)
    close(got["bn1_moving_var"].asnumpy(), var)


def test_callbacks_and_monitor_run_in_fit(tmp_path, caplog):
    x, y = _data(24, 13)
    pm, _ = _modules()
    it = tmx.io.NDArrayIter(x, y, batch_size=6)
    seen = []
    mon = tmx.monitor.Monitor(1, pattern="fc1.*")
    with caplog.at_level(logging.INFO):
        pm.fit(it, num_epoch=2, optimizer_params=OPT, monitor=mon,
               batch_end_callback=[tmx.callback.Speedometer(6, 1),
                                   tmx.callback.log_train_metric(2),
                                   tmx.callback.ProgressBar(4),
                                   lambda p: seen.append(p.nbatch)],
               epoch_end_callback=[
                   tmx.callback.do_checkpoint(str(tmp_path / "cb")),
                   tmx.callback.module_checkpoint(pm, str(tmp_path / "mc"))],
               eval_data=tmx.io.NDArrayIter(x, y, batch_size=6),
               eval_end_callback=tmx.callback.LogValidationMetricsCallback())
    assert seen == [0, 1, 2, 3] * 2
    assert os.path.exists(str(tmp_path / "cb-0002.params"))
    assert os.path.exists(str(tmp_path / "mc-0002.params"))
    text = caplog.text
    assert "samples/sec" in text and "Validation-accuracy" in text
    assert "fc1_output0" in text and "fc1_weight" in text


def test_several_contexts_and_kvstores_raise():
    _, psym = _syms()
    m = tmx.mod.Module(psym, context=[tmx.cpu(0), tmx.cpu(1)])
    with pytest.raises(MXNetError, match="item 7"):
        m.bind([("data", (6, 5))], [("softmax_label", (6,))])
    pm, _ = _modules()
    for kv in ("dist_sync", "dist_async"):
        with pytest.raises(MXNetError, match="item 7"):
            pm.init_optimizer(kvstore=kv, force_init=True)
    with pytest.raises(TypeError, match="kvstore must be"):
        pm.init_optimizer(kvstore=object(), force_init=True)
    for kv in (None, "local", "device"):
        pm.init_optimizer(kvstore=kv, force_init=True)
        assert pm._kvstore is None and not pm._update_on_kvstore
    store = tmx.kv.create("device")
    pm.init_optimizer(kvstore=store, force_init=True)
    assert pm._kvstore is store and pm._update_on_kvstore
    with tmx.gpu(0):
        assert tmx.mod.Module(psym)._context == [tmx.gpu(0)]


# -- serving from a Module, a Symbol and symbol JSON ---------------------------

def _served_module(label):
    rs = np.random.RandomState(16)
    with nets.fresh_names(tmx):
        net = tmx.sym.FullyConnected(tmx.sym.var("data"), num_hidden=5,
                                     name="fc")
        net = tmx.sym.SoftmaxOutput(net, name="softmax") if label else \
            tmx.sym.tanh(net)
    mod = tmx.mod.Module(net, data_names=("data",),
                         label_names=("softmax_label",) if label else None,
                         context=tmx.cpu())
    mod.bind([("data", (1, 6))],
             [("softmax_label", (1,))] if label else None,
             for_training=False)
    mod.set_params({"fc_weight": rs.randn(5, 6).astype(np.float32),
                    "fc_bias": rs.randn(5).astype(np.float32)}, {})
    xs = [rs.randn(6).astype(np.float32) for _ in range(5)]
    return net, mod, xs


@pytest.mark.parametrize("label", [False, True])
def test_server_module_symbol_and_json_sources_match_predict(label, tmp_path):
    """The port's counterpart of test_serving.py's
    test_module_serving_fn_parity: each source's rows bit-equal to
    Module.predict (a SoftmaxOutput's label is filled with zeros)."""
    net, mod, xs = _served_module(label)
    refs = [mod.predict(tmx.nd.array(x[None])).asnumpy()[0] for x in xs]
    arg, aux = mod.get_params()
    tmx.nd.save(str(tmp_path / "p.params"),
                {"arg:" + k: v for k, v in arg.items()})
    param_bytes = (tmp_path / "p.params").read_bytes()
    with serving.Server(max_batch=4, max_wait_ms=3) as srv:
        srv.load("mod", module=mod)
        names = ["mod"]
        if not label:
            srv.load("sym", symbol=net, params=dict(arg))
            srv.load("json", symbol_json=net.tojson(),
                     param_bytes=param_bytes, input_shapes={"data": (1, 6)})
            names += ["sym", "json"]
        for name in names:
            futs = [srv.submit(name, x) for x in xs]
            for ref, f in zip(refs, futs):
                y = f.get(timeout=60.0)
                assert np.asarray(y).tobytes() == ref.tobytes(), name
    fn, params, inputs = mod.serving_fn()
    assert inputs == ["data"] and torch.equal(params["fc_weight"],
                                              arg["fc_weight"]._data)


# -- C8, C9: the optimizer's multipliers under Module --------------------------

def _frozen_fc(lr_mult=None, wd_mult=None):
    data = tmx.sym.var("data")
    w = tmx.sym.var("fc_weight", lr_mult=lr_mult, wd_mult=wd_mult)
    net = tmx.sym.FullyConnected(data, weight=w, num_hidden=3, name="fc")
    return tmx.sym.SoftmaxOutput(net, name="softmax")


def _one_sgd_step(sym, **opt):
    rs = np.random.RandomState(21)
    mod = tmx.mod.Module(sym, context=tmx.cpu())
    mod.bind([("data", (4, 5))], [("softmax_label", (4,))])
    w0 = {"fc_weight": rs.randn(3, 5).astype(np.float32),
          "fc_bias": rs.randn(3).astype(np.float32)}
    mod.set_params(w0, {})
    mod.init_optimizer(kvstore=None, optimizer="sgd",
                       optimizer_params=dict(learning_rate=0.5, **opt))
    mod.forward_backward(tmx.io.DataBatch(
        [tmx.nd.array(rs.randn(4, 5).astype(np.float32))],
        [tmx.nd.array(np.array([0, 1, 2, 1], np.float32))]))
    mod.update()
    return w0, {n: v.asnumpy() for n, v in mod.get_params()[0].items()}


def test_module_optimizer_gives_biases_no_weight_decay():
    """C8: under Module the optimizer knows the parameters' names, so a
    bias gets wd 0 and a weight ``wd`` (MXNet 1.2's set_wd_mult at
    construction); one step moves a bias by its gradient alone."""
    pm, _ = _modules()
    pm.init_optimizer(kvstore=None, optimizer="sgd",
                      optimizer_params=(("learning_rate", 0.5),
                                        ("wd", 0.1)))
    opt = pm._optimizer
    for i, n in enumerate(pm._param_names):
        assert opt._get_wd(i) == pytest.approx(
            0.1 if n.endswith("_weight") else 0.0), n
    _, decayed = _one_sgd_step(_frozen_fc(), wd=0.1)
    _, no_wd = _one_sgd_step(_frozen_fc(), wd=0.0)
    np.testing.assert_array_equal(decayed["fc_bias"], no_wd["fc_bias"])
    assert not np.array_equal(decayed["fc_weight"], no_wd["fc_weight"])


def test_symbol_lr_mult_zero_freezes_a_weight():
    """C9: ``sym.Variable("fc_weight", lr_mult=0.0)`` reaches the optimizer
    through Module: one sgd step at lr 0.5 leaves the weight as it was."""
    w0, w1 = _one_sgd_step(_frozen_fc(lr_mult=0.0))
    np.testing.assert_array_equal(w1["fc_weight"], w0["fc_weight"])
    assert np.abs(w1["fc_bias"] - w0["fc_bias"]).max() > 1e-3
    _, moved = _one_sgd_step(_frozen_fc())
    assert np.abs(moved["fc_weight"] - w0["fc_weight"]).max() > 1e-3


def test_symbol_wd_mult_zero_removes_the_decay():
    """C9: ``wd_mult=0.0`` on a weight removes its decay: the step with wd
    0.1 equals the step with wd 0, bit for bit."""
    _, with_mult = _one_sgd_step(_frozen_fc(wd_mult=0.0), wd=0.1)
    _, no_wd = _one_sgd_step(_frozen_fc(), wd=0.0)
    _, decayed = _one_sgd_step(_frozen_fc(), wd=0.1)
    np.testing.assert_array_equal(with_mult["fc_weight"], no_wd["fc_weight"])
    assert not np.array_equal(decayed["fc_weight"], no_wd["fc_weight"])


# -- Module with a KVStore -----------------------------------------------------

def _store_run(m, sym, args, batches, kv, on_kvstore, monkeypatch):
    monkeypatch.setenv("MXNET_UPDATE_ON_KVSTORE", "1" if on_kvstore else "0")
    mod = m.mod.Module(sym, context=m.cpu())
    mod.bind([("data", (6, 5))], [("softmax_label", (6,))])
    mod.set_params({n: m.nd.array(v) for n, v in args.items()}, {})
    mod.init_optimizer(kvstore=kv, optimizer="sgd", optimizer_params=OPT)
    for x, y in batches:
        mod.forward_backward(m.io.DataBatch([m.nd.array(x)],
                                            [m.nd.array(y)]))
        mod.update()
    return mod, {n: v.asnumpy() for n, v in mod.get_params()[0].items()}


@pytest.mark.parametrize("on_kvstore", [True, False])
def test_module_with_a_store_matches_no_store_and_jax(on_kvstore,
                                                      monkeypatch):
    """A ``"device"`` store with the update on the store (push the
    gradients, pull the weights) or not (push and pull the gradients, the
    update here): the weights after three steps equal the no-store path
    bit for bit, and the JAX build's Module given the same store within
    1e-5."""
    x, y = _data(18, 11)
    batches = [(x[i:i + 6], y[i:i + 6]) for i in range(0, 18, 6)]
    jsym, psym = _syms()
    args, _ = _params(psym)
    store = tmx.kv.create("device")
    mod, got = _store_run(tmx, psym, args, batches, store, on_kvstore,
                          monkeypatch)
    assert mod._kvstore is store and mod._update_on_kvstore == on_kvstore
    assert (mod._updater is None) == on_kvstore
    _, plain = _store_run(tmx, psym, args, batches, None, on_kvstore,
                          monkeypatch)
    _, want = _store_run(jmx, jsym, args, batches, jmx.kv.create("device"),
                         on_kvstore, monkeypatch)
    for n in plain:
        np.testing.assert_array_equal(got[n], plain[n])
        close(got[n], want[n])
    if on_kvstore:
        # the store's copy is the weights
        for i, n in enumerate(mod._param_names):
            np.testing.assert_array_equal(
                store._store[str(i)].asnumpy(), got[n])


def test_module_optimizer_states_through_the_store(tmp_path, monkeypatch):
    """With the update on the store, ``save_optimizer_states`` and
    ``load_optimizer_states`` go through it: a module restored from the
    checkpoint and the file continues bit-equal to the original."""
    monkeypatch.setenv("MXNET_UPDATE_ON_KVSTORE", "1")
    x, y = _data(24, 12)
    batches = [tmx.io.DataBatch([tmx.nd.array(x[i:i + 6])],
                                [tmx.nd.array(y[i:i + 6])])
               for i in range(0, 24, 6)]
    _, psym = _syms()
    args, _ = _params(psym)

    def fresh(params):
        mod = tmx.mod.Module(psym, context=tmx.cpu())
        mod.bind([("data", (6, 5))], [("softmax_label", (6,))])
        mod.set_params(params, {})
        mod.init_optimizer(kvstore=tmx.kv.create("device"), optimizer="sgd",
                           optimizer_params=OPT)
        return mod

    a = fresh(args)
    for b in batches[:2]:
        a.forward_backward(b)
        a.update()
    a.save_optimizer_states(str(tmp_path / "s.states"))
    b_mod = fresh({n: v.asnumpy() for n, v in a.get_params()[0].items()})
    b_mod.load_optimizer_states(str(tmp_path / "s.states"))
    assert b_mod._kvstore._updater.states.keys() == \
        a._kvstore._updater.states.keys()
    for m in (a, b_mod):
        for b in batches[2:]:
            m.forward_backward(b)
            m.update()
    for n, v in a.get_params()[0].items():
        np.testing.assert_array_equal(b_mod.get_params()[0][n].asnumpy(),
                                      v.asnumpy())
