"""Several contexts in one process, the port against the JAX build on the
CPU (its conftest gives JAX eight CPU devices, so the JAX build's
``cpu(i)`` are devices of their own; the port's ``cpu(i)`` are contexts
over torch's one CPU device).  A Module over two contexts with a
``"device"`` store (``tests/test_module.py:59-76``), a ``gluon.Trainer``
over four contexts fed by ``split_and_load``, ``DataParallelTrainer`` on a
two-device ``"dp"`` mesh (``tests/test_parallel.py:21-46``), the store's
reduce over contexts and ``clip_global_norm`` over them.  Inputs and
weights from numpy under a seed; weights within 1e-5 of the largest
reference value, losses to a relative 1e-5 (f32, the same sums in other
orders)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import engine as jengine

REL = 1e-5


def close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rel, "%.3e > %.0e" % (err, rel)


def _toy_data(n=120, d=10, k=3, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, d).astype(np.float32)
    w = rs.randn(d, k).astype(np.float32)
    return X, (X @ w).argmax(axis=1).astype(np.float32)


def _mlp_sym(mx):
    data = mx.sym.var("data")
    fc1 = mx.sym.FullyConnected(data, num_hidden=32, name="fc1")
    act = mx.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = mx.sym.FullyConnected(act, num_hidden=3, name="fc2")
    return mx.sym.SoftmaxOutput(fc2, mx.sym.var("softmax_label"),
                                name="softmax")


def _mlp_weights(seed=3):
    rs = np.random.RandomState(seed)
    return {"fc1_weight": (rs.randn(32, 10) * 0.3).astype(np.float32),
            "fc1_bias": (rs.randn(32) * 0.1).astype(np.float32),
            "fc2_weight": (rs.randn(3, 32) * 0.3).astype(np.float32),
            "fc2_bias": np.zeros(3, np.float32)}


def _module_run(mx, contexts, X, y, weights, epochs=3, kvstore="device"):
    it = mx.io.NDArrayIter(X, y, batch_size=20)
    mod = mx.mod.Module(_mlp_sym(mx), context=contexts)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params={n: mx.nd.array(v) for n, v in
                                weights.items()})
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5})
    metric = mx.metric.create("acc")
    for _ in range(epochs):
        it.reset()
        metric.reset()
        for batch in it:
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
            mod.update_metric(metric, batch.label)
    return mod, {n: v.asnumpy() for n, v in mod.get_params()[0].items()}, \
        metric.get()[1]


def test_module_two_contexts_device_store_matches_jax():
    X, y = _toy_data()
    w = _mlp_weights()
    jmod, jparams, jacc = _module_run(jmx, [jmx.cpu(0), jmx.cpu(1)], X, y, w)
    with tmx.cpu():
        tmod, tparams, tacc = _module_run(tmx, [tmx.cpu(0), tmx.cpu(1)], X, y,
                                          w)
        _, one, _ = _module_run(tmx, tmx.cpu(0), X, y, w)
    assert tmod._kvstore.type == "device" and tmod._update_on_kvstore
    assert len(tmod._exec_group.execs) == 2
    assert tacc == jacc and tacc > 0.9
    for n in w:
        close(tparams[n], jparams[n])
        # two contexts sum the same gradient as one, in two halves
        close(tparams[n], one[n])
    # the replicas hold the same weights; outputs merge along the batch
    group = tmod._exec_group
    for arrs in group.param_arrays:
        assert arrs[0].asnumpy().tobytes() == arrs[1].asnumpy().tobytes()
    assert tmod.get_outputs()[0].shape == (20, 3)
    assert [e.outputs[0].shape for e in group.execs] == [(10, 3), (10, 3)]


def _dense_net(mx, prefix):
    net = mx.gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(16, activation="relu", in_units=8),
                mx.gluon.nn.Dense(3, in_units=16))
    return net


def _net_weights(seed=4):
    rs = np.random.RandomState(seed)
    return [(rs.randn(*s) * 0.3).astype(np.float32)
            for s in ((16, 8), (16,), (3, 16), (3,))]


def test_gluon_trainer_four_contexts_split_and_load_matches_jax():
    """Four contexts, each a quarter of every batch under ``with ctx``, one
    backward over the four losses, ``step(batch)``: every context's copy
    within 1e-5 of the JAX build's and bit-equal to the others."""
    rs = np.random.RandomState(0)
    X = rs.randn(4, 16, 8).astype(np.float32)
    Y = rs.randint(0, 3, (4, 16)).astype(np.float32)
    weights = _net_weights()
    out = {}
    for name, mx in (("jax", jmx), ("port", tmx)):
        ctxs = [mx.cpu(i) for i in range(4)]
        net = _dense_net(mx, "t4_")
        net.initialize(ctx=ctxs)
        for p, w in zip(net.collect_params().values(), weights):
            if mx is tmx:
                p.set_data(w)       # every context's copy
                continue
            for d in p.list_data():
                # each copy stays committed to its own device
                d._write(jengine.colocate(jnp.asarray(w), d._read()))
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1, "momentum": 0.9},
                                   kvstore="device")
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        losses = []
        for x, y in zip(X, Y):
            xs = mx.gluon.utils.split_and_load(x, ctxs)
            ys = mx.gluon.utils.split_and_load(y, ctxs)
            assert [a.context for a in xs] == ctxs
            with mx.autograd.record():
                ls = []
                for ctx, a, b in zip(ctxs, xs, ys):
                    with ctx:
                        ls.append(loss_fn(net(a), b))
            mx.autograd.backward(ls)
            trainer.step(16)
            losses.append(sum(float(l.asnumpy().sum()) for l in ls))
        out[name] = ([[d.asnumpy() for d in p.list_data()]
                      for p in net.collect_params().values()], losses)
    (tw, tl), (jw, jl) = out["port"], out["jax"]
    np.testing.assert_allclose(tl, jl, rtol=REL)
    for tcopies, jcopies in zip(tw, jw):
        for c in tcopies:
            close(c, jcopies[0])
            assert c.tobytes() == tcopies[0].tobytes()


def test_data_parallel_trainer_two_device_mesh_matches_jax():
    """``tests/test_parallel.py:21-46``'s net and batch on one device and
    on a two-device ``"dp"`` mesh: the losses within 1e-5 of the JAX
    build's, the two meshes' within 1e-5 of each other, the weights within
    1e-5 of the JAX build's two-device run."""
    rs = np.random.RandomState(0)
    x = rs.randn(16, 8).astype(np.float32)
    y = (rs.rand(16) * 3).astype(np.float32)
    weights = _net_weights(7)
    losses, final = {}, {}
    for name, mx in (("jax", jmx), ("port", tmx)):
        for ndev in (1, 2):
            net = _dense_net(mx, "dp_")
            if mx is jmx:
                net.initialize()
                mesh = jmx.parallel.make_mesh({"dp": ndev})
            else:
                net.initialize(ctx=tmx.cpu(0))
                mesh = tmx.parallel.make_mesh(
                    {"dp": ndev}, [tmx.cpu(i) for i in range(ndev)])
            for p, w in zip(net.collect_params().values(), weights):
                p.set_data(w if mx is tmx else jmx.nd.array(w))
            tr = mx.parallel.DataParallelTrainer(
                net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                optimizer="sgd", optimizer_params={"learning_rate": 0.1},
                mesh=mesh)
            losses[name, ndev] = [float(np.asarray(
                tr.step(mx.nd.array(x), mx.nd.array(y)))) if mx is jmx
                else float(tr.step(x, y).asscalar())
                for _ in range(4)]
            tr.sync_params()
            final[name, ndev] = [p.data().asnumpy() for p in
                                 net.collect_params().values()]
    np.testing.assert_allclose(losses["port", 2], losses["jax", 2], rtol=REL)
    np.testing.assert_allclose(losses["port", 2], losses["port", 1],
                               rtol=REL)
    assert losses["port", 2][-1] < losses["port", 2][0]
    for got, want in zip(final["port", 2], final["jax", 2]):
        close(got, want)


def test_data_parallel_trainer_replicas_and_mesh_axes():
    with tmx.cpu():
        net = _dense_net(tmx, "dpr_")
        net.initialize()
        mesh = tmx.parallel.make_mesh({"dp": 2}, [tmx.cpu(0), tmx.cpu(1)])
        seen = []

        class Spy(tmx.gluon.loss.SoftmaxCrossEntropyLoss):
            def hybrid_forward(self, F, *args, **kw):
                seen.append(tmx.parallel.current_mesh())
                return super().hybrid_forward(F, *args, **kw)

        tr = tmx.parallel.DataParallelTrainer(
            net, Spy(), "sgd", {"learning_rate": 0.1, "momentum": 0.9},
            mesh=mesh)
        x = tmx.nd.array(np.random.RandomState(1).randn(6, 8))
        tr.step(x, tmx.nd.array(np.arange(6) % 3))
        reps = tr._replicas
        assert [r.ctx for r in reps] == [tmx.cpu(0), tmx.cpu(1)]
        # the mesh is scoped while the step runs (one loss a replica)
        assert seen == [mesh, mesh] and tmx.parallel.current_mesh() is None
        for n in tr._trainable:
            assert torch.equal(reps[0].params[n], reps[1].params[n])
            assert torch.equal(reps[0].opt_state[n][0],
                               reps[1].opt_state[n][0])
        with pytest.raises(ValueError, match="split evenly"):
            tr.step(x[:5], tmx.nd.zeros(5))
        # a {"dp": 1, "tp": 2} mesh: the first layer's weight split over
        # "tp" trains as the replicated one does
        tp = tmx.parallel.make_mesh({"dp": 1, "tp": 2},
                                    [tmx.cpu(0), tmx.cpu(1)])
        y = tmx.nd.array(np.arange(6) % 3)
        runs = []
        for split in (False, True):
            tnet = _dense_net(tmx, "dpt%d_" % split)
            tnet.initialize()
            for a, b in zip(net.collect_params().values(),
                            tnet.collect_params().values()):
                b.set_data(a.data())
            w = list(tnet.collect_params().values())[0]
            if split:
                w.sharding = ("tp",) + (None,) * (len(w.shape) - 1)
            ttr = tmx.parallel.DataParallelTrainer(
                tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                {"learning_rate": 0.1}, mesh=tp)
            runs.append([float(ttr.step(x, y).asscalar())
                         for _ in range(3)])
            if split:
                shards = ttr._params[w.name]
                assert isinstance(shards, tuple) and len(shards) == 2
        close(runs[1], runs[0])
        assert tmx.parallel.data_parallel_mesh().shape == {"dp": 1}
    two = tmx.parallel.data_parallel_mesh(
        devices=[tmx.cpu(0), tmx.cpu(1), tmx.cpu(2)], num_devices=2)
    assert two.shape == {"dp": 2}
    assert tmx.parallel.current_mesh() is None
    with tmx.parallel.use_mesh(two) as m:
        assert m is two and tmx.parallel.current_mesh() is two
    assert tmx.parallel.current_mesh() is None
    with pytest.raises(RuntimeError, match="no device mesh"):
        tmx.parallel.current_mesh(required=True)


def test_reduce_keeps_the_first_context():
    """The store's sum over contexts keeps the first value's context, as
    the JAX build's (``ctx=vlist[0]._ctx``), and a pull lands on every
    out's own context."""
    rs = np.random.RandomState(2)
    vals = [rs.randn(3, 4).astype(np.float32) for _ in range(3)]
    order = (2, 0, 1)
    with tmx.cpu():
        tred = tmx.kv.KVStore._reduce([tmx.nd.array(vals[i], ctx=tmx.cpu(i))
                                       for i in order])
    jred = jmx.kv.KVStore._reduce([jmx.nd.array(vals[i], ctx=jmx.cpu(i))
                                   for i in order])
    assert tred.context == tmx.cpu(2) and str(jred.context) == "cpu(2)"
    close(tred.asnumpy(), jred.asnumpy())
    with tmx.cpu():
        kv = tmx.kv.create("device")
        kv.init(0, tmx.nd.zeros((3, 4), ctx=tmx.cpu(1)))
        kv.push(0, [tmx.nd.array(v, ctx=tmx.cpu(i + 1))
                    for i, v in enumerate(vals)])
        outs = [tmx.nd.zeros((3, 4), ctx=tmx.cpu(i)) for i in (3, 1)]
        kv.pull(0, out=outs)
    assert [o.context for o in outs] == [tmx.cpu(3), tmx.cpu(1)]
    want = (vals[0] + vals[1]) + vals[2]
    assert all(np.array_equal(o.asnumpy(), want) for o in outs)


def test_contexts_and_torch_devices():
    """A gpu(i) context names cuda:i and back; every CPU context is torch's
    one CPU device, so a CPU tensor alone names cpu(0) and an array keeps
    the context it was made on."""
    Context = tmx.context.Context
    assert Context.from_torch_device(torch.device("cuda", 3)) == tmx.gpu(3)
    assert Context.from_torch_device(torch.device("cuda")) == tmx.gpu(0)
    assert Context.from_torch_device(torch.device("cpu")) == tmx.cpu(0)
    assert tmx.cpu(5).torch_device() == torch.device("cpu")
    assert tmx.num_devices("cpu") == 1
    a = tmx.nd.ones((2,), ctx=tmx.cpu(3))
    assert a.context == tmx.cpu(3)
    assert a.as_in_context(tmx.cpu(1)).context == tmx.cpu(1)
    if not torch.cuda.is_available():
        assert tmx.num_devices("gpu") == 0
        with pytest.raises(tmx.MXNetError, match="CUDA"):
            tmx.gpu(1).torch_device()


def test_clip_global_norm_over_contexts_matches_jax():
    rs = np.random.RandomState(6)
    vals = [rs.randn(5, 3).astype(np.float32) * 3 for _ in range(4)]
    tarrs = [tmx.nd.array(v, ctx=tmx.cpu(i)) for i, v in enumerate(vals)]
    jarrs = [jmx.nd.array(v, ctx=jmx.cpu(i)) for i, v in enumerate(vals)]
    tn = tmx.gluon.utils.clip_global_norm(tarrs, 2.0)
    jn = jmx.gluon.utils.clip_global_norm(jarrs, 2.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=REL)
    for t, j, i in zip(tarrs, jarrs, range(4)):
        assert t.context == tmx.cpu(i)
        close(t.asnumpy(), j.asnumpy())
