"""The port's stores and trainers across processes, on the CPU.

Two ranks start through ``tools/launch.py`` and meet over gloo
(``parallel/dist.py``), as ``tests/test_dist_multiprocess.py`` runs the
JAX build: the store's invariants (a push's sum over the ranks, several
keys in one push, integer sums exact, the row-sparse union, CSR sums in
bands, ``dist_async``
with SGD on the parameter server, ``barrier``), then a model trained on
each of the three surfaces (``Module.fit(kvstore="dist_sync")``, a
``gluon.Trainer`` over ``dist_sync``, ``DataParallelTrainer`` over the
process group).  Each rank writes its weights under ``tmp_path``; the
ranks must hold the same bits, and the JAX build's one-process run over two
contexts, fed the same weights and the same halves of every batch, must
agree within 1e-5 of its largest weight (f32; the same sums in other
orders).  The parameter service is also held against the JAX build's in
one process, and the shared-card refusal runs on the card.
"""
import os
import signal
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import engine as jengine
from incubator_mxnet_tpu.parallel import ps as jps
from incubator_mxnet_tpu_torch.parallel import ps as tps

import chip_smoke as cs

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
REL = 1e-5
TIMEOUT = 180
STEPS_X = 64            # rows of the training data; 32 a rank


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(tmp_path, source, n=2, args=(), timeout=TIMEOUT):
    """Run ``source`` as ``n`` ranks through tools/launch.py; the output,
    or a failure naming the hang (the whole process group is killed)."""
    worker = tmp_path / "worker.py"
    worker.write_text(textwrap.dedent(source))
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tools", "launch.py"), "-n",
         str(n), "-p", str(_free_port()), sys.executable, str(worker)]
        + [str(a) for a in args],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True, cwd=str(tmp_path))
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        proc.wait()
        pytest.fail("%d-rank run hung (%d s)" % (n, timeout))
    out = stdout + stderr
    assert proc.returncode == 0, out[-4000:]
    return out


_KV_WORKER = """
    import os
    import numpy as np
    import torch
    import torch.distributed as tdist
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd

    with mx.cpu():
        kv = mx.kv.create("dist_sync")
        rank, nw = kv.rank, kv.num_workers
        assert nw == 2, nw
        kv.init("w", nd.zeros((3, 2)))
        kv.push("w", nd.ones((3, 2)) * (rank + 1))        # 1 + 2 = 3
        out = nd.zeros((3, 2))
        kv.pull("w", out=out)
        assert np.array_equal(out.asnumpy(), np.full((3, 2), 3.0)), out

        # several keys and dtypes in one push: one all_reduce a dtype
        kv.init(["a", "b", "i", "l"],
                [nd.zeros(2), nd.zeros(2), nd.zeros(3, dtype="int32"),
                 nd.array(np.zeros(2), dtype="int64")])
        big = [(1 << 40) + 3, (1 << 41) + 5]
        kv.push(["a", "b", "i", "l"],
                [nd.ones(2) * (rank + 1), nd.ones(2) * 10 * (rank + 1),
                 nd.array(np.full(3, 1000003 * (rank + 1)), dtype="int32"),
                 nd.array(np.array(big) * (rank + 1), dtype="int64")])
        oa, ob = nd.zeros(2), nd.zeros(2)
        oi, ol = nd.zeros(3, dtype="int32"), nd.array(np.zeros(2),
                                                      dtype="int64")
        kv.pull(["a", "b", "i", "l"], out=[oa, ob, oi, ol])
        assert np.array_equal(oa.asnumpy(), [3.0, 3.0])
        assert np.array_equal(ob.asnumpy(), [30.0, 30.0])
        assert oi.asnumpy().tolist() == [3000009] * 3, oi.asnumpy()
        assert ol.asnumpy().tolist() == [3 * b for b in big], ol.asnumpy()

        # rank 0's init wins: ranks that initialized apart start equal
        kv.init("seeded", nd.ones(4) * (rank + 7))
        os_ = nd.zeros(4)
        kv.pull("seeded", out=os_)
        assert np.array_equal(os_.asnumpy(), np.full(4, 7.0)), os_

        # row-sparse: the ranks hold different rows; the sum is over the
        # union of the ids (ref: comm.h ReduceRowSparse)
        kv.init("rs", nd.zeros((6, 3)))
        dense = np.zeros((6, 3), np.float32)
        for r in [rank, 2 + rank, 4]:
            dense[r] = rank + 1
        kv.push("rs", nd.array(dense).tostype("row_sparse"))
        ors = nd.zeros((6, 3))
        kv.pull("rs", out=ors)
        exp = np.zeros((6, 3), np.float32)
        exp[0], exp[1], exp[2], exp[3], exp[4] = 1, 2, 1, 2, 3
        assert np.array_equal(ors.asnumpy(), exp), ors.asnumpy()
        # CSR: summed dense band by band (a bound of two rows here)
        os.environ["MXTPU_CSR_DENSIFY_BOUND"] = "40"
        kv.init("csr", nd.zeros((4, 5)))
        m = np.zeros((4, 5), np.float32)
        m[rank, rank + 1], m[3, 0] = rank + 1, 1
        kv.push("csr", nd.array(m).tostype("csr"))
        oc = nd.zeros((4, 5))
        kv.pull("csr", out=oc)
        want_c = np.zeros((4, 5), np.float32)
        want_c[0, 1], want_c[1, 2], want_c[3, 0] = 1, 2, 2
        assert np.array_equal(oc.asnumpy(), want_c), oc.asnumpy()
        got = mx.nd.sparse.zeros("row_sparse", (6, 3))
        kv.row_sparse_pull("rs", out=got, row_ids=nd.array([4, 1, 4]))
        assert got.indices.asnumpy().tolist() == [1, 4]
        assert np.array_equal(got.data.asnumpy(), exp[[1, 4]])

        # one distributed step: every rank lands on the same weights
        rng = np.random.RandomState(0)
        Xs = rng.randn(40, 6).astype(np.float32)[rank::2]
        grad = (Xs.T @ Xs / len(Xs)).astype(np.float32)[:3]
        kv.init("grad", nd.zeros((3, 6)))
        kv.push("grad", nd.array(grad))
        summed = nd.zeros((3, 6))
        kv.pull("grad", out=summed)
        w = 0.05 - 0.1 * summed.asnumpy() / nw
        both = [None, None]
        tdist.all_gather_object(both, w.tobytes())
        assert both[0] == both[1], "weights diverged"

        # dist_device_sync without a card: the host wire of that type
        kvd = mx.kv.create("dist_device_sync")
        kvd.init(3, nd.zeros(5))
        kvd.push(3, nd.ones(5) * (rank + 1))
        od = nd.zeros(5)
        kvd.pull(3, out=od)
        assert np.array_equal(od.asnumpy(), np.full(5, 3.0)), od
        print("WORKER %d SYNC OK" % rank, flush=True)

        # dist_async: every push is applied on rank 0's server as it
        # arrives; SGD's sums commute, so the order does not matter
        kva = mx.kv.create("dist_async")
        kva.init("aw", nd.ones((4,)) * 10.0)
        kva.set_optimizer(mx.optimizer.create("sgd", learning_rate=1.0))
        kva.push("aw", nd.ones((4,)) * (rank + 1))       # -1 and -2
        kva.barrier()
        oa2 = nd.zeros((4,))
        kva.pull("aw", out=oa2)
        assert np.array_equal(oa2.asnumpy(), np.full(4, 7.0)), oa2
        assert kva.num_dead_nodes() == 0
        kva.barrier()
        print("WORKER %d ASYNC OK" % rank, flush=True)
        kv.barrier()
        print("WORKER %d OK" % rank, flush=True)
"""


def test_two_process_store_invariants(tmp_path):
    out = launch(tmp_path, _KV_WORKER)
    for r in (0, 1):
        for tag in ("SYNC OK", "ASYNC OK", "OK"):
            assert "WORKER %d %s" % (r, tag) in out, out[-3000:]


# -- the three training surfaces ---------------------------------------------

_TRAIN_WORKER = """
    import os, sys
    import numpy as np
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, autograd, nd
    from incubator_mxnet_tpu_torch.parallel import DataParallelTrainer

    here = os.getcwd()
    init = np.load(os.path.join(here, "init.npz"))
    data = np.load(os.path.join(here, "data.npz"))
    X, y = data["X"], data["y"]

    def gluon_net(prefix):
        net = gluon.nn.HybridSequential(prefix=prefix)
        with net.name_scope():
            net.add(gluon.nn.Dense(16, activation="relu", in_units=10),
                    gluon.nn.Dense(2, in_units=16))
        net.initialize()
        for i, p in enumerate(net.collect_params().values()):
            p.set_data(init["g%d" % i])
        return net

    with mx.cpu():
        kv = mx.kv.create("dist_sync")
        rank, nw = kv.rank, kv.num_workers
        Xs, ys = X[rank::nw], y[rank::nw]
        saved = {}

        # surface 1: Module.fit(kvstore=dist_sync)
        it = mx.io.NDArrayIter(Xs, ys, batch_size=8, shuffle=False,
                               label_name="softmax_label")
        s = mx.sym.Variable("data")
        s = mx.sym.FullyConnected(s, num_hidden=16, name="fc1")
        s = mx.sym.Activation(s, act_type="relu")
        s = mx.sym.FullyConnected(s, num_hidden=2, name="fc2")
        s = mx.sym.SoftmaxOutput(s, name="softmax")
        mod = mx.mod.Module(s, context=mx.cpu())
        mod.fit(it, num_epoch=2, kvstore=kv, optimizer="sgd",
                optimizer_params={"learning_rate": 0.05},
                arg_params={n[2:]: nd.array(init[n]) for n in init.files
                            if n.startswith("m_")})
        for n, v in mod.get_params()[0].items():
            saved["m_" + n] = v.asnumpy()
        print("WORKER %d FIT OK" % rank, flush=True)

        # surface 2: gluon.Trainer over dist_sync, step(global batch)
        gnet = gluon_net("g_")
        trainer = gluon.Trainer(gnet.collect_params(), "sgd",
                                {"learning_rate": 0.05},
                                kvstore=mx.kv.create("dist_sync"))
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        for epoch in range(2):
            for i in range(0, len(Xs), 8):
                xb, yb = nd.array(Xs[i:i + 8]), nd.array(ys[i:i + 8])
                with autograd.record():
                    loss = loss_fn(gnet(xb), yb)
                loss.backward()
                trainer.step(8 * nw)
        for i, p in enumerate(gnet.collect_params().values()):
            saved["g%d" % i] = p.data().asnumpy()
        print("WORKER %d TRAINER OK" % rank, flush=True)

        # surface 3: DataParallelTrainer over the process group
        hnet = gluon_net("h_")
        tr = DataParallelTrainer(hnet, loss_fn, "sgd",
                                 {"learning_rate": 0.05})
        yl = y.astype(np.int64)
        losses = []
        for ep in range(2):
            for i in range(0, STEPS_X, 16):
                lo = rank * 8
                losses.append(float(tr.step(X[i:i + 16][lo:lo + 8],
                                            yl[i:i + 16][lo:lo + 8])
                                    .asscalar()))
        tr.sync_params()
        for i, p in enumerate(hnet.collect_params().values()):
            saved["g%d_dpt" % i] = p.data().asnumpy()
        saved["dpt_losses"] = np.array(losses)
        np.savez(os.path.join(here, "rank%d.npz" % rank), **saved)
        print("WORKER %d DPT OK" % rank, flush=True)
""".replace("STEPS_X", str(STEPS_X))


def _train_inputs(seed=42):
    rng = np.random.RandomState(seed)
    X = rng.randn(STEPS_X, 10).astype(np.float32)
    W = rng.randn(10, 1).astype(np.float32)
    y = (X @ W > 0).astype(np.float32).ravel()
    init = {"m_fc1_weight": rng.randn(16, 10).astype(np.float32) * 0.3,
            "m_fc1_bias": np.zeros(16, np.float32),
            "m_fc2_weight": rng.randn(2, 16).astype(np.float32) * 0.3,
            "m_fc2_bias": np.zeros(2, np.float32)}
    for i, shape in enumerate(((16, 10), (16,), (2, 16), (2,))):
        init["g%d" % i] = (rng.randn(*shape) * 0.3).astype(np.float32)
    return X, y, init


def _interleaved(X0, X1, b):
    """Batches of 2b rows: rank 0's b rows, then rank 1's (the contexts'
    slices of a two-context Module)."""
    parts = []
    for i in range(0, len(X0), b):
        parts += [X0[i:i + b], X1[i:i + b]]
    return np.concatenate(parts)


def _jax_references(X, y, init):
    """The JAX build in one process over cpu(0) and cpu(1), each context
    given one rank's half of every batch."""
    ctxs = [jmx.cpu(0), jmx.cpu(1)]
    X0, X1, y0, y1 = X[0::2], X[1::2], y[0::2], y[1::2]
    ref = {}
    it = jmx.io.NDArrayIter(_interleaved(X0, X1, 8),
                            _interleaved(y0, y1, 8), batch_size=16,
                            shuffle=False, label_name="softmax_label")
    s = jmx.sym.Variable("data")
    s = jmx.sym.FullyConnected(s, num_hidden=16, name="fc1")
    s = jmx.sym.Activation(s, act_type="relu")
    s = jmx.sym.FullyConnected(s, num_hidden=2, name="fc2")
    s = jmx.sym.SoftmaxOutput(s, name="softmax")
    mod = jmx.mod.Module(s, context=ctxs)
    mod.fit(it, num_epoch=2, kvstore="device", optimizer="sgd",
            optimizer_params={"learning_rate": 0.05},
            arg_params={n[2:]: jmx.nd.array(init[n]) for n in init
                        if n.startswith("m_")})
    for n, v in mod.get_params()[0].items():
        ref["m_" + n] = v.asnumpy()

    def gluon_net(prefix, ctx):
        net = jmx.gluon.nn.HybridSequential(prefix=prefix)
        with net.name_scope():
            net.add(jmx.gluon.nn.Dense(16, activation="relu", in_units=10),
                    jmx.gluon.nn.Dense(2, in_units=16))
        net.initialize(ctx=ctx)
        for i, p in enumerate(net.collect_params().values()):
            for d in p.list_data():
                # each context's copy stays committed to its own device
                d._write(jengine.colocate(jnp.asarray(init["g%d" % i]),
                                          d._read()))
        return net

    gnet = gluon_net("g_", ctxs)
    trainer = jmx.gluon.Trainer(gnet.collect_params(), "sgd",
                                {"learning_rate": 0.05}, kvstore="device")
    loss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    halves = ((X0, y0), (X1, y1))
    for _ in range(2):
        for i in range(0, len(X0), 8):
            with jmx.autograd.record():
                losses = []
                for ctx, (xs, ys) in zip(ctxs, halves):
                    with ctx:
                        losses.append(loss_fn(
                            gnet(jmx.nd.array(xs[i:i + 8], ctx=ctx)),
                            jmx.nd.array(ys[i:i + 8], ctx=ctx)))
            jmx.autograd.backward(losses)
            trainer.step(16)
    for i, p in enumerate(gnet.collect_params().values()):
        ref["g%d" % i] = p.data(ctxs[0]).asnumpy()

    hnet = gluon_net("h_", jmx.cpu(0))
    tr = jmx.parallel.DataParallelTrainer(
        hnet, loss_fn, "sgd", {"learning_rate": 0.05},
        mesh=jmx.parallel.make_mesh({"dp": 2}))
    yl = y.astype(np.int64)
    dlosses = []
    for _ in range(2):
        for i in range(0, STEPS_X, 16):
            dlosses.append(float(tr.step(jmx.nd.array(X[i:i + 16]),
                                         jmx.nd.array(yl[i:i + 16]))))
    tr.sync_params()
    for i, p in enumerate(hnet.collect_params().values()):
        ref["g%d_dpt" % i] = p.data().asnumpy()
    ref["dpt_losses"] = np.array(dlosses)
    return ref


def test_two_process_training_surfaces_match_jax(tmp_path):
    """Module.fit, gluon.Trainer and DataParallelTrainer over two ranks:
    the ranks bit-equal, and within 1e-5 (relative to the largest weight)
    of the JAX build's one-process two-context run."""
    X, y, init = _train_inputs()
    np.savez(tmp_path / "init.npz", **init)
    np.savez(tmp_path / "data.npz", X=X, y=y)
    out = launch(tmp_path, _TRAIN_WORKER)
    for r in (0, 1):
        for tag in ("FIT", "TRAINER", "DPT"):
            assert "WORKER %d %s OK" % (r, tag) in out, out[-3000:]
    ranks = [dict(np.load(tmp_path / ("rank%d.npz" % r))) for r in (0, 1)]
    assert ranks[0].keys() == ranks[1].keys()
    for k in ranks[0]:
        assert ranks[0][k].tobytes() == ranks[1][k].tobytes(), k
    ref = _jax_references(X, y, init)
    assert set(ref) == set(ranks[0])
    for k, want in ref.items():
        got = ranks[0][k]
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= REL, (k, err)
    assert ranks[0]["dpt_losses"][-1] < ranks[0]["dpt_losses"][0]


# -- ring attention, experts and the pipeline over ranks ---------------------

_PARALLEL_WORKER = """
    import importlib
    import sys
    import numpy as np
    import torch
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.parallel import dist
    ring = importlib.import_module(
        "incubator_mxnet_tpu_torch.parallel.ring_attention")
    moe = importlib.import_module("incubator_mxnet_tpu_torch.parallel.moe")
    pipe = importlib.import_module(
        "incubator_mxnet_tpu_torch.parallel.pipeline")
    TP_NAMES = ("tw0", "tb0", "tw1", "tb1")
    dist.init_process()
    r = dist.rank()
    d = dict(np.load("inputs.npz"))
    t = {k: torch.tensor(v) for k, v in d.items()}
    out = {}
    sp = dist.worker_mesh(cpu=True, axes={"dp": 1, "sp": 2})
    for causal in (0, 1):
        q, k, v = (t[n].clone().requires_grad_() for n in "qkv")
        o = ring.ring_attention(q, k, v, sp, "sp", bool(causal))
        grads = torch.autograd.grad(o, (q, k, v), t["g"])
        out["ring%d_out" % causal] = o.detach()
        for n, gr in zip("qkv", grads):
            out["ring%d_d%s" % (causal, n)] = gr
    ep = dist.worker_mesh(cpu=True, axes={"ep": 2})
    args = [t[n].clone().requires_grad_() for n in ("x", "gw", "w1", "w2")]
    o, drops, aux = moe.switch_moe_apply(*args, ep, "ep", 0.5)
    grads = torch.autograd.grad((o * o).sum(), args)
    out["cap_out"], out["cap_drops"] = o.detach(), drops.detach()
    for n, gr in zip(("x", "gw", "w1", "w2"), grads):
        out["cap_d" + n] = gr
    with mx.cpu():
        blk = moe.ExpertParallelMoE(10, 4, prefix="m_")
        blk._pre_infer(torch.zeros((1, 6)))
        blk.initialize()
        for p, n in zip(blk.collect_params().values(), ("gw", "w1", "w2")):
            p.set_data(mx.nd.array(d[n]))
        x = mx.nd.array(d["x"])
        x.attach_grad()
        with mx.parallel.use_mesh(ep), mx.autograd.record():
            o = blk(x)
            loss = (o * o).sum()
        loss.backward()
    out["dense_out"], out["dense_dx"] = o._data.detach(), x.grad._data
    for p, n in zip(blk.collect_params().values(), ("gw", "w1", "w2")):
        out["dense_d" + n] = p.grad()._data
    pp = dist.worker_mesh(cpu=True, axes={"pp": 2})
    loss, grads = pipe.pipeline_train_step(
        lambda p, a: torch.tanh(a @ p["W"] + p["b"]),
        {"W": t["W"], "b": t["b"]}, t["px"], t["py"],
        lambda o, y: ((o - y) ** 2).sum(-1), pp, num_microbatches=4)
    out["pp_loss"], out["pp_dW"], out["pp_db"] = loss, grads["W"], grads["b"]
    tp = dist.worker_mesh(cpu=True, axes={"dp": 1, "tp": 2})
    with mx.cpu():
        net = mx.gluon.nn.HybridSequential(prefix="t_")
        net.add(mx.gluon.nn.Dense(8, in_units=6, activation="tanh"),
                mx.gluon.nn.Dense(3, in_units=8))
        net.initialize()
        for p, n in zip(net.collect_params().values(), TP_NAMES):
            p.set_data(mx.nd.array(d[n]))
        net[0].weight.sharding = ("tp", None)
        tr = mx.parallel.DataParallelTrainer(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            {"learning_rate": 0.5}, mesh=tp)
        for _ in range(2):
            out["tp_loss"] = tr.step(mx.nd.array(d["tx"]),
                                     mx.nd.array(d["ty"]))._data
        tr.sync_params()
    for p, n in zip(net.collect_params().values(), TP_NAMES):
        out["tp_" + n] = p.data()._data.detach()
    np.savez("rank%d.npz" % r, **{k: v.numpy() for k, v in out.items()})
    print("WORKER %d PARALLEL OK" % r, flush=True)
"""


def _parallel_inputs():
    rs = np.random.RandomState(17)
    f = lambda *s: rs.randn(*s).astype(np.float32)     # noqa: E731
    return dict(q=f(1, 2, 16, 8), k=f(1, 2, 16, 8), v=f(1, 2, 16, 8),
                g=f(1, 2, 16, 8), x=f(16, 6), gw=f(6, 4),
                w1=f(4, 6, 10) * 0.3, w2=f(4, 10, 6) * 0.3,
                W=f(2, 8, 8) * 0.4, b=f(2, 8) * 0.1, px=f(8, 8), py=f(8, 8),
                tw0=f(8, 6) * 0.5, tb0=f(8) * 0.1, tw1=f(3, 8) * 0.5,
                tb1=f(3) * 0.1, tx=f(8, 6),
                ty=rs.randint(0, 3, 8).astype(np.float32))


def _parallel_references(d):
    """The same functions without a mesh: autograd through the plain
    attention, the JAX build's capacity dispatch on its own mesh, the
    dense mixture on one device, the unpipelined stage chain."""
    import jax
    from incubator_mxnet_tpu.parallel import make_mesh as jax_mesh
    from incubator_mxnet_tpu.parallel.moe import switch_moe_apply
    from incubator_mxnet_tpu_torch.ops.attention import _attention_reference
    from incubator_mxnet_tpu_torch.parallel import moe as tmoe
    t = {k: torch.tensor(v) for k, v in d.items()}
    ref = {}
    for causal in (0, 1):
        q, k, v = (t[n].clone().requires_grad_() for n in "qkv")
        o = _attention_reference(q, k, v, bool(causal))
        grads = torch.autograd.grad(o, (q, k, v), t["g"])
        ref["ring%d_out" % causal] = o.detach().numpy()
        for n, gr in zip("qkv", grads):
            ref["ring%d_d%s" % (causal, n)] = gr.numpy()
    mesh = jax_mesh({"ep": 2}, jax.devices("cpu")[:2])
    (o, drops, aux), vjp = jax.vjp(
        lambda *a: switch_moe_apply(*a, mesh, "ep", 0.5),
        *[jnp.asarray(d[n]) for n in ("x", "gw", "w1", "w2")])
    grads = vjp((2 * o, jnp.zeros_like(drops), jnp.zeros_like(aux)))
    ref["cap_out"], ref["cap_drops"] = np.asarray(o), np.asarray(drops)
    for n, gr in zip(("x", "gw", "w1", "w2"), grads):
        ref["cap_d" + n] = np.asarray(gr)
    args = [t[n].clone().requires_grad_() for n in ("x", "gw", "w1", "w2")]
    probs = torch.softmax(args[0] @ args[1], -1)
    combine = probs * tmoe._one_hot(probs.argmax(-1), 4, probs.dtype)
    o = tmoe._dense_body(None, args[0], combine, args[2], args[3])
    grads = torch.autograd.grad((o * o).sum(), args)
    ref["dense_out"] = o.detach().numpy()
    for n, gr in zip(("dx", "dgw", "dw1", "dw2"), grads):
        ref["dense_" + n] = gr.numpy()
    W, b = t["W"].clone().requires_grad_(), t["b"].clone().requires_grad_()
    a = t["px"]
    for i in range(2):
        a = torch.tanh(a @ W[i] + b[i])
    loss = ((a - t["py"]) ** 2).sum(-1).mean()
    loss.backward()
    ref["pp_loss"] = loss.detach().numpy()
    ref["pp_dW"], ref["pp_db"] = W.grad.numpy(), b.grad.numpy()
    names = ("tw0", "tb0", "tw1", "tb1")
    net = tmx.gluon.nn.HybridSequential(prefix="t_")
    net.add(tmx.gluon.nn.Dense(8, in_units=6, activation="tanh"),
            tmx.gluon.nn.Dense(3, in_units=8))
    net.initialize(ctx=tmx.cpu())
    for p, n in zip(net.collect_params().values(), names):
        p.set_data(tmx.nd.array(d[n], ctx=tmx.cpu()))
    tr = tmx.parallel.DataParallelTrainer(
        net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        {"learning_rate": 0.5})
    for _ in range(2):
        ref["tp_loss"] = tr.step(tmx.nd.array(d["tx"], ctx=tmx.cpu()),
                                 tmx.nd.array(d["ty"], ctx=tmx.cpu())
                                 ).asnumpy()
    tr.sync_params()
    for p, n in zip(net.collect_params().values(), names):
        ref["tp_" + n] = p.data().asnumpy()
    return ref


def test_two_process_ring_moe_pipeline(tmp_path):
    """The rank backend (``dist.RankAxis``) of the three modules over two
    ranks: ring attention over {"dp": 1, "sp": 2} with its gradients,
    capacity and dense expert dispatch over {"ep": 2} with theirs, a GPipe
    training pass over {"pp": 2}, two DataParallelTrainer steps with a
    weight split over "tp" of {"dp": 1, "tp": 2}; the ranks bit-equal, and
    against references computed here without a mesh: ring outputs rtol
    2e-4 (atol 2e-5), ring gradients rtol 1e-3 (atol 1e-4), the rest 1e-5
    of the largest value, the capacity drops exact."""
    d = _parallel_inputs()
    np.savez(tmp_path / "inputs.npz", **d)
    out = launch(tmp_path, _PARALLEL_WORKER)
    for r in (0, 1):
        assert "WORKER %d PARALLEL OK" % r in out, out[-3000:]
    ranks = [dict(np.load(tmp_path / ("rank%d.npz" % r))) for r in (0, 1)]
    for k in ranks[0]:
        assert ranks[0][k].tobytes() == ranks[1][k].tobytes(), k
    ref = _parallel_references(d)
    assert set(ref) == set(ranks[0])
    for k, want in ref.items():
        got = ranks[0][k]
        if k == "cap_drops":
            assert np.array_equal(got, want)
        elif k.startswith("ring"):
            tol = dict(rtol=2e-4, atol=2e-5) if k.endswith("out") else \
                dict(rtol=1e-3, atol=1e-4)
            np.testing.assert_allclose(got, want, err_msg=k, **tol)
        else:
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= REL, (k, err)


# -- one process: the parameter service, and rank 0 of 1 --------------------

def test_parameter_service_matches_jax(monkeypatch):
    """Two servers, keys hashed across them and a big array cut into row
    blocks (bound 100 elements): init, SGD with momentum on the servers,
    pulls, row pulls and the heartbeat table, against the JAX build's
    service in this process (values within 1e-6)."""
    monkeypatch.setenv("MXTPU_KVSTORE_BIGARRAY_BOUND", "100")
    rs = np.random.RandomState(5)
    vals = {"w": rs.randn(30, 7).astype(np.float32),
            "b": rs.randn(7).astype(np.float32),
            "3": rs.randn(4, 2).astype(np.float32)}
    grads = [{k: rs.randn(*v.shape).astype(np.float32)
              for k, v in vals.items()} for _ in range(3)]
    got = {}
    for name, ps, mxp in (("port", tps, tmx), ("jax", jps, jmx)):
        group = ps.ServerGroup(2)
        client = ps.GroupClient(group.address, rank=0)
        try:
            client.init({k: v.copy() for k, v in vals.items()})
            assert client._big.keys() == {"w"}
            client.set_optimizer(mxp.optimizer.create(
                "sgd", learning_rate=0.1, momentum=0.9))
            for g in grads:
                client.push(g)
            pulled = client.pull(["w", "b", "3"])
            rows = client.pull_rows({"w": np.array([29, 0, 15])})["w"]
            empty = client.pull_rows({"b": np.array([], np.int64)})["b"]
            # a late client finds the blocks without having placed them
            late = ps.GroupClient(group.address)
            late_w = late.pull(["w"])["w"]
            late.close()
            dead = client.dead_nodes(window=60.0)
        finally:
            client.close()
            group.shutdown()
        got[name] = (pulled, rows, empty, late_w, dead)
    (p, r, e, lw, d), (jp, jr, je, jlw, jd) = got["port"], got["jax"]
    for k in vals:
        np.testing.assert_allclose(p[k], jp[k], rtol=1e-6, atol=1e-6)
        assert not np.allclose(p[k], vals[k])
    np.testing.assert_allclose(r, jr, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(r, p["w"][[29, 0, 15]])
    assert e.shape == je.shape == (0,)
    np.testing.assert_array_equal(lw, p["w"])
    assert d == jd == []


def test_parameter_service_resend_is_applied_once():
    """A mutation resent with the id the server already applied (its reply
    lost) is acknowledged and not applied again."""
    group = tps.ServerGroup(1)
    client = tps.PSClient(group.address)
    try:
        client.init({"k": np.zeros(3, np.float32)})
        client.push({"k": np.ones(3, np.float32)})
        again = {"cmd": "push", "kv": {"k": np.ones(3, np.float32)},
                 "client": client._client_id, "req": client._req_id}
        tps._send_msg(client._sock, again)
        assert tps._recv_msg(client._sock) == {"ok": True, "dedup": True}
        np.testing.assert_array_equal(client.pull(["k"])["k"], np.ones(3))
        with pytest.raises(RuntimeError, match="unknown cmd"):
            client._call({"cmd": "nope"})
    finally:
        client.close()
        group.shutdown()
    with pytest.raises(ConnectionError, match="closed client"):
        client.pull(["k"])


def test_dist_stores_in_one_process_are_rank_0_of_1():
    """Without a launcher every dist type is rank 0 of 1 and sums like the
    local store; dist_async runs its own server (as the JAX build)."""
    with tmx.cpu():
        for name in ("dist_sync", "dist_device_sync", "dist_async"):
            kv = tmx.kv.create(name)
            jkv = jmx.kv.create(name)
            assert (kv.type, kv.rank, kv.num_workers) == \
                (jkv.type, jkv.rank, jkv.num_workers) == (name, 0, 1)
            kv.init(5, tmx.nd.ones((2, 3)))
            kv.push(5, [tmx.nd.ones((2, 3)), tmx.nd.ones((2, 3)) * 2])
            out = tmx.nd.zeros((2, 3))
            kv.pull(5, out=out)
            want = 3.0 if name != "dist_async" else 4.0   # the server adds
            assert np.array_equal(out.asnumpy(), np.full((2, 3), want)), \
                (name, out.asnumpy())
            assert kv.num_dead_nodes() == 0 and kv.barrier() is None
            if name == "dist_async":
                kv.close()
                jkv.close()


def test_worker_mesh_and_local_context():
    mesh = tmx.parallel.dist.worker_mesh(cpu=True)
    assert mesh.shape == {"worker": 1} and mesh.kvstore == "dist_sync"
    assert list(mesh.devices.flat) == [tmx.cpu(0)]
    assert tmx.parallel.dist.local_context() == tmx.gpu(0)
    with pytest.raises(ValueError, match="kvstore must be"):
        tmx.parallel.dist.worker_mesh(kvstore="local")


def test_trainer_dist_async_update_on_kvstore_false_raises():
    with tmx.cpu():
        net = tmx.gluon.nn.Dense(2, in_units=3)
        net.initialize()
        kv = tmx.kv.create("dist_async")
        tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1}, kvstore=kv,
                               update_on_kvstore=False)
        with pytest.raises(ValueError, match="dist_async"):
            tr.step(1)
        kv.close()


def test_record_iter_shards_by_rank_match_jax(tmp_path):
    """train_imagenet.py's record path under a dist store: rank r of n reads
    ``part_index=r, num_parts=n``.  Each rank's shard is the JAX build's,
    the shards are disjoint and together they are every record."""
    from test_torch_image import _write_rec
    with tmx.cpu():
        prefix, _ = _write_rec(tmp_path, n=12)
    seen = {}
    for name, mx in (("port", tmx), ("jax", jmx)):
        for part in range(2):
            it = mx.io.ImageRecordIter(
                path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
                data_shape=(3, 8, 8), batch_size=2, dtype="uint8",
                aug_list=[], part_index=part, num_parts=2,
                preprocess_threads=1, ctx=mx.cpu(0))
            rows = []
            for b in it:
                data = b.data[0].asnumpy()
                rows += [data[i].tobytes() for i in range(2 - b.pad)]
            seen[name, part] = rows
            if hasattr(it, "close"):
                it.close()
    for part in range(2):
        assert seen["port", part] == seen["jax", part]
    assert not set(seen["port", 0]) & set(seen["port", 1])
    assert len(seen["port", 0]) == len(seen["port", 1]) == 6


# -- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_card_store_across_ranks_small(card, tmp_path):
    """16a at a small size: two ranks on the card under dist_sync, the
    invariants on card tensors, and dist_device_sync's refusal of two
    ranks on one card."""
    out = cs.dist_store_phase(tmx, "card test", tmp_path, big=1 << 16)
    assert out["ok"] and out["shared_card_refused"]


@pytest.mark.cuda
def test_card_mixed_contexts_small(card, monkeypatch):
    """16d with 180 synthetic training images: Module over [gpu(0),
    cpu(0)] within its bounds of the one-context run."""
    monkeypatch.setattr(cs, "MNIST_SYNTH", 200)
    out = cs.mixed_context_phase(tmx, "card test")
    assert all(r["max_abs_err"] <= r["bound"] and r["first_step_max_abs_err"]
               <= r["first_step_bound"] for r in out.values())
