"""Sequence and pipeline parallelism in the port against the JAX build, on
the CPU: ring attention (``parallel/ring_attention.py``, the registry op
``_contrib_RingAttention``, ``MultiHeadAttention(seq_axis=...)``), the
GPipe schedule (``parallel/pipeline.py``: ``pipeline_apply``,
``pipeline_train_step``, ``make_pipeline_trainer``, ``PipelineTrainer``)
and ``DataParallelTrainer`` over 2-D meshes (``"dp"`` with ``"sp"`` or
``"tp"``).  One counterpart for each test of ``tests/test_parallel.py``
(ring, pipeline, the dp x sp mesh), ``tests/test_parallel_surface.py`` and
the two ``"tp"`` tests of ``tests/test_model_parallel.py``.

The port's meshes are of Contexts ``cpu(0..7)`` (one torch device, a thread
a shard); the JAX build's run on its conftest's eight CPU devices.  Inputs
come from numpy under a seed, Gluon weights cross from the JAX build.
Bounds: ring outputs rtol 2e-4, atol 2e-5; ring gradients rtol 1e-3, atol
1e-4; pipelines and trainers over ``"tp"`` 1e-5 of the largest value (f32,
the same sums in other orders)."""
import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import parallel as jpar
from incubator_mxnet_tpu.ops.attention import (
    _attention_reference as jax_reference)
from incubator_mxnet_tpu_torch import parallel as tpar

# the modules (the packages export functions of the same names)
jring = importlib.import_module("incubator_mxnet_tpu.parallel.ring_attention")
jpipe = importlib.import_module("incubator_mxnet_tpu.parallel.pipeline")
tring = importlib.import_module(
    "incubator_mxnet_tpu_torch.parallel.ring_attention")
tpipe = importlib.import_module("incubator_mxnet_tpu_torch.parallel.pipeline")

RING = dict(rtol=2e-4, atol=2e-5)
RING_GRAD = dict(rtol=1e-3, atol=1e-4)
REL = 1e-5


def close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rel, "%.3e > %.0e" % (err, rel)


def jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return jpar.make_mesh(axes, jax.devices("cpu")[:n])


def tmesh(axes):
    n = int(np.prod(list(axes.values())))
    return tpar.make_mesh(axes, [tmx.cpu(i) for i in range(n)])


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _copy(jblk, tblk):
    """The JAX block's values into the port's, parameter by parameter."""
    jps = list(jblk.collect_params().values())
    tps = list(tblk.collect_params().values())
    assert [p.shape for p in jps] == [p.shape for p in tps]
    for jp, tp in zip(jps, tps):
        tp.set_data(tmx.nd.array(jp.data().asnumpy(), ctx=tmx.cpu()))


# -- ring attention (tests/test_parallel.py) ---------------------------------

def _qkv(seed, shape, n=3):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(n)]


def test_ring_attention_matches_reference():
    q, k, v = _qkv(0, (2, 4, 64, 16))
    got = tring.ring_attention(_t(q), _t(k), _t(v), tmesh({"sp": 8}), "sp")
    want = jring.ring_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jmesh({"sp": 8}), axis="sp")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RING)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_reference(*map(jnp.asarray, (q, k, v)))),
        **RING)


def test_ring_attention_causal():
    q, k, v = _qkv(1, (1, 2, 32, 8))
    got = tring.ring_attention(_t(q), _t(k), _t(v), tmesh({"sp": 4}), "sp",
                               causal=True)
    want = jring.ring_attention(*map(jnp.asarray, (q, k, v)),
                                jmesh({"sp": 4}), "sp", True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RING)


def test_ring_attention_causal_unequal_lengths_follow_jax_ring():
    """Q and K of different lengths: the mask compares global positions
    (q_pos >= k_pos) as the JAX ring does, not flash's bottom-right
    anchor."""
    rs = np.random.RandomState(12)
    q = rs.randn(1, 2, 16, 8).astype(np.float32)
    k, v = _qkv(13, (1, 2, 32, 8), 2)
    got = tring.ring_attention(_t(q), _t(k), _t(v), tmesh({"sp": 4}), "sp",
                               causal=True)
    want = jring.ring_attention(*map(jnp.asarray, (q, k, v)),
                                jmesh({"sp": 4}), "sp", True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RING)
    flash = jax_reference(*map(jnp.asarray, (q, k, v)), causal=True)
    assert np.abs(got.numpy() - np.asarray(flash)).max() > 1e-3


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_grads_match_reference(causal):
    q, k, v, g = _qkv(11, (1, 2, 32, 8), 4)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = tring.ring_attention(tq, tk, tv, tmesh({"sp": 4}), "sp", causal)
    grads = torch.autograd.grad(out, (tq, tk, tv), _t(g))
    jout, vjp = jax.vjp(lambda a, b, c: jring.ring_attention(
        a, b, c, jmesh({"sp": 4}), "sp", causal), *map(jnp.asarray,
                                                       (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **RING)
    for got, want in zip(grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **RING_GRAD)


def test_ring_attention_trains_over_dp_sp():
    """The gradient of the causal ring over the "sp" axis of a dp x sp
    mesh against the JAX build's inside jit."""
    q, k, v = _qkv(5, (2, 2, 16, 8))
    jm = jmesh({"dp": 2, "sp": 4})
    want = jax.jit(lambda a, b, c: jax.grad(
        lambda x: jring.ring_attention(x, b, c, jm, "sp", True).sum())(a))(
            *map(jnp.asarray, (q, k, v)))
    tq = _t(q, True)
    out = tring.ring_attention(tq, _t(k), _t(v), tmesh({"dp": 2, "sp": 4}),
                               "sp", True)
    (got,) = torch.autograd.grad(out.sum(), (tq,))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RING_GRAD)


def test_dp_sp_2d_mesh_attention():
    """The ring body over "sp" in each "dp" row of a 2-D mesh, the batch
    split over "dp", against the JAX build's shard_map of its body."""
    from incubator_mxnet_tpu._jax_compat import shard_map
    from jax.sharding import PartitionSpec as P
    D = 8
    q, k, v = _qkv(4, (4, 2, 32, D))
    jm = jmesh({"dp": 2, "sp": 4})
    spec, stat = P("dp", None, "sp", None), P("dp", None, "sp")
    want, _, _ = shard_map(
        functools.partial(jring._ring_body, axis_name="sp", causal=False,
                          scale=D ** -0.5), mesh=jm,
        in_specs=(spec, spec, spec), out_specs=(spec, stat, stat),
        check_vma=False)(*map(jnp.asarray, (q, k, v)))
    mesh = tmesh({"dp": 2, "sp": 4})
    rows = []
    for i in range(2):
        home = mesh.devices[i, 0]
        half = [_t(a[2 * i:2 * i + 2]) for a in (q, k, v)]
        out, _, _ = tpar.mesh.dispatch_on_mesh(
            lambda ax, a, b, c: tring._ring_body(ax, a, b, c, False,
                                                 D ** -0.5),
            mesh, "sp", (2, 2, 2), (2, 2, 2), *half,
            home=home.torch_device())
        assert tpar.mesh.axis_devices(mesh, "sp", home) == \
            list(mesh.devices[i])
        rows.append(out.numpy())
    np.testing.assert_allclose(np.concatenate(rows), np.asarray(want),
                               **RING)


# -- the pipeline (tests/test_parallel.py) -----------------------------------

def test_pipeline_matches_sequential():
    rs = np.random.RandomState(0)
    D = 16
    Ws = rs.randn(4, D, D).astype(np.float32) * 0.3
    bs = rs.randn(4, D).astype(np.float32) * 0.1
    x = rs.randn(8, D).astype(np.float32)
    got = tpipe.pipeline_apply(
        lambda p, a: torch.relu(a @ p["W"] + p["b"]),
        {"W": _t(Ws), "b": _t(bs)}, _t(x), tmesh({"pp": 4}),
        num_microbatches=4)
    want = jpipe.pipeline_apply(
        lambda p, a: jax.nn.relu(a @ p["W"] + p["b"]),
        {"W": jnp.asarray(Ws), "b": jnp.asarray(bs)}, jnp.asarray(x),
        jmesh({"pp": 4}), axis="pp", num_microbatches=4)
    close(got.numpy(), np.asarray(want))


def test_pipeline_train_step_matches_sequential():
    rs = np.random.RandomState(0)
    D = 8
    Ws = (rs.randn(4, D, D) * 0.4).astype(np.float32)
    bs = (rs.randn(4, D) * 0.1).astype(np.float32)
    x = rs.randn(8, D).astype(np.float32)
    y = rs.randn(8, D).astype(np.float32)
    tm, jm = tmesh({"pp": 4}), jmesh({"pp": 4})
    loss, grads = tpipe.pipeline_train_step(
        lambda p, a: torch.tanh(a @ p["W"] + p["b"]),
        {"W": _t(Ws), "b": _t(bs)}, _t(x), _t(y),
        lambda o, t: ((o - t) ** 2).sum(-1), tm, num_microbatches=4)
    jloss, jgrads = jpipe.pipeline_train_step(
        lambda p, a: jnp.tanh(a @ p["W"] + p["b"]),
        {"W": jnp.asarray(Ws), "b": jnp.asarray(bs)}, jnp.asarray(x),
        jnp.asarray(y), lambda o, t: jnp.sum((o - t) ** 2, axis=-1), jm,
        num_microbatches=4)
    close(float(loss), float(jloss))
    for n in ("W", "b"):
        close(grads[n].numpy(), np.asarray(jgrads[n]))
    train = tpipe.make_pipeline_trainer(
        lambda p, a: torch.tanh(a @ p["W"] + p["b"]),
        lambda o, t: ((o - t) ** 2).sum(-1), tm, num_microbatches=4,
        learning_rate=0.05)
    jtrain = jpipe.make_pipeline_trainer(
        lambda p, a: jnp.tanh(a @ p["W"] + p["b"]),
        lambda o, t: jnp.sum((o - t) ** 2, axis=-1), jm,
        num_microbatches=4, learning_rate=0.05)
    p, jp = {"W": _t(Ws), "b": _t(bs)}, {"W": jnp.asarray(Ws),
                                         "b": jnp.asarray(bs)}
    losses = []
    for _ in range(10):
        p, l = train(p, _t(x), _t(y))
        jp, jl = jtrain(jp, jnp.asarray(x), jnp.asarray(y))
        close(float(l), float(jl))
        losses.append(float(l))
    assert losses[-1] < losses[0]
    close(p["W"].numpy(), np.asarray(jp["W"]))


# -- the Gluon surface (tests/test_parallel_surface.py) ----------------------

def _stage_pair(width, n, act="tanh", seed=7):
    jmx.random.seed(seed)
    jbody, tbody = jmx.gluon.nn.HybridSequential(), \
        tmx.gluon.nn.HybridSequential()
    for _ in range(n):
        jb = jmx.gluon.nn.Dense(width, activation=act, flatten=False,
                                in_units=width)
        jb.initialize(jmx.init.Xavier(rnd_type="gaussian", magnitude=2.0))
        tb = tmx.gluon.nn.Dense(width, activation=act, flatten=False,
                                in_units=width)
        tb.initialize(ctx=tmx.cpu())
        _copy(jb, tb)
        jbody.add(jb)
        tbody.add(tb)
    return jbody, tbody


def _params_np(blk):
    return [p.data().asnumpy() for p in blk.collect_params().values()]


def test_pipeline_trainer_gluon_surface():
    """Identical stages over pp=4: the loss falls, and each step's loss and
    the final weights match the JAX build's PipelineTrainer."""
    n, width, batch = 4, 6, 8
    rs = np.random.RandomState(0)
    X = rs.randn(batch, width).astype(np.float32)
    Y = rs.randn(batch, width).astype(np.float32)
    jbody, tbody = _stage_pair(width, n)
    jtr = jpar.PipelineTrainer(jbody, jmx.gluon.loss.L2Loss(),
                               jmesh({"pp": n}), num_microbatches=4,
                               learning_rate=0.05)
    ttr = tpar.PipelineTrainer(tbody, tmx.gluon.loss.L2Loss(),
                               tmesh({"pp": n}), num_microbatches=4,
                               learning_rate=0.05)
    losses = []
    for _ in range(10):
        losses.append(float(ttr.step(X, Y)))
        close(losses[-1], float(np.asarray(jtr.step(X, Y))))
    assert losses[-1] < losses[0], losses
    ttr.sync_params()
    jtr.sync_params()
    for got, want in zip(_params_np(tbody), _params_np(jbody)):
        close(got, want)


def test_pipeline_trainer_pre_post():
    """Structurally different embed and head blocks on the first and the
    last stage."""
    n, width = 2, 6
    rs = np.random.RandomState(1)
    X = rs.randn(8, 3).astype(np.float32)
    Yl = (rs.rand(8) * 4).astype(np.float32)
    jbody, tbody = _stage_pair(width, n, seed=3)
    blocks = []
    for units, in_units in ((width, 3), (4, width)):
        jb = jmx.gluon.nn.Dense(units, flatten=False, in_units=in_units)
        jb.initialize(jmx.init.Xavier())
        tb = tmx.gluon.nn.Dense(units, flatten=False, in_units=in_units)
        tb.initialize(ctx=tmx.cpu())
        _copy(jb, tb)
        blocks.append((jb, tb))
    (jpre, tpre), (jpost, tpost) = blocks
    jtr = jpar.PipelineTrainer(jbody, jmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                               jmesh({"pp": n}), num_microbatches=2,
                               learning_rate=0.1, pre=jpre, post=jpost)
    ttr = tpar.PipelineTrainer(tbody, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                               tmesh({"pp": n}), num_microbatches=2,
                               learning_rate=0.1, pre=tpre, post=tpost)
    losses = []
    for _ in range(15):
        losses.append(float(ttr.step(X, Yl)))
        close(losses[-1], float(np.asarray(jtr.step(X, Yl))))
    assert losses[-1] < losses[0], losses
    ttr.sync_params()
    jtr.sync_params()
    for tb, jb in ((tpre, jpre), (tpost, jpost), (tbody, jbody)):
        for got, want in zip(_params_np(tb), _params_np(jb)):
            close(got, want)


def test_pipeline_trainer_stage_count_mismatch():
    body = tmx.gluon.nn.HybridSequential()
    blk = tmx.gluon.nn.Dense(4, activation="tanh", flatten=False, in_units=4)
    blk.initialize(ctx=tmx.cpu())
    body.add(blk)
    with pytest.raises(ValueError, match="stage blocks"):
        tpar.PipelineTrainer(body, tmx.gluon.loss.L2Loss(), tmesh({"pp": 2}))


def _mha_pair(E, H, causal, x, mesh_j, mesh_t, seq_axis="sp", seed=11):
    jmx.random.seed(seed)
    jblk = jmx.gluon.nn.MultiHeadAttention(E, H, causal=causal)
    jblk.initialize(jmx.init.Xavier())
    jblk(jmx.nd.array(x))
    tblk = tmx.gluon.nn.MultiHeadAttention(E, H, causal=causal,
                                           seq_axis=seq_axis)
    tblk.initialize(ctx=tmx.cpu())
    with tpar.use_mesh(mesh_t):
        tblk(tmx.nd.array(x, ctx=tmx.cpu()))
    _copy(jblk, tblk)
    return jblk, tblk


def test_multihead_attention_ring_matches_local():
    """The same layer with seq_axis='sp' (the ring over cpu(0..3)) and the
    JAX build's with seq_axis=None (flash attention), and the port's own
    local layer."""
    B, S, E, H = 2, 16, 8, 2
    x = np.random.RandomState(0).randn(B, S, E).astype(np.float32)
    mesh = tmesh({"sp": 4})
    for causal in (False, True):
        jblk, tblk = _mha_pair(E, H, causal, x, None, mesh)
        local = tmx.gluon.nn.MultiHeadAttention(E, H, causal=causal)
        local.initialize(ctx=tmx.cpu())
        local(tmx.nd.array(x, ctx=tmx.cpu()))
        _copy(jblk, local)
        with tpar.use_mesh(mesh):
            out = tblk(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy()
        want = jblk(jmx.nd.array(x)).asnumpy()
        np.testing.assert_allclose(out, want, **RING)
        np.testing.assert_allclose(
            out, local(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy(), **RING)


def test_multihead_attention_trains_with_sp():
    """The gradients of every weight through the ring's backward against
    the JAX build's local layer's."""
    B, S, E, H = 2, 8, 8, 2
    rs = np.random.RandomState(2)
    x = rs.randn(B, S, E).astype(np.float32)
    y = rs.randn(B, S, E).astype(np.float32)
    jblk, tblk = _mha_pair(E, H, True, x, None, tmesh({"sp": 2}), seed=5)
    with jmx.autograd.record():
        jl = jmx.gluon.loss.L2Loss()(jblk(jmx.nd.array(x)), jmx.nd.array(y))
    jl.backward()
    with tpar.use_mesh(tmesh({"sp": 2})):
        with tmx.autograd.record():
            tl = tmx.gluon.loss.L2Loss()(tblk(tmx.nd.array(x,
                                                           ctx=tmx.cpu())),
                                         tmx.nd.array(y, ctx=tmx.cpu()))
        tl.backward()
    for jp, tp in zip(jblk.collect_params().values(),
                      tblk.collect_params().values()):
        np.testing.assert_allclose(tp.grad().asnumpy(), jp.grad().asnumpy(),
                                   **RING_GRAD)


def test_ring_attention_requires_mesh():
    blk = tmx.gluon.nn.MultiHeadAttention(8, 2, seq_axis="sp")
    blk.initialize(ctx=tmx.cpu())
    x = tmx.nd.array(np.random.rand(1, 4, 8).astype(np.float32),
                     ctx=tmx.cpu())
    with pytest.raises(RuntimeError, match="no device mesh"):
        blk(x)
    with tpar.use_mesh(tmesh({"dp": 2})):
        with pytest.raises(ValueError, match="no axis 'sp'"):
            tmx.nd._contrib_RingAttention(*[tmx.nd.ones((1, 2, 4, 4),
                                                        ctx=tmx.cpu())] * 3)


def _sp_net(mx, mesh_scope, x, seed=9):
    mx.random.seed(seed)
    net = mx.gluon.nn.HybridSequential(prefix="spnet_")
    with net.name_scope():
        net.add(mx.gluon.nn.MultiHeadAttention(8, 2, causal=True,
                                               seq_axis="sp"))
        net.add(mx.gluon.nn.Dense(4, flatten=False))
    kw = {} if mx is jmx else {"ctx": tmx.cpu()}
    net.initialize(mx.init.Xavier(), **kw)
    with mesh_scope:
        net(mx.nd.array(x, **kw))
    return net


def test_multihead_attention_sp_in_fused_trainer():
    """MultiHeadAttention(seq_axis='sp') inside DataParallelTrainer over a
    dp x sp mesh: each step's loss against the JAX build's jitted step from
    the same weights, and the loss falls."""
    B, S = 4, 8
    rs = np.random.RandomState(4)
    x = rs.randn(B, S, 8).astype(np.float32)
    y = (rs.rand(B, S) * 4).astype(np.float32)
    jm, tm = jmesh({"dp": 2, "sp": 4}), tmesh({"dp": 2, "sp": 4})
    jnet = _sp_net(jmx, jpar.use_mesh(jm), x)
    tnet = _sp_net(tmx, tpar.use_mesh(tm), x)
    _copy(jnet, tnet)
    jtr = jpar.DataParallelTrainer(
        jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        {"learning_rate": 0.1}, mesh=jm)
    ttr = tpar.DataParallelTrainer(
        tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        {"learning_rate": 0.1}, mesh=tm)
    losses = []
    for _ in range(16):
        losses.append(float(ttr.step(tmx.nd.array(x, ctx=tmx.cpu()),
                                     tmx.nd.array(y, ctx=tmx.cpu()))
                            .asscalar()))
        with jpar.use_mesh(jm):
            want = float(np.asarray(jtr.step(jmx.nd.array(x),
                                              jmx.nd.array(y))))
        np.testing.assert_allclose(losses[-1], want, **RING)
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0]


def test_pipeline_trainer_rejects_divergent_stage_compute():
    body = tmx.gluon.nn.HybridSequential()
    for act in ("tanh", "relu"):
        blk = tmx.gluon.nn.Dense(4, activation=act, flatten=False,
                                 in_units=4)
        blk.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
        body.add(blk)
    tr = tpar.PipelineTrainer(body, tmx.gluon.loss.L2Loss(),
                              tmesh({"pp": 2}), num_microbatches=2)
    X = np.random.RandomState(0).randn(4, 4).astype(np.float32)
    with pytest.raises(ValueError, match="computes differently"):
        tr.step(X, X)


def test_pipeline_trainer_batchnorm_stages():
    """Stages holding BatchNorm (training-mode sensitive) pass the stage
    probe and train as the JAX build's do (the running statistics of the
    scheduled stages are not kept, in either build)."""
    def stage(mx):
        s = mx.gluon.nn.HybridSequential()
        s.add(mx.gluon.nn.Dense(6, flatten=False, in_units=6))
        s.add(mx.gluon.nn.BatchNorm(axis=-1, in_channels=6))
        s.add(mx.gluon.nn.Activation("tanh"))
        return s

    jmx.random.seed(13)
    jbody, tbody = jmx.gluon.nn.HybridSequential(), \
        tmx.gluon.nn.HybridSequential()
    for _ in range(2):
        js, ts = stage(jmx), stage(tmx)
        js.initialize(jmx.init.Xavier())
        ts.initialize(ctx=tmx.cpu())
        _copy(js, ts)
        jbody.add(js)
        tbody.add(ts)
    X = np.random.RandomState(1).randn(4, 6).astype(np.float32)
    jtr = jpar.PipelineTrainer(jbody, jmx.gluon.loss.L2Loss(),
                               jmesh({"pp": 2}), num_microbatches=2,
                               learning_rate=0.05)
    ttr = tpar.PipelineTrainer(tbody, tmx.gluon.loss.L2Loss(),
                               tmesh({"pp": 2}), num_microbatches=2,
                               learning_rate=0.05)
    for _ in range(5):
        got = float(ttr.step(X, X))
        assert np.isfinite(got)
        close(got, float(np.asarray(jtr.step(X, X))))


# -- tensor parallelism (tests/test_model_parallel.py) ------------------------

def _toy():
    rng = np.random.RandomState(0)
    x = rng.randn(16, 8).astype(np.float32)
    y = (rng.rand(16) * 3).astype(np.float32)
    return x, y


def _mlp_pair():
    jmx.random.seed(3)
    jnet = jmx.gluon.nn.HybridSequential()
    jnet.add(jmx.gluon.nn.Dense(32, activation="relu", in_units=8))
    jnet.add(jmx.gluon.nn.Dense(3, in_units=32))
    jnet.initialize(jmx.init.Xavier())
    tnet = tmx.gluon.nn.HybridSequential()
    tnet.add(tmx.gluon.nn.Dense(32, activation="relu", in_units=8))
    tnet.add(tmx.gluon.nn.Dense(3, in_units=32))
    tnet.initialize(ctx=tmx.cpu())
    _copy(jnet, tnet)
    return jnet, tnet


def _shard_tp(net, n):
    for p in net.collect_params().values():
        if p.shape and p.shape[0] % n == 0:
            p.sharding = ("tp",) + (None,) * (len(p.shape) - 1)


def test_tp_sharded_training_matches_replicated():
    """Weights split over "tp" of a dp x tp mesh train to the losses of
    replicated training, and to the JAX build's."""
    x, y = _toy()
    losses = {}
    for mode in ("replicated", "tp"):
        jnet, tnet = _mlp_pair()
        if mode == "tp":
            _shard_tp(jnet, 4)
            _shard_tp(tnet, 4)
        jtr = jpar.DataParallelTrainer(
            jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            {"learning_rate": 0.1}, mesh=jmesh({"dp": 2, "tp": 4}))
        ttr = tpar.DataParallelTrainer(
            tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            {"learning_rate": 0.1}, mesh=tmesh({"dp": 2, "tp": 4}))
        for _ in range(5):
            got = float(ttr.step(tmx.nd.array(x, ctx=tmx.cpu()),
                                 tmx.nd.array(y, ctx=tmx.cpu())).asscalar())
            close(got, float(np.asarray(jtr.step(jmx.nd.array(x),
                                                 jmx.nd.array(y)))))
        losses[mode] = got
        ttr.sync_params()
        jtr.sync_params()
        for a, b in zip(_params_np(tnet), _params_np(jnet)):
            close(a, b)
    assert abs(losses["replicated"] - losses["tp"]) < 1e-4


def test_tp_param_placement():
    """A weight annotated ("tp", None) keeps its master copy and optimizer
    state as one shard on each device of the replica's "tp" row."""
    _, tnet = _mlp_pair()
    for p in tnet.collect_params().values():
        if len(p.shape) == 2 and p.shape[0] == 32:
            p.sharding = ("tp", None)
    mesh = tmesh({"dp": 2, "tp": 4})
    x, y = _toy()
    tr = tpar.DataParallelTrainer(tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                                  "sgd", {"learning_rate": 0.1,
                                          "momentum": 0.9}, mesh=mesh)
    tr.step(tmx.nd.array(x, ctx=tmx.cpu()), tmx.nd.array(y, ctx=tmx.cpu()))
    sharded = {n: v for n, v in tr._params.items() if isinstance(v, tuple)}
    assert list(sharded) == [tnet[0].weight.name]
    assert [s.shape for s in sharded[tnet[0].weight.name]] == [(8, 8)] * 4
    assert [len(r.opt_state[tnet[0].weight.name]) for r in tr._replicas] \
        == [4, 4]
    assert [r.ctx for r in tr._replicas] == [tmx.cpu(0), tmx.cpu(4)]


def test_trainer_over_rank_axes_is_deterministic(monkeypatch):
    """Over a mesh of ranks with an axis besides "dp" the ranks replicate
    weights that no all-reduce brings back into line: the trainer's step
    runs under torch's deterministic algorithms, and leaves the setting as
    it found it; over "dp" alone it does not switch them on."""
    from incubator_mxnet_tpu_torch.parallel.mesh import Mesh
    x, y = _toy()
    seen = {}
    for axes in ({"dp": 1, "sp": 2}, {"dp": 1}):
        _, tnet = _mlp_pair()
        inner = tnet.hybrid_forward_dispatch

        def spy(*a, _inner=inner, _key=str(axes), **k):
            seen[_key] = torch.are_deterministic_algorithms_enabled()
            return _inner(*a, **k)

        monkeypatch.setattr(tnet, "hybrid_forward_dispatch", spy)
        shape = tuple(axes.values())
        devs = np.array([tmx.cpu(0)] * int(np.prod(shape)),
                        dtype=object).reshape(shape)
        mesh = Mesh(devs, tuple(axes), kvstore="dist_sync")
        tr = tpar.DataParallelTrainer(
            tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            {"learning_rate": 0.1}, mesh=mesh)
        tr.step(tmx.nd.array(x, ctx=tmx.cpu()),
                tmx.nd.array(y, ctx=tmx.cpu()))
        assert not torch.are_deterministic_algorithms_enabled()
    assert seen == {str({"dp": 1, "sp": 2}): True, str({"dp": 1}): False}


# -- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_card_ring_attention_over_contexts(card):
    """The ring over a one-process mesh of two contexts on the card
    against flash attention's bf16 kernel (17b's layer bound), and its
    backward against the plain version's in f32."""
    mesh = tpar.make_mesh({"sp": 2}, [tmx.gpu(0), tmx.gpu(0)])
    from incubator_mxnet_tpu_torch.ops.attention import (
        flash_attention, _attention_reference)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((2, 4, 256, 64), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    got = tring.ring_attention(q, k, v, mesh, "sp", True)
    want = flash_attention(q, k, v, True)
    assert float((got.float() - want.float()).abs().max()) <= \
        2e-2 * float(want.float().abs().max())
    qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
    out = tring.ring_attention(qf, kf, vf, mesh, "sp", True)
    g = torch.randn(out.shape, generator=gen, device="cuda")
    grads = torch.autograd.grad(out, (qf, kf, vf), g)
    ref = torch.autograd.grad(_attention_reference(qf, kf, vf, True),
                              (qf, kf, vf), g)
    for a, b in zip(grads, ref):
        torch.testing.assert_close(a, b, **RING_GRAD)


@pytest.mark.cuda
def test_card_pipeline_over_contexts(card):
    """pipeline_train_step over two contexts on the card against the
    unpipelined chain in f32."""
    mesh = tpar.make_mesh({"pp": 2}, [tmx.gpu(0), tmx.gpu(0)])
    gen = torch.Generator(device="cuda").manual_seed(1)
    Ws = torch.randn((2, 64, 64), generator=gen, device="cuda") * 0.1
    x = torch.randn((16, 64), generator=gen, device="cuda")
    y = torch.randn((16, 64), generator=gen, device="cuda")
    loss, grads = tpipe.pipeline_train_step(
        lambda p, a: torch.tanh(a @ p["W"]), {"W": Ws}, x, y,
        lambda o, t: ((o - t) ** 2).sum(-1), mesh, num_microbatches=4)
    W = Ws.clone().requires_grad_()
    ref = ((torch.tanh(torch.tanh(x @ W[0]) @ W[1]) - y) ** 2).sum(-1).mean()
    ref.backward()
    torch.testing.assert_close(loss, ref.detach(), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(grads["W"], W.grad, rtol=1e-4, atol=1e-5)
