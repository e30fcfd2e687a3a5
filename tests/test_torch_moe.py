"""Expert parallelism in the port against the JAX build, on the CPU:
``parallel/moe.py`` (``ExpertParallelMoE``, dense and capacity dispatch,
``switch_moe_apply``) and ``DataParallelTrainer`` over dp x ep meshes.  One
counterpart for each test of ``tests/test_moe_capacity.py`` and the two MoE
tests of ``tests/test_model_parallel.py``.

The port's meshes are of Contexts ``cpu(0..7)``; the JAX build's run on
its conftest's eight CPU devices.  Inputs from numpy under a seed, weights
crossed from the JAX build.  Bounds: outputs, gradients and trajectories
1e-5 of the largest value (f32, the same sums in other orders; the expert
sums of the dense path are added per shard); ``last_drop_fraction`` and
the capacity slots exact."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import parallel as jpar
from incubator_mxnet_tpu.parallel import moe as jmoe
from incubator_mxnet_tpu_torch import parallel as tpar
from incubator_mxnet_tpu_torch.parallel import moe as tmoe

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


def _pair(x, seed=1, jscope=None, tscope=None, **kw):
    """The JAX layer (Xavier under ``seed``) and the port's with its
    weights, deferred shapes resolved on ``x``."""
    jmx.random.seed(seed)
    jblk = jpar.ExpertParallelMoE(**kw)
    jblk.initialize(jmx.init.Xavier())
    tblk = tpar.ExpertParallelMoE(**kw)
    tblk.initialize(ctx=tmx.cpu())
    with (jscope or _null()):
        jblk(jmx.nd.array(x))
    with (tscope or _null()):
        tblk(tmx.nd.array(x, ctx=tmx.cpu()))
    for jp, tp in zip(jblk.collect_params().values(),
                      tblk.collect_params().values()):
        tp.set_data(tmx.nd.array(jp.data().asnumpy(), ctx=tmx.cpu()))
    return jblk, tblk


class _null(object):
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


# -- tests/test_model_parallel.py -------------------------------------------

def test_moe_eager_and_topk():
    rng = np.random.RandomState(2)
    x = rng.randn(4, 8).astype(np.float32)
    jblk, tblk = _pair(x, hidden_size=16, num_experts=8, top_k=2)
    out = tblk(tmx.nd.array(x, ctx=tmx.cpu()))
    assert out.shape == (4, 8)
    assert tblk.expert_w1.sharding == ("ep", None, None)
    assert tblk.gate_weight.shape == (8, 8)
    close(out.asnumpy(), jblk(jmx.nd.array(x)).asnumpy())
    close(tblk.last_aux_loss, jblk.last_aux_loss)
    # top_k == num_experts: the dense soft mixture
    jblk2, tblk2 = _pair(x, seed=3, hidden_size=16, num_experts=4, top_k=4)
    close(tblk2(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy(),
          jblk2(jmx.nd.array(x)).asnumpy())


def _toy():
    rng = np.random.RandomState(0)
    x = rng.randn(16, 8).astype(np.float32)
    y = (rng.rand(16) * 3).astype(np.float32)
    return x, y


def _moe_nets(x, dispatch="dense", capacity_factor=1.25, seed=1, E=4,
              h=16, classes=3, jscope=None, tscope=None):
    jmx.random.seed(seed)
    jnet = jmx.gluon.nn.HybridSequential()
    jnet.add(jpar.ExpertParallelMoE(hidden_size=h, num_experts=E, top_k=1,
                                    dispatch=dispatch,
                                    capacity_factor=capacity_factor))
    jnet.add(jmx.gluon.nn.Dense(classes))
    jnet.initialize(jmx.init.Xavier())
    tnet = tmx.gluon.nn.HybridSequential()
    tnet.add(tpar.ExpertParallelMoE(hidden_size=h, num_experts=E, top_k=1,
                                    dispatch=dispatch,
                                    capacity_factor=capacity_factor))
    tnet.add(tmx.gluon.nn.Dense(classes))
    tnet.initialize(ctx=tmx.cpu())
    with (jscope or _null()):
        jnet(jmx.nd.array(x))
    with (tscope or _null()):
        tnet(tmx.nd.array(x, ctx=tmx.cpu()))
    for jp, tp in zip(jnet.collect_params().values(),
                      tnet.collect_params().values()):
        tp.set_data(tmx.nd.array(jp.data().asnumpy(), ctx=tmx.cpu()))
    return jnet, tnet


def test_moe_expert_parallel_training():
    """Dense dispatch in DataParallelTrainer over dp x ep with adam: each
    step's loss against the JAX build's, the loss falls, and the expert
    weights stay split over "ep"."""
    x, y = _toy()
    jnet, tnet = _moe_nets(x)
    jtr = jpar.DataParallelTrainer(
        jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        {"learning_rate": 0.01}, mesh=jmesh({"dp": 2, "ep": 4}))
    ttr = tpar.DataParallelTrainer(
        tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        {"learning_rate": 0.01}, mesh=tmesh({"dp": 2, "ep": 4}))
    losses = []
    for _ in range(31):
        losses.append(float(ttr.step(tmx.nd.array(x, ctx=tmx.cpu()),
                                     tmx.nd.array(y, ctx=tmx.cpu()))
                            .asscalar()))
        close(losses[-1], float(np.asarray(jtr.step(jmx.nd.array(x),
                                                    jmx.nd.array(y)))))
    assert losses[-1] < losses[0]
    w1 = ttr._params[tnet[0].expert_w1.name]
    assert isinstance(w1, tuple) and [s.shape[0] for s in w1] == [1] * 4


# -- tests/test_moe_capacity.py ---------------------------------------------

def test_capacity_matches_dense_when_no_overflow():
    """Top-1 routing with room for every token: the all-to-all dispatch
    reproduces the dense path, and the JAX build's."""
    E, d, h, N = 4, 6, 10, 16
    x = np.random.RandomState(0).randn(N, d).astype(np.float32)
    tm, jm = tmesh({"ep": 4}), jmesh({"ep": 4})
    jd, td = _pair(x, hidden_size=h, num_experts=E, top_k=1)
    _, tc = _pair(x, seed=1, jscope=jpar.use_mesh(jm),
                  tscope=tpar.use_mesh(tm), hidden_size=h, num_experts=E,
                  top_k=1, dispatch="capacity", capacity_factor=64.0)
    out_dense = td(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy()
    with tpar.use_mesh(tm):
        out_cap = tc(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy()
    np.testing.assert_allclose(out_cap, out_dense, rtol=2e-5, atol=2e-6)
    close(out_dense, jd(jmx.nd.array(x)).asnumpy())
    assert tc.last_drop_fraction == 0.0


def test_capacity_overflow_drops_and_reports():
    """A tiny capacity drops the overflow (output 0) and reports the share:
    the output and the drop fraction equal the JAX build's."""
    E, d, h, N = 2, 4, 6, 16
    x = np.random.RandomState(3).randn(N, d).astype(np.float32)
    tm, jm = tmesh({"ep": 2}), jmesh({"ep": 2})
    jb, tb = _pair(x, seed=3, jscope=jpar.use_mesh(jm),
                   tscope=tpar.use_mesh(tm), hidden_size=h, num_experts=E,
                   top_k=1, dispatch="capacity", capacity_factor=0.25)
    with tpar.use_mesh(tm):
        out = tb(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy()
    with jpar.use_mesh(jm):
        want = jb(jmx.nd.array(x)).asnumpy()
    close(out, want)
    assert tb.last_drop_fraction == jb.last_drop_fraction
    assert tb.last_drop_fraction >= 0.5
    assert np.sum(np.all(out == 0.0, axis=-1)) >= N // 2


def test_capacity_gradients_match_jax():
    """switch_moe_apply's gradients (input, gate, both expert weights)
    through the two all-to-alls against jax.vjp of the JAX build's."""
    rs = np.random.RandomState(5)
    E, d, h, N = 4, 6, 10, 16
    x = rs.randn(N, d).astype(np.float32)
    gw = rs.randn(d, E).astype(np.float32)
    w1 = (rs.randn(E, d, h) * 0.3).astype(np.float32)
    w2 = (rs.randn(E, h, d) * 0.3).astype(np.float32)
    for cf in (0.5, 8.0):
        ts = [torch.tensor(a, requires_grad=True) for a in (x, gw, w1, w2)]
        out, drops, aux = tmoe.switch_moe_apply(*ts, tmesh({"ep": 4}), "ep",
                                                cf)
        grads = torch.autograd.grad((out * out).sum(), ts)
        jm = jmesh({"ep": 4})
        (jout, jdrops, jaux), vjp = jax.vjp(
            lambda *a: jmoe.switch_moe_apply(*a, jm, "ep", cf),
            *map(jnp.asarray, (x, gw, w1, w2)))
        jgrads = vjp((2 * jout, jnp.zeros_like(jdrops),
                      jnp.zeros_like(jaux)))
        close(out.detach().numpy(), np.asarray(jout))
        assert np.array_equal(drops.detach().numpy(), np.asarray(jdrops))
        close(aux.detach().numpy(), np.asarray(jaux))
        for got, want in zip(grads, jgrads):
            close(got.numpy(), np.asarray(want))


def test_capacity_dispatch_trains_in_fused_trainer():
    """dispatch='capacity' inside DataParallelTrainer over dp x ep: the
    all-to-alls run in the step and the model trains (each dp replica
    routes its own shard of the batch, so its capacity is counted on that
    shard, where the JAX build's one program routes the whole batch)."""
    rs = np.random.RandomState(5)
    x = rs.randn(16, 6).astype(np.float32)
    y = (rs.rand(16) > 0.5).astype(np.float32)
    mesh = tmesh({"dp": 2, "ep": 4})
    _, tnet = _moe_nets(x, "capacity", 2.0, seed=4, h=8, classes=2,
                        jscope=jpar.use_mesh(jmesh({"dp": 2, "ep": 4})),
                        tscope=tpar.use_mesh(mesh))
    with tpar.use_mesh(mesh):
        tr = tpar.DataParallelTrainer(
            tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            {"learning_rate": 0.2}, mesh=mesh)
        args = (tmx.nd.array(x, ctx=tmx.cpu()), tmx.nd.array(y, ctx=tmx.cpu()))
        l0 = float(tr.step(*args).asscalar())
        for _ in range(25):
            l = float(tr.step(*args).asscalar())
    assert np.isfinite(l) and l < l0, (l0, l)


def test_capacity_rejects_topk():
    with pytest.raises(ValueError, match="top-1"):
        tpar.ExpertParallelMoE(hidden_size=4, num_experts=4, top_k=2,
                               dispatch="capacity")
    with pytest.raises(ValueError, match="dispatch"):
        tpar.ExpertParallelMoE(hidden_size=4, num_experts=4,
                               dispatch="sparse")


def test_capacity_trainer_without_ambient_scope():
    """The trainer scopes its own mesh for the step: no use_mesh around
    it."""
    rs = np.random.RandomState(6)
    x = rs.randn(16, 6).astype(np.float32)
    y = (rs.rand(16) > 0.5).astype(np.float32)
    mesh = tmesh({"dp": 2, "ep": 4})
    _, tnet = _moe_nets(x, "capacity", 2.0, seed=6, h=8, classes=2,
                        jscope=jpar.use_mesh(jmesh({"dp": 2, "ep": 4})),
                        tscope=tpar.use_mesh(mesh))
    tr = tpar.DataParallelTrainer(tnet,
                                  tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                                  "sgd", {"learning_rate": 0.1}, mesh=mesh)
    l = float(tr.step(tmx.nd.array(x, ctx=tmx.cpu()),
                      tmx.nd.array(y, ctx=tmx.cpu())).asscalar())
    assert np.isfinite(l)
    with pytest.raises(RuntimeError, match="no device mesh"):
        tnet(tmx.nd.array(x, ctx=tmx.cpu()))
    with tpar.use_mesh(tmesh({"dp": 2})):
        with pytest.raises(ValueError, match="no axis 'ep'"):
            tnet(tmx.nd.array(x, ctx=tmx.cpu()))


def test_router_receives_gradient_dense():
    """Top-1 dense combine scaled by the router's probability: the gate has
    a gradient, hybridized too, equal to the JAX build's."""
    E, d, h, N = 4, 6, 8, 16
    x = np.random.RandomState(7).randn(N, d).astype(np.float32)
    jblk, tblk = _pair(x, seed=8, hidden_size=h, num_experts=E, top_k=1)
    jblk.hybridize()
    tblk.hybridize()
    grads = []
    for mx, blk, kw in ((jmx, jblk, {}), (tmx, tblk, {"ctx": tmx.cpu()})):
        with mx.autograd.record():
            out = blk(mx.nd.array(x, **kw))
            loss = (out * out).sum()
        loss.backward()
        grads.append(blk.gate_weight.grad().asnumpy())
    assert np.abs(grads[0]).sum() > 0
    close(grads[0], grads[1])


def test_router_receives_gradient_capacity():
    """In capacity dispatch the gate trains through the combine's scale."""
    rs = np.random.RandomState(8)
    x = rs.randn(16, 6).astype(np.float32)
    y = (rs.rand(16) > 0.5).astype(np.float32)
    mesh = tmesh({"dp": 2, "ep": 4})
    _, tnet = _moe_nets(x, "capacity", 4.0, seed=8, h=8, classes=2,
                        jscope=jpar.use_mesh(jmesh({"dp": 2, "ep": 4})),
                        tscope=tpar.use_mesh(mesh))
    moe = tnet[0]
    gate0 = moe.gate_weight.data().asnumpy().copy()
    tr = tpar.DataParallelTrainer(tnet,
                                  tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                                  "sgd", {"learning_rate": 0.5}, mesh=mesh)
    for _ in range(3):
        tr.step(tmx.nd.array(x, ctx=tmx.cpu()),
                tmx.nd.array(y, ctx=tmx.cpu()))
    tr.sync_params()
    assert not np.allclose(gate0, moe.gate_weight.data().asnumpy())


def test_capacity_reports_aux_loss():
    E, d, h, N = 2, 4, 6, 16
    x = np.random.RandomState(9).randn(N, d).astype(np.float32)
    tm, jm = tmesh({"ep": 2}), jmesh({"ep": 2})
    jb, tb = _pair(x, seed=9, jscope=jpar.use_mesh(jm),
                   tscope=tpar.use_mesh(tm), hidden_size=h, num_experts=E,
                   top_k=1, dispatch="capacity", capacity_factor=8.0)
    with tpar.use_mesh(tm):
        tb(tmx.nd.array(x, ctx=tmx.cpu()))
    with jpar.use_mesh(jm):
        jb(jmx.nd.array(x))
    # >= 1 always (Cauchy-Schwarz), 1 at uniform routing
    assert tb.last_aux_loss is not None and tb.last_aux_loss >= 1.0 - 1e-5
    close(tb.last_aux_loss, jb.last_aux_loss)
