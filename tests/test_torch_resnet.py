"""ResNet-50 v1 of the model zoo in the PyTorch port against the JAX build, on
the CPU.

``resnet50_v1(thumbnail=True, classes=10)`` (the whole ResNet-50 structure,
23.6M parameters, a 3x3 stem for 32x32 inputs) from the same f32 weights
(``convert.load_numpy_params``; BatchNorm's gamma, beta and running
statistics drawn away from their init so that every term counts), batch 4
of seeded 32x32 images and labels.  The JAX side runs jitted
(``functionalize``, ``DataParallelTrainer``), not op by op.

Why the bounds differ from test to test.  A deep post-activation ResNet
with BatchNorm in training mode is ill-conditioned at its initialization:
its gradients grow ~40x from the head to the stem, and relu's derivative
jumps at 0, so rounding differences of 1e-7 in the forward (summation
orders of the convolutions) flip a few relu masks and move the gradients
by a few percent.  The JAX build itself shows it: moving its input by one
f32 ulp moves its gradients by 2.0-2.5% (relative L2 per tensor) and its
weights after 3 SGD steps as much as the port's differ from it.  So:

* inference forward, the running statistics after one step (they depend
  only on the first forward): 1e-5 relative, the f32 rounding of both
  builds; the training-mode logits and loss: 1e-4 relative (measured
  2.4e-5: 48 batch-normalized layers, each dividing by a standard
  deviation computed from as few as 64 values, carry the rounding
  differences forward);
* every gradient of one training step: relative L2 per tensor <= 0.1 (4x
  the JAX build's own spread under a one-ulp input change); the 1x1
  convolutions' biases feed BatchNorm, which removes any constant, so
  their true gradient is 0 and both builds give rounding noise: |g| <=
  1e-5 of the largest gradient;
* each bottleneck unit alone (V1 and V2, 8x8 inputs, where no relu input
  lies within rounding of 0): every gradient within 1e-5 of its largest
  value, element by element;
* 3 ``DataParallelTrainer`` steps and 2 eager ``gluon.Trainer`` steps,
  each run by the port from the JAX build's state before it (weights,
  momenta, running statistics; two runs from one start part after a step
  as the gradients above do, so whole trajectories are not comparable):
  the loss and the running statistics as the training-mode forward
  above, each weight's update and momentum as the gradients above;
* bf16 compute over f32 master weights, the same steps: the loss, each
  running statistic and each update within 2x the JAX build's own
  distance between its bf16 and its f32 first step from the same state
  (bf16 activations through 48 layers differ by a few percent between the
  two builds: XLA keeps fused intermediates in f32 where the port rounds
  each op), or the BF16_STEP floor; the running statistics stay f32 and
  are blended exactly once a step from the f32 batch statistics.

Also: the parameter names of the ten ResNet factories
(``tests/data/zoo_param_names.json``), ``get_model``, ``pretrained=True``
raising, and relu's gradient at 0 (the port's 0, MXNet's ``relu_grad``;
the JAX build's ``jnp.maximum`` passes 0.5 there, a reference-side
difference).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.gluon.block import functionalize as jax_functionalize
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
from incubator_mxnet_tpu.parallel import DataParallelTrainer as JaxDPT
from incubator_mxnet_tpu.parallel import make_mesh as jax_make_mesh
from incubator_mxnet_tpu_torch.convert import load_numpy_params
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision

BATCH, CLASSES, STEPS = 4, 10, 3
OPT = {"learning_rate": 0.01, "momentum": 0.9}
F32_REL = 1e-5
TRAIN_FWD_REL = 1e-4
GRAD_REL_L2 = 0.1
# one bf16 step from the same state: (loss, running statistics, updates)
BF16_STEP = (2e-2, 2e-2, 0.25)

_SNAP = json.load(open(os.path.join(os.path.dirname(__file__), "data",
                                    "zoo_param_names.json")))


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


@pytest.fixture(scope="module")
def start():
    """(images, labels, f32 weights by name, the JAX net holding them)."""
    jmx.random.seed(0)      # the JAX build's Xavier draws, fixed per run
    rs = np.random.RandomState(0)
    x = rs.standard_normal((BATCH, 3, 32, 32)).astype(np.float32)
    y = rs.randint(0, CLASSES, (BATCH,)).astype(np.float32)
    jnet = jvision.resnet50_v1(thumbnail=True, classes=CLASSES)
    jnet.initialize(jmx.init.Xavier())
    with jmx.autograd.predict_mode():
        jnet(jmx.nd.array(x))            # resolves the deferred shapes
    params = {}
    for name, p in jnet.collect_params().items():
        v = p.data().asnumpy()
        if name.endswith("gamma") or name.endswith("running_var"):
            v = rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif name.endswith("beta") or name.endswith("running_mean"):
            v = (0.1 * rs.standard_normal(v.shape)).astype(np.float32)
        params[name] = v
        p.set_data(jmx.nd.array(v))
    return x, y, params, jnet


def _port_net(params):
    net = tvision.resnet50_v1(thumbnail=True, classes=CLASSES)
    load_numpy_params(net, params, tmx.cpu())
    return net


def _short(net, weights):
    return {n[len(net.prefix):]: a for n, a in weights.items()}


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


def _close(got, want, rel):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= rel * scale, (err, rel * scale)


@pytest.mark.parametrize("factory", sorted(f for f in _SNAP
                                           if f.startswith("resnet")))
def test_resnet_param_names_match_snapshot(factory):
    net = getattr(tvision, factory)()
    got = sorted(k[len(net.prefix):] for k in net.collect_params().keys())
    assert got == _SNAP[factory]
    if factory == "resnet50_v1":
        assert len(got) == 299


def test_get_model_and_pretrained():
    net = tvision.get_model("ResNet18_v2", classes=3)
    assert isinstance(net, tvision.ResNetV2)
    assert tmx.gluon.model_zoo.get_model is tvision.get_model
    for name in ("vgg17", "resnet51_v1"):
        with pytest.raises(ValueError, match="not supported"):
            tvision.get_model(name)
    with pytest.raises(tmx.MXNetError, match="weight files"):
        tvision.resnet50_v1(pretrained=True)
    with pytest.raises(ValueError, match="Invalid number of layers"):
        tvision.get_resnet(1, 51)
    blocks = [b for stage in tvision.resnet50_v2(thumbnail=True)
              .features._children for b in getattr(stage, "_children", [])
              if isinstance(b, tvision.resnet._ResidualUnit)]
    assert len(blocks) == 16 and all(isinstance(b, tvision.BottleneckV2)
                                     for b in blocks)


def test_convert_carries_every_parameter_running_stats_included(start):
    """``load_numpy_params`` matches all 295 names of the JAX build's
    thumbnail ResNet-50 (299 less the stem's BatchNorm) by suffix, the
    running statistics too, which take no gradient, and ``numpy_params`` gives them back unchanged; a missing
    name raises."""
    from incubator_mxnet_tpu_torch.convert import numpy_params
    _, _, params, jnet = start
    net = _port_net(params)
    back = numpy_params(net)
    assert len(back) == len(params) == 295
    want = _short(jnet, params)
    for n, v in _short(net, back).items():
        np.testing.assert_array_equal(v, want[n])
    assert sum("running" in n for n in want) == 2 * 52
    partial = {n: v for n, v in params.items()
               if not n.endswith("stage4_batchnorm9_running_var")}
    with pytest.raises(ValueError, match="running_var"):
        _port_net(partial)


def test_resnet50_inference_forward_matches_jax(start):
    x, _, params, jnet = start
    with jmx.autograd.predict_mode():
        want = jnet(jmx.nd.array(x)).asnumpy()
    net = _port_net(params)
    with tmx.autograd.predict_mode():
        got = net(tmx.nd.array(x)).asnumpy()
    assert got.shape == (BATCH, CLASSES)
    _close(got, want, F32_REL)


@pytest.fixture(scope="module")
def jax_grads(start):
    """The JAX build's training-mode logits, loss and gradients (jitted)."""
    x, y, params, jnet = start
    fn, _ = jax_functionalize(jnet, jmx.nd.array(x), train=True)
    trainable = [n for n, p in jnet.collect_params().items()
                 if p.grad_req != "null"]

    def loss(tvals, fvals, xx, yy):
        logits = fn({**fvals, **tvals}, xx)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(jnp.take_along_axis(
            logp, yy.astype(jnp.int32)[:, None], axis=1)), logits

    vals = {n: jnp.asarray(v) for n, v in params.items()}
    tvals = {n: vals[n] for n in trainable}
    fvals = {n: v for n, v in vals.items() if n not in tvals}
    (lval, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        tvals, fvals, jnp.asarray(x), jnp.asarray(y))
    return (float(lval), np.asarray(logits),
            {n: np.asarray(g) for n, g in grads.items()})


def _relu_zero_spy(monkeypatch):
    """Counts exact zeros at the inputs of the port's relu."""
    from incubator_mxnet_tpu_torch.ops.registry import get_op
    op = get_op("Activation")
    real, zeros = op.fcompute, []

    def spy(data, act_type="relu"):
        if act_type == "relu":
            zeros.append(int((data == 0).sum()))
        return real(data, act_type=act_type)
    monkeypatch.setattr(op, "fcompute", spy)
    return zeros


def test_resnet50_training_loss_and_gradients_match_jax(start, jax_grads,
                                                        monkeypatch):
    x, y, params, _ = start
    want_loss, want_logits, want_g = jax_grads
    zeros = _relu_zero_spy(monkeypatch)
    net = _port_net(params)
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with tmx.autograd.record():
        logits = net(tmx.nd.array(x))
        loss = tmx.nd.mean(loss_fn(logits, tmx.nd.array(y)))
    loss.backward()
    assert len(zeros) == 48 and sum(zeros) == 0   # no relu input at 0
    _close(logits.asnumpy(), want_logits, TRAIN_FWD_REL)
    assert abs(float(loss.asscalar()) - want_loss) <= TRAIN_FWD_REL * \
        want_loss
    got = {n: p.grad().asnumpy() for n, p in net.collect_params().items()
           if p.grad_req != "null"}
    short_want = _short(start[3], want_g)
    short_got = _short(net, got)
    assert sorted(short_got) == sorted(short_want)
    gmax = max(float(np.abs(g).max()) for g in want_g.values())
    for n, w in short_want.items():
        g = short_got[n]
        if n.endswith("bias") and not n.startswith("dense"):
            # a 1x1 convolution feeding BatchNorm: its true gradient is 0
            assert np.abs(g).max() <= 1e-5 * gmax, n
            assert np.abs(w).max() <= 1e-5 * gmax, n
        else:
            assert _rel_l2(g, w) <= GRAD_REL_L2, (n, _rel_l2(g, w))


@pytest.mark.parametrize("kind,channels,in_channels", [
    ("BottleneckV1", 32, 16), ("BottleneckV2", 32, 16)])
def test_residual_unit_gradients_match_jax(kind, channels, in_channels):
    """One unit with its projection shortcut (stride 2) then one without,
    training mode, every gradient element by element."""
    jmx.random.seed(5)
    rs = np.random.RandomState(5)
    x = rs.standard_normal((BATCH, in_channels, 8, 8)).astype(np.float32)

    def build(mx, vision):
        net = mx.gluon.nn.HybridSequential(prefix="net_")
        block = getattr(vision, kind)
        with net.name_scope():
            net.add(block(channels, 2, True, in_channels=in_channels,
                          prefix="u0_"))
            net.add(block(channels, 1, False, in_channels=channels,
                          prefix="u1_"))
        return net
    jnet = build(jmx, jvision)
    jnet.initialize(jmx.init.Xavier())
    fn, vals = jax_functionalize(jnet, jmx.nd.array(x), train=True)
    params = {}
    for n, v in vals.items():
        v = np.asarray(v)
        if n.endswith("gamma"):
            v = rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif n.endswith("beta"):
            v = (0.1 * rs.standard_normal(v.shape)).astype(np.float32)
        params[n] = v
    dy = rs.standard_normal((BATCH, channels, 4, 4)).astype(np.float32)
    want_g, want_dx = jax.jit(jax.grad(
        lambda p, xx: jnp.sum(fn(p, xx) * dy), argnums=(0, 1)))(
        {n: jnp.asarray(v) for n, v in params.items()}, jnp.asarray(x))
    tnet = build(tmx, tvision)
    load_numpy_params(tnet, params, tmx.cpu())
    xt = tmx.nd.array(x)
    xt.attach_grad()
    with tmx.autograd.record():
        out = tnet(xt)
    out.backward(tmx.nd.array(dy))
    _close(xt.grad.asnumpy(), np.asarray(want_dx), F32_REL)
    gmax = max(float(np.abs(np.asarray(g)).max()) for g in want_g.values())
    for n, p in tnet.collect_params().items():
        if p.grad_req == "null":
            continue
        w = np.asarray(want_g[n])
        if n.endswith("bias"):     # feeds BatchNorm: true gradient 0
            assert np.abs(p.grad().asnumpy()).max() <= 1e-5 * gmax, n
        else:
            _close(p.grad().asnumpy(), w, F32_REL)


def _jax_trainer(jnet, dtype):
    return JaxDPT(jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                  dict(OPT), mesh=jax_make_mesh({"dp": 1}, jax.devices()[:1]),
                  donate=False, dtype=dtype)


@pytest.fixture(scope="module")
def jax_trajectories(start):
    """The JAX build's STEPS trainer steps in f32 and in bf16 compute:
    {dtype: [(state before the step, loss, state after)]}, a state being
    ({name: weight}, {name: momentum}) as numpy."""
    x, y, params, jnet = start
    runs = {}
    for dtype in (None, "bfloat16"):
        jt = _jax_trainer(jnet, dtype)
        steps = []
        state = None
        for k in range(STEPS):
            loss = float(jt.step(jmx.nd.array(x), jmx.nd.array(y)))
            if state is None:       # the start: the weights, no momentum
                state = (dict(params), {n: np.zeros_like(v[0]) for n, v in
                                        jt._opt_state.items()})
            after = ({n: np.asarray(v) for n, v in jt._params.items()},
                     {n: np.asarray(v[0]) for n, v in jt._opt_state.items()})
            steps.append((state, loss, after))
            state = after
        runs[dtype] = steps
    return runs


def _check_step(net, jnet, before, after_got, after_want, loss_got,
                loss_want, dtype=None, noise=None):
    """One trainer step of the port from the JAX build's state against the
    JAX build's step from it: the loss and the running statistics (the
    forward's), the weights' updates and momenta (the gradients'); in bf16
    each within twice ``noise``, the JAX build's own bf16-to-f32 distance
    by tensor after its first step, or BF16_STEP's floor."""
    loss_rel, stats_rel, upd_l2 = ((TRAIN_FWD_REL, TRAIN_FWD_REL, GRAD_REL_L2)
                                   if dtype is None else BF16_STEP)
    assert abs(loss_got - loss_want) <= max(
        loss_rel * loss_want, 0.0 if noise is None else 2 * noise["loss"])
    (w0, _), (w1, m1) = ([_short(jnet, d) for d in st]
                         for st in (before, after_want))
    g1, gm1 = (_short(net, d) for d in after_got)
    for n in w1:
        if "running" in n:
            err = float(np.abs(g1[n] - w1[n]).max())
            assert err <= max(stats_rel * float(np.abs(w1[n]).max()),
                              0.0 if noise is None else 2 * noise[n]), n
        elif n.endswith("bias") and not n.startswith("dense"):
            # a 1x1 convolution feeding BatchNorm: no true gradient; bf16
            # rounding leaves one of the JAX build's size
            floor = 0.0 if dtype is None else \
                2 * float(np.abs(w1[n] - w0[n]).max())
            assert np.abs(g1[n] - w0[n]).max() <= floor + 1e-6, n
        else:
            bound = upd_l2 if noise is None else max(upd_l2, 2 * noise[n])
            assert _rel_l2(g1[n] - w0[n], w1[n] - w0[n]) <= bound, n
            assert _rel_l2(gm1[n], m1[n]) <= bound, n


def _load_state(tr, net, state):
    """The JAX build's state into a port DataParallelTrainer's f32 masters
    and momenta."""
    weights, moms = (_short_full(net, d) for d in state)
    with torch.no_grad():
        for n, v in tr._params.items():
            v.copy_(torch.tensor(weights[n]))
        for n, (mom,) in tr._opt_state.items():
            mom.copy_(torch.tensor(moms[n]))


def _short_full(net, d):
    """{port's full name: value} from a JAX-named dict."""
    return {net.prefix + n.split("_", 1)[1]: v for n, v in d.items()}


def _state_of(tr, net):
    return ({n: v.numpy().copy() for n, v in tr._params.items()},
            {n: s[0].numpy().copy() for n, s in tr._opt_state.items()})


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
def test_data_parallel_trainer_steps_match_jax(start, jax_trajectories,
                                               dtype):
    """Each of STEPS DataParallelTrainer steps, run by the port from the
    JAX build's state before it (weights, momenta, running statistics),
    against the JAX build's own step."""
    x, y, params, jnet = start
    net = _port_net(params)
    tr = tmx.parallel.DataParallelTrainer(
        net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", dict(OPT),
        dtype=dtype)
    tr._gather_params(torch.tensor(x))
    noise = None
    if dtype is not None:
        # both JAX runs take their first step from the same state
        (w0, _), _, (f1, _) = jax_trajectories[None][0]
        _, _, (b1, _) = jax_trajectories[dtype][0]
        noise = {n[len(jnet.prefix):]: (
            float(np.abs(b1[n] - f1[n]).max()) if "running" in n
            else _rel_l2(b1[n] - w0[n], f1[n] - w0[n])) for n in w0}
        noise["loss"] = abs(jax_trajectories[None][0][1] -
                            jax_trajectories[dtype][0][1])
    for before, loss_want, after_want in jax_trajectories[dtype]:
        _load_state(tr, net, before)
        loss = float(tr.step(tmx.nd.array(x), tmx.nd.array(y)).asscalar())
        _check_step(net, jnet, before, _state_of(tr, net), after_want, loss,
                    loss_want, dtype, noise)
    tr.sync_params()
    for n, p in net.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(), tr._params[n])
        assert p.data().dtype == np.float32


def test_eager_gluon_trainer_matches_jax(start, jax_trajectories):
    """Two eager steps (record, backward, ``Trainer.step(batch)``), each
    from the JAX build's state before it: the same gradient (the mean over
    the batch) and momentum update as the JAX build's trainer step."""
    x, y, params, jnet = start
    net = _port_net(params)
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    names = [p.name for p in tr._params]
    for before, loss_want, after_want in jax_trajectories[None][:2]:
        weights, moms = (_short_full(net, d) for d in before)
        for p in tr._params:
            p.set_data(tmx.nd.array(weights[p.name]))
        for i, n in enumerate(names):
            if i in tr._updaters[0].states:
                tr._updaters[0].states[i][:] = tmx.nd.array(moms[n])
        with tmx.autograd.record():
            loss = loss_fn(net(tmx.nd.array(x)), tmx.nd.array(y))
        loss.backward()
        tr.step(BATCH)
        got = ({p.name: p.data().asnumpy() for p in tr._params},
               {n: (tr._updaters[0].states[i].asnumpy()
                    if i in tr._updaters[0].states else np.zeros(1))
                for i, n in enumerate(names)})
        _check_step(net, jnet, before, got, after_want,
                    float(tmx.nd.mean(loss).asscalar()), loss_want)


def test_trainer_blends_running_stats_once_a_step_in_f32(start,
                                                         monkeypatch):
    """In bf16 compute, the f32 master running statistics become exactly
    0.9·before + 0.1·(the step's f32 batch statistics), once a step; the
    Block's own arrays change only at ``sync_params``."""
    from incubator_mxnet_tpu_torch.ops import nn as tnn
    x, y, params, _ = start
    batch_stats = []
    real = tnn._BatchNormTrainFunction.forward

    def spy(ctx, *args):
        out = real(ctx, *args)
        batch_stats.append((out[1].clone(), out[2].clone()))
        return out
    monkeypatch.setattr(tnn._BatchNormTrainFunction, "forward",
                        staticmethod(spy))
    net = _port_net(params)
    tr = tmx.parallel.DataParallelTrainer(
        net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", dict(OPT),
        dtype="bfloat16")
    bns = [b for b in _blocks(net) if isinstance(b, tmx.gluon.nn.BatchNorm)]
    block_before = {n: p.data().asnumpy().copy()
                    for n, p in net.collect_params().items()}
    tr.step(tmx.nd.array(x), tmx.nd.array(y))     # gathers the masters
    for step in range(2):
        before = {n: v.clone() for n, v in tr._params.items()}
        batch_stats.clear()
        tr.step(tmx.nd.array(x), tmx.nd.array(y))
        assert len(batch_stats) == len(bns) == 52
        for bn, (mean, var) in zip(bns, batch_stats):
            assert mean.dtype == var.dtype == torch.float32
            for p, batch in ((bn.running_mean, mean), (bn.running_var, var)):
                master = tr._params[p.name]
                assert master.dtype == torch.float32
                want = 0.9 * before[p.name] + (1 - 0.9) * batch
                assert torch.equal(master, want), p.name
    for n, p in net.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(), block_before[n])
    tr.sync_params()
    for n, p in net.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(),
                                      tr._params[n].numpy())


def test_trainer_harvests_a_rebound_layer_state():
    """A layer that rebinds its state's array (in place of writing into
    it) still lands the new value in the trainer's f32 master once a step,
    as the JAX step harvests every shadow the forward wrote."""
    class Counter(tmx.gluon.HybridBlock):
        def __init__(self):
            super().__init__(prefix="c_")
            self.w = self.params.get("w", shape=(1,), init="ones")
            self.seen = self.params.get("seen", shape=(1,), init="zeros",
                                        grad_req="null")

        def hybrid_forward(self, F, x, w, seen):
            seen._data = seen._data + 1       # a new array, not a write
            return x * w

    net = Counter()
    net.initialize()
    tr = tmx.parallel.DataParallelTrainer(
        net, tmx.gluon.loss.L2Loss(), "sgd", {"learning_rate": 0.1},
        dtype="bfloat16")
    x = tmx.nd.array(np.ones((2, 1), np.float32))
    for step in range(1, 3):
        tr.step(x, x)
        assert tr._params["c_seen"].dtype == torch.float32
        assert float(tr._params["c_seen"][0]) == step
    assert float(net.seen.data().asscalar()) == 0.0
    tr.sync_params()
    assert float(net.seen.data().asscalar()) == 2.0


def _blocks(block):
    """The subtree's blocks in forward order (children in registration
    order), which is the order of their BatchNorm calls."""
    out = [block]
    for c in block._children:
        out.extend(_blocks(c))
    return out


def test_relu_gradient_at_zero_is_zero():
    """MXNet's relu_grad is (x > 0): 0 at exactly 0.  The JAX build's relu
    is ``jnp.maximum(x, 0)``, whose gradient splits a tie and passes 0.5
    there (a reference-side difference the port does not copy)."""
    xs = np.array([-1.0, 0.0, 2.0], np.float32)
    x = tmx.nd.array(xs)
    x.attach_grad()
    with tmx.autograd.record():
        y = tmx.nd.Activation(x, act_type="relu")
    y.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(), [0.0, 0.0, 1.0])
    want = jax.grad(lambda v: jnp.sum(jnp.maximum(v, 0)))(jnp.asarray(xs))
    np.testing.assert_array_equal(np.asarray(want), [0.0, 0.5, 1.0])


@pytest.mark.cuda
def test_card_resnet50_trainer_step_matches_cpu(start):
    """The small ResNet-50 on the card against the CPU: the inference
    forward and, after one f32 DataParallelTrainer step with torch's TF32
    default (on), the loss and the running statistics, within the file's
    first-step bounds (cuDNN's convolutions stay f32 under the op's
    guard)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, y, params, _ = start
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        results = []
        for ctx in (tmx.cpu(), tmx.gpu(0)):
            with ctx:
                net = tvision.resnet50_v1(thumbnail=True, classes=CLASSES)
                load_numpy_params(net, params, ctx)
                with tmx.autograd.predict_mode():
                    infer = net(tmx.nd.array(x)).asnumpy()
                tr = tmx.parallel.DataParallelTrainer(
                    net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                    dict(OPT))
                loss = float(tr.step(tmx.nd.array(x),
                                     tmx.nd.array(y)).asscalar())
                tr.sync_params()
                results.append((infer, loss, {
                    n[len(net.prefix):]: p.data().asnumpy()
                    for n, p in net.collect_params().items()}))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    (want_i, want_l, want_s), (got_i, got_l, got_s) = results
    _close(got_i, want_i, TRAIN_FWD_REL)
    assert abs(got_l - want_l) <= TRAIN_FWD_REL * want_l
    for n in want_s:
        if "running" in n:
            _close(got_s[n], want_s[n], TRAIN_FWD_REL)
