"""The model zoo's other families in the port (AlexNet, VGG, SqueezeNet,
DenseNet, MobileNet, Inception V3) against the JAX build, on the CPU.

Each family runs at a small size, ``classes=10``, batch 2: AlexNet at
63x63 (its smallest input), VGG with narrow stages at 32x32, SqueezeNet at
224x224 (its classifier pools 13x13), a DenseNet of two narrow blocks and
MobileNet 0.25 at 32x32, and Inception V3 block by block (stem, A-E) at
its widths on small maps (the whole net needs 299x299, which the port
runs alone).  Both packages get the same seeded numpy weights
(``convert.load_numpy_params``; BatchNorm's gamma, beta and running
statistics drawn away from their init) and inputs; the JAX side runs
jitted, its parameter shapes preset from the port's so that no eager pass
compiles op by op.  Bound: the inference logits within 1e-5 of their
largest value (f32 sums of the convolutions in other orders); AlexNet's
gradients under ``record(train_mode=False)`` within 1e-4 (relu inputs
are off exact zeros, where MXNet's and the JAX build's relu gradients
differ).

Also: the parameter names of alexnet and the eight VGGs against
``tests/data/zoo_param_names.json`` and of every other factory against
the JAX build's, ``get_model`` over all 30 names, ``pretrained=True``
raising, and Dropout in training mode following ``mx.random.seed``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import random_state as jrandom_state
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
from incubator_mxnet_tpu.ndarray import NDArray as JNDArray
from incubator_mxnet_tpu_torch.convert import load_numpy_params
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision

F32_REL = 1e-5
GRAD_REL = 1e-4
CLASSES = 10

_SNAP = json.load(open(os.path.join(os.path.dirname(__file__), "data",
                                    "zoo_param_names.json")))
OTHER = sorted(n for n in tvision._MODELS if not n.startswith("resnet"))


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _short(net):
    return sorted(k[len(net.prefix):] for k in net.collect_params().keys())


@pytest.mark.parametrize("factory", sorted(f for f in _SNAP
                                           if not f.startswith("resnet")))
def test_param_names_match_snapshot(factory):
    net = getattr(tvision, factory)()
    assert _short(net) == _SNAP[factory]


@pytest.mark.parametrize("name", OTHER)
def test_param_names_match_jax(name):
    got = tvision.get_model(name, classes=CLASSES)
    want = jvision.get_model(name, classes=CLASSES)
    assert _short(got) == _short(want)


def test_get_model_and_pretrained():
    assert len(tvision._MODELS) == 30
    assert set(tvision._MODELS) == set(OTHER) | {
        n for n in _SNAP if n.startswith("resnet")}
    for name in OTHER:
        net = tvision.get_model(name.upper(), classes=CLASSES)
        assert type(net).__name__ == type(jvision.get_model(name)).__name__
    with pytest.raises(ValueError, match="not supported"):
        tvision.get_model("vgg17")
    for factory in (tvision.alexnet, tvision.vgg16_bn, tvision.squeezenet1_1,
                    tvision.densenet121, tvision.mobilenet0_5,
                    tvision.inception_v3):
        with pytest.raises(tmx.MXNetError, match="weight files"):
            factory(pretrained=True)
    with pytest.raises(ValueError, match="Invalid number of layers"):
        tvision.get_vgg(12)
    with pytest.raises(ValueError, match="SqueezeNet version"):
        tvision.SqueezeNet("2.0")
    for name in ("get_vgg", "get_squeezenet", "get_mobilenet", "get_resnet"):
        assert callable(getattr(tvision, name))


def _weights(net, x, seed):
    """The port net's deferred shapes resolved by ``x``, and seeded f32
    weights for every parameter by full name."""
    net.initialize(tmx.init.Zero())
    with tmx.autograd.predict_mode():
        net(tmx.nd.array(x))
    rs = np.random.RandomState(seed)
    out = {}
    for name, p in net.collect_params().items():
        shape = p.shape
        if name.endswith("gamma") or name.endswith("running_var"):
            v = rs.uniform(0.5, 1.5, shape)
        elif name.endswith("beta") or name.endswith("running_mean"):
            v = 0.1 * rs.standard_normal(shape)
        elif name.endswith("bias"):
            v = 0.1 * rs.standard_normal(shape)
        else:
            fan_in = int(np.prod(shape[1:])) or 1
            v = rs.standard_normal(shape) * np.sqrt(2.0 / fan_in)
        out[name] = v.astype(np.float32)
    return out


def _jax_load(jnet, weights, prefix):
    """The JAX net with every parameter's shape preset, then set."""
    by_short = {n[len(prefix):]: v for n, v in weights.items()}
    params = jnet.collect_params()
    for name, p in params.items():
        p.shape = by_short[name[len(jnet.prefix):]].shape
    jnet.initialize(jmx.init.Zero())
    for name, p in params.items():
        p.set_data(jmx.nd.array(by_short[name[len(jnet.prefix):]]))
    return {n: p.data()._read() for n, p in params.items()}


def _jax_fn(jnet, train=False):
    """The JAX net's forward as a pure function of (parameters, input),
    traced without an eager pass (what ``functionalize`` does after its
    one)."""
    def fn(vals, x):
        shadows = {n: JNDArray(v) for n, v in vals.items()}
        with jrandom_state.use_key(jax.random.PRNGKey(0)):
            with jautograd._scope(recording=False, training=train):
                with jnet._trace_params(shadows):
                    return jnet.hybrid_forward_dispatch(JNDArray(x))._read()
    return fn


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, rel * scale)


def _pair(make, x, seed=0):
    """(port net, JAX net, the JAX net's parameter values) from one set of
    seeded weights."""
    tnet = make(tmx)
    weights = _weights(tnet, x, seed)
    load_numpy_params(tnet, weights, tmx.cpu())
    jnet = make(jmx)
    vals = _jax_load(jnet, weights, tnet.prefix)
    return tnet, jnet, vals


def _small_vgg(mx, batch_norm):
    from importlib import import_module
    vgg = import_module(mx.__name__ + ".gluon.model_zoo.vision.vgg")
    return vgg.VGG([1, 1, 2, 2, 2], [8, 8, 16, 16, 16], classes=CLASSES,
                   batch_norm=batch_norm)


def _small_densenet(mx):
    from importlib import import_module
    dn = import_module(mx.__name__ + ".gluon.model_zoo.vision.densenet")
    return dn.DenseNet(8, 4, [2, 3], bn_size=2, classes=CLASSES)


def _vision(mx):
    return jvision if mx is jmx else tvision


FAMILIES = [
    ("alexnet", lambda mx: _vision(mx).alexnet(classes=CLASSES), 63),
    ("vgg11_narrow", lambda mx: _small_vgg(mx, False), 32),
    ("vgg11_bn_narrow", lambda mx: _small_vgg(mx, True), 32),
    ("squeezenet1_0", lambda mx: _vision(mx).squeezenet1_0(classes=CLASSES),
     224),
    ("squeezenet1_1", lambda mx: _vision(mx).squeezenet1_1(classes=CLASSES),
     224),
    ("densenet_narrow", _small_densenet, 32),
    ("mobilenet0_25", lambda mx: _vision(mx).mobilenet0_25(classes=CLASSES),
     32),
]


@pytest.mark.parametrize("family", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_family_inference_matches_jax(family):
    _, make, size = family
    x = np.random.RandomState(1).uniform(-1, 1, (2, 3, size, size)).astype(
        np.float32)
    tnet, jnet, vals = _pair(make, x)
    want = jax.jit(_jax_fn(jnet))(vals, jnp.asarray(x))
    with tmx.autograd.predict_mode():
        got = tnet(tmx.nd.array(x)).asnumpy()
    assert got.shape == (2, CLASSES)
    _close(got, want, F32_REL)


def _inception(mx):
    from importlib import import_module
    return import_module(mx.__name__ + ".gluon.model_zoo.vision.inception")


def _stem(mx):
    inc = _inception(mx)
    seq = mx.gluon.nn.HybridSequential(prefix="stem_")
    with seq.name_scope():
        seq.add(inc._make_basic_conv(channels=32, kernel_size=3, strides=2))
        seq.add(inc._make_basic_conv(channels=64, kernel_size=3, padding=1))
        seq.add(mx.gluon.nn.MaxPool2D(pool_size=3, strides=2))
        seq.add(inc._make_basic_conv(channels=80, kernel_size=1))
    return seq


# (block, maker, input channels, input side)
INCEPTION_BLOCKS = [
    ("stem", _stem, 3, 19),
    ("A", lambda mx: _inception(mx)._make_A(32, "A1_"), 192, 7),
    ("B", lambda mx: _inception(mx)._make_B("B_"), 288, 7),
    ("C", lambda mx: _inception(mx)._make_C(128, "C1_"), 768, 5),
    ("D", lambda mx: _inception(mx)._make_D("D_"), 768, 7),
    ("E", lambda mx: _inception(mx)._make_E("E1_"), 1280, 3),
]


@pytest.mark.parametrize("block", INCEPTION_BLOCKS,
                         ids=[b[0] for b in INCEPTION_BLOCKS])
def test_inception_block_matches_jax(block):
    """Each Inception V3 block (the branch concat ``_Concurrent``, E's
    ``_SplitConcat``) at its widths on a small map."""
    _, make, channels, side = block
    x = np.random.RandomState(2).uniform(-1, 1, (2, channels, side, side))
    x = x.astype(np.float32)
    tnet, jnet, vals = _pair(make, x)
    want = jax.jit(_jax_fn(jnet))(vals, jnp.asarray(x))
    with tmx.autograd.predict_mode():
        got = tnet(tmx.nd.array(x)).asnumpy()
    _close(got, want, F32_REL)


def test_inception_v3_runs_at_299():
    net = tvision.inception_v3(classes=CLASSES)
    net.initialize(tmx.init.Xavier())
    x = np.random.RandomState(3).uniform(-1, 1, (1, 3, 299, 299))
    with tmx.autograd.predict_mode():
        out = net(tmx.nd.array(x.astype(np.float32))).asnumpy()
    assert out.shape == (1, CLASSES) and np.isfinite(out).all()
    assert len(net.collect_params()) == 472


def test_alexnet_gradients_match_jax():
    """Loss gradients of every AlexNet parameter with dropout off
    (``record(train_mode=False)``), relu inputs off exact zeros."""
    x = np.random.RandomState(4).uniform(-1, 1, (2, 3, 63, 63)).astype(
        np.float32)
    y = np.array([3, 7], np.float32)
    tnet, jnet, vals = _pair(lambda mx: _vision(mx).alexnet(
        classes=CLASSES), x, seed=5)
    fn = _jax_fn(jnet)

    def loss(vals):
        logits = fn(vals, jnp.asarray(x))
        lp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.sum(lp[jnp.arange(2), y.astype(np.int32)])
    want = jax.jit(jax.grad(loss))(vals)
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with tmx.autograd.record(train_mode=False):
        total = tmx.nd.sum(loss_fn(tnet(tmx.nd.array(x)), tmx.nd.array(y)))
    total.backward()
    for name, p in tnet.collect_params().items():
        jname = jnet.prefix + name[len(tnet.prefix):]
        _close(p.grad().asnumpy(), want[jname], GRAD_REL)


def test_training_mode_dropout_follows_the_seed():
    """AlexNet in training mode draws its two dropout masks from the
    framework generator: equal after the same seed, different after
    another, and unlike the inference forward."""
    net = tvision.alexnet(classes=CLASSES)
    net.initialize(tmx.init.Xavier())
    x = tmx.nd.array(np.random.RandomState(6).uniform(
        0, 1, (2, 3, 63, 63)).astype(np.float32))
    with tmx.autograd.predict_mode():
        infer = net(x).asnumpy()       # the deferred init draws here
    outs = []
    for seed in (1, 1, 2):
        tmx.random.seed(seed)
        with tmx.autograd.train_mode():
            outs.append(net(x).asnumpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[0], outs[2])
    assert not np.array_equal(outs[0], infer)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_card_zoo_matches_cpu(card):
    """chip_smoke's phase 8a: every new family on the card against the
    CPU, f32 with TF32 off, batch 2 at full resolution, and AlexNet's
    training-mode forward following the seed."""
    import torch
    import chip_smoke as cs
    prev = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = cs.zoo_parity(tmx, cs.card_line())
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = prev
    assert max(v for k, v in out.items() if k != "seconds") <= cs.ZOO_REL
