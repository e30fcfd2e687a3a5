"""The rest of ``ops/nn.py`` in the port against the JAX build, on the CPU,
with the Gluon layers over them, and the registration guards of this
slice.

Each case feeds the same seeded numpy inputs to the JAX build's operator
(``fcompute`` and ``jax.vjp``, jitted) and to the port's (through
``invoke`` under ``autograd.record(train_mode=False)``, so the ops that
compute otherwise in training take their inference path on both sides),
forward and backward with the same head gradient, in f32.  Bounds are in
f32 ulps (``elem``: at each element's |want|; ``max``: at max |want|), at
most 84 (1e-5 relative), each set above the error measured here: 0 where
both compute the same IEEE steps; a few where XLA's and ATen's exp, expm1,
pow or rsqrt differ (elu 3 and 4 ulps, softmax 3 and 5), or a reduction
sums in another order (InstanceNorm's and LRN's windows, prelu's gamma
gradient, a softmax's row).  The ``*Output`` ops' gradients ignore the
head gradient on both sides (trap A3).  Dropout and rrelu in training draw
random numbers and are held by distribution in
``tests/test_torch_random.py``.

Where MXNet and the JAX build part, the port follows MXNet and a test pins
it: ``UpSampling``'s bilinear mode (MXNet's grouped Deconvolution with the
weight input; the JAX build resizes with ``jax.image.resize`` and ignores
the weight) and its nearest mode with several inputs (MXNet upsamples each
to the first's size and concatenates or sums; the JAX build reads only the
first).
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.ops.registry import get_op as port_op
from test_torch_ops_math import gen, jax_run, ulps


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def port_run(name, arrays, params, head, grad_inputs):
    xs = [tmx.nd.array(a) for a in arrays]
    for i in grad_inputs:
        xs[i].attach_grad()
    with tmx.autograd.record(train_mode=False):
        out = tmx.nd.invoke(port_op(name), xs, dict(params))
    out = out[0] if isinstance(out, list) else out
    if not grad_inputs:
        return out, None
    out.backward(tmx.nd.NDArray(torch.from_numpy(np.array(head))))
    return out, [xs[i].grad for i in grad_inputs]


def check(name, arrays, params, fwd, bwd, grad_inputs=(0,)):
    """One f32 case on both sides at its bounds ((n, measure) each)."""
    want, jgrads, head = jax_run(name, arrays, params, "float32", 99,
                                 grad_inputs if bwd else ())
    got, pgrads = port_run(name, arrays, params, head,
                           grad_inputs if bwd else ())
    assert got.shape == tuple(want.shape)
    err = ulps(got.asnumpy(), np.asarray(want), "float32", fwd[1])
    assert err <= fwd[0], "forward %.2f ulp > %s" % (err, fwd[0])
    for pg, jg in zip(pgrads or (), jgrads or ()):
        err = ulps(pg.asnumpy(), np.asarray(jg), "float32", bwd[1])
        assert err <= bwd[0], "gradient %.2f ulp > %s" % (err, bwd[0])


E0 = (0, "elem")


def el(n):
    return (n, "elem")


def mx_(n):
    return (n, "max")


def _labels(n, k, seed):
    return np.random.RandomState(seed).randint(0, k, (n,)).astype(np.float32)


# (id, op, input specs: (domain, shape) or an array maker, params, fwd,
# bwd, inputs with a gradient)
CASES = [
    ("InstanceNorm", "InstanceNorm",
     [("any", (2, 3, 5, 6)), ("near1", (3,)), ("any", (3,))], {},
     mx_(4), mx_(8), (0, 1, 2)),
    ("InstanceNorm_3d_eps", "InstanceNorm",
     [("any", (2, 4, 7)), ("near1", (4,)), ("any", (4,))], dict(eps=1e-5),
     mx_(4), mx_(8), (0, 1, 2)),
    ("LRN", "LRN", [("any", (2, 8, 5, 5))], {}, el(2), mx_(4), (0,)),
    ("LRN_nsize3", "LRN", [("any", (2, 6, 4, 3))],
     dict(nsize=3, alpha=1e-2, beta=0.5, knorm=1.0), el(2), mx_(4), (0,)),
    ("LeakyReLU_leaky", "LeakyReLU", [("any", (4, 5, 6))], dict(slope=0.1),
     E0, E0, (0,)),
    ("LeakyReLU_elu", "LeakyReLU", [("any", (4, 5, 6))],
     dict(act_type="elu", slope=0.7), el(4), el(6), (0,)),
    ("LeakyReLU_prelu_channel", "LeakyReLU",
     [("any", (2, 5, 3, 4)), ("unit", (5,))], dict(act_type="prelu"),
     E0, mx_(2), (0, 1)),
    ("LeakyReLU_prelu_full", "LeakyReLU",
     [("any", (2, 5, 3)), ("unit", (1, 5, 1))], dict(act_type="prelu"),
     E0, mx_(2), (0, 1)),
    ("LeakyReLU_rrelu_inference", "LeakyReLU", [("any", (4, 5, 6))],
     dict(act_type="rrelu", lower_bound=0.1, upper_bound=0.3), E0, E0,
     (0,)),
    ("UpSampling_nearest_2", "UpSampling", [("any", (2, 3, 4, 5))],
     dict(scale=2), E0, E0, (0,)),
    ("UpSampling_nearest_3", "UpSampling", [("any", (1, 2, 3, 3))],
     dict(scale=3, num_args=1), E0, E0, (0,)),
    ("SoftmaxActivation_instance", "SoftmaxActivation",
     [("any", (4, 3, 5))], {}, el(4), mx_(6), (0,)),
    ("SoftmaxActivation_channel", "SoftmaxActivation",
     [("any", (2, 6, 3, 4))], dict(mode="channel"), el(4), mx_(6), (0,)),
    ("Dropout_inference", "Dropout", [("any", (8, 16))], dict(p=0.4),
     E0, E0, (0,)),
    ("Dropout_p0", "Dropout", [("any", (8, 16))], dict(p=0.0, axes=(1,)),
     E0, E0, (0,)),
    ("LinearRegressionOutput", "LinearRegressionOutput",
     [("any", (6, 4)), ("any", (6, 4))], dict(grad_scale=0.5), E0, E0,
     (0,)),
    ("MAERegressionOutput", "MAERegressionOutput",
     [("any", (6, 4)), ("any", (24,))], dict(grad_scale=2.0), E0, E0,
     (0,)),
    ("LogisticRegressionOutput", "LogisticRegressionOutput",
     [("any", (6, 4)), ("unit", (6, 4))], {}, el(1), mx_(1), (0,)),
    ("SVMOutput_l2", "SVMOutput",
     [("any", (8, 5)), lambda: _labels(8, 5, 3)],
     dict(margin=0.5, regularization_coefficient=2.0), E0, mx_(1), (0,)),
    ("SVMOutput_linear", "SVMOutput",
     [("any", (8, 5)), lambda: _labels(8, 5, 4)],
     dict(use_linear=True), E0, E0, (0,)),
]


def _arrays(specs):
    return [s() if callable(s) else gen(s[0], s[1], seed=i)
            for i, s in enumerate(specs)]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_nn_op_matches_jax(case):
    _, name, specs, params, fwd, bwd, grads = case
    check(name, _arrays(specs), params, fwd, bwd, grads)


def test_output_ops_ignore_the_head_gradient():
    """The gradient of an ``*Output`` op is its own formula whatever
    head gradient arrives (trap A3)."""
    x = tmx.nd.array(gen("any", (4, 3), 0))
    lab = tmx.nd.array(gen("any", (4, 3), 1))
    for name in ("LinearRegressionOutput", "MAERegressionOutput",
                 "LogisticRegressionOutput"):
        grads = []
        for head in (1.0, 7.0):
            x.attach_grad()
            with tmx.autograd.record():
                y = getattr(tmx.nd, name)(x, lab)
            y.backward(tmx.nd.ones(y.shape) * head)
            grads.append(x.grad.asnumpy())
        np.testing.assert_array_equal(grads[0], grads[1])
    np.testing.assert_array_equal(
        grads[0], 1 / (1 + np.exp(-x.asnumpy())) - lab.asnumpy())


def test_upsampling_bilinear_is_mxnets_grouped_deconvolution():
    """MXNet's bilinear UpSampling is a Deconvolution with the weight input
    (kernel 2s - s%2, stride s, pad ceil((s-1)/2), one group a channel, no
    bias); the port computes exactly that.  The JAX build resizes with
    ``jax.image.resize`` and ignores the weight: its output does not move
    when the weight does (a reference-side difference)."""
    rs = np.random.RandomState(0)
    for scale in (2, 3, 4):
        k = 2 * scale - scale % 2
        x = rs.standard_normal((2, 3, 5, 4)).astype(np.float32)
        w = tmx.nd.zeros((3, 1, k, k))
        tmx.init.Bilinear()(tmx.initializer.InitDesc("up_weight"), w)
        got = tmx.nd.UpSampling(tmx.nd.array(x), w, scale=scale,
                                sample_type="bilinear", num_filter=3)
        want = torch.nn.functional.conv_transpose2d(
            torch.from_numpy(x), w._data, stride=scale,
            padding=-(-(scale - 1) // 2), groups=3)
        assert got.shape == (2, 3, 5 * scale, 4 * scale)
        np.testing.assert_allclose(got.asnumpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
        jx = jmx.nd.array(x)
        j1 = jmx.nd.UpSampling(jx, jmx.nd.array(w.asnumpy()), scale=scale,
                               sample_type="bilinear", num_filter=3)
        j2 = jmx.nd.UpSampling(jx, jmx.nd.array(2 * w.asnumpy()),
                               scale=scale, sample_type="bilinear",
                               num_filter=3)
        np.testing.assert_array_equal(j1.asnumpy(), j2.asnumpy())
        doubled = tmx.nd.UpSampling(tmx.nd.array(x), w * 2, scale=scale,
                                    sample_type="bilinear", num_filter=3)
        np.testing.assert_allclose(doubled.asnumpy(), 2 * got.asnumpy(),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["concat", "sum"])
def test_upsampling_nearest_several_inputs_follows_mxnet(mode):
    """MXNet's nearest UpSampling with several inputs brings each to the
    first's size times ``scale`` and concatenates them on channels (or sums
    them); the JAX build reads only the first input."""
    rs = np.random.RandomState(1)
    a = rs.standard_normal((1, 2, 3, 3)).astype(np.float32)
    b = rs.standard_normal((1, 2 if mode == "sum" else 4, 1, 1)).astype(
        np.float32)
    got = tmx.nd.UpSampling(tmx.nd.array(a), tmx.nd.array(b), scale=2,
                            num_args=2, multi_input_mode=mode).asnumpy()
    ua = a.repeat(2, 2).repeat(2, 3)
    ub = b.repeat(6, 2).repeat(6, 3)
    want = ua + ub if mode == "sum" else np.concatenate([ua, ub], 1)
    np.testing.assert_array_equal(got, want)
    jax_out = jmx.nd.UpSampling(jmx.nd.array(a), jmx.nd.array(b), scale=2,
                                num_args=2, multi_input_mode=mode).asnumpy()
    np.testing.assert_array_equal(jax_out, ua)


def test_instance_norm_layer_matches_jax():
    x = gen("any", (2, 4, 6, 5), 0)
    gamma, beta = gen("near1", (4,), 1), gen("any", (4,), 2)
    outs = []
    for mx in (jmx, tmx):
        layer = mx.gluon.nn.InstanceNorm(in_channels=4, scale=True)
        layer.initialize()
        layer.gamma.set_data(mx.nd.array(gamma))
        layer.beta.set_data(mx.nd.array(beta))
        outs.append(layer(mx.nd.array(x)).asnumpy())
        assert layer.gamma.grad_req == "write"
    assert ulps(outs[1], outs[0], "float32", "max") <= 4
    layer = tmx.gluon.nn.InstanceNorm()
    layer.initialize()
    assert layer.gamma.grad_req == "null" and layer.beta.grad_req == "write"
    assert layer(tmx.nd.array(x)).shape == x.shape


def test_sequential_and_lambdas_match_jax():
    x = gen("any", (3, 5), 0)
    w = gen("any", (4, 5), 1)
    outs = []
    for mx in (jmx, tmx):
        net = mx.gluon.nn.Sequential()
        with net.name_scope():
            net.add(mx.gluon.nn.Dense(4, in_units=5, use_bias=False),
                    mx.gluon.nn.Lambda("tanh"),
                    mx.gluon.nn.HybridLambda(lambda F, v: F.square(v)),
                    mx.gluon.nn.HybridLambda("negative"),
                    mx.gluon.nn.Lambda(lambda v: v * 2))
        net.initialize()
        net[0].weight.set_data(mx.nd.array(w))
        assert len(net) == 5
        assert "Lambda(tanh)" in repr(net) and "HybridLambda" in repr(net)
        outs.append(net(mx.nd.array(x)).asnumpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="not found"):
        tmx.gluon.nn.Lambda("no_such_function")
    with pytest.raises(ValueError, match="Unrecognized"):
        tmx.gluon.nn.HybridLambda(3)
    with pytest.raises(ValueError, match="HybridBlock"):
        tmx.gluon.nn.HybridSequential().add(tmx.gluon.nn.Lambda("tanh"))


def test_nd_namespace_reexports_contexts():
    assert tmx.nd.cpu is tmx.cpu and tmx.nd.Context is tmx.Context
    assert tmx.nd.current_context() == tmx.cpu()
    for name in ("cpu", "current_context", "Context"):
        assert hasattr(jmx.nd, name)
    assert tmx.nd.zeros((2,), ctx=tmx.nd.cpu(0)).context == tmx.nd.Context(
        "cpu", 0)


# names the JAX build registers in these modules that wait for a later
# item (ROADMAP names each)
LATER_OPS = {"_sparse_sgd_update": 10, "_sparse_sgd_mom_update": 10}
SLICE_MODULES = ("incubator_mxnet_tpu.ops.nn",
                 "incubator_mxnet_tpu.ops.random_ops",
                 "incubator_mxnet_tpu.ops.linalg",
                 "incubator_mxnet_tpu.ops.optimizer_ops")


def test_every_op_of_this_slice_is_registered():
    """The set difference against the JAX registry: every name the JAX
    build registers from ops/nn.py, ops/random_ops.py, ops/linalg.py and
    ops/optimizer_ops.py is in the port but the sparse updates (item 10;
    CTCLoss stays in ops/rnn.py, item 8), each alias on the same Operator
    as in the JAX build, with the same differentiability and randomness."""
    from incubator_mxnet_tpu.ops import registry as jreg
    from incubator_mxnet_tpu_torch.ops import registry as treg
    names = {n for n, o in jreg._REGISTRY.items()
             if o.fcompute.__module__ in SLICE_MODULES}
    assert names - set(treg._REGISTRY) == set(LATER_OPS)
    for n in names - set(LATER_OPS):
        j, t = jreg._REGISTRY[n], treg._REGISTRY[n]
        assert t.name == j.name, n
        assert t.differentiable == j.differentiable, n
        assert bool(t.needs_rng) == j.needs_rng, n
        assert t.takes_is_train == j.takes_is_train, n


# public names of the JAX build's namespaces that wait for a later item
LATER_NAMES = {
    "gluon.nn": {"SymbolBlock": 5},
    "gluon.loss": {"CTCLoss": 8},
    "optimizer": {"fused_bucket_kind": 12, "fused_bucket_update": 12,
                  "fused_lr_wd": 12, "fused_state_arity": 12},
    "nd.contrib": {"CTCLoss": 8, "ctc_loss": 8, "RingAttention": 7,
                   "DeformableConvolution": 9, "DeformablePSROIPooling": 9,
                   "MultiBoxDetection": 9, "MultiBoxPrior": 9,
                   "MultiBoxTarget": 9, "MultiProposal": 9,
                   "PSROIPooling": 9, "Proposal": 9, "ROIAlign": 9,
                   "box_nms": 9, "dequantize": 11, "quantize": 11,
                   "quantized_act": 11, "quantized_conv": 11,
                   "quantized_elemwise_add": 11, "quantized_flatten": 11,
                   "quantized_fully_connected": 11,
                   "quantized_pooling": 11, "requantize": 11},
}
NAMESPACES = ("gluon.nn", "gluon.loss", "initializer", "optimizer", "random",
              "nd.random", "nd.linalg", "nd.contrib",
              "gluon.model_zoo.vision")


def _public(ns):
    """Public classes and functions of a namespace (modules and the
    helpers it imports excluded)."""
    names = getattr(ns, "__all__", None)
    if names is None:
        names = [n for n in dir(ns) if not n.startswith("_")]
    return {n for n in names
            if callable(getattr(ns, n)) and not isinstance(getattr(ns, n),
                                                            type(np))
            and n not in ("annotations", "get_op", "invoke",
                          "make_op_func", "NDArray")}


@pytest.mark.parametrize("path", NAMESPACES)
def test_every_public_name_of_the_namespace_is_ported(path):
    def walk(root):
        ns = root
        for part in path.split("."):
            ns = getattr(ns, part)
        return ns
    jns, tns = walk(jmx), walk(tmx)
    missing = _public(jns) - set(dir(tns))
    assert missing == set(LATER_NAMES.get(path, {})), sorted(missing)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_card_nn_ops_match_cpu(card):
    """chip_smoke's phase 8d nn cases: each op at AlexNet's and Inception's
    activation shapes on CUDA tensors against the port's CPU result, f32
    and bf16, forward and backward, under sync-debug mode "error"."""
    import chip_smoke as cs
    rs = np.random.default_rng(cs.SEED)
    ran = 0
    for case in cs.oplib_cases():
        for dtype in case[4]:
            cs.sweep_case(tmx, case, dtype, rs)
            ran += 1
    assert ran == 23
    assert cs._upsampling_bilinear(tmx, np, rs, cs.card_line()) <= \
        cs.SWEEP_ULP["nn"][0][0][0]
