"""The optimizer layer of the PyTorch port against the JAX build, on the CPU:
the update ops (the registry formulas of ops/optimizer_ops.py:
``mp_sgd_update``, ``mp_sgd_mom_update``, ``adam_update``, and
``nag_mom_update``, ``rmsprop_update``, ``rmspropalex_update``,
``ftrl_update``, ``ftml_update``, ``signsgd_update``, ``signum_update``),
and every optimizer of the JAX build but SGLD (whose noise is random;
``tests/test_torch_random.py`` holds its deterministic part) driven
through ``Updater`` over several steps, in f32 and with
``multi_precision`` on bf16 weights (an f32 master copy per weight).

Bounds: f32 1e-6 relative and absolute (the same f32 operations in the same
order); a bf16 weight equal bit for bit (both round the same f32 master
value once); the bf16 ops without a master copy (each op rounded to bf16,
scalars too, as the JAX build's weakly typed scalars) within one bf16 ulp of
each element.
"""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

from test_torch_halfprec import ulps

TOL = dict(rtol=1e-6, atol=1e-6)
SHAPE = (6, 5)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _a(seed, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(SHAPE) *
            scale).astype(np.float32)


def _np(x):
    return np.asarray(x.asnumpy(), np.float32)


OPS = {
    "mp_sgd_update": (["w16", "g16", "w32"],
                      dict(lr=0.1, wd=0.01, rescale_grad=0.5)),
    "mp_sgd_mom_update": (["w16", "g16", "mom", "w32"],
                          dict(lr=0.1, momentum=0.9, wd=0.003,
                               clip_gradient=0.8)),
    "adam_update": (["w", "g", "mean", "var"],
                    dict(lr=0.01, beta1=0.8, beta2=0.99, epsilon=1e-6,
                         wd=0.01, rescale_grad=2.0)),
    "nag_mom_update": (["w", "g", "mom"],
                       dict(lr=0.1, momentum=0.9, wd=0.01,
                            clip_gradient=1.5)),
    "rmsprop_update": (["w", "g", "var"],
                       dict(lr=0.01, gamma1=0.9, epsilon=1e-6, wd=0.01,
                            clip_weights=1.2)),
    "rmspropalex_update": (["w", "g", "var", "mom", "mean"],
                           dict(lr=0.01, gamma1=0.9, gamma2=0.8,
                                epsilon=1e-4, rescale_grad=0.5)),
    "ftrl_update": (["w", "g", "mom", "var"],
                    dict(lr=0.1, lamda1=0.05, beta=1.5, wd=0.01,
                         clip_gradient=2.0)),
    "ftml_update": (["w", "g", "var", "var", "mom"],
                    dict(lr=0.01, beta1=0.6, beta2=0.99, epsilon=1e-6,
                         t=2, wd=0.01, clip_grad=1.5)),
    "signsgd_update": (["w", "g"], dict(lr=0.05, wd=0.01,
                                        rescale_grad=0.5)),
    "signum_update": (["w", "g", "mom"],
                      dict(lr=0.05, momentum=0.8, wd=0.01, wd_lh=0.02,
                           clip_gradient=1.0)),
}


def _inputs(mx, names):
    w = _a(0)
    make = {"w16": lambda: mx.nd.array(w, dtype="bfloat16"),
            "w32": lambda: mx.nd.array(w),
            "w": lambda: mx.nd.array(w),
            "g16": lambda: mx.nd.array(_a(1, 2.0), dtype="bfloat16"),
            "g": lambda: mx.nd.array(_a(1, 2.0)),
            "mom": lambda: mx.nd.array(_a(2, 0.1)),
            "mean": lambda: mx.nd.array(_a(3, 0.1)),
            "var": lambda: mx.nd.array(np.abs(_a(4, 0.1)))}
    return [make[n]() for n in names]


def _run_op(mx, name, steps=3):
    names, kwargs = OPS[name]
    arrays = _inputs(mx, names)
    path = []
    for _ in range(steps):
        getattr(mx.nd, name)(*arrays, out=arrays[0], **kwargs)
        path.append([_np(a) for i, a in enumerate(arrays) if i != 1])
    return path


@pytest.mark.parametrize("name", list(OPS))
def test_update_op_matches_jax(name):
    """Three updates in a row, each writing the weight (``out=``) and its
    state in place; every array after every step."""
    want = _run_op(jmx, name)
    got = _run_op(tmx, name)
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            if name.startswith("mp_"):
                np.testing.assert_array_equal(gs[0], ws[0])
            np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("name", ["sgd_update", "sgd_mom_update",
                                  "adam_update"])
def test_update_op_in_bf16_matches_jax(name):
    """The plain ops on bf16 arrays: every op and every scalar rounded to
    bf16 as in the JAX build, within one ulp (ATen's and XLA's sqrt)."""
    kwargs = {"sgd_update": dict(lr=0.1, wd=0.01),
              "sgd_mom_update": dict(lr=0.1, momentum=0.9, wd=0.01),
              "adam_update": dict(lr=0.01, epsilon=1e-3)}[name]
    n_state = {"sgd_update": 0, "sgd_mom_update": 1, "adam_update": 2}[name]

    def run(mx):
        w = mx.nd.array(_a(0), dtype="bfloat16")
        g = mx.nd.array(_a(1), dtype="bfloat16")
        states = [mx.nd.array(np.abs(_a(2 + i, 0.1)), dtype="bfloat16")
                  for i in range(n_state)]
        getattr(mx.nd, name)(w, g, *states, out=w, **kwargs)
        return [_np(a) for a in [w] + states]
    for got, want in zip(run(tmx), run(jmx)):
        assert ulps(got, want, "bfloat16") <= 1


OPTIMIZERS = {
    "sgd": dict(learning_rate=0.1, momentum=0.9, wd=0.01),
    "sgd_plain": dict(learning_rate=0.1, clip_gradient=0.5),
    "adam": dict(learning_rate=0.01, wd=0.001),
    "nag": dict(learning_rate=0.1, momentum=0.9, wd=0.01),
    "nag_plain": dict(learning_rate=0.1),
    "adagrad": dict(learning_rate=0.1, wd=0.01, clip_gradient=1.5),
    "adadelta": dict(rho=0.8, epsilon=1e-4, wd=0.01),
    "rmsprop": dict(learning_rate=0.01, gamma1=0.8, clip_weights=2.0),
    "rmsprop_centered": dict(learning_rate=0.01, centered=True,
                             epsilon=1e-4),
    "ftrl": dict(learning_rate=0.1, lamda1=0.02, wd=0.01),
    "ftml": dict(learning_rate=0.01, wd=0.01),
    "signum": dict(learning_rate=0.05, momentum=0.8, wd_lh=0.01),
    "signum_plain": dict(learning_rate=0.05, momentum=0.0),
    "dcasgd": dict(learning_rate=0.1, momentum=0.9, lamda=0.1, wd=0.01),
    "dcasgd_plain": dict(learning_rate=0.1),
    "lbsgd": dict(learning_rate=0.1, momentum=0.9, batch_scale=4,
                  warmup_epochs=1, updates_per_epoch=3),
    "test": dict(),
}


# the bf16 weights of these equal the JAX build's bit for bit; the others
# within one bf16 ulp: their f32 master copies agree to 1e-6, but XLA
# contracts a product and a sum of the update into one fused multiply-add
# under jit, so a master value within an f32 ulp of a bf16 rounding
# boundary may round to either side (measured: one element of 30, in
# nag without momentum)
BF16_EXACT = ("sgd", "sgd_plain", "adam")


def _updater_path(mx, name, dtype, multi_precision, steps=5):
    kwargs = dict(OPTIMIZERS[name], multi_precision=multi_precision,
                  rescale_grad=0.5)
    if name.endswith("_centered"):
        kwargs["centered"] = True
    opt = mx.optimizer.create(name.split("_")[0], **kwargs)
    upd = mx.optimizer.get_updater(opt)
    weights = [mx.nd.array(_a(i), dtype=dtype) for i in range(2)]
    path = []
    for step in range(steps):
        for i, w in enumerate(weights):
            g = mx.nd.array(_a(10 + 2 * step + i, 2.0), dtype=dtype)
            upd(i, g, w)
        path.append([_np(w) for w in weights])
    return path, upd


@pytest.mark.parametrize("dtype,mp", [("float32", False), ("bfloat16", True)],
                         ids=["f32", "bf16_multi_precision"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_through_updater_matches_jax(name, dtype, mp):
    want, _ = _updater_path(jmx, name, dtype, mp)
    got, upd = _updater_path(tmx, name, dtype, mp)
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            if dtype == "bfloat16" and name in BF16_EXACT:
                np.testing.assert_array_equal(g, w)
            elif dtype == "bfloat16":
                assert ulps(g, w, "bfloat16") <= 1
            else:
                np.testing.assert_allclose(g, w, **TOL)
    if mp:   # the master copy is f32 and the weight its rounding
        state = upd.states[0]
        master = state[1]
        assert tmx.base.dtype_name(master._data.dtype) == "float32"


def test_updater_states_round_trip():
    _, upd = _updater_path(tmx, "adam", "float32", False, steps=2)
    blob = upd.get_states()
    other = tmx.optimizer.get_updater(tmx.optimizer.create("adam"))
    other.set_states(blob)
    w = tmx.nd.array(_a(0))
    state = other.ensure_state(0, w)
    np.testing.assert_array_equal(state[0].asnumpy(),
                                  upd.states[0][0].asnumpy())


def test_registry_and_lr_policy():
    opt = tmx.optimizer.create("SGD", learning_rate=0.2, momentum=0.5)
    assert isinstance(opt, tmx.optimizer.SGD) and opt.momentum == 0.5
    opt.set_learning_rate(0.3)
    assert opt.lr == 0.3
    param = tmx.gluon.Parameter("w", shape=(2,), lr_mult=0.5, wd_mult=2.0)
    opt = tmx.optimizer.create("sgd", learning_rate=0.2, wd=0.1,
                               param_dict={0: param})
    assert opt._get_lr(0) == pytest.approx(0.1)
    assert opt._get_wd(0) == pytest.approx(0.2)
    with pytest.raises(ValueError):
        tmx.optimizer.create("no_such_optimizer")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_card_updates_match_cpu(card):
    """chip_smoke's phase 8d updates: each update op at fc6's shape and
    every optimizer on bf16 weights through multi_precision, on CUDA
    tensors against the port's CPU result."""
    import chip_smoke as cs
    worst = cs.updates_on_card(tmx, np.random.default_rng(cs.SEED))
    assert max(v for k, v in worst.items() if not k.endswith("_move")) \
        <= cs.UPDATE_ULP
