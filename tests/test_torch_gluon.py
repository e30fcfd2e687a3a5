"""Gluon layers of the PyTorch port against the JAX build on the CPU.

Each case builds the layer in both packages, initializes the JAX one,
carries its weights into the port with ``convert.load_numpy_params`` and
feeds both the same seeded numpy input.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.convert import load_numpy_params


def _x(shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _params(jnet):
    return {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}


def _carry(jnet, tnet):
    load_numpy_params(tnet, _params(jnet), tmx.cpu())
    mine = {n[len(tnet.prefix):] for n in tnet.collect_params()}
    theirs = {n[len(jnet.prefix):] for n in jnet.collect_params()}
    assert mine == theirs


# (name, build(nn) -> block, input shapes)
LAYERS = [
    ("dense_flatten_false", lambda nn: nn.Dense(6, flatten=False), [(2, 5, 4)]),
    ("dense_no_bias", lambda nn: nn.Dense(6, flatten=False, use_bias=False,
                                          in_units=4), [(3, 4)]),
    ("dense_flatten", lambda nn: nn.Dense(6, activation="relu"), [(2, 3, 4)]),
    ("layer_norm", lambda nn: nn.LayerNorm(), [(2, 5, 8)]),
    ("layer_norm_eps", lambda nn: nn.LayerNorm(epsilon=1e-2, in_channels=8),
     [(4, 8)]),
    ("mha_unfused", lambda nn: nn.MultiHeadAttention(16, 4), [(2, 10, 16)]),
    ("mha_unfused_causal_no_bias",
     lambda nn: nn.MultiHeadAttention(16, 2, causal=True, use_bias=False),
     [(2, 12, 16)]),
    ("mha_fused", lambda nn: nn.MultiHeadAttention(16, 4, fused_qkv=True),
     [(2, 10, 16)]),
    ("mha_fused_causal",
     lambda nn: nn.MultiHeadAttention(24, 3, causal=True, fused_qkv=True),
     [(1, 9, 24)]),
    ("mha_cross", lambda nn: nn.MultiHeadAttention(16, 4, causal=True),
     [(2, 6, 16), (2, 10, 16), (2, 10, 16)]),
    ("sequential", lambda nn: _seq(nn), [(2, 4, 8)]),
]


def _seq(nn):
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(8, flatten=False), nn.Activation("relu"),
                nn.LayerNorm())
    return net


@pytest.mark.parametrize("name,build,shapes", LAYERS, ids=[c[0] for c in LAYERS])
def test_layer_matches_jax(name, build, shapes):
    xs = [_x(s, seed=i) for i, s in enumerate(shapes)]
    jnet = build(jmx.gluon.nn)
    jnet.initialize(jmx.init.Xavier())
    want = jnet(*[jmx.nd.array(x) for x in xs]).asnumpy()
    tnet = build(tmx.gluon.nn)
    _carry(jnet, tnet)
    with tmx.cpu():
        got = tnet(*[tmx.nd.array(x) for x in xs])
    assert got.shape == want.shape
    np.testing.assert_allclose(got.asnumpy(), want, rtol=0, atol=2e-5)


def test_embedding_clamps_out_of_range_ids():
    ids = np.array([[0, 3, -4, 9], [11, 2, 7.9, 10]], np.float32)
    jnet = jmx.gluon.nn.Embedding(10, 5)
    jnet.initialize(jmx.init.Normal(1.0))
    want = jnet(jmx.nd.array(ids)).asnumpy()
    tnet = tmx.gluon.nn.Embedding(10, 5)
    _carry(jnet, tnet)
    with tmx.cpu():
        got = tnet(tmx.nd.array(ids)).asnumpy()
    np.testing.assert_array_equal(got, want)
    w = _params(jnet)[jnet.prefix + "weight"]
    np.testing.assert_array_equal(got[0, 2], w[0])     # -4 → row 0
    np.testing.assert_array_equal(got[1, 0], w[9])     # 11 → row 9
    np.testing.assert_array_equal(got[1, 2], w[7])     # 7.9 → 7


def test_seq_axis_raises():
    """MultiHeadAttention(seq_axis=...) needs a mesh in scope (the JAX
    build's test_ring_attention_requires_mesh)."""
    blk = tmx.gluon.nn.MultiHeadAttention(16, 4, seq_axis="sp")
    blk.initialize(ctx=tmx.cpu())
    x = tmx.nd.array(np.random.rand(1, 4, 16).astype(np.float32),
                     ctx=tmx.cpu())
    with pytest.raises(RuntimeError, match="no device mesh"):
        blk(x)


def test_load_numpy_params_checks():
    jnet = jmx.gluon.nn.Dense(4, in_units=3)
    jnet.initialize()
    params = _params(jnet)
    missing = {k: v for k, v in params.items() if k.endswith("weight")}
    with pytest.raises(ValueError, match="missing"):
        load_numpy_params(tmx.gluon.nn.Dense(4, in_units=3), missing, tmx.cpu())
    extra = dict(params, **{jnet.prefix + "gamma": np.ones(4, np.float32)})
    with pytest.raises(ValueError, match="extra"):
        load_numpy_params(tmx.gluon.nn.Dense(4, in_units=3), extra, tmx.cpu())
    with pytest.raises(ValueError, match="shape"):
        load_numpy_params(tmx.gluon.nn.Dense(4, in_units=5), params, tmx.cpu())
    as_f64 = {k: v.astype(np.float64) for k, v in params.items()}
    with pytest.raises(ValueError, match="dtype"):
        load_numpy_params(tmx.gluon.nn.Dense(4, in_units=3), as_f64, tmx.cpu())
    mixed = {"a_weight": params[jnet.prefix + "weight"],
             "b_bias": params[jnet.prefix + "bias"]}
    with pytest.raises(ValueError, match="prefixes"):
        load_numpy_params(tmx.gluon.nn.Dense(4, in_units=3), mixed, tmx.cpu())


def test_param_names_and_deferred_init():
    tnet = tmx.gluon.nn.MultiHeadAttention(8, 2)
    jnet = jmx.gluon.nn.MultiHeadAttention(8, 2)
    names = sorted(n[len(tnet.prefix):] for n in tnet.collect_params())
    assert names == sorted(n[len(jnet.prefix):] for n in jnet.collect_params())
    with tmx.cpu():
        tnet.initialize(tmx.init.Xavier())
        w = tnet.proj_q.weight
        assert w.shape == (8, 0)
        with pytest.raises(tmx.gluon.DeferredInitializationError):
            w.data()
        out = tnet(tmx.nd.array(_x((1, 3, 8))))
    assert out.shape == (1, 3, 8) and w.shape == (8, 8)
    assert w.list_ctx() == [tmx.cpu()]


def test_cast_and_hybridize():
    with tmx.cpu():
        net = tmx.gluon.nn.Dense(3, in_units=4)
        net.initialize(tmx.init.One())
        net.hybridize()
        net.cast("bfloat16")
        assert net.weight.data().dtype == torch.bfloat16
        out = net(tmx.nd.array(np.ones((2, 4), np.float32), dtype="bfloat16"))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.asnumpy(), np.full((2, 3), 4.0))


@pytest.mark.parametrize("init,check", [
    (lambda: tmx.init.Zero(), lambda a: (a == 0).all()),
    (lambda: tmx.init.One(), lambda a: (a == 1).all()),
    (lambda: tmx.init.Constant(0.25), lambda a: (a == 0.25).all()),
    (lambda: tmx.init.Uniform(0.1), lambda a: np.abs(a).max() <= 0.1
     and a.std() > 0.03),
    (lambda: tmx.init.Normal(0.5), lambda a: abs(a.std() - 0.5) < 0.05),
    (lambda: tmx.init.Xavier(magnitude=3),
     lambda a: np.abs(a).max() <= np.sqrt(3 / 64) and a.std() > 0.1),
    (lambda: tmx.init.Xavier(rnd_type="gaussian", factor_type="in"),
     lambda a: abs(a.std() - np.sqrt(3 / 64)) < 0.03),
], ids=["zero", "one", "constant", "uniform", "normal", "xavier",
        "xavier_gaussian_in"])
def test_initializers(init, check):
    with tmx.cpu():
        net = tmx.gluon.nn.Dense(64, in_units=64, use_bias=False)
        tmx.random.seed(7)
        net.initialize(init())
        first = net.weight.data().asnumpy()
        net2 = tmx.gluon.nn.Dense(64, in_units=64, use_bias=False)
        tmx.random.seed(7)
        net2.initialize(init())
    assert check(first)
    np.testing.assert_array_equal(first, net2.weight.data().asnumpy())
