"""The random ops of the PyTorch port (``ops/random_ops.py``, ``shuffle``,
``Dropout``, rrelu, ``mx.random``/``nd.random``, the random initializers,
SGLD) on the CPU.

Stream equality with ``jax.random`` is not a goal (ROADMAP trap A4): the
JAX build draws from threefry keys, the port from torch's Philox/MT
generators.  So each sampler is held to its distribution and its
properties, and to the JAX build's output shape and dtype:

* moments: the mean and variance of 2^16 draws within 6 standard errors
  of the analytic values (the standard error of a sample variance from the
  distribution's fourth moment);
* Kolmogorov-Smirnov distance against scipy's CDF for the continuous
  samplers, below the large-n bound at p = 1e-6, sqrt(-ln(p / 2) / (2n));
* class frequencies by chi-square at p = 1e-6;
* every draw from the framework generator: two draws after the same
  ``mx.random.seed`` are bit-equal although torch's default generator is
  reseeded in between, and no draw moves torch's default generator.
"""
import math

import numpy as np
import pytest
import scipy.stats as st
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import random_state

N = 1 << 16
P_VALUE = 1e-6
KS_BOUND = math.sqrt(-math.log(P_VALUE / 2) / (2 * N))


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _np(a):
    return np.asarray(a.asnumpy(), np.float64)


def _moments_ok(x, mean, var, m4=None):
    """Sample mean and variance within 6 standard errors; ``m4`` the
    fourth central moment (a normal's 3·var² by default)."""
    x = np.asarray(x, np.float64).ravel()
    n = x.size
    m4 = 3 * var * var if m4 is None else m4
    se_mean = math.sqrt(var / n)
    se_var = math.sqrt(max(m4 - var * var, 1e-30) / n)
    assert abs(x.mean() - mean) <= 6 * se_mean, (x.mean(), mean)
    assert abs(x.var() - var) <= 6 * se_var, (x.var(), var)


def _ks_ok(x, cdf):
    d = st.kstest(np.asarray(x, np.float64).ravel(), cdf).statistic
    assert d <= KS_BOUND, (d, KS_BOUND)


# sampler name -> draw(mx) for the seed tests; each a call a user makes
SAMPLERS = {
    "uniform": lambda mx: mx.random.uniform(-1, 2, shape=(64, 8)),
    "normal": lambda mx: mx.nd.random.normal(1, 3, shape=(64, 8)),
    "gamma": lambda mx: mx.random.gamma(2.5, 0.5, shape=(512,)),
    "exponential": lambda mx: mx.random.exponential(2.0, shape=(512,)),
    "poisson": lambda mx: mx.random.poisson(4.0, shape=(512,)),
    "negative_binomial": lambda mx: mx.random.negative_binomial(
        3, 0.4, shape=(512,)),
    "generalized_negative_binomial":
        lambda mx: mx.random.generalized_negative_binomial(
            2.0, 0.3, shape=(512,)),
    "multinomial": lambda mx: mx.random.multinomial(
        mx.nd.array(np.full((4, 5), 0.2, np.float32)), shape=16),
    "shuffle": lambda mx: mx.random.shuffle(mx.nd.arange(64).reshape(
        (16, 4))),
    "sample_uniform": lambda mx: mx.nd.random.uniform(
        mx.nd.array([0.0, 5.0]), mx.nd.array([1.0, 6.0]), shape=(32,)),
    "sample_normal": lambda mx: mx.nd.random.normal(
        mx.nd.array([0.0, 5.0]), mx.nd.array([1.0, 2.0]), shape=(32,)),
    "dropout": lambda mx: _train(mx, lambda: mx.nd.Dropout(
        mx.nd.ones((64, 16)), p=0.3)),
    "rrelu": lambda mx: _train(mx, lambda: mx.nd.LeakyReLU(
        -mx.nd.ones((64, 16)), act_type="rrelu")),
    "orthogonal": lambda mx: _init(mx, mx.init.Orthogonal()),
    "msraprelu": lambda mx: _init(mx, mx.init.MSRAPrelu()),
    "sgld": lambda mx: _sgld(mx),
}


def _train(mx, fn):
    with mx.autograd.train_mode():
        return fn()


def _init(mx, init):
    a = mx.nd.zeros((16, 24))
    init(mx.initializer.InitDesc("w_weight"), a)
    return a


def _sgld(mx):
    w = mx.nd.ones((32, 8))
    upd = mx.optimizer.get_updater(mx.optimizer.create(
        "sgld", learning_rate=0.01))
    upd(0, mx.nd.ones((32, 8)), w)
    return w


def _values(out):
    outs = out if isinstance(out, list) else [out]
    return [o.asnumpy() for o in outs]


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_draws_follow_the_seed_not_torchs_default_generator(name):
    """The same ``mx.random.seed`` gives the same draws although torch's
    default generator is reseeded in between; another seed gives others;
    no draw moves torch's default generator."""
    draw = SAMPLERS[name]
    torch.manual_seed(1)
    tmx.random.seed(7)
    state = torch.get_rng_state()
    a = _values(draw(tmx))
    assert torch.equal(torch.get_rng_state(), state)
    torch.manual_seed(2)
    tmx.random.seed(7)
    b = _values(draw(tmx))
    tmx.random.seed(8)
    c = _values(draw(tmx))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert any(not np.array_equal(x, z) for x, z in zip(a, c))


def test_use_generator_reaches_the_ops():
    """``random_state.use_generator`` (what ``functionalize`` uses) scopes
    every op's draws; a scope that draws nothing makes no generator."""
    with random_state.use_generator(11):
        a = tmx.random.normal(shape=(8,)).asnumpy()
        d = _train(tmx, lambda: tmx.nd.Dropout(tmx.nd.ones((8,)))).asnumpy()
    with random_state.use_generator(11):
        b = tmx.random.normal(shape=(8,)).asnumpy()
        e = _train(tmx, lambda: tmx.nd.Dropout(tmx.nd.ones((8,)))).asnumpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(d, e)
    g = torch.Generator()
    g.manual_seed(11)
    with random_state.use_generator(g):
        c = tmx.random.normal(shape=(8,)).asnumpy()
    np.testing.assert_array_equal(a, c)
    with random_state.use_generator(3):
        scope = random_state._override.scope
        with tmx.autograd.predict_mode():
            tmx.nd.Dropout(tmx.nd.ones((4, 4)), p=0.5)
            tmx.nd.LeakyReLU(tmx.nd.ones((4, 4)), act_type="rrelu")
        assert scope[2] == {}     # inference drew nothing, made nothing


# (name, port draw of N values, JAX draw of a few, mean, var, m4, cdf)
def _gamma_m4(a, b):
    return 3 * a * (a + 2) * b ** 4


CONTINUOUS = [
    ("uniform", lambda mx, n: mx.random.uniform(-1, 3, shape=(n,)),
     1.0, 16 / 12, 16 ** 2 / 80, st.uniform(-1, 4).cdf),
    ("normal", lambda mx, n: mx.random.normal(2, 0.5, shape=(n,)),
     2.0, 0.25, None, st.norm(2, 0.5).cdf),
    ("exponential", lambda mx, n: mx.random.exponential(4.0, shape=(n,)),
     0.25, 1 / 16, 9 / 4 ** 4, st.expon(scale=0.25).cdf),
    ("gamma_0.5", lambda mx, n: mx.random.gamma(0.5, 2.0, shape=(n,)),
     1.0, 2.0, _gamma_m4(0.5, 2.0), st.gamma(0.5, scale=2.0).cdf),
    ("gamma_2", lambda mx, n: mx.random.gamma(2.0, 1.0, shape=(n,)),
     2.0, 2.0, _gamma_m4(2.0, 1.0), st.gamma(2.0).cdf),
    ("gamma_9", lambda mx, n: mx.random.gamma(9.0, 0.5, shape=(n,)),
     4.5, 2.25, _gamma_m4(9.0, 0.5), st.gamma(9.0, scale=0.5).cdf),
]


@pytest.mark.parametrize("name,draw,mean,var,m4,cdf", CONTINUOUS,
                         ids=[c[0] for c in CONTINUOUS])
def test_continuous_sampler_distribution(name, draw, mean, var, m4, cdf):
    tmx.random.seed(0)
    x = draw(tmx, N)
    want = draw(jmx, 16)
    assert x.dtype == want.dtype and x.shape == (N,)
    x = _np(x)
    _moments_ok(x, mean, var, m4)
    _ks_ok(x, cdf)


# (name, draw, mean, var): negative binomial k(1-p)/p, k(1-p)/p²;
# generalized: mu, mu + alpha·mu²
DISCRETE = [
    ("poisson", lambda mx, n: mx.random.poisson(3.5, shape=(n,)), 3.5, 3.5),
    ("negative_binomial", lambda mx, n: mx.random.negative_binomial(
        4, 0.3, shape=(n,)), 4 * 0.7 / 0.3, 4 * 0.7 / 0.09),
    ("generalized_negative_binomial",
     lambda mx, n: mx.random.generalized_negative_binomial(
         2.0, 0.5, shape=(n,)), 2.0, 2.0 + 0.5 * 4.0),
]


@pytest.mark.parametrize("name,draw,mean,var", DISCRETE,
                         ids=[d[0] for d in DISCRETE])
def test_discrete_sampler_moments(name, draw, mean, var):
    tmx.random.seed(0)
    x = draw(tmx, N)
    want = draw(jmx, 16)
    assert x.dtype == want.dtype and x.shape == (N,)
    x = _np(x)
    assert np.array_equal(x, np.round(x)) and x.min() >= 0
    # the sample variance's standard error from the draws' own 4th moment
    m4 = float(((x - x.mean()) ** 4).mean())
    _moments_ok(x, mean, var, m4)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_half_precision_uniform_and_normal(dtype):
    """16-bit draws, 2^20 of them: U[-1, 3) inside its range and unbiased
    (torch's own bf16 ``uniform_`` sends a draw that rounds up to 3 to -1,
    a mean 7 standard errors low here), N(0, 1) by its moments."""
    n = 1 << 20
    tmx.random.seed(0)
    u = tmx.random.uniform(-1, 3, shape=(n,), dtype=dtype)
    z = tmx.random.normal(0, 1, shape=(n,), dtype=dtype)
    assert tmx.base.dtype_name(u._data.dtype) == dtype
    assert str(jmx.random.uniform(0, 1, shape=(4,), dtype=dtype).dtype) \
        == dtype
    u = _np(u)
    assert u.min() >= -1 and u.max() < 3
    _moments_ok(u, 1.0, 16 / 12, 256 / 80)
    _moments_ok(_np(z), 0.0, 1.0)
    w = _np(tmx.random.uniform(0.1, 0.3, shape=(n,), dtype=dtype))
    assert w.min() >= 0.1 and w.max() < 0.3


@pytest.mark.parametrize("data_shape,shape", [((5,), (3, 4)), ((3, 5), (7,)),
                                              ((3, 5), ()), ((5,), ())])
def test_multinomial_shapes_and_log_probabilities(data_shape, shape):
    """Shapes and dtypes as the JAX build's, and each draw's
    log-probability.  The JAX build's ``get_prob`` raises on a 1-d row
    (its ``take_along_axis`` gets 2-d indices; ROADMAP, reference-side
    faults), so there only the draws' shape is compared."""
    rs = np.random.RandomState(0)
    p = rs.uniform(0.1, 1, data_shape).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    got, lp = tmx.random.multinomial(tmx.nd.array(p), shape=shape,
                                     get_prob=True)
    assert lp.shape == got.shape and lp.dtype == np.float32
    if len(data_shape) == 1:
        with pytest.raises(ValueError):
            jmx.random.multinomial(jmx.nd.array(p), shape=shape,
                                   get_prob=True)
        want = jmx.random.multinomial(jmx.nd.array(p), shape=shape)
    else:
        want, wlp = jmx.random.multinomial(jmx.nd.array(p), shape=shape,
                                           get_prob=True)
        assert lp.shape == wlp.shape and lp.dtype == wlp.dtype
    assert got.shape == want.shape and got.dtype == want.dtype
    ids = got.asnumpy().astype(np.int64)
    rows = p.reshape(-1, p.shape[-1])
    flat = ids.reshape(rows.shape[0], -1)
    np.testing.assert_allclose(
        lp.asnumpy().reshape(flat.shape),
        np.log(np.take_along_axis(rows, flat, 1)), rtol=1e-6)


def test_multinomial_frequencies_chi_square():
    p = np.array([0.05, 0.15, 0.3, 0.5], np.float32)
    tmx.random.seed(0)
    ids = tmx.random.multinomial(tmx.nd.array(np.stack([p, p[::-1]])),
                                 shape=N).asnumpy()
    for row, probs in zip(ids, (p, p[::-1])):
        counts = np.bincount(row, minlength=4)
        expected = probs / probs.sum(dtype=np.float64) * N
        assert st.chisquare(counts, expected).pvalue > P_VALUE


def test_sample_uniform_and_normal_per_element():
    """``nd.random.uniform``/``normal`` with array parameters: ``shape``
    draws for each parameter element, shaped ``low.shape + shape``."""
    lo, hi = np.array([[0, 10], [-5, 1]], np.float32), \
        np.array([[1, 12], [-4, 5]], np.float32)
    tmx.random.seed(0)
    u = tmx.nd.random.uniform(tmx.nd.array(lo), tmx.nd.array(hi),
                              shape=(N // 4,))
    z = tmx.nd.random.normal(tmx.nd.array(lo), tmx.nd.array(hi - lo),
                             shape=(N // 4,))
    want = jmx.nd.random.uniform(jmx.nd.array(lo), jmx.nd.array(hi),
                                 shape=(3,))
    assert u.shape == (2, 2, N // 4) and want.shape == (2, 2, 3)
    u, z = _np(u), _np(z)
    for i in range(2):
        for j in range(2):
            w = float(hi[i, j] - lo[i, j])
            assert lo[i, j] <= u[i, j].min() and u[i, j].max() < hi[i, j]
            _moments_ok(u[i, j], lo[i, j] + w / 2, w * w / 12,
                        w ** 4 / 80)
            _moments_ok(z[i, j], lo[i, j], w * w)


def test_shuffle_permutes_whole_rows():
    x = np.arange(200 * 3, dtype=np.float32).reshape(200, 3)
    tmx.random.seed(0)
    got = tmx.random.shuffle(tmx.nd.array(x)).asnumpy()
    want = jmx.random.shuffle(jmx.nd.array(x)).asnumpy()
    for out in (got, want):
        assert out.shape == x.shape
        np.testing.assert_array_equal(np.sort(out[:, 0]), x[:, 0])
        np.testing.assert_array_equal(out[:, 1:] - out[:, :1],
                                      x[:, 1:] - x[:, :1])
    assert not np.array_equal(got, x)
    assert tmx.nd._shuffle is not None and \
        tmx.ops.registry.get_op("_shuffle") is \
        tmx.ops.registry.get_op("shuffle")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_dropout_keep_share_values_and_gradient(dtype):
    """In training each element is kept with probability 1 - p, as
    ``x / keep`` with ``keep`` in the dtype (the JAX build's division; a
    product with 1/keep differs by an ulp in 16-bit), and its gradient is
    mask / keep."""
    p = 0.3
    rs = np.random.RandomState(0)
    x = rs.uniform(0.5, 2.0, (256, 256)).astype(np.float32)
    tmx.random.seed(0)
    a = tmx.nd.array(x, dtype=dtype)
    a.attach_grad()
    with tmx.autograd.record():
        y = tmx.nd.Dropout(a, p=p)
    y.backward()
    out = y._data
    mask = out != 0
    keep = torch.tensor(1 - p, dtype=out.dtype)
    share = float(mask.float().mean())
    n = mask.numel()
    assert abs(share - (1 - p)) <= 6 * math.sqrt(p * (1 - p) / n)
    assert torch.equal(out[mask], (a._data / keep)[mask])
    assert torch.equal(a.grad._data, torch.where(
        mask, torch.ones_like(out) / keep, torch.zeros_like(out)))


def test_dropout_modes_axes_and_identity():
    x = tmx.nd.ones((8, 6, 5))
    with tmx.autograd.predict_mode():
        np.testing.assert_array_equal(tmx.nd.Dropout(x, p=0.5).asnumpy(), 1)
        always = tmx.nd.Dropout(x, p=0.5, mode="always").asnumpy()
    assert 0 < (always == 0).mean() < 1
    with tmx.autograd.train_mode():
        np.testing.assert_array_equal(tmx.nd.Dropout(x, p=0.0).asnumpy(), 1)
        shared = tmx.nd.Dropout(x, p=0.5, axes=(1,)).asnumpy()
    # one draw along axis 1: every (i, :, k) column is all kept or all not
    assert np.all((shared == 0).all(1) | (shared != 0).all(1))
    want = jmx.nd.Dropout(jmx.nd.ones((8, 6, 5)), p=0.5, axes=(1,))
    assert want.shape == shared.shape


def test_gluon_dropout_layer_trains_and_predicts():
    layer = tmx.gluon.nn.Dropout(0.5, axes=(0,))
    assert "p = 0.5" in repr(layer)
    x = tmx.nd.ones((4, 32))
    np.testing.assert_array_equal(layer(x).asnumpy(), 1)
    with tmx.autograd.record():
        y = layer(x).asnumpy()
    assert set(np.unique(y)) <= {0.0, 2.0}
    assert np.all((y == y[:1]))            # shared along axis 0


def test_rrelu_slopes_lie_in_their_range():
    lo, hi = 0.1, 0.4
    x = -np.random.RandomState(0).uniform(0.5, 2, (64, 64)).astype(
        np.float32)
    tmx.random.seed(0)
    with tmx.autograd.train_mode():
        y = tmx.nd.LeakyReLU(tmx.nd.array(x), act_type="rrelu",
                             lower_bound=lo, upper_bound=hi).asnumpy()
    s = y / x
    assert s.min() >= lo and s.max() < hi and np.unique(s).size > 100
    _moments_ok(s, (lo + hi) / 2, (hi - lo) ** 2 / 12, (hi - lo) ** 4 / 80)
    pos = tmx.nd.LeakyReLU(tmx.nd.array(-x), act_type="rrelu")
    np.testing.assert_array_equal(pos.asnumpy(), -x)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_rrelu_16bit_slopes_unbiased(dtype):
    """rrelu's training slopes in 16 bits, 2^20 of them on x = -1 (so the
    output is minus the slope, exactly): inside [lower, upper) and
    unbiased.  They are drawn as ``nd.random.uniform``'s 16-bit draws are;
    torch's own bf16 ``uniform_`` sends a slope that rounds up to
    ``upper`` to ``lower``, which puts the bf16 mean 16 standard errors
    low here."""
    lo, hi = 0.125, 0.334
    tmx.random.seed(0)
    with tmx.autograd.train_mode():
        y = tmx.nd.LeakyReLU(-tmx.nd.ones((1 << 20,), dtype=dtype),
                             act_type="rrelu", lower_bound=lo,
                             upper_bound=hi)
    assert tmx.base.dtype_name(y._data.dtype) == dtype
    s = -_np(y)
    assert s.min() >= lo and s.max() < hi
    _moments_ok(s, (lo + hi) / 2, (hi - lo) ** 2 / 12, (hi - lo) ** 4 / 80)


def test_sgld_deterministic_part_with_zero_noise(monkeypatch):
    """SGLD's update without its noise (monkeypatched to zero in both
    builds) is w - lr/2·(rescale·g + wd·w), as the JAX build's, over 3
    steps to 1e-6; with the noise, the residual is N(0, lr)."""
    import jax
    rs = np.random.RandomState(0)
    w0 = rs.standard_normal((64, 32)).astype(np.float32)
    grads = [rs.standard_normal((64, 32)).astype(np.float32)
             for _ in range(3)]

    def run(mx):
        opt = mx.optimizer.create("sgld", learning_rate=0.1, wd=0.01,
                                  rescale_grad=0.5, clip_gradient=1.0)
        upd = mx.optimizer.get_updater(opt)
        w = mx.nd.array(w0)
        for g in grads:
            upd(0, mx.nd.array(g), w)
        return w.asnumpy()
    with monkeypatch.context() as m:
        m.setattr(jax.random, "normal",
                  lambda key, shape, dtype: jax.numpy.zeros(shape, dtype))
        m.setattr(torch, "randn", lambda *shape, **kw: torch.zeros(
            *shape, dtype=kw.get("dtype"), device=kw.get("device")))
        want, got = run(jmx), run(tmx)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    tmx.random.seed(0)
    opt = tmx.optimizer.create("sgld", learning_rate=0.04)
    w = tmx.nd.zeros((N,))
    tmx.optimizer.get_updater(opt)(0, tmx.nd.zeros((N,)), w)
    _moments_ok(w.asnumpy(), 0.0, 0.04)


def test_random_ops_registered_as_in_jax():
    """Every op of the JAX build's ops/random_ops.py, its aliases
    resolving to the same Operator, each marked as drawing."""
    from incubator_mxnet_tpu.ops import registry as jreg
    from incubator_mxnet_tpu_torch.ops import registry as treg
    names = {n for n, o in jreg._REGISTRY.items()
             if o.fcompute.__module__ == "incubator_mxnet_tpu.ops.random_ops"}
    assert names and names <= set(treg._REGISTRY)
    for n in names:
        assert treg.get_op(n).name == jreg.get_op(n).name
        assert treg.get_op(n).needs_rng and not treg.get_op(n).differentiable
    assert set(tmx.random.__all__) == set(jmx.random.__all__)
    public = {n for n in dir(jmx.nd.random) if not n.startswith("_")}
    assert {n for n in public if callable(getattr(jmx.nd.random, n))} - \
        {"NDArray", "get_op", "invoke"} <= set(dir(tmx.nd.random))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_card_random_draws(card):
    """chip_smoke's phase 8e on the card: moments, KS, chi-square,
    shuffle, dropout and rrelu, seeds with the default generator reseeded,
    under sync-debug mode "error"."""
    import chip_smoke as cs
    cs.random_draws(tmx, cs.card_line())
