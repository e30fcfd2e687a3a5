"""The initializers of the port against the JAX build, on the CPU.

The deterministic ones (``Zero``, ``One``, ``Constant``, ``Bilinear``,
``LSTMBias``, ``Load``, ``Mixed`` over them) fill bit for bit what the
JAX build fills.  The random ones (``Orthogonal``, ``MSRAPrelu``) draw
from the framework generator, so they are held by property: Orthogonal's
rows (or columns) orthonormal times its scale, MSRAPrelu's variance
magnitude / fan within 6 standard errors; ``tests/test_torch_random.py``
shows their draws follow ``mx.random.seed``.
"""
import math

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _fill(mx, init, name, shape):
    a = mx.nd.zeros(shape)
    init(mx.initializer.InitDesc(name), a)
    return a.asnumpy()


DETERMINISTIC = [
    ("zero", lambda mx: mx.init.Zero(), "w_weight", (3, 4)),
    ("one", lambda mx: mx.init.One(), "w_weight", (3, 4)),
    ("constant", lambda mx: mx.init.Constant(0.25), "w_weight", (5,)),
    ("bilinear_4", lambda mx: mx.init.Bilinear(), "up_weight", (3, 1, 4, 4)),
    ("bilinear_5", lambda mx: mx.init.Bilinear(), "up_weight", (2, 2, 5, 5)),
    ("bilinear_3x6", lambda mx: mx.init.Bilinear(), "up_weight",
     (1, 1, 3, 6)),
    ("lstmbias", lambda mx: mx.init.LSTMBias(forget_bias=2.0), "l_bias",
     (16,)),
    ("lstmbias_weight_name", lambda mx: mx.init.LSTMBias(), "l_weight",
     (8,)),
    ("bias_default", lambda mx: mx.init.Xavier(), "d_bias", (6,)),
    ("gamma_default", lambda mx: mx.init.Xavier(), "bn_gamma", (6,)),
    ("load", lambda mx: mx.init.Load(
        {"arg:w_weight": np.arange(12.0).reshape(3, 4)}), "w_weight",
     (3, 4)),
    ("load_default", lambda mx: mx.init.Load({}, mx.init.One()),
     "w_weight", (2, 2)),
    ("mixed", lambda mx: mx.init.Mixed(["x_.*", ".*"], [
        mx.init.Constant(3.0), mx.init.Bilinear()]), "y_weight",
     (1, 1, 4, 4)),
]


@pytest.mark.parametrize("case", DETERMINISTIC, ids=[c[0] for c in
                                                     DETERMINISTIC])
def test_deterministic_initializer_matches_jax(case):
    _, make, name, shape = case
    want = _fill(jmx, make(jmx), name, shape)
    got = _fill(tmx, make(tmx), name, shape)
    np.testing.assert_array_equal(got, want)


def test_initializer_errors_and_registry():
    with pytest.raises(ValueError, match="Shape mismatch"):
        _fill(tmx, tmx.init.Load({"w_weight": np.ones((2, 2))}),
              "w_weight", (3, 3))
    with pytest.raises(ValueError, match="no default Initializer"):
        _fill(tmx, tmx.init.Load({}), "w_weight", (3, 3))
    with pytest.raises(ValueError, match="did not match any pattern"):
        _fill(tmx, tmx.init.Mixed(["a.*"], [tmx.init.One()]), "w_weight",
              (2,))
    for name in ("orthogonal", "msraprelu", "bilinear", "lstmbias"):
        assert type(tmx.init.create(name)).__name__.lower() == name
    assert tmx.init.MSRAPrelu(slope=0.1).dumps() == \
        jmx.init.MSRAPrelu(slope=0.1).dumps()
    assert tmx.init.Orthogonal().dumps() == jmx.init.Orthogonal().dumps()


def test_bilinear_weights_an_upsampling_layer():
    """A parameter made with ``init=Bilinear()`` is filled by it whatever
    the block's default initializer."""
    p = tmx.gluon.Parameter("up_weight", shape=(2, 1, 4, 4),
                            init=tmx.init.Bilinear())
    p.initialize(default_init=tmx.init.Zero())
    want = _fill(jmx, jmx.init.Bilinear(), "up_weight", (2, 1, 4, 4))
    np.testing.assert_array_equal(p.data().asnumpy(), want)


def _moments_ok(x, mean, var):
    x = np.asarray(x, np.float64).ravel()
    n = x.size
    assert abs(x.mean() - mean) <= 6 * math.sqrt(var / n)
    assert abs(x.var() - var) <= 6 * math.sqrt(2 * var * var / n)


def test_random_initializers_by_property():
    """Orthogonal: orthonormal rows (or columns) times its scale, for
    either draw; MSRAPrelu: Gaussian with variance magnitude / fan
    (2 / (1 + slope²) over the average fan)."""
    for shape in ((16, 48), (48, 16), (8, 3, 2, 2)):
        for rand_type in ("uniform", "normal"):
            a = tmx.nd.zeros(shape)
            tmx.init.Orthogonal(scale=1.5, rand_type=rand_type)(
                tmx.initializer.InitDesc("w_weight"), a)
            q = a.asnumpy().reshape(shape[0], -1)
            gram = q @ q.T if q.shape[0] <= q.shape[1] else q.T @ q
            np.testing.assert_allclose(gram, 2.25 * np.eye(len(gram)),
                                       atol=1e-5)
    a = tmx.nd.zeros((256, 128, 3, 3))
    tmx.random.seed(0)
    tmx.init.MSRAPrelu(slope=0.5)(tmx.initializer.InitDesc("c_weight"), a)
    fan = (128 + 256) * 9 / 2.0
    _moments_ok(a.asnumpy(), 0.0, 2.0 / 1.25 / fan)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_card_initializers_match_cpu(card):
    """chip_smoke's phase 8d initializers: the deterministic ones fill the
    same values on the card, bit for bit."""
    import chip_smoke as cs
    assert cs.initializers_on_card(tmx) == 6
