"""The glue around the port's Gluon against the JAX build's, on the CPU:
``gluon.utils`` (``split_data``, ``split_and_load``, ``clip_global_norm``
with its NaN warning, ``check_sha1``, ``download`` of local files),
``gluon.Constant``, ``gluon.contrib.nn``, ``model_zoo.model_store`` on
``tmp_path`` with ``pretrained=True`` loading a local file, and
``test_utils``.  Bounds: bit-equal where both compute the same f32
operations; ``clip_global_norm``'s sums of squares run in another order
(XLA's reduction against ATen's), so its norm and the scaled arrays are
within 1e-6 relative."""
import hashlib
import warnings

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import test_utils as jtu
from incubator_mxnet_tpu_torch.base import MXNetError


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _x(shape=(6, 4, 5), seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("axis,n,even", [(0, 3, True), (1, 2, True),
                                         (2, 2, False), (0, 4, False)])
def test_split_data_matches_jax(axis, n, even):
    x = _x()
    got = tmx.gluon.utils.split_data(tmx.nd.array(x), n, axis, even)
    want = jmx.gluon.utils.split_data(jmx.nd.array(x), n, axis, even)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())


def test_split_errors_and_split_and_load():
    x = _x()
    for m in (tmx, jmx):
        with pytest.raises(ValueError, match="Too many slices"):
            m.gluon.utils.split_data(m.nd.array(x), 7)
        with pytest.raises(ValueError, match="evenly split"):
            m.gluon.utils.split_data(m.nd.array(x), 4)
    one = tmx.gluon.utils.split_and_load(x, [tmx.cpu()])
    assert len(one) == 1 and one[0].context == tmx.cpu()
    np.testing.assert_array_equal(one[0].asnumpy(), x)
    two = tmx.gluon.utils.split_and_load(tmx.nd.array(x), [tmx.cpu(0)] * 2)
    want = jmx.gluon.utils.split_and_load(x, [jmx.cpu(0)] * 2)
    for g, w in zip(two, want):
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())


@pytest.mark.parametrize("max_norm", [1.0, 1e4])
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_clip_global_norm_matches_jax(max_norm, dtype):
    """Each array's sum of squares in f32, the total and its root in
    float64 on the host; the arrays scaled in place when the norm is
    above ``max_norm``, untouched otherwise."""
    xs = [_x((3, 4), s).astype(dtype) for s in range(3)]
    t = [tmx.nd.array(a, dtype=dtype) for a in xs]
    j = [jmx.nd.array(a, dtype=dtype) for a in xs]
    got = tmx.gluon.utils.clip_global_norm(t, max_norm)
    want = jmx.gluon.utils.clip_global_norm(j, max_norm)
    assert isinstance(got, float)
    assert got == pytest.approx(want, rel=1e-6)
    for a, b, x in zip(t, j, xs):
        if max_norm > got:
            np.testing.assert_array_equal(a.asnumpy(), x)
        np.testing.assert_allclose(a.asnumpy().astype(np.float32),
                                   b.asnumpy().astype(np.float32),
                                   rtol=1e-6 if dtype == "float32" else 1e-3)


def test_clip_global_norm_with_a_nan_warns_as_jax():
    xs = [_x((2, 3), 1), _x((4,), 2)]
    xs[1][2] = np.nan
    results = []
    for m in (tmx, jmx):
        arrs = [m.nd.array(a) for a in xs]
        with pytest.warns(UserWarning, match="nan or inf"):
            norm = m.gluon.utils.clip_global_norm(arrs, 1.0)
        results.append((norm, [a.asnumpy() for a in arrs]))
    (tn, ta), (jn, ja) = results
    assert np.isnan(tn) and np.isnan(jn)
    for a, b in zip(ta, ja):       # NaN scales nothing: both unchanged
        np.testing.assert_array_equal(a, b)


def test_check_sha1_and_download(tmp_path):
    src = tmp_path / "weights.bin"
    src.write_bytes(b"mxnet" * 1000)
    digest = hashlib.sha1(src.read_bytes()).hexdigest()
    for m in (tmx, jmx):
        assert m.gluon.utils.check_sha1(str(src), digest)
        assert not m.gluon.utils.check_sha1(str(src), "0" * 40)
    dest = tmp_path / "copies"
    dest.mkdir()
    got = tmx.gluon.utils.download("file://" + str(src), path=str(dest),
                                   sha1_hash=digest)
    assert got == str(dest / "weights.bin")
    assert tmx.gluon.utils.check_sha1(got, digest)
    # an existing file with the right hash is kept, whatever the URL
    assert tmx.gluon.utils.download("https://example.invalid/weights.bin",
                                    path=got, sha1_hash=digest) == got
    with pytest.raises(MXNetError, match="nothing is downloaded"):
        tmx.gluon.utils.download("https://example.invalid/other.bin",
                                 path=str(dest))
    with pytest.raises(IOError):
        jmx.gluon.utils.download("https://example.invalid/other.bin",
                                 path=str(dest))


def test_constant_matches_jax():
    """Non-trainable, filled from its value, its initializer registered as
    ``Constant_<name>`` so ``dumps()`` round-trips through ``create``."""
    value = _x((2, 3), 4)
    got = []
    for m in (tmx, jmx):
        c = m.gluon.Constant("const_u", value)
        assert c.grad_req == "null" and c.shape == (2, 3)
        c.initialize(ctx=m.cpu())
        got.append(c.data().asnumpy())
        dumped = c.init.dumps()
        assert m.initializer.create(dumped.split('"')[1]).__class__ \
            .__name__ == "Constant_const_u"
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[0], value)
    c = tmx.gluon.Constant("const_v", tmx.nd.array(value))
    c.initialize()
    with pytest.raises(RuntimeError, match="grad_req='null'"):
        c.grad()


def test_contrib_nn_matches_jax():
    rs = np.random.RandomState(6)
    x = rs.standard_normal((2, 5)).astype(np.float32)
    w1, w2 = rs.standard_normal((3, 5)), rs.standard_normal((4, 5))
    outs = []
    for m in (tmx, jmx):
        cnn = m.gluon.contrib.nn
        for cls in (cnn.HybridConcurrent, cnn.Concurrent):
            net = cls(axis=1)
            net.add(m.gluon.nn.Dense(3, in_units=5, use_bias=False),
                    m.gluon.nn.Dense(4, in_units=5, use_bias=False),
                    cnn.Identity())
            net.initialize()
            for p, w in zip(net.collect_params().values(), (w1, w2)):
                p.set_data(m.nd.array(w.astype(np.float32)))
            outs.append(net(m.nd.array(x)).asnumpy())
    for t, j in zip(outs[:2], outs[2:]):
        assert t.shape == (2, 12)
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(outs[0][:, 7:], x)
    assert tmx.gluon.contrib.rnn.LSTMPCell and \
        tmx.gluon.contrib.rnn.VariationalDropoutCell


def test_model_store_and_pretrained(tmp_path):
    store = tmx.gluon.model_zoo.model_store
    with pytest.raises(MXNetError, match="weight files"):
        store.get_model_file("alexnet", root=str(tmp_path))
    with pytest.raises(IOError):
        jmx.gluon.model_zoo.model_store.get_model_file(
            "alexnet", root=str(tmp_path))
    vision = tmx.gluon.model_zoo.vision
    net = vision.mobilenet0_25(classes=3)
    net.initialize(tmx.init.Xavier())
    x = tmx.nd.array(_x((1, 3, 32, 32), 7))
    want = net(x).asnumpy()
    net.save_params(str(tmp_path / "mobilenet0.25.params"))
    (tmp_path / "notes.txt").write_text("kept")
    path = store.get_model_file("mobilenet0.25", root=str(tmp_path))
    assert path == str(tmp_path / "mobilenet0.25.params")
    assert path == jmx.gluon.model_zoo.model_store.get_model_file(
        "mobilenet0.25", root=str(tmp_path))
    loaded = vision.mobilenet0_25(pretrained=True, root=str(tmp_path),
                                  ctx=tmx.cpu(), classes=3)
    np.testing.assert_array_equal(loaded(x).asnumpy(), want)
    with pytest.raises(MXNetError, match="weight files"):
        vision.get_model("resnet18_v1", pretrained=True, root=str(tmp_path))
    store.purge(root=str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["notes.txt"]
    store.purge(root=str(tmp_path / "absent"))


# -- test_utils -------------------------------------------------------------------

def test_test_utils_match_jax(monkeypatch):
    tu, ju = tmx.test_utils, jtu
    monkeypatch.setenv("MXTPU_TEST_CTX", "cpu")
    assert tu.default_context() == tmx.cpu() and ju.default_context() \
        == jmx.cpu()
    monkeypatch.delenv("MXTPU_TEST_CTX")
    assert tu.default_context() == tmx.cpu()      # the current context
    a = _x((3, 4), 8)
    tu.assert_almost_equal(a, a + 5e-5)
    ju.assert_almost_equal(a, a + 5e-5)
    for u in (tu, ju):
        with pytest.raises(AssertionError):
            u.assert_almost_equal(a, a + 1e-2)
        assert u.same(a, a.copy()) and not u.same(a, a + 1)
    tu.assert_almost_equal(tmx.nd.array(a), a, rtol=0, atol=0)
    np.random.seed(3)
    shape = tu.rand_shape_nd(3, 6)
    np.random.seed(3)
    assert shape == ju.rand_shape_nd(3, 6)
    np.random.seed(4)
    got = tu.rand_ndarray((4, 5), scale=2.0)
    np.random.seed(4)
    want = ju.rand_ndarray((4, 5), scale=2.0)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    for stype in ("row_sparse", "csr"):
        np.random.seed(4)
        got = tu.rand_ndarray((4, 5), stype=stype, density=0.5)
        np.random.seed(4)
        want = ju.rand_ndarray((4, 5), stype=stype, density=0.5)
        assert got.stype == want.stype == stype
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
        np.testing.assert_array_equal(got.indices.asnumpy(),
                                      want.indices.asnumpy())
    x = _x((2, 3), 9)
    np.testing.assert_array_equal(
        tu.simple_forward(tmx.nd.relu, x),
        ju.simple_forward(jmx.nd.relu, x))


@pytest.mark.parametrize("f", ["tanh", "square_sum"])
def test_numeric_gradient_matches_jax(f):
    """Central differences of the same function agree between the
    packages within f32 rounding, and both pass their tape check."""
    x = _x((2, 3), 10)
    fns = {"tanh": lambda m: (lambda a: m.nd.tanh(a) * 3),
           "square_sum": lambda m: (lambda a, b: (a * a + b).sum())}
    fn_t, fn_j = fns[f](tmx), fns[f](jmx)
    n = 1 if f == "tanh" else 2
    ins_t = [tmx.nd.array(x) for _ in range(n)]
    ins_j = [jmx.nd.array(x) for _ in range(n)]
    got = tmx.test_utils.numeric_grad(fn_t, ins_t)
    want = jtu.numeric_grad(fn_j, ins_j)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    tmx.test_utils.check_numeric_gradient(fn_t, ins_t)
    jtu.check_numeric_gradient(fn_j, ins_j)
    with pytest.raises(AssertionError, match="gradient mismatch"):
        tmx.test_utils.check_numeric_gradient(
            lambda a: tmx.nd.BlockGrad(a) * a, [tmx.nd.array(x)])


def test_check_consistency():
    """On this machine the CPU only: one output, its own reference; given
    contexts, each must agree with the first."""
    x = _x((3, 3), 11)
    outs = tmx.test_utils.check_consistency(lambda a: tmx.nd.exp(a), [x])
    assert len(outs) == 1
    np.testing.assert_allclose(outs[0], np.exp(x), rtol=1e-6)
    tmx.test_utils.check_consistency(lambda a: a * 2, [x],
                                     ctxs=[tmx.cpu(0), tmx.cpu(0)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jtu.check_consistency(lambda a: a * 2, [x])
