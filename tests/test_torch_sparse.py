"""Sparse storage in the port (``ndarray/sparse.py``, the sparse ops of the
registry, SGD's lazy update, the store's row-sparse path, ``LibSVMIter``,
``rand_ndarray``) against the JAX build, on the CPU.

Each case of ``tests/test_sparse.py`` has a twin here that feeds both
packages the same numpy arrays.  Structure (``indices``, ``indptr``) is
held exactly; casts, ``retain``, row-sparse sums and the plain lazy
update bit for bit; the momentum update within 1e-6 (relative and
absolute), as ``tests/test_torch_optimizer.py`` holds the dense one: XLA
contracts momentum·mom - lr·g into one fused multiply-add under jit.  A
product element lies within 2n·2^-24·Σ|terms| of its n terms of an exact
reference or of the JAX build's (each side rounds n products and n - 1
partial sums).  The card's tests (``-m cuda``) run phase 15's functions
of ``chip_smoke.py`` at small sizes: the ops on the card against the CPU,
BASELINE config 5's loop with its dense witness, records, bulking, and
ROADMAP C11.
"""
import gc

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import test_utils as jtu
from incubator_mxnet_tpu.ndarray import sparse as jsp
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ndarray import sparse as tsp

import chip_smoke as cs

U = 2.0 ** -24


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


@pytest.fixture(autouse=True, scope="module")
def _collect():
    """Free the JAX build's arrays these tests leave in reference cycles
    (its tape's closures) before the next file of this process runs:
    tests that count live device bytes must not see them go mid-test."""
    yield
    gc.collect()


def _np(a):
    return np.asarray(a.asnumpy())


def _same_structure(t, j):
    """The port's sparse array ``t`` holds the JAX build's ``j``'s
    components: indices (and indptr) exactly, data bit for bit."""
    assert t.stype == j.stype and tuple(t.shape) == tuple(j.shape)
    keys = ("indices", "data") + (("indptr",) if t.stype == "csr" else ())
    for k in keys:
        np.testing.assert_array_equal(_np(getattr(t, k)), _np(getattr(j, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(_np(t), _np(j))


def _sum_close(got, want, abs_terms, n_terms):
    """|got - want| <= 2n·u·Σ|terms| per element."""
    bound = 2.0 * n_terms * U * abs_terms
    assert np.all(np.abs(got.astype(np.float64) - want) <= bound), \
        np.abs(got - want).max()


def _matrix(seed, shape, density, zero_rows=()):
    rs = np.random.RandomState(seed)
    a = rs.standard_normal(shape).astype(np.float32)
    a *= rs.rand(*shape) < density
    a[list(zero_rows)] = 0
    return a


# -- the twins of tests/test_sparse.py ----------------------------------------

def test_rsp_roundtrip():
    a = np.array([[0, 0], [1, 2], [0, 0], [3, 4]], np.float32)
    t, j = tsp.row_sparse_array(a), jsp.row_sparse_array(a)
    assert t.stype == "row_sparse"
    _same_structure(t, j)
    np.testing.assert_array_equal(_np(t.tostype("default")), a)
    assert t.tostype("row_sparse") is t


def test_csr_roundtrip():
    a = np.array([[0, 2, 0], [1, 0, 3]], np.float32)
    t, j = tsp.csr_matrix(a), jsp.csr_matrix(a)
    assert t.stype == "csr"
    _same_structure(t, j)
    np.testing.assert_array_equal(_np(t.tostype("default")), a)


@pytest.mark.parametrize("src", ["default", "row_sparse", "csr"])
@pytest.mark.parametrize("to", ["default", "row_sparse", "csr"])
def test_cast_storage_via_ndarray(src, to):
    """Every cast between the three storage types (zero rows, stored zeros
    dropped) against the JAX build's ``tostype`` and ``nd.cast_storage``."""
    a = _matrix(0, (9, 7), 0.3, zero_rows=(0, 4))
    t, j = tmx.nd.array(a).tostype(src), jmx.nd.array(a).tostype(src)
    for got, want in ((t.tostype(to), j.tostype(to)),
                      (tmx.nd.cast_storage(t, to),
                       jmx.nd.cast_storage(j, to))):
        assert got.stype == to
        if to == "default":
            np.testing.assert_array_equal(_np(got), _np(want))
        else:
            _same_structure(got, want)
    one = tmx.nd.array(np.array([[1, 0], [0, 0]], np.float32))
    assert one.tostype("row_sparse").indices.shape == (1,)
    with pytest.raises(ValueError, match="2-D"):
        tmx.nd.ones((2, 3, 4)).tostype("csr")
    with pytest.raises(ValueError, match="unknown stype"):
        tmx.nd.ones((2, 3)).tostype("coo")


def test_retain():
    a = np.diag(np.arange(1.0, 5.0)).astype(np.float32)
    for ids in (np.array([0, 2], np.float32), np.array([3, 0, 3]),
                np.array([], np.int64)):
        got = tsp.retain(tsp.row_sparse_array(a), tmx.nd.array(ids))
        want = jsp.retain(jsp.row_sparse_array(a), jmx.nd.array(ids))
        _same_structure(got, want)
        _same_structure(tmx.nd.sparse_retain(tsp.row_sparse_array(a),
                                             tmx.nd.array(ids)), want)
    # the registered dense form (inside graphs): other rows zeroed, a
    # negative id from the end, one out of range dropped, floats truncated
    ids = np.array([1.7, -1, 9, 0], np.float32)
    np.testing.assert_array_equal(
        _np(tmx.nd.sparse_retain(tmx.nd.array(a), tmx.nd.array(ids))),
        _np(jmx.nd.sparse_retain(jmx.nd.array(a), jmx.nd.array(ids))))
    np.testing.assert_array_equal(
        _np(tmx.nd._sparse_retain_dense(tmx.nd.array(a), tmx.nd.array(ids))),
        _np(jmx.nd._sparse_retain_dense(jmx.nd.array(a), jmx.nd.array(ids))))
    np.testing.assert_array_equal(
        _np(tmx.nd._cast_storage_dense(tmx.nd.array(a), stype="csr")), a)
    with pytest.raises(TypeError, match="RowSparseNDArray"):
        tsp.retain(tmx.nd.array(a), [0])


@pytest.mark.parametrize("transpose_a", [False, True])
@pytest.mark.parametrize("transpose_b", [False, True])
def test_csr_dot(transpose_a, transpose_b):
    """CSR·dense and CSRᵀ·dense (and with the dense operand transposed)
    against the JAX build, and the gradient of the dense operand under
    ``record()`` against jax's, each element within the bound of its
    terms."""
    rs = np.random.RandomState(0)
    A = _matrix(1, (5, 7), 0.4)
    inner, outer = (5, 7) if transpose_a else (7, 5)
    B = rs.standard_normal((3, inner) if transpose_b else
                           (inner, 3)).astype(np.float32)
    head = rs.standard_normal((outer, 3)).astype(np.float32)
    got = {}
    for m, sp in ((tmx, tsp), (jmx, jsp)):
        x = sp.csr_matrix(A)
        w = m.nd.array(B)
        w.attach_grad()
        with m.autograd.record():
            out = sp.dot(x, w, transpose_a=transpose_a,
                         transpose_b=transpose_b)
        out.backward(m.nd.array(head))
        got[m] = (_np(out), _np(w.grad))
    a, b = (A.T if transpose_a else A), (B.T if transpose_b else B)
    ref = a.astype(np.float64) @ b
    abs_terms = np.abs(a).astype(np.float64) @ np.abs(b)
    n = (a != 0).sum(1, keepdims=True) * np.ones((1, 3))
    for m in got:
        _sum_close(got[m][0], ref, abs_terms, n)
    _sum_close(got[tmx][0], got[jmx][0], 2 * abs_terms, n)
    gref = (a.T.astype(np.float64) @ head)
    gref = gref.T if transpose_b else gref
    np.testing.assert_allclose(got[tmx][1], gref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[tmx][1], got[jmx][1], rtol=1e-5,
                               atol=1e-6)


def test_rsp_add():
    r1 = np.array([[1, 1], [0, 0], [2, 2]], np.float32)
    r2 = np.array([[0, 0], [3, 3], [4, 4]], np.float32)
    got = tsp.elemwise_add(tsp.row_sparse_array(r1), tsp.row_sparse_array(r2))
    want = jsp.elemwise_add(jsp.row_sparse_array(r1),
                            jsp.row_sparse_array(r2))
    _same_structure(got, want)
    parts = [_matrix(s, (30, 4), 0.2) for s in range(4)]
    got = tsp.add_n(*[tsp.row_sparse_array(p) for p in parts])
    want = jsp.add_n(*[jsp.row_sparse_array(p) for p in parts])
    _same_structure(got, want)
    # a dense operand adds densely
    np.testing.assert_array_equal(
        _np(tsp.elemwise_add(tsp.row_sparse_array(r1), tmx.nd.array(r2))),
        r1 + r2)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("wd,clip", [(0.0, None), (1e-2, 0.3)])
@pytest.mark.parametrize("lazy", [True, False])
def test_sparse_sgd_lazy_update(momentum, wd, clip, lazy):
    """SGD on a row-sparse gradient, three updates through the Updater:
    lazily only its rows (momentum too), or densely with
    ``lazy_update=False``; weights bit-equal to the JAX build's without
    momentum, within 1e-6 with it (XLA's FMA), momentum likewise."""
    rs = np.random.RandomState(3)
    w0 = rs.standard_normal((12, 3)).astype(np.float32)
    grads = [_matrix(10 + i, (12, 3), 1.0, zero_rows=range(i, 12, 2))
             for i in range(3)]
    out = {}
    for m, sp in ((tmx, tsp), (jmx, jsp)):
        opt = m.optimizer.SGD(learning_rate=0.5, momentum=momentum, wd=wd,
                              clip_gradient=clip, rescale_grad=0.25,
                              lazy_update=lazy)
        upd = m.optimizer.get_updater(opt)
        w = m.nd.array(w0)
        for g in grads:
            upd(0, sp.row_sparse_array(g), w)
        state = upd.states[0]
        out[m] = (_np(w), None if state is None else _np(state))
    if momentum:
        np.testing.assert_allclose(out[tmx][0], out[jmx][0], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(out[tmx][1], out[jmx][1], rtol=1e-6,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(out[tmx][0], out[jmx][0])
    if lazy:
        never = [i for i in range(12) if all(g[i].sum() == 0 for g in grads)]
        np.testing.assert_array_equal(out[tmx][0][never], w0[never])


def test_kvstore_sparse_push_pull():
    out = {}
    for m, sp in ((tmx, tsp), (jmx, jsp)):
        kv = m.kv.create("local")
        kv.init("w", m.nd.zeros((4, 2)))
        g1 = sp.row_sparse_array((np.array([[1.0, 1.0]], np.float32),
                                  np.array([1])), shape=(4, 2))
        g2 = sp.row_sparse_array((np.array([[2.0, 2.0]], np.float32),
                                  np.array([3])), shape=(4, 2))
        kv.push("w", [g1, g2])
        dense = m.nd.zeros((4, 2))
        kv.pull("w", out=dense)
        rows = m.nd.zeros((4, 2))
        kv.row_sparse_pull("w", out=rows, row_ids=m.nd.array(
            np.array([3], np.float32)))
        rsp = m.nd.zeros((4, 2)).tostype("row_sparse")
        kv.row_sparse_pull("w", out=rsp, row_ids=m.nd.array(
            np.array([3, 1, 3], np.float32)))
        out[m] = (_np(dense), _np(rows), rsp)
    np.testing.assert_array_equal(out[tmx][0], out[jmx][0])
    np.testing.assert_array_equal(out[tmx][1], out[jmx][1])
    assert out[tmx][1][1].sum() == 0 and out[tmx][1][3].tolist() == [2, 2]
    _same_structure(out[tmx][2], out[jmx][2])
    assert _np(out[tmx][2].indices).tolist() == [1, 3]


def test_row_sparse_weight_through_the_store():
    """The example's start: ``nd.zeros((dim, 1)).tostype('row_sparse')``
    has zero rows, initializes a store key, takes a first
    ``row_sparse_pull``, and the store's sgd updates only the pushed
    rows; a sparse out of ``pull`` raises, as writes into sparse arrays
    do."""
    out = {}
    for m in (tmx, jmx):
        w = m.nd.zeros((6, 1)).tostype("row_sparse")
        assert w.indices.shape == (0,) and w.data.shape == (0, 1)
        kv = m.kv.create("local")
        kv.init("w", w)
        kv.set_optimizer(m.optimizer.create("sgd", learning_rate=0.5))
        kv.row_sparse_pull("w", out=w, row_ids=m.nd.array([4, 2]))
        g = m.nd.array(np.array([[0], [0], [1], [0], [-2], [0]],
                                np.float32)).tostype("row_sparse")
        kv.push("w", g)
        kv.row_sparse_pull("w", out=w, row_ids=m.nd.array([2, 4, 5]))
        out[m] = w
        with pytest.raises(TypeError, match="sparse"):
            kv.pull("w", out=w)
    _same_structure(out[tmx], out[jmx])
    assert _np(out[tmx]).reshape(-1).tolist() == [0, 0, -0.5, 0, 1.0, 0]


@pytest.fixture
def small_libsvm(tmp_path):
    """The example's synthetic data (linear_classification.py:41-52) at
    dim 300, written by chip_smoke's generator."""
    cfg = dict(cs.SPARSE, dim=300, batch=100, rows=2000, nnz=12, seed=7)
    path = str(tmp_path / "train.libsvm")
    ids, labels, w0 = cs.sparse_data(cfg, path)
    return cfg, path, ids, labels, np.zeros_like(w0)


def test_sparse_linear_classification_end_to_end(small_libsvm):
    """BASELINE config 5 at the example's test size (dim 300, batch 100,
    as tests/test_examples.py:74-81), through chip_smoke's copy of the
    example's loop on both packages: the port reaches accuracy > 0.8 in 6
    epochs, its losses follow the JAX build's (1e-5), and its final
    weights equal the JAX build's to 1e-5 of their largest."""
    cfg, path, _, _, w0 = small_libsvm
    got = cs.sparse_linear_fit(tmx, path, cfg["dim"], cfg["batch"], 6, 0.5,
                               w0, tmx.cpu())
    assert got["acc"][-1] > 0.8, got["acc"]
    assert got["loss"][-1] < got["loss"][0]
    want = cs.sparse_linear_fit(jmx, path, cfg["dim"], cfg["batch"], 2, 0.5,
                                w0, jmx.cpu())
    np.testing.assert_allclose(got["loss"][:2], want["loss"], rtol=1e-5)
    two = cs.sparse_linear_fit(tmx, path, cfg["dim"], cfg["batch"], 2, 0.5,
                               w0, tmx.cpu())
    scale = np.abs(want["w"]).max()
    np.testing.assert_allclose(two["w"], want["w"], rtol=0, atol=1e-5 * scale)
    assert two["rows"] == want["rows"]


def test_plain_dense_step_witnesses_the_port(small_libsvm):
    """15b's witness on the CPU: each step of the port's loop within
    ``sparse_plain_step``'s bound of a plain dense step from the same
    weights (on the CPU both sum in the same order: bit-equal), and rows
    no batch touched untouched."""
    cfg, path, ids, labels, _ = small_libsvm
    rs = np.random.RandomState(1)
    w0 = (rs.standard_normal((cfg["dim"], 1)) * 0.01).astype(np.float32)
    model = cs.SparseLinear(tmx, cfg["dim"], 0.5, w0, tmx.cpu())
    it = tmx.io.LibSVMIter(data_libsvm=path, data_shape=(cfg["dim"],),
                           batch_size=cfg["batch"])
    for i, bt in enumerate(it):
        wb, bb = (torch.as_tensor(a.reshape(-1)) for a in model.weights())
        model.step(bt)
        wa, ba = (torch.as_tensor(a.reshape(-1)) for a in model.weights())
        rows = slice(i * cfg["batch"], (i + 1) * cfg["batch"])
        pw, pb, ew, eb = cs.sparse_plain_step(torch, ids[rows], labels[rows],
                                              wb, bb, 0.5)
        assert torch.equal(wa, pw) and torch.equal(ba, pb)
        assert bool((ew >= 0).all()) and eb >= 0
        untouched = np.setdiff1d(np.arange(cfg["dim"]), ids[rows])
        assert torch.equal(wa[untouched], wb[untouched])


def test_libsvm_iter(tmp_path):
    """LibSVMIter's batches (CSR triples, labels, pad, the wrapped tail)
    equal the JAX build's, with repeated and unsorted ids and an empty
    row; provide_data and provide_label too."""
    fn = str(tmp_path / "data.libsvm")
    with open(fn, "w") as f:
        f.write("1 0:1.5 3:2.0\n0 1:1.0\n\n1 3:3.0 2:1.0 3:0.5\n"
                "0 0:0.5\n-1\n2 1:1e-3 0:7\n")
    tit = tmx.io.LibSVMIter(data_libsvm=fn, data_shape=(4,), batch_size=4)
    jit = jmx.io.LibSVMIter(data_libsvm=fn, data_shape=(4,), batch_size=4)
    assert tit.provide_data[0][:2] == jit.provide_data[0][:2] == (
        "data", (4, 4))
    assert tit.provide_label[0][:2] == jit.provide_label[0][:2]
    for _ in range(2):
        tb, jb = list(tit), list(jit)
        assert len(tb) == len(jb) == 2
        for t, j in zip(tb, jb):
            _same_structure(t.data[0], j.data[0])
            np.testing.assert_array_equal(_np(t.label[0]), _np(j.label[0]))
            assert t.pad == j.pad
        tit.reset()
        jit.reset()
    assert tb[1].pad == 2


def test_sparse_zeros():
    for stype, shape in (("row_sparse", (3, 2)), ("csr", (3, 2)),
                         ("row_sparse", (4, 2, 3))):
        t = tmx.nd.zeros(shape, stype=stype)
        j = jmx.nd.zeros(shape, stype=stype)
        _same_structure(t, j)
        assert _np(t).sum() == 0 and t.dtype == np.float32
    with pytest.raises(ValueError, match="unknown stype"):
        tsp.zeros("coo", (2, 2))


def test_dense_sparse_dot_transpose_a():
    """dense · CSR with transpose_a and transpose_b, and the row-sparse
    products (rsp · dense; a transposed rsp or a rsp right operand
    densify), against the JAX build."""
    rs = np.random.RandomState(3)
    B = _matrix(4, (4, 6), 0.5)
    R = _matrix(5, (6, 4), 0.5, zero_rows=(1, 3))
    cases = ((rs.standard_normal((4, 5)), "csr", dict(transpose_a=True)),
             (rs.standard_normal((3, 4)), "csr", {}),
             (rs.standard_normal((3, 6)), "csr", dict(transpose_b=True)))
    for lhs, stype, kw in cases:
        lhs = lhs.astype(np.float32)
        got = tsp.dot(tmx.nd.array(lhs), tmx.nd.array(B).tostype(stype),
                      **kw)
        want = jsp.dot(jmx.nd.array(lhs), jmx.nd.array(B).tostype(stype),
                       **kw)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)
    D = rs.standard_normal((4, 3)).astype(np.float32)
    E = rs.standard_normal((6, 3)).astype(np.float32)
    for lhs, rhs, kw in (
            (tsp.row_sparse_array(R), D, {}),
            (tsp.row_sparse_array(R), E, dict(transpose_a=True)),
            (tsp.row_sparse_array(R), D.T, dict(transpose_b=True))):
        jl = jsp.row_sparse_array(R)
        got = tsp.dot(lhs, tmx.nd.array(rhs), **kw)
        want = jsp.dot(jl, jmx.nd.array(rhs), **kw)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)
    got = tsp.dot(tmx.nd.array(D.T), tsp.row_sparse_array(B))
    want = jsp.dot(jmx.nd.array(D.T), jsp.row_sparse_array(B))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)
    got = tsp.dot(tmx.nd.array(E.T), tmx.nd.array(R))
    np.testing.assert_allclose(_np(got), E.T @ R, rtol=1e-5, atol=1e-6)


def test_csr_row_slicing():
    dense = _matrix(0, (7, 5), 0.4)
    t, j = tmx.nd.array(dense).tostype("csr"), jmx.nd.array(dense).tostype(
        "csr")
    for key in (slice(2, 6), slice(0, 7), 3, -1, slice(3, 1), slice(None)):
        _same_structure(t[key], j[key])
        want = dense[key if isinstance(key, slice) else
                     slice(key % 7, key % 7 + 1)]
        np.testing.assert_array_equal(_np(t[key]), want)
    with pytest.raises(IndexError):
        t[7]
    with pytest.raises(ValueError, match="contiguous"):
        t[::2]


def test_csr_reduce_densify_guard(monkeypatch):
    """The CSR sum of the store: below ``MXTPU_CSR_DENSIFY_BOUND`` dense,
    above it band by band of rows with a warning, both equal to the JAX
    build's cross-worker reduce of the same matrix (one process: the
    reduce is the compression of its dense form); a push of two CSR
    values sums them."""
    from incubator_mxnet_tpu import kvstore as jkvs
    from incubator_mxnet_tpu_torch.kvstore import KVStore
    jkv = jkvs.create("dist_sync")
    dense = _matrix(7, (64, 48), 0.15)
    monkeypatch.setenv("MXTPU_CSR_DENSIFY_BOUND", str(1 << 30))
    want = jkv._cross_worker_reduce_sparse(jmx.nd.array(dense).tostype(
        "csr"))
    got = KVStore._sum_csr([tmx.nd.array(dense).tostype("csr")])
    _same_structure(got, want)
    monkeypatch.setenv("MXTPU_CSR_DENSIFY_BOUND", str(10 * 48 * 4))
    with pytest.warns(UserWarning, match="MXTPU_CSR_DENSIFY_BOUND"):
        banded = KVStore._sum_csr([tmx.nd.array(dense).tostype("csr")])
    _same_structure(banded, want)
    other = _matrix(8, (64, 48), 0.15)
    kv = tmx.kv.create("local")
    kv.init("x", tmx.nd.zeros((64, 48)))
    with pytest.warns(UserWarning, match="MXTPU_CSR_DENSIFY_BOUND"):
        kv.push("x", [tmx.nd.array(dense).tostype("csr"),
                      tmx.nd.array(other).tostype("csr")])
    out = tmx.nd.zeros((64, 48))
    kv.pull("x", out=out)
    np.testing.assert_array_equal(_np(out), dense + other)


# -- beyond tests/test_sparse.py ------------------------------------------------

def test_repeated_and_unsorted_indices_follow_jax():
    """Ids given by the caller are kept as given; a repeated row (or
    (row, column)) keeps its last value wherever it is scattered, as the
    JAX build's scatter on the CPU does: densifying, casting, the lazy
    update; a sum adds the repeats."""
    data = np.array([[1.0, 1.0], [2.0, 2.0], [5.0, 6.0]], np.float32)
    for idx in ([1, 1, 0], [2, 0, 2], [2, 0, 1]):
        idx = np.array(idx)
        t = tsp.row_sparse_array((data, idx), shape=(3, 2))
        j = jsp.row_sparse_array((data, idx), shape=(3, 2))
        np.testing.assert_array_equal(_np(t.indices), idx)
        np.testing.assert_array_equal(_np(t), _np(j))
        _same_structure(t.tostype("row_sparse"), j.tostype("row_sparse"))
        _same_structure(t.tostype("csr"), j.tostype("csr"))
        _same_structure(tsp.add_n(t, t), jsp.add_n(j, j))
        _same_structure(tsp.retain(t, [2, 1]), jsp.retain(j, [2, 1]))
        ws = []
        for m, g in ((tmx, t), (jmx, j)):
            w = m.nd.ones((3, 2))
            m.optimizer.get_updater(m.optimizer.SGD(learning_rate=0.5))(
                0, g, w)
            ws.append(_np(w))
        np.testing.assert_array_equal(*ws)
    t = tsp.csr_matrix((np.array([1.0, 2.0, 3.0], np.float32),
                        np.array([2, 2, 0]), np.array([0, 2, 3])),
                       shape=(2, 3))
    j = jsp.csr_matrix((np.array([1.0, 2.0, 3.0], np.float32),
                        np.array([2, 2, 0]), np.array([0, 2, 3])),
                       shape=(2, 3))
    assert t.canonical is False
    np.testing.assert_array_equal(_np(t), _np(j))
    w = np.arange(6, dtype=np.float32).reshape(3, 2)
    np.testing.assert_array_equal(_np(tsp.dot(t, tmx.nd.array(w))),
                                  _np(jsp.dot(j, jmx.nd.array(w))))


def test_ids_out_of_range_raise(tmp_path):
    """An id outside the shape raises IndexError where it enters (a tuple's
    indices, a LibSVM file's feature id, row_sparse_pull's row ids), never
    reaching a gather or scatter (on the card a device assertion)."""
    with pytest.raises(IndexError, match="row id out of range"):
        tsp.row_sparse_array((np.ones((1, 2), np.float32), [3]), shape=(3, 2))
    with pytest.raises(IndexError, match="row id out of range"):
        tsp.row_sparse_array((tmx.nd.ones((1, 2)), tmx.nd.array([-1])),
                             shape=(3, 2))
    with pytest.raises(IndexError, match="column id out of range"):
        tsp.csr_matrix((np.ones(1, np.float32), [5], [0, 1]), shape=(1, 5))
    fn = str(tmp_path / "wide.libsvm")
    with open(fn, "w") as f:
        f.write("1 0:1 7:1\n")
    with pytest.raises(IndexError, match="column id out of range"):
        tmx.io.LibSVMIter(data_libsvm=fn, data_shape=(4,)).next()
    kv = tmx.kv.create("local")
    kv.init("w", tmx.nd.ones((4, 2)))
    with pytest.raises(IndexError, match="row id out of range"):
        kv.row_sparse_pull("w", out=tmx.nd.zeros((4, 2)),
                           row_ids=tmx.nd.array([1, 4]))


def test_sparse_arrays_take_no_gradient_and_no_writes():
    """A sparse array takes no gradient (attach_grad raises; products
    differentiate their dense operand only) and no in-place write
    (``out=``, ``[:] =``, ``+=``, ``copyto``), as in the JAX build, which
    raises TypeError on a write; ops on one densify."""
    r = tsp.row_sparse_array(np.eye(3, dtype=np.float32))
    c = tmx.nd.array(np.eye(3, dtype=np.float32)).tostype("csr")
    for a in (r, c):
        with pytest.raises(MXNetError, match="no gradient"):
            a.attach_grad()
        with pytest.raises(TypeError, match="sparse"):
            tmx.nd.ones((3, 3)).copyto(a)
        with pytest.raises(TypeError, match="sparse"):
            a[:] = 1
        with pytest.raises(TypeError, match="sparse"):
            a += 1
        with pytest.raises(TypeError, match="sparse"):
            tmx.nd.relu(tmx.nd.ones((3, 3)), out=a)
        np.testing.assert_array_equal(_np(a * 2), 2 * np.eye(3))
        np.testing.assert_array_equal(_np(a.copy()), np.eye(3))
        dense = tmx.nd.zeros((3, 3))
        a.copyto(dense)
        np.testing.assert_array_equal(_np(dense), np.eye(3))
        assert a.shape == (3, 3) and a.size == 9 and a.ndim == 2


def test_rand_ndarray_sparse_matches_jax():
    """``rand_ndarray`` of each stype draws what the JAX build's draws
    from the same numpy seed, at the density asked."""
    for stype in ("row_sparse", "csr"):
        np.random.seed(5)
        got = tmx.test_utils.rand_ndarray((40, 30), stype, density=0.1)
        np.random.seed(5)
        want = jtu.rand_ndarray((40, 30), stype, density=0.1)
        _same_structure(got, want)
        share = np.count_nonzero(_np(got)) / 1200.0
        assert abs(share - 0.1) < 5 * np.sqrt(0.09 / 1200)
    with pytest.raises(ValueError):
        tmx.test_utils.rand_ndarray((2, 2), "coo")


def test_sparse_arrays_move_between_contexts():
    r = tsp.row_sparse_array(_matrix(2, (5, 3), 0.5))
    c = tmx.nd.array(_matrix(3, (5, 3), 0.5)).tostype("csr")
    for a in (r, c):
        b = a.as_in_context(tmx.cpu(0))
        assert b is a
        moved = a.copyto(tmx.cpu(1))
        assert moved.stype == a.stype and moved.context == tmx.cpu(1)
        np.testing.assert_array_equal(_np(moved), _np(a))
        a.wait_to_read()


def test_bulk_flushes_before_a_sparse_cast():
    """A cast reads a deferred array's values on the host (its rows depend
    on them): inside ``mx.engine.bulk`` the segment flushes first (cause
    ``read``), and the result equals eager."""
    a = _matrix(9, (6, 4), 0.4, zero_rows=(2,))
    want = tmx.nd.array(a * 2).tostype("row_sparse")
    tmx.engine.reset_flush_stats()
    with tmx.engine.bulk(16):
        x = tmx.nd.array(a) * 2
        got = x.tostype("row_sparse")
        assert tmx.engine.flush_stats()["causes"]["read"] == 1
    _same_structure(got, jsp.row_sparse_array(a * 2))
    _same_structure(got, want)


def test_parameter_keeps_its_storage_types():
    """``Parameter(stype=, grad_stype=)`` is accepted and kept, its data
    and gradient dense, and a Trainer steps it through the plain path."""
    for m in (tmx, jmx):
        p = m.gluon.Parameter("w", shape=(4, 2), stype="row_sparse",
                              grad_stype="row_sparse")
        assert (p._stype, p._grad_stype) == ("row_sparse", "row_sparse")
    p = tmx.gluon.Parameter("w", shape=(4, 2), grad_stype="row_sparse",
                            init=tmx.init.One())
    p.initialize(ctx=tmx.cpu())
    tr = tmx.gluon.Trainer([p], "sgd", {"learning_rate": 0.5},
                           kvstore=tmx.kv.create("local"))
    with tmx.autograd.record():
        y = (p.data() * tmx.nd.array(np.arange(8.0).reshape(4, 2))).sum()
    y.backward()
    tr.step(1)
    np.testing.assert_array_equal(_np(p.data()), 1 - 0.5 * np.arange(
        8.0).reshape(4, 2))


def test_parameters_load_from_sparse_records(tmp_path):
    """A ``.params`` file holding a row-sparse record loads into a dense
    parameter (densified), as the JAX build's load does."""
    path = str(tmp_path / "p.params")
    a = _matrix(4, (5, 3), 0.5, zero_rows=(1,))
    tmx.nd.save(path, {"w": tsp.row_sparse_array(a)})
    p = tmx.gluon.ParameterDict()
    p.get("w", shape=(5, 3))
    p.load(path, ctx=tmx.cpu())
    np.testing.assert_array_equal(_np(p["w"].data()), a)


# -- the card ------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return cs.card_line()


@pytest.mark.cuda
def test_card_sparse_ops_match_cpu(card):
    """Phase 15a at a small size: casts, retain, products and their
    backward, add_n and the lazy updates on the card against the CPU."""
    with tmx.gpu(0):
        res = cs.sparse_card_ops(tmx, card, dim=50000, batch=512, reps=2)
    assert res["ok"], res["failures"]


@pytest.mark.cuda
def test_card_linear_classification_and_witness(card):
    """Phase 15b at a small size: the loss falls, every step within the
    dense witness's bound, the run repeats bit for bit."""
    cfg = dict(cs.SPARSE, dim=100000, batch=1024, rows=8192)
    with tmx.gpu(0):
        res = cs.sparse_train(tmx, card, cfg)
    assert res["witness"]["ok"]


@pytest.mark.cuda
def test_card_records_bulk_and_c11(card):
    """Phases 15c-15e at a small size: sparse records through the card,
    the lazy update inside mx.engine.bulk bit-equal to eager, and C11 (a
    failed capture in a block with Dropout, then draws equal to eager)."""
    with tmx.gpu(0):
        assert all(cs.sparse_records(tmx, card, dim=20000,
                                     batch=256)["bit_equal"].values())
        assert cs.sparse_bulk(tmx, card, dim=20000, rows=500)["bit_equal"]
        res = cs.c11_contract(tmx, card, shape=(16, 32))
    assert all(r["draw_equal_to_eager"] for r in res.values()), res
