"""The port's engine bulking (``mx.engine.bulk``) on the CPU: the contracts
of the JAX build's ``tests/test_engine_bulk.py`` one for one, held bit for
bit against the port's own unbulked run; ``bench_eager.py``'s three chains
through both packages (flush causes and segment lengths equal, values
within 1e-6 relative in f32); and the port's own contracts (outputs of one
flush survive the next, recomputing backward, in-place writes after a
forward, ``offband``, ``NaiveEngine``, ops that cannot be deferred, the
inference cache).  The card's tests call ``chip_smoke``'s phase 11 at
small sizes."""
import contextlib
import gc
import threading

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import autograd, engine, nd
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ops import registry

REL = 1e-6
CHAIN = 64
SHAPE = (64, 64)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _chain(a, b, c, n=16):
    for _ in range(n // 4):
        a = a * b
        a = a + c
        a = a.abs()
        a = a - c
    return a


def _scope(bulked, size=64):
    return engine.bulk(size) if bulked else contextlib.nullcontext()


def test_bulk_matches_eager():
    rs = np.random.RandomState(0)
    a = nd.array(rs.rand(8, 8))
    b = nd.array(rs.rand(8, 8) + 0.5)
    c = nd.array(rs.rand(8, 8))
    want = _chain(a, b, c).asnumpy()
    with engine.bulk(64):
        got = _chain(a, b, c)
        assert type(got._slot) is engine._Pending
        assert got.shape == (8, 8) and got.dtype == np.float32
        got_np = got.asnumpy()          # flushes transparently
    np.testing.assert_array_equal(got_np, want)


def test_bulk_segment_overflow_flushes():
    rs = np.random.RandomState(1)
    a = nd.array(rs.rand(4, 4))
    b = nd.array(rs.rand(4, 4) + 0.5)
    c = nd.array(rs.rand(4, 4))
    want = _chain(a, b, c, n=32).asnumpy()
    engine.reset_flush_stats()
    with engine.bulk(5):
        got = _chain(a, b, c, n=32).asnumpy()
    np.testing.assert_array_equal(got, want)
    stats = engine.flush_stats()
    assert stats["causes"]["size-cap"] == 5, stats
    assert max(stats["segment_lengths"]) == 5, stats


def test_bulk_replay_cache_hits():
    rs = np.random.RandomState(2)
    a = nd.array(rs.rand(4, 4))
    b = nd.array(rs.rand(4, 4) + 0.5)
    c = nd.array(rs.rand(4, 4))
    before = len(engine._replay_cache)
    for _ in range(4):
        with engine.bulk(64):
            _chain(a, b, c).asnumpy()
    assert len(engine._replay_cache) - before == 1


def test_bulk_random_ops_consume_keys():
    """Draws defer too: two scopes draw different samples, bit-equal to
    two eager draws from the same seed."""
    tmx.random.seed(0)
    with engine.bulk(16):
        x1 = nd.random.uniform(shape=(16,)).asnumpy()
    with engine.bulk(16):
        x2 = nd.random.uniform(shape=(16,)).asnumpy()
    assert not np.array_equal(x1, x2)
    tmx.random.seed(0)
    e1 = nd.random.uniform(shape=(16,)).asnumpy()
    e2 = nd.random.uniform(shape=(16,)).asnumpy()
    np.testing.assert_array_equal(x1, e1)
    np.testing.assert_array_equal(x2, e2)


def test_bulk_autograd_runs_eagerly():
    rs = np.random.RandomState(3)
    a = nd.array(rs.rand(4, 4))
    a.attach_grad()
    with engine.bulk(64):
        with autograd.record():
            y = (a * a).sum()
        y.backward()
    np.testing.assert_allclose(a.grad.asnumpy(), 2 * a.asnumpy(), rtol=1e-6)


def test_bulk_inplace_write_resolves():
    a = nd.array(np.ones((4, 4), np.float32))
    with engine.bulk(64):
        y = a * 2.0
        y[:] = 7.0
        out = (y + 1).asnumpy()
    np.testing.assert_array_equal(out, 8.0)


def test_bulk_mixed_with_views():
    a = nd.array(np.arange(16, dtype=np.float32).reshape(4, 4))
    engine.reset_flush_stats()
    with engine.bulk(64):
        y = a * 2
        v = y[1]                   # a view of a deferred value defers
        assert type(v._slot) is engine._Pending
        got = v.asnumpy()
    np.testing.assert_array_equal(got, np.arange(4, 8, dtype=np.float32) * 2)
    assert engine.flush_stats()["causes"]["view"] == 0


def _view_chain(a, b, n=32):
    x = a
    for _ in range(n // 4):
        x = x * b
        x = x.reshape((4, 16))
        x = x.abs()
        x = x.reshape((8, 8))
        x = x - 0.25
        x = x / b
    return x


def test_bulk_view_chain_flushes_once():
    rs = np.random.RandomState(7)
    a = nd.array(rs.rand(8, 8).astype(np.float32))
    b = nd.array(rs.rand(8, 8).astype(np.float32) + 0.5)
    want = _view_chain(a, b).asnumpy()
    engine.reset_flush_stats()
    with engine.bulk(128):
        got = _view_chain(a, b)
    g = got.asnumpy()
    stats = engine.flush_stats()
    assert stats["causes"]["scope-close"] == 1, stats
    assert sum(stats["causes"].values()) == 1, stats
    assert list(stats["segment_lengths"].values()) == [1], stats
    np.testing.assert_array_equal(g, want)


def test_bulk_slice_transpose_mid_chain_parity():
    av = np.random.RandomState(11).rand(6, 8).astype(np.float32)

    def run(bulked):
        a = nd.array(av)
        with _scope(bulked):
            x = a * 2.0
            x = x.transpose((1, 0))
            x = x[2:6]
            x = x.reshape((2, 12))
            x = x + 0.5
            x = x.reshape((24,))
            return (x * x).asnumpy()

    want = run(False)
    engine.reset_flush_stats()
    got = run(True)
    np.testing.assert_array_equal(got, want)
    assert sum(engine.flush_stats()["causes"].values()) == 1


def test_bulk_write_through_deferred_view():
    def run(bulked):
        y0 = nd.array(np.arange(16, dtype=np.float32).reshape(4, 4))
        with _scope(bulked):
            y = y0 * 2.0
            v = y[1:3]
            v[:] = 7.0
            w = y.reshape((2, 8))
            w += 1.0
            z = y + 0.0
        return y.asnumpy(), z.asnumpy(), w.asnumpy(), v.asnumpy()

    eager = run(False)
    engine.reset_flush_stats()
    bulked = run(True)
    stats = engine.flush_stats()
    for e, b in zip(eager, bulked):
        np.testing.assert_array_equal(e, b)
    assert stats["causes"]["scope-close"] == 1, stats
    assert sum(stats["causes"].values()) == 1, stats


def test_bulk_recorded_view_segment_backward_parity():
    """Bit-equal to the port's own unbulked run (the JAX build's bulked
    run of this test is not the reference)."""
    rs = np.random.RandomState(0)
    xv = rs.randn(4, 6).astype(np.float32)
    wv = rs.randn(6, 8).astype(np.float32)

    def step(bulked):
        x, w = nd.array(xv), nd.array(wv)
        x.attach_grad()
        w.attach_grad()
        with _scope(bulked):
            with autograd.record():
                h = nd.dot(x, w)
                h = h.reshape((8, 4))
                h = h.transpose((1, 0))
                h = h[1:3]
                loss = (h * h).sum()
            loss.backward()
        return (loss.asnumpy(), x.grad.asnumpy().copy(),
                w.grad.asnumpy().copy())

    l0, gx0, gw0 = step(False)
    engine.reset_flush_stats()
    l1, gx1, gw1 = step(True)
    stats = engine.flush_stats()
    np.testing.assert_array_equal(l0, l1)
    np.testing.assert_array_equal(gx0, gx1)
    np.testing.assert_array_equal(gw0, gw1)
    assert stats["causes"]["autograd"] == 1, stats
    assert sum(stats["causes"].values()) == 1, stats


def test_bulk_view_of_cross_scope_value_materializes():
    a = nd.array(np.arange(8, dtype=np.float32))
    engine.reset_flush_stats()
    with engine.bulk(4):
        y = a * 2.0
        with engine.bulk(4):
            v = y.reshape((2, 4))
            z = v + 1.0
            got = z.asnumpy()
    np.testing.assert_array_equal(got, np.arange(8).reshape(2, 4) * 2.0 + 1)
    assert engine.flush_stats()["causes"]["view"] == 1


def test_bulk_waitall_covers_replay():
    a = nd.array(np.ones((8, 8), np.float32))
    engine.reset_flush_stats()
    with engine.bulk(16):
        out = a * 3 + 1
        nd.waitall()                  # flushes the open segment
        assert type(out._slot) is engine._Pending
        assert out._slot.value is not None
        assert engine.flush_stats()["causes"]["read"] == 1
    np.testing.assert_array_equal(out.asnumpy(), 4.0)


def test_bulk_ext_dedup():
    a = nd.array(np.ones((4, 4), np.float32))
    b = nd.array(np.ones((4, 4), np.float32) * 2)
    with engine.bulk(32):
        y = a * b
        z = y + b
        w = z * b
        assert len(engine._current().ext) == 2
        got = w.asnumpy()
    np.testing.assert_array_equal(got, (1 * 2 + 2) * 2)


def test_bulk_defers_recorded_ops_gradients_identical():
    rs = np.random.RandomState(0)
    xv = rs.randn(4, 6).astype(np.float32)
    wv = rs.randn(6, 3).astype(np.float32)

    def train_step(bulked):
        x, w = nd.array(xv), nd.array(wv)
        x.attach_grad()
        w.attach_grad()
        with _scope(bulked):
            with autograd.record():
                h = nd.dot(x, w)
                h = nd.relu(h)
                h = h * 2.0 + 1.0
                loss = nd.sum(h * h)
                if bulked:
                    assert type(loss._slot) is engine._Pending
            loss.backward()
        return loss.asnumpy(), x.grad.asnumpy().copy(), w.grad.asnumpy()

    l0, gx0, gw0 = train_step(False)
    l1, gx1, gw1 = train_step(True)
    np.testing.assert_array_equal(l0, l1)
    np.testing.assert_array_equal(gx0, gx1)
    np.testing.assert_array_equal(gw0, gw1)


def test_bulk_pause_inside_record_stops_gradient():
    x = nd.array(np.ones((3,), np.float32) * 2.0)
    x.attach_grad()
    with engine.bulk(64):
        with autograd.record():
            y = x * 3.0
            with autograd.pause():
                c = y * 10.0
            z = nd.sum(y + c)
        z.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(), [3.0, 3.0, 3.0])


def test_bulk_training_loop_multiple_steps():
    rs = np.random.RandomState(1)
    X = rs.randn(32, 4).astype(np.float32)
    yv = (X @ rs.randn(4).astype(np.float32) > 0).astype(np.float32)

    def run(bulked):
        w = nd.array(np.random.RandomState(2).randn(4, 1).astype(
            np.float32) * 0.1)
        w.attach_grad()
        losses = []
        for _ in range(6):
            with _scope(bulked):
                with autograd.record():
                    logits = nd.dot(nd.array(X), w).reshape((-1,))
                    p = nd.sigmoid(logits)
                    loss = -nd.mean(nd.array(yv) * nd.log(p + 1e-6)
                                    + (1 - nd.array(yv))
                                    * nd.log(1 - p + 1e-6))
                loss.backward()
            losses.append(float(loss.asnumpy()))
            w -= 0.5 * w.grad
            w.grad[:] = 0
        return losses, w.asnumpy()

    losses, w_b = run(True)
    assert losses[-1] < losses[0], losses
    want, w_e = run(False)
    assert losses == want
    np.testing.assert_array_equal(w_b, w_e)


def test_bulk_detach_alias_keeps_separate_grad_slots():
    def run(bulked):
        x = nd.array(np.array([2.0, 3.0], np.float32))
        x.attach_grad()
        with _scope(bulked, 16):
            with autograd.record():
                xd = x.detach()
                loss = (x * xd).sum()
            loss.backward()
        return x.grad.asnumpy().copy()

    np.testing.assert_array_equal(run(False), run(True))


def test_bulk_pause_only_input_grad_untouched():
    x = nd.array(np.ones((3,), np.float32))
    k = nd.array(np.ones((3,), np.float32))
    x.attach_grad()
    k.attach_grad()
    k.grad[:] = 42.0
    with engine.bulk(16):
        with autograd.record():
            y = x * 3.0
            with autograd.pause():
                c = k * 2.0
            z = (y + c).sum()
        z.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(), 3.0)
    np.testing.assert_array_equal(k.grad.asnumpy(), 42.0)


def test_bulk_inplace_write_mid_segment_uses_fresh_buffer():
    w = nd.array(np.array([1.0, 2.0], np.float32))
    with engine.bulk(16):
        y = w * 2.0
        w += 1.0               # a store into w, recorded
        z = w * 3.0
        got_y = y.asnumpy().copy()
        got_z = z.asnumpy().copy()
    np.testing.assert_array_equal(got_y, [2.0, 4.0])
    np.testing.assert_array_equal(got_z, [6.0, 9.0])
    np.testing.assert_array_equal(w.asnumpy(), [2.0, 3.0])


def test_bulk_defers_optimizer_updates():
    rs = np.random.RandomState(3)
    w0, g0, m0 = (rs.randn(8, 4).astype(np.float32) for _ in range(3))

    def run(bulked):
        w, g, m = (nd.array(a) for a in (w0, g0, m0))
        storage = w._data.untyped_storage().data_ptr()
        engine.reset_flush_stats()
        with _scope(bulked):
            for _ in range(3):
                nd.sgd_mom_update(w, g, m, lr=0.1, momentum=0.9, wd=0.01,
                                  out=w)
            if bulked:
                assert type(w._slot) is engine._Pending
                assert type(m._slot) is engine._Pending
            s = (w * 2.0).sum().asnumpy()
        # the stores landed in the arrays' own storage
        assert w._data.untyped_storage().data_ptr() == storage
        return w.asnumpy(), m.asnumpy(), s

    we, me, se = run(False)
    wb, mb, sb = run(True)
    assert sum(engine.flush_stats()["causes"].values()) == 1
    np.testing.assert_array_equal(we, wb)
    np.testing.assert_array_equal(me, mb)
    np.testing.assert_array_equal(se, sb)


def test_bulk_out_store_dtype_mismatch_falls_back():
    a = nd.array(np.ones((4,), np.float32))
    o = nd.zeros((4,), dtype=np.float16)
    with engine.bulk(16):
        nd.elemwise_add(a, a, out=o)
        assert type(o._slot) is torch.Tensor
        got = o.asnumpy()
    assert got.dtype == np.float16
    np.testing.assert_array_equal(got, 2.0)


def test_bulk_chained_store_dead_intermediates_eliminated():
    w = nd.array(np.ones((8,), np.float32))
    g = nd.array(np.full((8,), 0.5, np.float32))
    before = set(engine._replay_cache)
    with engine.bulk(16):
        for _ in range(4):
            nd.sgd_update(w, g, lr=0.1, wd=0.0, out=w)
    new = [k for k in engine._replay_cache if k not in before]
    assert len(new) == 1
    live = new[0][3]
    assert len(live) == 1, live
    want = np.ones(8, np.float32)
    for _ in range(4):
        want = want - np.float32(0.1) * np.float32(0.5)
    np.testing.assert_array_equal(w.asnumpy(), want)


# ---------------------------------------------------------------------------
# bench_eager.py's chains through both packages
# ---------------------------------------------------------------------------

def _chain_views(a, b, c, n):
    x = a
    h, w = SHAPE
    for _ in range(n // 4):
        x = x * b
        x = x.reshape((h * w,))
        x = x + 1.0
        x = x.reshape(SHAPE)
        x = x.transpose((1, 0))
        x = x.abs()
        x = x[0:h]
        x = x - c
    return x


def _bench_chains(m, a, b, c, train):
    """The three chains of bench_eager.py under ``m.engine.bulk``: values,
    a's gradient, and the flush statistics of each."""
    a, b, c = (m.nd.array(v) for v in (a, b, c))
    out = {}
    m.engine.reset_flush_stats()
    with m.engine.bulk(CHAIN + 1):
        out["eager"] = _chain(a, b, c, CHAIN).asnumpy()
    out["eager_stats"] = m.engine.flush_stats()
    m.engine.reset_flush_stats()
    with m.engine.bulk(4 * CHAIN):
        out["views"] = _chain_views(a, b, c, CHAIN).asnumpy()
    out["views_stats"] = m.engine.flush_stats()
    if train:
        a.attach_grad()
        m.engine.reset_flush_stats()
        with m.engine.bulk(CHAIN + 8):
            with m.autograd.record():
                o = _chain(a, b, c, CHAIN)
                loss = (o * o).sum()
            loss.backward()
        out["train_stats"] = m.engine.flush_stats()
        out["loss"] = loss.asnumpy()
        out["grad"] = a.grad.asnumpy()
    return out


@pytest.mark.parametrize("train", [False, True])
def test_bench_eager_chains_match_the_jax_build(train):
    rs = np.random.RandomState(0)
    a = rs.rand(*SHAPE).astype(np.float32)
    b = rs.rand(*SHAPE).astype(np.float32) + 0.5
    c = rs.rand(*SHAPE).astype(np.float32)
    got = _bench_chains(tmx, a, b, c, train)
    want = _bench_chains(jmx, a, b, c, train)
    keys = ["eager", "views"] + (["loss", "grad"] if train else [])
    for k in keys:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        assert float(np.abs(got[k] - want[k]).max()) <= REL * scale, k
    for k in ("eager_stats", "views_stats") + (("train_stats",)
                                                if train else ()):
        assert got[k]["causes"] == want[k]["causes"], k
        assert got[k]["segment_lengths"] == want[k]["segment_lengths"], k
    # and bulked against the port's own eager run, bit for bit
    ta, tb, tc = (tmx.nd.array(v) for v in (a, b, c))
    np.testing.assert_array_equal(got["eager"],
                                  _chain(ta, tb, tc, CHAIN).asnumpy())
    np.testing.assert_array_equal(got["views"],
                                  _chain_views(ta, tb, tc, CHAIN).asnumpy())


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flushes", [2, 3])
def test_output_of_one_flush_survives_the_next(flushes):
    a = nd.array(np.arange(6, dtype=np.float32))
    outs = []
    for i in range(flushes):
        with engine.bulk(8):
            outs.append((a * float(i + 1) + 1.0).abs())
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o.asnumpy(),
                                      np.arange(6) * (i + 1) + 1.0)


def _recorded(x, w):
    with autograd.record():
        h = nd.relu(nd.dot(x, w)) * 0.5
        return (h * h).sum()


def test_two_recorded_forwards_then_one_backward():
    rs = np.random.RandomState(4)
    xv, wv = rs.randn(3, 5).astype(np.float32), rs.randn(5, 4).astype(
        np.float32)

    def run(bulked):
        x, w = nd.array(xv), nd.array(wv)
        w.attach_grad()
        with _scope(bulked):
            l1 = _recorded(x, w)
            l2 = _recorded(x * 2.0, w)
        autograd.backward([l1, l2])
        return w.grad.asnumpy()

    np.testing.assert_array_equal(run(True), run(False))


def test_ext_written_in_place_after_forward_raises_at_backward():
    x = nd.array(np.ones((2, 3), np.float32))
    w = nd.array(np.ones((3, 2), np.float32))
    w.attach_grad()
    with engine.bulk(16):
        loss = _recorded(x, w)
    loss._data                       # flushed: the tape node exists
    x[:] = 5.0                       # an input of the segment changes
    with pytest.raises(RuntimeError, match="modified by an in-place"):
        loss.backward()


def test_offband_neither_joins_nor_flushes():
    a = nd.array(np.ones((4,), np.float32))
    engine.reset_flush_stats()
    with engine.bulk(16):
        y = a * 2.0
        with engine.offband():
            z = a + 1.0
            assert type(z._slot) is torch.Tensor
        assert len(engine._current().instructions) == 1
        w = y + 1.0
    assert sum(engine.flush_stats()["causes"].values()) == 1
    np.testing.assert_array_equal(w.asnumpy(), 3.0)
    np.testing.assert_array_equal(z.asnumpy(), 2.0)


def test_naive_engine_disables_deferral(monkeypatch):
    monkeypatch.setenv("MXTPU_ENGINE_TYPE", "NaiveEngine")
    a = nd.array(np.ones((4,), np.float32))
    with engine.bulk(16):
        y = a * 2.0
        assert type(y._slot) is torch.Tensor
        assert not engine._current().instructions


def test_not_deferrable_op_flushes_its_inputs_with_cause_read():
    m = nd.array(np.eye(3, dtype=np.float32) * 2.0)
    engine.reset_flush_stats()
    with engine.bulk(16):
        s = m + m.transpose()
        u, lam = nd.linalg.syevd(s)          # eigh checks info on the host
        assert type(lam._slot) is torch.Tensor
        assert engine.flush_stats()["causes"]["read"] == 1
    assert not registry.get_op("_linalg_syevd").deferrable
    np.testing.assert_allclose(lam.asnumpy(), [4.0, 4.0, 4.0], rtol=1e-6)


def test_infer_cache_hit_on_second_identical_op(monkeypatch):
    op = registry.get_op("broadcast_add")
    calls = []
    real = op.infer

    def counting(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(op, "infer", counting)
    registry._infer_cache.clear()
    a = nd.array(np.ones((3, 7), np.float32))
    with engine.bulk(16):
        y = a + a
        z = y + a
    assert len(calls) == 1
    assert engine.cache_sizes()["infer"] >= 1
    np.testing.assert_array_equal(z.asnumpy(), 3.0)


def test_dead_intermediates_and_cache_bound(monkeypatch):
    monkeypatch.setenv("GRAFT_REPLAY_CACHE_SIZE", "2")
    a = nd.array(np.ones((2,), np.float32))
    for n in range(1, 5):
        with engine.bulk(16):
            y = a
            for _ in range(n):
                y = y + 1.0
        np.testing.assert_array_equal(y.asnumpy(), 1.0 + n)
    assert len(engine._replay_cache) <= 2
    gc.collect()


def test_flatten_helpers():
    xs = [torch.arange(6.0).reshape(2, 3), torch.ones(4)]
    flat = engine.flatten_arrays(xs)
    assert flat.shape == (10,)
    back = engine.split_flat(flat, [(2, 3), (4,)])
    assert all(torch.equal(p, q) for p, q in zip(back, xs))
    assert engine.colocate(flat, xs[0]) is flat
    assert engine.cache_sizes()["split"] >= 1


THREAD_CASES = {
    "value": lambda box, w: box["y"].asnumpy(),
    "store_target_read": lambda box, w: w.asnumpy(),
    "store_target_write": lambda box, w: w.__setitem__(slice(None), 5.0),
}


@pytest.mark.parametrize("what", sorted(THREAD_CASES))
def test_segment_of_another_thread_raises_instead_of_flushing(what):
    """A value, or a store target, of a segment that another thread is
    recording is not flushed from this thread: it raises, and the owner's
    segment stays whole."""
    a = nd.array(np.ones((4,), np.float32))
    w = nd.array(np.zeros((4,), np.float32))
    recorded, done = threading.Event(), threading.Event()
    box = {}

    def owner():
        with engine.bulk(16):
            box["y"] = a * 2.0
            nd.elemwise_add(a, a, out=w)
            box["homed"] = type(w._slot) is engine._Pending
            recorded.set()
            done.wait(30)
            box["n"] = len(engine._current().instructions)
        box["w"] = w.asnumpy()

    t = threading.Thread(target=owner)
    t.start()
    assert recorded.wait(30)
    try:
        with pytest.raises(MXNetError, match="another thread"):
            THREAD_CASES[what](box, w)
    finally:
        done.set()
        t.join(30)
    assert box["homed"] and box["n"] == 2
    np.testing.assert_array_equal(box["w"], 2.0)
    np.testing.assert_array_equal(box["y"].asnumpy(), 2.0)


def test_meta_inference_failure_raises_in_bulk():
    """A deferrable op whose outputs meta inference cannot give raises
    inside a scope: it is not run eagerly behind the caller's back."""
    def host_read(x):
        return x * float(x.sum().item())

    op = registry.Operator("_test_engine_host_read", host_read)
    a = nd.array(np.ones((3,), np.float32))
    np.testing.assert_array_equal(nd.invoke(op, [a], {}).asnumpy(), 3.0)
    with engine.bulk(8):
        with pytest.raises(MXNetError, match="cannot infer"):
            nd.invoke(op, [a], {})


def test_gluon_batchnorm_training_forward_in_bulk():
    """Gluon BatchNorm's training forward inside a scope: its moving
    statistics are one deferred store, and output and statistics are
    bit-equal to eager."""
    rs = np.random.RandomState(7)
    net = tmx.gluon.nn.BatchNorm(in_channels=3)
    net.initialize()
    x = nd.array(rs.randn(4, 3, 5, 5).astype(np.float32))

    def forward(bulked):
        net.running_mean.set_data(nd.zeros((3,)))
        net.running_var.set_data(nd.ones((3,)))
        with _scope(bulked):
            with autograd.record():
                y = net(x)
            if bulked:
                assert type(net.running_mean.data()._slot) is \
                    engine._Pending
                assert len(engine._current().instructions) == 2
        return [y.asnumpy(), net.running_mean.data().asnumpy(),
                net.running_var.data().asnumpy()]

    want = forward(False)
    for got, w in zip(forward(True), want):
        np.testing.assert_array_equal(got, w)
    assert not np.array_equal(want[1], 0.0)


def test_bulk_lazy_sparse_sgd_defers():
    """The twin of the JAX build's contract: the row-sparse lazy SGD update
    is a registered op and defers under bulk; one flush covers the update
    and its consumer, the weight equals eager bit for bit and equals the
    JAX build's, and the rows without gradient stay untouched."""
    rs = np.random.RandomState(5)
    w0 = rs.randn(16, 4).astype(np.float32)
    dense_g = np.zeros((16, 4), np.float32)
    dense_g[[2, 9]] = rs.randn(2, 4)

    def run(m, bulked):
        opt = m.optimizer.SGD(learning_rate=0.1, lazy_update=True)
        w = m.nd.array(w0)
        grad = m.nd.array(dense_g).tostype("row_sparse")
        with (m.engine.bulk(16) if bulked else contextlib.nullcontext()):
            opt.update(0, w, grad, None)
            if bulked and m is tmx:
                assert type(w._slot) is engine._Pending
            out = (w * 1.0).sum().asnumpy()
        return w.asnumpy(), float(out)

    we, se = run(tmx, False)
    engine.reset_flush_stats()
    wb, sb = run(tmx, True)
    stats = engine.flush_stats()
    assert sum(stats["causes"].values()) == 1, stats
    assert stats["segment_lengths"] == {3: 1}, stats
    np.testing.assert_array_equal(we, wb)
    assert se == sb
    np.testing.assert_array_equal(we, run(jmx, True)[0])
    np.testing.assert_array_equal(we[0], w0[0])
    assert not np.allclose(we[2], w0[2])


# ---------------------------------------------------------------------------
# on the card (skipped here): phase 11 of chip_smoke.py at small sizes
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_card_bulk_graphs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    chip_smoke.bulk_card_contracts(tmx, chip_smoke.card_line())
