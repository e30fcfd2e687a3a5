"""The port's serving runtime (``incubator_mxnet_tpu_torch.serving``): the
contracts of tests/test_serving.py on the CPU (bit parity across buckets
and dtypes, batch formation, the exact-sum SLO decomposition, LRU residency
and reload, the reload latch, hot-swap, the parity probe, the dispatcher's
survival, thread-local shadows, the CLI), both packages' ``Server`` on the
same numpy weights and requests, and on the card the CUDA-graph programs
(``-m cuda``)."""
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu.serving as jserving
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import gluon, serving
from incubator_mxnet_tpu_torch.ndarray import NDArray
from incubator_mxnet_tpu_torch.serving import registry as registry_mod

ROOT = Path(__file__).resolve().parent.parent
DIN, DHID, DOUT = 12, 16, 4
CPU = tmx.cpu()
WAIT = 60.0      # seconds any future or thread may take


def _mlp_class(pkg):
    class _MLP(pkg.gluon.HybridBlock):
        def __init__(self, dh=DHID, dout=DOUT, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.d1 = pkg.gluon.nn.Dense(dh, activation="relu")
                self.d2 = pkg.gluon.nn.Dense(dout)

        def hybrid_forward(self, F, x):
            return F.Activation(self.d2(self.d1(x)), act_type="tanh")

    return _MLP


_MLP = _mlp_class(tmx)


class _BatchCoupled(gluon.HybridBlock):
    """Deliberately row-COUPLED forward (subtracts the batch mean): in
    ``fused`` mode its batched rows differ from the bucket-1 forward, so it
    triggers the parity probe; in ``exact`` mode every row is its own
    forward and parity holds structurally."""

    def hybrid_forward(self, F, x):
        return x - F.mean(x, axis=0, keepdims=True)


def _weights(names_shapes, seed, scale, dtype=np.float32):
    rs = np.random.RandomState(seed)
    return {n: (rs.randn(*s) * scale).astype(dtype) for n, s in names_shapes}


def _mlp(seed=0, din=DIN, scale=0.5, dtype="float32", ctx=CPU):
    net = _MLP()
    net.initialize(ctx=ctx)
    net.hybridize()
    net(tmx.nd.array(np.zeros((1, din), np.float32), ctx=ctx))
    if dtype != "float32":
        net.cast(dtype)
    params = net.collect_params()
    vals = _weights([(n, p.shape) for n, p in params.items()], seed, scale)
    for n, p in params.items():
        p.set_data(tmx.nd.array(vals[n], ctx=ctx, dtype=dtype))
    return net


def _eager(net, x, ctx=CPU):
    return net(tmx.nd.array(x[None], ctx=ctx)).asnumpy()[0]


def _serve(net, n_req=12, seed=3, din=DIN, **srv_kw):
    """Serve n_req threaded single-example requests; returns (inputs,
    outputs, futures)."""
    rs = np.random.RandomState(seed)
    xs = [rs.randn(din).astype(np.float32) for _ in range(n_req)]
    kw = dict(max_batch=8, max_wait_ms=3)
    kw.update(srv_kw)
    with serving.Server(**kw) as srv:
        srv.load("m", block=net, example=tmx.nd.array(xs[0][None], ctx=CPU))
        futs = [None] * n_req

        def client(lo, hi):
            for i in range(lo, hi):
                futs[i] = srv.submit("m", xs[i])

        step = max(n_req // 3, 1)
        threads = [threading.Thread(target=client,
                                    args=(lo, min(lo + step, n_req)))
                   for lo in range(0, n_req, step)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        outs = [f.get(timeout=WAIT) for f in futs]
    return xs, outs, futs


# -- batched parity ------------------------------------------------------------

def test_batched_bit_parity_across_shape_buckets():
    net = _mlp()
    coupled = _BatchCoupled()
    coupled.initialize(ctx=CPU)
    rs = np.random.RandomState(1)
    flat = [rs.randn(DIN).astype(np.float32) for _ in range(9)]
    wide = [rs.randn(5, 7).astype(np.float32) for _ in range(7)]
    with serving.Server(max_batch=8, max_wait_ms=3) as srv:
        srv.load("m", block=net, example=tmx.nd.array(flat[0][None], ctx=CPU))
        srv.load("c", block=coupled, example=tmx.nd.array(wide[0][None],
                                                          ctx=CPU))
        futs = [("m", x, srv.submit("m", x)) for x in flat] + \
               [("c", x, srv.submit("c", x)) for x in wide]
        for name, x, f in futs:
            y = f.get(timeout=WAIT)
            ref = _eager(net if name == "m" else coupled, x)
            assert y.shape == ref.shape and y.tobytes() == ref.tobytes()


def test_batched_bit_parity_float16():
    net = _mlp(seed=2, scale=1.0, dtype="float16")
    rs = np.random.RandomState(2)
    xs = [rs.randn(DIN).astype(np.float16) for _ in range(6)]
    with serving.Server(max_batch=4, max_wait_ms=3) as srv:
        srv.load("m16", block=net, example=tmx.nd.array(
            xs[0][None], ctx=CPU, dtype="float16"))
        futs = [srv.submit("m16", x) for x in xs]
        for x, f in zip(xs, futs):
            y = f.get(timeout=WAIT)
            assert y.dtype == np.float16
            ref = net(tmx.nd.array(x[None], ctx=CPU,
                                   dtype="float16")).asnumpy()[0]
            assert y.tobytes() == ref.tobytes()


def test_batches_assemble_and_cap_at_max_batch():
    net = _mlp()
    rs = np.random.RandomState(4)
    xs = [rs.randn(DIN).astype(np.float32) for _ in range(10)]
    with serving.Server(max_batch=4, max_wait_ms=150) as srv:
        srv.load("m", block=net, example=tmx.nd.array(xs[0][None], ctx=CPU))
        srv.warmup("m", xs[0])
        futs = [srv.submit("m", x) for x in xs]
        for f in futs:
            f.get(timeout=WAIT)
        recs = [f.record for f in futs]
        batches = srv.batcher.batches_total
    sizes = [r["batch_size"] for r in recs]
    assert max(sizes) > 1 and all(s <= 4 for s in sizes)
    assert all(r["bucket"] >= r["batch_size"] for r in recs)
    # every request landed in exactly one batch
    assert sum(1.0 / s for s in sizes) == pytest.approx(batches)


def test_max_wait_timeout_flushes_partial_batch():
    net = _mlp()
    x = np.random.RandomState(5).randn(DIN).astype(np.float32)
    with serving.Server(max_batch=32, max_wait_ms=40) as srv:
        srv.load("m", block=net, example=tmx.nd.array(x[None], ctx=CPU))
        srv.warmup("m", x, buckets=[1])
        t0 = time.perf_counter()
        y = srv.submit("m", x).get(timeout=WAIT)
        dt = time.perf_counter() - t0
    assert y.tobytes() == _eager(net, x).tobytes()
    assert dt >= 0.040                   # held for the wait window
    assert dt < 10.0                     # but flushed, not starved


def test_deadline_sheds_a_queued_request():
    net = _mlp()
    x = np.random.RandomState(6).randn(DIN).astype(np.float32)
    with serving.Server(max_batch=32, max_wait_ms=200) as srv:
        srv.load("m", block=net, example=tmx.nd.array(x[None], ctx=CPU))
        fut = srv.submit("m", x, deadline_ms=20)
        with pytest.raises(serving.DeadlineExceededError):
            fut.get(timeout=WAIT)
    snap = tmx.telemetry.compact_snapshot()
    assert snap.get('graft_serve_shed_total{model="m"}', 0) >= 1


# -- SLO decomposition ---------------------------------------------------------

def test_per_request_decomposition_conserves_exactly():
    _xs, _outs, futs = _serve(_mlp(), n_req=12)
    for f in futs:
        rec = f.record
        comp = rec["components"]
        assert sum(comp[c] for c in serving.slo.COMPONENTS) == rec["wall_s"]
        for c in ("queue_wait", "batch_assembly", "device_compute"):
            assert comp[c] >= 0.0
        assert comp["host_io"] > -1e-9
        assert rec["wall_s"] > 0.0


def test_slo_ring_quantiles_and_metrics():
    serving.slo.reset()
    _serve(_mlp(), n_req=10)
    s = serving.slo.summary()
    assert s["ok"] >= 10
    assert 0 < s["p50_ms"] <= s["p99_ms"]
    assert serving.slo.component_quantile("queue_wait", 0.99) >= 0.0
    snap = tmx.telemetry.compact_snapshot()
    assert snap.get('graft_serve_requests_total{model="m"}', 0) >= 10
    assert snap.get('graft_serve_latency_seconds{quantile="p50"}', 0) > 0
    assert snap.get('graft_serve_batch_size_count', 0) >= 1


def test_metrics_prometheus_round_trip_and_switch():
    reg = tmx.telemetry.MetricsRegistry()
    reg.counter("c_total", "a counter", ("k",)).inc(3, k='a"b')
    reg.gauge("g", "a gauge").set(2.5)
    reg.histogram("h", "a histogram", buckets=(1.0, 2.0)).observe(1.5)
    parsed = tmx.telemetry.parse_prometheus_text(reg.prometheus_text())
    assert parsed["c_total"][frozenset({("k", 'a"b')})] == 3.0
    assert parsed["g"][frozenset()] == 2.5
    assert parsed["h_bucket"][frozenset({("le", "2")})] == 1.0
    assert parsed["h_bucket"][frozenset({("le", "1")})] == 0.0
    tmx.telemetry.set_enabled(False)
    try:
        reg.gauge("g", "a gauge").set(9.0)
    finally:
        tmx.telemetry.set_enabled(None)
    assert tmx.telemetry.compact_snapshot(reg)["g"] == 2.5


# -- residency: LRU eviction + reload ------------------------------------------

def _x(seed):
    return np.random.RandomState(seed).randn(DIN).astype(np.float32)


def test_lru_eviction_and_transparent_reload():
    nets = [_mlp(seed=s) for s in (1, 2, 3)]
    x = _x(9)
    ex = tmx.nd.array(x[None], ctx=CPU)
    model_bytes = serving.ModelRegistry().load_block("p", nets[0], ex).nbytes
    budget = 2 * model_bytes + 1                         # exactly 2 fit
    reg = serving.ModelRegistry(memory_bytes=budget)
    ha = reg.load_block("a", nets[0], ex)
    hb = reg.load_block("b", nets[1], ex)
    assert ha.resident and hb.resident
    hc = reg.load_block("c", nets[2], ex)
    assert not ha.resident and hb.resident and hc.resident
    assert reg.resident_bytes() <= budget
    reg.acquire("b")
    entry, params, version = reg.acquire("a")
    assert ha.resident and version == 1 and params
    assert not hc.resident
    assert reg.reloads_total == 1 and reg.evictions_total == 2
    y = ha.predict(x[None])
    assert np.asarray(y).tobytes() == \
        nets[0](tmx.nd.array(x[None], ctx=CPU)).asnumpy().tobytes()


def test_eviction_with_requests_through_server():
    nets = [_mlp(seed=s) for s in (1, 2)]
    x = _x(8)
    with serving.Server(memory_bytes=1, max_batch=4, max_wait_ms=2) as srv:
        srv.load("a", block=nets[0], example=tmx.nd.array(x[None], ctx=CPU))
        srv.load("b", block=nets[1], example=tmx.nd.array(x[None], ctx=CPU))
        assert not srv.registry.get("a").resident
        ya = srv.predict("a", x, timeout=WAIT)
        assert ya.tobytes() == _eager(nets[0], x).tobytes()
        assert srv.registry.reloads_total >= 1


def test_eviction_reload_restores_load_time_weights():
    net = _mlp(seed=6)
    x = _x(10)
    reg = serving.ModelRegistry()
    h = reg.load_block("m", net, tmx.nd.array(x[None], ctx=CPU))
    ref = np.asarray(h.predict(x[None]))
    for _n, p in net.collect_params().items():      # "retrain" the source
        p.set_data(p.data() * 3.0)
    assert np.asarray(h.predict(x[None])).tobytes() == ref.tobytes()
    assert reg.evict("m") and not h.resident
    got = np.asarray(h.predict(x[None]))        # transparent reload
    assert got.tobytes() == ref.tobytes()       # load-time weights
    assert h.version == 1
    assert got.tobytes() != \
        net(tmx.nd.array(x[None], ctx=CPU)).asnumpy().tobytes()


def test_reload_runs_outside_the_registry_lock():
    nets = [_mlp(seed=1), _mlp(seed=2)]
    x = _x(21)
    reg = serving.ModelRegistry()
    ha = reg.load_block("a", nets[0], tmx.nd.array(x[None], ctx=CPU))
    reg.load_block("b", nets[1], tmx.nd.array(x[None], ctx=CPU))
    assert reg.evict("a") and not ha.resident
    orig_loader = reg.get("a")._loader
    started, release = threading.Event(), threading.Event()

    def slow_loader():
        started.set()
        release.wait(10.0)
        return orig_loader()

    reg.get("a")._loader = slow_loader
    reloader = threading.Thread(target=lambda: reg.acquire("a"),
                                daemon=True)
    reloader.start()
    assert started.wait(10.0)
    t0 = time.perf_counter()
    _entry, params, _v = reg.acquire("b")
    blocked_s = time.perf_counter() - t0
    still_loading = not release.is_set() and reloader.is_alive()
    release.set()
    reloader.join(10.0)
    assert still_loading, "gate opened early — the probe proved nothing"
    assert params and blocked_s < 5.0
    assert ha.resident
    assert np.asarray(ha.predict(x[None])).tobytes() == \
        nets[0](tmx.nd.array(x[None], ctx=CPU)).asnumpy().tobytes()


def test_reload_latch_serializes_concurrent_acquires():
    net = _mlp(seed=3)
    x = _x(22)
    reg = serving.ModelRegistry()
    ha = reg.load_block("a", net, tmx.nd.array(x[None], ctx=CPU))
    assert reg.evict("a")
    orig_loader = reg.get("a")._loader
    calls = [0]
    gate = threading.Event()

    def slow_loader():
        calls[0] += 1
        gate.wait(10.0)
        return orig_loader()

    reg.get("a")._loader = slow_loader
    results, errors = [], []

    def worker():
        try:
            _e, params, version = reg.acquire("a")
            results.append((len(params), version))
        except Exception as exc:        # pragma: no cover - failure path
            errors.append(exc)

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.1)                     # let every follower reach the latch
    gate.set()
    for t in threads:
        t.join(10.0)
    assert not errors and len(results) == 4
    assert calls[0] == 1, "the latch must serialize to ONE loader run"
    assert len(set(results)) == 1
    assert reg.reloads_total == 1 and ha.resident


def test_reload_failure_releases_latch():
    net = _mlp(seed=4)
    x = _x(23)
    reg = serving.ModelRegistry()
    ha = reg.load_block("a", net, tmx.nd.array(x[None], ctx=CPU))
    assert reg.evict("a")
    orig_loader = reg.get("a")._loader
    boom = [True]

    def flaky_loader():
        if boom[0]:
            raise IOError("weights store down")
        return orig_loader()

    reg.get("a")._loader = flaky_loader
    with pytest.raises(IOError):
        reg.acquire("a")
    assert reg.get("a")._loading is None        # latch released
    boom[0] = False
    _e, params, _v = reg.acquire("a")           # retry succeeds
    assert params and ha.resident
    # a malformed mapping fails INSIDE the locked install step
    assert reg.evict("a")
    reg.get("a")._loader = lambda: {"w": object()}   # no numel()
    with pytest.raises(Exception):
        reg.acquire("a")
    assert reg.get("a")._loading is None
    reg.get("a")._loader = orig_loader
    _e, params, _v = reg.acquire("a")
    assert params and ha.resident


def test_reload_failure_does_not_clobber_successor_latch(monkeypatch):
    net = _mlp(seed=5)
    x = _x(24)
    reg = serving.ModelRegistry()
    reg.load_block("a", net, tmx.nd.array(x[None], ctx=CPU))
    assert reg.evict("a")
    entry = reg.get("a")
    successor = threading.Event()

    def exploding_nbytes(params):
        entry._loading = successor
        raise TypeError("malformed mapping")

    with monkeypatch.context() as m:
        m.setattr(registry_mod, "_nbytes", exploding_nbytes)
        with pytest.raises(TypeError):
            reg.acquire("a")
    assert entry._loading is successor, \
        "failure handler clobbered the successor's latch"
    entry._loading = None
    _e, params, _v = reg.acquire("a")
    assert params and entry._resident


def test_unload_and_sources_of_later_slices():
    net = _mlp()
    reg = serving.ModelRegistry()
    h = reg.load_block("m", net, tmx.nd.array(_x(1)[None], ctx=CPU))
    assert reg.unload("m") and not h.resident and reg.models() == []
    with pytest.raises(KeyError):
        reg.acquire("m")
    with serving.Server() as srv:
        for kw in ({"module": object()}, {"symbol": object(), "params": {}},
                   {"symbol_json": "{}", "param_bytes": b""}):
            with pytest.raises(NotImplementedError, match="ROADMAP item 5"):
                srv.load("x", **kw)


# -- hot-swap ------------------------------------------------------------------

def test_swap_ticket_old_version_serves_until_commit():
    net = _mlp()
    x = _x(11)
    with serving.Server(max_batch=4, max_wait_ms=1) as srv:
        srv.load("m", block=net, example=tmx.nd.array(x[None], ctx=CPU))
        old = srv.predict("m", x, timeout=WAIT)
        _fn, pv = net.serving_fn(tmx.nd.array(x[None], ctx=CPU))
        ticket = srv.begin_swap("m", {n: np.asarray(v.detach()) * 2.0
                                      for n, v in pv.items()})
        mid = srv.predict("m", x, timeout=WAIT)
        assert mid.tobytes() == old.tobytes()
        assert srv.registry.get("m").version == 1 and not ticket.done
        assert ticket.commit() == 2 and ticket.done
        new = srv.predict("m", x, timeout=WAIT)
        assert new.tobytes() != old.tobytes()
        assert srv.registry.get("m").version == 2
        assert srv.registry.swaps_total == 1
        t2 = srv.begin_swap("m", {n: np.asarray(v.detach()) * 3.0
                                  for n, v in pv.items()})
        t2.abandon()
        assert srv.predict("m", x, timeout=WAIT).tobytes() == new.tobytes()
        assert srv.registry.get("m").version == 2
    snap = tmx.telemetry.compact_snapshot()
    assert snap.get('graft_serve_model_events_total{kind="swap"}', 0) >= 1


def test_hot_swap_mid_traffic_no_torn_weights():
    net = _mlp()
    x = _x(12)
    with serving.Server(max_batch=4, max_wait_ms=1) as srv:
        srv.load("m", block=net, example=tmx.nd.array(x[None], ctx=CPU))
        srv.warmup("m", x)
        oracle = {srv.predict("m", x, timeout=WAIT).tobytes()}
        _fn, pv = net.serving_fn(tmx.nd.array(x[None], ctx=CPU))
        stop = threading.Event()
        bad = []

        def traffic():
            while not stop.is_set():
                y = srv.predict("m", x, timeout=WAIT)
                if y.tobytes() not in oracle:
                    bad.append(y)
                    return

        threads = [threading.Thread(target=traffic) for _ in range(3)]
        for k in (3.0, 5.0, 7.0):       # three version flips mid-traffic
            new = {n: v.detach() * k for n, v in pv.items()}
            ticket = srv.begin_swap("m", new)
            if len(oracle) == 1:
                for t in threads:
                    t.start()
            entry, _params, _v = srv.registry.acquire("m")
            oracle.add(np.asarray(entry.jit_for(1)(
                new, torch.from_numpy(x[None])))[0].tobytes())
            ticket.commit()
        stop.set()
        for t in threads:
            t.join(timeout=WAIT)
        assert not bad, "a response saw torn weights"
        assert srv.registry.get("m").version == 4


def test_overlapping_swaps_keep_versions_monotonic():
    net = _mlp()
    x = _x(22)
    reg = serving.ModelRegistry()
    h = reg.load_block("m", net, tmx.nd.array(x[None], ctx=CPU))
    _fn, pv = net.serving_fn(tmx.nd.array(x[None], ctx=CPU))
    ta = reg.begin_swap("m", {n: v.detach() * 2 for n, v in pv.items()})
    tb = reg.begin_swap("m", {n: v.detach() * 3 for n, v in pv.items()})
    vb = tb.commit()
    va = ta.commit()
    assert (vb, va) == (2, 3) and h.version == 3
    _entry, params, _v = reg.acquire("m")
    name0 = sorted(pv)[0]
    assert torch.equal(params[name0], pv[name0].detach() * 2)


def test_swap_keeps_a_bf16_version_through_eviction():
    """A hot-swapped bf16 version reloads after eviction bit for bit, in its
    own dtype (numpy has no bf16: the host copy is a torch tensor)."""
    net = _mlp(seed=7, dtype="bfloat16")
    x = _x(25)
    reg = serving.ModelRegistry()
    h = reg.load_block("m", net, tmx.nd.array(x[None], ctx=CPU,
                                              dtype="bfloat16"))
    _fn, pv = net.serving_fn(tmx.nd.array(x[None], ctx=CPU,
                                          dtype="bfloat16"))
    new = {n: (v.detach().float() * 1.5).to(torch.bfloat16)
           for n, v in pv.items()}
    assert reg.swap("m", new) == 2
    before = h.predict(x[None].astype(np.float32)).to(torch.bfloat16)
    assert reg.evict("m")
    _e, params, version = reg.acquire("m")
    assert version == 2
    for n, v in new.items():
        assert params[n].dtype == torch.bfloat16 and torch.equal(params[n], v)
    after = h.predict(x[None].astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(before, after)


# -- parity probe (fused mode) + exact mode ------------------------------------

def _coupled_requests(srv, n=6):
    rs = np.random.RandomState(13)
    xs = [rs.randn(DIN).astype(np.float32) for _ in range(n)]
    futs = [srv.submit("c", x) for x in xs]
    return xs, [f.get(timeout=WAIT) for f in futs]


def _coupled():
    net = _BatchCoupled()
    net.initialize(ctx=CPU)
    return net


def test_parity_probe_demotes_fused_mismatch(monkeypatch):
    monkeypatch.setenv("GRAFT_SERVE_BATCH_MODE", "fused")
    net = _coupled()
    with serving.Server(max_batch=8, max_wait_ms=100) as srv:
        srv.load("c", block=net, example=tmx.nd.array(
            np.zeros((1, DIN), np.float32), ctx=CPU))
        xs, outs = _coupled_requests(srv)
        demoted = bool(srv.registry.get("c").no_batch)
    assert demoted
    for x, y in zip(xs, outs):
        assert y.tobytes() == _eager(net, x).tobytes()
    snap = tmx.telemetry.compact_snapshot()
    assert snap.get('graft_serve_parity_fallbacks_total{model="c"}', 0) >= 1


def test_functionalized_forward_draws_from_a_fixed_default_seed():
    """``fn``'s default randomness is a generator seeded 0 made afresh in
    every call (the JAX build's fixed default key), made only when a draw
    asks for it (a CUDA graph capture may make none); an explicit
    generator is used as given."""
    from incubator_mxnet_tpu_torch import random_state
    cpu = torch.device("cpu")
    draws = []
    for _ in range(2):
        with random_state.use_generator(0):
            draws.append(torch.rand(3, generator=random_state.generator(cpu)))
            again = torch.rand(3, generator=random_state.generator(cpu))
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0],
                                                               again)
    g = torch.Generator().manual_seed(5)
    with random_state.use_generator(g):
        assert random_state.generator(cpu) is g
    assert random_state.generator(cpu) is not g
    fn, params = _mlp().serving_fn(tmx.nd.array(_x(1)[None], ctx=CPU))
    x = torch.from_numpy(_x(2)[None])
    assert torch.equal(fn(params, x), fn(params, x, rng=g))


def test_trace_shadows_are_thread_local():
    net = _mlp()
    x = np.random.RandomState(20).randn(1, DIN).astype(np.float32)
    ref = net(tmx.nd.array(x, ctx=CPU)).asnumpy()
    shadows = {p.name: NDArray(torch.zeros(p.shape))
               for _n, p in net.collect_params().items()}
    entered, release = threading.Event(), threading.Event()

    def holder():
        with net._trace_params(shadows):
            entered.set()
            release.wait(10)

    t = threading.Thread(target=holder)
    t.start()
    assert entered.wait(10)
    try:
        out = net(tmx.nd.array(x, ctx=CPU)).asnumpy()
    finally:
        release.set()
        t.join(10)
    assert out.tobytes() == ref.tobytes()
    assert np.abs(out).sum() > 0


def test_exact_mode_serves_row_coupled_model_with_parity():
    net = _coupled()
    with serving.Server(max_batch=8, max_wait_ms=100) as srv:
        srv.load("c", block=net, example=tmx.nd.array(
            np.zeros((1, DIN), np.float32), ctx=CPU))
        xs, outs = _coupled_requests(srv)
        assert not srv.registry.get("c").no_batch
    for x, y in zip(xs, outs):
        assert y.tobytes() == _eager(net, x).tobytes()


def test_parity_verdicts_reset_on_reregistration(monkeypatch):
    monkeypatch.setenv("GRAFT_SERVE_BATCH_MODE", "fused")
    with serving.Server(max_batch=8, max_wait_ms=100) as srv:
        srv.load("c", block=_coupled(), example=tmx.nd.array(
            np.zeros((1, DIN), np.float32), ctx=CPU))
        _coupled_requests(srv)
        assert srv.registry.get("c").no_batch
        srv.registry.unload("c")
        clean = _mlp()
        srv.load("c", block=clean, example=tmx.nd.array(
            np.zeros((1, DIN), np.float32), ctx=CPU))
        assert not srv.registry.get("c").no_batch
        xs, outs = _coupled_requests(srv)
        for x, y in zip(xs, outs):
            assert y.tobytes() == _eager(clean, x).tobytes()


def test_dispatcher_survives_unexpected_dispatch_error(monkeypatch):
    net = _mlp()
    x = _x(21)
    with serving.Server(max_batch=4, max_wait_ms=1) as srv:
        srv.load("m", block=net, example=tmx.nd.array(x[None], ctx=CPU))
        real = serving.ModelHandle.jit_for

        def boom(self, bucket, mode=None):
            raise RuntimeError("jit_for exploded")

        monkeypatch.setattr(serving.ModelHandle, "jit_for", boom)
        fut = srv.submit("m", x)
        with pytest.raises(RuntimeError):
            fut.get(timeout=WAIT)
        monkeypatch.setattr(serving.ModelHandle, "jit_for", real)
        y = srv.predict("m", x, timeout=WAIT)
        assert y.tobytes() == _eager(net, x).tobytes()
    snap = tmx.telemetry.compact_snapshot()
    assert snap.get('graft_serve_errors_total{model="m"}', 0) >= 1


# -- the graph cache's bookkeeping (no card needed) ----------------------------

def test_graph_cache_keeps_only_the_current_weights():
    """A graph is kept only for the model's current weight set; a swap, an
    eviction and an unload drop every graph (and the weights it holds)."""
    net = _mlp()
    reg = serving.ModelRegistry()
    h = reg.load_block("m", net, tmx.nd.array(_x(2)[None], ctx=CPU))
    _e, params, _v = reg.acquire("m")

    def fake(p):
        return registry_mod._Graph(None, [], (torch.zeros(1),), p, True)

    h._cache_graph("k1", fake(params))
    h._cache_graph("k2", fake(dict(params)))        # foreign weights
    assert h.graph_keys() == ["k1"]
    assert h._cached_graph("k1", params) is not None
    assert h._cached_graph("k1", dict(params)) is None
    reg.swap("m", {n: v.detach() for n, v in params.items()})
    assert h.graph_keys() == []
    _e, params, _v = reg.acquire("m")
    h._cache_graph("k1", fake(params))
    assert reg.evict("m") and h.graph_keys() == []
    _e, params, _v = reg.acquire("m")
    h._cache_graph("k1", fake(params))
    assert reg.unload("m") and h.graph_keys() == []


def test_programs_by_bucket_and_mode(monkeypatch):
    net = _mlp()
    h = serving.ModelRegistry().load_block(
        "m", net, tmx.nd.array(_x(3)[None], ctx=CPU))
    assert h.jit_for(1) is h.jit_for(1, "exact") is h.jit_for(4, "fused")
    assert h.jit_for(4).key == ("exact", 4) and h.jit_for(4) is h.jit_for(4)
    monkeypatch.setenv("GRAFT_SERVE_BATCH_MODE", "fused")
    assert h.jit_for(4).key == "fused"
    xb = torch.from_numpy(np.stack([_x(4), _x(5)]))
    _e, params, _v = h.acquire()
    fused = h.jit_for(2, "fused")(params, xb)
    exact = h.jit_for(2, "exact")(params, xb)
    for i in range(2):      # exact rows ARE the bucket-1 program's
        assert torch.equal(exact[i:i + 1], h.jit_for(1)(params, xb[i:i + 1]))
    # a GEMM over 2 rows may round otherwise than over 1 (the probe's case)
    torch.testing.assert_close(fused, exact, rtol=0, atol=1e-6)
    assert h.captures == 0           # the CPU runs programs eagerly


# -- the CLI -------------------------------------------------------------------

def test_serving_selftest_cli():
    proc = subprocess.run(
        [sys.executable, "-m", "incubator_mxnet_tpu_torch.serving",
         "--selftest", "--device", "cpu"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "graftserve selftest OK" in proc.stdout


def test_serving_cli_refuses_the_cpu_unless_asked():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "incubator_mxnet_tpu_torch.serving",
         "--selftest"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert "mx.cpu()" in proc.stderr and "selftest OK" not in proc.stdout


# -- both packages' Server on the same weights and requests ---------------------

def _jax_server_outputs(jnet, example, xs, max_batch):
    with jserving.Server(max_batch=max_batch, max_wait_ms=50) as srv:
        srv.load("m", block=jnet, example=jmx.nd.array(example))
        futs = [srv.submit("m", x) for x in xs]
        return [f.get(timeout=300.0) for f in futs]


def _port_server_outputs(tnet, example, xs, max_batch):
    with serving.Server(max_batch=max_batch, max_wait_ms=50) as srv:
        srv.load("m", block=tnet, example=tmx.nd.array(example, ctx=CPU))
        futs = [srv.submit("m", x) for x in xs]
        return [f.get(timeout=WAIT) for f in futs]


def test_server_matches_jax_on_the_mlp():
    jnet = _mlp_class(jmx)()
    jnet.initialize(ctx=jmx.cpu())
    jnet(jmx.nd.array(np.zeros((1, DIN), np.float32)))
    tnet = _mlp()
    tparams = tnet.collect_params()
    jparams = jnet.collect_params()
    vals = _weights([(n, p.shape) for n, p in tparams.items()], 31, 0.5)
    for (tn, tp), (jn, jp) in zip(sorted(tparams.items()),
                                  sorted(jparams.items())):
        assert tn[len(tnet.prefix):] == jn[len(jnet.prefix):]
        tp.set_data(tmx.nd.array(vals[tn], ctx=CPU))
        jp.set_data(jmx.nd.array(vals[tn]))
    rs = np.random.RandomState(32)
    xs = [rs.randn(DIN).astype(np.float32) for _ in range(7)]
    example = xs[0][None]
    want = _jax_server_outputs(jnet, example, xs, 4)
    got = _port_server_outputs(tnet, example, xs, 4)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def _last_token(pkg, lm):
    class LastToken(pkg.gluon.HybridBlock):
        """The LM's last position: (logits (vocab,), their argmax)."""

        def __init__(self, lm, **kw):
            super().__init__(**kw)
            self.lm = lm

        def hybrid_forward(self, F, tokens):
            last = F.slice_axis(self.lm(tokens), axis=1, begin=-1, end=None)
            last = F.reshape(last, shape=(0, -1))
            return last, F.argmax(last, axis=-1)

    return LastToken(lm)


def test_server_matches_jax_on_a_small_last_token_lm():
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_lm import SMALL, _jax_lm
    from incubator_mxnet_tpu_torch.convert import load_numpy_params
    from incubator_mxnet_tpu_torch.models import TransformerLM
    jmx.random.seed(0)
    jlm = _jax_lm(**SMALL)
    jlm.initialize(jmx.init.Xavier())
    rs = np.random.RandomState(33)
    tokens = rs.randint(0, SMALL["vocab"], (3, SMALL["seq_len"]))
    jlm(jmx.nd.array(tokens[:1]))
    params = {n: p.data().asnumpy() for n, p in jlm.collect_params().items()}
    tlm = TransformerLM(**SMALL)
    load_numpy_params(tlm, params, CPU)
    xs = [t.astype(np.int32) for t in tokens]
    example = xs[0][None]
    want = _jax_server_outputs(_last_token(jmx, jlm), example, xs, 2)
    got = _port_server_outputs(_last_token(tmx, tlm), example, xs, 2)
    for (gl, gi), (wl, wi) in zip(got, want):
        assert gl.shape == wl.shape == (SMALL["vocab"],)
        assert gl.dtype == wl.dtype == np.float32
        np.testing.assert_allclose(gl, wl, rtol=0, atol=1e-4)
        assert gi == wi == wl.argmax()


# -- on the card: the CUDA-graph programs --------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return tmx.gpu(0)


def _card_requests(n, seed=40):
    rs = np.random.RandomState(seed)
    return [rs.randn(DIN).astype(np.float32) for _ in range(n)]


@pytest.mark.cuda
def test_card_graph_replay_matches_bucket1_program(card):
    net = _mlp(ctx=card)
    xs = _card_requests(12)
    with serving.Server(max_batch=4, max_wait_ms=20) as srv:
        h = srv.load("m", block=net, example=tmx.nd.array(xs[0][None],
                                                          ctx=card))
        assert srv.warmup("m", xs[0]) == [1, 2, 4]
        assert h.captures == 3 and len(h.graph_keys()) == 3
        futs = [srv.submit("m", x) for x in xs]
        outs = [f.get(timeout=WAIT) for f in futs]
        assert h.captures == 3          # traffic only replays
        _e, params, _v = srv.registry.acquire("m")
        for x, y in zip(xs, outs):
            ref = h.jit_for(1)(params, torch.from_numpy(x[None]).cuda())
            assert y.tobytes() == ref.cpu().numpy()[0].tobytes()
            eager = _eager(net, x, card)
            np.testing.assert_allclose(y, eager, rtol=0, atol=1e-5)
        assert max(f.record["batch_size"] for f in futs) > 1


@pytest.mark.cuda
def test_card_swap_recaptures_and_eviction_drops_graphs(card):
    net = _mlp(ctx=card)
    xs = _card_requests(8, seed=41)
    with serving.Server(max_batch=2, max_wait_ms=20) as srv:
        h = srv.load("m", block=net, example=tmx.nd.array(xs[0][None],
                                                          ctx=card))
        srv.warmup("m", xs[0])
        assert h.captures == 2
        v1 = [srv.predict("m", x, timeout=WAIT) for x in xs[:2]]
        _fn, pv = net.serving_fn(tmx.nd.array(xs[0][None], ctx=card))
        assert srv.swap("m", {n: v.detach() * 2 for n, v in pv.items()}) == 2
        assert h.graph_keys() == []
        srv.warmup("m", xs[0])
        assert h.captures == 4          # one more per bucket used
        v2 = [srv.predict("m", x, timeout=WAIT) for x in xs[:2]]
        assert all(a.tobytes() != b.tobytes() for a, b in zip(v1, v2))
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        assert srv.registry.evict("m") and h.graph_keys() == []
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() < held     # weights freed
        again = [srv.predict("m", x, timeout=WAIT) for x in xs[:2]]
        assert [a.tobytes() for a in again] == [b.tobytes() for b in v2]
        assert h.version == 2 and h.captures == 5


@pytest.mark.cuda
def test_card_swap_during_a_first_capture(card):
    net = _mlp(ctx=card)
    x = _card_requests(1, seed=42)[0]
    with serving.Server(max_batch=8, max_wait_ms=5) as srv:
        h = srv.load("m", block=net, example=tmx.nd.array(x[None], ctx=card))
        _fn, pv = net.serving_fn(tmx.nd.array(x[None], ctx=card))
        new = {n: (v.detach() * 3).cpu() for n, v in pv.items()}
        errors, tickets = [], []

        def capture():
            try:
                srv.warmup("m", x)
            except Exception as exc:    # pragma: no cover - failure path
                errors.append(exc)

        t = threading.Thread(target=capture)
        t.start()
        while t.is_alive() and not tickets:
            tickets.append(srv.begin_swap("m", new))
        t.join(WAIT)
        assert not errors and tickets
        assert tickets[0].commit() == 2
        y = srv.predict("m", x, timeout=WAIT)
        _e, params, _v = srv.registry.acquire("m")
        ref = h.jit_for(1)(params, torch.from_numpy(x[None]).cuda())
        assert y.tobytes() == ref.cpu().numpy()[0].tobytes()


@pytest.mark.cuda
def test_card_failed_capture_raises(card):
    """A forward that waits for the card cannot be captured: the request
    fails with the capture's error; nothing runs eagerly instead."""
    code = (
        "import numpy as np, incubator_mxnet_tpu_torch as mx\n"
        "from incubator_mxnet_tpu_torch import gluon, serving\n"
        "class Sync(gluon.HybridBlock):\n"
        "    def hybrid_forward(self, F, x):\n"
        "        return x * float(x.asnumpy().sum())\n"
        "net = Sync(); net.initialize(ctx=mx.gpu(0))\n"
        "x = np.ones(4, np.float32)\n"
        "with serving.Server(max_batch=1) as srv:\n"
        "    h = srv.load('s', block=net, example=mx.nd.array(x[None],\n"
        "                 ctx=mx.gpu(0)))\n"
        "    try:\n"
        "        srv.predict('s', x, timeout=60)\n"
        "    except Exception as exc:\n"
        "        print('raised', type(exc).__name__, h.captures)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert "raised" in proc.stdout and proc.stdout.split()[-1] == "0", \
        proc.stdout + proc.stderr
