"""SLO telemetry of the serving runtime: per-request latency decomposition.

Counterpart of ``incubator_mxnet_tpu/serving/slo.py`` (:43-158).  Every
request's end-to-end wall time decomposes into FOUR components that sum
EXACTLY to the request wall:

* ``queue_wait``      — enqueue → picked into a batch by the dispatcher,
* ``batch_assembly``  — pick → padded batch built and copied to the device,
* ``device_compute``  — dispatch → the batch's program done on the device
                        (a CUDA event the host waits on; on the CPU the
                        eager forward's return),
* ``host_io``         — the residual: output rows copied to the host and
                        the response delivered.

``host_io = wall - (queue_wait + batch_assembly + device_compute)``
makes the sum exact by construction (IEEE: ``s + (wall - s) == wall``);
the first three are direct timestamp diffs of the request timeline.

Requests land in a ring of the last ``GRAFT_SERVE_RING`` (default 1024)
records; every batch completion republishes rolling p50/p99 gauges over
the ring (``graft_serve_latency_seconds{quantile=...}``) next to the
counters/histograms of ``telemetry/metrics.py`` (``graft_serve_*``).
"""
from __future__ import annotations

import os
import threading
from collections import deque

from ..telemetry import metrics as _tmetrics

__all__ = ["COMPONENTS", "decompose", "record_request", "record_batch",
           "requests", "quantiles", "component_quantile", "summary",
           "reset", "ring_size"]

COMPONENTS = ("queue_wait", "batch_assembly", "device_compute", "host_io")

_DEFAULT_RING = 1024


def ring_size():
    try:
        n = int(os.environ.get("GRAFT_SERVE_RING", str(_DEFAULT_RING)))
    except ValueError:
        return _DEFAULT_RING
    return max(n, 16)


_lock = threading.Lock()
_ring = deque(maxlen=ring_size())


def decompose(t_enq, t_pick, t_built, t_computed, t_done):
    """The request timeline → ``(wall_s, components)`` with the exact-sum
    contract: components are non-negative timestamp diffs except
    ``host_io``, the residual that makes the four sum to ``wall_s``
    bit-exactly."""
    wall = t_done - t_enq
    comp = {
        "queue_wait": max(t_pick - t_enq, 0.0),
        "batch_assembly": max(t_built - t_pick, 0.0),
        "device_compute": max(t_computed - t_built, 0.0),
    }
    s = comp["queue_wait"] + comp["batch_assembly"] + comp["device_compute"]
    comp["host_io"] = wall - s      # residual: sum == wall by construction
    return wall, comp


def record_request(model, version, wall_s, components, batch_size,
                   bucket, ok=True):
    """One finished request: ring + metrics.  Returns the record."""
    rec = {"model": model, "version": version, "wall_s": wall_s,
           "components": components, "batch_size": batch_size,
           "bucket": bucket, "ok": ok}
    with _lock:
        _ring.append(rec)
    _tmetrics.serve_request(model, wall_s, components)
    return rec


def record_batch(model, size, bucket):
    """One dispatched batch: size histogram + padding counter, then the
    rolling quantile gauges are refreshed from the ring."""
    _tmetrics.serve_batch(model, size, bucket)
    p50, p99 = quantiles()
    if p50 is not None:
        _tmetrics.serve_quantiles(p50, p99)


def requests():
    """The ring, oldest first (copies)."""
    with _lock:
        return [dict(r, components=dict(r["components"])) for r in _ring]


def _quantile(sorted_vals, q):
    if not sorted_vals:
        return None
    idx = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[idx]


def quantiles(records=None):
    """(p50_s, p99_s) over the ring (or an explicit record list)."""
    if records is None:
        with _lock:
            walls = [r["wall_s"] for r in _ring if r["ok"]]
    else:
        walls = [r["wall_s"] for r in records if r["ok"]]
    walls.sort()
    return _quantile(walls, 0.50), _quantile(walls, 0.99)


def component_quantile(component, q=0.99, records=None):
    """Quantile of ONE latency component over the ring's ok requests —
    e.g. ``component_quantile("queue_wait", 0.99)``.  None on an empty
    ring or unknown component."""
    if component not in COMPONENTS:
        return None
    if records is None:
        with _lock:
            vals = [r["components"][component] for r in _ring if r["ok"]]
    else:
        vals = [r["components"][component] for r in records if r["ok"]]
    vals.sort()
    return _quantile(vals, q)


def summary(records=None):
    """Aggregate view over the ring: count, mean/p50/p99 latency, mean
    per-component seconds, mean batch size."""
    recs = requests() if records is None else list(records)
    ok = [r for r in recs if r["ok"]]
    if not ok:
        return {"requests": len(recs), "ok": 0}
    p50, p99 = quantiles(ok)
    n = len(ok)
    return {
        "requests": len(recs),
        "ok": n,
        "mean_ms": round(sum(r["wall_s"] for r in ok) / n * 1e3, 3),
        "p50_ms": round(p50 * 1e3, 3),
        "p99_ms": round(p99 * 1e3, 3),
        "components_ms": {
            c: round(sum(r["components"][c] for r in ok) / n * 1e3, 3)
            for c in COMPONENTS},
        "mean_batch_size": round(sum(r["batch_size"] for r in ok) / n, 2),
    }


def reset():
    """Drop the ring (tests/benches)."""
    global _ring
    with _lock:
        _ring = deque(maxlen=ring_size())
