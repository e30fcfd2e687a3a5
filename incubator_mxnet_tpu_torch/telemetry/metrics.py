"""Metrics registry: Counter / Gauge / Histogram with labels.

Counterpart of ``incubator_mxnet_tpu/telemetry/metrics.py`` (plain Python
there too, kept here as the port's own copy): the registry core (:1-392),
its two expositions, :meth:`MetricsRegistry.snapshot` (JSON-able) and
:meth:`MetricsRegistry.prometheus_text` (round-trippable through
:func:`parse_prometheus_text`), :func:`compact_snapshot` and
:func:`write_snapshot`, and the serving runtime's ``graft_serve_*``
catalog (:897-1007, :1129).  The catalog entries of the engine, kvstore,
io, autograd, device memory, lens, tsan, armor and elastic subsystems wait
for those subsystems.  ``GRAFT_TELEMETRY=0`` turns every increment into a
no-op.
"""
from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
           "enabled", "set_enabled", "parse_prometheus_text",
           "compact_snapshot", "write_snapshot"]

_enabled_override = None


def set_enabled(flag):
    """Force telemetry on/off (None = defer to GRAFT_TELEMETRY)."""
    global _enabled_override
    _enabled_override = flag


def enabled():
    if _enabled_override is not None:
        return bool(_enabled_override)
    return os.environ.get("GRAFT_TELEMETRY", "1").strip().lower() \
        not in ("0", "false", "no", "off")


def _label_key(labelnames, labels):
    if set(labels) != set(labelnames):
        raise ValueError("expected labels %s, got %s"
                         % (list(labelnames), sorted(labels)))
    return tuple(str(labels[n]) for n in labelnames)


class _Metric(object):
    kind = "untyped"

    def __init__(self, name, help="", labelnames=()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._series = {}          # label-value tuple -> sample
        self._lock = threading.Lock()

    def _sample(self, labels):
        key = _label_key(self.labelnames, labels)
        s = self._series.get(key)
        if s is None:
            with self._lock:
                s = self._series.setdefault(key, self._new_sample())
        return s

    def clear(self):
        with self._lock:
            self._series.clear()

    def labels_of(self, key):
        return dict(zip(self.labelnames, key))

    def samples(self):
        """[(labels dict, sample payload)] — payload shape is per-kind.

        The export runs UNDER the lock: a histogram payload reads
        several list slots, and exporting outside the lock let a
        concurrent ``observe`` tear the snapshot (bucket counts from
        one observation, sum from the next) — the watchdog samples from
        a background thread, so snapshots must be self-consistent."""
        with self._lock:
            return [(self.labels_of(k), self._export(s))
                    for k, s in self._series.items()]


class Counter(_Metric):
    """Monotonic counter (per label set)."""

    kind = "counter"

    def _new_sample(self):
        return [0.0]

    def inc(self, value=1, **labels):
        if not enabled():
            return
        if value < 0:
            raise ValueError("counters only go up (got %r)" % value)
        s = self._sample(labels)
        with self._lock:
            s[0] += value

    def set(self, value, **labels):
        """Collector-side absolute set (for mirroring external counters)."""
        if not enabled():
            return
        s = self._sample(labels)
        with self._lock:
            s[0] = float(value)

    def value(self, **labels):
        return self._sample(labels)[0]

    def _export(self, s):
        return s[0]


class Gauge(_Metric):
    """Point-in-time value (per label set)."""

    kind = "gauge"

    def _new_sample(self):
        return [0.0]

    def set(self, value, **labels):
        if not enabled():
            return
        s = self._sample(labels)
        with self._lock:
            s[0] = float(value)

    def inc(self, value=1, **labels):
        if not enabled():
            return
        s = self._sample(labels)
        with self._lock:
            s[0] += value

    def dec(self, value=1, **labels):
        self.inc(-value, **labels)

    def value(self, **labels):
        return self._sample(labels)[0]

    def _export(self, s):
        return s[0]


_DEFAULT_BUCKETS = (0.0001, 0.001, 0.01, 0.1, 1.0, 10.0)


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics: each bucket
    counts observations ≤ its upper bound; +Inf is implicit)."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), buckets=_DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def _new_sample(self):
        # [counts per bucket..., +Inf count, sum]
        return [0] * (len(self.buckets) + 1) + [0.0]

    def observe(self, value, **labels):
        if not enabled():
            return
        s = self._sample(labels)
        with self._lock:
            for i, b in enumerate(self.buckets):
                if value <= b:
                    s[i] += 1
            s[len(self.buckets)] += 1      # +Inf
            s[-1] += value

    def _export(self, s):
        return {"buckets": {("%g" % b): s[i]
                            for i, b in enumerate(self.buckets)},
                "count": s[len(self.buckets)],
                "sum": s[-1]}


class MetricsRegistry(object):
    """Named metric store + pull-collectors + expositions."""

    def __init__(self):
        self._metrics = {}
        self._collectors = []
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, labelnames, **kw)
                self._metrics[name] = m
                return m
        if type(m) is not cls or m.labelnames != tuple(labelnames):
            raise ValueError("metric %r re-registered with a different "
                             "kind/labels" % name)
        return m

    def counter(self, name, help="", labelnames=()):
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()):
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=_DEFAULT_BUCKETS):
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def register_collector(self, fn):
        """``fn(registry)`` runs before every snapshot/exposition — the
        pull path for gauges sampled from live state (device memory,
        autograd tape size)."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def _collect(self):
        for fn in list(self._collectors):
            try:
                fn(self)
            except Exception:
                pass        # a broken collector must not kill exposition

    def metrics(self):
        with self._lock:
            return list(self._metrics.values())

    def reset(self, prefix=None):
        """Zero every series (or only metrics whose name starts with
        ``prefix``) — keeps registrations and collectors."""
        for m in self.metrics():
            if prefix is None or m.name.startswith(prefix):
                m.clear()

    def snapshot(self, collect=True):
        """JSON-able dict of everything the registry holds."""
        if collect:
            self._collect()
        out = {}
        for m in self.metrics():
            out[m.name] = {
                "kind": m.kind,
                "help": m.help,
                "samples": [{"labels": labels, "value": payload}
                            for labels, payload in m.samples()],
            }
        return out

    def prometheus_text(self, collect=True):
        """Prometheus text exposition format v0.0.4."""
        if collect:
            self._collect()
        lines = []
        for m in sorted(self.metrics(), key=lambda m: m.name):
            lines.append("# HELP %s %s" % (m.name, m.help or m.name))
            lines.append("# TYPE %s %s" % (m.name, m.kind))
            for labels, payload in m.samples():
                if m.kind == "histogram":
                    for le, cnt in payload["buckets"].items():
                        lines.append("%s_bucket%s %s" % (
                            m.name, _fmt_labels(labels, le=le), _fmt(cnt)))
                    lines.append("%s_bucket%s %s" % (
                        m.name, _fmt_labels(labels, le="+Inf"),
                        _fmt(payload["count"])))
                    lines.append("%s_sum%s %s" % (
                        m.name, _fmt_labels(labels), _fmt(payload["sum"])))
                    lines.append("%s_count%s %s" % (
                        m.name, _fmt_labels(labels), _fmt(payload["count"])))
                else:
                    lines.append("%s%s %s" % (m.name, _fmt_labels(labels),
                                              _fmt(payload)))
        return "\n".join(lines) + "\n"


def _fmt(v):
    f = float(v)
    return ("%d" % int(f)) if f == int(f) else repr(f)


def _fmt_labels(labels, **extra):
    items = list(labels.items()) + list(extra.items())
    if not items:
        return ""
    body = ",".join('%s="%s"' % (k, str(v).replace("\\", "\\\\")
                                 .replace('"', '\\"').replace("\n", "\\n"))
                    for k, v in items)
    return "{%s}" % body


def parse_prometheus_text(text):
    """Parse the text exposition back into
    ``{metric_name: {frozenset(label items): value}}`` — the inverse used
    by the round-trip tests (histogram series appear under their
    ``_bucket``/``_sum``/``_count`` sample names, as on the wire)."""
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "{" in line:
            name, rest = line.split("{", 1)
            labelstr, value = rest.rsplit("}", 1)
            labels = {}
            for part in _split_labels(labelstr):
                k, v = part.split("=", 1)
                v = v.strip()
                if len(v) >= 2 and v[0] == '"' and v[-1] == '"':
                    v = v[1:-1]
                labels[k] = _unescape(v)
        else:
            name, value = line.rsplit(" ", 1)
            labels = {}
        out.setdefault(name.strip(), {})[
            frozenset(labels.items())] = float(value)
    return out


_UNESCAPES = {"n": "\n", "\\": "\\", '"': '"'}


def _unescape(v):
    """Left-to-right escape decoding — sequential str.replace passes
    corrupt values like a literal backslash followed by 'n'."""
    out = []
    i = 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append(_UNESCAPES.get(nxt, "\\" + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _split_labels(s):
    parts, buf, in_q, esc = [], [], False, False
    for ch in s:
        if esc:
            buf.append(ch)
            esc = False
        elif ch == "\\":
            buf.append(ch)
            esc = True
        elif ch == '"':
            buf.append(ch)
            in_q = not in_q
        elif ch == "," and not in_q:
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    if buf:
        parts.append("".join(buf))
    return [p for p in parts if p.strip()]


# ---------------------------------------------------------------------------
# default registry + the graft_serve_* metric catalog
# ---------------------------------------------------------------------------

_REGISTRY = MetricsRegistry()


def registry():
    """The process-wide default registry."""
    return _REGISTRY


# -- graftserve: production serving runtime -----------------------------------

_SERVE_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
_SERVE_LATENCY_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5,
                          1.0, 5.0)


def serve_request(model, wall_s, components):
    """One completed serving request: per-request latency + the four-way
    decomposition (queue_wait/batch_assembly/device_compute/host_io,
    serving/slo.py — the components sum EXACTLY to ``wall_s``)."""
    if not enabled():
        return
    r = _REGISTRY
    r.counter("graft_serve_requests_total",
              "Serving requests completed", ("model",)).inc(model=model)
    r.histogram("graft_serve_request_seconds",
                "End-to-end request latency (enqueue to response ready)",
                ("model",), buckets=_SERVE_LATENCY_BUCKETS).observe(
        wall_s, model=model)
    h = r.histogram("graft_serve_component_seconds",
                    "Per-request latency by SLO component", ("component",),
                    buckets=_SERVE_LATENCY_BUCKETS)
    for c, v in components.items():
        h.observe(v, component=c)


def serve_quantiles(p50_s, p99_s):
    """Rolling-window latency quantiles (serving/slo.py recomputes them
    over the request ring after every batch)."""
    if not enabled():
        return
    g = _REGISTRY.gauge("graft_serve_latency_seconds",
                        "Rolling request-latency quantiles over the last "
                        "GRAFT_SERVE_RING requests", ("quantile",))
    g.set(p50_s, quantile="p50")
    g.set(p99_s, quantile="p99")


def serve_batch(model, size, bucket):
    """One dispatched serving batch: ``size`` real requests padded to
    the ``bucket`` compiled batch signature."""
    if not enabled():
        return
    r = _REGISTRY
    r.counter("graft_serve_batches_total",
              "Serving batches dispatched", ("model",)).inc(model=model)
    r.histogram("graft_serve_batch_size",
                "Real requests per dispatched batch", (),
                buckets=_SERVE_BATCH_BUCKETS).observe(size)
    if bucket > size:
        r.counter("graft_serve_padding_rows_total",
                  "Padding rows dispatched to reach a batch bucket").inc(
            bucket - size)


def serve_queue_depth(depth):
    """Requests currently queued across all models (set on every
    enqueue/pick)."""
    if not enabled():
        return
    _REGISTRY.gauge("graft_serve_queue_depth",
                    "Requests waiting in the dynamic batcher").set(depth)


def serve_errors(model, n=1):
    """Requests failed by a dispatch/model error."""
    if not enabled():
        return
    _REGISTRY.counter("graft_serve_errors_total",
                      "Serving requests failed", ("model",)).inc(
        n, model=model)


def serve_model_event(kind):
    """Registry lifecycle tick: ``load``/``reload``/``evict``/``swap``/
    ``unload`` (serving/registry.py)."""
    if not enabled():
        return
    _REGISTRY.counter("graft_serve_model_events_total",
                      "Model registry lifecycle events (load/reload/"
                      "evict/swap/unload)", ("kind",)).inc(kind=kind)


def serve_residency(resident_bytes, resident_models, budget_bytes):
    """Registry residency snapshot after every load/evict/swap."""
    if not enabled():
        return
    r = _REGISTRY
    r.gauge("graft_serve_resident_bytes",
            "Model weight bytes resident in the serving registry").set(
        resident_bytes)
    r.gauge("graft_serve_resident_models",
            "Models with resident weights in the serving registry").set(
        resident_models)
    # always published (0 = unlimited) so an unlimited registry can't
    # inherit a stale budget value from an earlier bounded one
    r.gauge("graft_serve_memory_budget_bytes",
            "GRAFT_SERVE_MEMORY_BYTES residency budget (0 = "
            "unlimited)").set(budget_bytes)


def serve_parity_fallback(model):
    """One (model, shape, bucket) signature demoted to per-request
    dispatch because its batched output failed the bit-parity probe."""
    if not enabled():
        return
    _REGISTRY.counter("graft_serve_parity_fallbacks_total",
                      "Batch signatures demoted to per-request dispatch "
                      "by the parity probe", ("model",)).inc(model=model)


def serve_shed(model, n=1):
    """Requests shed by the batcher because their deadline expired
    before dispatch (serving/batcher.py load shedding)."""
    if not enabled():
        return
    _REGISTRY.counter("graft_serve_shed_total",
                      "Serving requests shed at dispatch because their "
                      "deadline_ms had already expired", ("model",)).inc(
        n, model=model)


def compact_snapshot(reg=None):
    """Flat ``{"name{label=v}": value}`` view (histograms export their
    ``_count``/``_sum``) — the form the benches embed in BENCH JSON."""
    reg = reg or _REGISTRY
    out = {}
    reg._collect()
    for m in reg.metrics():
        for labels, payload in m.samples():
            key = m.name + _fmt_labels(labels)
            if m.kind == "histogram":
                out[m.name + "_count" + _fmt_labels(labels)] = \
                    payload["count"]
                out[m.name + "_sum" + _fmt_labels(labels)] = \
                    round(payload["sum"], 6)
            else:
                out[key] = payload
    return out


def write_snapshot(path, reg=None):
    """Dump the JSON snapshot to ``path`` (GRAFT_TELEMETRY_SNAPSHOT)."""
    reg = reg or _REGISTRY
    with open(path, "w") as f:
        json.dump(reg.snapshot(), f, indent=2, sort_keys=True)
    return path
