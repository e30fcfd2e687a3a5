"""Observability (counterpart of ``incubator_mxnet_tpu/telemetry/``).

This slice ports :mod:`~incubator_mxnet_tpu_torch.telemetry.metrics`, the
process-wide Counter/Gauge/Histogram registry with JSON snapshot and
Prometheus text expositions, which the serving runtime reports into
(``graft_serve_*``).  The flight recorder, watchdog, lens, tracing and
cross-rank aggregation wait for their own slice (ROADMAP item 12).
``GRAFT_TELEMETRY=0`` disables metric collection.
"""
from __future__ import annotations

from . import metrics  # noqa: F401
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,  # noqa: F401
                      compact_snapshot, enabled, parse_prometheus_text,
                      registry, set_enabled, write_snapshot)
