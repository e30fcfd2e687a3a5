"""The serving runtime (counterpart of ``incubator_mxnet_tpu/serving/``).

Turns a :class:`~incubator_mxnet_tpu_torch.gluon.HybridBlock` into a
production predictor:

* :class:`DynamicBatcher` — thread-safe request queue; batches assemble
  under ``GRAFT_SERVE_MAX_BATCH`` / ``GRAFT_SERVE_MAX_WAIT_MS``, pad to
  power-of-two shape buckets and run as ONE program, with a bit-parity
  probe against the bucket-1 program (serving/batcher.py);
* :class:`ModelRegistry` — multi-model weight residency under
  ``GRAFT_SERVE_MEMORY_BYTES`` with LRU eviction and versioned hot-swap;
  on the card each (model, weight version, example shape, bucket) is a
  CUDA graph captured once and replayed per batch (serving/registry.py);
* SLO telemetry — per-request queue_wait/batch_assembly/device_compute/
  host_io decomposition with an exact-sum conservation contract and the
  ``graft_serve_*`` metrics incl. rolling p50/p99 gauges (serving/slo.py);
* ``python -m incubator_mxnet_tpu_torch.serving --selftest`` — the smoke
  of all of it, on the card unless ``--device cpu``.

:class:`Server` bundles the three::

    srv = serving.Server(max_wait_ms=2)
    srv.load("lm", block=net, example=example_x)
    srv.warmup("lm", one_request)           # capture the bucket programs
    fut = srv.submit("lm", x)               # ServeFuture
    y = fut.get(timeout=1.0)
    srv.swap("lm", new_params)              # hot-swap, no torn weights
    srv.close()

The model runs where its parameters live.  Output rows come back as numpy
arrays, bfloat16 as float32 (exact), as ``NDArray.asnumpy`` returns them.
"""
from __future__ import annotations

from .batcher import (DynamicBatcher, ServeFuture, ServeError,
                      DeadlineExceededError, serve_max_batch,
                      serve_max_wait_ms, serve_deadline_ms, parity_mode,
                      normalize_example, request_signature, stack_inputs)
from .registry import (ModelRegistry, ModelHandle, SwapTicket, Program,
                       serve_memory_bytes, serve_batch_mode,
                       default_registry, on_serving_stream)
from . import loader
from . import slo

__all__ = ["Server", "DynamicBatcher", "ServeFuture", "ServeError",
           "DeadlineExceededError", "ModelRegistry", "ModelHandle",
           "SwapTicket", "Program", "loader", "slo", "serve_max_batch",
           "serve_max_wait_ms", "serve_deadline_ms", "serve_memory_bytes",
           "serve_batch_mode", "parity_mode", "default_registry"]


class Server(object):
    """Registry + batcher in one object — the serving runtime."""

    def __init__(self, memory_bytes=None, max_batch=None, max_wait_ms=None,
                 registry=None):
        self.registry = registry if registry is not None \
            else ModelRegistry(memory_bytes)
        self.batcher = DynamicBatcher(self.registry, max_batch=max_batch,
                                      max_wait_ms=max_wait_ms)

    # -- model lifecycle -----------------------------------------------------
    def load(self, name, block=None, example=None, module=None,
             symbol=None, params=None, symbol_json=None, param_bytes=None,
             input_shapes=None, input_names=None):
        """Register a model from ``block`` (+ ``example``, one input with its
        batch axis).  The ``module=``, ``symbol=`` and ``symbol_json=``
        sources raise ``NotImplementedError`` in this slice (ROADMAP item
        5)."""
        if block is not None:
            return self.registry.load_block(name, block, example)
        if module is not None:
            return self.registry.load_module(name, module)
        if symbol is not None:
            return self.registry.load_symbol(
                name, symbol, params, input_shapes=input_shapes,
                input_names=input_names)
        if symbol_json is not None:
            return self.registry.load_bytes(name, symbol_json, param_bytes,
                                            input_shapes)
        raise ValueError("pass one of block=, module=, symbol=, "
                         "symbol_json=")

    def swap(self, name, new_params):
        """Hot-swap ``name`` to a new weight version (copies in on a side
        stream, flips atomically; in-flight requests keep the old
        version)."""
        return self.registry.swap(name, new_params)

    def begin_swap(self, name, new_params):
        return self.registry.begin_swap(name, new_params)

    # -- serving -------------------------------------------------------------
    def submit(self, name, x, deadline_ms=None):
        """Enqueue one example; returns a :class:`ServeFuture`.
        ``deadline_ms`` (default GRAFT_SERVE_DEADLINE_MS) bounds queue
        time — an expired request is shed with
        :class:`~.batcher.DeadlineExceededError`."""
        return self.batcher.submit(name, x, deadline_ms=deadline_ms)

    def predict(self, name, x, timeout=30.0):
        """Synchronous convenience: submit + get."""
        return self.submit(name, x).get(timeout)

    def warmup(self, name, example, buckets=None):
        """Capture the (shape, bucket) programs for ``example`` (one request,
        without its batch axis) off the hot path, so production dispatches
        only replay: one direct call per bucket (and its parity probe).
        Returns the buckets."""
        xs = normalize_example(example)     # the submit() normalization,
        sig = request_signature(xs)         # so warmup captures EXACTLY
        #                                     the production signatures
        entry, params, _version = self.registry.acquire(name)
        if buckets is None:
            buckets, b = [], 1
            while b < self.batcher._max_batch:
                buckets.append(b)
                b <<= 1
            buckets.append(self.batcher._max_batch)
        for b in sorted(set(buckets)):
            with on_serving_stream(entry.device):
                batched = stack_inputs([xs] * b, b, entry.device)
                out = entry.jit_for(b)(params, *batched)
            outs = out if isinstance(out, tuple) else (out,)
            self.batcher._maybe_probe(name, sig, b, entry, params,
                                      batched, outs)
        return buckets

    # -- lifecycle -----------------------------------------------------------
    def stats(self):
        return {
            "registry": self.registry.stats(),
            "queue_depth": self.batcher.queue_depth,
            "batches": self.batcher.batches_total,
            "requests": self.batcher.requests_total,
            "slo": slo.summary(),
        }

    def close(self):
        self.batcher.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

