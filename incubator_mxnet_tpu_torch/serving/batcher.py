"""Dynamic batcher of the serving runtime: request queue → padded shape
bucket → ONE program.

Counterpart of ``incubator_mxnet_tpu/serving/batcher.py``.  Requests (one
example each) enqueue into per-``(model, input signature)`` queues; a
dispatcher thread assembles batches under two knobs —
``GRAFT_SERVE_MAX_BATCH`` (dispatch when a queue holds that many) and
``GRAFT_SERVE_MAX_WAIT_MS`` (dispatch whatever is there once the OLDEST
request has waited that long) — pads the batch to a power-of-two bucket
and runs the whole bucket as ONE program of the registry (a CUDA graph per
(model, weight version, example shape, bucket) on the card, replayed for
every batch of that signature).

**Bit-parity contract** (held against the bucket-1 program, the JAX
build's ``jit_for(1)``):

* within a signature it is STRUCTURAL in ``exact`` mode — row ``i`` of
  the bucket program is the bucket-1 forward of input row ``i``, so
  co-batched requests and padding rows can never perturb a result;
* across signatures in ``fused`` mode (a bucket-8 GEMM against the
  bucket-1 GEMM) cuBLAS may pick different kernels, so
  ``GRAFT_SERVE_PARITY=probe`` (default) bit-compares row 0 of each
  dispatch against the bucket-1 program on the same request; a mismatch
  demotes that (model, shape) to per-request dispatch and re-runs the
  batch per request, so a non-parity row is never delivered
  (``graft_serve_parity_fallbacks_total``).

The device edges: a batch is assembled in pinned host memory and copied
to the card without blocking on the serving stream; ``device_compute``
ends when the host has waited on an event recorded after the program, so
it marks device completion.  Output rows come back by the port's host
rule: bfloat16 as float32 (exact), as ``NDArray.asnumpy`` returns it.

The JAX build's flight-recorder journal and bracket, lens device ledger,
grafttsan regions, fault points, and the autotuner's registration and live
knobs (``set_max_batch``, ``set_max_wait_ms``, ``flush``) are not part of
this slice (ROADMAP item 12).
"""
from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from collections import OrderedDict, deque

import numpy as np
import torch

from ..telemetry import metrics as _tmetrics
from . import slo as _slo
from ..ndarray.ndarray import narrow_dtype
from .registry import on_serving_stream

__all__ = ["DynamicBatcher", "ServeFuture", "ServeError",
           "DeadlineExceededError", "serve_max_batch", "serve_max_wait_ms",
           "serve_deadline_ms", "parity_mode", "normalize_example",
           "request_signature"]

DEFAULT_MAX_BATCH = 32
DEFAULT_MAX_WAIT_MS = 5.0


def serve_deadline_ms():
    """GRAFT_SERVE_DEADLINE_MS: default per-request deadline (0/unset =
    none).  A request still queued when its deadline passes is SHED —
    failed with :class:`DeadlineExceededError` instead of dispatched — so
    an overloaded server spends device time only on work whose answer
    somebody still wants."""
    try:
        v = float(os.environ.get("GRAFT_SERVE_DEADLINE_MS", "0"))
    except ValueError:
        return None
    return v if v > 0 else None


def serve_max_batch():
    """GRAFT_SERVE_MAX_BATCH: dispatch a queue the moment it holds this
    many requests (default 32)."""
    try:
        n = int(os.environ.get("GRAFT_SERVE_MAX_BATCH",
                               str(DEFAULT_MAX_BATCH)))
    except ValueError:
        return DEFAULT_MAX_BATCH
    return max(n, 1)


def serve_max_wait_ms():
    """GRAFT_SERVE_MAX_WAIT_MS: dispatch whatever a queue holds once its
    oldest request has waited this long (default 5ms).  0 = dispatch
    immediately (batching only what piled up while the dispatcher was
    busy)."""
    try:
        v = float(os.environ.get("GRAFT_SERVE_MAX_WAIT_MS",
                                 str(DEFAULT_MAX_WAIT_MS)))
    except ValueError:
        return DEFAULT_MAX_WAIT_MS
    return max(v, 0.0)


def parity_mode():
    """GRAFT_SERVE_PARITY: ``probe`` (default) bit-checks batches against
    the bucket-1 program and demotes mismatching (model, shape)s to
    per-request dispatch; ``off`` trusts the bucket programs."""
    v = os.environ.get("GRAFT_SERVE_PARITY", "probe").strip().lower()
    return "off" if v in ("0", "off", "false", "no") else "probe"


class ServeError(RuntimeError):
    """A request failed (model error, shutdown, dispatch exception)."""


class DeadlineExceededError(ServeError):
    """The request's ``deadline_ms`` passed while it was still queued — it
    was shed, never dispatched.  Typed so callers can tell an overload
    rejection from a model failure and retry elsewhere."""

    def __init__(self, model, waited_ms):
        super().__init__(
            "request for model %r shed after %.1fms in queue "
            "(deadline exceeded)" % (model, waited_ms))
        self.model = model
        self.waited_ms = waited_ms


def _host_value(v):
    from ..ndarray import NDArray
    if isinstance(v, NDArray):
        return v.asnumpy()
    if isinstance(v, torch.Tensor):
        return NDArray(v).asnumpy()
    return v


def normalize_example(x):
    """One request input → tuple of np arrays (the form requests queue as
    and signatures key on).  Shared by ``DynamicBatcher.submit`` and
    ``Server.warmup`` so warmup captures EXACTLY the signatures production
    dispatches hit.  NDArrays and tensors come to the host by the port's
    rule (bfloat16 as float32)."""
    xs = x if isinstance(x, (tuple, list)) else (x,)
    return tuple(np.asarray(_host_value(v)) for v in xs)


def request_signature(xs):
    """The (shape, dtype) signature tuple of a normalized input."""
    return tuple((v.shape, str(v.dtype)) for v in xs)


def stack_inputs(rows, bucket, device):
    """The program's input tensors for a batch: each input's ``rows``
    (per-request host arrays) stacked and zero-padded to ``bucket`` rows,
    64-bit narrowed as the JAX build's ``jnp.asarray``.  For the card the
    batch is assembled in pinned memory and copied without blocking on the
    current stream (the caller's serving stream)."""
    cuda = device.type == "cuda"
    out = []
    for i in range(len(rows[0])):
        first = rows[0][i]
        buf = torch.from_numpy(np.zeros((bucket,) + first.shape,
                                        narrow_dtype(first.dtype)))
        if cuda:
            buf = buf.pin_memory()
        host = buf.numpy()
        for j, r in enumerate(rows):
            host[j] = r[i]
        out.append(buf.to(device, non_blocking=True) if cuda else buf)
    return out


def host_rows(t):
    """A program output on the host: bfloat16 as float32 (exact), as
    ``NDArray.asnumpy``."""
    t = t.detach()
    if t.dtype is torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def _bits(t):
    """The bytes of a tensor, as a uint8 tensor (bit-equality of any
    dtype, bfloat16 included; NaN payloads and -0.0 count)."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


class ServeFuture(object):
    """Handed back by :meth:`DynamicBatcher.submit`; resolves when the
    request's batch lands.  ``record`` carries the request's SLO
    decomposition after resolution."""

    __slots__ = ("_event", "_value", "_error", "record")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error = None
        self.record = None

    def done(self):
        return self._event.is_set()

    def get(self, timeout=None):
        """Block until the response is ready; returns the output row
        (np.ndarray, or a tuple for multi-output models)."""
        if not self._event.wait(timeout):
            raise TimeoutError("serving request still in flight")
        if self._error is not None:
            raise self._error
        return self._value

    def _resolve(self, value, record):
        self._value = value
        self.record = record
        self._event.set()

    def _fail(self, exc):
        self._error = exc if isinstance(exc, Exception) \
            else ServeError(str(exc))
        self._event.set()


class _Request(object):
    __slots__ = ("model", "xs", "future", "t_enq", "t_pick", "t_built",
                 "t_computed", "t_deadline")

    def __init__(self, model, xs, deadline_ms=None):
        self.model = model
        self.xs = xs                # tuple of per-input np arrays
        self.future = ServeFuture()
        self.t_enq = time.perf_counter()
        self.t_pick = self.t_built = self.t_computed = None
        if deadline_ms is None:
            deadline_ms = serve_deadline_ms()
        self.t_deadline = None if deadline_ms is None \
            else self.t_enq + float(deadline_ms) / 1e3


def _bucket_for(n, max_batch):
    """Smallest power-of-two ≥ n, capped at max_batch — the program set
    stays O(log max_batch) per shape."""
    b = 1
    while b < n and b < max_batch:
        b <<= 1
    return min(b, max_batch)


class DynamicBatcher(object):
    """The request queue + dispatcher thread.  One instance serves every
    model of its :class:`~incubator_mxnet_tpu_torch.serving.ModelRegistry`.

    Thread-safety: one condition variable guards the queues.  The
    dispatcher is a daemon thread with an explicit shutdown path
    (:meth:`close` — drains the queues, then joins)."""

    def __init__(self, registry, max_batch=None, max_wait_ms=None):
        self._registry = registry
        self._max_batch = serve_max_batch() if max_batch is None \
            else max(int(max_batch), 1)
        wait_ms = serve_max_wait_ms() if max_wait_ms is None \
            else max(float(max_wait_ms), 0.0)
        self._max_wait = wait_ms / 1e3
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queues = OrderedDict()    # key -> deque[_Request]
        self._depth = 0
        self._closed = False
        self._thread = None
        self._batch_seq = itertools.count(1)
        self.batches_total = 0
        self.requests_total = 0

    # -- submission ----------------------------------------------------------
    def submit(self, model, x, deadline_ms=None):
        """Enqueue ONE example for ``model``; returns a
        :class:`ServeFuture`.  ``x`` is a single input (np/NDArray/tensor)
        or a tuple for multi-input models; the model's forward sees it
        stacked under a leading batch axis.  ``deadline_ms`` (default
        GRAFT_SERVE_DEADLINE_MS) bounds queue time: a request still
        undispatched when it expires is shed with
        :class:`DeadlineExceededError` and counted in
        ``graft_serve_shed_total``."""
        xs = normalize_example(x)
        req = _Request(model, xs, deadline_ms=deadline_ms)
        key = (model, request_signature(xs))
        with self._cv:
            if self._closed:
                raise ServeError("batcher is closed")
            self._queues.setdefault(key, deque()).append(req)
            self._depth += 1
            self.requests_total += 1
            _tmetrics.serve_queue_depth(self._depth)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name="graftserve-batcher",
                    daemon=True)
                self._thread.start()
            self._cv.notify()
        return req.future

    # -- the dispatcher loop -------------------------------------------------
    def _loop(self):
        while True:
            with self._cv:
                batch = None
                while not self._closed:
                    now = time.perf_counter()
                    batch, deadline = self._pick_locked(now)
                    if batch is not None:
                        break
                    timeout = None if deadline is None \
                        else max(deadline - now, 0.0)
                    self._cv.wait(timeout)
                if batch is None and self._closed:
                    # drain whatever is left, then exit
                    batch, _ = self._pick_locked(time.perf_counter(),
                                                 drain=True)
                    if batch is None:
                        return
            try:
                self._dispatch(batch)
            except Exception as exc:    # the dispatcher thread must survive
                # ANY dispatch bug: fail the batch's futures instead of
                # dying with them unresolved
                for r in batch:
                    if not r.future.done():
                        r.future._fail(exc)
                logging.getLogger("graftserve").exception(
                    "dispatch failed outside the batch error path")

    def _shed_locked(self, now):
        """Load shedding: fail every queued request whose deadline passed
        (typed :class:`DeadlineExceededError`, counted in
        ``graft_serve_shed_total``).  Returns the earliest LIVE deadline so
        the dispatcher's wait wakes in time to shed the next expiry."""
        earliest = None
        shed = []
        for key in list(self._queues):
            q = self._queues[key]
            keep = deque()
            for r in q:
                if r.t_deadline is not None and now >= r.t_deadline:
                    shed.append(r)
                else:
                    keep.append(r)
                    if r.t_deadline is not None:
                        earliest = r.t_deadline if earliest is None \
                            else min(earliest, r.t_deadline)
            if len(keep) != len(q):
                if keep:
                    self._queues[key] = keep
                else:
                    del self._queues[key]
        if shed:
            self._depth -= len(shed)
            for r in shed:
                waited = (now - r.t_enq) * 1e3
                r.future._fail(DeadlineExceededError(r.model, waited))
                _tmetrics.serve_shed(r.model)
        return earliest

    def _pick_locked(self, now, drain=False):
        """Choose the ripest ready queue (full, expired or draining);
        returns (requests, next_deadline)."""
        shed_wake = self._shed_locked(now)
        best_key = None
        best_enq = None
        deadline = shed_wake
        for key, q in self._queues.items():
            if not q:
                continue
            head = q[0].t_enq
            ready = (len(q) >= self._max_batch or drain
                     or now - head >= self._max_wait)
            if ready:
                if best_enq is None or head < best_enq:
                    best_key, best_enq = key, head
            else:
                d = head + self._max_wait
                deadline = d if deadline is None else min(deadline, d)
        if best_key is None:
            return None, deadline
        q = self._queues[best_key]
        batch = [q.popleft() for _ in range(min(len(q), self._max_batch))]
        if not q:
            del self._queues[best_key]
        self._depth -= len(batch)
        _tmetrics.serve_queue_depth(self._depth)
        t_pick = time.perf_counter()
        for r in batch:
            r.t_pick = t_pick
        return batch, None

    # -- dispatch ------------------------------------------------------------
    def _dispatch(self, reqs):
        model = reqs[0].model
        bid = next(self._batch_seq)
        try:
            entry, params, version = self._registry.acquire(model)
        except Exception as exc:
            self._fail_batch(reqs, exc, model, bid)
            return
        sig = request_signature(reqs[0].xs)
        if sig in entry.no_batch and len(reqs) > 1:
            # parity-demoted signature: per-request dispatch, still one
            # program each — bit-identical to the bucket-1 path
            for r in reqs:
                self._run_batch([r], entry, params, version, bid,
                                demoted=True)
                bid = next(self._batch_seq)
            return
        self._run_batch(reqs, entry, params, version, bid)

    def _run_batch(self, reqs, entry, params, version, bid, demoted=False):
        model = reqs[0].model
        n = len(reqs)
        bucket = _bucket_for(n, self._max_batch)
        sig = request_signature(reqs[0].xs)
        device = entry.device
        try:
            program = entry.jit_for(bucket)
            # one stream for uploads, replays and downloads: the host's
            # order is the device's
            with on_serving_stream(device):
                # assembly: stack + pad to the bucket, then to the device
                xvals = stack_inputs([r.xs for r in reqs], bucket, device)
                t_built = time.perf_counter()
                for r in reqs:
                    r.t_built = t_built
                out = program(params, *xvals)
                outs = out if isinstance(out, tuple) else (out,)
                if device.type == "cuda":
                    done = torch.cuda.Event()
                    done.record()
                    done.synchronize()
            t_computed = time.perf_counter()
            for r in reqs:
                r.t_computed = t_computed
            if self._maybe_probe(model, sig, bucket, entry, params, xvals,
                                 outs):
                # probe mismatch: discard the batched result and re-run
                # THIS batch per request too — a demoted signature never
                # delivers a non-parity row, not even its first batch
                for r in reqs:
                    self._run_batch([r], entry, params, version,
                                    next(self._batch_seq), demoted=True)
                return
            # host_io: rows out of the device result, futures resolved
            host_outs = [host_rows(o) for o in outs]
            single = not isinstance(out, tuple)
            for j, r in enumerate(reqs):
                row = tuple(o[j] for o in host_outs)
                value = row[0] if single else row
                t_done = time.perf_counter()
                wall, comp = _slo.decompose(r.t_enq, r.t_pick, r.t_built,
                                            r.t_computed, t_done)
                rec = _slo.record_request(model, version, wall, comp,
                                          batch_size=n, bucket=bucket)
                r.future._resolve(value, rec)
            self.batches_total += 1
            _slo.record_batch(model, n, bucket)
        except Exception as exc:
            self._fail_batch(reqs, exc, model, bid)

    def _maybe_probe(self, model, sig, bucket, entry, params, xvals, outs):
        """``GRAFT_SERVE_PARITY=probe``: row 0 of the batched dispatch must
        be bit-equal to the bucket-1 program on the same request.  In
        ``exact`` mode the clean verdict is cached per (sig, bucket) —
        parity there is structural, one probe per signature proves the
        wiring.  In ``fused`` mode kernel choice can depend on the values'
        layout, so every dispatch is spot-checked (row 0).  Verdicts live
        on the handle: they survive hot-swaps (same program) and die with
        re-registration.  Returns True when the dispatch mismatched and the
        signature was demoted to per-request dispatch."""
        if bucket <= 1 or parity_mode() == "off":
            return False
        from .registry import serve_batch_mode
        cacheable = serve_batch_mode() == "exact"
        if (cacheable and (sig, bucket) in entry.parity_ok) \
                or sig in entry.no_batch:
            return False
        ref = entry.jit_for(1)(params, *[v[:1] for v in xvals])
        refs = ref if isinstance(ref, tuple) else (ref,)
        for r, o in zip(refs, outs):
            if not torch.equal(_bits(r[:1]), _bits(o[:1])):
                entry.no_batch.add(sig)
                _tmetrics.serve_parity_fallback(model)
                logging.getLogger("graftserve").warning(
                    "parity probe: batched output of model %r (bucket %d) "
                    "differs from the bucket-1 program — demoting this "
                    "shape to per-request dispatch", model, bucket)
                return True
        if cacheable:
            entry.parity_ok.add((sig, bucket))
        return False

    def _fail_batch(self, reqs, exc, model, bid):
        _tmetrics.serve_errors(model, len(reqs))
        for r in reqs:
            r.future._fail(exc)

    # -- lifecycle -----------------------------------------------------------
    @property
    def queue_depth(self):
        return self._depth

    def close(self):
        """Shut the dispatcher down: queued requests are drained
        (dispatched), then the thread joins.  Idempotent."""
        with self._cv:
            if self._closed:
                thread = None
            else:
                self._closed = True
                thread = self._thread
            self._cv.notify_all()
        if thread is not None:
            thread.join(timeout=30.0)
        # no thread ever started (or it exited early): drain inline
        while True:
            with self._cv:
                batch, _ = self._pick_locked(time.perf_counter(),
                                             drain=True)
            if batch is None:
                break
            self._dispatch(batch)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
