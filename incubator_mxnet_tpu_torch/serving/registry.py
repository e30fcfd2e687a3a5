"""Serving model registry: multi-model weight residency with LRU eviction,
versioned hot-swap, and one program per (model, weight version, bucket).

Counterpart of ``incubator_mxnet_tpu/serving/registry.py``.  A
:class:`ModelRegistry` owns N models.  Each model is ``(fn, params,
version)``: one pure forward (serving/loader.py) and the weight tensors,
the RESIDENCY UNIT.

* **Programs** — where the JAX build jits ``fn`` and passes ``params`` per
  call, a CUDA graph bakes in the addresses of the tensors it was captured
  with.  So :meth:`ModelHandle.jit_for` returns a :class:`Program` whose
  CUDA graphs are keyed by batch bucket, input signature and weight set
  (a version's tensors): captured at first use (or by ``Server.warmup``)
  on the dispatching thread, replayed for every later batch.  A new
  version is captured at its first dispatch; a commit, an eviction or an
  unload drops the handle's graphs with the weights they hold.  All of a
  handle's graphs share one memory pool, so their replays (and the copies
  out of their outputs) are serialized by a lock per handle on one serving
  stream per device.  ``ModelHandle.captures`` counts captures (and
  ``capture_log`` times each).  A failed
  capture raises: nothing falls back to eager on the card.  On the CPU a
  program is the eager function.

* **Budget** — ``GRAFT_SERVE_MEMORY_BYTES`` (0/unset = unlimited; the
  constructor's ``memory_bytes`` overrides) over weight bytes, as the
  JAX build's ``_nbytes``.  Loading or reloading past the budget evicts
  least-recently-USED models first.  An evicted model keeps a host copy of
  its weights (pinned, in their own dtype, bf16 included); the next request
  reloads that copy transparently, bit for bit, at the same version.

* **Hot-swap** — :meth:`begin_swap` copies the new weights from pinned
  host memory to the device on a side stream while the OLD version keeps
  serving; :meth:`SwapTicket.commit` waits for the copy's event on the host
  and flips the model's ``(params, version)`` pair atomically under the
  registry lock.  A dispatch snapshots the pair under the same lock, so
  every response is entirely old-version or entirely new-version.

The JAX build's grafttsan region hooks are not part of this slice
(ROADMAP item 12).
"""
from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager

import torch

from ..telemetry import metrics as _tmetrics
from . import loader as _loader

__all__ = ["ModelRegistry", "ModelHandle", "SwapTicket", "Program",
           "serve_memory_bytes", "serve_batch_mode", "default_registry",
           "serving_stream", "on_serving_stream"]


def serve_memory_bytes():
    """GRAFT_SERVE_MEMORY_BYTES: registry residency budget in bytes
    (0 or unset = unlimited)."""
    try:
        return int(os.environ.get("GRAFT_SERVE_MEMORY_BYTES", "0"))
    except ValueError:
        return 0


def serve_batch_mode():
    """GRAFT_SERVE_BATCH_MODE: how a padded bucket becomes one program.

    * ``exact`` (default) — the bucket program is B batch-1 forwards,
      concatenated, in one program (one CUDA graph): each row IS the
      bucket-1 forward, so the batched result reproduces the bucket-1
      program bit for bit by construction;
    * ``fused`` — the bucket program runs over the (B,)+shape batch at
      once (true batched GEMMs).  cuBLAS, like XLA, may pick kernels by
      the batch size whose results differ by ULPs from the bucket-1
      forward; the batcher's parity probe demotes any (model, shape) where
      that happens."""
    v = os.environ.get("GRAFT_SERVE_BATCH_MODE", "exact").strip().lower()
    return "fused" if v == "fused" else "exact"


def _nbytes(param_vals):
    total = 0
    for v in param_vals.values():
        total += v.numel() * v.element_size()
    return total


_streams = {}
_streams_lock = threading.Lock()

# called with the program's key at the start of every CUDA graph capture,
# before its eager run; a test sets it to hold a capture open (a weight
# swap begun during a first capture)
before_capture = None


def serving_stream(device):
    """The one stream of ``device`` that every program replay, batch
    upload and reload runs on (CUDA devices only), so the device runs them
    in the order the host issued them."""
    key = device.index or 0
    with _streams_lock:
        s = _streams.get(key)
        if s is None:
            s = _streams[key] = torch.cuda.Stream(device)
        return s


@contextmanager
def on_serving_stream(device):
    """Run the block on ``device``'s serving stream (CUDA devices; nothing
    changes on the CPU)."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device), torch.cuda.stream(serving_stream(device)):
        yield


def _own_copy(params):
    """Copies of the weights for the registry.  On the card they are made
    on (and belong to) the serving stream, which reads them: the caching
    allocator then orders their reuse after the last replay that read
    them."""
    out = {}
    for n, v in params.items():
        v = v.detach()
        if v.device.type == "cuda":
            stream = serving_stream(v.device)
            stream.wait_stream(torch.cuda.current_stream(v.device))
            with torch.cuda.stream(stream):
                out[n] = v.clone()
        else:
            out[n] = v.clone()
    return out


def _host_copy(params):
    """Host copies of device weights, in their own dtype (pinned when they
    come from the card, so a reload copies them back asynchronously)."""
    host = {}
    for n, v in params.items():
        v = v.detach()
        if v.device.type == "cuda":
            h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            with torch.cuda.stream(serving_stream(v.device)):
                h.copy_(v)
        else:
            h = v.clone()
        host[n] = h
    return host


def _upload(host, device):
    """The device copy of host weights: on the serving stream, which the
    host then waits for, so the tensors are complete on every stream and
    belong to the stream that uses them."""
    if device.type != "cuda":
        return {n: h.clone() for n, h in host.items()}
    stream = serving_stream(device)
    with torch.cuda.stream(stream):
        out = {n: h.to(device, non_blocking=True) for n, h in host.items()}
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return out


def _exact_batched(fn, bucket):
    """The ``exact`` bucket program: ``bucket`` batch-1 forwards of ``fn``
    concatenated along the batch axis, whose row ``i`` is the bucket-1
    forward of row ``i``."""

    def batched(params, *xbs):
        outs = [fn(params, *[xb[i:i + 1] for xb in xbs])
                for i in range(bucket)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat([o[k] for o in outs], 0)
                         for k in range(len(outs[0])))
        return torch.cat(outs, 0)

    return batched


class _Graph(object):
    """One captured CUDA graph: static input buffers, static outputs, and
    the weight set it reads (held, so the addresses stay valid)."""

    __slots__ = ("graph", "inputs", "outputs", "params", "single")

    def __init__(self, graph, inputs, outputs, params, single):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.params = params
        self.single = single


class Program(object):
    """The dispatch entry of one batch bucket: ``program(params,
    *input_tensors)`` returns a tensor or a tuple of tensors (fresh ones the
    caller owns).  On CUDA tensors it replays the handle's CUDA graph for
    (this program, the inputs' signature, ``params``), capturing it first
    when there is none; on CPU tensors it runs the forward eagerly."""

    __slots__ = ("_handle", "_fn", "key")

    def __init__(self, handle, fn, key):
        self._handle = handle
        self._fn = fn
        self.key = key

    def __call__(self, params, *xs):
        if not xs or xs[0].device.type != "cuda":
            return self._fn(params, *xs)
        h = self._handle
        device = xs[0].device
        gkey = (self.key, device.index or 0,
                tuple((tuple(x.shape), x.dtype) for x in xs))
        stream = serving_stream(device)
        caller = torch.cuda.current_stream(device)
        with h._replay_lock:
            stream.wait_stream(caller)
            with torch.cuda.stream(stream):
                g = h._cached_graph(gkey, params)
                if g is None:
                    g = self._capture(params, xs, stream, gkey)
                for s, x in zip(g.inputs, xs):
                    s.copy_(x, non_blocking=True)
                g.graph.replay()
                # the pool is shared by every graph of the handle: the
                # outputs leave it before the lock opens
                outs = tuple(o.clone() for o in g.outputs)
        if caller != stream:
            caller.wait_stream(stream)
            for o in outs:
                o.record_stream(caller)
        return outs[0] if g.single else outs

    def _capture(self, params, xs, stream, gkey):
        if before_capture is not None:
            before_capture(self.key)
        h = self._handle
        inputs = [x.clone() for x in xs]
        # one eager run on the serving stream first (PyTorch's recipe):
        # lazy initialization (library loads, cuBLAS workspaces, kernel
        # attributes) happens outside the capture
        self._fn(params, *inputs)
        stream.synchronize()
        if h._pool is None:
            h._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=h._pool, stream=stream,
                              capture_error_mode="thread_local"):
            out = self._fn(params, *inputs)
        h.capture_log.append((self.key, gkey[2], time.perf_counter() - t0))
        single = not isinstance(out, tuple)
        g = _Graph(graph, inputs, (out,) if single else tuple(out), params,
                   single)
        h.captures += 1
        h._cache_graph(gkey, g)
        return g


class ModelHandle(object):
    """One registered model.  The handle stays valid across evictions
    (weights reload on next use) and hot-swaps (version bumps); it is what
    the batcher dispatches through."""

    __slots__ = ("name", "input_names", "_fn", "_programs", "_graphs",
                 "_graphs_lock", "_replay_lock", "_pool", "captures",
                 "capture_log",
                 "_params", "_version", "_resident", "_loader", "_nbytes",
                 "_registry", "_loading", "_device", "loaded_at",
                 "parity_ok", "no_batch", "__weakref__")

    def __init__(self, registry, name, fn, param_vals, input_names,
                 loader=None, device=None):
        self._registry = registry
        self._loading = None        # per-entry reload latch (an Event
        #                             while one thread runs the loader
        #                             OUTSIDE the registry lock)
        self.name = name
        self.input_names = list(input_names)
        self._fn = fn
        self._programs = {}         # key -> Program
        self._graphs = {}           # (program, device, signature) -> _Graph
        self._graphs_lock = threading.Lock()
        self._replay_lock = threading.Lock()
        self._pool = None           # one CUDA graph memory pool
        self.captures = 0
        self.capture_log = []       # (program key, signature, seconds)
        self._params = dict(param_vals)
        if device is None:
            device = next(iter(self._params.values())).device \
                if self._params else torch.device("cpu")
        self._device = device
        self._version = 1
        self._resident = True
        self._loader = loader
        self._nbytes = _nbytes(self._params)
        self.loaded_at = time.time()
        # parity-probe verdicts live ON the handle: they are a property of
        # this handle's PROGRAM, so they survive hot-swaps (same fn) but
        # never leak to a different model re-registered under the same name
        self.parity_ok = set()      # (sig, bucket) probed clean (exact)
        self.no_batch = set()       # sig demoted to per-request dispatch

    def jit_for(self, bucket, mode=None):
        """The program of one batch bucket: the plain forward in ``fused``
        mode (or at bucket 1, identical either way), the concatenation of
        batch-1 forwards in ``exact`` mode (see :func:`serve_batch_mode`)."""
        mode = serve_batch_mode() if mode is None else mode
        key = "fused" if bucket <= 1 or mode == "fused" else ("exact",
                                                              bucket)
        prog = self._programs.get(key)
        if prog is None:
            fn = self._fn if key == "fused" else _exact_batched(self._fn,
                                                                bucket)
            prog = self._programs.setdefault(key, Program(self, fn, key))
        return prog

    def _cached_graph(self, gkey, params):
        with self._graphs_lock:
            g = self._graphs.get(gkey)
        return g if g is not None and g.params is params else None

    def _cache_graph(self, gkey, g):
        """Keep a graph only while its weights are the model's current
        ones: a graph of another weight set (an in-flight batch of the old
        version, an oracle over foreign weights) serves its call and is
        dropped, so it never keeps those weights alive."""
        with self._graphs_lock:
            if g.params is self._params:
                self._graphs[gkey] = g

    def _drop_graphs(self):
        with self._graphs_lock:
            self._graphs = {}

    def graph_keys(self):
        """The cached graphs' (program key, device index, signature)."""
        with self._graphs_lock:
            return list(self._graphs)

    @property
    def version(self):
        return self._version

    @property
    def resident(self):
        return self._resident

    @property
    def nbytes(self):
        return self._nbytes

    @property
    def device(self):
        return self._device

    def acquire(self):
        """Snapshot ``(handle, param_vals, version)`` for one dispatch —
        atomic under the registry lock (hot-swap flips the same pair
        there), marks LRU use, reloads if evicted."""
        return self._registry.acquire(self.name)

    def predict(self, *inputs):
        """Direct single dispatch (no batching): the bucket-1 program over
        ``inputs`` (tensors / NDArrays / host arrays, with their batch
        axis)."""
        entry, params, _version = self.acquire()
        vals = [_loader._raw(v).to(entry._device) for v in inputs]
        return entry.jit_for(1)(params, *vals)


class SwapTicket(object):
    """An in-flight hot-swap: new weights copying to the device on a side
    stream while the old version serves.  ``commit`` waits for the copy
    and flips atomically; ``abandon`` drops it (the old version keeps
    serving)."""

    __slots__ = ("_registry", "name", "target_version", "_params", "_host",
                 "_event", "_done")

    def __init__(self, registry, name, target_version, params, host, event):
        self._registry = registry
        self.name = name
        self.target_version = target_version
        self._params = params       # name -> device tensor (copying in)
        self._host = host           # name -> host copy (the reload source)
        self._event = event         # the copy's CUDA event, or None
        self._done = False

    @property
    def done(self):
        return self._done

    def commit(self):
        """Wait for the copy, then flip the model's (params, version) pair
        atomically.  Returns the new version — assigned at COMMIT time as a
        monotonic bump (``target_version`` is the projection from
        begin_swap time; overlapping swaps each get a distinct, increasing
        version, last commit wins the weights)."""
        if self._done:
            return self.target_version
        if self._event is not None:
            self._event.synchronize()
        self.target_version = self._registry._commit_swap(
            self.name, self._params, self._host)
        self._done = True
        return self.target_version

    def abandon(self):
        """Drop the swap without flipping (old version keeps serving)."""
        if self._done:
            return
        self._done = True
        self._params = self._host = None


class ModelRegistry(object):
    """name → :class:`ModelHandle` with LRU residency under a byte
    budget."""

    def __init__(self, memory_bytes=None):
        self._lock = threading.RLock()
        self._models = OrderedDict()        # name -> ModelHandle, LRU order
        self._budget = serve_memory_bytes() if memory_bytes is None \
            else int(memory_bytes)
        self.loads_total = 0
        self.reloads_total = 0
        self.evictions_total = 0
        self.swaps_total = 0

    # -- loading -------------------------------------------------------------
    @staticmethod
    def _snapshot_loader(params, device):
        """Reload closure over HOST copies of the load-time weights, in
        their own dtype.  Reading the LIVE source block on reload would
        silently fast-forward an evicted model to retrained weights under
        its unchanged version number; an eviction must round-trip to the
        exact registered version, and new weights arrive ONLY via the
        versioned swap path."""
        host = _host_copy(params)
        return lambda: _upload(host, device)

    def load_block(self, name, block, example, train=False):
        """Register a HybridBlock.  The weights are copied NOW; training
        the block further does not change what this registry serves —
        publish new weights with :meth:`swap`."""
        fn, params, input_names = _loader.block_model(block, example,
                                                      train=train)
        params = _own_copy(params)
        device = _loader.model_device(block, example)
        return self._install(name, fn, params, input_names,
                             self._snapshot_loader(params, device), device)

    def load_module(self, name, module):
        """Register a bound, initialized Module (its parameters are copied
        now, as a block's)."""
        fn, params, input_names = _loader.module_model(module)
        return self._install_symbol(name, fn, params, input_names)

    def load_symbol(self, name, symbol, params, input_shapes=None,
                    input_names=None):
        """Register a Symbol and its parameters."""
        fn, params, input_names = _loader.symbol_model(
            symbol, params, input_shapes, input_names)
        return self._install_symbol(name, fn, params, input_names)

    def load_bytes(self, name, symbol_json, param_bytes, input_shapes):
        """Register the C-predict payload (symbol JSON, ``.params`` bytes,
        input shapes)."""
        fn, params, input_names = _loader.bytes_model(
            symbol_json, param_bytes, input_shapes)
        return self._install_symbol(name, fn, params, input_names)

    def _install_symbol(self, name, fn, params, input_names):
        device = _loader.symbol_device(params)
        params = _own_copy({n: v.to(device) for n, v in params.items()})
        return self._install(name, fn, params, input_names,
                             self._snapshot_loader(params, device), device)

    def _install(self, name, fn, param_vals, input_names, loader,
                 device=None):
        with self._lock:
            if name in self._models:
                raise ValueError("model %r already registered (use swap "
                                 "for a new weight version, or unload "
                                 "first)" % name)
            handle = ModelHandle(self, name, fn, param_vals, input_names,
                                 loader=loader, device=device)
            self._models[name] = handle
            self.loads_total += 1
            _tmetrics.serve_model_event("load")
            self._evict_to_fit(protect=name)
            self._publish_residency()
            return handle

    # -- use / residency -----------------------------------------------------
    def get(self, name):
        with self._lock:
            return self._models.get(name)

    def acquire(self, name):
        """(handle, param_vals, version) snapshot for one dispatch: atomic
        vs hot-swap, marks LRU use, transparently reloads an evicted model
        (evicting others to fit).

        Reload runs OUTSIDE the registry lock: a cold model's loader (a
        host-to-device copy of its weights) must not stall other models'
        dispatches.  A per-entry latch serializes concurrent reloads of the
        SAME model (one loader run, everyone else waits on the Event, never
        on the lock); the install step re-checks under the lock so a
        hot-swap or unload that raced the reload wins."""
        while True:
            with self._lock:
                entry = self._models.get(name)
                if entry is None:
                    raise KeyError("model %r is not registered" % name)
                if entry._resident:
                    self._models.move_to_end(name)
                    return entry, entry._params, entry._version
                if entry._loader is None:
                    raise RuntimeError("model %r was evicted and has no "
                                       "reload source" % name)
                latch = entry._loading
                if latch is None:
                    latch = entry._loading = threading.Event()
                    i_load = True
                else:
                    i_load = False
                loader = entry._loader
            if not i_load:
                # another thread is mid-reload: wait on ITS latch (not the
                # registry lock), then re-check from the top
                latch.wait()
                continue
            # the latch MUST open on every exit from here on: any escaping
            # exception would otherwise park every follower forever
            try:
                params = dict(loader())         # the slow part: unlocked
                retry = False
                with self._lock:
                    entry._loading = None
                    current = self._models.get(name)
                    if current is entry and not entry._resident:
                        entry._params = params
                        entry._nbytes = _nbytes(params)
                        entry._resident = True
                        self.reloads_total += 1
                        _tmetrics.serve_model_event("reload")
                        self._evict_to_fit(protect=name)
                        self._publish_residency()
                    if current is None:
                        raise KeyError("model %r was unloaded mid-reload"
                                       % name)
                    if current is not entry:
                        retry = True    # re-registered under the same name
                    else:
                        self._models.move_to_end(name)
                        snap = (entry, entry._params, entry._version)
            except BaseException:
                with self._lock:
                    if entry._loading is latch:
                        # clear only OUR latch: a successor may have
                        # installed its own
                        entry._loading = None
                raise
            finally:
                latch.set()
            if retry:
                continue
            return snap

    def unload(self, name):
        """Drop a model entirely (its handle goes stale)."""
        with self._lock:
            entry = self._models.pop(name, None)
            if entry is not None:
                entry._params = {}
                entry._resident = False
                entry._drop_graphs()
                _tmetrics.serve_model_event("unload")
                self._publish_residency()
            return entry is not None

    def evict(self, name):
        """Explicitly drop a model's weights and graphs (keeps the handle;
        next use reloads)."""
        with self._lock:
            entry = self._models.get(name)
            if entry is None or not entry._resident:
                return False
            self._evict_entry(entry)
            self._publish_residency()
            return True

    def _evict_entry(self, entry):
        entry._params = {}
        entry._resident = False
        entry._drop_graphs()
        self.evictions_total += 1
        _tmetrics.serve_model_event("evict")

    def _evict_to_fit(self, protect=None):
        """LRU-evict resident models until the budget holds.  The
        ``protect``-ed model is never evicted — a single model bigger than
        the budget stays resident; the gauges make the overshoot
        visible."""
        if self._budget <= 0:
            return
        while self.resident_bytes() > self._budget:
            victim = None
            for entry in self._models.values():     # OrderedDict = LRU order
                if entry._resident and entry.name != protect:
                    victim = entry
                    break
            if victim is None:
                return
            self._evict_entry(victim)

    def resident_bytes(self):
        return sum(e._nbytes for e in self._models.values() if e._resident)

    def _publish_residency(self):
        _tmetrics.serve_residency(
            self.resident_bytes(),
            sum(1 for e in self._models.values() if e._resident),
            self._budget)

    # -- hot-swap ------------------------------------------------------------
    def begin_swap(self, name, new_params):
        """Start copying a new weight version to the model's device: each
        value (NDArray, tensor or host array) is staged in pinned host
        memory and copied on a side stream while the CURRENT version keeps
        serving.  Returns a :class:`SwapTicket`; nothing changes until
        ``commit()``."""
        with self._lock:
            entry = self._models.get(name)
            if entry is None:
                raise KeyError("model %r is not registered" % name)
            target_version = entry._version + 1
            device = entry._device
        cuda = device.type == "cuda"
        host, params = {}, {}
        for pname in sorted(new_params):
            v = _loader._raw(new_params[pname]).detach()
            h = torch.empty(v.shape, dtype=v.dtype, pin_memory=cuda)
            h.copy_(v)
            host[pname] = h
        event = None
        if cuda:
            stream = serving_stream(device)
            side = torch.cuda.Stream(device)
            # allocated for the serving stream, which will read them
            with torch.cuda.stream(stream):
                for pname, h in host.items():
                    params[pname] = torch.empty(h.shape, dtype=h.dtype,
                                                device=device)
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                for pname, h in host.items():
                    params[pname].copy_(h, non_blocking=True)
                    params[pname].record_stream(side)
                event = torch.cuda.Event()
                event.record(side)
        else:
            params = {n: h.clone() for n, h in host.items()}
        return SwapTicket(self, name, target_version, params, host, event)

    def swap(self, name, new_params):
        """begin_swap + commit in one call.  Returns the new version."""
        return self.begin_swap(name, new_params).commit()

    def _commit_swap(self, name, new_params, host):
        # the reload source flips WITH the weights: the old one would
        # resurrect pre-swap weights under the post-swap version after an
        # eviction
        with self._lock:
            entry = self._models.get(name)
            if entry is None:
                raise KeyError("model %r was unloaded mid-swap" % name)
            device = entry._device
            entry._params = new_params
            entry._nbytes = _nbytes(new_params)
            # monotonic bump at commit time: two overlapping swaps can
            # never share or regress a version number
            target_version = entry._version + 1
            entry._version = target_version
            entry._resident = True
            entry._loader = lambda: _upload(host, device)
            entry._drop_graphs()
            self.swaps_total += 1
            _tmetrics.serve_model_event("swap")
            self._evict_to_fit(protect=name)
            self._publish_residency()
            return target_version

    # -- introspection -------------------------------------------------------
    def models(self):
        with self._lock:
            return list(self._models.keys())

    def stats(self):
        with self._lock:
            return {
                "models": {
                    n: {"version": e._version, "resident": e._resident,
                        "nbytes": e._nbytes, "captures": e.captures}
                    for n, e in self._models.items()},
                "resident_bytes": self.resident_bytes(),
                "budget_bytes": self._budget,
                "loads": self.loads_total,
                "reloads": self.reloads_total,
                "evictions": self.evictions_total,
                "swaps": self.swaps_total,
            }


_default = [None]
_default_lock = threading.Lock()


def default_registry():
    """A process-wide registry (one loader, shared residency
    accounting)."""
    with _default_lock:
        if _default[0] is None:
            _default[0] = ModelRegistry()
        return _default[0]

