"""Engine op bulking: ``mx.engine.bulk`` records eager ops and replays the
segment as one captured CUDA graph.

Counterpart of ``incubator_mxnet_tpu/engine.py``.  MXNet's engine amortizes
the cost of pushing each small op by appending consecutive eager ops to a
bulk segment run as one engine op (src/engine/threaded_engine.h:472-509
BulkAppend/BulkFlush, ``MXNET_EXEC_BULK_EXEC_*``); the JAX build replays
such a segment as one jitted XLA program.  Here, inside

    with mx.engine.bulk(64):
        ...eager ops...

each op call is recorded (its outputs are ``_Pending`` placeholders that
know their shape and dtype, from :func:`ops.registry.infer_cached`) and the
segment is flushed when the scope closes (cause ``scope-close``), before a
call that would make it longer than ``size`` (``size-cap``), when a view
cannot be deferred (``view``), when a value is read (``read``), when
autograd's backward needs it (``autograd``) or when a monitor reads it
(``monitor``).

On the card a flush runs the program once eagerly on a side stream (its
results are this flush's), captures it into a ``torch.cuda.CUDAGraph`` and
caches the graph by (instructions, external input shapes, dtypes and
strides, live set, generators, the math flags); a later flush of the same
program replays the graph on the current stream.  The sparse arrays'
casts, ``retain`` and ``row_sparse_pull`` size their outputs from the data:
they are not registry ops, and they read their inputs' values, which
flushes an open segment first (cause ``read``).  Three traps shape it:

- a graph reads fixed addresses.  An entry reads each external input
  where the caller's tensor lies, and keeps its address, not the tensor.
  A set of addresses it has not seen gets a graph of its own (weights
  after a cast, a load or a swap: never copied), at most ``_VARIANTS`` an
  entry; a slot that comes at a new address on two flushes in a row (an
  activation made anew each time) gets a buffer of the entry's own
  instead, which the input is copied into before each replay;
- the next replay overwrites the graph's outputs, so live outputs are
  cloned out of the engine's memory pool before they are handed out (a
  store into an existing array is copied into that array instead).  The
  engine's graphs share one pool per device (:func:`graph_pool`), which
  an empty anchor graph keeps alive while the bounded cache frees the
  graphs it evicts.  A graph's scratch memory may be another's, so every
  capture and replay into a pool, a hybridized block's too, is ordered
  after the last (:func:`pool_order`), whatever thread or stream runs it;
- a segment that draws random numbers registers the framework generator
  with the graph, which advances it per replay exactly as the eager calls
  would.  A capture that fails leaves such a generator unusable: it is
  replaced by a fresh one at the state the eager run left, and every
  cached graph that registered it is dropped (:func:`drop_generators`).

On the CPU a flush runs the program op by op with the same bookkeeping:
that is the plain version the tests hold against the JAX build.

A segment with ops recorded by autograd becomes ONE tape node, a
``torch.autograd.Function`` over the external inputs that can receive a
gradient; its backward runs the segment's forward again under grad and
takes ``torch.autograd.grad`` (on the card a second captured graph, cached
per program, grad inputs and outputs), so no activation is kept between
forward and backward.  An input written in place after the forward makes
the backward raise, as torch's autograd does.  Ops run under
``autograd.pause()`` inside the segment are detached.

``out=`` stores and mutating ops (optimizer updates) are recorded by
rebinding the target to the pending output when shape and dtype match; at
flush the value is written into the target's tensor (its home), so the
target keeps its storage, its ``requires_grad`` and every view of it.  A
view of a deferred array records ``_bulk_view_extract``; a write through
it records ``_bulk_view_write`` and rebinds the base.  Not deferred:
recorded ops with ``out=``, ops registered ``deferrable=False`` and every
op under ``MXTPU_ENGINE_TYPE=NaiveEngine``.  A deferrable op whose outputs
meta inference cannot give raises: the registry must flag it.

A segment belongs to the thread that records it: reading one of its
values, or writing an array it will store into, from another thread
raises ``MXNetError`` instead of flushing it under its owner.

Strict mode (``GRAFT_ENGINE_CHECK=1`` or :func:`set_engine_check`) checks
EH101 and EH102 at record time and EH103 and EH104 at flush
(``analysis/engine_check.py``).
"""
from __future__ import annotations

import collections
import contextlib
import functools
import os
import threading
import weakref

import torch

from . import config, profiler as _profiler, random_state
from .analysis.engine_check import (EngineHazardError,
                                    check_segment_integrity, oracle_compare)
from .base import MXNetError, torch_dtype
from .ops.registry import (BoundedCache, _infer_cache, get_op, hashable,
                           infer_cached)

__all__ = ["bulk", "offband", "in_bulk", "flush", "flush_stats",
           "reset_flush_stats", "EngineHazardError", "engine_check_enabled",
           "set_engine_check", "BoundedCache", "cache_sizes",
           "flatten_arrays", "unflatten", "split_flat", "colocate",
           "clear_graphs"]

_engine_check_override = None


def set_engine_check(flag):
    """Force strict mode on or off (None defers to GRAFT_ENGINE_CHECK)."""
    global _engine_check_override
    _engine_check_override = flag


def engine_check_enabled():
    """Whether a bulk scope opened now runs in strict mode."""
    if _engine_check_override is not None:
        return bool(_engine_check_override)
    return os.environ.get("GRAFT_ENGINE_CHECK", "").strip().lower() \
        in ("1", "true", "yes", "on")


def storage_ptr(t):
    """The address of ``t``'s storage (views of one storage share it)."""
    return t.untyped_storage().data_ptr()


class _Pending(object):
    """A deferred value: shape, dtype and device for metadata queries,
    ``value`` once its segment flushed.  ``owners`` are weak references to
    the arrays that expose it: a pending none of them still holds at flush
    is dead and leaves the program as no output.  ``home`` is the tensor a
    store into an existing array writes the value into at flush."""
    __slots__ = ("shape", "dtype", "device", "slot", "value", "state",
                 "epoch", "owners", "error", "home", "__weakref__")

    def __init__(self, shape, dtype, device, slot, state):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.device = device
        self.slot = slot
        self.value = None
        self.state = state
        self.epoch = state.epoch
        self.owners = []
        self.error = None
        self.home = None

    @property
    def ndim(self):
        return len(self.shape)

    def numel(self):
        n = 1
        for s in self.shape:
            n *= s
        return n

    def live(self):
        return any(o is not None and o._slot is self
                   for o in (w() for w in self.owners))


class _BulkState(object):
    """One open scope of one thread: the segment being recorded."""

    def __init__(self, size, check=False, enabled=True):
        self.size = size
        self.check = bool(check)
        self.enabled = bool(enabled)
        self.owner_tid = threading.get_ident()
        self.epoch = 0
        self._clear()

    def _clear(self):
        # instructions: (op name, fcompute kwargs, their key, is_train,
        # in_refs (("e", ext slot) | ("t", pending slot)), rng slot,
        # number of outputs, recorded by autograd)
        self.instructions = []
        self.ext = []            # external input tensors, by slot
        self.ext_ids = {}        # id(tensor) -> slot (the tensor is pinned)
        self.ext_versions = []   # each one's _version when recorded
        self.ext_ptrs = set()    # their storages: an eager write flushes
        self.gens = []           # generators the segment draws from
        self.gen_ids = {}
        self.pendings = []
        self.homes = {}          # storage of a store target -> its tensor
        self.extract_meta = {}   # strict mode: id(extract) -> (view, base,
        #                          the base's version when recorded)
        self.any_recorded = False
        self.device = None

    def add_ext(self, t):
        slot = self.ext_ids.get(id(t))
        if slot is None:
            slot = len(self.ext)
            self.ext.append(t)
            self.ext_ids[id(t)] = slot
            self.ext_versions.append(t._version)
            self.ext_ptrs.add(storage_ptr(t))
        return slot

    def add_gen(self, g):
        slot = self.gen_ids.get(id(g))
        if slot is None:
            slot = len(self.gens)
            self.gens.append(g)
            self.gen_ids[id(g)] = slot
        return slot


_tls = threading.local()
_HOMED = {}      # storage pointer of a pending store's target -> its state

_FLUSH_CAUSES = ("scope-close", "size-cap", "view", "read", "autograd",
                 "monitor")
_flush_causes = {c: 0 for c in _FLUSH_CAUSES}
_segment_hist = {}   # instructions per flush -> count
_stats = {"captures": 0, "replays": 0, "backward_captures": 0,
          "backward_replays": 0}


def _free_entry(entry):
    if isinstance(entry, _Graph):
        entry.release()


_replay_cache = BoundedCache(on_evict=_free_entry)
_seg_vjp_cache = BoundedCache(on_evict=_free_entry)
_split_cache = BoundedCache()


def flush_stats():
    """The flush-cause counters, the segment-length histogram (flushes
    that ran instructions) and the card's capture and replay counts."""
    return {"causes": dict(_flush_causes),
            "segment_lengths": dict(_segment_hist),
            "graphs": dict(_stats)}


def reset_flush_stats():
    for c in _FLUSH_CAUSES:
        _flush_causes[c] = 0
    _segment_hist.clear()
    for k in _stats:
        _stats[k] = 0


def cache_sizes():
    """Entry counts of the engine's bounded caches."""
    return {"replay": len(_replay_cache), "infer": len(_infer_cache),
            "seg_vjp": len(_seg_vjp_cache), "split": len(_split_cache)}


def _current():
    return getattr(_tls, "state", None)


def _active(st):
    return st is not None and st.enabled


class bulk(object):
    """Context manager: defer up to ``size`` eager ops per segment."""

    def __init__(self, size=64):
        self.size = max(int(size), 1)
        self._prev = None

    def __enter__(self):
        self._prev = _current()
        _tls.state = _BulkState(self.size, check=engine_check_enabled(),
                                enabled=not config.naive_engine())
        return self

    def __exit__(self, *exc):
        try:
            flush(cause="scope-close")
        finally:
            _tls.state = self._prev


class offband(object):
    """Dispatch eagerly beside an open bulk segment, neither joining nor
    flushing it: ops inside run as ordinary eager calls, and the
    surrounding segment goes on recording after the scope (reading one of
    its values inside still flushes it, as any read does)."""

    def __enter__(self):
        self._prev = _current()
        _tls.state = None
        return self

    def __exit__(self, *exc):
        _tls.state = self._prev


def in_bulk():
    """True when the calling thread has an open bulk scope."""
    return _current() is not None


def _same_segment(p, st):
    return type(p) is _Pending and p.value is None and p.state is st \
        and p.epoch == st.epoch


def maybe_defer(op, kw, vals, is_train, gen=None, rec=False, nd_inputs=None,
                out_reqs=None, params=None, device=None):
    """Record one call into the open segment, or return None to run it
    eagerly.  ``vals`` are the inputs (pendings of this segment or
    tensors), ``kw`` the fcompute's keyword arguments but the generator,
    ``gen`` the generator a drawing call takes, ``params`` the call's
    parameters for meta inference (default ``kw``), ``device`` the output
    device of a call without inputs.  ``out_reqs`` [(output, shape,
    dtype)] refuses the call, before anything is recorded, unless those
    outputs come out with exactly that shape and dtype (a store target's).
    Returns the tuple of output pendings."""
    st = _current()
    if not _active(st):
        return None
    if len(st.instructions) >= st.size:
        # before recording, never right after: the outputs just made get
        # their owners only once the caller wraps them
        flush(st, cause="size-cap")
    staged, shapes = [], []
    dev = device
    for v in vals:
        if type(v) is _Pending:
            if not _same_segment(v, st):
                return None          # another scope's or segment's value
            staged.append(("t", v))
        elif isinstance(v, torch.Tensor):
            if _HOMED and storage_ptr(v) in _HOMED:
                return None          # a pending store will rewrite it
            staged.append(("e", v))
        else:
            return None
        if dev is None:
            dev = v.device
        elif v.device != dev:
            return None
        shapes.append((tuple(v.shape), v.dtype))
    if dev is None or (st.device is not None and dev != st.device):
        return None
    if st.check:
        _strict_check_record(st, op, vals, nd_inputs)
    try:
        key = hashable(kw)
    except TypeError as exc:
        raise MXNetError("bulk engine: the parameters of %s have no hashable "
                         "form (%s); register it deferrable=False"
                         % (op.name, exc)) from exc
    out_sig = infer_cached(op, shapes, kw if params is None else params,
                           is_train)
    if out_reqs is not None:
        for slot, shp, dt in out_reqs:
            if slot >= len(out_sig) or tuple(out_sig[slot][0]) != tuple(shp) \
                    or torch_dtype(out_sig[slot][1]) != dt:
                return None
    in_refs = tuple((tag, v.slot if tag == "t" else st.add_ext(v))
                    for tag, v in staged)
    rng_slot = st.add_gen(gen) if gen is not None else None
    outs = []
    for shp, dt in out_sig:
        p = _Pending(shp, torch_dtype(dt), dev, len(st.pendings), st)
        st.pendings.append(p)
        outs.append(p)
    st.instructions.append((op.name, dict(kw), key, bool(is_train), in_refs,
                            rng_slot, len(outs), bool(rec)))
    st.device = dev
    st.any_recorded |= bool(rec)
    return tuple(outs)


def _strict_check_record(st, op, vals, nd_inputs):
    """EH101 and EH102 against the version of each input's base."""
    for pos, v in enumerate(vals):
        if type(v) is not _Pending:
            continue
        meta = st.extract_meta.get(id(v))
        if meta is None:
            continue
        view, base, ver = meta[0](), meta[1](), meta[2]
        consumer = (nd_inputs[pos] if nd_inputs is not None
                    and pos < len(nd_inputs) else None)
        # a stale extract is a hazard only when it arrives through the
        # view it extracts: eager semantics read the view after the write
        # (another owner holding it is a snapshot copy, which is legal)
        if base is not None and view is not None and consumer is view \
                and base._bver != ver:
            raise EngineHazardError(
                "EH101", "op %r reads view (shape %s, offset %d) through a "
                "_bulk_view_extract recorded at base version %d, but the "
                "base was rebound to version %d since: the replay would read "
                "the value before the write, eager execution the one after"
                % (op.name, view.shape, view._voff, ver, base._bver),
                op=op.name, input=pos, recorded_version=ver,
                current_version=base._bver)
    if op.name == "_bulk_view_write" and nd_inputs:
        base = nd_inputs[0]
        if base is not None and vals and base._slot is not vals[0]:
            raise EngineHazardError(
                "EH102", "_bulk_view_write over a base operand that is no "
                "longer the base's binding (version %d): the rebind would "
                "drop the writes between" % base._bver,
                base_version=base._bver)


# ---------------------------------------------------------------------------
# resolving values
# ---------------------------------------------------------------------------

def resolve(pending, cause="read"):
    """The value of ``pending``, flushing its segment if needed."""
    if pending.value is None and pending.error is None:
        flush(pending.state, cause=cause)
    if pending.error is not None:
        raise MXNetError("bulk engine: the deferred segment holding this "
                         "value failed: %s" % (pending.error,)) \
            from pending.error
    if pending.value is None:
        raise MXNetError("bulk engine: a deferred value was eliminated as "
                         "dead but read later")
    return pending.value


def resolve_nd(arr, cause="read"):
    """Bind ``arr`` (whose slot is a pending) to its value.  A view of a
    deferred array becomes a torch view of its base's tensor, so it goes
    on writing through."""
    base = arr._vbase
    if base is None:
        v = arr._slot = resolve(arr._slot, cause)
        return v
    bt = resolve_nd(base, cause) if type(base._slot) is _Pending \
        else base._data
    if not bt.is_contiguous():
        bt = base._slot = bt.contiguous()
    n = 1
    for s in arr._vshape:
        n *= s
    if arr._vrec and bt.requires_grad:
        with torch.enable_grad():
            v = bt.reshape(-1)[arr._voff:arr._voff + n].view(arr._vshape)
    else:
        v = bt.detach().reshape(-1)[arr._voff:arr._voff + n].view(
            arr._vshape)
    arr._slot = v
    arr._vbase = None
    return v


def read_deferred(arr):
    """An op's input inside a scope: the array's pending when it is one of
    the open segment, its tensor otherwise (a view of a deferred array
    records its extract, or materializes with cause ``view``)."""
    d = arr._slot
    if type(d) is not _Pending:
        return d
    base = arr._vbase
    if base is None:
        return d if d.value is None else arr._data
    st = _current()
    if arr._vver == base._bver and _same_segment(d, st):
        return d
    if _active(st) and _same_segment(base._slot, st):
        p = _record_extract(st, base, arr._voff, arr._vshape, arr._vrec,
                            arr)
        if p is not None:
            arr._slot = p
            arr._vver = base._bver
            return p
    return resolve_nd(arr, "view")


def _record_extract(st, base, offset, shape, rec, view):
    p = maybe_defer(get_op("_bulk_view_extract"),
                    {"offset": int(offset), "shape": tuple(shape)},
                    [base._slot], False, rec=rec, nd_inputs=[base])
    if p is None:
        return None
    if st.check and view is not None:
        st.extract_meta[id(p[0])] = (weakref.ref(view), weakref.ref(base),
                                     base._bver)
    return p[0]


def defer_view(arr, fn):
    """A view ``fn(arr)`` of a deferred array as a new array over a
    ``_bulk_view_extract`` of the segment, or None (no open segment holds
    the base, or the view is not one contiguous span)."""
    from .autograd import is_recording
    from .ndarray.ndarray import NDArray
    st = _current()
    if not _active(st):
        return None
    base, off0 = (arr._vbase, arr._voff) if arr._vbase is not None \
        else (arr, 0)
    if not _same_segment(base._slot, st):
        return None
    try:
        meta = fn(torch.empty(arr.shape, dtype=arr._slot.dtype,
                              device="meta"))
    except Exception:
        return None                  # the eager path raises the error
    if not meta.is_contiguous():
        return None
    shape = tuple(meta.shape)
    view = NDArray(None, ctx=arr._ctx)
    rec = is_recording()
    p = _record_extract(st, base, off0 + meta.storage_offset(), shape, rec,
                        view)
    if p is None:
        return None
    view._slot = p
    view._vbase, view._voff, view._vshape = base, off0 + \
        meta.storage_offset(), shape
    view._vver, view._vrec = base._bver, rec
    return view


# ---------------------------------------------------------------------------
# stores into arrays
# ---------------------------------------------------------------------------

def can_rebind(st, dst, recording):
    """Whether a store into ``dst`` by a call recorded by autograd or not
    (``recording``) can be deferred (see :func:`_rebind`)."""
    cur = dst._slot
    if dst._vbase is not None:
        return False
    if type(cur) is _Pending:
        if cur.value is None:
            return _same_segment(cur, st)
        cur = cur.value
    return not recording and cur.is_contiguous() \
        and storage_ptr(cur) not in _HOMED


def _rebind(st, dst, p, recording=None):
    """Make ``dst`` expose ``p`` (a fresh pending of this segment) if
    :func:`can_rebind` allows it; a tensor it held becomes ``p``'s home,
    written at flush."""
    from .autograd import is_recording
    if not can_rebind(st, dst, is_recording() if recording is None
                      else recording):
        return False
    cur = dst._slot
    if type(cur) is _Pending and cur.value is not None:
        cur = dst._data
    if type(cur) is _Pending:
        p.home, cur.home = cur.home, None
    else:
        p.home = cur
        st.homes[storage_ptr(cur)] = cur
        _HOMED[storage_ptr(cur)] = st
    p.owners.append(weakref.ref(dst))
    dst._slot = p
    dst._bver += 1
    return True


def _view_write(st, view, value):
    """Record the write of ``value`` through the deferred view ``view``:
    its base is rebound to the new pending."""
    from .autograd import is_recording
    base = view._vbase
    bp = base._slot
    if not _same_segment(bp, st):
        return False
    p = maybe_defer(get_op("_bulk_view_write"), {"offset": int(view._voff)},
                    [bp, value], False, rec=is_recording(),
                    nd_inputs=[base, None])
    if p is None:
        return False
    p = p[0]
    p.home, bp.home = bp.home, None
    p.owners.append(weakref.ref(base))
    base._slot = p
    base._bver += 1
    view._vver = -1                  # re-extracted from the new base
    return True


def defer_store(dst, res):
    """``dst op= x`` inside a scope: rebind ``dst`` (or write through it,
    for a deferred view) to the pending ``res`` holds.  True if recorded."""
    st = _current()
    if not _active(st):
        return False
    v = res._slot
    if not _same_segment(v, st) or v.shape != tuple(dst.shape) \
            or v.dtype != dst._slot.dtype:
        return False
    if dst._vbase is not None:
        return _view_write(st, dst, v)
    return _rebind(st, dst, v)


def defer_setitem(dst, key, value):
    """``dst[key] = value`` inside a scope when ``dst`` or ``value`` is
    deferred and the target is one contiguous span.  True if recorded."""
    from .autograd import is_recording
    from .ndarray.ndarray import NDArray
    st = _current()
    if not _active(st):
        return False
    full = isinstance(key, slice) and key == slice(None) or key is Ellipsis
    dst_deferred = type(dst._slot) is _Pending
    val = read_deferred(value) if isinstance(value, NDArray) else None
    if not dst_deferred and not _same_segment(val, st):
        return False
    target = dst
    if not full:
        if not dst_deferred:
            return False
        target = defer_view(dst, lambda t: t[key])
        if target is None:
            return False
    shape, dtype = tuple(target.shape), dst._slot.dtype
    if val is None:
        try:
            if isinstance(value, (int, float, bool)):
                val = torch.full((), value, dtype=dtype,
                                 device=dst._slot.device)
            else:
                val = torch.as_tensor(value, dtype=dtype,
                                      device=dst._slot.device)
            val = val.expand(shape)
        except Exception:
            return False
    elif tuple(val.shape) != shape:
        if type(val) is _Pending:
            return False
        try:
            val = val.expand(shape)
        except RuntimeError:
            return False
    if target._vbase is not None:
        return _view_write(st, target, val)
    # the whole of a root: a fresh value rebinds it
    if not can_rebind(st, dst, is_recording()):
        return False
    cur = dst._slot if dst_deferred else dst._data
    p = maybe_defer(get_op("_bulk_view_write"), {"offset": 0}, [cur, val],
                    False, rec=is_recording(), nd_inputs=[dst, None])
    if p is None:
        return False
    return _rebind(st, dst, p[0])


def before_write(t):
    """An eager in-place write into ``t`` is about to happen: flush the
    segment that reads it, or that will write it."""
    st = _current()
    ptr = None
    if st is not None and st.instructions:
        ptr = storage_ptr(t)
        if ptr in st.ext_ptrs:
            flush(st, cause="read")
    if _HOMED:
        owner = _HOMED.get(storage_ptr(t) if ptr is None else ptr)
        if owner is not None:
            flush(owner, cause="read")


def flush_homed(t):
    """A tensor a pending store will rewrite is read: flush that store."""
    owner = _HOMED.get(storage_ptr(t))
    if owner is not None:
        flush(owner, cause="read")


# ---------------------------------------------------------------------------
# running a program
# ---------------------------------------------------------------------------

def _aliases(t, inputs):
    ptr = t.untyped_storage().data_ptr()
    return any(isinstance(x, torch.Tensor)
               and ptr == x.untyped_storage().data_ptr() for x in inputs)


def _run_program(instrs, ext, gens, want, grad=False, ops=None):
    """Run a segment op by op as ``ndarray.invoke`` would, and return the
    values of pending slots ``want``.  ``grad`` records the instructions
    autograd recorded (their no-grad inputs detached); the others run
    detached, as under ``autograd.pause()``.  ``ops`` are the instructions'
    operators, when the caller has looked them up."""
    tmp = []
    if ops is None:
        ops = [get_op(i[0]) for i in instrs]
    split = capturing()
    for op, (_name, kw, _key, _train, in_refs, rng_slot, _n, rec) in zip(
            ops, instrs):
        if split is not None:
            split.last_op = op.name
        args = [ext[i] if tag == "e" else tmp[i] for tag, i in in_refs]
        on = grad and rec
        if on and op.nograd_inputs:
            args = [a.detach() if j in op.nograd_inputs else a
                    for j, a in enumerate(args)]
        call = dict(kw)
        if rng_slot is not None:
            call["generator"] = gens[rng_slot]
        with torch.set_grad_enabled(on):
            res = op.fcompute(*args, **call)
            res = res if isinstance(res, tuple) else (res,)
            res = tuple(r.clone(memory_format=torch.contiguous_format)
                        if _aliases(r, args) else r for r in res)
        tmp.extend(res)
    return [tmp[i] for i in want]


_side_streams = {}


def _side_stream(device):
    s = _side_streams.get(device.index)
    if s is None:
        s = _side_streams[device.index] = torch.cuda.Stream(device)
    return s


_pools = {}     # device index -> (pool id, the anchor graph)


def graph_pool(device):
    """The memory pool id of the engine's graphs on ``device``.  An anchor
    graph captured into it first holds it: a pool whose last graph is
    freed is released, and its id cannot be captured into again."""
    entry = _pools.get(device.index)
    if entry is None:
        pool = torch.cuda.graph_pool_handle()
        anchor = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(device)
        with torch.cuda.stream(_side_stream(device)):
            anchor.capture_begin(pool=pool,
                                 capture_error_mode="thread_local")
            torch.zeros(1, device=device)
            anchor.capture_end()
        entry = _pools[device.index] = (pool, anchor)
    return entry[0]


_retired = []   # (pool, anchor) of pools no capture may use again


def retire_pool(device, pool):
    """Stop capturing into ``pool`` on ``device``: the next capture there
    makes a new pool.  Its anchor is kept, so the graphs captured into it
    stay valid and the allocator never releases a pool it still marks as
    recording."""
    entry = _pools.get(device.index)
    if entry is not None and entry[0] == pool:
        _retired.append(_pools.pop(device.index))


def clear_graphs():
    """Drop every cached program and graph, and the pools' anchors: once
    no graph is left, ``torch.cuda.empty_cache()`` gives the pools' memory
    back.  A program flushed afterwards is captured again."""
    _replay_cache.clear()
    _seg_vjp_cache.clear()
    _pools.clear()


def _math_flags():
    return (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)


_VARIANTS = 4   # graphs an entry keeps, one per set of input addresses

# the graphs of a pool share their intermediate memory: every eager first
# run, capture and replay into the engine's pools runs under this lock
# (pool_order), one at a time in the process
_pool_lock = threading.RLock()
_pool_last = {}     # device index -> (stream, event) of the last pool use
_capturing = threading.local()     # .split: this thread's open _Split;
#                                    .seen: the eager run's recorded ops


@contextlib.contextmanager
def pool_order(device):
    """Hold the engine's graph pool of ``device``: under the process's
    lock, on the current stream, ordered after the last use of the pool on
    another stream.  Graphs that share a pool must never run concurrently,
    whichever CachedOp or bulk segment they belong to."""
    with _pool_lock:
        cur = torch.cuda.current_stream(device)
        last = _pool_last.get(device.index)
        if last is not None and last[0] != cur:
            cur.wait_event(last[1])
        try:
            yield
        finally:
            event = last[1] if last is not None else torch.cuda.Event()
            event.record(cur)
            _pool_last[device.index] = (cur, event)


def capturing():
    """The open capture of this thread (a :class:`_Split`), or None."""
    return getattr(_capturing, "split", None)


def run_outside_graph(fcompute, args, kw):
    """Run an op that cannot live in a graph (``deferrable=False``).  In a
    capture it ends the piece before it (:meth:`_Split.eager`); in the
    eager run before a capture its results are kept for that capture."""
    split = capturing()
    if split is not None:
        return split.eager(fcompute, args, kw)
    seen = getattr(_capturing, "seen", None)
    _capturing.seen = None      # what the op calls itself is not recorded
    try:
        res = fcompute(*args, **kw)
    finally:
        _capturing.seen = seen
    if seen is not None:
        seen.append([r.clone() for r in
                     (res if isinstance(res, tuple) else (res,))])
    return res


class _EagerStep(object):
    """An op that cannot live in a graph, between two captured pieces: a
    replay runs it again on the tensors the piece before left at their
    addresses and copies its results into those the piece after reads."""

    def __init__(self, fcompute, args, kw, outs):
        self.fcompute = fcompute
        self.args = args
        self.kw = kw
        self.outs = outs

    def replay(self):
        with torch.no_grad():
            res = self.fcompute(*self.args, **self.kw)
            res = res if isinstance(res, tuple) else (res,)
            for o, r in zip(self.outs, res):
                o.copy_(r)


class _Split(object):
    """A capture that ends its graph at an op which cannot be captured and
    captures what follows as the next graph: ``steps`` alternate graphs
    and :class:`_EagerStep` s.  The op does not run in the capture: its
    inputs there are pool memory no kernel has written yet, and running it
    would repeat its side effects and draws.  Its results are those of the
    same op in the eager run before the capture (``seen``, in order), at
    addresses of their own that the replays write.  ``last_op`` names the
    op the capture reached, for its error."""

    def __init__(self, gens, pool, seen):
        self.gens = gens
        self.pool = pool
        self.seen = list(seen)
        self.steps = []
        self.graph = None
        self.last_op = None

    def begin(self):
        g = torch.cuda.CUDAGraph()
        for gen in self.gens:
            g.register_generator_state(gen)
        g.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self.graph = g

    def end(self):
        self.graph.capture_end()
        self.steps.append(self.graph)
        self.graph = None

    def abort(self, device):
        g, self.graph = self.graph, None
        if g is None:
            return
        try:
            g.capture_end()
        except Exception:
            # an invalidated capture (an op that waited for the card, a
            # library error) leaves its pool marked as recording in the
            # allocator: no capture can begin in it again, so the device's
            # later captures take a new pool
            retire_pool(device, self.pool)

    def eager(self, fcompute, args, kw):
        """Place one op outside the graphs, between two pieces."""
        if not self.seen:
            raise MXNetError("the capture reached an op that cannot be "
                             "captured which its eager run did not reach")
        self.end()
        outs = self.seen.pop(0)
        self.steps.append(_EagerStep(fcompute, list(args), dict(kw), outs))
        self.begin()
        return tuple(outs)


class _Graph(object):
    """The captured graphs of one program ``fn(inputs) -> [tensors]``.

    Each input slot is borrowed (the graph reads the caller's tensor where
    it lies) until shown otherwise.  The entry keeps one variant per set of
    addresses of its borrowed slots: a graph and its static outputs (at
    most ``_VARIANTS``, the least recently used dropped).  A slot that comes
    at a new address on two calls in a row is owned from then on: the
    entry's own buffer, which the input is copied into before each replay.
    Slots ``owned`` are owned from the start (inputs made anew for every
    call).  A variant is captured after one eager run of ``fn``, whose
    results that call returns.

    A program may hold ops that cannot be captured (``deferrable=False``
    in the registry): the capture splits there (:class:`_Split`), and a
    variant is then several graphs with those ops run eagerly between
    them; ``pieces`` and ``split_ops`` count them at the last capture.
    ``what`` names the program in a capture's error."""

    def __init__(self, fn, inputs, gens, device, owned=(), what=None):
        self.fn = fn
        n = len(inputs)
        self.owned = [None] * n
        for i in owned:
            self.owned[i] = torch.empty_like(inputs[i])
        self.moved = [False] * n    # came at a new address on the last call
        self.gens = [g for g in gens if g is not None]
        self.device = device
        self.what = what
        self.variants = collections.OrderedDict()  # addresses -> (steps,
        #                                              outputs)
        self.capture_s = None
        self.pieces = 0
        self.split_ops = 0

    def _addresses(self, inputs):
        return tuple(None if buf is not None else t.data_ptr()
                     for buf, t in zip(self.owned, inputs))

    def capture(self, inputs, seen=()):
        """Capture ``fn`` over ``inputs`` (owned slots read the entry's
        buffers) as the graphs of their addresses; ``seen`` holds the
        results of the ops that cannot be captured in the eager run
        before."""
        import time
        t0 = time.perf_counter()
        static = [t if buf is None else buf.copy_(t)
                  for buf, t in zip(self.owned, inputs)]
        stream = _side_stream(self.device)
        torch.cuda.synchronize(self.device)
        states = [g.get_state() for g in self.gens]
        split = _Split(self.gens, graph_pool(self.device), seen)
        with torch.cuda.stream(stream):
            split.begin()
            _capturing.split = split
            try:
                outs = self.fn(static)
            except BaseException as exc:
                _capturing.split = None
                split.abort(self.device)
                drop_generators(self.gens, states)
                raise MXNetError(
                    "capturing %s into a CUDA graph failed at op %s "
                    "(%s: %s); an op that cannot be captured must be "
                    "registered deferrable=False"
                    % (self.what or "a bulk engine segment", split.last_op,
                       type(exc).__name__, exc)) from exc
            _capturing.split = None
            split.end()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        self.variants[self._addresses(inputs)] = (split.steps, list(outs))
        while len(self.variants) > _VARIANTS:
            self.variants.popitem(last=False)
        self.pieces = sum(isinstance(s, torch.cuda.CUDAGraph)
                          for s in split.steps)
        self.split_ops = len(split.steps) - self.pieces
        self.capture_s = time.perf_counter() - t0

    def run(self, inputs):
        """(outputs over ``inputs``, whether it captured): a replay's
        outputs cloned out of the pool, or a capture's eager results."""
        addrs = self._addresses(inputs)
        hit = self.variants.get(addrs)
        if hit is None:
            last = next(reversed(self.variants), addrs)
            moved = [a is not None and a != b for a, b in zip(addrs, last)]
            again = [i for i, m in enumerate(moved) if m and self.moved[i]]
            self.moved = moved
            for i in again:
                self.owned[i] = torch.empty_like(inputs[i])
            if again:
                # the graphs read the old addresses of the slots now owned
                self.variants.clear()
            results, seen = _eager_run(self.fn, inputs, self.device)
            self.capture(inputs, seen)
            return results, True
        self.variants.move_to_end(addrs)
        self.moved = [False] * len(inputs)
        for buf, t in zip(self.owned, inputs):
            if buf is not None:
                buf.copy_(t)
        for step in hit[0]:
            step.replay()
        return [o.clone() for o in hit[1]], False

    def release(self):
        self.variants.clear()
        self.owned = [None] * len(self.owned)


# functions ``fn(ids)`` that drop whatever holds a generator a failed
# capture left unusable (a hybridized block's graphs and backward
# generators register one: gluon/block.py)
_generator_hooks = []


def on_dropped_generators(fn):
    """Register ``fn(ids)``, called with the ids of the generators a failed
    capture dropped (:func:`drop_generators`)."""
    _generator_hooks.append(fn)
    return fn


def drop_generators(gens, states):
    """After a failed capture: the generators registered with it are left
    bound to an unfinished graph, and a draw from one raises.  Put a fresh
    generator at each one's ``states`` entry (its state before the
    capture, the one the eager run left) wherever the framework holds it
    (``random_state.replace_generator``), and drop every cached graph that
    registered one; a program keyed on a dropped generator is captured
    afresh with the new one."""
    if not gens:
        return
    for g, s in zip(gens, states):
        random_state.replace_generator(g, s)
    dead = frozenset(id(g) for g in gens)
    for cache in (_replay_cache, _seg_vjp_cache):
        for key, entry in cache.items():
            if isinstance(entry, _Graph) and \
                    not dead.isdisjoint(map(id, entry.gens)):
                cache.pop(key)
                entry.release()
    for fn in _generator_hooks:
        fn(dead)


def _eager_run(fn, inputs, device):
    """(results, the results of its ops that cannot be captured) of one
    run of ``fn`` on the side stream, ordered with the current one."""
    cur = torch.cuda.current_stream(device)
    stream = _side_stream(device)
    stream.wait_stream(cur)
    outer = getattr(_capturing, "seen", None)
    _capturing.seen = seen = []
    try:
        with torch.cuda.stream(stream):
            results = fn(inputs)
    finally:
        _capturing.seen = outer
    cur.wait_stream(stream)
    for r in results:
        r.record_stream(cur)
    return results, seen


def _run_cuda(cache, key, fn, inputs, gens, device, owned=(), what=None):
    """(results, captured now) of ``fn`` over ``inputs`` through the
    cached graph of ``key``, in the pool's order (:func:`pool_order`): on
    a miss one eager run on the side stream gives the results, then the
    capture.  ``gens`` may be a function that names the generators to
    register once the eager run has drawn."""
    with pool_order(device):
        entry = cache.get(key)
        if entry is not None:
            return entry.run(inputs)
        results, seen = _eager_run(fn, inputs, device)
        entry = _Graph(fn, inputs, gens() if callable(gens) else gens,
                       device, owned, what)
        entry.capture(inputs, seen)
        cache[key] = entry
    return results, True


# ---------------------------------------------------------------------------
# flush
# ---------------------------------------------------------------------------

def flush(state=None, cause="read"):
    """Run the open segment of ``state`` (this thread's by default) and
    fill every pending it recorded."""
    st = state if state is not None else _current()
    if st is None or not st.instructions:
        return
    if st.owner_tid != threading.get_ident():
        raise MXNetError(
            "bulk engine: this thread reads a value of, or writes an array "
            "stored into by, a bulk segment that another thread is still "
            "recording; use the array after that thread's scope closes")
    _flush_causes[cause] = _flush_causes.get(cause, 0) + 1
    _segment_hist[len(st.instructions)] = \
        _segment_hist.get(len(st.instructions), 0) + 1
    instrs, ext, gens = st.instructions, st.ext, st.gens
    versions, pendings, homes = st.ext_versions, st.pendings, st.homes
    recorded, device = st.any_recorded, st.device
    # reset first: a hazard raised below leaves the scope usable, and a
    # read during the run sees an empty segment
    st._clear()
    st.epoch += 1
    for ptr in homes:
        if _HOMED.get(ptr) is st:
            _HOMED.pop(ptr, None)

    err = None
    if st.check:
        try:
            check_segment_integrity(instrs, len(ext), len(gens))
        except EngineHazardError as exc:
            err = exc
    if err is None:
        for t, ver in zip(ext, versions):
            if t._version != ver:
                err = MXNetError(
                    "bulk engine: an input of the segment %s was written in "
                    "place after it was recorded" % [i[0] for i in instrs])
                break
    live = tuple(i for i, p in enumerate(pendings) if p.live())
    results = None
    gen_states = [g.get_state() for g in gens] if (recorded or st.check) \
        else None
    if err is None:
        span = _profiler.op_span("engine.flush(%s)" % cause)
        try:
            with span or _profiler.NO_SPAN:
                results = _execute(instrs, ext, gens, live, device, st.check,
                                   gen_states)
        except Exception as exc:
            err = exc
    if err is not None:
        for p in pendings:
            p.error = err
        raise err
    if recorded:
        results = _record_segment_node(instrs, ext, versions, gens,
                                       gen_states, pendings, live, results,
                                       device, homes)
    with torch.no_grad():
        for i, v in zip(live, results):
            p = pendings[i]
            if p.home is not None:
                p.home.copy_(v)
                v = p.home
            p.value = v


def _program_key(instrs, ext, gens, live, device):
    return (tuple((name, key, train, in_refs, rng, n, rec)
                  for name, _kw, key, train, in_refs, rng, n, rec in instrs),
            tuple((tuple(t.shape), t.dtype, t.stride(), t.requires_grad)
                  for t in ext),
            tuple(id(g) for g in gens), live, device, _math_flags())


def _execute(instrs, ext, gens, live, device, check, gen_states):
    key = _program_key(instrs, ext, gens, live, device)
    if device.type != "cuda":
        # the CPU's entry: the operators, which the program runs one by one
        ops = _replay_cache.get(key)
        if ops is None:
            ops = _replay_cache[key] = tuple(get_op(i[0]) for i in instrs)
        results = _run_program(instrs, ext, gens, live, ops=ops)
    else:
        results, captured = _run_cuda(
            _replay_cache, key,
            lambda xs: _run_program(instrs, xs, gens, live), list(ext), gens,
            device)
        _stats["captures" if captured else "replays"] += 1
    if check and results:
        # EH104: the same program op by op, from the same generator states
        post = [g.get_state() for g in gens]
        for g, s in zip(gens, gen_states):
            g.set_state(s)
        unfused = _run_program(instrs, ext, gens, live)
        for g, s in zip(gens, post):
            g.set_state(s)
        oracle_compare(results, unfused, instrs, live)
    return results


# ---------------------------------------------------------------------------
# recorded segments: one tape node
# ---------------------------------------------------------------------------

class _SegmentFunction(torch.autograd.Function):
    """The tape node of a recorded segment: its forward hands out the
    replay's values, its backward is :meth:`_Segment.backward`."""

    @staticmethod
    def forward(ctx, seg, *inputs):
        ctx.seg = seg
        values, seg.values = seg.values, None
        return tuple(values)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        return (None,) + tuple(ctx.seg.backward(grads))


class _Segment(object):
    """What a recorded segment's backward needs: the program, the inputs it
    read (with their versions), the generator states it drew from."""

    def __init__(self, key, instrs, ext, versions, gens, gen_states,
                 grad_slots, out_idx, device):
        self.key = key
        self.instrs = instrs
        self.ext = ext
        self.versions = versions
        self.gens = gens
        self.gen_states = gen_states
        self.grad_slots = grad_slots
        self.out_idx = out_idx
        self.device = device
        self.draws = bool(gens)
        self.values = None
        self.fresh = []     # inputs copied for the recompute, anew a flush

    def backward(self, grads):
        for t, ver in zip(self.ext, self.versions):
            if t._version != ver:
                raise RuntimeError(
                    "one of the arrays the bulk segment %s read was modified "
                    "by an in-place operation after its forward (version %d, "
                    "recorded %d): its backward would read the new values"
                    % ([i[0] for i in self.instrs], t._version, ver))
        grads = [g.contiguous() for g in grads]
        if self.device.type != "cuda" or self.draws:
            # the recompute draws again, from generators in the states the
            # forward drew from (eagerly: a graph would advance the
            # framework generators)
            gens = []
            for g, s in zip(self.gens, self.gen_states):
                clone = torch.Generator(device=g.device)
                clone.set_state(s)
                gens.append(clone)
            return _vjp(self.instrs, self.grad_slots, self.out_idx,
                        self.ext, grads, gens)
        n = len(self.ext)
        key = (self.key, tuple(self.grad_slots), tuple(self.out_idx))
        results, captured = _run_cuda(
            _seg_vjp_cache, key,
            # the graph's function holds the program, not this segment's
            # inputs
            functools.partial(_vjp_graph, self.instrs, self.grad_slots,
                              self.out_idx, n),
            list(self.ext) + grads, [], self.device,
            owned=self.fresh + list(range(n, n + len(grads))))
        _stats["backward_captures" if captured else "backward_replays"] += 1
        return results


def _vjp(instrs, grad_slots, out_idx, ext, grads, gens):
    """The gradients, with respect to ``ext[grad_slots]``, of the program's
    outputs ``out_idx`` seeded with ``grads``: its forward run again under
    grad."""
    ext = list(ext)
    leaves = []
    for s in grad_slots:
        leaf = ext[s].detach().requires_grad_(True)
        ext[s] = leaf
        leaves.append(leaf)
    with torch.enable_grad():
        outs = _run_program(instrs, ext, gens, out_idx, grad=True)
        got = torch.autograd.grad(outs, leaves, list(grads),
                                  allow_unused=True)
    return [torch.zeros_like(leaf) if g is None else g
            for g, leaf in zip(got, leaves)]


def _vjp_graph(instrs, grad_slots, out_idx, n, xs):
    return _vjp(instrs, grad_slots, out_idx, xs[:n], xs[n:], [])


def _record_segment_node(instrs, ext, versions, gens, gen_states, pendings,
                         live, results, device, homes):
    """Tie the live float outputs that depend, through recorded ops, on an
    input that requires grad to those inputs by one ``_SegmentFunction``;
    return ``results`` with those outputs replaced by the node's.  An input
    the segment itself stores into (BatchNorm's moving statistics) is
    copied first: the backward's recompute reads it as the forward did."""
    deps = []
    for name, _kw, _key, _train, in_refs, _rng, n_out, rec in instrs:
        found = set()
        if rec:
            nograd = get_op(name).nograd_inputs
            for pos, (tag, i) in enumerate(in_refs):
                if pos in nograd:
                    continue
                if tag == "t":
                    found |= deps[i]
                elif ext[i].requires_grad and ext[i].is_floating_point():
                    found.add(i)
        deps.extend([frozenset(found)] * n_out)
    outs = [(pos, i) for pos, i in enumerate(live)
            if deps[i] and pendings[i].dtype.is_floating_point]
    if not outs:
        return results
    grad_slots = sorted(set().union(*(deps[i] for _, i in outs)))
    key = _program_key(instrs, ext, gens, live, device) \
        if device.type == "cuda" else None
    seg_ext, seg_versions, fresh = list(ext), list(versions), []
    for i, t in enumerate(ext):
        if storage_ptr(t) in homes:
            seg_ext[i] = t.detach().clone()
            seg_versions[i] = seg_ext[i]._version
            fresh.append(i)
    seg = _Segment(key, instrs, seg_ext, seg_versions, list(gens),
                   gen_states, grad_slots, [i for _, i in outs], device)
    seg.fresh = fresh
    seg.values = [results[pos] for pos, _ in outs]
    with torch.enable_grad():
        tied = _SegmentFunction.apply(seg, *[ext[s] for s in grad_slots])
    if isinstance(tied, torch.Tensor):
        tied = (tied,)
    results = list(results)
    for (pos, _), t in zip(outs, tied):
        results[pos] = t
    return results


# ---------------------------------------------------------------------------
# flatten/unflatten glue
# ---------------------------------------------------------------------------

def flatten_arrays(arrs):
    """Concatenate tensors into one flat tensor."""
    return torch.cat([a.reshape(-1) for a in arrs])


def unflatten(flat, shapes):
    """Views of ``flat`` split into ``shapes``."""
    sizes = []
    for s in shapes:
        n = 1
        for d in s:
            n *= d
        sizes.append(n)
    return tuple(p.view(tuple(s)) for p, s in
                 zip(torch.split(flat, sizes), shapes))


def split_flat(flat, shapes):
    """:func:`unflatten` as new tensors, the split sizes cached by shapes."""
    shapes = tuple(tuple(s) for s in shapes)
    sizes = _split_cache.get(shapes)
    if sizes is None:
        sizes = _split_cache[shapes] = [
            int(torch.Size(s).numel()) for s in shapes]
    return tuple(p.reshape(s).clone()
                 for p, s in zip(torch.split(flat, sizes), shapes))


def colocate(val, ref):
    """``val`` on ``ref``'s device (itself when it already lies there)."""
    return val if val.device == ref.device else val.to(ref.device)
