"""Profiler: MXNet's profiler API over ``torch.profiler``.

Counterpart of ``incubator_mxnet_tpu/profiler.py`` (ref:
python/mxnet/profiler.py: ``set_config``, ``set_state``, ``pause``,
``resume``, ``dump``, ``dumps`` and the Domain/Task/Frame/Event/Counter/
Marker objects).

While the profiler runs, every registry op that ``ndarray.invoke``
dispatches, and every forward and backward of the symbolic Executor, is a
span (:func:`op_span`): a ``torch.profiler.record_function`` in a
``torch.profiler`` session that ``set_state("run")`` opens, with the CPU
activity and, when CUDA is available, the card's kernels.  So torch's ops,
the CUDA runtime calls and the kernels they launch land in the same trace
as the spans, on one clock.  ``set_state("stop")`` reads that trace back:
each span takes its ``record_function`` row's times, and the kernel rows
stay with it.  The custom objects and the spans' host clock
(``time.perf_counter``) are aligned to torch's clock through an anchor
span opened at the start of the session.  :func:`dump` writes it all as
one chrome trace (times in microseconds of ``perf_counter``);
:func:`dumps` aggregates the spans by name.

``sync=True`` waits for the card inside each op's span, at its start and
at its end, so a span covers its kernels' device time and the kernel rows
fall inside it; without it a span is the host time of the dispatch and its
kernels run later.  torch keeps two clocks in one trace: its CPU rows
(``record_function``, ATen ops) come from an approximate clock calibrated
at the session's start, while CUPTI stamps the kernels and the CUDA
runtime calls.  The two drift apart by up to milliseconds within a session
on some hosts, so each wait of a synchronized span also leaves a mark
(:func:`_clock_mark`: ``item()`` of a one-element card tensor), whose ATen
row lies inside the span on torch's clock and owns a copy and a stream
synchronize stamped by CUPTI; the span takes the times of those (from its
first mark's first call to its last mark's last).  CUPTI's device rows
drift from its host rows too, so the marks' copies also map the kernels
and copies onto the host rows' clock (:func:`_align_device_rows`): a
synchronized span, its launches and its kernels then share one clock.  Each span's ``args["clock"]``
says which clock its times are on: ``cupti``, ``torch`` or ``host``
(``perf_counter``, for a name whose ``record_function`` rows the trace did
not match one to one).  When the
profiler is off, :func:`op_span` returns None after one flag check.  During
a ``pause`` no span opens, while torch's session records on.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import threading
import time

import torch

__all__ = ["set_config", "set_state", "state", "dump", "dumps", "pause",
           "resume", "device_memory", "record_memory_snapshot", "op_span",
           "want_sync", "Domain", "Task", "Frame", "Event", "Counter",
           "Marker"]

_lock = threading.Lock()
# what a caller enters when op_span returns None: ``with op_span(name) or
# NO_SPAN:``
NO_SPAN = contextlib.nullcontext()
_ANCHOR = "mx.profiler.anchor"
_SPAN_CATS = ("operator", "symbolic")
_DURATION_CATS = _SPAN_CATS + ("task", "frame", "event")


class _ProfilerState:
    """The process's profiler (ref: profiler.h Profiler::Get)."""

    def __init__(self):
        self.running = False
        self.paused = False
        self.on = False             # running and not paused: the hot flag
        self.filename = "profile.json"
        self.profile_imperative = True
        self.profile_symbolic = True
        self.profile_memory = False
        self.profile_api = True
        self.aggregate_stats = False
        self.continuous_dump = False
        self.sync = False
        self.events = []            # chrome trace events, perf_counter us
        self.session = None         # the torch.profiler session
        self.session_spans = []     # this session's span events
        self.anchor_us = None


_P = _ProfilerState()


def set_config(**kwargs):
    """ref: profiler.py set_config.  Keys: filename, profile_all,
    profile_imperative, profile_symbolic, profile_memory, profile_api,
    aggregate_stats, continuous_dump, sync (wait for the card inside each
    op's span)."""
    if kwargs.pop("profile_all", False):
        _P.profile_imperative = _P.profile_symbolic = True
        _P.profile_memory = _P.profile_api = True
    for key in ("filename", "profile_imperative", "profile_symbolic",
                "profile_memory", "profile_api", "aggregate_stats",
                "continuous_dump", "sync"):
        if key in kwargs:
            setattr(_P, key, kwargs.pop(key))
    if kwargs:
        raise ValueError("unknown profiler config keys: %s" % list(kwargs))


def _now_us():
    return time.perf_counter_ns() / 1e3


def _start_session():
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        if torch.cuda.is_initialized():
            # the mark tensor made outside the session's spans
            dev = torch.cuda.current_device()
            _marks.setdefault(dev, torch.zeros(1, device="cuda:%d" % dev))
    session = profile(activities=activities)
    session.start()
    _P.session, _P.session_spans = session, []
    with record_function(_ANCHOR):
        _P.anchor_us = _now_us()


def _stop_session():
    """Close the torch session and merge its trace into the events
    (:func:`_merge_trace`)."""
    session, spans, anchor = _P.session, _P.session_spans, _P.anchor_us
    _P.session, _P.session_spans = None, []
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    session.stop()
    fd, path = tempfile.mkstemp(suffix=".json", dir=os.path.dirname(
        os.path.abspath(_P.filename)))
    os.close(fd)
    try:
        session.export_chrome_trace(path)
        with open(path) as f:
            rows = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    kept = _merge_trace(rows, spans, anchor)
    with _lock:
        _P.events.extend(kept)


_MARK_OP = "aten::_local_scalar_dense"
_marks = {}                 # device index -> the one-element mark tensor


def _clock_mark():
    """Wait for the card and mark CUPTI's clock in the trace (a
    synchronized span calls it as it opens and as it closes)."""
    torch.cuda.synchronize()
    dev = torch.cuda.current_device()
    mark = _marks.get(dev)
    if mark is None:
        mark = _marks[dev] = torch.zeros(1, device="cuda:%d" % dev)
    mark.item()


def _owned_marks(rows):
    """{id(record_function row): [mark rows]}: each ``_MARK_OP`` row under
    the innermost ``user_annotation`` row of its thread that contains it
    (both on torch's clock), in time order."""
    by_tid = {}
    for r in rows:
        if r.get("ph") != "X":
            continue
        if r.get("cat") == "user_annotation":
            by_tid.setdefault(r.get("tid"), []).append(
                (r["ts"], 0, -r["dur"], r))
        elif r.get("cat") == "cpu_op" and r.get("name") == _MARK_OP:
            by_tid.setdefault(r.get("tid"), []).append((r["ts"], 1, 0, r))
    owned = {}
    for events in by_tid.values():
        # by start; at one start the outer (longer) annotation first
        events.sort(key=lambda e: e[:3])
        stack = []
        for ts, is_mark, _, r in events:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= ts:
                stack.pop()
            if is_mark:
                if stack:
                    owned.setdefault(id(stack[-1]), []).append(r)
            else:
                stack.append(r)
    return owned


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")


def _align_device_rows(rows, calls):
    """Move CUPTI's device rows (kernels, copies) onto the clock of its
    host rows (the CUDA calls), in place.  CUPTI stamps a kernel on the
    card's clock and converts it to the host's, and on some hosts that
    conversion drifts: a kernel's row can begin hundreds of microseconds
    before the call that launched it.  Each mark's copy is a knot: it runs on an idle
    card right after its ``cudaMemcpyAsync`` starts, so its device start
    maps onto that call's start; between knots the map is linear, past the
    ends it keeps the nearest knot's offset.  The marks bracket a
    synchronized span's work on both clocks, so its kernels land between
    its marks' calls."""
    copies = {}
    for r in rows:
        if r.get("cat") == "cpu_op" and r.get("name") == _MARK_OP:
            for c in calls.get((r.get("args") or {}).get("External id"), []):
                if c.get("name", "").startswith("cudaMemcpy"):
                    copies[(c.get("args") or {}).get("correlation")] = c
    knots = sorted((r["ts"], copies[cid]["ts"]) for r in rows
                   if r.get("cat") == "gpu_memcpy" and
                   (cid := (r.get("args") or {}).get("correlation"))
                   in copies)
    mono = []
    for dev, host in knots:
        if not mono or (dev > mono[-1][0] and host > mono[-1][1]):
            mono.append((dev, host))
    if not mono:
        return
    devs = [d for d, _ in mono]

    def to_host(t):
        i = bisect.bisect_right(devs, t)
        if i == 0 or i == len(mono):
            d, h = mono[max(i - 1, 0)]
            return t + (h - d)
        (d0, h0), (d1, h1) = mono[i - 1], mono[i]
        return h0 + (t - d0) * (h1 - h0) / (d1 - d0)

    for r in rows:
        if r.get("ph") == "X" and r.get("cat") in _DEVICE_CATS:
            start, end = to_host(r["ts"]), to_host(r["ts"] + r["dur"])
            r["ts"], r["dur"] = start, max(end - start, 0.0)


def _merge_trace(rows, spans, anchor):
    """Move torch's ``rows`` onto the perf_counter clock by the anchor
    span's row and give each span of ``spans`` its times: a synchronized
    span those of its marks' CUDA calls (CUPTI's clock), any other the
    times of its ``record_function`` row (torch's CPU clock), a name whose
    rows do not pair one to one its host times.  Returns the rows to keep
    beside the spans."""
    anchor_rows = [r for r in rows if r.get("name") == _ANCHOR]
    if not anchor_rows:
        raise RuntimeError("the torch.profiler trace has no anchor span")
    shift = anchor_rows[0]["ts"] - anchor
    by_key, calls = {}, {}
    for r in rows:
        if r.get("ph") != "M" and "ts" in r:
            r["ts"] = r["ts"] - shift
        if r.get("cat") == "user_annotation":
            by_key.setdefault((r.get("tid"), r["name"]), []).append(r)
        elif r.get("cat") in ("cuda_runtime", "cuda_driver"):
            eid = (r.get("args") or {}).get("External id")
            if eid is not None:
                calls.setdefault(eid, []).append(r)
    _align_device_rows(rows, calls)
    owned = _owned_marks(rows)
    mine = {}
    for ev in spans:
        mine.setdefault((ev["tid"], ev["name"]), []).append(ev)
    taken = set()
    for key, evs in mine.items():
        found = by_key.get(key, [])
        if len(found) != len(evs):
            for ev in evs:
                ev["args"]["clock"] = "host"
            continue
        for ev, r in zip(sorted(evs, key=lambda e: e["ts"]),
                         sorted(found, key=lambda r: r["ts"])):
            taken.add(id(r))
            marks = owned.get(id(r), [])
            first = last = []
            if ev["args"].get("device_time") and len(marks) >= 2:
                first = calls.get((marks[0].get("args") or {}).get(
                    "External id"), [])
                last = calls.get((marks[-1].get("args") or {}).get(
                    "External id"), [])
            if first and last:
                ev["ts"] = min(c["ts"] for c in first)
                ev["dur"] = max(c["ts"] + c["dur"] for c in last) - ev["ts"]
                ev["args"]["clock"] = "cupti"
            else:
                ev["ts"], ev["dur"] = r["ts"], r["dur"]
                ev["args"]["clock"] = "torch"
    return [r for r in rows if id(r) not in taken
            and r.get("name") != _ANCHOR]


def set_state(state="stop"):
    """ref: profiler.py set_state: ``'run'`` opens a torch.profiler session
    and the spans, ``'stop'`` closes them (and dumps with
    ``continuous_dump``)."""
    if state not in ("run", "stop"):
        raise ValueError("state must be 'run' or 'stop'")
    if state == "run" and not _P.running:
        _start_session()
        _P.running, _P.paused = True, False
        _P.on = True
    elif state == "stop" and _P.running:
        _P.running = _P.on = False
        _stop_session()
        if _P.continuous_dump:
            dump()


def state():
    return "run" if _P.running else "stop"


def pause():
    """ref: profiler.py pause: no span opens until :func:`resume`."""
    _P.paused = True
    _P.on = False


def resume():
    """ref: profiler.py resume."""
    _P.paused = False
    _P.on = _P.running


def _record(ev):
    with _lock:
        _P.events.append(ev)


class _OpSpan(object):
    """One op's span: a record_function and an event on the host clock."""

    __slots__ = ("name", "cat", "begin", "rf")

    def __init__(self, name, cat):
        self.name = name
        self.cat = cat

    def __enter__(self):
        self.begin = _now_us()
        self.rf = torch.autograd.profiler.record_function(self.name)
        self.rf.__enter__()
        if _P.sync and torch.cuda.is_available() and \
                torch.cuda.is_initialized():
            _clock_mark()
        return self

    def __exit__(self, exc_type, exc, tb):
        sync = _P.sync
        if sync and torch.cuda.is_available() and torch.cuda.is_initialized():
            _clock_mark()
        self.rf.__exit__(None, None, None)
        end = _now_us()
        args = {"device_time": sync}
        if exc_type is not None:
            args["error"] = True
        ev = {"name": self.name, "cat": self.cat, "ph": "X", "ts": self.begin,
              "dur": end - self.begin, "pid": os.getpid(),
              "tid": threading.get_native_id(), "args": args}
        with _lock:
            _P.events.append(ev)
            if _P.session is not None:
                _P.session_spans.append(ev)
        return False


def op_span(name, kind="imperative"):
    """The span of one op (``kind`` ``"imperative"``, from ``invoke``) or
    of an Executor pass (``"symbolic"``): a context manager while the
    profiler runs, else None."""
    if not _P.on:
        return None
    if kind == "imperative":
        return _OpSpan(name, "operator") if _P.profile_imperative else None
    return _OpSpan(name, "symbolic") if _P.profile_symbolic else None


def want_sync():
    """Whether spans wait for the card (sync mode, while running)."""
    return _P.on and _P.sync


def dump(finished=True):
    """Write the chrome trace (ref: profiler.py dump) to the configured
    filename and return it: the spans, torch's CPU rows and the card's
    kernel rows of every closed session, and the custom objects.  Open it
    at chrome://tracing or https://ui.perfetto.dev.  ``finished`` drops
    the events written."""
    with _lock:
        events = list(_P.events)
        if finished:
            _P.events = []
    meta = [{"name": "process_name", "ph": "M", "pid": os.getpid(),
             "args": {"name": "incubator_mxnet_tpu_torch"}}]
    doc = {"traceEvents": meta + events, "displayTimeUnit": "ms",
           "otherData": {"clock": "time.perf_counter, microseconds"}}
    with open(_P.filename, "w") as f:
        json.dump(doc, f)
    return _P.filename


def device_memory():
    """Per-card memory from ``torch.cuda.memory_stats()``: bytes in use,
    their peak, the card's size and the allocations made; an empty list
    without CUDA."""
    out = []
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out.append({
            "device": "gpu(%d)" % i,
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(torch.cuda.get_device_properties(
                i).total_memory),
            "num_allocs": int(stats.get("allocation.all.allocated", 0)),
            "source": "allocator",
        })
    return out


def record_memory_snapshot(name="device_memory"):
    """A counter event of each card's bytes in use and their peak."""
    if not _P.on:
        return
    ts = _now_us()
    for m in device_memory():
        _record({"name": name, "cat": "memory", "ph": "C", "ts": ts,
                 "pid": m["device"],
                 "args": {"bytes_in_use": m["bytes_in_use"],
                          "peak_bytes_in_use": m["peak_bytes_in_use"]}})


def stats(reset=False):
    """``{(cat, name): (calls, total_us, min_us, max_us)}`` of the spans
    and duration objects recorded so far."""
    with _lock:
        events = list(_P.events)
        if reset:
            _P.events = []
    out = {}
    for ev in events:
        if ev.get("cat") not in _DURATION_CATS or "dur" not in ev:
            continue
        n, tot, mn, mx = out.get((ev["cat"], ev["name"]),
                                 (0, 0.0, float("inf"), 0.0))
        d = ev["dur"]
        out[(ev["cat"], ev["name"])] = (n + 1, tot + d, min(mn, d),
                                        max(mx, d))
    return out


def dumps(reset=False):
    """The aggregate table (ref: profiler.py dumps): calls and times of
    every span name, and each card's memory with ``profile_memory``."""
    lines = ["%-32s %8s %12s %12s %12s %12s"
             % ("Name", "Calls", "Total(us)", "Min(us)", "Max(us)", "Avg(us)")]
    for (_cat, name), (cnt, tot, mn, mx) in sorted(
            stats(reset).items(), key=lambda kv: -kv[1][1]):
        lines.append("%-32s %8d %12.1f %12.1f %12.1f %12.1f"
                     % (name[:32], cnt, tot, mn, mx, tot / cnt))
    if _P.profile_memory:
        lines.append("")
        lines.append("%-24s %16s %16s %16s %12s"
                     % ("Device memory", "InUse(bytes)", "Peak(bytes)",
                        "Limit(bytes)", "Allocs"))
        for m in device_memory():
            lines.append("%-24s %16d %16d %16d %12d"
                         % (m["device"], m["bytes_in_use"],
                            m["peak_bytes_in_use"], m["bytes_limit"],
                            m["num_allocs"]))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# custom objects (ref: python/mxnet/profiler.py Domain, Task, Frame, Event,
# Counter, Marker)
# ---------------------------------------------------------------------------

class Domain(object):
    """A named group of custom objects (ref: profiler.py Domain)."""

    def __init__(self, name):
        self.name = name

    def new_task(self, name):
        return Task(self, name)

    def new_frame(self, name):
        return Frame(self, name)

    def new_counter(self, name, value=None):
        return Counter(self, name, value)

    def new_marker(self, name):
        return Marker(self, name)

    def __str__(self):
        return self.name


class _DurationObject(object):
    """A start/stop pair, one complete event (Task, Frame, Event)."""

    _cat = "task"

    def __init__(self, domain, name):
        self.domain = domain
        self.name = name
        self._begin = None

    def start(self):
        self._begin = _now_us()

    def stop(self):
        if self._begin is None:
            raise RuntimeError("%s %r stopped before start"
                               % (type(self).__name__, self.name))
        if _P.on:
            end = _now_us()
            ev = {"name": self.name, "cat": self._cat, "ph": "X",
                  "ts": self._begin, "dur": end - self._begin,
                  "pid": os.getpid(), "tid": threading.get_native_id()}
            if self.domain is not None:
                ev["args"] = {"domain": str(self.domain)}
            _record(ev)
        self._begin = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def __str__(self):
        return self.name


class Task(_DurationObject):
    """ref: profiler.py Task."""
    _cat = "task"


class Frame(_DurationObject):
    """ref: profiler.py Frame."""
    _cat = "frame"


class Event(_DurationObject):
    """ref: profiler.py Event: a duration without a domain."""
    _cat = "event"

    def __init__(self, name):
        super().__init__(None, name)


class Counter(object):
    """A user counter; every value set while running is a counter event
    (ref: profiler.py Counter)."""

    def __init__(self, domain, name, value=None):
        self.domain = domain
        self.name = name
        self.value = 0
        if value is not None:
            self.set_value(value)

    def set_value(self, value):
        self.value = value
        if _P.on:
            _record({"name": self.name, "cat": "counter", "ph": "C",
                     "ts": _now_us(), "pid": os.getpid(),
                     "args": {self.name: value}})

    def increment(self, delta=1):
        self.set_value(self.value + delta)

    def decrement(self, delta=1):
        self.set_value(self.value - delta)

    def __iadd__(self, v):
        self.increment(v)
        return self

    def __isub__(self, v):
        self.decrement(v)
        return self

    def __str__(self):
        return self.name


class Marker(object):
    """An instant event (ref: profiler.py Marker)."""

    def __init__(self, domain, name):
        self.domain = domain
        self.name = name

    def mark(self, scope="process"):
        if _P.on:
            _record({"name": self.name, "cat": "marker", "ph": "i",
                     "ts": _now_us(), "pid": os.getpid(),
                     "tid": threading.get_native_id(),
                     "s": {"process": "p", "global": "g",
                           "thread": "t"}.get(scope, "p")})
