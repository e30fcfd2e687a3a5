"""The port's profiler (``mx.profiler`` over ``torch.profiler``) on the CPU:
the contracts of ``tests/test_profiler.py`` that hold no bulking and no
XLA (operators, pause and the aggregate table, the Executor's span, the
custom objects, sync mode, markers in the table), run on both packages
where they compare; the spans on torch's clock with torch's rows nested
in them; and ``op_span`` returning None while the profiler is stopped."""
import json

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import profiler as jprofiler
from incubator_mxnet_tpu_torch import profiler


@pytest.fixture(autouse=True)
def _fresh():
    """Each test starts stopped, with the default config and no events."""
    yield
    for p in (profiler, jprofiler):
        p.set_state("stop")
        p.set_config(filename="profile.json", sync=False,
                     profile_imperative=True, profile_symbolic=True,
                     profile_memory=False, aggregate_stats=False,
                     continuous_dump=False)
        p.dumps(reset=True)


def _events(fname):
    with open(fname) as f:
        return json.load(f)["traceEvents"]


@pytest.mark.parametrize("m", [jmx, tmx], ids=["jax", "port"])
def test_profile_operators(m, tmp_path):
    fname = str(tmp_path / "profile_op.json")
    m.profiler.set_config(filename=fname, profile_imperative=True)
    m.profiler.set_state("run")
    with m.cpu():
        a = m.nd.array(np.random.randn(32, 32).astype(np.float32))
        b = m.nd.array(np.random.randn(32, 32).astype(np.float32))
        for _ in range(3):
            c = m.nd.dot(a, b)
        c.asnumpy()
    m.profiler.set_state("stop")
    assert m.profiler.dump() == fname
    dots = [e for e in _events(fname) if e["name"] == "dot" and
            e["ph"] == "X"]
    assert len(dots) >= 3
    assert all(e["dur"] >= 0 and "ts" in e for e in dots)


def test_spans_hold_torch_rows_on_one_clock(tmp_path):
    """Each op span takes its record_function row's times: torch's ATen
    rows of the op lie inside it, on the same thread, and no second row of
    the span is left in the trace."""
    fname = str(tmp_path / "nested.json")
    profiler.set_config(filename=fname)
    profiler.set_state("run")
    with tmx.cpu():
        a = tmx.nd.ones((16, 16))
        for _ in range(2):
            tmx.nd.dot(a, a).asnumpy()
    profiler.set_state("stop")
    profiler.dump()
    rows = _events(fname)
    dots = [e for e in rows if e["name"] == "dot" and e["cat"] == "operator"]
    assert len(dots) == 2
    assert not [e for e in rows if e["name"] == "dot" and
                e.get("cat") == "user_annotation"]
    mms = [e for e in rows if e.get("cat") == "cpu_op" and
           e["name"] in ("aten::mm", "aten::matmul")]
    for d in dots:
        inside = [e for e in mms if e["tid"] == d["tid"] and
                  d["ts"] <= e["ts"] and
                  e["ts"] + e["dur"] <= d["ts"] + d["dur"]]
        assert inside, d
    assert not [e for e in rows if e["name"] == profiler._ANCHOR]


@pytest.mark.parametrize("m", [jmx, tmx], ids=["jax", "port"])
def test_profile_pause_and_aggregate(m, tmp_path):
    m.profiler.set_config(filename=str(tmp_path / "unused.json"))
    m.profiler.set_state("run")
    with m.cpu():
        x = m.nd.ones((8, 8))
        y = x + x
        m.profiler.pause()
        _ = x * x          # not recorded
        m.profiler.resume()
        z = y * y
        z.asnumpy()
    m.profiler.set_state("stop")
    table = m.profiler.dumps(reset=True)
    assert "Calls" in table and "Avg(us)" in table
    lines = [ln for ln in table.splitlines() if ln.strip()]
    assert len(lines) >= 2   # header + at least one op row
    if m is tmx:
        names = {ln.split()[0]: int(ln.split()[1]) for ln in lines[1:]}
        assert names.get("elemwise_mul", names.get("broadcast_mul")) == 1


@pytest.mark.parametrize("m", [jmx, tmx], ids=["jax", "port"])
def test_profile_executor_symbolic(m, tmp_path):
    fname = str(tmp_path / "profile_sym.json")
    m.profiler.set_config(filename=fname, profile_symbolic=True)
    data = m.sym.var("data")
    fc = m.sym.FullyConnected(data, num_hidden=4, name="fc")
    with m.cpu():
        exe = fc.simple_bind(ctx=m.cpu(), data=(2, 8), grad_req="null")
        m.profiler.set_state("run")
        exe.forward(is_train=False, data=m.nd.ones((2, 8)))
        exe.outputs[0].asnumpy()
    m.profiler.set_state("stop")
    m.profiler.dump()
    events = _events(fname)
    assert any(e["name"].startswith("Executor.forward") for e in events)


def test_executor_backward_span_and_symbolic_switch(tmp_path):
    """The port's Executor also names its backward; ``profile_symbolic``
    off drops both spans and keeps the ops'."""
    fname = str(tmp_path / "exec.json")
    profiler.set_config(filename=fname)
    with tmx.cpu():
        data = tmx.sym.var("data")
        fc = tmx.sym.FullyConnected(data, num_hidden=4, name="fcb")
        exe = fc.simple_bind(ctx=tmx.cpu(), data=(2, 8))
        profiler.set_state("run")
        exe.forward(is_train=True, data=tmx.nd.ones((2, 8)))
        exe.backward(tmx.nd.ones((2, 4)))
        profiler.set_config(profile_symbolic=False)
        exe.forward(is_train=False)
    profiler.set_state("stop")
    profiler.dump()
    names = [e["name"] for e in _events(fname) if e.get("cat") == "symbolic"]
    assert names == ["Executor.forward(fcb)", "Executor.backward(fcb)"]
    ops = [e["name"] for e in _events(fname) if e.get("cat") == "operator"]
    assert ops.count("FullyConnected") == 2


@pytest.mark.parametrize("m", [jmx, tmx], ids=["jax", "port"])
def test_profile_custom_objects(m, tmp_path):
    fname = str(tmp_path / "profile_custom.json")
    m.profiler.set_config(filename=fname)
    m.profiler.set_state("run")
    dom = m.profiler.Domain("app")
    with dom.new_task("step"):
        pass
    with m.profiler.Event("tick"):
        pass
    frame = dom.new_frame("iter")
    frame.start()
    frame.stop()
    cnt = dom.new_counter("samples", 0)
    cnt += 5
    cnt -= 2
    dom.new_marker("here").mark("global")
    m.profiler.set_state("stop")
    m.profiler.dump()
    events = _events(fname)
    names = {e["name"] for e in events}
    assert {"step", "tick", "iter", "samples", "here"} <= names
    counter_vals = [e["args"]["samples"] for e in events
                    if e["name"] == "samples"]
    assert counter_vals == [0, 5, 3]
    marker = [e for e in events if e["name"] == "here"][0]
    assert marker["ph"] == "i" and marker["s"] == "g"
    with pytest.raises(RuntimeError, match="before start"):
        m.profiler.Task(dom, "never").stop()


@pytest.mark.parametrize("m", [jmx, tmx], ids=["jax", "port"])
def test_profiler_sync_mode(m, tmp_path):
    fname = str(tmp_path / "profile_sync.json")
    m.profiler.set_config(filename=fname, sync=True)
    m.profiler.set_state("run")
    with m.cpu():
        a = m.nd.ones((64, 64))
        m.nd.dot(a, a)
    m.profiler.set_state("stop")
    m.profiler.set_config(sync=False)
    m.profiler.dump()
    dots = [e for e in _events(fname) if e["name"] == "dot"]
    assert dots
    if m is tmx:
        assert all(e["args"]["device_time"] is True for e in dots)


@pytest.mark.parametrize("m", [jmx, tmx], ids=["jax", "port"])
def test_dumps_survives_marker_events(m, tmp_path):
    """Instant ('i') marker events have no duration: the aggregate table
    skips them."""
    m.profiler.set_config(aggregate_stats=True,
                          filename=str(tmp_path / "markers.json"))
    m.profiler.set_state("run")
    d = m.profiler.Domain("test")
    d.new_marker("hello").mark()
    table = m.profiler.dumps()
    m.profiler.set_state("stop")
    assert "Name" in table


def test_op_span_is_none_while_stopped(tmp_path):
    """Stopped, paused, or with the kind switched off, ``op_span`` is None
    (one flag check on the hot path); running, it is a span."""
    profiler.set_config(filename=str(tmp_path / "spans.json"))
    assert profiler.state() == "stop"
    assert profiler.op_span("dot") is None
    assert profiler.op_span("Executor.forward(x)", "symbolic") is None
    assert not profiler.want_sync()
    profiler.set_state("run")
    try:
        assert profiler.op_span("dot") is not None
        profiler.set_config(profile_imperative=False)
        assert profiler.op_span("dot") is None
        assert profiler.op_span("e", "symbolic") is not None
        profiler.set_config(profile_imperative=True)
        profiler.pause()
        assert profiler.op_span("dot") is None
        profiler.resume()
        assert profiler.op_span("dot") is not None
    finally:
        profiler.set_state("stop")
    assert profiler.op_span("dot") is None
    with pytest.raises(ValueError):
        profiler.set_state("go")
    with pytest.raises(ValueError, match="unknown profiler config"):
        profiler.set_config(xprof_dir="x")


def test_memory_table_and_continuous_dump(tmp_path):
    """``profile_memory`` adds the cards' memory to the table (none on
    this machine); ``continuous_dump`` writes the trace at stop; the port's
    ``record_memory_snapshot`` records no counter without a card."""
    fname = tmp_path / "cont.json"
    profiler.set_config(filename=str(fname), continuous_dump=True,
                        profile_memory=True)
    profiler.set_state("run")
    with tmx.cpu():
        (tmx.nd.ones((4, 4)) * 2).asnumpy()
    profiler.record_memory_snapshot()
    table = profiler.dumps()
    profiler.set_state("stop")
    assert "Device memory" in table and "InUse(bytes)" in table
    assert fname.exists()
    assert profiler.device_memory() == []
    assert not [e for e in _events(str(fname)) if e.get("cat") == "memory"]


def test_synchronized_spans_take_cuptis_clock():
    """torch's CPU rows and CUPTI's kernel and runtime rows drift apart
    by up to milliseconds within a session on some hosts (the card's 10e
    check saw kernels up to 3.6 ms before their span), and Kineto gives a
    ``cudaDeviceSynchronize`` no "External id".  So a span with
    ``sync=True`` takes its times from the CUDA calls of its own marks
    (``aten::_local_scalar_dense`` rows inside it on torch's clock, not
    those of a span nested in it), from the first mark's first call to the
    last mark's last; an unsynchronized span keeps its record_function
    row's times, and a name whose rows do not pair one to one keeps the
    host clock."""
    def row(cat, name, ts, dur, eid=None, tid=1):
        args = {} if eid is None else {"External id": eid}
        return {"name": name, "ph": "X", "ts": ts, "dur": dur, "tid": tid,
                "cat": cat, "args": args}

    def mark(ts, eid):
        return row("cpu_op", profiler._MARK_OP, ts, 2.0, eid)

    def call(name, ts, dur, eid, corr=None):
        r = row("cuda_runtime", name, ts, dur, eid)
        r["args"]["correlation"] = corr
        return r

    def device(cat, name, ts, dur, corr):
        return {"name": name, "ph": "X", "ts": ts, "dur": dur, "tid": 9,
                "cat": cat, "args": {"correlation": corr}}

    def span(name, ts, synced):
        return {"name": name, "cat": "operator", "ph": "X", "ts": ts,
                "dur": 5.0, "tid": 1, "args": {"device_time": synced}}

    rows = [row("user_annotation", profiler._ANCHOR, 1000.0, 1.0),
            # "attn" with its two marks and an inner span "inner" with its
            # own two marks; CUPTI's rows lie 50 us off torch's clock
            row("user_annotation", "attn", 1100.0, 40.0, 11),
            mark(1101.0, 21), call("cudaMemcpyAsync", 1051.0, 1.0, 21, 31),
            call("cudaStreamSynchronize", 1052.0, 2.0, 21),
            # the card's rows 200 us behind CUPTI's host rows: the marks'
            # copies, and a kernel launched at 1071 that ran between them
            device("gpu_memcpy", "Memcpy DtoH", 851.5, 0.5, 31),
            call("cudaLaunchKernel", 1071.0, 1.0, 11, 41),
            device("kernel", "attn_kernel", 872.0, 5.0, 41),
            device("gpu_memcpy", "Memcpy DtoH", 885.5, 0.5, 34),
            row("user_annotation", "inner", 1110.0, 10.0, 12),
            mark(1111.0, 22), call("cudaMemcpyAsync", 1061.0, 1.0, 22),
            mark(1118.0, 23), call("cudaMemcpyAsync", 1068.0, 1.0, 23),
            mark(1135.0, 24), call("cudaMemcpyAsync", 1085.0, 1.0, 24, 34),
            call("cudaStreamSynchronize", 1086.0, 3.0, 24),
            row("user_annotation", "dot", 1200.0, 10.0, 13),
            row("user_annotation", "gone", 1300.0, 10.0, 14)]
    spans = [span("attn", 190.0, True), span("inner", 205.0, True),
             span("dot", 290.0, False), span("gone", 380.0, False),
             span("gone", 390.0, False)]
    kept = profiler._merge_trace(rows, spans, anchor=100.0)
    attn, inner, dot, gone = spans[0], spans[1], spans[2], spans[3]
    # the anchor row at 1000 is 100 on the host clock: shift 900
    assert attn["args"]["clock"] == "cupti"
    assert (attn["ts"], attn["dur"]) == (151.0, 38.0)
    assert inner["args"]["clock"] == "cupti"
    assert (inner["ts"], inner["dur"]) == (161.0, 8.0)
    assert dot["args"]["clock"] == "torch"
    assert (dot["ts"], dot["dur"]) == (300.0, 10.0)
    assert gone["args"]["clock"] == "host" and gone["ts"] == 380.0
    names = [r["name"] for r in kept]
    assert profiler._ANCHOR not in names and "attn" not in names
    assert "gone" in names and names.count(profiler._MARK_OP) == 4
    # the kernel and the copies now on the host rows' clock, the kernel
    # after its launch and inside its span
    kernel = next(r for r in kept if r["name"] == "attn_kernel")
    assert 171.0 < kernel["ts"] and kernel["ts"] + kernel["dur"] <= \
        attn["ts"] + attn["dur"]
    copies = sorted(r["ts"] for r in kept if r["name"] == "Memcpy DtoH")
    assert copies == [151.0, 185.0]


def test_sync_span_marks_the_clock_at_both_ends(monkeypatch):
    """In sync mode a span waits for the card and marks the clock as it
    opens and as it closes (a stubbed card counts the marks)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(profiler, "_clock_mark", lambda: calls.append(1))
    monkeypatch.setattr(profiler._P, "sync", True)
    monkeypatch.setattr(profiler._P, "on", True)
    monkeypatch.setattr(profiler._P, "session", None)
    with profiler.op_span("dot"):
        assert len(calls) == 1
    assert len(calls) == 2
