"""Phase 10e's check of chip_smoke.py, repeated over many profiler
sessions on one CUDA card: how many of flash attention's kernel rows a
synchronized session keeps, and whether each was launched and ran inside
its op's span.

    python3 tools/profiler_span_probe.py                 # from the repo root
    python3 tools/profiler_span_probe.py --sessions 12 --wait 0 0.1

Each session runs 4 forwards and backwards of flash attention at (4, 16,
1024, 128) in bf16 under ``mx.profiler`` with ``sync=True``, each followed
by 300 small element-wise ops, then waits ``--wait`` seconds before it
stops the profiler.  One JSON line a session: for each
flash kernel (rows, rows launched inside their op's span, rows run inside
it), the clocks the spans took (``args["clock"]``) and, for a session
whose rows fall short, where its rows lie against their nearest span.  A
summary line for each wait counts the sessions with a row outside its span
and those with fewer rows than ran; the card's name and power limit close
the output.
"""
import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import numpy as np
import torch
import chip_smoke as cs

ITERS, EXTRA = 4, 300


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=20)
    ap.add_argument("--wait", type=float, nargs="+", default=[0.0])
    args = ap.parse_args()
    card = cs.card_line()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import cuda_build
    cuda_build.build_all()
    nd, prof = mx.nd, mx.profiler
    rs = np.random.RandomState(0)
    qkv = [nd.array(rs.standard_normal((4, 16, 1024, 128)).astype(
        np.float32), ctx=mx.gpu(0)).astype("bfloat16") for _ in range(3)]
    for a in qkv:
        a.attach_grad()
    small = nd.ones((64, 64), ctx=mx.gpu(0))

    def work(n):
        for _ in range(n):
            with mx.autograd.record():
                o = nd.contrib.FlashAttention(*qkv, causal=True)
            o.backward()
            y = small
            for _ in range(EXTRA):
                y = y * 1.0001 + 0.5

    work(2)
    torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="span-probe-", dir=os.getcwd())
    for wait in args.wait:
        outside = short = 0
        for i in range(args.sessions):
            path = os.path.join(tmp, "trace-%d.json" % i)
            prof.set_config(filename=path, sync=True, profile_memory=True)
            prof.set_state("run")
            work(ITERS)
            time.sleep(wait)
            prof.set_state("stop")
            prof.dump()
            rows = cs._trace_rows(path)
            os.remove(path)
            inside = cs.flash_rows_in_spans(rows, True)
            clocks = {}
            for r in rows:
                if r.get("cat") == "operator" and \
                        "FlashAttention" in r["name"]:
                    key = "%s/%s" % (r["name"],
                                     (r.get("args") or {}).get("clock"))
                    clocks[key] = clocks.get(key, 0) + 1
            out = [k for k, (n, l, rn) in inside.items()
                   if l != n or rn != n]
            few = [k for k in cs.FLASH_KERNELS
                   if inside.get(k, (0, 0, 0))[0] < ITERS]
            outside += bool(out)
            short += bool(few)
            detail = []
            if out or few:
                spans = {}
                for r in rows:
                    if r.get("cat") == "operator" and r.get("ph") == "X":
                        spans.setdefault(r["name"], []).append(
                            (r["ts"], r["ts"] + r["dur"]))
                for r in rows:
                    kind = next((k for k in cs.FLASH_KERNELS
                                 if k in r["name"]), None) \
                        if r.get("cat") == "kernel" else None
                    own = spans.get(cs.FLASH_KERNELS[kind], []) \
                        if kind else []
                    if own:
                        s = min(own, key=lambda s: abs(s[0] - r["ts"]))
                        detail.append((kind, round(r["ts"] - s[0], 3),
                                       round(s[1] - r["ts"] - r["dur"], 3)))
            print(json.dumps(dict(
                wait=wait, session=i,
                inside={k: list(v) for k, v in inside.items()},
                clocks=clocks, outside=out, short=few,
                detail=detail[:12])), flush=True)
        print("span probe: wait %.3f s: %d of %d sessions with a flash row "
              "outside its span, %d with fewer than %d rows of a kernel | %s"
              % (wait, outside, args.sessions, short, ITERS, card),
              flush=True)
    os.rmdir(tmp)
    print(card)


if __name__ == "__main__":
    main()
