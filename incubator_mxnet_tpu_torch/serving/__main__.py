"""The serving runtime's CLI.

    python -m incubator_mxnet_tpu_torch.serving --selftest [--device cpu]
        A Dense MLP serves threaded traffic through the dynamic batcher
        (every response bit-equal to the bucket-1 program, and on the CPU
        to the eager forward; on the card the eager forward's max |Δ| is
        printed and bounded), the per-request SLO decomposition must
        conserve exactly, a mid-traffic hot-swap must flip atomically
        (every response entirely old- or new-version), and a tight
        residency budget must LRU-evict and transparently reload.  Runs on
        the card unless ``--device cpu``; with no card it raises.  Exit 1
        on any failed check.

    python -m incubator_mxnet_tpu_torch.serving --demo [--json] [--device cpu]
        Serve a few hundred requests and print the SLO summary and the
        registry's stats.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading

import numpy as np

# the card's eager forward may take other cuBLAS kernels than its captured
# programs: their difference is bounded, not required to be 0
EAGER_TOLERANCE = 1e-5


def _context(device):
    import incubator_mxnet_tpu_torch as mx
    ctx = mx.cpu() if device == "cpu" else mx.gpu(0)
    ctx.torch_device()      # no card and no --device cpu: MXNetError
    return ctx


def _build_net(ctx, seed=0, din=16, dh=32, dout=8, scale=1.0):
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon

    class MLP(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.d1 = gluon.nn.Dense(dh, activation="relu")
                self.d2 = gluon.nn.Dense(dout)

        def hybrid_forward(self, F, x):
            return F.Activation(self.d2(self.d1(x)), act_type="tanh")

    net = MLP()
    net.initialize(ctx=ctx)
    net.hybridize()
    rs = np.random.RandomState(seed)
    net(mx.nd.array(rs.randn(1, din).astype(np.float32), ctx=ctx))  # shapes
    for _name, p in net.collect_params().items():
        p.set_data(mx.nd.array(
            (rs.randn(*p.shape) * 0.5 * scale).astype(np.float32), ctx=ctx))
    return net


def selftest(device="gpu"):
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import serving

    ctx = _context(device)
    failures = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)
            print("graftserve selftest FAIL: %s" % msg, file=sys.stderr)

    din = 16
    net = _build_net(ctx, din=din)
    rs = np.random.RandomState(7)
    example = rs.randn(din).astype(np.float32)

    def eager(x):
        return net(mx.nd.array(x[None], ctx=ctx)).asnumpy()[0]

    with serving.Server(max_batch=8, max_wait_ms=2) as srv:
        srv.load("mlp", block=net, example=mx.nd.array(example[None],
                                                       ctx=ctx))
        srv.warmup("mlp", example)      # the per-request example shape
        handle = srv.registry.get("mlp")

        def bucket1(x, params=None):
            entry, current, _v = srv.registry.acquire("mlp")
            xb = serving.stack_inputs([(x,)], 1, entry.device)[0]
            out = entry.jit_for(1)(current if params is None else params, xb)
            return serving.batcher.host_rows(out)[0]

        # threaded traffic: every batched response bit-equal to the
        # bucket-1 program (and on the CPU to the eager forward)
        xs = [rs.randn(din).astype(np.float32) for _ in range(24)]
        futs = [None] * len(xs)

        def client(lo, hi):
            for i in range(lo, hi):
                futs[i] = srv.submit("mlp", xs[i])

        threads = [threading.Thread(target=client, args=(k * 8, k * 8 + 8))
                   for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        outs = [f.get(timeout=60.0) for f in futs]
        eager_err = 0.0
        for i, (x, y) in enumerate(zip(xs, outs)):
            ref = bucket1(x)
            if y.tobytes() != ref.tobytes():
                check(False, "request %d: batched != bucket-1 program" % i)
                break
            e = eager(x)
            eager_err = max(eager_err, float(np.abs(e - y).max()))
            if ctx.device_type == "cpu" and e.tobytes() != y.tobytes():
                check(False, "request %d: batched != eager forward" % i)
                break
        else:
            print("parity: %d threaded requests bit-equal to the bucket-1 "
                  "program; eager forward max |d| %.3e (%s)"
                  % (len(outs), eager_err, ctx))
        check(eager_err <= EAGER_TOLERANCE, "eager forward differs by %.3e"
              % eager_err)
        check(not handle.no_batch,
              "the parity probe demoted a signature on the reference MLP")
        if ctx.device_type == "gpu":
            check(handle.captures >= 1, "no CUDA graph was captured")
            print("graphs: %d captured, cached %s" % (
                handle.captures, sorted(str(k[0]) for k in
                                        handle.graph_keys())))

        # SLO conservation: the four components sum EXACTLY to wall
        for f in futs:
            r = f.record
            s = sum(r["components"][c] for c in serving.slo.COMPONENTS)
            check(s == r["wall_s"],
                  "decomposition not conserved: %r != %r" % (s, r["wall_s"]))
        print("conservation: queue_wait+batch_assembly+device_compute+"
              "host_io == wall for all %d requests" % len(futs))
        check(any(f.record["batch_size"] > 1 for f in futs),
              "no batch assembled more than one request")

        # hot-swap mid-traffic: every response entirely old or new
        _fn, pv = net.serving_fn(mx.nd.array(example[None], ctx=ctx))
        new_params = {n: v.detach() * 2.0 for n, v in pv.items()}
        ticket = srv.begin_swap("mlp", new_params)
        pre = srv.predict("mlp", xs[0])     # old version still serving
        v2 = ticket.commit()
        post = srv.predict("mlp", xs[0])
        check(v2 == 2, "swap did not bump the version (got %r)" % v2)
        check(pre.tobytes() == outs[0].tobytes(),
              "pre-commit response changed under an in-flight swap")
        check(post.tobytes() != outs[0].tobytes(),
              "post-commit response still serves old weights")
        check(post.tobytes() == bucket1(xs[0]).tobytes(),
              "post-commit response differs from the new version's "
              "bucket-1 program")

    # LRU eviction under a tight budget: nothing fits next to anything; a
    # request to the evicted model transparently reloads it
    h = serving.ModelRegistry(memory_bytes=1)
    nets = [_build_net(ctx, seed=s) for s in (1, 2)]
    ex = mx.nd.array(example[None], ctx=ctx)
    ha = h.load_block("a", nets[0], ex)
    hb = h.load_block("b", nets[1], ex)
    check(not ha.resident and hb.resident,
          "budget=1: expected only the newest model resident "
          "(a=%s b=%s)" % (ha.resident, hb.resident))
    before = serving.batcher.host_rows(ha.predict(example[None]))
    check(ha.resident and not hb.resident,
          "acquire did not reload the evicted model / evict the LRU one")
    check(h.reloads_total >= 1 and h.evictions_total >= 2,
          "eviction/reload counters did not move: %r" % (h.stats(),))
    h.evict("a")
    again = serving.batcher.host_rows(ha.predict(example[None]))
    check(again.tobytes() == before.tobytes() and ha.version == 1,
          "a reload did not restore the same version bit for bit")
    print("residency: LRU eviction + transparent reload under a tight "
          "budget OK (evictions=%d reloads=%d)"
          % (h.evictions_total, h.reloads_total))

    if failures:
        print("graftserve selftest: %d failure(s)" % len(failures),
              file=sys.stderr)
        return 1
    print("graftserve selftest OK (batched parity, SLO conservation, "
          "atomic hot-swap, LRU residency) on %s" % ctx)
    return 0


def demo(as_json=False, device="gpu"):
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import serving

    ctx = _context(device)
    net = _build_net(ctx)
    rs = np.random.RandomState(3)
    with serving.Server(max_batch=16, max_wait_ms=1) as srv:
        srv.load("mlp", block=net, example=mx.nd.array(
            rs.randn(1, 16).astype(np.float32), ctx=ctx))
        futs = [srv.submit("mlp", rs.randn(16).astype(np.float32))
                for _ in range(256)]
        for f in futs:
            f.get(timeout=60.0)
        stats = srv.stats()
    if as_json:
        print(json.dumps(stats, default=str))
    else:
        s = stats["slo"]
        print("graftserve demo on %s: %d requests, %d batches "
              "(mean batch %.1f)" % (ctx, stats["requests"],
                                     stats["batches"],
                                     s.get("mean_batch_size", 0)))
        print("  latency p50 %.3fms p99 %.3fms | components (mean ms): %s"
              % (s.get("p50_ms", 0), s.get("p99_ms", 0),
                 s.get("components_ms")))
        print("  registry: %s" % stats["registry"])
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m incubator_mxnet_tpu_torch.serving")
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", choices=("gpu", "cpu"), default="gpu",
                    help="where the model runs (default: the card, gpu(0))")
    args = ap.parse_args(argv)
    if args.selftest:
        return selftest(args.device)
    if args.demo:
        return demo(as_json=args.json, device=args.device)
    ap.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
