"""Which part of a hot swap stalls concurrent serving, on one CUDA card.

Four closed-loop client threads send 1024-token requests to the full-width
LM of ``bench_transformer.py`` (bf16, served by ``mx.serving.Server``,
max_batch 8, max_wait 5 ms), while another thread does one part of a
swap's work (pinned host allocation of the 1.89 GB of weights, the host
copy into it, the device allocation, the copy up from pinned or pageable
memory, or a whole ``Server.swap``).  Prints each part's seconds beside the
requests' p50, their largest wall and each SLO component's largest value.

    python3 tools/serve_swap_stall.py      # from the repo root, on the card
"""
import json, os, sys, threading, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import numpy as np
import torch
import chip_smoke as cs


def main():
    card = cs.card_line()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import cuda_build, serving
    from incubator_mxnet_tpu_torch.models import TransformerLM, HostXavier
    cuda_build.build_all()
    rs = np.random.RandomState(0)
    net = TransformerLM(**cs.LM_CONFIG)
    net.pos_embed.init = None
    net.initialize(HostXavier(cs.SEED), ctx=mx.gpu(0))
    net.cast("bfloat16")
    net.collect_params().setattr("grad_req", "null")
    lm = cs.last_token(mx, net)
    prompts = [rs.randint(0, 16384, (1024,)).astype(np.int32) for _ in range(32)]
    srv = serving.Server(max_batch=8, max_wait_ms=5)
    h = srv.load("lm", block=lm, example=prompts[0][None])
    srv.warmup("lm", prompts[0])
    host = {n: p.data()._data.cpu() for n, p in lm.collect_params().items()}
    dev = torch.device("cuda", 0)

    def pin_alloc():
        return {n: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                for n, v in host.items()}

    pinned = pin_alloc()

    def host_copy():
        for n, v in host.items():
            pinned[n].copy_(v)

    def dev_alloc():
        return {n: torch.empty(v.shape, dtype=v.dtype, device=dev)
                for n, v in host.items()}

    def h2d():
        side = torch.cuda.Stream(dev)
        with torch.cuda.stream(side):
            out = {n: v.to(dev, non_blocking=True) for n, v in pinned.items()}
        side.synchronize()
        return out

    def h2d_pageable():
        side = torch.cuda.Stream(dev)
        with torch.cuda.stream(side):
            out = {n: v.to(dev, non_blocking=True) for n, v in host.items()}
        side.synchronize()
        return out

    def swap():
        srv.swap("lm", host)

    parts = [("none", None), ("pin_alloc", pin_alloc), ("host_copy", host_copy),
             ("dev_alloc", dev_alloc), ("h2d_pinned", h2d),
             ("h2d_pageable", h2d_pageable), ("swap", swap)]
    for name, fn in parts:
        done = threading.Event()
        box = {}

        def work():
            time.sleep(0.1)
            if fn is not None:
                t0 = time.perf_counter()
                keep = fn()
                box["s"] = time.perf_counter() - t0
                del keep
            time.sleep(0.1)
            done.set()

        w = threading.Thread(target=work)
        w.start()
        results, errors, wall = cs.closed_loop(
            srv, prompts, 4, until=lambda n: done.is_set())
        w.join()
        recs = [r for _, _, r, _ in results]
        walls = sorted(r["wall_s"] for r in recs)
        comp = {c: round(max(r["components"][c] for r in recs) * 1e3, 2)
                for c in serving.slo.COMPONENTS}
        print("stall %-13s part %.3f s | %d requests, p50 %.2f ms, max %.2f "
              "ms, worst component ms %s | %s" % (
                  name, box.get("s", 0.0), len(recs),
                  walls[len(walls) // 2] * 1e3, walls[-1] * 1e3,
                  json.dumps(comp), card), flush=True)
        assert not errors, errors
    srv.close()


main()
