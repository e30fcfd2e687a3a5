"""The head step's profile (chip_smoke.train_head) after each earlier phase
of chip_smoke.py, on one CUDA card: which phase makes torch.profiler lose
kernels of a call that starts at the profiler window's edge.

    python3 tools/head_profile_probe.py    # from the repo root, on the card

Each "=== head step after ..." line is followed by the step's profile line
(device busy against the wall).
"""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import numpy as np
import torch
import chip_smoke as cs


def main():
    card = cs.card_line()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import cuda_build
    from incubator_mxnet_tpu_torch.models import TransformerLM, HostXavier
    cuda_build.build_all()
    cuda_build.load_extension("_rtc_launch")
    dev = torch.device("cuda", 0)
    _mod, kernels = cs.rtc_module(mx)
    cs.register_rtc_softmax(mx, kernels)

    def head(tag):
        print("=== head step after %s" % tag, flush=True)
        cs.train_head(mx, kernels, dev, card)

    head("setup")
    rs = np.random.RandomState(0)
    net = TransformerLM(**cs.LM_CONFIG)
    net.pos_embed.init = None
    net.initialize(HostXavier(cs.SEED), ctx=mx.gpu(0))
    net.cast("bfloat16")
    net.collect_params().setattr("grad_req", "null")
    x = mx.nd.array(rs.randint(0, 16384, (8, 1024)), ctx=mx.gpu(0),
                    dtype="int32")

    def request():
        with mx.autograd.predict_mode():
            net(x).wait_to_read()

    request()
    head("4b's requests, before a profile")
    cs.profile_device(request, "one request", {"flash": "flash_fwd"}, 1.0,
                      card)
    head("4b's request profile")
    cs.serve_runtime(mx, net, card, rs)
    head("4f")
    del net, x
    cs.serve_wide_lm(mx, card, rs, [27.9])
    head("4e")
    cs.train_small_lm(mx, card)
    head("4d small")
    cs.train_full_lm(mx, card)
    head("4d full")


main()
