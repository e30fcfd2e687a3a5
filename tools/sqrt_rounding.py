"""Why the f32 update ops and AdaGrad differ between the card and the CPU.

Counts the f32 square roots that the card and the CPU each round away from
the correctly rounded value (float64 sqrt rounded to f32), on 2·g² for an
fc6-shaped bf16 gradient g (AdaGrad's second-step history) and on 2^24
U[0, 1) values; then runs AdaGrad through multi_precision at lr 0.01 on
0.001·N(0, 1) gradients on both and prints the bf16 weights' difference
in bf16 ulps, element by element and at the largest weight, with the worst
element.

    python3 tools/sqrt_rounding.py      # from the repo root, on the card
"""
import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import numpy as np
import torch
import chip_smoke as cs
import incubator_mxnet_tpu_torch as mx

print("device:", cs.card_line(), torch.__version__, torch.version.cuda,
      torch.backends.cpu.get_cpu_capability(), flush=True)
rs = np.random.default_rng(7)
g = torch.tensor((rs.standard_normal(cs.FC6) * 1e-3).astype(np.float32))
g = g.to(torch.bfloat16).float()
h = g * g + g * g
want = torch.sqrt(h.double()).float()
cpu = torch.sqrt(h)
card = torch.sqrt(h.cuda()).cpu()
print("sqrt of 2g^2, %d values: the CPU differs from correctly rounded in "
      "%d, the card in %d, card vs CPU in %d" % (
          h.numel(), int((cpu != want).sum()), int((card != want).sum()),
          int((card != cpu).sum())), flush=True)
u = torch.rand(1 << 24, generator=torch.Generator().manual_seed(1))
print("sqrt of U[0, 1), 2^24 values: the CPU differs from correctly rounded "
      "in %d, the card in %d" % (
          int((torch.sqrt(u) != torch.sqrt(u.double()).float()).sum()),
          int((torch.sqrt(u.cuda()).cpu() != torch.sqrt(u.double()).float())
              .sum())), flush=True)
grad = (rs.standard_normal(cs.FC6) * 1e-3).astype(np.float32)
w0 = (rs.standard_normal(cs.FC6) * 0.01).astype(np.float32)
res = {}
for ctx in (mx.cpu(), mx.gpu(0)):
    o = mx.optimizer.create("adagrad", learning_rate=0.01,
                            multi_precision=True)
    upd = mx.optimizer.get_updater(o)
    w = mx.nd.array(w0, ctx=ctx).astype("bfloat16")
    gg = mx.nd.array(grad, ctx=ctx).astype("bfloat16")
    for _ in range(2):
        upd(0, gg, w)
    res[ctx.device_type] = w._data
d = (res["gpu"].float().cpu() - res["cpu"].float()).abs()
i = int(d.argmax())
print("adagrad lr 0.01 mp: card vs CPU %.4g bf16 ulp element by element, "
      "%.4g at the largest weight; worst element %d: CPU %r, card %r, "
      "w0 %r" % (cs._ulp_err(res["gpu"], res["cpu"], "elem"),
                 cs._ulp_err(res["gpu"], res["cpu"], "max"), i,
                 float(res["cpu"].flatten()[i]),
                 float(res["gpu"].flatten()[i]),
                 float(torch.tensor(w0).flatten()[i])), flush=True)
