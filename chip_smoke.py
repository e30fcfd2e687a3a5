#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card: serve the decoder-transformer LM,
train it at full width through DataParallelTrainer, train its vocabulary
head through runtime-compiled user kernels, serve and train ResNet-50 v1 at
bench.py's shape, then sweep the array surface and train, checkpoint,
resume and serve ResNet-50 v1 from its file, then hold the rest of the
model zoo and of the op library against the CPU, serve AlexNet, VGG-16 and
Inception-v3 and train AlexNet.

Run from the root of a checkout, with one CUDA card and the CUDA toolkit:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:

1. device  — the card's name and power limit (nvidia-smi), or exit non-zero
             when torch sees no CUDA device;
2. build   — every hand-written kernel of the port, from ``csrc/`` with nvcc
             (one per source, all at once), and the launcher of runtime
             kernels (``csrc/rtc_launch.c``, a CPython extension, with the
             host C compiler), with ptxas's report (registers,
             shared memory, spills) and the count of HGMMA (wgmma)
             instructions in the SASS of the bf16, f16 and f32 forward
             kernels, of the wide kernels (route A in bf16 and f16, route B)
             and of the bf16 and f16 backward kernels (dQ, dK/dV), none of
             which may be 0: every route runs on the tensor cores;
3. kernel  — each kernel against its plain PyTorch version on the card, at
             the shapes of its tests and of the serving path and at head dims
             160, 192 and 256, and 320 and 512 (the wide routes: A in bf16
             and f16, B in f32), in f32, bf16 and f16; bf16 and f16 also
             element by element (2^-8·|ref| + 5e-5, 2^-11·|ref| + 5e-5);
             the f32 route's split pass bit for bit; mixes of dtypes (the
             f32 route, and route B above D = 256, q's dtype out); flash
             attention's backward against torch autograd through the plain
             version in f32, TF32 off: the backward kernel
             in bf16 and f16 at the training shape and at Sq < Sk, Sq > Sk,
             Sk = 65, D = 20 and 64 (each through the kernel: its launch
             count moved, the torch ops' did not), the torch ops at small
             f32 shapes and D = 320;
4. serve   — small LMs on the card against the same weights on the CPU, with
             the same greedy tokens: f32 at D = 16 (the f32 route), f16 at
             D = 128 (the f16 route), bf16 and f32 at D = 256 (two output
             slices a block on the 16-bit and the f32 route), f32 and bf16
             at D = 320 (routes B and A), each route's launch count zeroed
             just before and read just after, none 0, and the wide count
             equal to the layers at D = 320 and 0 below; then
             the LM of bench_transformer.py at its full width (vocab 16384,
             d_model 4096, 32 heads, d_ffn 16384, 4 layers, seq 1024; random
             weights from a seed) answering 4 requests of 8 prompts x 1024
             tokens with each prompt's greedy next token; the kernels' launch
             counts are zeroed just before and read just after; then one more
             request under torch.profiler for its device time by kernel;
4f. serve  — the serving runtime on the same net: ``mx.serving.Server``
             (max_batch 8, max_wait 5 ms) loads LastToken(LM) (the last
             position's bf16 logits and their argmax), captures one CUDA
             graph per bucket 1, 2, 4, 8 (capture seconds, pool bytes),
             answers 32 requests of 1024 tokens from 4 closed-loop client
             threads (each row bit-equal to the bucket-1 program, the SLO
             components summing exactly to each request's wall; batch
             sizes, p50/p99, tokens/s, component means), swaps to a second
             version (HostXavier(SEED + 1), bf16) mid-traffic (every
             response entirely one version's, monotonic per client),
             evicts and reloads (bit-equal, same version), serves one
             fused pass (the probe's verdict; no delivered row differs
             from the bucket-1 program), traces one exact bucket-8 replay
             (32 flash_fwd_sm90_kernel launches; busy and idle share) and
             runs ``python -m incubator_mxnet_tpu_torch.serving --selftest``;
4e. serve  — the same LM with BENCH_HEADS=8 (D = 512, the same parameter
             shapes) in bf16 answering 2 requests of 8 x 1024 tokens, every
             attention through route A (4 launches a request, counted with
             the counters zeroed just before and read just after), each
             request's ms beside the D = 128 model's;
4d. train — the small f32 LM trained 3 steps through DataParallelTrainer on
             the card against the same 3 steps on the CPU (weights within
             1e-4, losses within 1e-5 relative); then the same LM at full
             width, uncut, trained as bench_transformer.py:147-170 trains it:
             DataParallelTrainer, SoftmaxCrossEntropyLoss, SGD with momentum
             0.9 at lr 0.05, bf16 compute with f32 master weights, batch 8 x
             1024 tokens from np.random.RandomState(0); 3 warm-up steps,
             then TRAIN_STEPS timed steps with the kernels' counts zeroed
             just before and read just after: each step's ms and loss,
             tokens/s, MFU (bench_transformer.py's model_flops_per_step over
             989 TFLOP/s), peak memory; it fails unless every loss is finite
             and the last below the first, and unless every flash backward
             of the timed steps went through the backward kernel (4 a step,
             none through the torch ops); then one step under
             torch.profiler, by group (GEMMs, flash forward, flash backward,
             optimizer update, the rest) with the idle share;
4c. rtc   — the user kernels of RTC_SOURCE compiled by the port's NVRTC
             binding (mx.rtc.CudaModule, sm_90a); axpy against 2x + y
             (exact); 3 SGD steps of the LM's vocabulary head at full width
             (8192 tokens x 4096 -> 16384, f32) through FullyConnected, the
             custom op rtc_softmax (softmax_fwd, softmax_bwd) and
             sgd_update, held step by step against the same steps with the
             plain versions, launch counts zeroed just before and read just
             after; each kernel's time, bound, plain and library times at
             the head shape; the host cost of one CudaKernel.launch (noop,
             no arguments; axpy, 4) in rounds, in turns with one torch.neg,
             the same launches written plainly over ctypes and the floor
             (cuLaunchKernel of noop in a loop from C), and the parts of
             axpy's launch, each alone;
5. timing  — the flash kernel at the serving shape: its time, its bound, the
             plain version's time and one PyTorch library call's time, in
             bf16 (the serving path), f16, and on the f32 route (with the
             split pass and the attention kernel also timed alone); at
             (8, 16, 1024, 256) causal on the bf16 and f32 routes; the wide
             routes at (8, 8, 1024, 512) causal (the serving shape's work at
             D = 512) in bf16, f16 (route A) and f32 (route B, with its split
             pass and attention kernel also alone), each beside SDPA, with
             the design's floor (the tensor work its walk issues at 989
             TFLOP/s); the backward kernel at the training
             shape beside the torch ops it replaced, the plain version and
             SDPA's backward, with the card's bound and the design's floor;
6. resnet  — ResNet-50 v1 of the model zoo, whose path reaches no hand
             kernel (convolutions on cuDNN, TF32 off in f32; Pooling and
             BatchNorm in torch ops):
             6a: resnet50_v1(thumbnail=True, classes=10), batch 4 of 32x32,
             the same seeded weights on the card and on the CPU: the
             inference forward, the training-mode forward and loss in f32
             with torch's TF32 default on (within 1e-4; the same forward
             with TF32 convolutions must break that bound, and both errors
             are printed), then 3 DataParallelTrainer steps in f32 and in
             bf16 compute, each taken on the card from the CPU's state
             before it (loss, running statistics, every update and
             momentum);
             6b: resnet50_v1(classes=1000) in bf16, inference mode, batch 32
             of 3x224x224 (BASELINE.md:17), one warm-up and 4 timed
             batches: ms a batch, img/s, peak memory, the bf16 logits
             against the f32 net's, and one batch under torch.profiler by
             group (cuDNN convolutions, layout transposes, BatchNorm,
             relu/add, pooling, other) with the idle share;
             6c: bench.py's training run (:199-211): resnet50_v1(classes=
             1000), Xavier, DataParallelTrainer with SoftmaxCrossEntropyLoss,
             SGD momentum 0.9 at lr 0.1, bf16 compute over f32 master
             weights, batch 256 of 3x224x224 from np.random.RandomState(0);
             3 warm-up and 5 timed steps on the same batch: step ms (mean,
             spread), img/s, MFU (the convolutions' and the dense layer's
             flop counted from the net's own shapes, x3, over 989 TFLOP/s),
             peak memory; it fails unless every loss is finite, the last
             below the first, and the running statistics moved and stayed
             finite; then one step under torch.profiler by group (adding
             cuDNN dgrad/wgrad and the optimizer update);
7. arrays  — the array surface and checkpoints, which launch no hand
             kernel:
             7a: every op of ops/math.py, ops/tensor.py and ops/init_ops.py
             that this slice ports, on CUDA tensors against the port's CPU
             result for the same seeded numpy inputs, forward and backward,
             in f32, bf16 and int32 (elementwise, broadcast and reduction
             ops at (1024, 4096), dot at (1024, 4096)·(4096, 4096),
             batch_dot at (32, 1024, 128)·(32, 128, 1024)), each at its
             bound in ulps (SWEEP_ULP; data movement, indexing, ordering and
             integer results bit-equal), each call and backward under torch's
             sync-debug mode "error"; every alias resolving to its op; int32
             mod and power at their edge values; the creation ops; one line
             per family;
             7b: resnet50_v1(classes=1000) in f32 trained through the plain
             Gluon loop (record, SoftmaxCrossEntropyLoss, backward,
             gluon.Trainer.step(64): sgd lr 0.1, momentum 0.9, wd 1e-4,
             MultiFactorScheduler(step=[2, 4], factor=0.1)) on a batch of
             64 x 3x224x224 from np.random.RandomState(0): run A takes 3
             steps, save_params and save_states, then steps 4-6; run B, a
             net of another seed and a fresh Trainer, load_params and
             load_states, then steps 4-6: the state after loading and the
             step-4 loss bit-equal to A's, the learning rates and
             num_update equal, steps 5-6 within CKPT_LOSS_REL and
             CKPT_WEIGHT_REL, and each tensor whose RMS is at least
             CKPT_LIVE_RMS of the net's within CKPT_TENSOR_REL; a third net loads A's file from its bytes
             (nd.load_buffer, serving's load_params_bytes) and its logits on
             a batch of 32 are bit-equal to A's; file sizes, save and load
             seconds and A's step ms;
8. zoo     — the rest of the vision zoo and of the op library, which
             launch no hand kernel:
             8a: alexnet, vgg11, vgg11_bn, squeezenet1_0/1_1, densenet121,
             mobilenet0_25 (224x224) and inception_v3 (299x299), classes
             10, on the card against the CPU from the same seeded f32
             weights, batch 2, inference mode, TF32 off (ZOO_REL); alexnet's
             training-mode forward bit-equal after the same mx.random.seed
             and different under another;
             8b: alexnet, vgg16 and inception_v3 (classes=1000) in bf16,
             batch 32 (BASELINE.md:13-16): ms a batch, img/s, peak memory,
             the bf16 logits against the f32 net's (ZOO_BF16_REL), one batch
             profiled by group; alexnet behind mx.serving.Server(max_batch
             8): 16 one-image requests from 2 client threads, every row
             bit-equal to the bucket-1 program;
             8c: alexnet(classes=1000) in f32 trained by the plain Gluon
             loop at batch 256 (BASELINE.md:27), Trainer 'nag' (lr 0.01,
             momentum 0.9, wd 1e-4), dropout live: step ms, img/s, MFU,
             peak memory, the loss finite and falling, one step profiled by
             group; every other optimizer of the slice 2 steps from one
             saved state, finite losses, every tensor moved;
             8d: the nn ops at AlexNet's and Inception's activation shapes
             (7a's harness, f32 and bf16), bilinear UpSampling, the update
             ops at fc6's shape and the optimizers on bf16 weights through
             multi_precision, the losses at (256, 1000), the linalg ops on
             64 stacked 256x256 matrices and fft/ifft at (256, 4096), the
             deterministic initializers: CUDA against CPU, forward and
             backward, under sync-debug mode "error" (syevd, which waits
             for the card, outside it);
             8e: 2^24 draws of each sampler on the card: moments, KS
             against scipy's CDF, multinomial chi-square, shuffle, dropout's
             keep share, values and gradient, rrelu's slopes, every draw
             bit-equal after the same seed with torch's default generators
             reseeded;
9. one JSON ``kernels`` line (the hand kernels of phases 2-5; phases 6-8
   launch none), then the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package.
"""
import contextlib
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time

H100_BF16_FLOPS = 989e12     # dense tensor-core peak (NVIDIA data sheet)
H100_F32_CUDA_CORE_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12
SEED = 0

# (shape (B, H, Sq, Sk, D), causal): the kernel's test shapes and the
# serving shape, which is last
ATTENTION_CASES = [
    ((2, 4, 256, 256, 64), False),
    ((2, 4, 256, 256, 64), True),
    ((1, 2, 128, 256, 64), True),    # Sq < Sk: the causal diagonal moves right
    ((1, 2, 256, 128, 64), True),    # Sq > Sk: 128 rows see no key at all
    ((1, 3, 40, 40, 24), False),     # ragged: no dimension a multiple of 64
    ((1, 3, 40, 40, 24), True),
    ((2, 4, 32, 32, 16), True),      # the small LM of phase 4a
    ((8, 32, 1024, 1024, 128), True),
]
# head dims past 128: two output slices a block column on every route
WIDE_CASES = [
    ((1, 2, 200, 200, 160), True),
    ((2, 2, 130, 130, 192), False),
    ((2, 4, 512, 512, 256), True),
]
# head dims above 256: the wide routes (csrc/flash_attention_wide_sm90.cu),
# route A in bf16 and f16, route B in f32, with the main path's shape (phase
# 4e and WIDER_TIMING: 16 key tiles, 16 row blocks) last; one mix of its own
# (route B), q's dtype out
WIDER_CASES = [
    ((1, 2, 200, 200, 320), True),
    ((2, 2, 130, 150, 512), True),   # Sq < Sk, ragged tiles, four slices
    ((1, 2, 150, 100, 320), True),   # Sq > Sk: 50 rows see no key
    ((8, 8, 1024, 1024, 512), True),
]
WIDE_MIXED = (("float16", "bfloat16", "float32"), (1, 2, 96, 160, 320))
# mixes of dtypes (q, k, v): the f32 route, q's dtype out
MIXED_CASES = [(("bfloat16", "float32", "float16"), (2, 3, 256, 320, 96)),
               (("float32", "bfloat16", "bfloat16"), (1, 2, 200, 200, 256))]
# kernel vs plain, max abs error. f32: both sum the same products in f32 in
# other orders (|o| <= ~4, D <= 256, Sk <= 1024), a few ulp of 4, far below
# 1e-4. bf16 (f16): the plain result is computed in f32 from the same
# 16-bit inputs, and the kernel rounds its f32 result once: half an ulp at
# |o| < 4 is 7.8e-3 (9.8e-4), within 2e-2 (2e-3).
TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-3}
# bf16, element by element against the f32 plain result: one bf16 rounding
# (2^-9 relative) and as much again for the f32 arithmetic (f16: 2^-11). P
# rounded to the type once before P·V breaks it at many elements (the
# negative controls of tests/test_torch_attention.py); the kernel's split
# P_hi + P_lo must break it nowhere.
BF16_REL, BF16_ABS = 2.0 ** -8, 5e-5
HALF_REL = {"bfloat16": BF16_REL, "float16": 2.0 ** -11}
# small LMs on the card against the CPU (phase 4a): (name, dtype, widths,
# the launch counter of their route, max abs error bound as ulps of the
# dtype at max |CPU logits| (f32: absolute))
SMALL_LMS = [
    ("f32_d16", "float32", dict(vocab=97, d_model=64, n_heads=4, d_ffn=256,
                                n_layers=2, seq_len=32), "f32_launches", None),
    ("f16_d128", "float16", dict(vocab=97, d_model=256, n_heads=2, d_ffn=512,
                                 n_layers=2, seq_len=32), "f16_launches", 16),
    ("bf16_d256", "bfloat16", dict(vocab=97, d_model=512, n_heads=2,
                                   d_ffn=1024, n_layers=2, seq_len=32),
     "launches", 8),
    ("f32_d256", "float32", dict(vocab=97, d_model=512, n_heads=2, d_ffn=1024,
                                 n_layers=2, seq_len=32), "f32_launches",
     None),
    ("f32_d320", "float32", dict(vocab=97, d_model=640, n_heads=2, d_ffn=1280,
                                 n_layers=2, seq_len=32), "wide_f32_launches",
     None),
    ("bf16_d320", "bfloat16", dict(vocab=97, d_model=640, n_heads=2,
                                   d_ffn=1280, n_layers=2, seq_len=32),
     "wide16_launches", 8),
]
# flash attention's backward on the card against torch autograd through the
# plain version in f32 with TF32 off: (shape (B, H, Sq, Sk, D), causal,
# dtype).  f32 (the torch ops): the same products in other orders, within
# 1e-4.  bf16 and f16 (the backward kernel; the training shape first): both
# compute in f32, but the kernel starts from the 16-bit output (delta =
# sum(g·out)), carries P and dS as two halves of the type and rounds each
# gradient once, so the bound is 2^-7 of the largest |gradient|
BACKWARD_CASES = [
    ((8, 32, 1024, 1024, 128), True, "bfloat16"),
    ((8, 32, 1024, 1024, 128), True, "float16"),
    ((1, 2, 128, 256, 64), True, "bfloat16"),    # Sq < Sk
    ((1, 2, 128, 256, 64), True, "float16"),
    ((1, 2, 256, 128, 64), True, "bfloat16"),    # Sq > Sk: rows see no key
    ((1, 2, 256, 128, 64), True, "float16"),
    ((2, 2, 65, 65, 64), True, "bfloat16"),      # Sk = 65: a ragged tile
    ((2, 2, 65, 65, 64), True, "float16"),
    ((1, 2, 77, 77, 20), True, "bfloat16"),      # D = 20, padded to 24
    ((1, 2, 77, 77, 20), True, "float16"),
    ((1, 2, 128, 256, 64), True, "float32"),     # the torch ops from here
    ((1, 2, 256, 128, 64), True, "float32"),
    ((2, 2, 65, 65, 32), True, "float32"),       # Sk = 65: one ragged chunk
    ((1, 2, 200, 200, 320), True, "float32"),    # D = 320, the wide forward
]
BACKWARD_F32_TOL = 1e-4
BACKWARD_BF16_REL = 2.0 ** -7
# the full-width training run: bench_transformer.py's LM and step (:147-170)
LM_CONFIG = dict(vocab=16384, d_model=4096, n_heads=32, d_ffn=16384,
                 n_layers=4, seq_len=1024)
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS = 8, 3, 5
TRAIN_OPT = {"learning_rate": 0.05, "momentum": 0.9}
SMALL_TRAIN_STEPS = 3
# card vs CPU, the small f32 LM's 3 training steps: the same f32 operations
# (TF32 off) in other orders, a few f32 ulps a step
SMALL_TRAIN_W_TOL, SMALL_TRAIN_LOSS_RTOL = 1e-4, 1e-5
MANTISSA = {"bfloat16": 7, "float16": 10}
FLASH_DESIGN = ("bf16: wgmma m64n64k16 for S = Q·Kᵀ (shared-memory operands) "
                "and for O += P_hi·V + P_lo·V (P from registers, V "
                "transposed), S of tile t issued with P·V of tile t-1, TMA "
                "3-stage K/V ring with mbarriers, 1 producer warp + 2 "
                "consumer warpgroups, 128 query rows x 64 keys a tile")
F32_DESIGN = ("f32: a split pass writes three bf16 planes (h, m, l) of "
              "q·scale, k and v from their strides; then wgmma m64n64k16, six "
              "products (lh, hl, mm, mh, hm, hh) for S = Q·Kᵀ and six for "
              "O += P·V with P split into three bf16 pieces in registers; Q's "
              "planes resident, K and V through an 8-slot TMA ring of "
              "(tile, plane) slots on mbarriers, 1 producer warp + 2 consumer "
              "warpgroups, 128 query rows x 64 keys a tile, S, softmax and "
              "P·V in turn in each warpgroup")
F16_DESIGN = ("f16: the bf16 kernel's template instantiated for __half: "
              "wgmma m64n64k16 .f16, TMA maps of FLOAT16, P split into two "
              "f16 halves (f16 x f16 products exact in f32)")
WIDE_DESIGN = ("bf16 at head dims 129-256: Q and K in four 64-column panels "
               "(three up to 192), one block per 128 output columns (grid "
               "z): S over the full D, O over the block's slice, 64 f32 "
               "registers of O a thread as at D = 128; 208 KB of shared "
               "memory at D = 256")
F32_WIDE_DESIGN = ("f32 at head dims 129-256: 64 query rows and one consumer "
                   "warpgroup a block (Q's three planes 96 KB at D = 256), "
                   "one block per 128 output columns, a four-slot ring of "
                   "32 KB (K plane) slots, 224 KB of shared memory")
BWD_DESIGN = ("bf16 and f16 backward over the row stats (m, 1/l) the "
              "forward kernel keeps when training; two kernels without "
              "atomics: dQ with queries outer (delta = sum(g·out) first, "
              "then S = Q·Kᵀ, dP = g·Vᵀ, dQ += dS_hi·K + dS_lo·K, K and V "
              "through a 3-stage TMA ring); "
              "dK and dV with keys outer, one 64-column output slice a block "
              "(Sᵀ = K·Qᵀ, dPᵀ = V·gᵀ, dV += Pᵀ_hi·g + Pᵀ_lo·g, dK += "
              "dSᵀ_hi·Q + dSᵀ_lo·Q, Q, g and their row stats through the "
              "ring); P and dS only in registers, 1 producer warp + 2 "
              "consumer warpgroups, 128 rows x 64 a tile")
BF16_SOURCE = "incubator_mxnet_tpu_torch/csrc/flash_attention_sm90.cu"
F32_SOURCE = "incubator_mxnet_tpu_torch/csrc/flash_attention_f32_sm90.cu"
BWD_SOURCE = "incubator_mxnet_tpu_torch/csrc/flash_attention_bwd_sm90.cu"
# the (mangled) kernel names cuobjdump lists, by route
HGMMA_FUNCTIONS = {"bf16": "flash_fwd_sm90_kernelI13__nv_bfloat16",
                   "f16": "flash_fwd_sm90_kernelI6__half",
                   "f32": "flash_fwd_f32_sm90_kernel",
                   "wide16_bf16": "flash_fwd_wide16_kernelI13__nv_bfloat16",
                   "wide16_f16": "flash_fwd_wide16_kernelI6__half",
                   "wide_f32": "flash_fwd_wide_f32_kernel",
                   "bwd_dq_bf16": "flash_bwd_dq_kernelI13__nv_bfloat16",
                   "bwd_dkdv_bf16": "flash_bwd_dkdv_kernelI13__nv_bfloat16",
                   "bwd_dq_f16": "flash_bwd_dq_kernelI6__half",
                   "bwd_dkdv_f16": "flash_bwd_dkdv_kernelI6__half"}
# the head dim 256 timing shape (B, H, Sq, Sk, D), causal
WIDE_TIMING = ((8, 16, 1024, 1024, 256), True)
# the wide routes' timing shape: the serving shape's work at D = 512
WIDER_TIMING = ((8, 8, 1024, 1024, 512), True)
WIDER_SOURCE = "incubator_mxnet_tpu_torch/csrc/flash_attention_wide_sm90.cu"
WIDE16_DESIGN = ("route A, bf16 and f16 at head dims above 256: 64 query rows "
                 "and 256 output columns (3 or 4 panels) a block, one "
                 "consumer warpgroup (255-register cap) + 1 producer warp; "
                 "wgmma m64n64k16 for S over 64-column panels of K streamed "
                 "through a ring of 8 KB slots (Q resident up to D = 768, "
                 "streamed beside K above; 16 slots, 27 when streamed), a "
                 "commit group a panel with up to 5 (kLag) in flight; O += "
                 "P_hi·V + P_lo·V from registers, the softmax of tile t "
                 "beside P·V of tile t-1")
WIDE_F32_DESIGN = ("route B, f32 and mixes at head dims above 256: the split "
                   "pass's three bf16 planes, 64 query rows and 256 output "
                   "columns a block, one consumer warpgroup; S in two walks "
                   "over the head-dim panels (the five small products, then "
                   "hh), Q's plane h resident up to D = 768 beside a 16-slot "
                   "ring of 8 KB panels (27 slots when it streams), planes m "
                   "and l streamed; O += P·V with six products, P in three "
                   "pieces in registers")
# the LM served at head dim 512 (phase 4e): bench_transformer.py's widths
# with BENCH_HEADS=8, the same parameter shapes; route A, 4 launches a request
WIDE_LM_HEADS, WIDE_LM_REQUESTS = 8, 2
# phase 4f: the serving runtime's requests (1024 tokens each), closed-loop
# client threads and batch buckets
SERVE_REQUESTS, SERVE_CLIENTS, SERVE_BUCKETS = 32, 4, (1, 2, 4, 8)
# flash_attention's launch counters: all routes, then those of head dims
# above 256
WIDE_COUNTERS = ("launches", "wide_launches", "wide16_launches",
                 "wide_f32_launches")
RTC_DESIGNS = {
    "softmax_fwd": ("one block per row; where c % 4 == 0 and the row fits, "
                    "the row read once as float4 into registers (SOFTMAX_VEC "
                    "a thread), block max, expf in registers, block sum, "
                    "float4 stores of e / s; else a three-pass loop in the "
                    "same kernel"),
    "softmax_bwd": ("a wide row a block of up to 1024 threads, narrow rows "
                    "several (softmax_bwd_geometry), copied as float4 with "
                    "BWD_VEC loads a thread in flight, then one fix-up a row "
                    "by the thread that stored column label: p - 1.0; a "
                    "scalar loop where c % 4 != 0 or a base is unaligned"),
    "axpy": ("float4 loads and stores, AXPY_VEC float4 of x and y a thread "
             "in flight, grid-stride; a scalar tail for n % 4 and for "
             "unaligned bases"),
}


# The rtc phase's user kernels: CUDA C that the port compiles at run time
# with NVRTC for sm_90a (mx.rtc.CudaModule), the counterpart of the JAX
# build's runtime Pallas kernels (incubator_mxnet_tpu/rtc.py:86), whose one
# user kernel is the axpy of tests/test_rtc_resume.py.  softmax_fwd and
# softmax_bwd are the forward and backward of the custom op "rtc_softmax",
# a softmax output with the gradient p - onehot(label) (upstream MXNet's
# example/numpy-ops/custom_softmax_rtc.py).  Each is bound by memory bytes
# on this card: one pass of reads and writes at 3.35 TB/s, the head's 1.07
# GB far past the 50 MB L2, so all three stream.  axpy reads x and y and
# writes o as float4, AXPY_VEC float4 of each input in flight a thread
# before its stores; n % 4 elements, and every element when a base is not
# 16-byte aligned, take a scalar loop; axpy_geometry(n) picks its grid.
# softmax_bwd copies p into dz the same way, a wide row by a block of up to
# 1024 threads with BWD_VEC float4 each in flight (narrow rows several to
# a block; softmax_bwd_geometry(c)), and applies the one-hot as one fix-up
# a row: the thread that stored column label[row] stores p - 1.0 there
# after its own float4 store, so no element is compared; rows with
# c % 4 != 0 or unaligned bases take a scalar loop in the same kernel.
# Plain loads and stores: streaming cache hints (__ldcs, __stcs) and
# blocks of 256 threads over several wide rows were slower on the card.  softmax_fwd takes
# one block per row and reads the row from memory once: where c % 4 ==
# 0, the bases are 16-byte aligned and the row fits the block's registers
# (SOFTMAX_VEC float4 a thread), each thread loads its slice as float4 into
# registers, and the block reduces the max (warp shuffles, then one value per
# warp in shared memory), turns its registers into expf(z - m), reduces the
# sum and stores e / s as float4.  Every other row width takes the three-pass
# loop of the same kernel (max, sum, write, each reading the row again from
# L2).  softmax_geometry(c) picks the block for both.  noop measures the
# host cost of one launch.
RTC_SOURCE = r"""
#define SOFTMAX_VEC 8
#define AXPY_VEC 4
#define BWD_VEC 2

// o = 2x + y over n elements as float4, AXPY_VEC float4 of x and of y a
// thread in flight before its stores, over a grid-stride loop; the last
// n % 4 elements (all n when a base is unaligned) by a scalar loop
extern "C" __global__ void axpy(const float *x, const float *y, float *o,
                                int n) {
    const bool vec = (((size_t)x | (size_t)y | (size_t)o) & 15) == 0;
    const long long n4 = vec ? n / 4 : 0;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long j0 = (long long)blockIdx.x * blockDim.x * AXPY_VEC +
                        threadIdx.x; j0 < n4; j0 += stride * AXPY_VEC) {
        float4 a[AXPY_VEC], b[AXPY_VEC];
#pragma unroll
        for (int u = 0; u < AXPY_VEC; ++u) {
            const long long j = j0 + (long long)u * blockDim.x;
            if (j < n4) {
                a[u] = ((const float4 *)x)[j];
                b[u] = ((const float4 *)y)[j];
            }
        }
#pragma unroll
        for (int u = 0; u < AXPY_VEC; ++u) {
            const long long j = j0 + (long long)u * blockDim.x;
            if (j < n4)
                ((float4 *)o)[j] = make_float4(
                    2.0f * a[u].x + b[u].x, 2.0f * a[u].y + b[u].y,
                    2.0f * a[u].z + b[u].z, 2.0f * a[u].w + b[u].w);
        }
    }
    for (long long i = 4 * n4 + (long long)blockIdx.x * blockDim.x +
                       threadIdx.x; i < n; i += stride)
        o[i] = 2.0f * x[i] + y[i];
}

__device__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// the max (is_max) or the sum of v over the block, returned to every thread
__device__ float block_reduce(float v, bool is_max, float *scratch) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const float neutral = is_max ? -3.402823466e38f : 0.0f;
    v = is_max ? warp_max(v) : warp_sum(v);
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = lane < (int)(blockDim.x >> 5) ? scratch[lane] : neutral;
        v = is_max ? warp_max(v) : warp_sum(v);
        if (lane == 0) scratch[32] = v;
    }
    __syncthreads();
    v = scratch[32];
    __syncthreads();
    return v;
}

__device__ float max4(float4 v) {
    return fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
}

// p = softmax(z) over each row of c columns; one block per row
extern "C" __global__ void softmax_fwd(const float *z, float *p, int c) {
    __shared__ float scratch[33];
    const float *row = z + (size_t)blockIdx.x * c;
    float *out = p + (size_t)blockIdx.x * c;
    if ((c & 3) == 0 && c <= 4 * SOFTMAX_VEC * (int)blockDim.x &&
            (((size_t)z | (size_t)p) & 15) == 0) {
        // the row in registers: float4 j of the row is x[i] of thread
        // j % blockDim.x, i = j / blockDim.x
        const float4 *row4 = (const float4 *)row;
        float4 *out4 = (float4 *)out;
        const int n4 = c >> 2;
        float4 x[SOFTMAX_VEC];
        float m = -3.402823466e38f;
#pragma unroll
        for (int i = 0; i < SOFTMAX_VEC; ++i) {
            const int j = threadIdx.x + i * blockDim.x;
            if (j < n4) {
                x[i] = __ldg(row4 + j);
                m = fmaxf(m, max4(x[i]));
            }
        }
        m = block_reduce(m, true, scratch);
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < SOFTMAX_VEC; ++i) {
            if (threadIdx.x + i * blockDim.x < n4) {
                x[i] = make_float4(expf(x[i].x - m), expf(x[i].y - m),
                                   expf(x[i].z - m), expf(x[i].w - m));
                s += (x[i].x + x[i].y) + (x[i].z + x[i].w);
            }
        }
        s = block_reduce(s, false, scratch);
#pragma unroll
        for (int i = 0; i < SOFTMAX_VEC; ++i) {
            const int j = threadIdx.x + i * blockDim.x;
            if (j < n4)
                out4[j] = make_float4(x[i].x / s, x[i].y / s, x[i].z / s,
                                      x[i].w / s);
        }
        return;
    }
    float m = -3.402823466e38f;
    for (int j = threadIdx.x; j < c; j += blockDim.x) m = fmaxf(m, row[j]);
    m = block_reduce(m, true, scratch);
    float s = 0.0f;
    for (int j = threadIdx.x; j < c; j += blockDim.x) s += expf(row[j] - m);
    s = block_reduce(s, false, scratch);
    for (int j = threadIdx.x; j < c; j += blockDim.x)
        out[j] = expf(row[j] - m) / s;
}

// dz = p - onehot(label) over rows of c columns, ceil(rows / gridDim.x)
// rows a block: each row copied as float4, BWD_VEC float4 a thread in
// flight before its stores (a scalar loop where c % 4 != 0 or a base is
// unaligned); then the thread that stored column label[row] stores
// p - 1.0f there, after its own store of that element
extern "C" __global__ void softmax_bwd(const float *p, const float *label,
                                       float *dz, int rows, int c) {
    const bool vec = (c & 3) == 0 && (((size_t)p | (size_t)dz) & 15) == 0;
    const int per = (rows + gridDim.x - 1) / gridDim.x;
    const int r_end = min(rows, (int)(blockIdx.x + 1) * per);
    for (int r = blockIdx.x * per; r < r_end; ++r) {
        const size_t base = (size_t)r * c;
        if (vec) {
            const float4 *src = (const float4 *)(p + base);
            float4 *dst = (float4 *)(dz + base);
            const int n4 = c >> 2;
            for (int j0 = threadIdx.x; j0 < n4; j0 += BWD_VEC * blockDim.x) {
                float4 v[BWD_VEC];
#pragma unroll
                for (int u = 0; u < BWD_VEC; ++u)
                    if (j0 + u * (int)blockDim.x < n4)
                        v[u] = src[j0 + u * blockDim.x];
#pragma unroll
                for (int u = 0; u < BWD_VEC; ++u)
                    if (j0 + u * (int)blockDim.x < n4)
                        dst[j0 + u * blockDim.x] = v[u];
            }
        } else {
            for (int j = threadIdx.x; j < c; j += blockDim.x)
                dz[base + j] = p[base + j];
        }
        // the owner of column l: float4 l / 4 (element l) went to thread
        // (l / 4) % blockDim.x (l % blockDim.x) of the loops above
        const int l = (int)label[r];
        if (l >= 0 && l < c &&
                threadIdx.x == (vec ? (l >> 2) : l) % blockDim.x)
            dz[base + l] = p[base + l] - 1.0f;
    }
}

extern "C" __global__ void noop() {}
"""
RTC_SIGNATURES = {
    "axpy": "const float *x, const float *y, float *o, int n",
    "softmax_fwd": "const float *z, float *p, int c",
    "softmax_bwd": ("const float *p, const float *label, float *dz, "
                    "int rows, int c"),
    "noop": "",
}
RTC_KERNELS = ("axpy", "softmax_fwd", "softmax_bwd")
SOFTMAX_THREADS = 512


def _define(name):
    return int(re.search(r"#define %s (\d+)" % name, RTC_SOURCE).group(1))


# float4 a thread holds on softmax_fwd's one-read path, and keeps in flight
# in axpy and softmax_bwd (RTC_SOURCE's own)
SOFTMAX_VEC, AXPY_VEC, BWD_VEC = (_define(n) for n in
                                  ("SOFTMAX_VEC", "AXPY_VEC", "BWD_VEC"))
SOFTMAX_MAX_THREADS = 1024
AXPY_THREADS = 256
BWD_THREADS = 1024
# about this many elements of p a softmax_bwd block copies (rows x c)
BWD_BLOCK_ELEMENTS = 1 << 14
AXPY_N = 2 ** 26
# the LM's vocabulary head at full width: 8 x 1024 tokens of d_model 4096
# into vocab 16384 (bench_transformer.py's LM), f32
HEAD = dict(tokens=8192, d_model=4096, vocab=16384)
HEAD_STEPS = 3
HEAD_LR = 1e-4
# rtc vs plain, max abs error.  softmax_fwd: expf and the two reductions run
# in other orders than torch.softmax; p <= 1 and both are within a few ulp
# of the exact value, so a few ulp of 1 (1.2e-7 each) stays under 1e-6.
# softmax_bwd and axpy: the same single IEEE operations as the plain
# version (2x is exact, so a fused multiply-add equals a multiply and an
# add): exact.  Head weights: the GEMMs are the same calls on the same
# inputs, and p differs at the ulp level, which moves dW by at most
# 8192·|Δp|·max|h| and W by lr times that, far below 1e-6.
RTC_TOLERANCE = {"softmax_fwd": 1e-6, "softmax_bwd": 0.0, "axpy": 0.0,
                 "head_p": 1e-6, "head_w": 1e-6}


def softmax_geometry(c):
    """softmax_fwd's launch for rows of ``c`` columns: ``(block threads,
    dynamic shared bytes, whether the row is read once)``.  The one-read path
    needs c % 4 == 0 (16-byte aligned rows) and c <= 4 * SOFTMAX_VEC * block;
    its block is the least multiple of 32 threads that holds the row.  Every
    other width runs the three-pass loop on SOFTMAX_THREADS threads."""
    if c % 4 == 0 and c <= 4 * SOFTMAX_VEC * SOFTMAX_MAX_THREADS:
        per_warp = 4 * SOFTMAX_VEC * 32
        return 32 * -(-c // per_warp), 0, True
    return SOFTMAX_THREADS, 0, False


def softmax_bwd_geometry(c):
    """softmax_bwd's launch for rows of ``c`` columns: ``(block threads, rows
    a block, whether rows are copied as float4)``; the grid is
    ceil(rows / rows a block).  A block has the least multiple of 32 threads
    that gives each thread at most BWD_VEC float4 (or elements) of a row,
    at most BWD_THREADS, and as many rows as make about BWD_BLOCK_ELEMENTS
    elements.  The float4 path needs c % 4 == 0 (and 16-byte aligned bases,
    which the kernel checks)."""
    vec = c % 4 == 0
    units = c // 4 if vec else c
    block = min(BWD_THREADS, 32 * -(-units // (32 * BWD_VEC)))
    return max(block, 32), max(1, BWD_BLOCK_ELEMENTS // c), vec


def axpy_geometry(n):
    """axpy's launch for ``n`` elements: ``(grid blocks, block threads)``,
    one block per AXPY_THREADS x AXPY_VEC float4 (its loop strides over the
    grid, so any grid is right)."""
    return max(1, -(-n // (4 * AXPY_VEC * AXPY_THREADS))), AXPY_THREADS


def rtc_module(mx):
    """Compile RTC_SOURCE once (NVRTC, sm_90a); returns the module and its
    kernels by name."""
    mod = mx.rtc.CudaModule(RTC_SOURCE, exports=list(RTC_SIGNATURES))
    return mod, {n: mod.get_kernel(n, s) for n, s in RTC_SIGNATURES.items()}


def softmax_plain(z):
    """Plain version of softmax_fwd."""
    import torch
    return torch.softmax(z, dim=-1)


def softmax_bwd_plain(p, label):
    """Plain version of softmax_bwd: p - onehot(label), label held as f32."""
    import torch
    return p - torch.nn.functional.one_hot(label.long(),
                                           p.shape[-1]).to(p.dtype)


def register_rtc_softmax(mx, kernels=None):
    """Register the custom op ``rtc_softmax``: ``nd.Custom(z, label,
    op_type="rtc_softmax")`` is softmax(z) over the last axis, and its
    backward, which ignores the head gradient (``need_top_grad=False``), is
    p - onehot(label) into z; the label gets no gradient.

    On a CUDA NDArray it launches the rtc kernels, ``kernels`` from
    :func:`rtc_module` (without them a CUDA call raises); on a CPU NDArray
    it runs the plain versions.  Which one runs follows from the device
    alone."""

    def launch_into(name, req, dst, args, rows, c):
        """Launch ``name`` writing its (rows, c) result into ``dst``; the
        port asks a custom op only for ``write`` or ``null``."""
        if req == "null":
            return
        if req != "write":
            raise mx.MXNetError("rtc_softmax writes its result, got req %r"
                                % req)
        if kernels is None:
            raise mx.MXNetError("rtc_softmax on %s needs the rtc kernels: "
                                "register_rtc_softmax(mx, rtc_module(mx)[1])"
                                % dst.context)
        if name == "softmax_fwd":
            block, shared, _ = softmax_geometry(c)
            kernels[name].launch(args + [dst, c], dst.context, (rows,),
                                 (block,), shared)
        else:
            block, per, _ = softmax_bwd_geometry(c)
            kernels[name].launch(args + [dst, rows, c], dst.context,
                                 (-(-rows // per),), (block,))

    class RtcSoftmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            z = in_data[0]
            if z.context.device_type == "gpu":
                rows, c = z.shape
                launch_into("softmax_fwd", req[0], out_data[0], [z], rows, c)
            else:
                self.assign(out_data[0], req[0],
                            mx.nd.NDArray(softmax_plain(z._data)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            p, label = out_data[0], in_data[1]
            if p.context.device_type == "gpu":
                rows, c = p.shape
                launch_into("softmax_bwd", req[0], in_grad[0], [p, label],
                            rows, c)
            else:
                self.assign(in_grad[0], req[0], mx.nd.NDArray(
                    softmax_bwd_plain(p._data, label._data)))

    class RtcSoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return RtcSoftmax()

    mx.operator.register("rtc_softmax")(RtcSoftmaxProp)
    return RtcSoftmaxProp


def case_key(shape, causal, dtype_name):
    return "x".join(map(str, shape)) + ("_causal" if causal else "") + \
        "_" + dtype_name


def fail(msg):
    print("chip_smoke: FAILED: " + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, "nvidia-smi failed: " + out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, torch):
    """Mean ms of ``fn()`` over ``reps`` back-to-back calls, by CUDA events,
    after two warm-up calls."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attention_work(b, h, sq, sk, d, causal, itemsize):
    """(flops, bytes) the attention on these inputs needs: each input read
    once, the output written once, and 4·D flops per (query, key) pair the
    mask lets through (a row that sees no key averages all of them)."""
    if causal:
        pairs = 0
        for i in range(sq):
            seen = min(max(i + sk - sq + 1, 0), sk)
            pairs += seen if seen else sk
    else:
        pairs = sq * sk
    flops = 4.0 * b * h * d * pairs
    nbytes = itemsize * b * h * d * (2 * sq + 2 * sk)
    return flops, nbytes


def f32_tensor_work(b, h, sq, sk, d, causal):
    """The tensor work (flop) flash_fwd_f32_sm90_kernel does: its walk over
    128-row query blocks and 64-key tiles (whole tiles across the causal
    diagonal), six products in each of S and P·V over the head-dim bucket."""
    bucket = 64 if d <= 64 else 128
    tiles = 0
    for q0 in range(0, sq, 128):
        n_end = sk
        if causal and q0 + sk - sq >= 0:
            n_end = min(sk, q0 + min(128, sq - q0) + sk - sq)
        tiles += -(-n_end // 64)
    return b * h * tiles * 2 * 6 * 2.0 * 128 * 64 * bucket


def wide_tensor_work(b, h, sq, sk, d, causal, products):
    """The tensor work (flop) the wide kernels issue: their walk over 64-row
    query blocks and 64-key tiles (whole tiles across the diagonal), for
    each of the ceil(panels / slice) output slices of 3 or 4 panels, S over
    the padded head dim and P·V over the slice, ``products`` wgmma products
    for each f32 product (route A: 1 for S and the two halves of P for P·V,
    so 1 and 2; route B: 6 and 6)."""
    panels = -(-(-(-d // 8) * 8) // 64)
    slices = -(-panels // 4)
    width = 3 if -(-panels // slices) <= 3 else 4
    slices = -(-panels // width)
    tiles = 0
    for q0 in range(0, sq, 64):
        n_end = sk
        if causal and q0 + sk - sq >= 0:
            n_end = min(sk, q0 + min(64, sq - q0) + sk - sq)
        tiles += -(-n_end // 64)
    s_prod, pv_prod = products
    per_tile = 2.0 * 64 * 64 * 64 * (s_prod * panels + pv_prod * width)
    return b * h * slices * tiles * per_tile


def ptxas_resources(log, function):
    """ptxas's report for each instance of the kernels whose (mangled) name
    contains ``function``: {instance: (registers, spill stores, spill loads
    in bytes)}."""
    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1) if function in m.group(1) else None
            if name is not None:   # the kernel's name and template arguments
                name = name[name.find("flash_fwd"):].split("EEEv")[0]
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            found[name] = (0, int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            spills = found.get(name, (0, 0, 0))
            found[name] = (int(m.group(1)), spills[1], spills[2])
    return found


def time_flash(q, k, v, causal, card, torch):
    """flash_attention on q, k, v (one dtype) by CUDA events, beside its
    plain version and scaled_dot_product_attention with the bottom-right
    bool mask (the yardstick; the port never calls it), and its bound: the
    larger of the bytes at 3.35 TB/s and the operations, f32 on the CUDA
    cores or the split's six bf16 products on the tensor cores, whichever is
    less, for f32; 16-bit on the tensor cores otherwise."""
    from incubator_mxnet_tpu_torch.ops.attention import (
        flash_attention, _attention_reference)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    scale = 1.0 / math.sqrt(d)
    t = {"ms": cuda_ms(lambda: flash_attention(q, k, v, causal), 20, torch),
         "plain_ms": cuda_ms(lambda: _attention_reference(q, k, v, causal), 5,
                             torch),
         "library_ms": cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask,
                                            scale=scale), 10, torch)}
    flops, nbytes = attention_work(b, h, sq, sk, d, causal, q.element_size())
    terms = {"bytes": nbytes / H100_BYTES_PER_S * 1e3}
    if q.dtype == torch.float32:
        terms["cuda_core"] = flops / H100_F32_CUDA_CORE_FLOPS * 1e3
        terms["split_tensor"] = 6 * flops / H100_BF16_FLOPS * 1e3
        ops_ms = min(terms["cuda_core"], terms["split_tensor"])
    else:
        terms["tensor"] = flops / H100_BF16_FLOPS * 1e3
        ops_ms = terms["tensor"]
    t["bound_ms"] = max(terms["bytes"], ops_ms)
    t["bound_by"] = "bytes" if terms["bytes"] >= ops_ms else "operations"
    t["bound_terms_ms"] = terms
    t["tflops"] = flops / t["ms"] / 1e9
    t["shape"] = "(%d,%d,%d,%d,%d)%s %s" % (
        b, h, sq, sk, d, " causal" if causal else "",
        str(q.dtype).replace("torch.", ""))
    print("timing: flash_attention_fwd at %s: kernel_ms %.4f, bound_ms %.4f "
          "(%s; terms ms %s; %.3e flop, %.3e bytes), plain_ms %.4f, "
          "library_ms %.4f (scaled_dot_product_attention with a bottom-right "
          "bool mask%s); kernel at %.1f TFLOP/s of the needed work | %s"
          % (t["shape"], t["ms"], t["bound_ms"], t["bound_by"],
             json.dumps({k_: round(v_, 4) for k_, v_ in terms.items()}),
             flops, nbytes, t["plain_ms"], t["library_ms"],
             ", TF32 off" if q.dtype == torch.float32 else "", t["tflops"],
             card), flush=True)
    return t


GEMM_NAMES = ("gemm", "xmma", "cutlass", "nvjet")


DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# the record_function span around the timed call of ``profiled``
PROFILED_SPAN = "chip_smoke.profiled"


def timed_device_work(prof, spans=()):
    """The device activities (kernels, copies, fills) of a :func:`profiled`
    session that its timed call launched: those whose launching runtime or
    driver call (by correlation id) lies inside the span PROFILED_SPAN,
    whichever thread made it; CUDA graph replays' kernels included.
    Returns ([(name, us, launch ts)], [(start, end, name)] of the
    record_function spans named in ``spans``), from the exported trace."""
    from incubator_mxnet_tpu_torch import cuda_build
    path = cuda_build.BUILD_DIR.parent / ("trace-%d.json" % os.getpid())
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        path.unlink()
    launch_ts, timed, named, device = {}, [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args") or {}
        interval = (e["ts"], e["ts"] + e.get("dur", 0), e.get("name"))
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launch_ts[args["correlation"]] = e["ts"]
        elif cat == "user_annotation" and e.get("name") == PROFILED_SPAN:
            timed.append(interval)
        elif cat == "user_annotation" and e.get("name") in spans:
            named.append(interval)
        elif cat in DEVICE_CATEGORIES:
            device.append((e.get("name", ""), float(e.get("dur", 0)),
                           args.get("correlation")))
    work = []
    for name, us, corr in device:
        ts = launch_ts.get(corr)
        if ts is not None and any(a <= ts <= b for a, b, _ in timed):
            work.append((name, us, ts))
    return work, named


def trace_kernels(prof):
    """{name: [device us, count]} of :func:`timed_device_work`."""
    kernels = {}
    for name, us, _ts in timed_device_work(prof)[0]:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += us
        k[1] += 1
    return kernels


def profiled(run):
    """One call of ``run`` under torch.profiler, after one untimed call in
    the same window: (the profile, the timed call's wall us by the host
    clock, device synchronized at both ends).  The timed call runs inside
    the record_function span PROFILED_SPAN, by which :func:`trace_kernels`
    keeps its device work.  Late in this script the profiler dropped the
    first kernels a window saw (the head step's forward GEMM and
    softmax_fwd, launched from the main thread before its backward, whose
    kernels it kept); the untimed call takes that loss."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
        with record_function(PROFILED_SPAN):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    return prof, wall_us


def profile_device(run, what, kernel_groups, gemm_flops, card):
    """Where one call of ``run`` spends its time: device time by kernel
    (torch.profiler, CUPTI; :func:`profiled`, :func:`trace_kernels`),
    grouped by ``kernel_groups`` ({group: kernel name substring}), GEMMs and
    the rest, against the call's wall time; the remainder is the device's
    idle share.  ``gemm_flops`` is the call's matrix-product work, for the
    GEMMs' achieved rate."""
    prof, wall_us = profiled(run)
    kernels = trace_kernels(prof)
    if not kernels:
        print("profile: torch.profiler recorded no device time: not measured")
        return None
    groups = dict.fromkeys(list(kernel_groups) + ["gemm", "other"], 0.0)
    for name, (us, _) in kernels.items():
        low = name.lower()
        group = next((g for g, key in kernel_groups.items() if key in low),
                     None)
        if group is None:
            group = "gemm" if any(t in low for t in GEMM_NAMES) else "other"
        groups[group] += us
    busy = sum(groups.values())
    print("profile: %s under torch.profiler: wall %.1f us, device busy %.1f "
          "us (%d device activities), idle share %.4f | %s"
          % (what, wall_us, busy, sum(n for _, n in kernels.values()),
             max(0.0, 1 - busy / wall_us), card))
    print("profile: device us by group %s; GEMMs %.4e flop at %.1f TFLOP/s"
          % (json.dumps({k: round(v, 1) for k, v in groups.items()}),
             gemm_flops, gemm_flops / groups["gemm"] / 1e6 if groups["gemm"]
             else 0.0))
    for name, (us, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
        print("profile:   %10.1f us  %3d x  %s" % (us, n, name[:110]))


def sass_count(lib, opcode, function=""):
    """How many SASS instructions of ``opcode`` the library's device code
    holds (cuobjdump -sass), in the functions whose (mangled) name contains
    ``function``."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120)
    check(out.returncode == 0, "cuobjdump failed: " + out.stderr.strip())
    count, inside = 0, not function
    for line in out.stdout.splitlines():
        if line.strip().startswith("Function :"):
            inside = function in line
        elif inside and re.search(r"\b%s\b" % opcode, line):
            count += 1
    return count


def host_rounds(fns, rounds, reps):
    """Host µs of one call of each of ``fns`` (name -> fn) in each of
    ``rounds`` rounds of ``reps`` calls: name -> the rounds' means.  The fns
    take turns, in order on even rounds and reversed on odd ones (a, b, b,
    a), and the device is synchronized after every ``reps`` calls (outside
    the clock), so its queue never holds more than ``reps`` launches and a
    full queue never blocks the host.  10 warm-up calls of each first."""
    import torch
    names = list(fns)
    for name in names:
        for _ in range(10):
            fns[name]()
    torch.cuda.synchronize()
    out = {name: [] for name in names}
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            fn = fns[name]
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            out[name].append((time.perf_counter() - t0) / reps * 1e6)
            torch.cuda.synchronize()
    return out


def plain_softmax_output(torch):
    """The rtc_softmax op in plain PyTorch, as one torch.autograd.Function:
    the oracle of the head-training run."""

    class PlainSoftmaxOutput(torch.autograd.Function):
        @staticmethod
        def forward(ctx, z, label):
            p = softmax_plain(z)
            ctx.save_for_backward(p, label)
            return p

        @staticmethod
        def backward(ctx, grad_p):
            p, label = ctx.saved_tensors
            return softmax_bwd_plain(p, label), None

    return PlainSoftmaxOutput


def train_head(mx, kernels, dev, card):
    """The head-training path: HEAD_STEPS SGD steps of the LM's vocabulary
    head through FullyConnected, the rtc_softmax custom op (rtc kernels) and
    sgd_update, held step by step against the same steps with the plain
    versions.  Returns the kernels' launches on the path."""
    import torch
    n, d, v = HEAD["tokens"], HEAD["d_model"], HEAD["vocab"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    h = torch.randn(n, d, generator=gen, device=dev)
    w0 = torch.randn(v, d, generator=gen, device=dev) * 0.02
    bias = torch.randn(v, generator=gen, device=dev) * 0.01
    label = torch.randint(0, v, (n,), generator=gen, device=dev).to(
        torch.float32)

    # the plain run first: its p and W after each step are the oracle
    plain = plain_softmax_output(torch)
    w = w0.clone().requires_grad_()
    want_p, want_w = [], []
    for _ in range(HEAD_STEPS):
        p = plain.apply(torch.matmul(h, w.t()) + bias, label)
        (g,) = torch.autograd.grad(p, [w], torch.ones_like(p))
        with torch.no_grad():
            w.copy_(w - HEAD_LR * (g * 1.0 + 0.0 * w))
        want_p.append(p.detach())
        want_w.append(w.detach().clone())
    del w, p, g

    H, B, L = (mx.nd.NDArray(t) for t in (h, bias, label))
    W = mx.nd.NDArray(w0.clone())
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    softmax = ("softmax_fwd", "softmax_bwd")
    for name in softmax:
        kernels[name].launches = 0

    def train_step():
        W.attach_grad()
        with mx.autograd.record():
            z = mx.nd.FullyConnected(H, W, B, num_hidden=v)
            p = mx.nd.Custom(z, L, op_type="rtc_softmax")
        p.backward()
        mx.nd.sgd_update(W, W.grad, lr=HEAD_LR, out=W)
        return p

    step_ms, ce, p_err, w_err = [], [], [], []
    for step_i in range(HEAD_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = train_step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        pt = p._data.detach()
        check(pt.shape == (n, v) and bool(torch.isfinite(pt).all()),
              "head step %d: p %s not finite" % (step_i, tuple(pt.shape)))
        ce.append(-torch.log(pt.gather(1, label.long()[:, None])).mean()
                  .item())
        p_err.append((pt - want_p[step_i]).abs().max().item())
        w_err.append((W._data.detach() - want_w[step_i]).abs().max().item())
        del p, pt
    launches = {name: kernels[name].launches for name in softmax}
    peak = torch.cuda.max_memory_allocated() - held
    with torch.no_grad():
        logits = torch.matmul(h, W._data.t()) + bias
        ce.append(-torch.log(softmax_plain(logits).gather(
            1, label.long()[:, None])).mean().item())
        del logits
    for step in range(HEAD_STEPS):
        print("rtc: head step %d: %.3f ms, cross-entropy %.6f -> %.6f, p vs "
              "plain max_abs_err %.3e (bound %.0e), W vs plain %.3e (bound "
              "%.0e) | %s" % (step, step_ms[step], ce[step], ce[step + 1],
                              p_err[step], RTC_TOLERANCE["head_p"],
                              w_err[step], RTC_TOLERANCE["head_w"], card))
    print("rtc: head training %s, %d steps, lr %g, f32: launches %s, peak "
          "memory allocated by the steps %d bytes (beyond %d held) | %s"
          % (HEAD, HEAD_STEPS, HEAD_LR, launches, peak, held, card),
          flush=True)
    check(max(p_err) <= RTC_TOLERANCE["head_p"], "head p disagrees with plain")
    check(max(w_err) <= RTC_TOLERANCE["head_w"], "head W disagrees with plain")
    check(all(a > b for a, b in zip(ce, ce[1:])),
          "cross-entropy did not fall at every step: %s" % ce)
    for name in softmax:
        check(launches[name] == HEAD_STEPS, "%s launched %d times in %d head "
              "steps" % (name, launches[name], HEAD_STEPS))
    # one more step, after the checks and the counts, for its device time
    profile_device(train_step, "one head step", {k: k for k in softmax},
                   4.0 * n * d * v, card)
    return launches


def rtc_phase(mx, dev, card):
    """Phase rtc: compile the user kernels with the port's NVRTC binding,
    check axpy, train the vocabulary head through them, time each kernel and
    the host cost of a launch.  Returns the kernels' JSON entries."""
    import numpy as np
    import torch
    ctx = mx.gpu(0)
    t0 = time.perf_counter()
    mod, kernels = rtc_module(mx)
    print("rtc: NVRTC compiled %s for %s in %.3f s (%d-byte CUBIN) | %s" % (
        sorted(RTC_SIGNATURES), mod.options[0], time.perf_counter() - t0,
        len(mod._cubin), card), flush=True)
    register_rtc_softmax(mx, kernels)
    axpy = kernels["axpy"]

    def run_axpy(x, y):
        o = mx.nd.empty(x.shape, ctx=ctx)
        grid, block = axpy_geometry(x.size)
        axpy.launch([x, y, o, x.size], ctx, (grid,), (block,))
        return o

    axpy.launches = 0
    x8 = mx.nd.array(np.arange(8, dtype=np.float32), ctx=ctx)
    got = run_axpy(x8, mx.nd.ones(8, ctx=ctx)).asnumpy()
    check(np.array_equal(got, np.arange(8, dtype=np.float32) * 2 + 1),
          "axpy (8,) != 2x + 1: %s" % got)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    n = AXPY_N
    x, y = (mx.nd.NDArray(torch.randn(n, generator=gen, device=dev))
            for _ in range(2))
    o = run_axpy(x, y)
    axpy_err = (o._data - (2 * x._data + y._data)).abs().max().item()
    print("rtc: axpy (8,) == 2x + 1 exactly; axpy (%d,) vs 2 * x + y "
          "max_abs_err %.3e (bound 0)" % (n, axpy_err), flush=True)
    check(axpy_err == RTC_TOLERANCE["axpy"], "axpy is not exact")
    launches = {"axpy": axpy.launches}
    launches.update(train_head(mx, kernels, dev, card))

    # timing at the head shape (these launches are not counted above)
    rows, c = HEAD["tokens"], HEAD["vocab"]
    Z = mx.nd.NDArray(torch.randn(rows, c, generator=gen, device=dev))
    P, DZ = mx.nd.empty((rows, c), ctx=ctx), mx.nd.empty((rows, c), ctx=ctx)
    lab = mx.nd.NDArray(torch.randint(0, c, (rows,), generator=gen,
                                      device=dev).to(torch.float32))
    idx = lab._data.long()[:, None]
    fwd, bwd = kernels["softmax_fwd"], kernels["softmax_bwd"]
    grid = (rows,)
    fwd_block, fwd_shared, one_read = softmax_geometry(c)
    check(one_read, "softmax_fwd at c = %d does not take its one-read path"
          % c)
    bwd_block, bwd_rows, bwd_vec = softmax_bwd_geometry(c)
    check(bwd_vec, "softmax_bwd at c = %d does not take its float4 path" % c)
    bwd_grid = (-(-rows // bwd_rows),)
    axpy_grid, axpy_block = axpy_geometry(n)
    fwd.launch([Z, P, c], ctx, grid, (fwd_block,), fwd_shared)
    bwd.launch([P, lab, DZ, rows, c], ctx, bwd_grid, (bwd_block,))
    errs = {"axpy": axpy_err,
            "softmax_fwd": (P._data - softmax_plain(Z._data)).abs().max()
            .item(),
            "softmax_bwd": (DZ._data - softmax_bwd_plain(P._data, lab._data))
            .abs().max().item()}
    for name in ("softmax_fwd", "softmax_bwd"):
        check(errs[name] <= RTC_TOLERANCE[name], "%s: max_abs_err %.3e > %.0e"
              % (name, errs[name], RTC_TOLERANCE[name]))
    check(torch.equal(torch.scatter(P._data, 1, idx, -1.0, reduce="add"),
                      softmax_bwd_plain(P._data, lab._data)),
          "softmax_bwd's library yardstick computes another function")
    xs, ys = x._data, y._data
    elems = rows * c
    work = {   # (flops, bytes): each input read once, each output written once
        "softmax_fwd": (7.0 * elems, 4.0 * 2 * elems),
        "softmax_bwd": (1.0 * elems, 4.0 * (2 * elems + rows)),
        "axpy": (2.0 * n, 4.0 * 3 * n),
    }
    timed = {
        "softmax_fwd": (lambda: fwd.launch([Z, P, c], ctx, grid,
                                           (fwd_block,), fwd_shared),
                        lambda: softmax_plain(Z._data),
                        lambda: torch.softmax(Z._data, dim=-1),
                        "torch.softmax"),
        "softmax_bwd": (lambda: bwd.launch([P, lab, DZ, rows, c], ctx,
                                           bwd_grid, (bwd_block,)),
                        lambda: softmax_bwd_plain(P._data, lab._data),
                        lambda: torch.scatter(P._data, 1, idx, -1.0,
                                              reduce="add"),
                        "torch.scatter(p, 1, label, -1.0, reduce='add')"),
        "axpy": (lambda: axpy.launch([x, y, o, n], ctx, (axpy_grid,),
                                     (axpy_block,)),
                 lambda: 2 * xs + ys,
                 lambda: torch.add(ys, xs, alpha=2),
                 "torch.add(y, x, alpha=2)"),
    }
    geometry = {"softmax_fwd": {"grid": rows, "block": fwd_block},
                "softmax_bwd": {"grid": bwd_grid[0], "block": bwd_block,
                                "rows_a_block": bwd_rows},
                "axpy": {"grid": axpy_grid, "block": axpy_block}}
    entries = []
    for name in RTC_KERNELS:
        kern, plain, library, library_name = timed[name]
        # the kernel and its library call in turns (kernel, library,
        # library, kernel), each the mean of its two turns
        turns = [cuda_ms(f, 50, torch) for f in (kern, library, library,
                                                  kern)]
        kernel_ms, library_ms = (turns[0] + turns[3]) / 2, \
            (turns[1] + turns[2]) / 2
        plain_ms = cuda_ms(plain, 20, torch)
        flops, nbytes = work[name]
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_F32_CUDA_CORE_FLOPS * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        shape = "(%d,)" % n if name == "axpy" else "(%d, %d)" % (rows, c)
        print("timing: rtc %s at %s f32: kernel_ms %.4f, bound_ms %.4f (%s: "
              "%.3e bytes at 3.35 TB/s, %.3e flop at 67 TFLOP/s f32), plain_ms "
              "%.4f, library_ms %s; %.1f GB/s; turns kernel, library, "
              "library, kernel %s | %s" % (
                  name, shape, kernel_ms, bound_ms, bound_by, nbytes, flops,
                  plain_ms, "%.4f (%s)" % (library_ms, library_name),
                  nbytes / kernel_ms / 1e6,
                  " ".join("%.4f" % t for t in turns), card), flush=True)
        entries.append({
            "name": name, "route": "cuda", "compiler": "nvrtc",
            "source": "chip_smoke.py",
            "replaces": "incubator_mxnet_tpu/rtc.py:86",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms})
        entries[-1]["design"] = RTC_DESIGNS[name]
        entries[-1]["geometry"] = geometry[name]
        check(launches[name] > 0, "%s was not launched on its path" % name)

    entries.append(launch_cost(mx, kernels, dev, card, launches))
    return entries


# the launch-cost timing: rounds x calls a round (far below the device's
# launch queue, synchronized between rounds)
LAUNCH_ROUNDS, LAUNCH_REPS = 20, 200


def spread(xs):
    return {"mean": sum(xs) / len(xs), "min": min(xs), "max": max(xs)}


def plain_launch(mx, kernel, args, grid, block):
    """One launch of ``kernel`` written plainly, the driver reached through
    ctypes as the port's first launch path reached it: a ctypes holder per
    argument, the primary context made current, torch's Stream object,
    cuLaunchKernel through its ctypes binding.  None of the launch's
    checks: the yardstick of the compiled launcher."""
    import ctypes
    import torch
    from incubator_mxnet_tpu_torch import _cuda_driver as cu
    from incubator_mxnet_tpu_torch import rtc
    holders = [ctypes.c_uint64(a._data.data_ptr()) if p.is_pointer
               else rtc._TYPES[p.ctype][1](a)
               for p, a in zip(kernel.params, args)]
    params = (ctypes.c_void_p * max(len(holders), 1))(
        *[ctypes.addressof(h) for h in holders])
    cu.use_primary_context(0)
    cu.check(cu.driver().cuLaunchKernel(
        kernel._sites[0].func, grid, 1, 1, block, 1, 1, 0,
        torch.cuda.current_stream(torch.device("cuda", 0)).cuda_stream,
        params, None), "cuLaunchKernel(%s)" % kernel.name)


def launch_cost(mx, kernels, dev, card, path_launches):
    """The host cost of one CudaKernel.launch: noop (no arguments) and axpy
    (4 arguments, n = 8, one block), beside one torch.neg on a 1-element
    tensor, the same launches written plainly over ctypes, and the floor
    (one cuLaunchKernel of noop issued from C, no Python in the loop),
    timed in turns; then the parts of axpy's launch, each alone, as the
    launch runs them.  ``path_launches`` are the user kernels' launches on
    the main path, all through this launch path.  Returns the rtc_launch
    entry."""
    import torch
    from incubator_mxnet_tpu_torch import _cuda_driver as cu
    from incubator_mxnet_tpu_torch import rtc
    ctx = mx.gpu(0)
    noop, axpy = kernels["noop"], kernels["axpy"]
    n = 8
    x = mx.nd.array(list(range(n)), ctx=ctx)
    y, o = mx.nd.ones(n, ctx=ctx), mx.nd.zeros(n, ctx=ctx)
    grid, block = axpy_geometry(n)
    args = [x, y, o, n]
    small = torch.zeros(1, device=dev)
    totals = host_rounds({
        "noop": lambda: noop.launch([], ctx, (1,), (1,)),
        "torch_neg": lambda: torch.neg(small),
        "axpy_4_args": lambda: axpy.launch(args, ctx, (grid,), (block,)),
        "plain_noop": lambda: plain_launch(mx, noop, [], 1, 1),
        "plain_axpy_4_args": lambda: plain_launch(mx, axpy, args, grid,
                                                  block),
    }, LAUNCH_ROUNDS, LAUNCH_REPS)
    o_err = (o._data - (2 * x._data + y._data)).abs().max().item()
    check(o_err == 0.0, "axpy through the timed launches != 2x + y")
    site = noop._sites[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    floor = []
    for _ in range(LAUNCH_ROUNDS):
        floor.append(cu.launch_floor_ns(site.func, site.ctx, LAUNCH_REPS,
                                        stream) / 1e3)
        torch.cuda.synchronize()

    # the parts of axpy's launch, each alone, as CudaKernel.launch runs them
    asite = axpy._sites[0]
    holders, _, params = axpy._buffer()
    device = axpy._devices[0]
    grid_t, block_t = (grid,), (block,)

    def checks_and_dims():
        c = ctx if ctx.__class__ is rtc.Context else rtc.Context(ctx)
        if c.device_type != "gpu" or len(args) != len(axpy._packers):
            raise AssertionError
        rtc._dims(grid_t, "grid_dims")
        b = rtc._dims(block_t, "block_dims")
        if b[0] * b[1] * b[2] > 1024 or axpy._devices.get(0) is None:
            raise AssertionError

    def arguments():
        for (pack, _), arg, holder in zip(axpy._packers, args, holders):
            pack(arg, holder, device)

    def bumps():
        for i in axpy._mutable:
            rtc._increment_version(args[i]._data)

    xt = x._data

    def getters():
        # what a pointer argument's check asks of its tensor
        return (xt.dtype, xt.get_device(), xt.is_contiguous(), xt.data_ptr())

    parts = {k: spread(v)["mean"] for k, v in host_rounds({
        "checks_and_dims": checks_and_dims,
        "arguments": arguments,
        "of_which_tensor_getters_one_pointer": getters,
        "stream": lambda: asite.stream(0),
        "launcher": lambda: asite.launch(asite.table, asite.func, asite.ctx,
                                         grid, 1, 1, block, 1, 1, 0, stream,
                                         params),
        "version_bumps": bumps,
    }, LAUNCH_ROUNDS, LAUNCH_REPS).items()}
    t = {k: spread(v) for k, v in totals.items()}
    f = spread(floor)
    for name, label in (
            ("noop", "CudaKernel.launch of noop (no arguments)"),
            ("axpy_4_args", "CudaKernel.launch of axpy (4 arguments, n = 8)"),
            ("torch_neg", "torch.neg on a 1-element tensor"),
            ("plain_noop", "noop launched plainly over ctypes"),
            ("plain_axpy_4_args", "axpy launched plainly over ctypes")):
        print("rtc: launch host cost, %s: %.3f us (mean of %d rounds of %d "
              "calls; rounds %.3f-%.3f) | %s" % (
                  label, t[name]["mean"], LAUNCH_ROUNDS, LAUNCH_REPS,
                  t[name]["min"], t[name]["max"], card), flush=True)
    print("rtc: launch floor, one cuLaunchKernel of noop issued from C: "
          "%.3f us (rounds %.3f-%.3f) | %s" % (f["mean"], f["min"], f["max"],
                                                card), flush=True)
    print("rtc: launch parts of axpy (us, each alone): %s; sum %.3f of the "
          "launch's %.3f | %s" % (
              ", ".join("%s %.3f" % kv for kv in parts.items()),
              sum(v for k, v in parts.items() if not k.startswith("of_")),
              t["axpy_4_args"]["mean"], card), flush=True)
    return {"name": "rtc_launch", "route": "cuda", "compiler": "cc",
            "source": "incubator_mxnet_tpu_torch/rtc.py, "
                      "incubator_mxnet_tpu_torch/csrc/rtc_launch.c",
            "replaces": "incubator_mxnet_tpu/rtc.py:86",
            "launches": sum(path_launches.values()), "max_abs_err": o_err,
            "ms": t["noop"]["mean"] / 1e3,
            "plain_ms": t["plain_noop"]["mean"] / 1e3,
            "bound_ms": f["mean"] / 1e3, "bound_by": "operations",
            "library_ms": t["torch_neg"]["mean"] / 1e3,
            "host_us": t["noop"]["mean"],
            "host_us_4_args": t["axpy_4_args"]["mean"],
            "bound_us": f["mean"], "library_us": t["torch_neg"]["mean"],
            "plain_us": t["plain_noop"]["mean"],
            "plain_us_4_args": t["plain_axpy_4_args"]["mean"],
            "parts_us": parts,
            "rounds_us": {k: [v["min"], v["max"]] for k, v in t.items()},
            "bound_rounds_us": [f["min"], f["max"]]}


def model_flops_per_step(n_params, tokens, seq_len, d_model, n_layers=1):
    """Model FLOPs of one training step (forward and backward) as
    bench_transformer.py:46-51 counts them: 6·N·tokens over the N
    non-embedding parameters, plus the causal attention term."""
    dense = 6.0 * n_params * tokens
    attn = 6.0 * seq_len * tokens * d_model * n_layers
    return dense + attn


def kernels_by_span(prof, spans):
    """Device time of the timed call of a :func:`profiled` session, by named
    span: a kernel belongs to the innermost span (a record_function of
    ``spans``) whose CPU interval holds the runtime call that launched it.
    Returns ({span: [us, GEMM us]}, [(kernel name, us) outside every
    span])."""
    work, intervals = timed_device_work(prof, spans)
    intervals.sort(key=lambda iv: iv[1] - iv[0])      # innermost first
    by_span = {name: [0.0, 0.0] for name in spans}
    outside = []
    for name, us, ts in work:
        span = next((n for a, b, n in intervals if a <= ts <= b), None)
        if span is None:
            outside.append((name, us))
            continue
        by_span[span][0] += us
        if any(t in name.lower() for t in GEMM_NAMES):
            by_span[span][1] += us
    return by_span, outside


def profile_training_step(run, gemm_flops, card):
    """One training step under torch.profiler, by group: cuBLAS GEMMs of the
    model, the flash forward kernel, the flash backward (the backward
    kernel and the copies its wrapper makes, the span
    flash_attention_backward), the optimizer update (the span
    DataParallelTrainer.update) and the rest, against the step's wall time;
    the remainder is the device's idle share."""
    spans = ("flash_attention_backward", "DataParallelTrainer.update")
    prof, wall_us = profiled(run)
    by_span, outside = kernels_by_span(prof, spans)
    if not outside and not any(v[0] for v in by_span.values()):
        print("profile: torch.profiler recorded no device time: not measured")
        return None
    groups = {"gemm": 0.0, "flash_attention_fwd": 0.0,
              "flash_attention_bwd": by_span[spans[0]][0],
              "optimizer_update": by_span[spans[1]][0], "other": 0.0}
    for name, us in outside:
        low = name.lower()
        if "flash_fwd" in low:
            groups["flash_attention_fwd"] += us
        elif any(t in low for t in GEMM_NAMES):
            groups["gemm"] += us
        else:
            groups["other"] += us
    busy = sum(groups.values())
    print("profile: one training step under torch.profiler: wall %.1f us, "
          "device busy %.1f us, idle share %.4f | %s"
          % (wall_us, busy, max(0.0, 1 - busy / wall_us), card))
    print("profile: device us by group %s (the flash backward's own GEMMs "
          "%.1f us of its %.1f); the model's GEMMs %.4e flop at %.1f "
          "TFLOP/s" % (json.dumps({k: round(v, 1) for k, v in groups.items()}),
                       by_span[spans[0]][1], by_span[spans[0]][0], gemm_flops,
                       gemm_flops / groups["gemm"] / 1e6 if groups["gemm"]
                       else 0.0), flush=True)
    top = {}
    for name, us in outside:
        top[name] = top.get(name, 0.0) + us
    for name, us in sorted(top.items(), key=lambda kv: -kv[1])[:6]:
        print("profile:   %10.1f us  %s" % (us, name[:110]))
    return dict(groups, wall_us=wall_us, busy_us=busy,
                idle_share=max(0.0, 1 - busy / wall_us))


def check_backward(gen, dev, card):
    """Flash attention's backward on the card against torch autograd through
    the plain version in f32, TF32 off, at BACKWARD_CASES: the 16-bit cases
    through the backward kernel, the f32 ones through the torch ops (each
    checked by the routes' counts).  Returns the max abs errors by case."""
    import torch
    from incubator_mxnet_tpu_torch.ops.attention import (
        flash_attention, _attention_reference)
    errs = {}
    for (b, h, sq, sk, d), causal, dname in BACKWARD_CASES:
        dtype = getattr(torch, dname)
        q, k, v = (torch.randn(b, h, s_, d, generator=gen, device=dev)
                   .to(dtype) for s_ in (sq, sk, sk))
        g = torch.randn(b, h, sq, d, generator=gen, device=dev).to(dtype)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = (flash_attention.backward_calls,
                  flash_attention.backward_kernel_launches,
                  flash_attention.backward_torch_calls)
        got = torch.autograd.grad(flash_attention(*leaves, causal), leaves, g)
        torch.cuda.synchronize()
        kernel = dtype != torch.float32
        check((flash_attention.backward_calls,
               flash_attention.backward_kernel_launches,
               flash_attention.backward_torch_calls) ==
              (before[0] + 1, before[1] + kernel, before[2] + (not kernel)),
              "the flash backward %s did not take its route (%s)"
              % (dname, "the kernel" if kernel else "the torch ops"))
        plain = [t.float().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(_attention_reference(*plain, causal),
                                   plain, g.float())
        key = case_key((b, h, sq, sk, d), causal, dname)
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            check(a.dtype == dtype and a.shape == w.shape and
                  bool(torch.isfinite(a).all()), "flash backward %s %s: %s "
                  "%s" % (key, name, a.dtype, tuple(a.shape)))
            err = (a.float() - w).abs().max().item()
            top = w.abs().max().item()
            bound = BACKWARD_F32_TOL if dtype == torch.float32 else \
                BACKWARD_BF16_REL * top
            errs["%s_%s" % (key, name)] = err
            ulps = "" if dtype == torch.float32 else \
                ", %.2f ulps of the type at max |grad|" % (err / 2.0 ** (
                    math.floor(math.log2(top)) - MANTISSA[dname]))
            print("kernel flash_attention_bwd %-36s %s max_abs_err %.3e "
                  "(bound %.3e%s; %s)" % (
                      key, name, err, bound, "" if dtype == torch.float32
                      else ": 2^-7 of max |grad| %.4f" % top, "the kernel"
                      if kernel else "the torch ops") + ulps, flush=True)
            check(err <= bound, "flash backward %s %s: max_abs_err %.3e > "
                  "%.3e" % (key, name, err, bound))
        del q, k, v, g, leaves, got, plain, want
    return errs


def bwd_tensor_work(b, h, sq, sk, d, causal):
    """The tensor work (flop) the backward kernel issues: the tile walks of
    its dQ and dK/dV kernels (csrc/flash_attention_bwd_sm90.cu), whole
    64 x 64 tiles across the diagonal over the head dim rounded up to 64
    (the row stats come from the forward, which computes them anyway)."""
    dp = -(-d // 64) * 64
    tile = 2.0 * 128 * 64        # one 128-row block by one 64-row tile
    offset, work = sk - sq, 0.0
    for q0 in range(0, sq, 128):
        rows = min(128, sq - q0)
        n_end = max(1, min(sk, q0 + rows + offset)) if causal else sk
        work += -(-n_end // 64) * tile * 4 * dp      # S, dP, dS_hi·K, dS_lo·K
    n_qt = -(-sq // 64)
    for n0 in range(0, sk, 128):
        t_lo = t_start = 0
        if causal:
            t_lo = min(n_qt, -(-(-offset) // 64)) if offset < 0 else 0
            first = n0 - offset - 63
            t_start = max(t_lo, -(-first // 64) if first > 0 else 0)
        walk = t_lo + n_qt - t_start
        # each 64-column slice: Sᵀ, dPᵀ over dp, and two halves of dV and dK
        work += walk * (dp // 64) * tile * (2 * dp + 4 * 64)
    return b * h * work


def time_backward(gen, dev, card):
    """The flash backward at the training shape (bf16): the backward kernel's
    time (autograd.grad with retain_graph, so the forward is not timed), the
    torch ops it replaced (_flash_backward called alone), the plain version
    (torch autograd through _attention_reference in f32) and SDPA's backward
    (the yardstick; the port never calls it).  Its bound is the card's: the
    bytes (q, k, v, out and g read once, dq, dk and dv written once) or the
    products with the 16-bit operands exact and P and dS carried to f32,
    16·D flop a visible (query, key) pair on the tensor cores (S and dP
    once, dV, dK and dQ as two products each), whichever is larger; the
    design's floor is the bf16 tensor work it issues (bwd_tensor_work).
    Also: each of its kernels' device time (torch.profiler), and in f16 on
    the same values the kernel's time, the plain version's (autograd through
    _attention_reference in f32 from the f16 values) and SDPA's backward in
    f16."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from incubator_mxnet_tpu_torch.ops.attention import (
        flash_attention, _attention_reference, _flash_backward)
    (b, h, sq, sk, d), causal, dname = BACKWARD_CASES[0]
    dtype = getattr(torch, dname)
    scale = 1.0 / math.sqrt(d)
    q, k, v = (torch.randn(b, h, s_, d, generator=gen, device=dev).to(dtype)
               for s_ in (sq, sk, sk))
    g = torch.randn(b, h, sq, d, generator=gen, device=dev).to(dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, causal)
    launches = flash_attention.backward_kernel_launches
    ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, g,
                                             retain_graph=True), 20, torch)
    check(flash_attention.backward_kernel_launches == launches + 22,
          "the timed backward did not run the kernel")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            torch.autograd.grad(out, leaves, g, retain_graph=True)
        torch.cuda.synchronize()
    kernel_us = {}
    for evt in prof.key_averages():
        for part in ("flash_bwd_dq", "flash_bwd_dkdv"):
            if part in evt.key:
                kernel_us[part] = kernel_us.get(part, 0.0) + (getattr(
                    evt, "self_device_time_total", 0) or 0) / 5
    half = [t.half().requires_grad_() for t in (q, k, v)]
    out16 = flash_attention(*half, causal)
    f16_ms = cuda_ms(lambda: torch.autograd.grad(out16, half, g.half(),
                                                 retain_graph=True), 20, torch)
    del out16, half
    o = out.detach()
    torch_ops_ms = cuda_ms(lambda: _flash_backward(q, k, v, o, g, causal,
                                                   scale), 5, torch)
    del out, o
    plain = [t.float().requires_grad_() for t in (q, k, v)]
    ref = _attention_reference(*plain, causal)
    plain_ms = cuda_ms(lambda: torch.autograd.grad(ref, plain, g.float(),
                                                   retain_graph=True),
                       5, torch)
    del ref, plain
    mask = torch.ones(sq, sk, dtype=torch.bool, device=dev).tril(sk - sq)
    lib = [t.clone().requires_grad_() for t in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(
        *lib, attn_mask=mask, scale=scale)
    library_ms = cuda_ms(lambda: torch.autograd.grad(out, lib, g,
                                                     retain_graph=True),
                         20, torch)
    del out, lib, leaves
    plain = [t.half().float().requires_grad_() for t in (q, k, v)]
    ref = _attention_reference(*plain, causal)
    f16_plain_ms = cuda_ms(lambda: torch.autograd.grad(
        ref, plain, g.half().float(), retain_graph=True), 5, torch)
    del ref, plain
    lib = [t.half().requires_grad_() for t in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(
        *lib, attn_mask=mask, scale=scale)
    f16_library_ms = cuda_ms(lambda: torch.autograd.grad(
        out, lib, g.half(), retain_graph=True), 20, torch)
    del out, lib
    fwd_flops, _ = attention_work(b, h, sq, sk, d, causal, 2)
    flops = 4 * fwd_flops              # 16·D a pair against the forward's 4·D
    issued = bwd_tensor_work(b, h, sq, sk, d, causal)
    nbytes = q.element_size() * b * h * d * (4 * sq + 4 * sk)
    terms = {"bytes": nbytes / H100_BYTES_PER_S * 1e3,
             "operations": flops / H100_BF16_FLOPS * 1e3,
             "design_floor": issued / H100_BF16_FLOPS * 1e3}
    t = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
         "torch_ops_ms": torch_ops_ms, "f16_ms": f16_ms,
         "f16_plain_ms": f16_plain_ms, "f16_library_ms": f16_library_ms,
         "kernel_us": kernel_us,
         "bound_ms": max(terms["bytes"], terms["operations"]),
         "bound_by": "bytes" if terms["bytes"] >= terms["operations"]
         else "operations", "bound_terms_ms": terms,
         "tflops": flops / ms / 1e9, "issued_tflops": issued / ms / 1e9,
         "shape": "(%d,%d,%d,%d,%d)%s %s" % (b, h, sq, sk, d,
                                             " causal" if causal else "",
                                             dname)}
    print("timing: flash_attention_bwd (the backward kernel) at %s: ms %.4f, "
          "bound_ms %.4f (%s; terms ms %s; %.3e flop needed, %.3e flop "
          "issued, %.3e bytes), torch_ops_ms %.4f (the torch ops it "
          "replaced, f32 products, TF32 off), plain_ms %.4f (autograd "
          "through the plain version in f32), library_ms %.4f "
          "(scaled_dot_product_attention's backward, bf16, bottom-right bool "
          "mask); %.1f TFLOP/s of the needed work, %.1f of the issued; "
          "device us by kernel %s (torch.profiler); f16 on the same values "
          "%.4f ms (plain %.4f, SDPA's backward in f16 %.4f) | %s"
          % (t["shape"], ms, t["bound_ms"], t["bound_by"],
             json.dumps({k_: round(v_, 4) for k_, v_ in terms.items()}),
             flops, issued, nbytes, torch_ops_ms, plain_ms, library_ms,
             t["tflops"], t["issued_tflops"],
             json.dumps({k_: round(v_, 1) for k_, v_ in kernel_us.items()}),
             f16_ms, f16_plain_ms, f16_library_ms, card), flush=True)
    return t


def _by_suffix(weights):
    return {n.split("_", 1)[1]: a for n, a in weights.items()}


def serve_wide_lm(mx, card, rs, d128_request_ms):
    """Phase 4e: the LM of bench_transformer.py:63-69 at its published widths
    with BENCH_HEADS=8 (D = 512, the same parameter shapes as the 32-head
    model), bf16, random weights from the seed, answering WIDE_LM_REQUESTS
    requests of 8 prompts x 1024 tokens with each prompt's greedy next
    token; every attention takes route A of the wide kernels, counted with
    the counters zeroed just before the requests and read just after."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch.ops.attention import flash_attention
    from incubator_mxnet_tpu_torch.models import TransformerLM, HostXavier
    cfg = dict(LM_CONFIG, n_heads=WIDE_LM_HEADS)
    batch = 8
    net = TransformerLM(**cfg)
    net.pos_embed.init = None
    net.initialize(HostXavier(SEED), ctx=mx.gpu(0))
    net.cast("bfloat16")
    net.collect_params().setattr("grad_req", "null")
    requests = [mx.nd.array(rs.randint(0, cfg["vocab"],
                                       (batch, cfg["seq_len"])),
                            ctx=mx.gpu(0), dtype="int32")
                for _ in range(WIDE_LM_REQUESTS)]
    with mx.autograd.predict_mode():
        net(requests[0]).wait_to_read()   # resolves the deferred shapes
    torch.cuda.synchronize()
    for c in WIDE_COUNTERS:
        setattr(flash_attention, c, 0)
    request_ms = []
    with mx.autograd.predict_mode():
        for tokens_nd in requests:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = net(tokens_nd)
            last = mx.nd.slice_axis(logits, axis=1, begin=-1, end=None)
            ids = mx.nd.argmax(last, axis=-1).asnumpy().reshape(-1)
            torch.cuda.synchronize()
            request_ms.append((time.perf_counter() - t0) * 1e3)
            check(logits.shape == (batch, cfg["seq_len"], cfg["vocab"]) and
                  bool(torch.isfinite(logits._data).all()),
                  "D = 512 LM: logits %s not finite or misshapen"
                  % (logits.shape,))
            check(ids.min() >= 0 and ids.max() < cfg["vocab"],
                  "D = 512 LM: token ids out of range: %s" % ids)
            print("serve: D = 512 LM request %d: %.3f ms, %.1f tokens/s "
                  "(the D = 128 model: mean %.3f ms), next tokens %s | %s"
                  % (len(request_ms) - 1, request_ms[-1],
                     batch * cfg["seq_len"] / request_ms[-1] * 1e3,
                     sum(d128_request_ms) / len(d128_request_ms),
                     ids.astype(np.int64).tolist(), card), flush=True)
            del logits
    launches = {c: getattr(flash_attention, c) for c in WIDE_COUNTERS}
    expected = WIDE_LM_REQUESTS * cfg["n_layers"]
    print("serve: D = 512 LM %s, launches %s (expected %d route A) | %s"
          % (cfg, launches, expected, card), flush=True)
    check(launches == dict(launches=expected, wide_launches=expected,
                           wide16_launches=expected, wide_f32_launches=0),
          "D = 512 LM: launches %s, expected %d through route A"
          % (launches, expected))
    del net, requests
    gc.collect()
    torch.cuda.empty_cache()
    return dict(request_ms=request_ms, launches=launches["wide16_launches"])


def last_token(mx, lm):
    """The served model of phase 4f: ``lm``'s last position, as a tuple of
    its logits (vocab,) in the LM's dtype and their argmax, so a response
    row is 64 KB rather than the whole (seq, vocab) logits."""

    class LastToken(mx.gluon.HybridBlock):
        def __init__(self, lm, **kwargs):
            super().__init__(**kwargs)
            self.lm = lm

        def hybrid_forward(self, F, tokens):
            last = F.slice_axis(self.lm(tokens), axis=1, begin=-1, end=None)
            last = F.reshape(last, shape=(0, -1))
            return last, F.argmax(last, axis=-1)

    return LastToken(lm)


def graph_pool_bytes(torch, pool):
    """Bytes of the caching allocator's segments in a CUDA graph memory
    pool (torch.cuda.memory_snapshot), or None when the snapshot does not
    name pools."""
    segs = torch.cuda.memory_snapshot()
    if not any("segment_pool_id" in seg for seg in segs):
        return None
    return sum(seg["total_size"] for seg in segs
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def closed_loop(srv, prompts, clients, until=None):
    """``clients`` threads, each sending its share of ``prompts`` one after
    another (the next when the last answered): once, or round and round
    until ``until(answers so far)`` is true.  Returns ([(request, row,
    record, client)] in answer order, errors, wall s)."""
    results, errors, lock = [], [], threading.Lock()

    def client(k):
        try:
            while True:
                for i in range(k, len(prompts), clients):
                    with lock:
                        if until is not None and until(len(results)):
                            return
                    fut = srv.submit("lm", prompts[i])
                    row = fut.get(timeout=600.0)
                    with lock:
                        results.append((i, row, fut.record, k))
                if until is None:
                    return
        except Exception as exc:
            errors.append(repr(exc))

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900.0)
    return results, errors, time.perf_counter() - t0


def traffic_report(what, results, wall_s, card):
    """Print and check one traffic run's SLO records: the exact sum, the
    batch sizes, latency quantiles, tokens/s and each component's mean."""
    from incubator_mxnet_tpu_torch.serving import slo
    recs = [r for _, _, r, _ in results]
    for r in recs:
        check(sum(r["components"][c] for c in slo.COMPONENTS) == r["wall_s"],
              "%s: SLO components do not sum to the wall exactly: %r"
              % (what, r))
    hist = {}
    for r in recs:
        hist[r["batch_size"]] = hist.get(r["batch_size"], 0) + 1
    batches = {b: n // b for b, n in sorted(hist.items())}
    p50, p99 = slo.quantiles(recs)
    means = {c: round(sum(r["components"][c] for r in recs) / len(recs) * 1e3,
                      3) for c in slo.COMPONENTS}
    tokens = len(recs) * LM_CONFIG["seq_len"]
    print("serve 4f: %s: %d requests in %.3f s, %.1f tokens/s; batches by "
          "size %s; latency p50 %.3f ms p99 %.3f ms; mean ms by component "
          "%s (their sum equals each request's wall exactly) | %s"
          % (what, len(recs), wall_s, tokens / wall_s, batches, p50 * 1e3,
             p99 * 1e3, json.dumps(means), card), flush=True)
    return dict(requests=len(recs), wall_s=wall_s,
                tokens_per_s=tokens / wall_s, batches_by_size=batches,
                p50_ms=p50 * 1e3, p99_ms=p99 * 1e3, component_ms=means)


def serve_runtime(mx, net, card, rs):
    """Phase 4f: the serving runtime (``mx.serving.Server``) serving the
    full-width LM through per-bucket CUDA-graph programs.  The flash
    launch counter is zeroed just before and read just after (it counts at
    eager runs and captures; a replay launches no Python); the trace of
    one bucket-8 replay proves the kernel runs in the served path."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch import serving
    from incubator_mxnet_tpu_torch.serving.batcher import host_rows
    from incubator_mxnet_tpu_torch.models import TransformerLM, HostXavier
    from incubator_mxnet_tpu_torch.ops.attention import flash_attention
    cfg = LM_CONFIG
    dev = torch.device("cuda", 0)
    lm = last_token(mx, net)
    prompts = [rs.randint(0, cfg["vocab"], (cfg["seq_len"],)).astype(np.int32)
               for _ in range(SERVE_REQUESTS)]
    out = {}
    torch.cuda.synchronize()
    flash_attention.launches = 0
    srv = serving.Server(max_batch=max(SERVE_BUCKETS), max_wait_ms=5)
    # 1. load: the registry's own copy of the weights and a pinned host copy
    t0 = time.perf_counter()
    h = srv.load("lm", block=lm, example=mx.nd.array(
        prompts[0][None], ctx=mx.gpu(0), dtype="int32"))
    out["load_s"] = time.perf_counter() - t0
    print("serve 4f: Server(max_batch=%d, max_wait_ms=5).load(\"lm\", "
          "LastToken(TransformerLM %s), bf16): %d bytes of weights in %.3f s "
          "| %s" % (max(SERVE_BUCKETS), cfg, h.nbytes, out["load_s"], card),
          flush=True)
    # 2. warmup: one program per bucket, captured off the hot path
    out["buckets"] = {}
    for b in SERVE_BUCKETS:
        n0 = len(h.capture_log)
        t0 = time.perf_counter()
        srv.warmup("lm", prompts[0], buckets=[b])
        warm_s = time.perf_counter() - t0
        cap_s = sum(sec for _, _, sec in h.capture_log[n0:])
        pool = graph_pool_bytes(torch, h._pool)
        out["buckets"][b] = dict(capture_s=cap_s, warmup_s=warm_s,
                                 pool_bytes=pool)
        print("serve 4f: bucket %d: capture %.3f s (warmup with its eager "
              "run and probe %.3f s); the handle's graph pool %s bytes | %s"
              % (b, cap_s, warm_s, "not measured" if pool is None else pool,
                 card), flush=True)
    check(h.captures == len(SERVE_BUCKETS), "warmup captured %d programs for "
          "%d buckets" % (h.captures, len(SERVE_BUCKETS)))

    def oracle():
        """Every request's answer by the bucket-1 program of the current
        version (host rows: logits as f32, the argmax)."""
        _e, params, version = srv.registry.acquire("lm")
        rows = []
        for x in prompts:
            logits, ids = h.jit_for(1)(params, torch.from_numpy(x[None]).to(
                dev))
            rows.append((host_rows(logits)[0], host_rows(ids)[0]))
        return rows, version

    def same(row, ref):
        return row[0].tobytes() == ref[0].tobytes() and \
            row[1].tobytes() == ref[1].tobytes()

    # 3. the oracle, and the eager batch-1 forward against it
    v1, version = oracle()
    check(version == 1, "version %d before any swap" % version)
    eager_err = 0.0
    with mx.autograd.predict_mode():
        for x, ref in zip(prompts, v1):
            logits, ids = lm(mx.nd.array(x[None], ctx=mx.gpu(0),
                                         dtype="int32"))
            eager_err = max(eager_err, float(np.abs(
                logits.asnumpy()[0] - ref[0]).max()))
    out["eager_vs_graph_max_abs"] = eager_err
    print("serve 4f: the bucket-1 program's answers (oracle) for %d "
          "requests; the eager batch-1 forward differs by max |d| %.3e "
          "(reported, not required to be 0)" % (len(prompts), eager_err),
          flush=True)
    # bucket-1 replay against the eager batch-1 forward, in turns
    _e, params, _v = srv.registry.acquire("lm")
    x1 = torch.from_numpy(prompts[0][None]).to(dev)
    x1_nd = mx.nd.NDArray(x1)

    def replay1():
        h.jit_for(1)(params, x1)

    def eager1():
        with mx.autograd.predict_mode():
            lm(x1_nd)

    times = {"graph": [], "eager": []}
    for r in range(6):
        for name, fn in (("graph", replay1), ("eager", eager1)) if r % 2 \
                else (("eager", eager1), ("graph", replay1)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    out["bucket1_graph_ms"] = sum(times["graph"][1:]) / 5
    out["bucket1_eager_ms"] = sum(times["eager"][1:]) / 5
    print("serve 4f: one batch-1 request (%d tokens): bucket-1 graph "
          "replay %.3f ms, eager forward %.3f ms (host clock to "
          "synchronize, mean of 5 after one, in turns) | %s"
          % (cfg["seq_len"], out["bucket1_graph_ms"],
             out["bucket1_eager_ms"], card), flush=True)
    del params, _e
    # 4. closed-loop traffic
    results, errors, wall = closed_loop(srv, prompts, SERVE_CLIENTS)
    check(not errors and len(results) == len(prompts),
          "traffic: %d answers, errors %s" % (len(results), errors))
    for i, row, rec, _k in results:
        check(same(row, v1[i]) and rec["version"] == 1, "traffic: request %d "
              "differs from the bucket-1 program" % i)
    out["traffic"] = traffic_report("closed loop, %d clients" % SERVE_CLIENTS,
                                    results, wall, card)
    # 5. a swap mid-traffic to a second version (HostXavier(SEED + 1), bf16)
    v2net = TransformerLM(**cfg)
    v2net.pos_embed.init = None
    v2net.initialize(HostXavier(SEED + 1), ctx=mx.gpu(0))
    v2net.cast("bfloat16")
    v2net.collect_params().setattr("grad_req", "null")
    with mx.autograd.predict_mode():
        v2net(mx.nd.array(prompts[0][None], ctx=mx.gpu(0),
                          dtype="int32")).wait_to_read()
    names = sorted(lm.collect_params().keys())
    v2names = sorted(v2net.collect_params().keys())
    check([n[len(net.prefix):] for n in names] ==
          [n[len(v2net.prefix):] for n in v2names],
          "the second version's parameters do not match the served ones")
    new_params = {n: v2net.collect_params()[m].data()._data.cpu()
                  for n, m in zip(names, v2names)}
    del v2net
    gc.collect()
    torch.cuda.empty_cache()
    # the clients go round until SERVE_REQUESTS answers came after the
    # commit; the swap starts after SERVE_REQUESTS // 4 answers
    swap_at = SERVE_REQUESTS // 4
    box = {}

    def until(n):       # called under closed_loop's lock
        if n >= swap_at and "thread" not in box:
            box["thread"] = threading.Thread(target=swapper)
            box["thread"].start()
        if "version" not in box:
            return False
        return n >= box.setdefault("answers_at_commit", n) + SERVE_REQUESTS

    def swapper():
        t0 = time.perf_counter()
        version = srv.swap("lm", new_params)
        box["swap_s"] = time.perf_counter() - t0
        box["version"] = version

    results, errors, wall = closed_loop(srv, prompts, SERVE_CLIENTS, until)
    box.pop("thread").join(600.0)
    check(not errors and box.get("version") == 2, "swap traffic: %d answers, "
          "errors %s, swap %s" % (len(results), errors, box))
    v2, version = oracle()
    check(version == 2, "version %d after the swap" % version)
    by_version = {1: 0, 2: 0}
    per_client = {}
    for i, row, rec, k in results:
        ref = v1[i] if rec["version"] == 1 else v2[i]
        check(same(row, ref), "swap traffic: request %d is not entirely "
              "version %d's answer" % (i, rec["version"]))
        check(not same(v1[i], v2[i]), "the two versions answer request %d "
              "alike" % i)
        by_version[rec["version"]] += 1
        per_client.setdefault(k, []).append(rec["version"])
    for k, vs in per_client.items():
        check(vs == sorted(vs), "client %d saw versions %s: not monotonic"
              % (k, vs))
    check(by_version[1] > 0 and by_version[2] > 0, "responses by version %s: "
          "the swap did not land mid-traffic" % by_version)
    out["swap"] = dict(box, by_version=by_version, traffic=traffic_report(
        "closed loop with a swap after %d answers" % swap_at, results, wall,
        card))
    print("serve 4f: swap to version 2 (HostXavier(%d), bf16) in %.3f s "
          "mid-traffic; responses by version %s, every one entirely its "
          "version's, monotonic per client | %s"
          % (SEED + 1, box["swap_s"], by_version, card), flush=True)
    del new_params
    # 6. eviction, then one request: a transparent reload, bit for bit
    loader, reload_s = h._loader, []

    def timed_loader():
        t0 = time.perf_counter()
        params = loader()
        reload_s.append(time.perf_counter() - t0)
        return params

    h._loader = timed_loader
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    check(srv.registry.evict("lm") and not h.resident and
          not h.graph_keys(), "evict kept the weights or the graphs")
    gc.collect()
    torch.cuda.synchronize()
    freed = held - torch.cuda.memory_allocated()
    captures = h.captures
    t0 = time.perf_counter()
    row = srv.predict("lm", prompts[0], timeout=600.0)
    request_s = time.perf_counter() - t0
    check(len(reload_s) == 1 and h.resident and h.version == 2 and
          srv.registry.reloads_total == 1 and same(row, v2[0]),
          "the evicted model did not reload to version 2 bit for bit")
    out["reload"] = dict(reload_s=reload_s[0], request_s=request_s,
                         freed_bytes=freed,
                         recaptures=h.captures - captures)
    print("serve 4f: evict freed %d bytes (weights and graphs); the next "
          "request reloaded version 2 in %.3f s (request %.3f s with its "
          "bucket-1 capture), bit-equal | %s"
          % (freed, reload_s[0], request_s, card), flush=True)
    # 7. one fused pass: the probe decides, no delivered row may differ
    os.environ["GRAFT_SERVE_BATCH_MODE"] = "fused"
    try:
        futs = [srv.submit("lm", prompts[i]) for i in range(8)]
        rows = [f.get(timeout=600.0) for f in futs]
    finally:
        del os.environ["GRAFT_SERVE_BATCH_MODE"]
    for i, (f, row) in enumerate(zip(futs, rows)):
        check(same(row, v2[i]), "fused pass: request %d differs from the "
              "bucket-1 program" % i)
    demoted = bool(h.no_batch)
    _e, params, _v = srv.registry.acquire("lm")
    x8 = torch.from_numpy(np.stack(prompts[:8])).to(dev)
    logits8, _ids8 = h.jit_for(8, "fused")(params, x8)
    fused_err = float(np.abs(host_rows(logits8) - np.stack(
        [r[0] for r in v2[:8]])).max())
    out["fused"] = dict(demoted=demoted, sizes=sorted(
        {f.record["batch_size"] for f in futs}), max_abs_vs_bucket1=fused_err)
    print("serve 4f: fused pass (GRAFT_SERVE_BATCH_MODE=fused), batch sizes "
          "%s: the probe %s; the fused bucket-8 program differs from the "
          "bucket-1 program by max |d| %.3e; every delivered row bit-equal "
          "to the bucket-1 program | %s"
          % (out["fused"]["sizes"], "demoted the shape to per-request "
             "dispatch" if demoted else "found row 0 bit-equal (kept)",
             fused_err, card), flush=True)
    # 8. the kernel in the served path: one exact bucket-8 replay, traced
    program = h.jit_for(8, "exact")
    got = [program(params, x8)]
    prof, wall_us = profiled(lambda: got.__setitem__(0, program(params, x8)))
    got = got[0]
    kernels = trace_kernels(prof)
    flash = sum(n for name, (_, n) in kernels.items()
                if "flash_fwd_sm90_kernel" in name)
    busy = sum(us for us, _ in kernels.values())
    for i in range(8):
        check(same((host_rows(got[0])[i], host_rows(got[1])[i]), v2[i]),
              "the traced bucket-8 replay differs from the bucket-1 program "
              "on row %d" % i)
    out["replay8"] = dict(flash_fwd_sm90_kernel=flash, wall_us=wall_us,
                          busy_us=busy, busy_share=busy / wall_us,
                          idle_share=max(0.0, 1 - busy / wall_us))
    print("serve 4f: one exact bucket-8 replay under torch.profiler: %d "
          "flash_fwd_sm90_kernel launches (expected %d), %d device "
          "activities, wall "
          "%.1f us, device busy %.1f us, busy share %.4f, idle share %.4f "
          "| %s" % (flash, 8 * cfg["n_layers"], sum(
              n for _, n in kernels.values()), wall_us, busy,
                    busy / wall_us, out["replay8"]["idle_share"], card),
          flush=True)
    check(flash == 8 * cfg["n_layers"], "the bucket-8 replay's trace lists "
          "%d flash_fwd_sm90_kernel launches, expected %d"
          % (flash, 8 * cfg["n_layers"]))
    del got, logits8, _ids8, params, _e, x8, program
    out["launches"] = flash_attention.launches
    out["captures"] = h.captures
    out["stats"] = srv.stats()["registry"]["models"]["lm"]
    srv.close()
    srv.registry.unload("lm")
    print("serve 4f: flash_attention launches counted on the path (eager "
          "runs and captures; replays launch no Python) %d; captures %d "
          "| %s" % (out["launches"], out["captures"], card), flush=True)
    check(out["launches"] > 0, "phase 4f launched no flash kernel")
    # 9. the CLI's selftest on the card, as a subprocess
    proc = subprocess.run([sys.executable, "-m",
                           "incubator_mxnet_tpu_torch.serving", "--selftest"],
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    for line in proc.stdout.splitlines():
        print("serve 4f: selftest: " + line)
    check(proc.returncode == 0 and "selftest OK" in proc.stdout,
          "python -m incubator_mxnet_tpu_torch.serving --selftest exited %d: "
          "%s" % (proc.returncode, proc.stderr[-2000:]))
    del srv, h, lm
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_small_lm(mx, card):
    """The small f32 LM trained SMALL_TRAIN_STEPS steps through
    DataParallelTrainer on the card against the same steps on the CPU, from
    the same weights; the flash kernel's counts zeroed just before the
    card's run and read just after.  Returns the card run's launches."""
    import numpy as np
    from incubator_mxnet_tpu_torch.models import TransformerLM, HostXavier
    from incubator_mxnet_tpu_torch.convert import (load_numpy_params,
                                                   numpy_params)
    from incubator_mxnet_tpu_torch.ops.attention import (flash_attention,
                                                         split_f32)
    small = SMALL_LMS[0][2]
    rs = np.random.RandomState(SEED + 3)
    tokens = rs.randint(0, small["vocab"], (2, small["seq_len"]))
    labels = rs.randint(0, small["vocab"],
                        (2, small["seq_len"])).astype(np.float32)
    with mx.cpu():
        init = TransformerLM(**small)
        init.initialize(HostXavier(SEED))
        init(mx.nd.array(tokens))
        weights = numpy_params(init)

    def run(ctx):
        with ctx:
            net = TransformerLM(**small)
            load_numpy_params(net, weights, ctx)
            trainer = mx.parallel.DataParallelTrainer(
                net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                dict(TRAIN_OPT))
            x = mx.nd.array(tokens, dtype="int32")
            y = mx.nd.array(labels)
            losses = [float(trainer.step(x, y).asscalar())
                      for _ in range(SMALL_TRAIN_STEPS)]
            trainer.sync_params()
            return losses, _by_suffix(numpy_params(net))

    want_losses, want_w = run(mx.cpu())
    flash_attention.launches = flash_attention.f32_launches = 0
    flash_attention.backward_calls = split_f32.launches = 0
    flash_attention.backward_kernel_launches = 0
    flash_attention.backward_torch_calls = 0
    got_losses, got_w = run(mx.gpu(0))
    launches = {"launches": flash_attention.launches,
                "f32_launches": flash_attention.f32_launches,
                "split_f32": split_f32.launches,
                "backward_calls": flash_attention.backward_calls,
                "backward_torch_calls": flash_attention.backward_torch_calls,
                "backward_kernel_launches":
                    flash_attention.backward_kernel_launches}
    w_err = max(float(np.abs(got_w[k] - want_w[k]).max()) for k in want_w)
    l_err = max(abs(a - b) / abs(b) for a, b in zip(got_losses, want_losses))
    print("train: small LM %s f32, %d steps through DataParallelTrainer on "
          "the card vs the CPU: losses %s vs %s (max rel err %.3e, bound "
          "%.0e), weights max_abs_err %.3e (bound %.0e); launches %s | %s"
          % (small, SMALL_TRAIN_STEPS, ["%.6f" % v for v in got_losses],
             ["%.6f" % v for v in want_losses], l_err, SMALL_TRAIN_LOSS_RTOL,
             w_err, SMALL_TRAIN_W_TOL, launches, card), flush=True)
    expected = small["n_layers"] * SMALL_TRAIN_STEPS
    check(launches["f32_launches"] == expected and
          launches["backward_calls"] == expected and
          launches["backward_torch_calls"] == expected and
          launches["backward_kernel_launches"] == 0,
          "small LM training: %s for %d layers x %d steps" % (
              launches, small["n_layers"], SMALL_TRAIN_STEPS))
    check(sorted(got_w) == sorted(want_w), "small LM training: names differ")
    check(w_err <= SMALL_TRAIN_W_TOL, "small LM training: card and CPU "
          "weights disagree")
    check(l_err <= SMALL_TRAIN_LOSS_RTOL, "small LM training: card and CPU "
          "losses disagree")
    check(got_losses[-1] < got_losses[0], "small LM training: the loss did "
          "not fall: %s" % got_losses)
    return launches


def train_full_lm(mx, card):
    """The LM of bench_transformer.py at full width, uncut, trained as the
    bench trains it (:147-170), TRAIN_WARMUP steps then TRAIN_STEPS timed
    steps; one more step under the profiler.  Returns the run's numbers."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch.models import TransformerLM, HostXavier
    from incubator_mxnet_tpu_torch.ops.attention import flash_attention
    cfg = LM_CONFIG
    batch, seq, vocab = TRAIN_BATCH, cfg["seq_len"], cfg["vocab"]
    t0 = time.perf_counter()
    net = TransformerLM(**cfg)
    net.pos_embed.init = None      # HostXavier for every weight, as the bench
    net.initialize(HostXavier(SEED), ctx=mx.gpu(0))
    rs = np.random.RandomState(0)
    x = mx.nd.array(rs.randint(0, vocab, (batch, seq)), ctx=mx.gpu(0),
                    dtype="int32")
    y = mx.nd.array(rs.randint(0, vocab, (batch, seq)).astype(np.float32),
                    ctx=mx.gpu(0))
    trainer = mx.parallel.DataParallelTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", dict(TRAIN_OPT),
        dtype="bfloat16")
    losses, step_ms = [], []
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        if i == TRAIN_WARMUP:      # the timed steps: counts from 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            flash_attention.launches = flash_attention.backward_calls = 0
            flash_attention.backward_kernel_launches = 0
            flash_attention.backward_torch_calls = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(float(trainer.step(x, y).asscalar()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        if i == 0:
            print("train: TransformerLM %s, DataParallelTrainer(sgd %s, "
                  "dtype=bfloat16), batch %d x %d: built, initialized and "
                  "the first step in %.1f s" % (cfg, TRAIN_OPT, batch, seq,
                                                time.perf_counter() - t0),
                  flush=True)
    launches = {"flash_attention_fwd": flash_attention.launches,
                "flash_attention_bwd_calls": flash_attention.backward_calls,
                "flash_attention_bwd": flash_attention.backward_kernel_launches,
                "flash_attention_bwd_torch_calls":
                    flash_attention.backward_torch_calls}
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(int(np.prod(p.shape)) for p in
                   net.collect_params().values())
    n_matmul = n_params - (vocab + seq) * cfg["d_model"]
    tokens = batch * seq
    flops = model_flops_per_step(n_matmul, tokens, seq, cfg["d_model"],
                                 cfg["n_layers"])
    timed = step_ms[TRAIN_WARMUP:]
    mean_s = sum(timed) / len(timed) / 1e3
    for i, (ms, loss) in enumerate(zip(step_ms, losses)):
        print("train: step %d%s: %.3f ms, loss %.6f | %s"
              % (i, " (warm-up)" if i < TRAIN_WARMUP else "", ms, loss, card))
    result = {"n_params": n_params, "n_params_non_embedding": n_matmul,
              "step_ms": timed, "step_ms_mean": mean_s * 1e3,
              "tokens_per_s": tokens / mean_s,
              "mfu": flops / mean_s / H100_BF16_FLOPS,
              "model_flops_per_step": flops, "peak_memory_bytes": peak,
              "losses": losses, "launches": launches}
    print("train: %d parameters (%d non-embedding); %d timed steps: mean "
          "%.3f ms, %.1f tokens/s, MFU %.4f (%.4e model flop a step over "
          "989 TFLOP/s); peak memory allocated %d bytes; launches %s in %d "
          "steps (%.1f flash forward launches a step) | %s"
          % (n_params, n_matmul, TRAIN_STEPS, result["step_ms_mean"],
             result["tokens_per_s"], result["mfu"], flops, peak, launches,
             TRAIN_STEPS, launches["flash_attention_fwd"] / TRAIN_STEPS,
             card), flush=True)
    check(all(math.isfinite(v) for v in losses), "training loss not finite: "
          "%s" % losses)
    check(losses[-1] < losses[0], "training loss did not fall: %s" % losses)
    expected = cfg["n_layers"] * TRAIN_STEPS
    check(launches["flash_attention_fwd"] == expected and
          launches["flash_attention_bwd_calls"] == expected and
          launches["flash_attention_bwd"] == expected and
          launches["flash_attention_bwd_torch_calls"] == 0,
          "training launches %s, expected %d each and no backward through "
          "the torch ops" % (launches, expected))
    d, f = cfg["d_model"], cfg["d_ffn"]
    gemm_flops = 3 * 2.0 * tokens * (cfg["n_layers"] * (4 * d * d + 2 * d * f)
                                     + d * vocab)
    result["profile"] = profile_training_step(
        lambda: trainer.step(x, y).asscalar(), gemm_flops, card)
    del trainer, net, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 6: ResNet-50 v1, the model of bench.py (:199-211) and of
# BASELINE.json's config 2: convolutions on cuDNN (aten.convolution, TF32
# off for f32), Pooling and BatchNorm in torch ops; no hand kernel
# ---------------------------------------------------------------------------
RESNET_SMALL = dict(thumbnail=True, classes=10)
RESNET_SMALL_BATCH, RESNET_SMALL_STEPS = 4, 3
RESNET_SMALL_OPT = {"learning_rate": 0.01, "momentum": 0.9}
# card vs CPU in f32 (6a): the same f32 operations summed in other orders
# (cuDNN's convolutions, the CPU's), ~1e-7 each, carried through 49
# (batch-)normalized layers: ~1e-5 of the largest logit (the CPU tests
# measure 2.4e-5 between the port and the JAX build in training mode).  A
# TF32 convolution rounds its inputs to 10 mantissa bits (~5e-4 each), so
# this bound must fail for it; the smoke runs the same forward with TF32 on
# and checks that it does
RESNET_F32_REL = 1e-4
# a trainer step taken on the card from the CPU's state: the loss and the
# running statistics to RESNET_F32_REL, each weight's update and momentum
# to a relative L2 distance of 0.1 (the gradients: relu's derivative jumps
# at 0, and the JAX build's own gradients move by 2-2.5% when its input
# moves by one ulp, tests/test_torch_resnet.py); in bf16 each to twice the
# CPU's own bf16-to-f32 distance after its first step, or those floors
RESNET_UPDATE_L2 = 0.1
# 6b: BASELINE.md:17's ResNet-50 inference batch, bf16, 224x224
RESNET_IMAGE = 224
RESNET_SERVE_BATCH, RESNET_SERVE_BATCHES = 32, 4
# 6c: bench.py's step: batch 256 of 3x224x224, bf16 compute over f32
# master weights, SGD momentum 0.9 at lr 0.1
RESNET_TRAIN_BATCH, RESNET_TRAIN_WARMUP, RESNET_TRAIN_STEPS = 256, 3, 5
RESNET_TRAIN_OPT = {"learning_rate": 0.1, "momentum": 0.9}
# the ops whose calls a profile attributes by span (smoke-side
# record_function wrappers, installed only around a profiled call), and the
# autograd nodes of their backward
RESNET_OP_SPANS = ("Convolution", "BatchNorm", "Pooling", "Activation",
                   "broadcast_add", "FullyConnected")
RESNET_GROUPS = (
    ("conv_layout_transpose", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("conv_fwd", ("op:Convolution",)),
    ("conv_dgrad_wgrad", ("_ConvolutionFunctionBackward",)),
    ("batchnorm", ("op:BatchNorm", "_BatchNormTrainFunction")),
    ("relu_add", ("op:Activation", "op:broadcast_add", "ReluBackward",
                  "ThresholdBackward", "AddBackward")),
    ("pooling", ("op:Pooling", "MaxPool2DWithIndicesBackward",
                 "AvgPool2DBackward", "ConstantPadNdBackward")),
    ("optimizer_update", ("DataParallelTrainer.update",)),
)


def op_device_work(prof):
    """The device work of a :func:`profiled` session's timed call, each
    item with the names of the CPU spans (record_function spans and torch
    ops, autograd nodes included) that enclose its launch on the launching
    thread: [(kernel name, us, [span names])]."""
    from incubator_mxnet_tpu_torch import cuda_build
    path = cuda_build.BUILD_DIR.parent / ("trace-op-%d.json" % os.getpid())
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        path.unlink()
    launches, spans, timed, device = {}, {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args") or {}
        a, b = e["ts"], e["ts"] + e.get("dur", 0)
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = (a, e.get("tid"))
        elif cat in ("cpu_op", "user_annotation"):
            if e.get("name") == PROFILED_SPAN:
                timed.append((a, b))
            spans.setdefault(e.get("tid"), []).append((a, b, e.get("name")))
        elif cat in DEVICE_CATEGORIES:
            device.append((e.get("name", ""), float(e.get("dur", 0)),
                           args.get("correlation")))
    work = []
    for name, us, corr in device:
        ts, tid = launches.get(corr, (None, None))
        if ts is None or not any(a <= ts <= b for a, b in timed):
            continue
        work.append((name, us, [n for a, b, n in spans.get(tid, ())
                                if a <= ts <= b]))
    return work


@contextlib.contextmanager
def wrapped_ops(names, wrap):
    """While active, the fcompute of each registered op in ``names`` is
    ``wrap(name, fcompute)``; the originals come back on the way out."""
    from incubator_mxnet_tpu_torch.ops.registry import get_op
    saved = [(get_op(n), get_op(n).fcompute) for n in names]
    for (op, real), n in zip(saved, names):
        op.fcompute = wrap(n, real)
    try:
        yield
    finally:
        for op, real in saved:
            op.fcompute = real


def _in_span(name, real):
    """``real`` inside a record_function span ``op:<name>``."""
    import torch

    def call(*a, **k):
        with torch.profiler.record_function("op:" + name):
            return real(*a, **k)
    return call


def resnet_profile(run, what, card, spans=RESNET_OP_SPANS,
                   groups=RESNET_GROUPS):
    """One call of ``run`` under torch.profiler (:func:`profiled`), device
    time by ``groups`` (a kernel joins the first group one of whose keys
    is in its name or in a span around its launch; the registered ops in
    ``spans`` run inside spans ``op:<name>``), with the idle share."""
    with wrapped_ops(spans, _in_span):
        prof, wall_us = profiled(run)
    work = op_device_work(prof)
    if not work:
        print("profile: torch.profiler recorded no device time: not measured")
        return None
    by_group = dict.fromkeys([g for g, _ in groups] + ["other"], 0.0)
    top = {}
    for name, us, names in work:
        low = name.lower()
        group = next((g for g, keys in groups
                      if any(k in low for k in keys) or
                      any(k in n for k in keys for n in names if n)), "other")
        by_group[group] += us
        top[(group, name)] = top.get((group, name), 0.0) + us
    busy = sum(by_group.values())
    out = dict(by_group, wall_us=wall_us, busy_us=busy,
               idle_share=max(0.0, 1 - busy / wall_us))
    print("profile: %s under torch.profiler: wall %.1f us, device busy %.1f "
          "us, idle share %.4f | %s" % (what, wall_us, busy,
                                        out["idle_share"], card))
    print("profile: device us by group %s" % json.dumps(
        {k: round(v, 1) for k, v in by_group.items()}), flush=True)
    for (group, name), us in sorted(top.items(), key=lambda kv: -kv[1])[:10]:
        print("profile:   %10.1f us  %-22s %s" % (us, group, name[:90]))
    return out


@contextlib.contextmanager
def conv_flops():
    """While active, counts into the yielded list's one item the flop (2 a
    multiply-add) of every Convolution and FullyConnected call, from its
    own shapes."""
    count = [0]

    def wrap(_name, real):
        def call(data, weight, *a, **k):
            out = real(data, weight, *a, **k)
            count[0] += 2 * out.numel() * int(math.prod(weight.shape[1:]))
            return out
        return call
    with wrapped_ops(("Convolution", "FullyConnected"), wrap):
        yield count


def _resnet_weights(mx, np, rs):
    """The small ResNet's f32 weights by name: the port's Xavier draws
    (seeded) with BatchNorm's gamma, beta and running statistics drawn away
    from their init."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    from incubator_mxnet_tpu_torch.convert import numpy_params
    mx.random.seed(SEED)
    with mx.cpu():
        net = vision.resnet50_v1(**RESNET_SMALL)
        net.initialize(mx.init.Xavier())
        with mx.autograd.predict_mode():
            net(mx.nd.array(np.zeros((1, 3, 32, 32), np.float32)))
        weights = numpy_params(net)
    for name, v in weights.items():
        if name.endswith("gamma") or name.endswith("running_var"):
            weights[name] = rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif name.endswith("beta") or name.endswith("running_mean"):
            weights[name] = (0.1 * rs.standard_normal(v.shape)).astype(
                np.float32)
    return weights


def _resnet_forward(mx, weights, x, y, ctx):
    """The small ResNet from ``weights`` on ``ctx``: (inference logits,
    training-mode logits, the loss of that forward)."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    from incubator_mxnet_tpu_torch.convert import load_numpy_params
    with ctx:
        net = vision.resnet50_v1(**RESNET_SMALL)
        load_numpy_params(net, weights, ctx)
        xs, ys = mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx)
        with mx.autograd.predict_mode():
            infer = net(xs).asnumpy()
        with mx.autograd.train_mode():
            logits = net(xs)
            loss = mx.nd.mean(mx.gluon.loss.SoftmaxCrossEntropyLoss()(
                logits, ys)).asscalar()
        return infer, logits.asnumpy(), float(loss)


class _SmallTrainer(object):
    """A DataParallelTrainer of the small ResNet on ``ctx`` whose state (f32
    master weights and momenta, by short name) can be read and set, so the
    card can take each step from the CPU's state before it."""

    def __init__(self, mx, weights, x, y, ctx, dtype):
        from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
        from incubator_mxnet_tpu_torch.convert import load_numpy_params
        self.ctx = ctx
        with ctx:
            self.net = vision.resnet50_v1(**RESNET_SMALL)
            load_numpy_params(self.net, weights, ctx)
            self.x, self.y = mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx)
            self.tr = mx.parallel.DataParallelTrainer(
                self.net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                dict(RESNET_SMALL_OPT), dtype=dtype)
            self.tr._gather_params(self.x._data)

    def state(self):
        cut = len(self.net.prefix)
        return ({n[cut:]: v.cpu().numpy().copy()
                 for n, v in self.tr._params.items()},
                {n[cut:]: s[0].cpu().numpy().copy()
                 for n, s in self.tr._opt_state.items()})

    def load(self, state):
        import torch
        weights, moms = state
        cut = len(self.net.prefix)
        with torch.no_grad():
            for n, v in self.tr._params.items():
                v.copy_(torch.from_numpy(weights[n[cut:]]))
            for n, (mom,) in self.tr._opt_state.items():
                mom.copy_(torch.from_numpy(moms[n[cut:]]))

    def step(self):
        with self.ctx:
            return float(self.tr.step(self.x, self.y).asscalar())


def _step_errors(before, got, want, loss_got, loss_want):
    """One step taken from the same state: the loss's relative error, the
    running statistics' largest error over each one's largest value (the
    forward's), and the largest relative L2 distance of a weight's update or
    momentum (the gradient's); the 1x1 convolutions' biases, which feed
    BatchNorm and have no true gradient, as their largest |update|."""
    (w0, _), (g1, gm), (w1, m1) = before, got, want
    out = dict(loss=abs(loss_got - loss_want) / abs(loss_want), stats=0.0,
               update=0.0, pre_bn_bias=0.0, update_name="")

    def l2(a, b):
        return float(((a - b) ** 2).sum() ** 0.5 /
                     max(float((b ** 2).sum() ** 0.5), 1e-30))
    for n in w1:
        if "running" in n:
            out["stats"] = max(out["stats"], float(abs(g1[n] - w1[n]).max()
                                                   / abs(w1[n]).max()))
        elif n.endswith("bias") and not n.startswith("dense"):
            out["pre_bn_bias"] = max(out["pre_bn_bias"],
                                     float(abs(g1[n] - w0[n]).max()))
        else:
            e = max(l2(g1[n] - w0[n], w1[n] - w0[n]), l2(gm[n], m1[n]))
            if e > out["update"]:
                out["update"], out["update_name"] = e, n
    return out


def resnet_small(mx, card):
    """Phase 6a: resnet50_v1(thumbnail=True, classes=10), batch 4 of 32x32,
    the same weights on the card and on the CPU: the inference forward, the
    training-mode forward and loss in f32 (TF32 on by torch's default: the
    op's guard must keep f32), and once more with TF32 convolutions, which
    must break the f32 bound; then RESNET_SMALL_STEPS DataParallelTrainer
    steps in f32 and in bf16 compute, each taken on the card from the CPU's
    state before it (two runs from one start part after a step: relu's
    derivative jumps at 0 and the net amplifies rounding differences,
    tests/test_torch_resnet.py)."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch.ops import nn as tnn
    rs = np.random.RandomState(SEED + 6)
    weights = _resnet_weights(mx, np, rs)
    x = rs.standard_normal((RESNET_SMALL_BATCH, 3, 32, 32)).astype(
        np.float32)
    y = rs.randint(0, RESNET_SMALL["classes"], RESNET_SMALL_BATCH).astype(
        np.float32)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True      # torch's default
    try:
        cpu_fwd = _resnet_forward(mx, weights, x, y, mx.cpu())
        card_fwd = _resnet_forward(mx, weights, x, y, mx.gpu(0))

        @contextlib.contextmanager
        def tf32_convolutions():
            yield                       # the guard left out: TF32 stays on
        real_guard = tnn._f32_convolutions
        tnn._f32_convolutions = tf32_convolutions
        try:
            tf32_fwd = _resnet_forward(mx, weights, x, y, mx.gpu(0))
        finally:
            tnn._f32_convolutions = real_guard
        steps = {}
        for dtype in (None, "bfloat16"):
            cpu = _SmallTrainer(mx, weights, x, y, mx.cpu(), dtype)
            gpu = _SmallTrainer(mx, weights, x, y, mx.gpu(0), dtype)
            rows = []
            for _ in range(RESNET_SMALL_STEPS):
                before = cpu.state()
                loss_want = cpu.step()
                gpu.load(before)
                loss_got = gpu.step()
                rows.append((before, gpu.state(), cpu.state(), loss_got,
                             loss_want))
            steps[dtype] = rows
    finally:
        torch.backends.cudnn.allow_tf32 = prev

    def rel(got, want):
        return float(np.abs(got - want).max() / np.abs(want).max())
    errs = {"infer_f32": rel(card_fwd[0], cpu_fwd[0]),
            "infer_tf32": rel(tf32_fwd[0], cpu_fwd[0]),
            "train_logits_f32": rel(card_fwd[1], cpu_fwd[1]),
            "train_logits_tf32": rel(tf32_fwd[1], cpu_fwd[1]),
            "train_loss_f32": abs(card_fwd[2] - cpu_fwd[2]) / cpu_fwd[2]}
    print("resnet 6a: resnet50_v1%s, batch %d: card vs CPU, max |d| / max "
          "|CPU|: %s; f32 bound %.0e, which TF32 must break | %s"
          % (RESNET_SMALL, RESNET_SMALL_BATCH, json.dumps(
              {k: "%.3e" % v for k, v in errs.items()}), RESNET_F32_REL,
             card), flush=True)
    check(errs["infer_f32"] <= RESNET_F32_REL and
          errs["train_logits_f32"] <= RESNET_F32_REL and
          errs["train_loss_f32"] <= RESNET_F32_REL,
          "6a: card and CPU disagree in f32: %s" % errs)
    check(errs["infer_tf32"] > RESNET_F32_REL and
          errs["train_logits_tf32"] > RESNET_F32_REL,
          "6a: TF32 convolutions do not break the f32 bound, so it does not "
          "show that f32 stays f32: %s" % errs)
    # bf16: the CPU's own bf16-to-f32 distance after the first step (both
    # from the same start) is the scale of bf16's differences
    (w0, m0), _, f1, _, f_loss = steps[None][0]
    _, _, b1, _, b_loss = steps["bfloat16"][0]
    noise = _step_errors((w0, m0), b1, f1, b_loss, f_loss)
    out = dict(errs, bf16_noise=noise)
    for dtype in (None, "bfloat16"):
        tag = "f32" if dtype is None else "bf16"
        if dtype is None:
            bounds = dict(loss=RESNET_F32_REL, stats=RESNET_F32_REL,
                          update=RESNET_UPDATE_L2, pre_bn_bias=1e-6)
        else:
            bounds = {k: max(floor, 2 * noise[k]) for k, floor in
                      (("loss", RESNET_F32_REL), ("stats", RESNET_F32_REL),
                       ("update", RESNET_UPDATE_L2), ("pre_bn_bias", 1e-6))}
        for k, (before, got, want, loss_got, loss_want) in enumerate(
                steps[dtype]):
            e = _step_errors(before, got, want, loss_got, loss_want)
            out["%s_step%d" % (tag, k)] = e
            print("resnet 6a: %s step %d from the CPU's state: loss card %.6f "
                  "CPU %.6f; errors %s; bounds %s"
                  % (tag, k, loss_got, loss_want, json.dumps(
                      {k_: ("%.3e" % v if isinstance(v, float) else v)
                       for k_, v in e.items()}), json.dumps(
                      {k_: "%.3e" % v for k_, v in bounds.items()})),
                  flush=True)
            check(math.isfinite(loss_got), "6a: a loss is not finite")
            for k_, bound in bounds.items():
                check(e[k_] <= bound, "6a: %s step %d: %s %.3e above %.3e"
                      % (tag, k, k_, e[k_], bound))
    return out


def _resnet_full(mx, np, seed=SEED):
    """resnet50_v1(classes=1000) on the card, Xavier (seeded), its deferred
    shapes resolved."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    mx.random.seed(seed)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    with mx.autograd.predict_mode():
        net(mx.nd.array(np.zeros((1, 3, RESNET_IMAGE, RESNET_IMAGE),
                                 np.float32), ctx=mx.gpu(0)))
    return net


def resnet_serve(mx, card):
    """Phase 6b: resnet50_v1(classes=1000) in bf16, inference mode, batch
    RESNET_SERVE_BATCH of 3x224x224 (seeded): one warm-up batch, then
    RESNET_SERVE_BATCHES timed ones (host clock to synchronize); the bf16
    logits against the f32 net's on the same batch; one batch under the
    profiler by group."""
    import numpy as np
    import torch
    net = _resnet_full(mx, np)
    net.collect_params().setattr("grad_req", "null")
    rs = np.random.RandomState(SEED + 7)
    x32 = mx.nd.array(rs.rand(RESNET_SERVE_BATCH, 3, RESNET_IMAGE,
                              RESNET_IMAGE).astype(np.float32), ctx=mx.gpu(0))
    with mx.autograd.predict_mode():
        ref = net(x32).asnumpy()
    net.cast("bfloat16")
    x = x32.astype("bfloat16")
    del x32

    def batch():
        with mx.autograd.predict_mode():
            return net(x)
    out = batch().asnumpy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(RESNET_SERVE_BATCHES):
        t0 = time.perf_counter()
        batch()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    with conv_flops() as flop:
        batch()
    flop = flop[0]
    mean = sum(ms) / len(ms)
    err = float(np.linalg.norm(out - ref) / np.linalg.norm(ref))
    result = dict(batch_ms=ms, batch_ms_mean=mean,
                  img_per_s=RESNET_SERVE_BATCH / mean * 1e3,
                  peak_memory_bytes=peak, flop=flop,
                  tflops=flop / mean / 1e9, bf16_vs_f32_rel_l2=err)
    print("resnet 6b: resnet50_v1(classes=1000) bf16 inference, batch %d x "
          "3x%dx%d: %s ms a batch (mean %.3f), %.1f img/s, %.4e conv and "
          "dense flop a batch (%.1f TFLOP/s), peak memory allocated %d "
          "bytes; bf16 logits vs the f32 net's, relative L2 %.3e | %s"
          % (RESNET_SERVE_BATCH, RESNET_IMAGE, RESNET_IMAGE,
             ["%.3f" % v for v in ms], mean, result["img_per_s"], flop,
             result["tflops"], peak, err, card), flush=True)
    check(out.shape == (RESNET_SERVE_BATCH, 1000) and
          np.isfinite(out).all(), "6b: logits of shape %s, finite %s"
          % (out.shape, np.isfinite(out).all()))
    check(err <= 0.1, "6b: bf16 logits %.3e (relative L2) from the f32 "
          "net's" % err)
    result["profile"] = resnet_profile(batch, "6b one inference batch", card)
    del net, x
    gc.collect()
    torch.cuda.empty_cache()
    return result


def resnet_train(mx, card):
    """Phase 6c: bench.py's training run on the card: resnet50_v1(classes=
    1000), Xavier, DataParallelTrainer with SoftmaxCrossEntropyLoss, SGD
    momentum 0.9 at lr 0.1, bf16 compute over f32 master weights, batch
    RESNET_TRAIN_BATCH from np.random.RandomState(0) as bench.py makes it;
    RESNET_TRAIN_WARMUP warm-up and RESNET_TRAIN_STEPS timed steps on the
    same batch; one more under the profiler."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    net = _resnet_full(mx, np)
    rs = np.random.RandomState(0)
    x = mx.nd.array(rs.rand(RESNET_TRAIN_BATCH, 3, RESNET_IMAGE,
                            RESNET_IMAGE).astype(np.float32), ctx=mx.gpu(0))
    y = mx.nd.array((rs.rand(RESNET_TRAIN_BATCH) * 1000).astype(np.float32),
                    ctx=mx.gpu(0))
    trainer = mx.parallel.DataParallelTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        dict(RESNET_TRAIN_OPT), dtype="bfloat16")
    running = [n for n in net.collect_params().keys() if "running" in n]
    losses, step_ms, start = [], [], None
    for i in range(RESNET_TRAIN_WARMUP + RESNET_TRAIN_STEPS):
        if i == RESNET_TRAIN_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if i == 0:
            with conv_flops() as forward_flop:
                loss = trainer.step(x, y)
            start = {n: trainer._params[n].clone() for n in running}
        else:
            loss = trainer.step(x, y)
        losses.append(float(loss.asscalar()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        if i == 0:
            print("resnet 6c: built, initialized and the first step in %.1f "
                  "s" % (time.perf_counter() - t0), flush=True)
    peak = torch.cuda.max_memory_allocated()
    timed = step_ms[RESNET_TRAIN_WARMUP:]
    mean = sum(timed) / len(timed)
    std = (sum((v - mean) ** 2 for v in timed) / len(timed)) ** 0.5
    flop = 3 * forward_flop[0]
    moved = max(float((trainer._params[n] - start[n]).abs().max())
                for n in running)
    finite = all(bool(torch.isfinite(trainer._params[n]).all())
                 for n in running)
    result = dict(step_ms=timed, step_ms_mean=mean, step_ms_std=std,
                  step_ms_min=min(timed), step_ms_max=max(timed),
                  img_per_s=RESNET_TRAIN_BATCH / mean * 1e3,
                  flop_per_step=flop, mfu=flop / (mean / 1e3) /
                  H100_BF16_FLOPS, floor_ms=flop / H100_BF16_FLOPS * 1e3,
                  peak_memory_bytes=peak, losses=losses,
                  running_stats_max_move=moved)
    for i, (ms, loss) in enumerate(zip(step_ms, losses)):
        print("resnet 6c: step %d%s: %.3f ms, loss %.6f | %s"
              % (i, " (warm-up)" if i < RESNET_TRAIN_WARMUP else "", ms, loss,
                 card))
    print("resnet 6c: resnet50_v1(classes=1000), DataParallelTrainer(sgd %s, "
          "dtype=bfloat16), batch %d x 3x%dx%d: %d timed steps, mean %.3f "
          "ms (std %.3f, %.3f-%.3f), %.1f img/s, MFU %.4f (%.4e conv and "
          "dense flop a step, 3x the forward's, over 989 TFLOP/s; floor "
          "%.3f ms), peak memory allocated %d bytes; running statistics "
          "moved by up to %.3e, finite %s | %s"
          % (RESNET_TRAIN_OPT, RESNET_TRAIN_BATCH, RESNET_IMAGE, RESNET_IMAGE,
             RESNET_TRAIN_STEPS, mean,
             std, min(timed), max(timed), result["img_per_s"], result["mfu"],
             flop, result["floor_ms"], peak, moved, finite, card),
          flush=True)
    check(all(math.isfinite(v) for v in losses), "6c: a loss is not finite: "
          "%s" % losses)
    check(losses[-1] < losses[0], "6c: the loss did not fall: %s" % losses)
    check(finite and moved > 0, "6c: running statistics moved %.3e, finite "
          "%s" % (moved, finite))
    result["profile"] = resnet_profile(
        lambda: trainer.step(x, y).asscalar(), "6c one training step", card)
    del trainer, net, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 7: the array surface (the ops of ops/math.py, ops/tensor.py and
# ops/init_ops.py ported in this slice) on the card against the port's CPU
# result, and checkpoints: ResNet-50 v1 trained, saved, resumed and served
# from its file.  No hand kernel on this path.
# ---------------------------------------------------------------------------
SWEEP_ROWS, SWEEP_COLS = 1024, 4096          # elementwise, broadcast, reduce
SWEEP_DOT = ((1024, 4096), (4096, 4096))
SWEEP_BATCH_DOT = ((32, 1024, 128), (32, 128, 1024))
# the families of the sweep, and every alias of each op (checked to resolve
# to the same Operator as its canonical name)
SWEEP_ALIASES = {
    "broadcast_mod": ("_mod",), "broadcast_power": ("_power", "_pow"),
    "broadcast_maximum": ("_maximum",), "broadcast_minimum": ("_minimum",),
    "broadcast_hypot": ("_hypot",),
    "broadcast_logical_and": ("_logical_and",),
    "broadcast_logical_or": ("_logical_or",),
    "broadcast_logical_xor": ("_logical_xor",),
    "add_n": ("ElementWiseSum", "elemwise_sum", "_sum"),
    "abs": ("_np_abs",), "negative": ("_np_negative",),
    "max": ("max_axis",), "min": ("min_axis",), "sum": ("sum_axis",),
    "broadcast_axis": ("broadcast_axes",), "swapaxes": ("SwapAxis",),
    "slice": ("crop",), "Concat": ("concat",), "SliceChannel": ("split",),
    "reverse": ("flip",), "Pad": ("pad",), "_copy": ("identity",),
    "BlockGrad": ("stop_gradient",), "make_loss": ("MakeLoss",),
    "_arange": ("arange",), "_eye": ("eye",), "_linspace": ("linspace",),
}
TRANSCENDENTAL = ("sqrt", "rsqrt", "cbrt", "rcbrt", "exp", "log", "log10",
                  "log2", "log1p", "expm1", "sin", "cos", "tan", "arcsin",
                  "arccos", "arctan", "sinh", "cosh", "tanh", "arcsinh",
                  "arccosh", "arctanh", "sigmoid", "erf", "gamma", "gammaln")
EXACT_UNARY = ("abs", "negative", "square", "degrees", "radians",
               "reciprocal", "relu", "softsign", "sign", "rint", "round",
               "ceil", "floor", "trunc", "fix", "logical_not")
DOMAIN = {"sqrt": "pos", "rsqrt": "pos", "log": "pos", "log10": "pos",
          "log2": "pos", "log1p": "pos", "gamma": "pos", "gammaln": "pos",
          "arcsin": "unit", "arccos": "unit", "arctanh": "unit",
          "tan": "unit", "arccosh": "gt1"}
# bounds, card against CPU (n ulps of the output's dtype, at each element
# or at the largest |CPU value| for values that cancel; 0: bit-equal).
# libdevice's and the CPU's transcendentals are each within 1-2 ulps of
# the exact value; a sum runs in another order (cuBLAS, CUDA's reduction
# trees); a 16-bit result is rounded once from f32 on both.  The inputs
# are seeded and both sides' libraries deterministic, so a case gives the
# same error on every run.  Each bound against the largest error of its key
# measured on an NVIDIA H100 80GB HBM3 at these inputs: f32 transcendental
# forwards 4 (rsqrt's: no room), their gradients 6 (sigmoid's 4),
# broadcast gradients 4 (2), pow and hypot 4 and 6 (3.5), sums 4 (3),
# products
# of 4096 factors 160 (nanprod's 108), products 48 (dot 35.5, batch_dot
# 17), gathers' sums 2 (1.5); 16-bit forwards 1 (1: no room), 16-bit
# gradients 2 (1).
SWEEP_ULP = {
    # key: ((f32 forward, f32 backward), (16-bit forward, 16-bit backward))
    "transcendental": (((4, "elem"), (6, "max")),
                       ((1, "elem"), (2, "max"))),
    # a broadcast operand's gradient is a sum over the broadcast rows
    "broadcast": (((0, "elem"), (4, "max")), ((0, "elem"), (2, "max"))),
    "broadcast_tx": (((4, "elem"), (6, "max")),
                     ((1, "elem"), (2, "max"))),
    "reduce": (((4, "max"), (4, "max")), ((1, "max"), (2, "max"))),
    "prod": (((160, "elem"), (160, "max")), ((1, "elem"), (2, "max"))),
    "product": (((48, "max"), (48, "max")), ((1, "max"), (2, "max"))),
    "scatter": (((0, "elem"), (2, "max")), ((0, "elem"), (2, "max"))),
}


def sweep_input(rng, kind, shape):
    """Seeded host inputs by domain (a ``np.random.Generator``), off exact
    zeros; only the draw the domain needs."""
    import numpy as np
    f32 = np.float32
    if kind in ("small", "int", "exp"):
        lo, hi = {"small": (0, 3), "int": (-9, 10), "exp": (0, 4)}[kind]
        return rng.integers(lo, hi, shape).astype(f32)
    if kind == "any":
        x = rng.standard_normal(shape, dtype=f32) * f32(2)
    else:
        lo, span = {"pos": (0.5, 2.5), "unit": (-0.9, 1.8),
                    "gt1": (1.1, 2.0), "near1": (0.7, 0.6)}[kind]
        x = f32(lo) + f32(span) * rng.random(shape, dtype=f32)
    x = np.asarray(x, f32)
    x[np.abs(x) < 1e-2] = f32(0.37)
    return x


def sweep_cases():
    """(family, op, params, input domains and shapes, dtypes, bound key or
    0, inputs with a gradient).  Shapes: (1024, 4096) for
    elementwise, broadcast and reduction ops, the products at their own."""
    R, C = SWEEP_ROWS, SWEEP_COLS
    full = ("any", (R, C))
    cases = []
    for name in TRANSCENDENTAL + EXACT_UNARY:
        diff = name not in ("sign", "rint", "round", "ceil", "floor",
                            "trunc", "fix", "logical_not")
        dts = ("float32", "bfloat16") + (
            ("int32",) if name in ("abs", "negative", "square", "relu",
                                   "sign", "round", "floor", "exp") else ())
        bound = "transcendental" if name in TRANSCENDENTAL else 0
        cases.append(("unary", name, {}, [(DOMAIN.get(name, "any"), (R, C))],
                      dts, bound, (0,) if diff else ()))
    cases += [
        ("unary", "clip", {"a_min": -0.7, "a_max": 1.1}, [full],
         ("float32", "bfloat16", "int32"), 0, (0,)),
        ("unary", "hard_sigmoid", {}, [full], ("float32", "bfloat16"), 0,
         (0,)),
        ("unary", "smooth_l1", {"scalar": 2.0}, [full],
         ("float32", "bfloat16"), 0, (0,)),
    ]
    for name, kinds, dts in (
            ("broadcast_mod", ("any", "pos"), ("float32", "bfloat16",
                                               "int32")),
            ("broadcast_power", ("pos", "any"), ("float32", "bfloat16")),
            ("broadcast_maximum", ("any", "any"), ("float32", "bfloat16",
                                                   "int32")),
            ("broadcast_minimum", ("any", "any"), ("float32", "int32")),
            ("broadcast_hypot", ("any", "any"), ("float32", "bfloat16")),
            ("broadcast_logical_and", ("small", "small"),
             ("float32", "int32")),
            ("broadcast_logical_or", ("small", "small"), ("float32",)),
            ("broadcast_logical_xor", ("small", "small"), ("float32",))):
        bound = "broadcast_tx" if name in ("broadcast_power",
                                           "broadcast_hypot") else \
            "broadcast"
        grads = (0, 1) if "logical" not in name else ()
        cases.append(("binary", name, {}, [(kinds[0], (R, C)),
                                           (kinds[1], (1, C))], dts, bound,
                      grads))
    cases.append(("binary", "add_n", {}, [full, full, full],
                  ("float32", "bfloat16", "int32"), 0, (0, 1, 2)))
    for name, s, kind, dts, bound in (
            ("_mod_scalar", 1.7, "any", ("float32", "int32"), 0),
            ("_rmod_scalar", 2.5, "pos", ("float32",), 0),
            ("_power_scalar", 2.5, "pos", ("float32", "bfloat16"),
             "transcendental"),
            ("_power_scalar", 3, "int", ("int32",), 0),
            ("_rpower_scalar", 1.5, "any", ("float32",), "transcendental"),
            ("_maximum_scalar", 0.3, "any", ("float32", "int32"), 0),
            ("_minimum_scalar", -0.3, "any", ("float32", "bfloat16"), 0),
            ("_hypot_scalar", 1.3, "any", ("float32",), "transcendental")):
        cases.append(("scalar", name, {"scalar": s}, [(kind, (R, C))], dts,
                      bound, (0,)))
    cases += [
        ("reduction", "prod", {"axis": 1}, [("near1", (R, C))],
         ("float32", "bfloat16"), "prod", (0,)),
        ("reduction", "nansum", {"axis": 0}, [full], ("float32", "int32"),
         "reduce", (0,)),
        ("reduction", "nanprod", {"axis": 1}, [("near1", (R, C))],
         ("float32",), "prod", (0,)),
        ("reduction", "max", {"axis": 1}, [full],
         ("float32", "bfloat16", "int32"), 0, (0,)),
        ("reduction", "min", {}, [full], ("float32",), 0, (0,)),
        ("reduction", "norm", {"axis": 1}, [full], ("float32", "bfloat16"),
         "reduce", (0,)),
        ("reduction", "square_sum", {"axis": 0}, [full], ("float32",),
         "reduce", (0,)),
        ("reduction", "L2Normalization", {}, [("any", (R // 4, 4, C))],
         ("float32",), "reduce", (0,)),
        ("product", "dot", {}, [("any", SWEEP_DOT[0]), ("any", SWEEP_DOT[1])],
         ("float32", "bfloat16"), "product", (0, 1)),
        ("product", "dot", {"transpose_b": True},
         [("int", (64, 256)), ("int", (128, 256))], ("int32",), 0, ()),
        ("product", "batch_dot", {}, [("any", SWEEP_BATCH_DOT[0]),
                                      ("any", SWEEP_BATCH_DOT[1])],
         ("float32", "bfloat16"), "product", (0, 1)),
        ("product", "batch_dot", {}, [("int", (4, 32, 64)),
                                      ("int", (4, 64, 16))], ("int32",), 0,
         ()),
        ("product", "khatri_rao", {}, [("any", (64, C)), ("any", (16, C))],
         ("float32",), "product", (0, 1)),
        ("index", "argmin", {"axis": 1}, [full], ("float32", "int32"), 0,
         ()),
        ("index", "argmax_channel", {}, [full], ("float32",), 0, ()),
        ("index", "take", {"axis": 0, "mode": "clip"},
         [full, ("idx", (64, 32))], ("float32", "bfloat16", "int32"),
         "scatter", (0,)),
        ("index", "take", {"axis": 1, "mode": "wrap"},
         [full, ("idx", (2048,))], ("float32",), "scatter", (0,)),
        ("index", "one_hot", {"depth": 1000}, [("idx", (4096,))],
         ("float32",), 0, ()),
        ("index", "gather_nd", {}, [full, ("idx2", (2, 8192))],
         ("float32", "int32"), "scatter", (0,)),
        ("index", "scatter_nd", {"shape": (R, C)},
         [("any", (8192,)), ("idx2", (2, 8192))], ("float32",), "scatter",
         (0,)),
        ("index", "where", {}, [("small", (R, C)), full, full],
         ("float32", "int32"), 0, (1, 2)),
        ("shape", "squeeze", {"axis": 1}, [("any", (R, 1, C))],
         ("float32", "int32"), 0, (0,)),
        ("shape", "swapaxes", {"dim1": 0, "dim2": 1}, [full],
         ("float32", "bfloat16"), 0, (0,)),
        ("shape", "slice", {"begin": (1, None), "end": (None, -3),
                            "step": (2, -3)}, [full], ("float32", "int32"),
         0, (0,)),
        ("shape", "slice_like", {}, [full, ("any", (R // 2, C // 4))],
         ("float32",), 0, (0,)),
        ("shape", "Concat", {"dim": 0}, [full, full], ("float32", "int32"),
         0, (0, 1)),
        ("shape", "stack", {"axis": 1}, [full, full], ("float32",), 0,
         (0, 1)),
        ("shape", "SliceChannel", {"num_outputs": 4, "axis": 1}, [full],
         ("float32", "int32"), 0, (0,)),
        ("shape", "repeat", {"repeats": 2, "axis": 0}, [full],
         ("float32",), 0, (0,)),
        ("shape", "tile", {"reps": (2, 1)}, [full], ("float32",), 0, (0,)),
        ("shape", "reverse", {"axis": (0, 1)}, [full], ("float32", "int32"),
         0, (0,)),
        ("shape", "Pad", {"mode": "reflect",
                          "pad_width": (0, 0, 0, 0, 3, 2, 1, 4)},
         [("any", (16, 64, 32, 32))], ("float32",), "scatter", (0,)),
        ("shape", "Pad", {"mode": "edge",
                          "pad_width": (0, 0, 0, 0, 2, 2, 2, 2)},
         [("any", (16, 64, 32, 32))], ("bfloat16",), 0, ()),
        ("shape", "Pad", {"mode": "constant", "constant_value": 1.5,
                          "pad_width": (0, 0, 1, 1, 2, 2, 0, 3)},
         [("any", (16, 64, 32, 32))], ("float32", "int32"), 0, (0,)),
        ("shape", "space_to_depth", {"block_size": 2},
         [("any", (16, 64, 32, 32))], ("float32",), 0, (0,)),
        ("shape", "depth_to_space", {"block_size": 2},
         [("any", (16, 64, 32, 32))], ("float32",), 0, (0,)),
        ("shape", "broadcast_to", {"shape": (R, C)}, [("any", (1, C))],
         ("float32", "int32"), "reduce", (0,)),
        ("shape", "broadcast_axis", {"axis": 1, "size": C},
         [("any", (R, 1))], ("float32",), "reduce", (0,)),
        ("shape", "_copy", {}, [full], ("float32", "int32"), 0, (0,)),
        ("shape", "BlockGrad", {}, [full], ("float32",), 0, ()),
        ("shape", "make_loss", {"grad_scale": 0.25}, [full], ("float32",),
         0, (0,)),
        ("shape", "_grad_add", {}, [full, full], ("float32",), 0, (0, 1)),
        ("ordering", "topk", {"k": 8}, [("perm", (R, C))],
         ("float32", "bfloat16", "int32"), 0, ()),
        ("ordering", "topk", {"k": 5, "ret_typ": "both", "is_ascend": True},
         [("small", (R, C))], ("float32", "int32"), 0, ()),
        ("ordering", "topk", {"k": 3, "ret_typ": "mask", "axis": 0},
         [("perm", (R, C))], ("float32",), 0, ()),
        ("ordering", "sort", {}, [("perm", (R, C))], ("float32", "int32"),
         0, ()),
        ("ordering", "sort", {"is_ascend": False}, [("small", (R, C))],
         ("bfloat16",), 0, ()),
        ("ordering", "argsort", {}, [("perm", (R, C))], ("float32",), 0,
         ()),
        ("ordering", "argsort", {"is_ascend": False}, [("small", (R, C))],
         ("float32", "int32"), 0, ()),
        ("sequence", "SequenceLast", {"use_sequence_length": True},
         [full, ("len", (C,))], ("float32",), 0, (0,)),
        ("sequence", "SequenceMask", {"use_sequence_length": True,
                                      "value": -1.0},
         [full, ("len", (C,))], ("float32", "int32"), 0, (0,)),
        ("sequence", "SequenceReverse", {"use_sequence_length": True},
         [full, ("len", (C,))], ("float32",), 0, (0,)),
    ]
    return cases


def _sweep_arrays(rs, specs, dtype):
    """The host inputs of one case: values by domain in ``dtype`` (int32
    values for an int32 case), index arrays as int32, permutations for the
    orderings (bf16 rounds some to ties, which the stable sorts order
    alike on both sides), sequence lengths in [0, rows]."""
    import numpy as np
    out = []
    for kind, shape in specs:
        if kind == "perm":      # distinct but where bf16 rounds them
            a = rs.permutation(int(np.prod(shape))).reshape(shape)
            a = (a.astype(np.float64) - a.size / 2).astype(np.float32)
        elif kind == "idx":
            a = rs.integers(-8, SWEEP_ROWS + 8, shape).astype(np.int32)
        elif kind == "idx2":
            a = np.stack([rs.integers(0, SWEEP_ROWS, shape[1:]),
                          rs.integers(0, SWEEP_COLS, shape[1:])]).astype(
                np.int32)
        elif kind == "len":
            a = rs.integers(0, SWEEP_ROWS + 1, shape).astype(np.int32)
        else:
            a = sweep_input(rs, kind, shape)
            if dtype == "int32":
                a = np.round(a).astype(np.int32)
        out.append(a)
    return out


def _ulp_err(got, want, measure):
    """max |got - want| in ulps of ``want``'s dtype, at each element's
    |want| (``elem``) or at max |want| (``max``), computed in float64 on
    ``got``'s device; inf when NaN or inf do not match."""
    import torch
    mant = {torch.float32: 23, torch.bfloat16: 7, torch.float16: 10}[
        want.dtype]
    g = got.detach().to(torch.float64)
    w = want.detach().to(device=g.device, dtype=torch.float64)
    if g.shape != w.shape or not torch.equal(torch.isnan(g), torch.isnan(w)):
        return math.inf
    fin = torch.isfinite(w)
    odd = ~fin & ~torch.isnan(w)
    if not torch.equal(g[odd], w[odd]):
        return math.inf
    err = torch.where(fin, (g - w).abs(), torch.zeros_like(w))
    ref = w.abs() if measure == "elem" else w.abs().max()
    e = torch.floor(torch.log2(torch.clamp(ref, min=2.0 ** -126)))
    return float((err / torch.exp2(e - mant)).max()) if err.numel() \
        else 0.0


def _sweep_run(mx, op, arrays, params, dtype, ctx, heads_host, grads):
    """One case through the port on ``ctx``: the outputs and the gradients
    (as tensors) for seeded head gradients.  Inputs and heads are placed
    on ``ctx`` outside the op's call and its backward, which on the card
    run under torch's sync-debug mode "error": an op that waited for the
    card would raise.  ``heads_host`` caches the head gradients' host
    values by shape, so both runs of a case use the same."""
    import numpy as np
    import torch
    xs = [mx.nd.array(a, ctx=ctx, dtype=dtype if a.dtype.kind == "f"
                      else "int32") for a in arrays]
    with card_calls(ctx, torch):
        for i in grads:
            xs[i].attach_grad()
        with mx.autograd.record():
            out = mx.nd.invoke(op, xs, dict(params))
    outs = out if isinstance(out, list) else [out]
    if grads:
        rng = np.random.default_rng(SEED)
        heads = [mx.nd.NDArray(torch.from_numpy(heads_host.setdefault(
            o.shape, np.array(sweep_input(rng, "any", o.shape)))).to(
                o._data.device, o._data.dtype)) for o in outs]
        with card_calls(ctx, torch):
            mx.autograd.backward(outs, heads)
    return ([o._data for o in outs],
            [xs[i].grad._data for i in grads])


@contextlib.contextmanager
def sync_debug_error(torch):
    """torch's sync-debug mode "error" inside: a call that synchronizes
    with the card (an ``.item()``, a host copy) raises."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def card_calls(ctx, torch):
    """Around calls on ``ctx``: on the card, sync-debug mode "error" after
    a synchronize (so only the calls inside can trip it); on the CPU,
    nothing."""
    if ctx.device_type != "gpu":
        return contextlib.nullcontext()
    torch.cuda.synchronize()
    return sync_debug_error(torch)


def sweep_case(mx, case, dtype, rs):
    """One case of the sweep in ``dtype``: the op on the card against the
    CPU, forward and backward, each at its bound (failing the run past
    it).  Returns the largest error in ulps and the case's bound."""
    import torch
    from incubator_mxnet_tpu_torch.ops.registry import get_op
    family, name, params, specs, _, bound, grads = case
    op = get_op(name)
    arrays = _sweep_arrays(rs, specs, dtype)
    g = () if dtype == "int32" else grads
    heads = {}
    want = _sweep_run(mx, op, arrays, params, dtype, mx.cpu(), heads, g)
    got = _sweep_run(mx, op, arrays, params, dtype, mx.gpu(0), heads, g)
    fb, bb = SWEEP_ULP[bound][dtype != "float32"] if bound else (
        (0, "elem"), (0, "elem"))
    worst = 0.0
    for part, (gl, wl, (n, measure)) in enumerate(
            ((got[0], want[0], fb), (got[1], want[1], bb))):
        for gt, wt in zip(gl, wl):
            check(gt.dtype == wt.dtype and gt.shape == wt.shape,
                  "7a: %s %s %s: %s %s on the card, %s %s on the CPU"
                  % (name, params, dtype, gt.dtype, gt.shape, wt.dtype,
                     wt.shape))
            if n == 0 or not wt.is_floating_point():
                same = torch.equal(gt, wt.to(gt.device)) or (
                    wt.is_floating_point() and bool(torch.equal(
                        torch.isnan(gt), torch.isnan(wt.to(gt.device)))
                        and torch.equal(torch.nan_to_num(gt),
                                        torch.nan_to_num(wt.to(gt.device)))))
                err = 0.0 if same else math.inf
            else:
                err = _ulp_err(gt, wt, measure)
            check(err <= n, "7a: %s %s %s: %s %.3g ulp above %d"
                  % (name, params, dtype, "gradient" if part else "forward",
                     err, n))
            worst = max(worst, err)
    return worst, max(fb[0], bb[0] if g else 0)


def array_sweep(mx, card):
    """Phase 7a: every op this slice ports, on CUDA tensors against the
    port's CPU result for the same numpy inputs, forward and backward, each
    case at its stated bound; the aliases resolve to one Operator; integer
    mod and power at their edge values; the creation ops.  One line per
    family: cases, ops, the largest error and its bound."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch.ops.registry import get_op
    t0 = time.perf_counter()
    for name, aliases in SWEEP_ALIASES.items():
        for a in aliases:
            check(get_op(a) is get_op(name), "7a: alias %s is not %s's "
                  "Operator" % (a, name))
    gpu, cpu = mx.gpu(0), mx.cpu()
    families = {}
    rs = np.random.default_rng(SEED)
    for case in sweep_cases():
        family, name = case[0], case[1]
        for dtype in case[4]:
            worst, bound = sweep_case(mx, case, dtype, rs)
            fam = families.setdefault(family, dict(cases=0, ops=set(),
                                                   max_ulp=0.0, bound=0,
                                                   worst_case=None))
            fam["cases"] += 1
            fam["ops"].add(name)
            if worst > fam["max_ulp"]:
                fam["max_ulp"], fam["worst_case"] = worst, "%s %s" % (
                    name, dtype)
            fam["bound"] = max(fam["bound"], bound)
    families["integer edges"] = integer_edges(mx, gpu, cpu, np, torch)
    families["creation"] = creation_sweep(mx, gpu, cpu, np)
    for family, fam in families.items():
        print("sweep %s: %d cases of %d ops (%s), max error %.3g ulp (%s), "
              "bound %d ulp | %s" % (family, fam["cases"], len(fam["ops"]),
                                     " ".join(sorted(fam["ops"])),
                                     fam["max_ulp"], fam.get("worst_case"),
                                     fam["bound"], card), flush=True)
    seconds = time.perf_counter() - t0
    print("sweep: %d cases in %.1f s" % (sum(f["cases"] for f in
                                              families.values()), seconds),
          flush=True)
    return {f: dict(v, ops=sorted(v["ops"])) for f, v in families.items()}


def integer_edges(mx, gpu, cpu, np, torch):
    """int32 mod by 0 and -1 (INT_MIN too) and powers with negative and
    large exponents: on the card, under sync-debug mode "error", equal to
    the CPU (the JAX build's values, tests/test_torch_ops_math.py)."""
    lhs = np.array([5, -5, 7, 0, -2 ** 31, 3, -7, 2 ** 31 - 1] * 512,
                   np.int32)
    cases = [("broadcast_mod", np.array([0, 0, -1, 0, -1, 0, 2, -3] * 512,
                                        np.int32)),
             ("broadcast_power", np.array([-1, -1, -1, -1, -2, 70, 31, -64]
                                          * 512, np.int32))]
    from incubator_mxnet_tpu_torch.ops.registry import get_op
    for name, rhs in cases:
        want = _sweep_run(mx, get_op(name), [lhs, rhs], {}, "int32", cpu,
                          {}, ())[0][0]
        got = _sweep_run(mx, get_op(name), [lhs, rhs], {}, "int32", gpu,
                         {}, ())[0][0]
        check(torch.equal(got.cpu(), want), "7a: int32 %s edge values "
              "differ on the card" % name)
    return dict(cases=2, ops={"broadcast_mod", "broadcast_power"},
                max_ulp=0.0, bound=0)


def creation_sweep(mx, gpu, cpu, np):
    """The creation ops on the card against the CPU, bit-equal (outside
    sync-debug mode: arange copies numpy's values to the card)."""
    cases = [("arange", dict(start=0.5, stop=4000.0, step=0.3, repeat=2)),
             ("arange", dict(start=-3, stop=10 ** 6, step=7,
                             dtype="int32")),
             ("eye", dict(N=SWEEP_ROWS, M=SWEEP_COLS, k=5)),
             ("linspace", dict(start=-2.5, stop=3.1, num=SWEEP_COLS)),
             ("linspace", dict(start=0.0, stop=1.0, num=777,
                               endpoint=False, dtype="bfloat16"))]
    for name, params in cases:
        a = getattr(mx.nd, name)(ctx=gpu, **params)
        b = getattr(mx.nd, name)(ctx=cpu, **params)
        check(a.context == gpu and np.array_equal(a.asnumpy(), b.asnumpy()),
              "7a: %s %s differs on the card" % (name, params))
    x = mx.nd.array(np.zeros((SWEEP_ROWS, SWEEP_COLS), np.float32), ctx=gpu)
    for name in ("ones_like", "shape_array", "size_array"):
        a, b = getattr(mx.nd, name)(x), getattr(mx.nd, name)(x.copyto(cpu))
        check(np.array_equal(a.asnumpy(), b.asnumpy()), "7a: %s differs on "
              "the card" % name)
    return dict(cases=len(cases) + 3,
                ops={"_arange", "_eye", "_linspace", "ones_like",
                     "shape_array", "size_array"}, max_ulp=0.0, bound=0)


# 7b: ResNet-50 v1 through the plain Gluon loop at
# example/image-classification/train_imagenet.py's optimizer (sgd, lr 0.1,
# momentum 0.9, wd 1e-4, MultiFactorScheduler), the schedule's steps cut to
# [2, 4] so the rate falls before and after the checkpoint at step 3
CKPT_BATCH, CKPT_SERVE_BATCH = 64, 32
CKPT_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
CKPT_SCHEDULE = dict(step=[2, 4], factor=0.1)
CKPT_SAVE_AT, CKPT_STEPS = 3, 6
# steps 5-6 of the resumed run against the uninterrupted one: cuDNN's
# backward (wgrad) and the loss's scatter may add in another order, ~1e-7
# relative a step, which the next step's forward carries on (this net's
# gradients move by percents for a one-ulp change of its input).  The
# weights are compared by their relative L2 distance over the whole net,
# and each tensor by its own where its RMS is at least CKPT_LIVE_RMS of the
# net's (a convolution's bias before BatchNorm starts at 0 and takes only
# rounding for a gradient, so it has no scale of its own).  Measured on an
# NVIDIA H100 80GB HBM3: losses 9.2e-7 to 5.3e-6 apart over six runs,
# weights 6.6e-6 to 7.3e-6, each checked tensor 1.14e-4 to 1.20e-4 (a
# BatchNorm beta) over three; the bounds leave ~10x.  The 32 convolution
# biases sit below 1.1e-6 of the net's RMS, every other tensor above 5e-3
CKPT_LOSS_REL, CKPT_WEIGHT_REL = 5e-5, 1e-4
CKPT_LIVE_RMS, CKPT_TENSOR_REL = 1e-3, 1e-3


def _ckpt_state(net, trainer):
    """Every parameter (running statistics too) and momentum, on the host,
    and the update count."""
    params = {n[len(net.prefix):]: p.data().asnumpy()
              for n, p in net.collect_params().items()}
    moms = {i: (s.asnumpy() if hasattr(s, "asnumpy") else s)
            for i, s in trainer._updaters[0].states.items()}
    return params, moms, trainer._optimizer.num_update


def checkpoint_cycle(mx, card):
    """Phase 7b: ResNet-50 v1 (classes=1000, f32, on the card) trained by
    autograd.record / SoftmaxCrossEntropyLoss / backward /
    gluon.Trainer.step(64) under a MultiFactorScheduler: run A takes 3
    steps, saves (save_params, save_states), takes steps 4-6; run B, a net
    of another seed with a fresh Trainer, loads both and takes steps 4-6;
    then a third net serves A's file from its bytes (nd.load_buffer,
    serving.loader.load_params_bytes)."""
    import tempfile
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch.serving.loader import load_params_bytes
    gpu = mx.gpu(0)
    rs = np.random.RandomState(0)
    x = mx.nd.array(rs.rand(CKPT_BATCH, 3, RESNET_IMAGE, RESNET_IMAGE)
                    .astype(np.float32), ctx=gpu)
    y = mx.nd.array(rs.randint(0, 1000, CKPT_BATCH).astype(np.float32),
                    ctx=gpu)
    serve_x = mx.nd.array(rs.rand(CKPT_SERVE_BATCH, 3, RESNET_IMAGE,
                                  RESNET_IMAGE).astype(np.float32), ctx=gpu)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def trainer_of(net):
        sched = mx.lr_scheduler.MultiFactorScheduler(**CKPT_SCHEDULE)
        return mx.gluon.Trainer(net.collect_params(), "sgd",
                                dict(CKPT_OPT, lr_scheduler=sched))

    def step(net, trainer):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(CKPT_BATCH)
        out = loss.asnumpy()
        return out, (time.perf_counter() - t1) * 1e3, \
            trainer._optimizer._get_lr(0)

    def logits(net):
        with mx.autograd.predict_mode():
            return net(serve_x).asnumpy()

    def timed(fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t1

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        p, s = os.path.join(tmp, "resnet50.params"), \
            os.path.join(tmp, "resnet50.states")
        net = _resnet_full(mx, np, SEED)
        trainer = trainer_of(net)
        run_a = [step(net, trainer) for _ in range(CKPT_SAVE_AT)]
        sec = dict(save_params=timed(lambda: net.save_params(p)),
                   save_states=timed(lambda: trainer.save_states(s)))
        saved = _ckpt_state(net, trainer)
        served_a = logits(net)
        run_a += [step(net, trainer) for _ in range(CKPT_SAVE_AT,
                                                    CKPT_STEPS)]
        end_a = _ckpt_state(net, trainer)
        del net, trainer
        gc.collect()
        net = _resnet_full(mx, np, SEED + 1)
        trainer = trainer_of(net)
        sec["load_params"] = timed(lambda: net.load_params(p, ctx=gpu))
        sec["load_states"] = timed(lambda: trainer.load_states(s))
        loaded = _ckpt_state(net, trainer)
        run_b = [step(net, trainer) for _ in range(CKPT_SAVE_AT,
                                                   CKPT_STEPS)]
        end_b = _ckpt_state(net, trainer)
        del net, trainer
        gc.collect()
        buf = open(p, "rb").read()
        sec["load_buffer"] = timed(lambda: mx.nd.load_buffer(buf))
        args, aux = load_params_bytes(buf)
        served = _resnet_full(mx, np, SEED + 2)
        served.collect_params().setattr("grad_req", "null")
        for name, prm in served.collect_params().items():
            short = name[len(served.prefix):]
            prm.set_data(args[short] if short in args else aux[short])
        served_c = logits(served)
        sizes = dict(params_bytes=os.path.getsize(p),
                     states_bytes=os.path.getsize(s))
        del served, args, aux
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    same = all(np.array_equal(saved[0][k], loaded[0][k]) for k in saved[0])
    same_mom = sorted(saved[1]) == sorted(loaded[1]) and all(
        np.array_equal(saved[1][i], loaded[1][i]) for i in saved[1])
    loss_a = [float(l_.mean()) for l_, _, _ in run_a]
    loss_b = [float(l_.mean()) for l_, _, _ in run_b]
    lrs_a = [lr for _, _, lr in run_a[CKPT_SAVE_AT:]]
    lrs_b = [lr for _, _, lr in run_b]
    step4 = bool(np.array_equal(run_a[CKPT_SAVE_AT][0], run_b[0][0]))
    loss_rel = max(abs(a - b) / abs(a) for a, b in
                   zip(loss_a[CKPT_SAVE_AT:], loss_b))
    diff2 = {k: float(np.square(end_a[0][k].astype(np.float64)
                                - end_b[0][k]).sum()) for k in end_a[0]}
    norm2 = {k: float(np.square(end_a[0][k].astype(np.float64)).sum())
             for k in end_a[0]}
    weight_rel = math.sqrt(sum(diff2.values()) / sum(norm2.values()))
    net_ms = sum(norm2.values()) / sum(v.size for v in end_a[0].values())
    rms = {k: math.sqrt(norm2[k] / end_a[0][k].size / net_ms)
           for k in end_a[0]}
    live = [k for k in end_a[0] if rms[k] >= CKPT_LIVE_RMS]
    gap = (max([rms[k] for k in rms if k not in live], default=0.0),
           min(rms[k] for k in live))
    worst = max(live, key=lambda k: diff2[k] / norm2[k])
    worst_rel = math.sqrt(diff2[worst] / norm2[worst])
    served_equal = bool(np.array_equal(served_a, served_c))
    result = dict(step_ms=[ms for _, ms, _ in run_a], losses_a=loss_a,
                  losses_b=loss_b, lrs_a=lrs_a, lrs_b=lrs_b,
                  step4_loss_bit_equal=step4, loss_rel_steps_5_6=loss_rel,
                  weight_rel_l2_after_6=weight_rel,
                  worst_tensor=(worst, worst_rel),
                  tensors_checked=(len(live), len(end_a[0])),
                  rms_gap=gap,
                  state_bit_equal=same,
                  momentum_bit_equal=same_mom,
                  num_update=(saved[2], loaded[2]),
                  served_logits_bit_equal=served_equal, seconds=sec, **sizes)
    for i, (l_, ms, lr) in enumerate(run_a):
        print("ckpt 7b: run A step %d: %.3f ms, loss %.6f, lr %g | %s"
              % (i + 1, ms, float(l_.mean()), lr, card), flush=True)
    print("ckpt 7b: files %d bytes (.params) and %d bytes (.states); "
          "seconds: %s | %s" % (sizes["params_bytes"], sizes["states_bytes"],
                                json.dumps({k: round(v, 4) for k, v in
                                            sec.items()}), card), flush=True)
    print("ckpt 7b: resumed run B: losses %s (A %s), lr %s (A %s), step-4 "
          "loss bit-equal %s, steps 5-6 loss rel %.3e (bound %g), weights "
          "after step 6 rel L2 %.3e (bound %g), each of %d of %d tensors "
          "(RMS at least %g of the net's; the others below %.3g, these "
          "above %.3g) within %.3e (%s; bound %g); state "
          "bit-equal after load %s, momentum %s, num_update %s; served "
          "logits from the file's bytes bit-equal %s"
          % (loss_b, loss_a[CKPT_SAVE_AT:], lrs_b, lrs_a, step4, loss_rel,
             CKPT_LOSS_REL, weight_rel, CKPT_WEIGHT_REL, len(live),
             len(end_a[0]), CKPT_LIVE_RMS, gap[0], gap[1], worst_rel, worst,
             CKPT_TENSOR_REL, same, same_mom, result["num_update"],
             served_equal),
          flush=True)
    check(all(math.isfinite(v) for v in loss_a + loss_b),
          "7b: a loss is not finite")
    check(same and same_mom, "7b: the state after load differs from A's at "
          "the save (parameters %s, momentum %s)" % (same, same_mom))
    check(saved[2] == loaded[2] and lrs_a == lrs_b, "7b: num_update %s or "
          "the resumed learning rates %s differ from A's %s"
          % (result["num_update"], lrs_b, lrs_a))
    check(lrs_a == [CKPT_OPT["learning_rate"] * 0.1 ** k for k in
                    (1, 2, 2)], "7b: the schedule gave %s" % lrs_a)
    check(step4, "7b: B's step-4 loss is not bit-equal to A's")
    check(loss_rel <= CKPT_LOSS_REL and weight_rel <= CKPT_WEIGHT_REL,
          "7b: steps 5-6 drifted: loss %.3e, weights %.3e" % (loss_rel,
                                                              weight_rel))
    check(worst_rel <= CKPT_TENSOR_REL, "7b: tensor %s drifted %.3e after "
          "step 6" % (worst, worst_rel))
    check(served_equal, "7b: logits served from the file's bytes differ")
    return result


# ---------------------------------------------------------------------------
# phase 8: the rest of the op library (the nn ops, random ops, update ops
# and optimizers, losses, initializers and linalg of this slice) and the
# rest of the vision zoo, served and trained.  No hand kernel on this
# path: the ops are PyTorch calls, as the JAX build's are jnp/lax outside
# any Pallas kernel.
# ---------------------------------------------------------------------------
# 8a: each new family on the card against the CPU, f32, TF32 off, the same
# seeded weights, batch 2 at full resolution.  Relative L2 of the logits:
# the same f32 operations summed in other orders (cuDNN's convolutions and
# cuBLAS's products against the CPU's), ~1e-7 an op through 8 to 121
# layers; a TF32 product (10-bit mantissa) would break it
ZOO_BATCH = 2
ZOO_FAMILIES = (("alexnet", 224), ("vgg11", 224), ("vgg11_bn", 224),
                ("squeezenet1_0", 224), ("squeezenet1_1", 224),
                ("densenet121", 224), ("mobilenet0_25", 224),
                ("inception_v3", 299))
ZOO_REL = 1e-4
# 8b: BASELINE.md:13-16's inference batch, bf16; the bf16 logits against
# the f32 net's (relative L2)
ZOO_SERVE = (("alexnet", 224), ("vgg16", 224), ("inception_v3", 299))
ZOO_SERVE_BATCH, ZOO_SERVE_BATCHES = 32, 4
ZOO_BF16_REL = 2e-2
# the reference's published inference img/s at batch 32 (BASELINE.md; no
# bar here: other cards, cuDNN 5.1)
ZOO_PUBLISHED = {"alexnet": "1443.90 img/s on a K80, 4883.77 on a P100 "
                            "(BASELINE.md:13, :21)",
                 "vgg16": "228.96 img/s on a K80 (BASELINE.md:14)",
                 "inception_v3": "106.43 img/s on a K80 (BASELINE.md:16)"}
SERVER_REQUESTS, SERVER_CLIENTS, SERVER_MAX_BATCH = 16, 2, 8
# 8c: BASELINE.md:27's AlexNet training batch (483.37 img/s on a K80)
ALEXNET_TRAIN_BATCH, ALEXNET_WARMUP, ALEXNET_STEPS = 256, 3, 5
ALEXNET_OPT = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
# every other optimizer of this slice, 2 steps each from one saved state
OTHER_OPTIMIZERS = (
    ("adagrad", {"learning_rate": 1e-4}),
    ("adadelta", {}),
    ("rmsprop", {"learning_rate": 1e-4}),
    ("rmsprop", {"learning_rate": 1e-4, "centered": True}),
    ("ftrl", {"learning_rate": 0.01}),
    ("ftml", {"learning_rate": 1e-4}),
    ("signum", {"learning_rate": 1e-4, "momentum": 0.9}),
    ("sgld", {"learning_rate": 1e-6}),
    ("dcasgd", {"learning_rate": 0.01, "momentum": 0.9}),
    ("lbsgd", {"learning_rate": 0.01, "momentum": 0.9, "batch_scale": 2}),
    ("test", {}),
)
ZOO_OP_SPANS = ("Convolution", "FullyConnected", "Pooling", "Dropout",
                "Activation", "BatchNorm", "Concat", "nag_mom_update")
ZOO_GROUPS = (
    ("conv_layout_transpose", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("conv_fwd", ("op:Convolution",)),
    ("conv_dgrad_wgrad", ("_ConvolutionFunctionBackward",)),
    ("dense", ("op:FullyConnected", "MmBackward", "AddmmBackward",
               "TBackward")),
    ("pooling", ("op:Pooling", "MaxPool2DWithIndicesBackward",
                 "AvgPool2DBackward", "ConstantPadNdBackward")),
    ("dropout", ("op:Dropout", "WhereBackward", "DivBackward")),
    ("relu", ("op:Activation", "ReluBackward", "ThresholdBackward")),
    ("batchnorm", ("op:BatchNorm", "_BatchNormTrainFunction")),
    ("concat", ("op:Concat", "CatBackward")),
    ("optimizer_update", ("op:nag_mom_update",)),
)
# 8d: the op library on CUDA tensors against the port's CPU result.  Shapes:
# AlexNet's first activation (batch 8) and Inception's 35x35, 17x17 and
# 8x8 ones (batch 4); fc6's weight for the updates; (256, 1000) losses;
# 64 stacked 256x256 matrices; fft at (256, 4096)
OPLIB_SHAPES = {"alexnet_c1": (8, 64, 55, 55), "inc_35": (4, 192, 35, 35),
                "inc_17": (4, 768, 17, 17), "inc_8": (4, 2048, 8, 8)}
FC6 = (4096, 9216)
LOSS_SHAPE = (256, 1000)
LINALG_STACK, LINALG_N = 64, 256
FFT_SHAPE = (256, 4096)
# bounds (n ulps; as SWEEP_ULP's keys): the normalizations, LRN and the
# softmaxes sum a window or a row in another order on the card
# (reductions of 9 to 3025 values), the rest are one IEEE step or a
# library call both sides round once (a grouped deconvolution's sums)
SWEEP_ULP["nn"] = (((8, "max"), (16, "max")), ((1, "max"), (2, "max")))
# the update ops: elementwise f32 steps on both sides, in ulps at each
# output's largest value (the new weight w - u cancels where u ~ w, so a
# one-ulp difference of u is thousands of ulps of a tiny result: call 1 of
# PR 14 measured up to 2.6e5 ulps element by element)
UPDATE_ULP = 4
# 8d's bf16 weights through multi_precision: every optimizer but SGLD
# (random) at the rates and options of tests/test_torch_optimizer.py's
# OPTIMIZERS, which are not 8c's training rates: two steps of an fc6-shaped
# weight (0.01·N(0, 1)) on an fc6-shaped gradient (MP_GRAD·N(0, 1))
MP_OPTIMIZERS = (
    ("nag", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("adagrad", dict(learning_rate=0.1, wd=0.01, clip_gradient=1.5)),
    ("adadelta", dict(rho=0.8, epsilon=1e-4, wd=0.01)),
    ("rmsprop", dict(learning_rate=0.01, gamma1=0.8, clip_weights=2.0)),
    ("rmsprop", dict(learning_rate=0.01, centered=True, epsilon=1e-4)),
    ("ftrl", dict(learning_rate=0.1, lamda1=0.02, wd=0.01)),
    ("ftml", dict(learning_rate=0.01, wd=0.01)),
    ("signum", dict(learning_rate=0.05, momentum=0.8, wd_lh=0.01)),
    ("dcasgd", dict(learning_rate=0.1, momentum=0.9, lamda=0.1, wd=0.01)),
    ("lbsgd", dict(learning_rate=0.1, momentum=0.9, batch_scale=4,
                   warmup_epochs=1, updates_per_epoch=3)),
    ("test", {}),
)
MP_GRAD = 0.1
# the card's bf16 weights within MP_ULP bf16 ulps of the CPU's at the
# largest weight; the CPU's two steps move the largest-moved weight by at
# least MP_MOVE_ULP such ulps, so an update the card skipped or got wrong
# by more than an eighth of its size fails the bound
MP_ULP, MP_MOVE_ULP = 1, 8
# a loss: a row's log-softmax or a mean over 1000 values in another order
LOSS_REL = 1e-5
# linalg card vs CPU (cuSOLVER, cuBLAS, cuFFT against LAPACK, MKL or
# pocketfft): each output within 1e-4 of its largest value
LINALG_REL = 1e-4
# syevd's eigenvectors, card against CPU up to a sign per row: a vector
# moves by ~n·u·|A|/gap (n = 256, u = 6e-8, gaps of |A|/256) ~ 4e-3 of its
# unit norm, whichever solver runs; call 2 of PR 14 measured 1.5e-3
SYEVD_VECTOR_REL = 1e-2
# 8e: 2^24 draws a sampler; KS at p = 1e-6 and chi-square at p = 1e-6
RANDOM_N = 1 << 24
RANDOM_P = 1e-6


def _zoo_weights(mx, np, name, size, classes, rs):
    """A zoo net on the CPU with seeded weights (the port's Xavier draws
    after ``mx.random.seed``, BatchNorm's gamma, beta and running
    statistics drawn away from their init): the weights by name."""
    from incubator_mxnet_tpu_torch.convert import numpy_params
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    mx.random.seed(SEED)
    with mx.cpu():
        net = getattr(vision, name)(classes=classes)
        net.initialize(mx.init.Xavier())
        with mx.autograd.predict_mode():
            net(mx.nd.array(np.zeros((1, 3, size, size), np.float32)))
        weights = numpy_params(net)
    for n, v in weights.items():
        if n.endswith("gamma") or n.endswith("running_var"):
            weights[n] = rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif n.endswith("beta") or n.endswith("running_mean"):
            weights[n] = (0.1 * rs.standard_normal(v.shape)).astype(
                np.float32)
    return weights


def _zoo_net(mx, name, weights, ctx, classes):
    from incubator_mxnet_tpu_torch.convert import load_numpy_params
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    net = getattr(vision, name)(classes=classes)
    load_numpy_params(net, weights, ctx)
    return net


def _rel_l2(np, got, want):
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) /
                 max(np.linalg.norm(np.asarray(want, np.float64)), 1e-30))


def zoo_parity(mx, card):
    """Phase 8a: each family on the card against the CPU from the same
    seeded f32 weights, inference mode, batch ZOO_BATCH at full resolution,
    TF32 off; then AlexNet's training-mode forward on the card, whose two
    dropout masks follow ``mx.random.seed``."""
    import numpy as np
    import torch
    rs = np.random.RandomState(SEED + 8)
    out = {}
    t0 = time.perf_counter()
    for name, size in ZOO_FAMILIES:
        weights = _zoo_weights(mx, np, name, size, 10, rs)
        x = rs.uniform(-1, 1, (ZOO_BATCH, 3, size, size)).astype(np.float32)
        logits = {}
        for ctx in (mx.cpu(), mx.gpu(0)):
            net = _zoo_net(mx, name, weights, ctx, 10)
            with mx.autograd.predict_mode():
                logits[ctx.device_type] = net(mx.nd.array(
                    x, ctx=ctx)).asnumpy()
            del net
        err = _rel_l2(np, logits["gpu"], logits["cpu"])
        out[name] = err
        print("zoo 8a: %s (classes=10) f32 inference, batch %d x 3x%dx%d, "
              "card vs CPU logits relative L2 %.3e (bound %.0e), %d "
              "parameters | %s" % (name, ZOO_BATCH, size, size, err, ZOO_REL,
                                   len(weights), card), flush=True)
        check(np.isfinite(logits["gpu"]).all() and err <= ZOO_REL,
              "8a: %s: card vs CPU relative L2 %.3e" % (name, err))
    gc.collect()
    torch.cuda.empty_cache()
    # training mode: dropout draws from the card's framework generator
    weights = _zoo_weights(mx, np, "alexnet", 224, 10, rs)
    net = _zoo_net(mx, "alexnet", weights, mx.gpu(0), 10)
    x = mx.nd.array(rs.uniform(-1, 1, (ZOO_BATCH, 3, 224, 224)).astype(
        np.float32), ctx=mx.gpu(0))
    runs = []
    for seed in (SEED, SEED, SEED + 1):
        mx.random.seed(seed)
        torch.manual_seed(seed + 100)   # the default generator plays no part
        with mx.autograd.train_mode():
            runs.append(net(x).asnumpy())
    with mx.autograd.predict_mode():
        infer = net(x).asnumpy()
    same = bool(np.array_equal(runs[0], runs[1]))
    differ = not np.array_equal(runs[0], runs[2])
    print("zoo 8a: alexnet training-mode forward on the card: bit-equal "
          "after the same mx.random.seed %s, different under another %s, "
          "unlike inference %s | %s" % (same, differ,
                                        not np.array_equal(runs[0], infer),
                                        card), flush=True)
    check(same and differ and not np.array_equal(runs[0], infer),
          "8a: alexnet's training-mode forward does not follow the seed")
    out["seconds"] = time.perf_counter() - t0
    del net
    gc.collect()
    torch.cuda.empty_cache()
    return out


def zoo_serve(mx, card):
    """Phase 8b: alexnet, vgg16 and inception_v3 (classes=1000) served in
    bf16, inference mode, batch ZOO_SERVE_BATCH: one warm-up and
    ZOO_SERVE_BATCHES timed batches (host clock to synchronize), the bf16
    logits against the f32 net's, one batch profiled by group; then alexnet
    behind ``mx.serving.Server``."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    rs = np.random.RandomState(SEED + 9)
    out = {}
    for name, size in ZOO_SERVE:
        mx.random.seed(SEED)
        net = getattr(vision, name)(classes=1000)
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        net.collect_params().setattr("grad_req", "null")
        x32 = mx.nd.array(rs.uniform(0, 1, (ZOO_SERVE_BATCH, 3, size, size))
                          .astype(np.float32), ctx=mx.gpu(0))
        with mx.autograd.predict_mode():
            ref = net(x32).asnumpy()
        net.cast("bfloat16")
        x = x32.astype("bfloat16")
        del x32

        def batch():
            with mx.autograd.predict_mode():
                return net(x)
        got = batch().asnumpy()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(ZOO_SERVE_BATCHES):
            t0 = time.perf_counter()
            batch()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        with conv_flops() as flop:
            batch()
        mean = sum(ms) / len(ms)
        err = _rel_l2(np, got, ref)
        res = dict(batch_ms=ms, batch_ms_mean=mean,
                   img_per_s=ZOO_SERVE_BATCH / mean * 1e3,
                   peak_memory_bytes=peak, flop=flop[0],
                   tflops=flop[0] / mean / 1e9, bf16_vs_f32_rel_l2=err)
        print("zoo 8b: %s(classes=1000) bf16 inference, batch %d x 3x%dx%d: "
              "%s ms a batch (mean %.3f), %.1f img/s, %.4e conv and dense "
              "flop a batch (%.1f TFLOP/s), peak memory allocated %d bytes; "
              "bf16 logits vs the f32 net's, relative L2 %.3e (bound %.0e); "
              "published: %s | %s"
              % (name, ZOO_SERVE_BATCH, size, size, ["%.3f" % v for v in ms],
                 mean, res["img_per_s"], flop[0], res["tflops"], peak, err,
                 ZOO_BF16_REL, ZOO_PUBLISHED[name], card), flush=True)
        check(got.shape == (ZOO_SERVE_BATCH, 1000) and np.isfinite(got).all()
              and err <= ZOO_BF16_REL, "8b: %s: logits %s, finite %s, bf16 "
              "vs f32 %.3e" % (name, got.shape, np.isfinite(got).all(), err))
        res["profile"] = resnet_profile(
            batch, "8b %s one inference batch" % name, card,
            spans=ZOO_OP_SPANS, groups=ZOO_GROUPS)
        out[name] = res
        if name == "alexnet":
            out["server"] = zoo_server(mx, net, card, rs)
        del net, x
        gc.collect()
        torch.cuda.empty_cache()
    return out


def bf16_input(mx, net):
    """The served model of phase 8b: ``net`` (bf16) on requests that
    arrive as f32 host images, cast to bf16 inside the program."""

    class Bf16Input(mx.gluon.HybridBlock):
        def __init__(self, net, **kwargs):
            super().__init__(**kwargs)
            self.net = net

        def hybrid_forward(self, F, x):
            return self.net(F.Cast(x, dtype="bfloat16"))

    return Bf16Input(net)


def zoo_server(mx, net, card, rs):
    """8b: the bf16 AlexNet behind ``mx.serving.Server(max_batch=
    SERVER_MAX_BATCH)``: SERVER_REQUESTS one-image requests from
    SERVER_CLIENTS client threads; every served row bit-equal to the
    bucket-1 program's answer for that image."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch import serving
    from incubator_mxnet_tpu_torch.serving.batcher import host_rows
    dev = torch.device("cuda", 0)
    images = [rs.uniform(0, 1, (3, 224, 224)).astype(np.float32)
              for _ in range(SERVER_REQUESTS)]
    served = bf16_input(mx, net)
    t0 = time.perf_counter()
    srv = serving.Server(max_batch=SERVER_MAX_BATCH, max_wait_ms=5)
    try:
        h = srv.load("alexnet", block=served, example=mx.nd.array(
            images[0][None], ctx=mx.gpu(0)))
        load_s = time.perf_counter() - t0
        results, errors = [None] * len(images), []

        def client(k):
            try:
                for i in range(k, len(images), SERVER_CLIENTS):
                        results[i] = srv.predict("alexnet", images[i])
            except Exception as exc:       # reported below, then failed
                errors.append(repr(exc))
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(SERVER_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        check(not errors, "8b: a Server request failed: %s" % errors[:2])
        _e, params, _v = srv.registry.acquire("alexnet")
        prog = h.jit_for(1)
        same = 0
        for img, row in zip(images, results):
            want = host_rows(prog(params, torch.from_numpy(img[None]).to(
                dev)))[0]
            same += np.asarray(row).tobytes() == want.tobytes()
        stats = srv.stats()
    finally:
        srv.close()
    out = dict(load_s=load_s, wall_s=wall, requests=len(images),
               bit_equal_rows=same, captures=h.captures)
    print("zoo 8b: Server(max_batch=%d) serving the bf16 alexnet: %d "
          "one-image requests from %d client threads in %.3f s (load %.3f "
          "s, %d programs captured); %d of %d rows bit-equal to the bucket-1 "
          "program | %s" % (SERVER_MAX_BATCH, len(images), SERVER_CLIENTS,
                            wall, load_s, h.captures, same, len(images),
                            card), flush=True)
    check(same == len(images), "8b: %d of %d served rows differ from the "
          "bucket-1 program" % (len(images) - same, len(images)))
    out["stats"] = {k: v for k, v in stats.items()
                    if isinstance(v, (int, float, str))}
    return out


def alexnet_train(mx, card):
    """Phase 8c: alexnet(classes=1000) in f32 (Xavier, seeded) trained by
    the plain Gluon loop at BASELINE.md:27's batch: record,
    SoftmaxCrossEntropyLoss, backward, gluon.Trainer('nag').step, both
    Dropout(0.5) layers live; ALEXNET_WARMUP warm-up and ALEXNET_STEPS
    timed steps on one batch from np.random.RandomState(0); one step
    profiled; then each of OTHER_OPTIMIZERS takes 2 steps from the same
    saved state (each weight tensor must move; FTRL may keep a bias at
    0, its sparsity)."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch.convert import numpy_params
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    t0 = time.perf_counter()
    mx.random.seed(SEED)
    net = vision.alexnet(classes=1000)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    rs = np.random.RandomState(0)
    x = mx.nd.array(rs.rand(ALEXNET_TRAIN_BATCH, 3, 224, 224).astype(
        np.float32), ctx=mx.gpu(0))
    y = mx.nd.array((rs.rand(ALEXNET_TRAIN_BATCH) * 1000).astype(
        np.float32), ctx=mx.gpu(0))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.predict_mode():
        net(x[0:1])                      # resolves the deferred shapes
    saved = numpy_params(net)

    def step(trainer):
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(ALEXNET_TRAIN_BATCH)
        return mx.nd.mean(loss)

    trainer = mx.gluon.Trainer(net.collect_params(), "nag",
                               dict(ALEXNET_OPT))
    losses, step_ms = [], []
    for i in range(ALEXNET_WARMUP + ALEXNET_STEPS):
        if i == ALEXNET_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if i == 0:
            with conv_flops() as forward_flop:
                with mx.autograd.predict_mode():
                    net(x)
            loss = step(trainer)
        else:
            loss = step(trainer)
        losses.append(float(loss.asscalar()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    timed = step_ms[ALEXNET_WARMUP:]
    mean = sum(timed) / len(timed)
    std = (sum((v - mean) ** 2 for v in timed) / len(timed)) ** 0.5
    flop = 3 * forward_flop[0]
    out = dict(step_ms=timed, step_ms_mean=mean, step_ms_std=std,
               img_per_s=ALEXNET_TRAIN_BATCH / mean * 1e3,
               flop_per_step=flop, mfu=flop / (mean / 1e3) / H100_BF16_FLOPS,
               peak_memory_bytes=peak, losses=losses,
               setup_s=time.perf_counter() - t0)
    for i, (ms, loss) in enumerate(zip(step_ms, losses)):
        print("zoo 8c: step %d%s: %.3f ms, loss %.6f | %s"
              % (i, " (warm-up)" if i < ALEXNET_WARMUP else "", ms, loss,
                 card))
    print("zoo 8c: alexnet(classes=1000) f32, gluon.Trainer(nag %s), batch "
          "%d x 3x224x224, dropout live: %d timed steps, mean %.3f ms (std "
          "%.3f, %.3f-%.3f), %.1f img/s, MFU %.4f (%.4e conv and dense flop "
          "a step, 3x the forward's, over 989 TFLOP/s), peak memory "
          "allocated %d bytes; published: 483.37 img/s on a K80 "
          "(BASELINE.md:27) | %s"
          % (ALEXNET_OPT, ALEXNET_TRAIN_BATCH, ALEXNET_STEPS, mean, std,
             min(timed), max(timed), out["img_per_s"], out["mfu"], flop,
             peak, card), flush=True)
    check(all(math.isfinite(v) for v in losses), "8c: a loss is not finite: "
          "%s" % losses)
    check(losses[-1] < losses[0], "8c: the loss did not fall: %s" % losses)
    out["profile"] = resnet_profile(
        lambda: step(trainer).asscalar(), "8c one training step", card,
        spans=ZOO_OP_SPANS, groups=ZOO_GROUPS)
    # the other optimizers, each from the saved start
    moved = {}
    names = [n for n in saved]
    for opt, kwargs in OTHER_OPTIMIZERS:
        for name, p in net.collect_params().items():
            p.set_data(mx.nd.array(saved[name], ctx=mx.gpu(0)))
        tr = mx.gluon.Trainer(net.collect_params(), opt, dict(kwargs))
        ls = [float(step(tr).asscalar()) for _ in range(2)]
        now = numpy_params(net)
        least = min(float(np.abs(now[n] - saved[n]).max()) for n in names
                    if n.endswith("weight"))
        key = opt + ("_centered" if kwargs.get("centered") else "")
        moved[key] = dict(losses=ls, least_weight_move=least)
        check(all(math.isfinite(v) for v in ls) and least > 0,
              "8c: %s: losses %s, the least-moved weight %.3e" % (key, ls,
                                                                  least))
    out["other_optimizers"] = moved
    print("zoo 8c: from one saved state, 2 steps each: %s | %s" % (
        ", ".join("%s losses %.4f %.4f, every weight moved (least %.2e)" % (
            k, v["losses"][0], v["losses"][1], v["least_weight_move"])
            for k, v in moved.items()), card), flush=True)
    del trainer, net, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return out


def oplib_cases():
    """The deterministic ops of ops/nn.py at AlexNet's and Inception's
    activation shapes, as 7a's cases (family, op, params, input specs,
    dtypes, bound key, inputs with a gradient)."""
    s = OPLIB_SHAPES
    c, n = s["inc_35"][1], s["inc_17"][1]
    both = ("float32", "bfloat16")
    return [
        ("nn", "LRN", dict(nsize=5), [("any", s["alexnet_c1"])], both, "nn",
         (0,)),
        ("nn", "InstanceNorm", {}, [("any", s["inc_35"]), ("near1", (c,)),
                                    ("any", (c,))], both, "nn", (0, 1, 2)),
        ("nn", "LeakyReLU", dict(slope=0.1), [("any", s["inc_17"])], both,
         "broadcast", (0,)),
        ("nn", "LeakyReLU", dict(act_type="elu", slope=0.5),
         [("any", s["inc_17"])], both, "transcendental", (0,)),
        ("nn", "LeakyReLU", dict(act_type="prelu"),
         [("any", s["inc_17"]), ("unit", (n,))], both, "nn", (0, 1)),
        ("nn", "UpSampling", dict(scale=2), [("any", s["inc_17"])], both,
         "nn", (0,)),
        ("nn", "SoftmaxActivation", dict(mode="channel"),
         [("any", s["inc_8"])], both, "nn", (0,)),
        ("nn", "SoftmaxActivation", {}, [("any", s["inc_8"])], both, "nn",
         (0,)),
        ("nn", "LinearRegressionOutput", {},
         [("any", LOSS_SHAPE), ("any", LOSS_SHAPE)], both, "nn", (0,)),
        ("nn", "MAERegressionOutput", {},
         [("any", LOSS_SHAPE), ("any", LOSS_SHAPE)], both, "nn", (0,)),
        ("nn", "LogisticRegressionOutput", {},
         [("any", LOSS_SHAPE), ("unit", LOSS_SHAPE)], both, "nn", (0,)),
        ("nn", "SVMOutput", dict(margin=0.5), [("any", LOSS_SHAPE),
                                               ("small", (LOSS_SHAPE[0],))],
         ("float32",), "nn", (0,)),
    ]


def _upsampling_bilinear(mx, np, rs, card):
    """Bilinear UpSampling (MXNet's grouped Deconvolution with the
    Bilinear weight) at Inception's 17x17 map, card against CPU, under
    sync-debug mode "error"."""
    import torch
    x = sweep_input(rs, "any", OPLIB_SHAPES["inc_17"])
    c = x.shape[1]
    outs = {}
    for ctx in (mx.cpu(), mx.gpu(0)):
        w = mx.nd.zeros((c, 1, 4, 4), ctx=ctx)
        mx.init.Bilinear()(mx.initializer.InitDesc("up_weight"), w)
        xs = mx.nd.array(x, ctx=ctx)
        with card_calls(ctx, torch):
            y = mx.nd.UpSampling(xs, w, scale=2, sample_type="bilinear",
                                 num_filter=c)
        outs[ctx.device_type] = y._data
    return _ulp_err(outs["gpu"], outs["cpu"], "max")


def _update_inputs(rs, np, names):
    """fc6-shaped f32 update inputs: the weight, its gradient, and states
    (``var``-named states non-negative)."""
    f = lambda scale: (rs.standard_normal(FC6) * scale).astype(np.float32)
    make = {"w": lambda: f(0.01), "g": lambda: f(1e-3),
            "mom": lambda: f(1e-4), "var": lambda: np.abs(f(1e-4)),
            "mean": lambda: f(1e-5)}
    return [make[n]() for n in names]


# each update op's inputs and parameters (module 6), at fc6's shape
UPDATE_CASES = (
    ("nag_mom_update", ("w", "g", "mom"), dict(lr=0.01, momentum=0.9,
                                               wd=1e-4)),
    ("rmsprop_update", ("w", "g", "var"), dict(lr=1e-3, gamma1=0.9,
                                               clip_weights=1.0)),
    ("rmspropalex_update", ("w", "g", "var", "mom", "mean"),
     dict(lr=1e-3, gamma1=0.9, gamma2=0.9, epsilon=1e-4)),
    ("ftrl_update", ("w", "g", "mom", "var"), dict(lr=0.1, lamda1=1e-3)),
    ("ftml_update", ("w", "g", "var", "var", "mom"), dict(lr=1e-3, t=3)),
    ("signsgd_update", ("w", "g"), dict(lr=1e-3, wd=1e-4)),
    ("signum_update", ("w", "g", "mom"), dict(lr=1e-3, momentum=0.9,
                                              wd_lh=1e-4)),
)


def updates_on_card(mx, rs):
    """8d: each update op of this slice at fc6's shape in f32, on CUDA
    tensors under sync-debug mode "error" against the CPU: the new weight
    and every state written back, within UPDATE_ULP ulps at its largest
    value; then each of MP_OPTIMIZERS on a bf16 weight of that shape
    through ``multi_precision`` (an f32 master copy), 2 steps, the bf16
    weights within MP_ULP bf16 ulps at their largest value, where the
    CPU's 2 steps moved them at least MP_MOVE_ULP.  Returns the largest
    errors and (``*_move``) the CPU's moves, in those ulps."""
    import numpy as np
    import torch
    worst = {}
    for name, names, params in UPDATE_CASES:
        arrays = _update_inputs(rs, np, names)
        res = {}
        for ctx in (mx.cpu(), mx.gpu(0)):
            xs = [mx.nd.array(a, ctx=ctx) for a in arrays]
            with card_calls(ctx, torch):
                getattr(mx.nd, name)(*xs, out=xs[0], **params)
            res[ctx.device_type] = [x._data for i, x in enumerate(xs)
                                    if i != 1]
        err = max(_ulp_err(g, w, "max") for g, w in zip(res["gpu"],
                                                         res["cpu"]))
        worst[name] = err
        check(err <= UPDATE_ULP, "8d: %s: %.3g ulp above %d"
              % (name, err, UPDATE_ULP))
    grad = (rs.standard_normal(FC6) * MP_GRAD).astype(np.float32)
    w0 = (rs.standard_normal(FC6) * 0.01).astype(np.float32)
    for opt, kwargs in MP_OPTIMIZERS:
        res = {}
        for ctx in (mx.cpu(), mx.gpu(0)):
            o = mx.optimizer.create(opt, multi_precision=True, **kwargs)
            upd = mx.optimizer.get_updater(o)
            w = mx.nd.array(w0, ctx=ctx).astype("bfloat16")
            res["start"] = w._data.clone()
            g = mx.nd.array(grad, ctx=ctx).astype("bfloat16")
            for _ in range(2):
                upd(0, g, w)
            res[ctx.device_type] = w._data
        key = "mp_" + opt + ("_centered" if kwargs.get("centered") else "")
        worst[key] = _ulp_err(res["gpu"], res["cpu"], "max")
        moved = _ulp_err(res["start"], res["cpu"], "max")
        worst[key + "_move"] = moved
        check(worst[key] <= MP_ULP and moved >= MP_MOVE_ULP,
              "8d: %s: bf16 weights %.3g ulp apart (bound %d), the CPU's "
              "update moved them %.3g ulp (at least %d)"
              % (key, worst[key], MP_ULP, moved, MP_MOVE_ULP))
    return worst


# the losses of module 8 at (256, 1000): (class, kwargs, label kind)
LOSS_CASES = (
    ("L1Loss", {}, "any"), ("SigmoidBinaryCrossEntropyLoss", {}, "bits"),
    ("SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True}, "bits"),
    ("KLDivLoss", {"from_logits": False}, "probs"), ("HuberLoss", {}, "any"),
    ("HingeLoss", {}, "signs"), ("SquaredHingeLoss", {}, "signs"),
    ("LogisticLoss", {}, "signs"),
    ("LogisticLoss", {"label_format": "binary"}, "bits"),
    ("TripletLoss", {}, "any"),
)


def losses_on_card(mx, rs):
    """8d: each loss at LOSS_SHAPE on CUDA tensors against the CPU,
    forward and the prediction's gradient, under sync-debug mode "error",
    within LOSS_REL of the largest value.  Returns the largest errors."""
    import numpy as np
    import torch
    worst = {}
    for name, kwargs, kind in LOSS_CASES:
        pred = sweep_input(rs, "any", LOSS_SHAPE)
        if kwargs.get("from_sigmoid"):
            pred = 1 / (1 + np.exp(-pred))
        label = {"any": lambda: sweep_input(rs, "any", LOSS_SHAPE),
                 "bits": lambda: (rs.random(LOSS_SHAPE) < 0.5).astype(
                     np.float32),
                 "signs": lambda: np.where(rs.random(LOSS_SHAPE) < 0.5, -1,
                                           1).astype(np.float32),
                 "probs": lambda: (lambda p: p / p.sum(-1, keepdims=True))(
                     rs.random(LOSS_SHAPE, dtype=np.float32) + 0.05)}[kind]()
        extra = [sweep_input(rs, "any", LOSS_SHAPE)] \
            if name == "TripletLoss" else []
        res = {}
        for ctx in (mx.cpu(), mx.gpu(0)):
            loss_fn = getattr(mx.gluon.loss, name)(**kwargs)
            p = mx.nd.array(pred, ctx=ctx)
            args = [mx.nd.array(a, ctx=ctx) for a in [label] + extra]
            p.attach_grad()
            with card_calls(ctx, torch):
                with mx.autograd.record():
                    loss = loss_fn(p, *args)
                loss.backward()
            res[ctx.device_type] = (loss.asnumpy(), p.grad.asnumpy())
        key = name + "".join("_%s" % v for v in kwargs.values())
        worst[key] = max(
            float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)
            for g, w in zip(res["gpu"], res["cpu"]))
        check(worst[key] <= LOSS_REL, "8d: %s: card vs CPU %.3e of the "
              "largest value" % (key, worst[key]))
    return worst


def _spd(np, rs, n, s):
    """``s`` symmetric positive definite n x n matrices Q·diag(λ)·Qᵀ with
    the eigenvalues λ spread evenly over [1, 2]: well conditioned, and
    with gaps of 1/n between eigenvalues, so that the eigenvectors are too
    (a Wishart matrix's smallest eigenvalues lie ~1e-5 apart, which moved
    syevd's vectors by 0.42 between card and CPU in call 1 of PR 14)."""
    q = np.linalg.qr(rs.standard_normal((s, n, n)))[0]
    lam = np.linspace(1.0, 2.0, n)
    return ((q * lam) @ q.transpose(0, 2, 1)).astype(np.float32)


def linalg_on_card(mx, rs):
    """8d: the linalg ops on LINALG_STACK stacked LINALG_N x LINALG_N
    well-conditioned matrices and fft/ifft at FFT_SHAPE, on CUDA tensors
    against the CPU, forward and backward, each output within LINALG_REL of
    its largest value; under sync-debug mode "error" but ``syevd``, which
    waits for the card (cuSOLVER's ``info``, read by ``eigh``): its
    eigenvalues and U·A·Uᵀ = diag(L) within LINALG_REL, its vectors up to
    a sign per row within SYEVD_VECTOR_REL.  Returns the largest errors."""
    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch.ops.registry import get_op
    s, n = LINALG_STACK, LINALG_N
    a = (rs.standard_normal((s, n, n)) / np.sqrt(n)).astype(np.float32)
    b = (rs.standard_normal((s, n, n)) / np.sqrt(n)).astype(np.float32)
    low = (np.tril(a) + 2 * np.eye(n)).astype(np.float32)
    spd = _spd(np, rs, n, s)
    chol = np.linalg.cholesky(spd.astype(np.float64)).astype(np.float32)
    wide = a[:, : n // 2]
    cases = [("_linalg_gemm", [a, b, a], dict(alpha=0.5, beta=2.0),
              (0, 1, 2)),
             ("_linalg_gemm2", [a, b], dict(transpose_b=True), (0, 1)),
             ("_linalg_potrf", [spd], {}, (0,)),
             ("_linalg_potri", [chol], {}, (0,)),
             ("_linalg_trmm", [low, b], dict(rightside=True), (0, 1)),
             ("_linalg_trsm", [low, b], dict(transpose=True), (0, 1)),
             ("_linalg_sumlogdiag", [spd], {}, (0,)),
             ("_linalg_syrk", [a], dict(alpha=0.5), (0,)),
             ("_linalg_gelqf", [wide], {}, (0,)),
             ("_contrib_fft", [sweep_input(rs, "any", FFT_SHAPE)], {}, (0,)),
             ("_contrib_ifft", [sweep_input(rs, "any", FFT_SHAPE)], {},
              (0,))]
    worst = {}
    heads = {}
    for name, arrays, params, grads in cases:
        want = _sweep_run(mx, get_op(name), arrays, params, "float32",
                          mx.cpu(), heads, grads)
        got = _sweep_run(mx, get_op(name), arrays, params, "float32",
                         mx.gpu(0), heads, grads)
        err = 0.0
        for gt, wt in zip(got[0] + got[1], want[0] + want[1]):
            w = wt.detach().double()
            err = max(err, float((gt.detach().cpu().double() - w).abs().max()) /
                      max(float(w.abs().max()), 1e-30))
        worst[name] = err
        check(err <= LINALG_REL, "8d: %s: card vs CPU %.3e of the largest "
              "value" % (name, err))
    # syevd (waits for the card): the eigenvalues, U·A·Uᵀ = diag(L) on the
    # card, and the vectors up to a sign per row against the CPU's
    res = {}
    for ctx in (mx.cpu(), mx.gpu(0)):
        u, lam = mx.nd.linalg.syevd(mx.nd.array(spd, ctx=ctx))
        res[ctx.device_type] = (u.asnumpy().astype(np.float64),
                                lam.asnumpy().astype(np.float64))
    (gu, gl), (wu, wl) = res["gpu"], res["cpu"]
    sign = np.sign((gu * wu).sum(-1, keepdims=True))
    diag = gu @ spd.astype(np.float64) @ gu.transpose(0, 2, 1)
    worst["_linalg_syevd"] = max(
        float(np.abs(gl - wl).max() / np.abs(wl).max()),
        float(np.abs(diag - gl[..., None] * np.eye(n)).max() /
              np.abs(gl).max()))
    worst["_linalg_syevd_vectors"] = float(np.abs(gu * sign - wu).max() /
                                           np.abs(wu).max())
    check(worst["_linalg_syevd"] <= LINALG_REL and
          worst["_linalg_syevd_vectors"] <= SYEVD_VECTOR_REL,
          "8d: syevd: eigenvalues and U·A·Uᵀ %.3e, vectors %.3e, card vs "
          "CPU" % (worst["_linalg_syevd"], worst["_linalg_syevd_vectors"]))
    return worst


def initializers_on_card(mx):
    """8d: the deterministic initializers fill the same values on the card
    as on the CPU, bit for bit."""
    import numpy as np
    cases = [(mx.init.Bilinear(), "up_weight", (64, 1, 8, 8)),
             (mx.init.LSTMBias(forget_bias=1.5), "lstm_bias", (4096,)),
             (mx.init.Constant(0.3), "w_weight", FC6),
             (mx.init.One(), "w_weight", FC6),
             (mx.init.Load({"arg:w_weight": np.arange(12.0).reshape(3, 4)}),
              "w_weight", (3, 4)),
             (mx.init.Mixed(["up.*", ".*"], [mx.init.Bilinear(),
                                             mx.init.Zero()]),
              "up_weight", (8, 2, 4, 4))]
    for init, name, shape in cases:
        vals = []
        for ctx in (mx.cpu(), mx.gpu(0)):
            arr = mx.nd.zeros(shape, ctx=ctx)
            init(mx.initializer.InitDesc(name), arr)
            vals.append(arr.asnumpy())
        check(np.array_equal(vals[0], vals[1]), "8d: %s fills other values "
              "on the card" % type(init).__name__)
    return len(cases)


def op_library(mx, card):
    """Phase 8d: the op library of this slice on CUDA tensors against the
    port's CPU result for the same numpy inputs, forward and backward,
    under sync-debug mode "error" (only syevd exempt): the nn ops
    (:func:`oplib_cases`, 7a's harness), bilinear UpSampling, the update
    ops and optimizers, the losses, the linalg ops, the deterministic
    initializers.  One line each."""
    import numpy as np
    t0 = time.perf_counter()
    rs = np.random.default_rng(SEED + 10)
    out = {}
    nn = dict(cases=0, max_ulp=0.0, worst_case=None)
    for case in oplib_cases():
        for dtype in case[4]:
            worst, _bound = sweep_case(mx, case, dtype, rs)
            nn["cases"] += 1
            if worst > nn["max_ulp"]:
                nn["max_ulp"] = worst
                nn["worst_case"] = "%s %s %s" % (case[1], case[2], dtype)
    nn["upsampling_bilinear_ulp"] = _upsampling_bilinear(mx, np, rs, card)
    check(nn["upsampling_bilinear_ulp"] <= SWEEP_ULP["nn"][0][0][0],
          "8d: bilinear UpSampling %.3g ulp" % nn["upsampling_bilinear_ulp"])
    out["nn"] = nn
    print("oplib 8d nn: %d cases (f32 and bf16) at AlexNet's and "
          "Inception's activation shapes %s, max error %.3g ulp (%s; bounds "
          "f32 %s, bf16 %s); bilinear UpSampling %.3g ulp | %s"
          % (nn["cases"], OPLIB_SHAPES, nn["max_ulp"], nn["worst_case"],
             SWEEP_ULP["nn"][0], SWEEP_ULP["nn"][1],
             nn["upsampling_bilinear_ulp"], card), flush=True)
    out["updates"] = updates_on_card(mx, rs)
    print("oplib 8d updates: at fc6's shape %s, card vs CPU in ulps "
          "(f32 ops bound %d; bf16 weights through multi_precision bound "
          "%d where the CPU moved them at least %d): %s | %s" % (
              FC6, UPDATE_ULP, MP_ULP, MP_MOVE_ULP, json.dumps(
              {k: round(v, 3) for k, v in out["updates"].items()}), card),
          flush=True)
    out["losses"] = losses_on_card(mx, rs)
    print("oplib 8d losses: at %s, card vs CPU (forward and gradient, of "
          "the largest value; bound %.0e): %s | %s" % (
              LOSS_SHAPE, LOSS_REL, json.dumps(
                  {k: "%.2e" % v for k, v in out["losses"].items()}), card),
          flush=True)
    out["linalg"] = linalg_on_card(mx, rs)
    print("oplib 8d linalg: %d stacked %dx%d matrices, fft/ifft at %s, "
          "card vs CPU (forward and gradient, of the largest value; bound "
          "%.0e; syevd outside sync-debug mode: eigenvalues and U·A·Uᵀ to "
          "that bound, vectors up to a sign per row to %.0e): %s | %s"
          % (LINALG_STACK, LINALG_N, LINALG_N, FFT_SHAPE, LINALG_REL,
             SYEVD_VECTOR_REL, json.dumps({k: "%.2e" % v for k, v in
                                           out["linalg"].items()}), card),
          flush=True)
    out["initializers"] = initializers_on_card(mx)
    out["seconds"] = time.perf_counter() - t0
    print("oplib 8d: %d deterministic initializers bit-equal on the card; "
          "8d in %.1f s | %s" % (out["initializers"], out["seconds"], card),
          flush=True)
    return out


def _moments(x, mean, var, m4):
    """(|mean - μ| / SE, |var - σ²| / SE) of the draws ``x`` on the card,
    in float64; ``m4`` the fourth central moment."""
    x = x.double().flatten()
    n = x.numel()
    m, v = float(x.mean()), float(x.var(unbiased=False))
    return (abs(m - mean) / math.sqrt(var / n),
            abs(v - var) / math.sqrt(max(m4 - var * var, 1e-30) / n))


def _ks(np, x, cdf):
    """Kolmogorov-Smirnov distance of the draws against ``cdf`` (scipy)."""
    xs = np.sort(x.double().cpu().numpy())
    f = cdf(xs)
    n = xs.size
    i = np.arange(1, n + 1)
    return float(max((i / n - f).max(), (f - (i - 1) / n).max()))


def random_draws(mx, card):
    """Phase 8e: the samplers on the card, RANDOM_N draws each (f32; uniform
    and normal also bf16), drawn under sync-debug mode "error": mean and
    variance within 6 standard errors, the KS distance against scipy's CDF
    below the large-n bound at p = RANDOM_P, multinomial frequencies by
    chi-square, shuffle a permutation of whole rows, Dropout's keep share,
    values and gradient, rrelu's slopes in their range, and every draw
    bit-equal after the same ``mx.random.seed`` with torch's default
    generators reseeded in between."""
    import numpy as np
    import scipy.stats as st
    import torch
    gpu = mx.gpu(0)
    n = RANDOM_N
    t0 = time.perf_counter()
    ks_bound = math.sqrt(-math.log(RANDOM_P / 2) / (2 * n))

    def gm4(a, b):
        return 3 * a * (a + 2) * b ** 4
    # (name, draw, mean, var, 4th central moment, scipy cdf or None)
    samplers = [
        ("uniform", lambda d: mx.random.uniform(-1, 3, shape=(n,), ctx=gpu,
                                                dtype=d),
         1.0, 16 / 12, 256 / 80, st.uniform(-1, 4).cdf),
        ("normal", lambda d: mx.random.normal(2, 0.5, shape=(n,), ctx=gpu,
                                              dtype=d),
         2.0, 0.25, 3 * 0.0625, st.norm(2, 0.5).cdf),
        ("exponential", lambda d: mx.random.exponential(
            4.0, shape=(n,), ctx=gpu), 0.25, 1 / 16, 9 / 256,
         st.expon(scale=0.25).cdf),
        ("gamma_0.5", lambda d: mx.random.gamma(0.5, 2.0, shape=(n,),
                                                ctx=gpu),
         1.0, 2.0, gm4(0.5, 2.0), st.gamma(0.5, scale=2.0).cdf),
        ("gamma_2", lambda d: mx.random.gamma(2.0, 1.0, shape=(n,), ctx=gpu),
         2.0, 2.0, gm4(2.0, 1.0), st.gamma(2.0).cdf),
        ("gamma_9", lambda d: mx.random.gamma(9.0, 0.5, shape=(n,), ctx=gpu),
         4.5, 2.25, gm4(9.0, 0.5), st.gamma(9.0, scale=0.5).cdf),
        ("poisson", lambda d: mx.random.poisson(3.5, shape=(n,), ctx=gpu),
         3.5, 3.5, 3.5 + 3 * 3.5 ** 2, None),
        ("negative_binomial", lambda d: mx.random.negative_binomial(
            4, 0.3, shape=(n,), ctx=gpu), 4 * 0.7 / 0.3, 4 * 0.7 / 0.09,
         None, None),
        ("generalized_negative_binomial",
         lambda d: mx.random.generalized_negative_binomial(
             2.0, 0.5, shape=(n,), ctx=gpu), 2.0, 4.0, None, None),
    ]
    out = {}
    mx.random.seed(SEED)
    for name, draw, mean, var, m4, cdf in samplers:
        dtypes = ("float32", "bfloat16") if name in ("uniform", "normal") \
            else ("float32",)
        for dtype in dtypes:
            with card_calls(gpu, torch):
                x = draw(dtype)._data
            check(x.device.type == "cuda" and x.numel() == n,
                  "8e: %s drew %s on %s" % (name, tuple(x.shape), x.device))
            fourth = m4 if m4 is not None else float(
                ((x.double() - x.double().mean()) ** 4).mean())
            zm, zv = _moments(x, mean, var, fourth)
            key = "%s_%s" % (name, dtype)
            res = dict(mean_se=zm, var_se=zv)
            if cdf is not None and dtype == "float32":
                res["ks"] = _ks(np, x, cdf)
            out[key] = res
            check(zm <= 6 and zv <= 6, "8e: %s: mean %.2f, variance %.2f "
                  "standard errors off" % (key, zm, zv))
            check(res.get("ks", 0.0) <= ks_bound, "8e: %s: KS %.3e above "
                  "%.3e" % (key, res.get("ks", 0.0), ks_bound))
            if name == "uniform":
                check(float(x.min()) >= -1 and float(x.max()) < 3,
                      "8e: uniform %s outside [-1, 3)" % dtype)
            del x
    # multinomial: class frequencies by chi-square, per row
    p = torch.tensor([[0.05, 0.15, 0.3, 0.5], [0.5, 0.3, 0.15, 0.05]],
                     device="cuda")
    probs = mx.nd.NDArray(p)
    with card_calls(gpu, torch):
        ids = mx.random.multinomial(probs, shape=n // 4)._data
    chi = []
    for row, q in zip(ids, p.double().cpu().numpy()):
        counts = torch.bincount(row.long(), minlength=4).cpu().numpy()
        chi.append(float(st.chisquare(counts, q / q.sum() * row.numel())
                         .pvalue))
    out["multinomial_chi2_p"] = chi
    check(min(chi) > RANDOM_P, "8e: multinomial frequencies, chi-square p "
          "%s" % chi)
    # shuffle: a permutation of whole rows
    rows = n // 16
    data = torch.arange(rows, device="cuda", dtype=torch.float32)[:, None] \
        * 4 + torch.arange(4, device="cuda", dtype=torch.float32)
    with card_calls(gpu, torch):
        sh = mx.random.shuffle(mx.nd.NDArray(data))._data
    ok = torch.equal(torch.sort(sh[:, 0])[0], data[:, 0]) and torch.equal(
        sh - sh[:, :1], data - data[:, :1]) and not torch.equal(sh, data)
    out["shuffle_rows"] = rows
    check(ok, "8e: shuffle is not a permutation of whole rows")
    # dropout: keep share, kept values, gradient
    pdrop = 0.5
    x = mx.nd.array(np.random.RandomState(SEED).uniform(
        0.5, 2.0, (256, 4096)).astype(np.float32), ctx=gpu)
    x.attach_grad()
    with card_calls(gpu, torch):
        with mx.autograd.record():
            y = mx.nd.Dropout(x, p=pdrop)
        y.backward()
    yt, xt, gt = y._data, x._data, x.grad._data
    mask = yt != 0
    keep = torch.full((), 1 - pdrop, device="cuda")
    share = float(mask.float().mean())
    sigma = math.sqrt(pdrop * (1 - pdrop) / mask.numel())
    values = torch.equal(yt[mask], (xt / keep)[mask])
    grads = torch.equal(gt, torch.where(mask, 1 / keep, torch.zeros_like(gt)))
    out["dropout"] = dict(keep_share=share, sigmas=abs(share - 0.5) / sigma,
                          values=values, gradient=grads)
    check(abs(share - (1 - pdrop)) <= 6 * sigma and values and grads,
          "8e: dropout keep share %.5f, values %s, gradient %s"
          % (share, values, grads))
    # rrelu: n slopes in f32 and bf16 on x = -1 (the output is minus the
    # slope, exactly), in [lower, upper) and by their moments
    lo, hi = 0.1, 0.3
    slopes = {}
    for dtype in ("float32", "bfloat16"):
        neg = mx.nd.full((n,), -1.0, ctx=gpu, dtype=dtype)
        with card_calls(gpu, torch):
            with mx.autograd.train_mode():
                r = -mx.nd.LeakyReLU(neg, act_type="rrelu", lower_bound=lo,
                                     upper_bound=hi)._data
        zm, zv = _moments(r, (lo + hi) / 2, (hi - lo) ** 2 / 12,
                          (hi - lo) ** 4 / 80)
        least, most = float(r.min()), float(r.max())
        slopes[dtype] = dict(mean_se=zm, var_se=zv, least=least, most=most)
        check(lo <= least and most < hi and zm <= 6 and zv <= 6,
              "8e: rrelu %s slopes in [%.4f, %.4f], mean %.2f, variance "
              "%.2f standard errors off" % (dtype, least, most, zm, zv))
        del neg, r
    out["rrelu_slopes"] = slopes
    # seeds: every sampler again after the same seed, default generators
    # reseeded in between
    def all_draws():
        outs = []
        with card_calls(gpu, torch):
            for name, draw, *_ in samplers:
                outs.append(draw("float32")._data[:4096].clone())
            outs.append(mx.random.multinomial(probs, shape=64)._data)
            outs.append(mx.random.shuffle(mx.nd.NDArray(data))._data[:64])
            with mx.autograd.train_mode():
                outs.append(mx.nd.Dropout(x, p=0.5)._data[:4])
        return outs
    mx.random.seed(SEED + 5)
    torch.manual_seed(1)
    torch.cuda.manual_seed_all(1)
    first = all_draws()
    mx.random.seed(SEED + 5)
    torch.manual_seed(2)
    torch.cuda.manual_seed_all(2)
    again = all_draws()
    mx.random.seed(SEED + 6)
    other = all_draws()
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    differ = sum(not torch.equal(a, b) for a, b in zip(first, other))
    out["seed_bit_equal"] = same
    check(same and differ == len(first), "8e: draws after the same seed "
          "equal %s; %d of %d differ under another" % (same, differ,
                                                      len(first)))
    out["seconds"] = time.perf_counter() - t0
    print("random 8e: %d draws a sampler on the card (KS bound %.3e at p = "
          "%.0e): %s; multinomial chi-square p %s; shuffle of %d rows a "
          "permutation; dropout keep share %.5f (%.2f sigma), kept x/keep "
          "and gradient mask/keep exact; rrelu slopes in [%g, %g) %s; every "
          "draw bit-equal after the same seed with torch's default "
          "generators reseeded; %.1f s | %s"
          % (n, ks_bound, RANDOM_P, json.dumps(
              {k: {m: round(v, 6) for m, v in r.items()}
               for k, r in out.items() if isinstance(r, dict) and
               "mean_se" in r}), ["%.3g" % v for v in chi], rows, share,
             out["dropout"]["sigmas"], lo, hi, json.dumps(
                 {d: {m: round(v, 6) for m, v in r.items()}
                  for d, r in slopes.items()}), out["seconds"], card),
          flush=True)
    return out


def main():
    import torch
    # phase 1: device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke runs only on a "
             "CUDA card")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print("device: %s | torch.cuda.get_device_name(0) = %s | torch %s, CUDA %s"
          % (card, kind, torch.__version__, torch.version.cuda), flush=True)

    try:
        import incubator_mxnet_tpu_torch as mx
    except ImportError as exc:
        fail("cannot import incubator_mxnet_tpu_torch (%s); run from the root "
             "of a checkout" % exc)
    from incubator_mxnet_tpu_torch import cuda_build
    from incubator_mxnet_tpu_torch.ops.attention import (
        flash_attention, _attention_reference, split_f32,
        _split_f32_reference, _attention_f32_planes)
    from incubator_mxnet_tpu_torch.models import TransformerLM, HostXavier
    from incubator_mxnet_tpu_torch.convert import load_numpy_params
    import numpy as np

    # phase 2: build
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    print("build: %.1f s for %s (nvcc %s) into %s" % (
        time.perf_counter() - t0, sorted(built) or "nothing (cached)",
        " ".join(cuda_build.NVCC_FLAGS), cuda_build.BUILD_DIR), flush=True)
    t0 = time.perf_counter()
    cuda_build.load_extension("_rtc_launch")
    print("build: the rtc launcher %s (%s %s) loaded in %.2f s" % (
        cuda_build.extension_path("_rtc_launch").name, cuda_build._cc(),
        " ".join(cuda_build.CC_FLAGS), time.perf_counter() - t0), flush=True)
    for name in cuda_build.KERNELS:
        for line in cuda_build.build_log(name).splitlines():
            if any(t in line for t in ("entry function", "registers",
                                       "spill", "C7515", "C7512")):
                print("  ptxas %s: %s" % (name, line.strip()))
    flash_lib = cuda_build.lib_path("flash_attention")
    hgmma = {route: sass_count(flash_lib, "HGMMA", function)
             for route, function in HGMMA_FUNCTIONS.items()}
    print("build: HGMMA instructions in the flash_attention library's SASS "
          "by route (cuobjdump -sass): %s" % hgmma, flush=True)
    for route, count in hgmma.items():
        check(count > 0, "no HGMMA in the %s route's kernel: it does not run "
              "on the tensor cores" % route)

    # phase 3: each kernel against its plain version on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("kernel: plain versions run with TF32 off "
          "(torch.backends.cuda.matmul.allow_tf32 = False)", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    errs, violations = {}, {}
    for (b, h, sq, sk, d), causal in ATTENTION_CASES + WIDE_CASES + \
            WIDER_CASES:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            q = torch.randn(b, h, sq, d, generator=gen, device=dev).to(dtype)
            k = torch.randn(b, h, sk, d, generator=gen, device=dev).to(dtype)
            v = torch.randn(b, h, sk, d, generator=gen, device=dev).to(dtype)
            out = flash_attention(q, k, v, causal)
            torch.cuda.synchronize()
            ref = _attention_reference(q.float(), k.float(), v.float(), causal)
            check(out.dtype == dtype and out.shape == (b, h, sq, d),
                  "kernel output %s %s" % (out.dtype, tuple(out.shape)))
            check(bool(torch.isfinite(out).all()), "kernel output not finite")
            err = (out.float() - ref).abs().max().item()
            dname = str(dtype).replace("torch.", "")
            tol = TOLERANCE[dname]
            key = case_key((b, h, sq, sk, d), causal, dname)
            errs[key] = err
            extra = ""
            if dtype != torch.float32:
                rel = HALF_REL[dname]
                bad = int(((out.float() - ref).abs() >
                           rel * ref.abs() + BF16_ABS).sum().item())
                violations[key] = bad
                extra = ", %d of %d elements outside 2^%d·|ref| + 5e-5" % (
                    bad, ref.numel(), round(math.log2(rel)))
            print("kernel flash_attention_fwd %-34s max_abs_err %.3e "
                  "(bound %.0e)%s" % (key, err, tol, extra), flush=True)
            check(err <= tol, "flash_attention_fwd %s: max_abs_err %.3e > %.0e"
                  % (key, err, tol))
            check(not violations.get(key), "flash_attention_fwd %s: %d "
                  "elements break the per-element bound"
                  % (key, violations.get(key, 0)))
            del q, k, v, out, ref
    # mixes of dtypes: the f32 route reads each input at its own dtype
    for dtypes, (b, h, sq, sk, d) in MIXED_CASES:
        q, k, v = (torch.randn(b, h, s_, d, generator=gen, device=dev).to(
            getattr(torch, t)) for t, s_ in zip(dtypes, (sq, sk, sk)))
        before = flash_attention.mixed_launches, split_f32.launches
        out = flash_attention(q, k, v, True)
        torch.cuda.synchronize()
        ref = _attention_reference(q, k, v, True)
        check(out.dtype == q.dtype and ref.dtype == q.dtype,
              "mixed %s: output %s" % (dtypes, out.dtype))
        check((flash_attention.mixed_launches, split_f32.launches) ==
              (before[0] + 1, before[1] + 3), "mixed %s did not take the f32 "
              "route's kernels" % (dtypes,))
        err = (out.float() - ref.float()).abs().max().item()
        key = case_key((b, h, sq, sk, d), True, "+".join(dtypes))
        errs[key] = err
        print("kernel flash_attention_fwd mixed %-42s max_abs_err %.3e (bound "
              "%.0e, q's dtype out)" % (key, err, TOLERANCE[dtypes[0]]),
              flush=True)
        check(err <= TOLERANCE[dtypes[0]], "mixed %s: max_abs_err %.3e"
              % (dtypes, err))
        del q, k, v, out, ref
    # a mix of dtypes above D = 256: route B, each input at its dtype
    dtypes, (b, h, sq, sk, d) = WIDE_MIXED
    q, k, v = (torch.randn(b, h, s_, d, generator=gen, device=dev).to(
        getattr(torch, t)) for t, s_ in zip(dtypes, (sq, sk, sk)))
    before = (flash_attention.wide_launches, flash_attention.wide_f32_launches,
              split_f32.launches)
    out = flash_attention(q, k, v, True)
    torch.cuda.synchronize()
    ref = _attention_reference(q, k, v, True)
    check(out.dtype == q.dtype and (
        flash_attention.wide_launches, flash_attention.wide_f32_launches,
        split_f32.launches) == (before[0] + 1, before[1] + 1, before[2] + 3),
          "wide mixed %s: output %s, not route B" % (dtypes, out.dtype))
    err = (out.float() - ref.float()).abs().max().item()
    key = case_key((b, h, sq, sk, d), True, "+".join(dtypes))
    errs[key] = err
    print("kernel flash_attention_fwd wide mixed %-37s max_abs_err %.3e "
          "(bound %.0e, q's dtype out)" % (key, err, TOLERANCE[dtypes[0]]),
          flush=True)
    check(err <= TOLERANCE[dtypes[0]], "wide mixed %s: max_abs_err %.3e"
          % (dtypes, err))
    del q, k, v, out, ref
    # the f32 route's split pass, bit for bit, on split-heads views at the
    # small LM's shape and the serving shape
    split_errs = {}
    for (b, h, sq, sk, d), causal in ATTENTION_CASES[-2:]:
        x = torch.randn(b, sq, h, d, generator=gen, device=dev).transpose(1, 2)
        got = split_f32(x, 1.0 / math.sqrt(d))
        torch.cuda.synchronize()
        want = _split_f32_reference(x, 1.0 / math.sqrt(d))
        key = case_key((b, h, sq, sk, d), causal, "float32")
        split_errs[key] = (got.float() - want.float()).abs().max().item()
        print("kernel split_f32 %-32s planes %s, max_abs_err %.3e against "
              "the plain version (bound 0: bit for bit)"
              % (key, tuple(got.shape), split_errs[key]), flush=True)
        check(torch.equal(got, want), "split_f32 %s differs from its plain "
              "version" % key)
        del x, got, want

    # flash attention's backward against autograd through the plain version
    backward_errs = check_backward(gen, dev, card)

    # phase 4a: small LMs on the card against the same weights on the CPU,
    # each route's path: its launch count zeroed just before, read after
    small_launches = {}
    rs = np.random.RandomState(SEED)
    for name, dtype, small, counter, ulps in SMALL_LMS:
        tokens = rs.randint(0, small["vocab"], (2, small["seq_len"]))
        with mx.cpu():
            cpu_net = TransformerLM(**small)
            cpu_net.initialize(HostXavier(SEED))
            cpu_net(mx.nd.array(tokens))
            weights = {n: p.data().asnumpy() for n, p in
                       cpu_net.collect_params().items()}
            cpu_net.cast(dtype)
            cpu_logits = np.asarray(cpu_net(mx.nd.array(
                tokens, dtype="int32")).asnumpy(), np.float32)
        gpu_net = TransformerLM(**small)
        load_numpy_params(gpu_net, weights, mx.gpu(0))
        gpu_net.cast(dtype)
        small_tokens = mx.nd.array(tokens, ctx=mx.gpu(0), dtype="int32")
        torch.cuda.synchronize()
        for c in WIDE_COUNTERS + ("f32_launches", "f16_launches"):
            setattr(flash_attention, c, 0)
        split_f32.launches = 0
        with mx.autograd.predict_mode():
            gpu_logits = np.asarray(gpu_net(small_tokens).asnumpy(),
                                    np.float32)
        launches = {c: getattr(flash_attention, c) for c in
                    WIDE_COUNTERS + ("f32_launches", "f16_launches")}
        launches["split_f32"] = split_f32.launches
        small_launches[name] = launches[counter]
        del small_tokens
        err = float(np.abs(gpu_logits - cpu_logits).max())
        top = float(np.abs(cpu_logits).max())
        bound = 1e-4 if ulps is None else \
            ulps * 2.0 ** (math.floor(math.log2(top)) - MANTISSA[dtype])
        print("serve: small LM %s %s %s, card vs CPU logits max_abs_err %.3e "
              "(bound %.3e%s); launches %s"
              % (name, dtype, small, err, bound, "" if ulps is None else
                 ": %d ulps at max |logits| %.4f" % (ulps, top), launches),
              flush=True)
        check(launches[counter] == small["n_layers"], "small LM %s launched "
              "%d %s for %d layers" % (name, launches[counter], counter,
                                       small["n_layers"]))
        check(launches["launches"] == small["n_layers"], "small LM %s: %d "
              "flash launches" % (name, launches["launches"]))
        wide = small["d_model"] // small["n_heads"] > 256
        check(launches["wide_launches"] == wide * small["n_layers"],
              "small LM %s: %d wide launches" % (name,
                                                 launches["wide_launches"]))
        if dtype == "float32":
            f32_routes = launches["f32_launches"] + \
                launches["wide_f32_launches"]
            check(launches["split_f32"] == 3 * f32_routes,
                  "split_f32 launched %d times for %d f32 attentions"
                  % (launches["split_f32"], f32_routes))
        check(err <= bound, "small LM %s: card and CPU disagree" % name)
        check(np.array_equal(gpu_logits[:, -1].argmax(-1),
                             cpu_logits[:, -1].argmax(-1)),
              "small LM %s: greedy tokens differ between card and CPU" % name)
        del cpu_net, gpu_net
        gc.collect()   # Blocks hold reference cycles: free the card's copy

    # phase 4b: the full-width LM serving 4 requests
    cfg = LM_CONFIG
    batch, n_requests = 8, 4
    t0 = time.perf_counter()
    net = TransformerLM(**cfg)
    net.pos_embed.init = None      # HostXavier for every weight, as the bench
    net.initialize(HostXavier(SEED), ctx=mx.gpu(0))
    net.cast("bfloat16")
    # a served model keeps no gradient buffers
    net.collect_params().setattr("grad_req", "null")
    requests = [mx.nd.array(rs.randint(0, cfg["vocab"], (batch, cfg["seq_len"])),
                            ctx=mx.gpu(0), dtype="int32")
                for _ in range(n_requests)]
    with mx.autograd.predict_mode():
        net(requests[0]).wait_to_read()   # resolves the deferred shapes
    n_params = sum(int(np.prod(p.shape)) for p in
                   net.collect_params().values())
    print("serve: TransformerLM %s, %d parameters (bfloat16), built and "
          "initialized in %.1f s" % (cfg, n_params, time.perf_counter() - t0),
          flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    request_ms, answers, all_logits = [], [], []
    with mx.autograd.predict_mode():
        for tokens_nd in requests:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = net(tokens_nd)
            last = mx.nd.slice_axis(logits, axis=1, begin=-1, end=None)
            ids = mx.nd.argmax(last, axis=-1).asnumpy()
            torch.cuda.synchronize()
            request_ms.append((time.perf_counter() - t0) * 1e3)
            answers.append(ids.reshape(-1).astype(np.int64))
            all_logits.append(logits)
    launches = {"flash_attention_fwd": flash_attention.launches}
    peak = torch.cuda.max_memory_allocated()
    for logits, ids in zip(all_logits, answers):
        check(logits.shape == (batch, cfg["seq_len"], cfg["vocab"]),
              "logits shape %s" % (logits.shape,))
        check(bool(torch.isfinite(logits._data).all()), "non-finite logits")
        check(ids.shape == (batch,) and ids.min() >= 0
              and ids.max() < cfg["vocab"], "token ids out of range: %s" % ids)
    del all_logits
    expected = n_requests * cfg["n_layers"]
    check(launches["flash_attention_fwd"] == expected,
          "flash_attention_fwd launched %d times on the serving path, "
          "expected %d" % (launches["flash_attention_fwd"], expected))
    tokens_per_request = batch * cfg["seq_len"]
    for i, (ms, ids) in enumerate(zip(request_ms, answers)):
        print("serve: request %d: %.3f ms, %.1f tokens/s, next tokens %s | %s"
              % (i, ms, tokens_per_request / ms * 1e3, ids.tolist(), card))
    print("serve: launches on the serving path %s; peak memory allocated "
          "%d bytes | %s" % (launches, peak, card), flush=True)
    d, f = cfg["d_model"], cfg["d_ffn"]
    gemm_flops = 2.0 * tokens_per_request * (
        cfg["n_layers"] * (4 * d * d + 2 * d * f) + d * cfg["vocab"])

    def request():
        with mx.autograd.predict_mode():
            logits = net(requests[0])
            mx.nd.argmax(mx.nd.slice_axis(logits, axis=1, begin=-1, end=None),
                         axis=-1).asnumpy()

    profile_device(request, "one request",
                   {"flash_attention_fwd": "flash_fwd"}, gemm_flops,
                   card)

    # phase 4f: the serving runtime on the same net (Server, CUDA graphs)
    runtime = serve_runtime(mx, net, card, rs)
    del net, requests
    gc.collect()

    # phase 4e: the same LM at head dim 512 (8 heads), route A
    wide_lm = serve_wide_lm(mx, card, rs, request_ms)

    # phase 4d: training through DataParallelTrainer, small and full width
    small_train_launches = train_small_lm(mx, card)
    train = train_full_lm(mx, card)

    # phase rtc: runtime-compiled user kernels, and the head trained by them
    rtc_entries = rtc_phase(mx, dev, card)

    # phase 5: kernel timing at the serving shape, then at D = 256
    (b, h, sq, sk, d), causal = ATTENTION_CASES[-1]
    qkv = [torch.randn(b, h, s_, d, generator=gen, device=dev).to(
        torch.bfloat16) for s_ in (sq, sk, sk)]
    bf16 = time_flash(*qkv, causal, card, torch)
    f16 = time_flash(*(t.half() for t in qkv), causal, card, torch)
    # the f32 route on the same values in f32: the split pass, then six bf16
    # products for each f32 product on the tensor cores
    q, k, v = (t.float() for t in qkv)
    del qkv
    scale = 1.0 / math.sqrt(d)
    lib = cuda_build.load("flash_attention")
    planes = (split_f32(q, scale), split_f32(k), split_f32(v))

    def split3():
        return split_f32(q, scale), split_f32(k), split_f32(v)

    def split3_plain():
        return (_split_f32_reference(q, scale), _split_f32_reference(k),
                _split_f32_reference(v))

    f32 = time_flash(q, k, v, causal, card, torch)
    f32["split_ms"] = cuda_ms(split3, 10, torch)
    f32["attention_ms"] = cuda_ms(lambda: _attention_f32_planes(
        *planes, q.shape, causal, lib), 10, torch)
    split_plain_ms = cuda_ms(split3_plain, 5, torch)
    del q, k, v, planes
    done = f32_tensor_work(b, h, sq, sk, d, causal)
    print("timing: flash_attention_fwd f32 route at (%d,%d,%d,%d): split pass "
          "%.4f ms, attention kernel %.4f ms; the kernel does %.3e flop of "
          "tensor work (64-key tiles across the diagonal), %.1f TFLOP/s; %d "
          "HGMMA in its SASS | %s"
          % (b, h, sq, d, f32["split_ms"], f32["attention_ms"], done,
             done / f32["attention_ms"] / 1e9, hgmma["f32"], card), flush=True)
    dp = -(-d // 8) * 8
    split_bytes = 4 * b * h * (sq + 2 * sk) * d + 3 * 2 * b * h * (
        sq + 2 * sk) * dp
    split_bound = split_bytes / H100_BYTES_PER_S * 1e3
    print("timing: split_f32 (q, k, v) at (%d,%d,%d,%d) f32: kernel_ms %.4f, "
          "bound_ms %.4f (bytes: %.3e bytes at 3.35 TB/s), plain_ms %.4f, "
          "library_ms null (no one PyTorch call splits); %.1f GB/s | %s"
          % (b, h, sq, d, f32["split_ms"], split_bound, split_bytes,
             split_plain_ms, split_bytes / f32["split_ms"] / 1e6, card),
          flush=True)
    # head dim 256: two output slices a block column on both routes
    (b2, h2, sq2, sk2, d2), causal2 = WIDE_TIMING
    q, k, v = (torch.randn(b2, h2, s_, d2, generator=gen, device=dev).to(
        torch.bfloat16) for s_ in (sq2, sk2, sk2))
    wide_bf16 = time_flash(q, k, v, causal2, card, torch)
    q, k, v = (t.float() for t in (q, k, v))
    wide_f32 = time_flash(q, k, v, causal2, card, torch)
    del q, k, v
    # head dim 512: the wide routes, the serving shape's work; route A in
    # bf16 and f16, route B in f32 (split pass and attention also alone)
    (b3, h3, sq3, sk3, d3), causal3 = WIDER_TIMING
    q, k, v = (torch.randn(b3, h3, s_, d3, generator=gen, device=dev).to(
        torch.bfloat16) for s_ in (sq3, sk3, sk3))
    wider_bf16 = time_flash(q, k, v, causal3, card, torch)
    wider_f16 = time_flash(q.half(), k.half(), v.half(), causal3, card, torch)
    q, k, v = (t.float() for t in (q, k, v))
    wider_f32 = time_flash(q, k, v, causal3, card, torch)
    scale3 = 1.0 / math.sqrt(d3)
    planes = (split_f32(q, scale3), split_f32(k), split_f32(v))
    wider_f32["split_ms"] = cuda_ms(lambda: (
        split_f32(q, scale3), split_f32(k), split_f32(v)), 10, torch)
    wider_f32["attention_ms"] = cuda_ms(lambda: _attention_f32_planes(
        *planes, q.shape, causal3, lib), 10, torch)
    del q, k, v, planes
    wide_floor = {}
    for route, products, t_ in (("wide16", (1, 2), wider_bf16),
                                ("wide_f32", (6, 6), wider_f32)):
        issued = wide_tensor_work(b3, h3, sq3, sk3, d3, causal3, products)
        wide_floor[route] = issued / H100_BF16_FLOPS * 1e3
        t_["floor_ms"] = wide_floor[route]
        t_["issued_flop"] = issued
        print("timing: %s at %s: the design issues %.3e flop of tensor work "
              "(its floor %.4f ms at 989 TFLOP/s), %.1f TFLOP/s of it in "
              "%.4f ms%s | %s"
              % (route, t_["shape"], issued, wide_floor[route],
                 issued / (t_.get("attention_ms", t_["ms"])) / 1e9,
                 t_.get("attention_ms", t_["ms"]),
                 " (the attention kernel alone; split pass %.4f ms)"
                 % t_["split_ms"] if "split_ms" in t_ else "", card),
              flush=True)
    backward = time_backward(gen, dev, card)
    serving = case_key(*ATTENTION_CASES[-1], "bfloat16")

    # phase 6: ResNet-50 v1 (no hand kernel on its path): the small net on
    # the card against the CPU, serving at full width, bench.py's training
    resnet = dict(small=resnet_small(mx, card), serve=resnet_serve(mx, card),
                  train=resnet_train(mx, card))

    # phase 7: the array surface on the card against the CPU, and
    # ResNet-50 v1 trained, checkpointed, resumed and served from its file
    arrays = dict(sweep=array_sweep(mx, card),
                  checkpoint=checkpoint_cycle(mx, card))

    # phase 8: the rest of the zoo and of the op library (no hand kernel)
    t8 = time.perf_counter()
    zoo = dict(parity=zoo_parity(mx, card), serve=zoo_serve(mx, card),
               train=alexnet_train(mx, card), oplib=op_library(mx, card),
               random=random_draws(mx, card))
    zoo["seconds"] = time.perf_counter() - t8
    print("zoo: phase 8 in %.1f s | %s" % (zoo["seconds"], card), flush=True)

    def entry(name, source, design, launches_, err, t,
              replaces="incubator_mxnet_tpu/ops/attention.py:56", **extra):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    design=design, launches=launches_, max_abs_err=err,
                    ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                    bound_by=t["bound_by"], library_ms=t["library_ms"],
                    shape=t["shape"], **extra)

    wide_key = case_key(*WIDE_CASES[-1], "%s")
    wider_key = case_key(*WIDER_CASES[-1], "%s")
    build_log = cuda_build.build_log("flash_attention")
    print("serve 4f: summary " + json.dumps(runtime, default=str),
          flush=True)
    print("train: summary " + json.dumps({
        k_: v_ for k_, v_ in train.items() if k_ != "losses"}), flush=True)
    print("backward: " + json.dumps(dict(backward, max_abs_err_cases=
                                         backward_errs)), flush=True)
    print("resnet: summary " + json.dumps(resnet, default=str), flush=True)
    print("arrays: summary " + json.dumps(arrays, default=str), flush=True)
    print("zoo: summary " + json.dumps(zoo, default=str), flush=True)
    print(json.dumps({"kernels": [
        entry("flash_attention_fwd", BF16_SOURCE, FLASH_DESIGN,
              launches["flash_attention_fwd"], errs[serving], bf16,
              max_abs_err_cases=errs, half_violations_cases=violations,
              tflops=bf16["tflops"],
              training_launches=train["launches"]["flash_attention_fwd"],
              serving_runtime_launches=runtime["launches"],
              serving_runtime_replay8_trace_launches=runtime["replay8"][
                  "flash_fwd_sm90_kernel"],
              training_steps=TRAIN_STEPS,
              small_training_launches=small_train_launches),
        entry("flash_attention_fwd_f16", BF16_SOURCE, F16_DESIGN,
              small_launches["f16_d128"],
              errs[case_key(*ATTENTION_CASES[-1], "float16")], f16,
              tflops=f16["tflops"]),
        entry("flash_attention_fwd_f32", F32_SOURCE, F32_DESIGN,
              small_launches["f32_d16"],
              errs[case_key(*ATTENTION_CASES[-1], "float32")], f32,
              split_ms=f32["split_ms"], attention_ms=f32["attention_ms"],
              bound_terms_ms=f32["bound_terms_ms"], hgmma=hgmma["f32"]),
        entry("split_f32", F32_SOURCE, "the f32 route's split pass (q, k, "
              "v: three calls)", 3 * small_launches["f32_d16"],
              split_errs[case_key(*ATTENTION_CASES[-1], "float32")],
              dict(ms=f32["split_ms"], plain_ms=split_plain_ms,
                   bound_ms=split_bound, bound_by="bytes", library_ms=None,
                   shape=f32["shape"])),
        entry("flash_attention_fwd_d256", BF16_SOURCE, WIDE_DESIGN,
              small_launches["bf16_d256"], errs[wide_key % "bfloat16"],
              wide_bf16, tflops=wide_bf16["tflops"]),
        entry("flash_attention_fwd_f32_d256", F32_SOURCE, F32_WIDE_DESIGN,
              small_launches["f32_d256"], errs[wide_key % "float32"],
              wide_f32, bound_terms_ms=wide_f32["bound_terms_ms"]),
        entry("flash_attention_fwd_wide16", WIDER_SOURCE, WIDE16_DESIGN,
              wide_lm["launches"], errs[wider_key % "bfloat16"],
              wider_bf16, tflops=wider_bf16["tflops"],
              floor_ms=wider_bf16["floor_ms"],
              hgmma={r: hgmma[r] for r in ("wide16_bf16", "wide16_f16")},
              ptxas=ptxas_resources(build_log, "flash_fwd_wide16_kernel"),
              small_lm_launches=small_launches["bf16_d320"],
              d512_request_ms=wide_lm["request_ms"],
              f16=dict(ms=wider_f16["ms"], plain_ms=wider_f16["plain_ms"],
                       bound_ms=wider_f16["bound_ms"],
                       library_ms=wider_f16["library_ms"],
                       max_abs_err=errs[wider_key % "float16"])),
        entry("flash_attention_fwd_wide_f32", WIDER_SOURCE, WIDE_F32_DESIGN,
              small_launches["f32_d320"], errs[wider_key % "float32"],
              wider_f32, floor_ms=wider_f32["floor_ms"],
              split_ms=wider_f32["split_ms"],
              attention_ms=wider_f32["attention_ms"],
              bound_terms_ms=wider_f32["bound_terms_ms"],
              hgmma=hgmma["wide_f32"],
              ptxas=ptxas_resources(build_log, "flash_fwd_wide_f32_kernel")),
        entry("flash_attention_bwd", BWD_SOURCE, BWD_DESIGN,
              train["launches"]["flash_attention_bwd"],
              max(backward_errs[case_key(*BACKWARD_CASES[0][:2], "bfloat16")
                                + "_" + n] for n in ("dq", "dk", "dv")),
              backward, replaces="incubator_mxnet_tpu/ops/attention.py:168",
              training_steps=TRAIN_STEPS, torch_ops_ms=backward[
                  "torch_ops_ms"], f16_ms=backward["f16_ms"],
              kernel_us=backward["kernel_us"],
              f16_plain_ms=backward["f16_plain_ms"],
              f16_library_ms=backward["f16_library_ms"],
              bound_terms_ms=backward["bound_terms_ms"],
              tflops=backward["tflops"], hgmma={
                  r: n for r, n in hgmma.items() if r.startswith("bwd")}),
    ] + rtc_entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
