#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card: serve the decoder-transformer LM,
then train its vocabulary head through runtime-compiled user kernels.

Run from the root of a checkout, with one CUDA card and the CUDA toolkit:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:

1. device  — the card's name and power limit (nvidia-smi), or exit non-zero
             when torch sees no CUDA device;
2. build   — every hand-written kernel of the port, from ``csrc/`` with nvcc
             (one per source, all at once), with ptxas's report (registers,
             shared memory, spills) and the count of HGMMA (wgmma)
             instructions in the flash library's SASS and in the f32 route's
             kernel, neither of which may be 0: both routes run on the tensor
             cores;
3. kernel  — each kernel against its plain PyTorch version on the card, at
             the shapes of its tests and of the serving path, in f32 and bf16;
             bf16 also element by element (2^-8·|ref| + 5e-5); the f32
             route's split pass bit for bit;
4. serve   — a small LM (f32, so the f32 route, whose launches are counted
             and must not be 0) on the card against the same weights on the
             CPU, then
             the LM of bench_transformer.py at its full width (vocab 16384,
             d_model 4096, 32 heads, d_ffn 16384, 4 layers, seq 1024; random
             weights from a seed) answering 4 requests of 8 prompts x 1024
             tokens with each prompt's greedy next token; the kernels' launch
             counts are zeroed just before and read just after; then one more
             request under torch.profiler for its device time by kernel;
4c. rtc   — the user kernels of RTC_SOURCE compiled by the port's NVRTC
             binding (mx.rtc.CudaModule, sm_90a); axpy against 2x + y
             (exact); 3 SGD steps of the LM's vocabulary head at full width
             (8192 tokens x 4096 -> 16384, f32) through FullyConnected, the
             custom op rtc_softmax (softmax_fwd, softmax_bwd) and
             sgd_update, held step by step against the same steps with the
             plain versions, launch counts zeroed just before and read just
             after; each kernel's time, bound, plain and library times at
             the head shape; the host cost of one launch;
5. timing  — the flash kernel at the serving shape: its time, its bound, the
             plain version's time and one PyTorch library call's time, in
             bf16 (the serving path) and on the f32 route (with the split
             pass and the attention kernel also timed alone);
6. one JSON ``kernels`` line, then the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package.
"""
import json
import math
import os
import re
import shutil
import subprocess
import sys
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
# kernel vs plain, max abs error. f32: both sum the same products in f32 in
# other orders (|o| <= ~4, D <= 128, Sk <= 1024), a few ulp of 4, far below
# 1e-4. bf16: the plain result is computed in f32 from the same bf16 inputs,
# and the kernel rounds its f32 result to bf16 once: half an ulp of bf16 at
# |o| < 4 is 7.8e-3, within 2e-2.
TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}
# bf16, element by element against the f32 plain result: one bf16 rounding
# (2^-9 relative) and as much again for the f32 arithmetic. P rounded to
# bf16 once before P·V breaks it at several percent of the elements (the
# negative control of tests/test_torch_attention.py); the kernel's split
# P_hi + P_lo must break it nowhere.
BF16_REL, BF16_ABS = 2.0 ** -8, 5e-5
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
F32_SOURCE = "incubator_mxnet_tpu_torch/csrc/flash_attention_f32_sm90.cu"
SOFTMAX_DESIGN = ("one block per row; where c % 4 == 0 and the row fits, the "
                  "row read once as float4 into registers (SOFTMAX_VEC a "
                  "thread), block max, expf in registers, block sum, float4 "
                  "stores of e / s; else a three-pass loop in the same kernel")


# The rtc phase's user kernels: CUDA C that the port compiles at run time
# with NVRTC for sm_90a (mx.rtc.CudaModule), the counterpart of the JAX
# build's runtime Pallas kernels (incubator_mxnet_tpu/rtc.py:86), whose one
# user kernel is the axpy of tests/test_rtc_resume.py.  softmax_fwd and
# softmax_bwd are the forward and backward of the custom op "rtc_softmax",
# a softmax output with the gradient p - onehot(label) (upstream MXNet's
# example/numpy-ops/custom_softmax_rtc.py).  Each is bound by memory bytes
# on this card: one pass of reads and writes at 3.35 TB/s.  axpy and
# softmax_bwd are the simple design: one thread per element.  softmax_fwd
# takes one block per row and reads the row from memory once: where c % 4 ==
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

extern "C" __global__ void axpy(const float *x, const float *y, float *o,
                                int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) o[i] = 2.0f * x[i] + y[i];
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

// dz = p - onehot(label) over each row of c columns; one block per row
extern "C" __global__ void softmax_bwd(const float *p, const float *label,
                                       float *dz, int c) {
    const size_t base = (size_t)blockIdx.x * c;
    const int l = (int)label[blockIdx.x];
    for (int j = threadIdx.x; j < c; j += blockDim.x)
        dz[base + j] = p[base + j] - (j == l ? 1.0f : 0.0f);
}

extern "C" __global__ void noop() {}
"""
RTC_SIGNATURES = {
    "axpy": "const float *x, const float *y, float *o, int n",
    "softmax_fwd": "const float *z, float *p, int c",
    "softmax_bwd": "const float *p, const float *label, float *dz, int c",
    "noop": "",
}
RTC_KERNELS = ("axpy", "softmax_fwd", "softmax_bwd")
SOFTMAX_THREADS = 512
# float4 a thread holds on softmax_fwd's one-read path (RTC_SOURCE's own)
SOFTMAX_VEC = int(re.search(r"#define SOFTMAX_VEC (\d+)", RTC_SOURCE).group(1))
SOFTMAX_MAX_THREADS = 1024
AXPY_THREADS = 256
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
        block, shared = (softmax_geometry(c)[:2] if name == "softmax_fwd"
                         else (SOFTMAX_THREADS, 0))
        kernels[name].launch(args + [dst, c], dst.context, (rows,), (block,),
                             shared)

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


GEMM_NAMES = ("gemm", "xmma", "cutlass", "nvjet")


def profile_device(run, what, kernel_groups, gemm_flops, card):
    """Where one call of ``run`` spends its time: device time by kernel
    (torch.profiler, CUPTI), grouped by ``kernel_groups`` ({group: kernel
    name substring}), GEMMs and the rest, against the call's wall time; the
    remainder is the device's idle share.  ``gemm_flops`` is the call's
    matrix-product work, for the GEMMs' achieved rate."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0) or 0
        if str(evt.device_type).endswith("CUDA") and us > 0:
            kernels[evt.key] = (us, evt.count)
    if not kernels:
        print("profile: torch.profiler recorded no device time: not measured")
        return
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
          "us, idle share %.4f | %s" % (what, wall_us, busy,
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


def host_us(fn, reps):
    """Mean host µs of ``fn()`` over ``reps`` calls (enqueue cost: the
    device is synchronized only after the loop), after 10 warm-up calls."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


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
        axpy.launch([x, y, o, x.size], ctx, (-(-x.size // AXPY_THREADS),),
                    (AXPY_THREADS,))
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
    grid, block = (rows,), (SOFTMAX_THREADS,)
    fwd_block, fwd_shared, one_read = softmax_geometry(c)
    check(one_read, "softmax_fwd at c = %d does not take its one-read path"
          % c)
    fwd.launch([Z, P, c], ctx, grid, (fwd_block,), fwd_shared)
    bwd.launch([P, lab, DZ, c], ctx, grid, block)
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
        "softmax_bwd": (lambda: bwd.launch([P, lab, DZ, c], ctx, grid, block),
                        lambda: softmax_bwd_plain(P._data, lab._data),
                        lambda: torch.scatter(P._data, 1, idx, -1.0,
                                              reduce="add"),
                        "torch.scatter(p, 1, label, -1.0, reduce='add')"),
        "axpy": (lambda: axpy.launch([x, y, o, n], ctx,
                                     (-(-n // AXPY_THREADS),),
                                     (AXPY_THREADS,)),
                 lambda: 2 * xs + ys,
                 lambda: torch.add(ys, xs, alpha=2),
                 "torch.add(y, x, alpha=2)"),
    }
    entries = []
    for name in RTC_KERNELS:
        kern, plain, library, library_name = timed[name]
        kernel_ms = cuda_ms(kern, 20, torch)
        plain_ms = cuda_ms(plain, 20, torch)
        library_ms = cuda_ms(library, 20, torch)
        flops, nbytes = work[name]
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_F32_CUDA_CORE_FLOPS * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        shape = "(%d,)" % n if name == "axpy" else "(%d, %d)" % (rows, c)
        print("timing: rtc %s at %s f32: kernel_ms %.4f, bound_ms %.4f (%s: "
              "%.3e bytes at 3.35 TB/s, %.3e flop at 67 TFLOP/s f32), plain_ms "
              "%.4f, library_ms %s; %.1f GB/s | %s" % (
                  name, shape, kernel_ms, bound_ms, bound_by, nbytes, flops,
                  plain_ms, "%.4f (%s)" % (library_ms, library_name),
                  nbytes / kernel_ms / 1e6, card), flush=True)
        entries.append({
            "name": name, "route": "cuda", "compiler": "nvrtc",
            "source": "chip_smoke.py",
            "replaces": "incubator_mxnet_tpu/rtc.py:86",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms})
        if name == "softmax_fwd":
            entries[-1]["design"] = SOFTMAX_DESIGN
            entries[-1]["block"] = fwd_block
        check(launches[name] > 0, "%s was not launched on its path" % name)

    noop = kernels["noop"]
    small = torch.zeros(1, device=dev)
    launch_us = host_us(lambda: noop.launch([], ctx, (1,), (1,)), 1000)
    torch_us = host_us(lambda: torch.neg(small), 1000)
    print("rtc: host cost of one CudaKernel.launch (empty kernel) %.2f us, of "
          "one torch.neg on a 1-element tensor %.2f us (mean of 1000) | %s"
          % (launch_us, torch_us, card), flush=True)
    return entries


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
    for name in cuda_build.KERNELS:
        for line in cuda_build.build_log(name).splitlines():
            if any(t in line for t in ("entry function", "registers",
                                       "spill", "wgmma")):
                print("  ptxas %s: %s" % (name, line.strip()))
    flash_lib = cuda_build.lib_path("flash_attention")
    hgmma = sass_count(flash_lib, "HGMMA")
    hgmma_f32 = sass_count(flash_lib, "HGMMA", "flash_fwd_f32_sm90_kernel")
    print("build: %d HGMMA instructions in the flash_attention library's "
          "SASS, %d of them in the f32 route's kernel (cuobjdump -sass)"
          % (hgmma, hgmma_f32), flush=True)
    check(hgmma > hgmma_f32, "no HGMMA in the bf16 route's kernel: it does "
          "not run on the tensor cores")
    check(hgmma_f32 > 0, "no HGMMA in flash_fwd_f32_sm90_kernel: the f32 "
          "route does not run on the tensor cores")

    # phase 3: each kernel against its plain version on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("kernel: plain versions run with TF32 off "
          "(torch.backends.cuda.matmul.allow_tf32 = False)", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    errs, violations = {}, {}
    for (b, h, sq, sk, d), causal in ATTENTION_CASES:
        for dtype in (torch.float32, torch.bfloat16):
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
            if dtype == torch.bfloat16:
                bad = int(((out.float() - ref).abs() >
                           BF16_REL * ref.abs() + BF16_ABS).sum().item())
                violations[key] = bad
                extra = ", %d of %d elements outside 2^-8·|ref| + 5e-5" % (
                    bad, ref.numel())
            print("kernel flash_attention_fwd %-32s max_abs_err %.3e "
                  "(bound %.0e)%s" % (key, err, tol, extra), flush=True)
            check(err <= tol, "flash_attention_fwd %s: max_abs_err %.3e > %.0e"
                  % (key, err, tol))
            check(not violations.get(key), "flash_attention_fwd %s: %d "
                  "elements break the per-element bf16 bound"
                  % (key, violations.get(key, 0)))
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

    # phase 4a: a small LM on the card against the same weights on the CPU,
    # the f32 route's path: its launch counts zeroed just before, read after
    small = dict(vocab=97, d_model=64, n_heads=4, d_ffn=256, n_layers=2,
                 seq_len=32)
    rs = np.random.RandomState(SEED)
    tokens = rs.randint(0, small["vocab"], (2, small["seq_len"]))
    with mx.cpu():
        cpu_net = TransformerLM(**small)
        cpu_net.initialize(HostXavier(SEED))
        cpu_logits = cpu_net(mx.nd.array(tokens)).asnumpy()
    gpu_net = TransformerLM(**small)
    load_numpy_params(gpu_net, {n: p.data().asnumpy() for n, p in
                                cpu_net.collect_params().items()}, mx.gpu(0))
    small_tokens = mx.nd.array(tokens, ctx=mx.gpu(0))
    torch.cuda.synchronize()
    flash_attention.f32_launches = split_f32.launches = 0
    with mx.autograd.predict_mode():
        gpu_logits = gpu_net(small_tokens).asnumpy()
    f32_launches = {"flash_attention_fwd_f32": flash_attention.f32_launches,
                    "split_f32": split_f32.launches}
    del small_tokens
    small_err = float(np.abs(gpu_logits - cpu_logits).max())
    print("serve: small LM %s, card vs CPU logits max_abs_err %.3e (bound "
          "1e-4); f32 route launches %s" % (small, small_err, f32_launches),
          flush=True)
    check(f32_launches["flash_attention_fwd_f32"] > 0,
          "the small LM did not launch the f32 route")
    check(f32_launches["split_f32"] == 3 * f32_launches[
        "flash_attention_fwd_f32"], "split_f32 launched %d times for %d f32 "
          "attentions" % (f32_launches["split_f32"],
                          f32_launches["flash_attention_fwd_f32"]))
    check(small_err <= 1e-4, "small LM: card and CPU disagree")
    check(np.array_equal(gpu_logits[:, -1].argmax(-1),
                         cpu_logits[:, -1].argmax(-1)),
          "small LM: greedy tokens differ between card and CPU")

    # phase 4b: the full-width LM serving 4 requests
    cfg = dict(vocab=16384, d_model=4096, n_heads=32, d_ffn=16384, n_layers=4,
               seq_len=1024)
    batch, n_requests = 8, 4
    t0 = time.perf_counter()
    net = TransformerLM(**cfg)
    net.pos_embed.init = None      # HostXavier for every weight, as the bench
    net.initialize(HostXavier(SEED), ctx=mx.gpu(0))
    net.cast("bfloat16")
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

    # phase rtc: runtime-compiled user kernels, and the head trained by them
    rtc_entries = rtc_phase(mx, dev, card)

    # phase 5: kernel timing at the serving shape
    (b, h, sq, sk, d), causal = ATTENTION_CASES[-1]
    q = torch.randn(b, h, sq, d, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(b, h, sk, d, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(b, h, sk, d, generator=gen, device=dev).to(torch.bfloat16)
    kernel_ms = cuda_ms(lambda: flash_attention(q, k, v, causal), 20, torch)
    plain_ms = cuda_ms(lambda: _attention_reference(q, k, v, causal), 5, torch)
    mask = torch.ones(sq, sk, dtype=torch.bool, device=dev).tril(sk - sq)
    scale = 1.0 / math.sqrt(d)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=scale),
                         10, torch)
    flops, nbytes = attention_work(b, h, sq, sk, d, causal, 2)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    tflops = flops / kernel_ms / 1e9
    print("timing: flash_attention_fwd at (%d,%d,%d,%d) causal bf16: "
          "kernel_ms %.4f, bound_ms %.4f (%s: %.3e bytes at 3.35 TB/s, "
          "%.3e flop at 989 TFLOP/s bf16), plain_ms %.4f, library_ms %.4f "
          "(scaled_dot_product_attention with a bottom-right bool mask); "
          "the split's tensor work %.3e flop, floor %.4f ms; kernel at %.1f "
          "TFLOP/s of the needed work | %s"
          % (b, h, sq, d, kernel_ms, bound_ms, bound_by, nbytes, flops,
             plain_ms, library_ms, 1.5 * flops,
             1.5 * flops / H100_BF16_FLOPS * 1e3, tflops, card), flush=True)
    # the f32 route on the same values in f32: the split pass, then six bf16
    # products for each f32 product on the tensor cores
    q, k, v = q.float(), k.float(), v.float()
    lib = cuda_build.load("flash_attention")
    planes = (split_f32(q, scale), split_f32(k), split_f32(v))

    def split3():
        return split_f32(q, scale), split_f32(k), split_f32(v)

    def split3_plain():
        return (_split_f32_reference(q, scale), _split_f32_reference(k),
                _split_f32_reference(v))

    f32 = {"ms": cuda_ms(lambda: flash_attention(q, k, v, causal), 10, torch),
           "split_ms": cuda_ms(split3, 10, torch),
           "attention_ms": cuda_ms(lambda: _attention_f32_planes(
               *planes, q.shape, causal, lib), 10, torch),
           "plain_ms": cuda_ms(lambda: _attention_reference(q, k, v, causal),
                               5, torch),
           "library_ms": cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask,
                                              scale=scale), 5, torch)}
    split_plain_ms = cuda_ms(split3_plain, 5, torch)
    del q, k, v, planes
    f32_bytes = attention_work(b, h, sq, sk, d, causal, 4)[1]
    # the least time of f32-exact work: the f32 operations on the CUDA cores,
    # or the split's six bf16 products on the tensor cores, whichever is less
    split_flops = 6 * flops
    f32_t = {"bytes": f32_bytes / H100_BYTES_PER_S * 1e3,
             "cuda_core": flops / H100_F32_CUDA_CORE_FLOPS * 1e3,
             "split_tensor": split_flops / H100_BF16_FLOPS * 1e3}
    ops_ms = min(f32_t["cuda_core"], f32_t["split_tensor"])
    f32["bound_ms"] = max(f32_t["bytes"], ops_ms)
    f32["bound_by"] = "bytes" if f32_t["bytes"] >= ops_ms else "operations"
    done = f32_tensor_work(b, h, sq, sk, d, causal)
    print("timing: flash_attention_fwd f32 route at (%d,%d,%d,%d) causal f32 "
          "(%s; %s): kernel_ms %.4f (split pass %.4f, attention kernel %.4f), "
          "bound_ms %.4f (%s: the split's tensor work %.3e flop at 989 "
          "TFLOP/s bf16, floor %.4f ms; f32 operations %.3e flop at 67 TFLOP/s, %.4f "
          "ms; %.3e bytes at 3.35 TB/s, %.4f ms), plain_ms %.4f, library_ms "
          "%.4f (scaled_dot_product_attention, f32, TF32 off); the kernel "
          "does %.3e flop of tensor work (64-key tiles across the diagonal), "
          "%.1f TFLOP/s; %d HGMMA in its SASS | %s"
          % (b, h, sq, d, F32_DESIGN, F32_SOURCE, f32["ms"], f32["split_ms"],
             f32["attention_ms"], f32["bound_ms"], f32["bound_by"],
             split_flops, f32_t["split_tensor"], flops, f32_t["cuda_core"],
             f32_bytes, f32_t["bytes"], f32["plain_ms"], f32["library_ms"],
             done, done / f32["attention_ms"] / 1e9, hgmma_f32, card),
          flush=True)
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
    serving_f32 = case_key(*ATTENTION_CASES[-1], "float32")

    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "incubator_mxnet_tpu_torch/csrc/flash_attention_sm90.cu",
        "replaces": "incubator_mxnet_tpu/ops/attention.py:56",
        "design": FLASH_DESIGN,
        "launches": launches["flash_attention_fwd"],
        "max_abs_err": errs[case_key(*ATTENTION_CASES[-1], "bfloat16")],
        "max_abs_err_cases": errs,
        "bf16_violations_cases": violations,
        "tflops": tflops,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }, {
        "name": "flash_attention_fwd_f32",
        "route": "cuda",
        "source": F32_SOURCE,
        "replaces": "incubator_mxnet_tpu/ops/attention.py:56",
        "design": F32_DESIGN,
        "launches": f32_launches["flash_attention_fwd_f32"],
        "max_abs_err": errs[serving_f32],
        "ms": f32["ms"],
        "split_ms": f32["split_ms"],
        "attention_ms": f32["attention_ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "bound_terms_ms": f32_t,
        "hgmma": hgmma_f32,
        "library_ms": f32["library_ms"],
    }, {
        "name": "split_f32",
        "route": "cuda",
        "source": F32_SOURCE,
        "replaces": "incubator_mxnet_tpu/ops/attention.py:56",
        "timed": "the f32 route's three calls (q, k, v)",
        "launches": f32_launches["split_f32"],
        "max_abs_err": split_errs[serving_f32],
        "ms": f32["split_ms"],
        "plain_ms": split_plain_ms,
        "bound_ms": split_bound,
        "bound_by": "bytes",
        "library_ms": None,
    }] + rtc_entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
