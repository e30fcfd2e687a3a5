// Flash-attention forward for Hopper (sm_90a) on bfloat16 inputs: wgmma on
// the tensor cores, TMA loads into 128-byte-swizzled shared memory, and an
// f32-exact split of P.
//
// Replaces the TPU kernel incubator_mxnet_tpu/ops/attention.py:_flash_kernel
// (:56, launched by _flash_forward_pallas :98) on the bf16 route. float32
// inputs keep the CUDA-core kernel of flash_attention.cu, whose C entry point
// flash_attention_fwd picks the route by dtype. It computes the reference's
// function: o = softmax(q·kᵀ·scale)·v with every product in f32 (the TPU
// kernel's Precision.HIGHEST), masked logits at the finite -1e30 sentinel, the
// causal diagonal anchored at the end of the key axis (row i sees keys
// j <= i + Sk - Sq), a row that sees no key averaging V uniformly, and
// o = acc / max(l, 1e-20) rounded to bf16 once.
//
// Exactness on the tensor cores. S = Q·Kᵀ runs as bf16 wgmma into an f32
// accumulator: the product of two bf16 values is exact in f32, so only the
// order of the f32 sums differs from the reference. P is an f32 softmax, not
// a bf16 value, so O += P·V is split: P_hi = bf16(P), P_lo = bf16(P - P_hi),
// and O += P_hi·V + P_lo·V into one f32 accumulator. P_hi + P_lo carries P to
// about 2^-17 relative, where P rounded to bf16 once would carry it to 2^-9
// and break the per-element bound 2^-8·|ref| + 5e-5 at several percent of
// the elements (the negative control of tests/test_torch_attention.py).
// The scale is folded with log2(e) into exp2f, which moves the logits by f32
// ulps only.
//
// What bounds it on this card: at the serving shape (8, 32, 1024, 128)
// causal bf16 the work the mask lets through is 68.8 GFLOP on 268 MB of q, k,
// v and o, 0.080 ms to move the bytes at 3.35 TB/s (the bound) and 0.070 ms
// of bf16 tensor-core work at 989 TFLOP/s. The split adds one P·V product:
// 103 GFLOP of tensor work, a floor of 0.104 ms for this design.
//
// What the design does about the four causes that hold the CUDA-core kernel
// of flash_attention.cu back (PERF.md):
//  1. no tensor cores: both products are wgmma m64n64k16 (bf16 in, f32
//     accumulate); S with both operands read from shared memory through
//     descriptors, P·V with P in registers;
//  2. bf16 widened to f32 in shared memory: tiles stay bf16, 128 KB at
//     D = 128 (Q 32 KB, three stages of K and V at 16 KB each);
//  3. one shared load per 2.7 FMAs: no thread loads a Q, K or V element;
//     wgmma reads its shared operands itself;
//  4. no overlap: one producer warp keeps a 3-stage ring of K and V tiles in
//     flight by TMA, with completion on mbarriers (K and V of a stage on
//     barriers of their own); the consumers release a stage with one arrive
//     per warp. Inside a warpgroup, the S product of tile t is issued
//     together with the P·V product of tile t-1, and the softmax of tile t
//     runs while that P·V is still on the tensor cores.
//
// Layout. One block per (128 query rows, b·h), the heaviest causal tiles
// first; 288 threads: two consumer warpgroups of 64 query rows each and one
// producer warp. Nine warps put three on one SM quarter of 16K registers, so
// ptxas caps a thread at 168 registers; the D = 128 kernel uses 159, which
// leaves no room for Q in registers or 128-key tiles. Tiles are cut into panels of 64 bf16 columns (128 bytes): a
// head-dim bucket of 64 has one, of 128 two. TMA writes each panel with the
// 128-byte swizzle (16-byte chunk c of row r lands at chunk c ^ (r % 8)), and
// the wgmma descriptors read that layout: Q and K K-major (rows 128 bytes
// apart, 8-row groups 1024 bytes apart, a k16 step advancing the start by 32
// bytes inside the swizzled row), V MN-major through the transpose bit (a k16
// step is 16 key rows, 2048 bytes). The m64n64 f32 accumulator of S holds row
// g and g + 8 of each warp's 16 rows at columns 8j + 2t and 8j + 2t + 1 (g =
// lane / 4, t = lane % 4); packed in pairs into bf16x2 it is exactly wgmma's
// A-from-registers fragment for the next k16 step of P·V, so P never goes
// through shared memory. Ragged edges: TMA fills rows past Sq or Sk and
// columns past D with zeros; keys past Sk get -inf logits (p = 0). Key tiles
// past the last visible key of the block are skipped only when every row of
// the block sees some key, where skipping is exact. The kernel allocates
// nothing and runs on the caller's stream.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 128;                 // query rows per block
constexpr int kBlockN = 64;                  // keys per tile
constexpr int kPanel = 64;                   // bf16 columns per swizzled panel
constexpr int kConsumers = 256;              // two warpgroups
constexpr int kThreads = kConsumers + 32;    // and one producer warp
constexpr int kStages = 3;
constexpr int kQPanel = kBlockM * kPanel * 2;   // bytes
constexpr int kKVPanel = kBlockN * kPanel * 2;  // bytes
constexpr float kSentinel = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
// a wait on an mbarrier that outlasts this many clock cycles (~20 s) traps, so
// a broken pipeline ends the launch with an error instead of hanging the card
constexpr long long kWaitLimit = 1ll << 35;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kWaitLimit) __trap();
}

// TMA: one box of a 3-d tensor map (coordinates innermost first) into shared
// memory, completing `bytes` of the barrier's transaction count
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (each >> 4), layout type 1 (128B swizzle)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma uses across its issue or its wait.
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int NP>
__device__ __forceinline__ void fence_regs(float (&r)[NP][32]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) fence_regs(r[p]);
}

// d (64 x 64, f32) = A·B (+ d when accumulate), A 64 x 16 bf16 K-major and
// B 16 x 64 bf16 K-major, both from shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64, f32) += A·B, A 64 x 16 bf16 from registers (four bf16x2 per
// thread) and B 16 x 64 bf16 MN-major from shared memory (transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// S = Q·Kᵀ for this warpgroup's 64 rows and one tile of 64 keys, k16 steps
// of 32 bytes inside each 128-byte panel; one commit group
template <int NP>
__device__ __forceinline__ void issue_qk(float (&sacc)[32], uint32_t q_wg,
                                         uint32_t k_t) {
#pragma unroll
  for (int kk = 0; kk < 4 * NP; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss(sacc, smem_desc(q_wg + (kk / 4) * kQPanel + off, 16, 1024),
             smem_desc(k_t + (kk / 4) * kKVPanel + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P_hi·V + P_lo·V, one panel of V (64 output columns) at a time, a k16
// step being 16 key rows (2048 bytes); registers 4kk .. 4kk+3 of P are the
// A operand of step kk; one commit group
template <int NP>
__device__ __forceinline__ void issue_pv(float (&oacc)[NP][32],
                                         const uint32_t (&p_hi)[16],
                                         const uint32_t (&p_lo)[16],
                                         uint32_t v_t) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = smem_desc(v_t + p * kKVPanel + kk * 2048, 1024, 1024);
      wgmma_rs(oacc[p], &p_hi[4 * kk], dv);
      wgmma_rs(oacc[p], &p_lo[4 * kk], dv);
    }
  }
  wgmma_commit();
}

// the running max (log2 units) and this thread's share of the running sum of
// its two rows
struct RowState {
  float m0 = kSentinel, m1 = kSentinel, l0 = 0.f, l1 = 0.f;
};

// Scale one S tile into log2 units, mask it, and turn it into the tile's P
// against the new running max; alpha0/alpha1 rescale the earlier sums.
__device__ __forceinline__ void softmax_tile(float (&s)[32], int n0, bool edge,
                                             int sk, int r0, int offset,
                                             int causal, float scale_log2,
                                             int t4, RowState& st,
                                             float& alpha0, float& alpha1) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x0 = s[4 * j + e] * scale_log2;
      float x1 = s[4 * j + 2 + e] * scale_log2;
      if (edge) {
        const int col = n0 + 8 * j + 2 * t4 + e;
        if (col >= sk) {
          x0 = -CUDART_INF_F;  // past the key axis: p = 0
          x1 = -CUDART_INF_F;
        } else if (causal) {
          if (col > r0 + offset) x0 = kSentinel;
          if (col > r0 + 8 + offset) x1 = kSentinel;
        }
      }
      s[4 * j + e] = x0;
      s[4 * j + 2 + e] = x1;
    }
  }
  float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(st.m0, mx0);
  const float mn1 = fmaxf(st.m1, mx1);
  alpha0 = exp2f(st.m0 - mn0);
  alpha1 = exp2f(st.m1 - mn1);
  st.m0 = mn0;
  st.m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * j + e] = exp2f(s[4 * j + e] - mn0);
      s[4 * j + 2 + e] = exp2f(s[4 * j + 2 + e] - mn1);
      rs0 += s[4 * j + e];
      rs1 += s[4 * j + 2 + e];
    }
  }
  st.l0 = st.l0 * alpha0 + rs0;  // this thread's share; the quad sums last
  st.l1 = st.l1 * alpha1 + rs1;
}

template <int NP>
__device__ __forceinline__ void rescale(float (&oacc)[NP][32], float alpha0,
                                        float alpha1) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      oacc[p][4 * j] *= alpha0;
      oacc[p][4 * j + 1] *= alpha0;
      oacc[p][4 * j + 2] *= alpha1;
      oacc[p][4 * j + 3] *= alpha1;
    }
  }
}

// P = P_hi + P_lo, both packed in pairs into bf16x2: the accumulator pair
// (2i, 2i+1) is register i of wgmma's A-from-registers fragment
__device__ __forceinline__ void split_p(const float (&p)[32],
                                        uint32_t (&p_hi)[16],
                                        uint32_t (&p_lo)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const __nv_bfloat162 hi = __floats2bfloat162_rn(p[2 * i], p[2 * i + 1]);
    const float2 hf = __bfloat1622float2(hi);
    p_hi[i] = bf16x2_bits(hi);
    p_lo[i] = bf16x2_bits(
        __floats2bfloat162_rn(p[2 * i] - hf.x, p[2 * i + 1] - hf.y));
  }
}

// NP: 64-column panels of the head-dim bucket, 1 (D <= 64) or 2 (D <= 128)
template <int NP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      __nv_bfloat16* __restrict__ o, int sq, int sk, int d,
                      float scale, int causal) {
  constexpr int kKVTile = NP * kKVPanel;
  extern __shared__ uint8_t smem_raw[];
  // barriers: Q; then per stage K full, V full, stage empty
  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + NP * kQPanel;       // stage s at + s * kKVTile
  const uint32_t v_s = k_s + kStages * kKVTile;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_k = bar_q + 8;                  // + 8 * stage
  const uint32_t bar_v = bar_k + 8 * kStages;
  const uint32_t bar_empty = bar_v + 8 * kStages;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  // the heaviest causal tiles (last query rows) are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;
  const int q_rows = min(kBlockM, sq - q0);
  const int offset = sk - sq;  // row i sees keys j <= i + offset
  int n_end = sk;
  if (causal && q0 + offset >= 0) n_end = min(sk, q0 + q_rows + offset);
  const int n_tiles = (n_end + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // producer: Q once, then K and V tile by tile into the ring
    if (lane == 0) {
      mbar_expect_tx(bar_q, NP * kQPanel);
      for (int p = 0; p < NP; ++p)
        tma_load(q_s + p * kQPanel, &qmap, p * kPanel, q0, bh, bar_q);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(bar_empty + 8 * s, (t / kStages - 1) & 1);
        mbar_expect_tx(bar_k + 8 * s, kKVTile);
        for (int p = 0; p < NP; ++p)
          tma_load(k_s + s * kKVTile + p * kKVPanel, &kmap, p * kPanel,
                   t * kBlockN, bh, bar_k + 8 * s);
        mbar_expect_tx(bar_v + 8 * s, kKVTile);
        for (int p = 0; p < NP; ++p)
          tma_load(v_s + s * kKVTile + p * kKVPanel, &vmap, p * kPanel,
                   t * kBlockN, bh, bar_v + 8 * s);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows wg*64 .. wg*64+63 of the block; this
  // thread holds rows r0 and r0 + 8. The S product of tile t runs while the
  // P·V product of tile t-1 is still on the tensor cores, and the softmax of
  // tile t overlaps that P·V.
  const int wg = warp / 4;
  const int t4 = lane % 4;
  const int r0 = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_wg = q_s + wg * 64 * 128;  // its 64 rows of each Q panel
  const auto edge = [&](int n0) {  // does the tile need the per-key mask?
    return n0 + kBlockN > sk || (causal && n0 + kBlockN - 1 > q0 + offset);
  };

  float oacc[NP][32];
  float sacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sacc[i] = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) oacc[p][i] = 0.f;
  }
  uint32_t p_hi[16], p_lo[16];
  RowState rows;
  float alpha0, alpha1;

  mbar_wait(bar_q, 0);
  mbar_wait(bar_k, 0);
  fence_regs(sacc);
  wgmma_fence();
  issue_qk<NP>(sacc, q_wg, k_s);
  wgmma_wait<0>();
  fence_regs(sacc);
  softmax_tile(sacc, 0, edge(0), sk, r0, offset, causal, scale_log2, t4, rows,
               alpha0, alpha1);
  split_p(sacc, p_hi, p_lo);  // O is still 0: nothing to rescale

  for (int t = 1; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int sp = (t - 1) % kStages;
    mbar_wait(bar_k + 8 * s, (t / kStages) & 1);
    mbar_wait(bar_v + 8 * sp, ((t - 1) / kStages) & 1);
    fence_regs(sacc);
    fence_regs(oacc);
    fence_regs(p_hi);
    fence_regs(p_lo);
    wgmma_fence();
    issue_qk<NP>(sacc, q_wg, k_s + s * kKVTile);
    issue_pv<NP>(oacc, p_hi, p_lo, v_s + sp * kKVTile);
    wgmma_wait<1>();  // S of tile t is in; P·V of tile t-1 may still run
    fence_regs(sacc);
    softmax_tile(sacc, t * kBlockN, edge(t * kBlockN), sk, r0, offset, causal,
                 scale_log2, t4, rows, alpha0, alpha1);
    wgmma_wait<0>();
    fence_regs(oacc);
    fence_regs(p_hi);
    fence_regs(p_lo);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * sp);  // stage of tile t-1
    rescale(oacc, alpha0, alpha1);
    split_p(sacc, p_hi, p_lo);
  }
  // the last tile's P·V (its stage is never waited for again)
  const int sl = (n_tiles - 1) % kStages;
  mbar_wait(bar_v + 8 * sl, ((n_tiles - 1) / kStages) & 1);
  fence_regs(oacc);
  fence_regs(p_hi);
  fence_regs(p_lo);
  wgmma_fence();
  issue_pv<NP>(oacc, p_hi, p_lo, v_s + sl * kKVTile);
  wgmma_wait<0>();
  fence_regs(oacc);
  fence_regs(p_hi);
  fence_regs(p_lo);

  // o = acc / max(l, 1e-20); d is a multiple of 8, so a column pair is whole
  const int r1 = r0 + 8;
  float l0 = rows.l0, l1 = rows.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-20f);
  const float den1 = fmaxf(l1, 1e-20f);
  __nv_bfloat16* og = o + (long long)bh * sq * d;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = p * kPanel + 8 * j + 2 * t4;
      if (col >= d) continue;
      if (r0 < sq)
        *reinterpret_cast<__nv_bfloat162*>(og + (long long)r0 * d + col) =
            __floats2bfloat162_rn(oacc[p][4 * j] / den0,
                                  oacc[p][4 * j + 1] / den0);
      if (r1 < sq)
        *reinterpret_cast<__nv_bfloat162*>(og + (long long)r1 * d + col) =
            __floats2bfloat162_rn(oacc[p][4 * j + 2] / den1,
                                  oacc[p][4 * j + 3] / den1);
    }
  }
}

// cuTensorMapEncodeTiled, taken from the driver through the runtime so that
// the library needs no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A (batch_heads, rows, d) bf16 tensor as a 3-d TMA map whose box is one
// panel of 64 columns by box_rows rows of one (batch, head): rows past `rows`
// and columns past d read as zeros.
bool make_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr,
              int batch_heads, int rows, int d, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)batch_heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kPanel, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NP>
cudaError_t launch_np(const CUtensorMap& qm, const CUtensorMap& km,
                      const CUtensorMap& vm, void* o, int batch_heads, int sq,
                      int sk, int d, float scale, int causal,
                      cudaStream_t stream) {
  const int smem = NP * (kQPanel + 2 * kStages * kKVPanel) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch_heads, (sq + kBlockM - 1) / kBlockM);
  flash_fwd_sm90_kernel<NP><<<grid, kThreads, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), sq, sk, d, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// The bf16 route of flash_attention_fwd (flash_attention.cu). q, o:
// (batch_heads, sq, d); k, v: (batch_heads, sk, d); contiguous bf16 with
// 16-byte aligned bases; d a multiple of 8 up to 128 (the TMA row stride is
// a multiple of 16 bytes).
cudaError_t flash_attention_sm90_bf16(const void* q, const void* k,
                                      const void* v, void* o,
                                      int batch_heads, int sq, int sk, int d,
                                      float scale, int causal,
                                      cudaStream_t stream) {
  if (d % 8 != 0 || d > 128 || (sq + kBlockM - 1) / kBlockM > 65535 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0)
    return cudaErrorInvalidValue;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  if (!make_map(encode, &qm, q, batch_heads, sq, d, kBlockM) ||
      !make_map(encode, &km, k, batch_heads, sk, d, kBlockN) ||
      !make_map(encode, &vm, v, batch_heads, sk, d, kBlockN))
    return cudaErrorInvalidValue;
  if (d <= 64)
    return launch_np<1>(qm, km, vm, o, batch_heads, sq, sk, d, scale, causal,
                        stream);
  return launch_np<2>(qm, km, vm, o, batch_heads, sq, sk, d, scale, causal,
                      stream);
}
