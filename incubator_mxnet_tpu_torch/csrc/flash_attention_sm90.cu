// Flash-attention forward for Hopper (sm_90a) on 16-bit inputs, bfloat16 or
// float16: wgmma on the tensor cores, TMA loads into 128-byte-swizzled shared
// memory, and an f32-exact split of P.
//
// Replaces the TPU kernel incubator_mxnet_tpu/ops/attention.py:_flash_kernel
// (:56, launched by _flash_forward_pallas :98) on the bf16 and f16 routes;
// float32 inputs, and any mix of dtypes, take flash_attention_f32_sm90.cu,
// and flash_attention.cu holds the routes' C entry points. The helpers the
// kernels share are in flash_sm90_common.cuh. It computes the reference's
// function: o = softmax(q·kᵀ·scale)·v with every product in f32 (the TPU
// kernel's Precision.HIGHEST), masked logits at the finite -1e30 sentinel, the
// causal diagonal anchored at the end of the key axis (row i sees keys
// j <= i + Sk - Sq), a row that sees no key averaging V uniformly, and
// o = acc / max(l, 1e-20) rounded to the input's type once.
//
// Exactness on the tensor cores. S = Q·Kᵀ runs as bf16 (f16) wgmma into an
// f32 accumulator: the product of two bf16 (8-bit significand) or two f16
// (11-bit) values is exact in f32, so only the order of the f32 sums differs
// from the reference. P is an f32 softmax, not a 16-bit value, so
// O += P·V is split: P_hi = T(P), P_lo = T(P - P_hi), and
// O += P_hi·V + P_lo·V into one f32 accumulator. P_hi + P_lo carries P to
// about 2^-17 relative in bf16 and 2^-22 in f16 (down to f16's subnormal
// step, 2^-24 absolute), where P rounded to the type once would carry it to
// 2^-9 (2^-12) and break the per-element bound 2^-8·|ref| + 5e-5
// (2^-11·|ref| + 5e-5 in f16) at many elements (the negative controls of
// tests/test_torch_attention.py). The scale is folded with log2(e) into
// exp2f, which moves the logits by f32 ulps only.
//
// What bounds it on this card: at the serving shape (8, 32, 1024, 128) causal
// bf16 the work the mask lets through is 68.8 GFLOP on 268 MB of q, k, v and
// o, 0.080 ms to move the bytes at 3.35 TB/s (the bound) and 0.070 ms of bf16
// tensor-core work at 989 TFLOP/s (f16 the same). The split adds one P·V
// product: 103 GFLOP of tensor work, a floor of 0.104 ms for this design.
//
// What the design does about the four causes that held the port's first,
// CUDA-core kernel back (PERF.md):
//  1. no tensor cores: both products are wgmma m64n64k16 (16-bit in, f32
//     accumulate); S with both operands read from shared memory through
//     descriptors, P·V with P in registers;
//  2. 16-bit values widened to f32 in shared memory: tiles stay 16-bit,
//     128 KB at D = 128 (Q 32 KB, three stages of K and V at 16 KB each);
//  3. one shared load per 2.7 FMAs: no thread loads a Q, K or V element;
//     wgmma reads its shared operands itself;
//  4. no overlap: one producer warp keeps a 3-stage ring of K and V tiles in
//     flight by TMA, with completion on mbarriers (K and V of a stage on
//     barriers of their own); the consumers release a stage with one arrive
//     per warp. Inside a warpgroup, the S product of tile t is issued
//     together with the P·V product of tile t-1, and the softmax of tile t
//     runs while that P·V is still on the tensor cores.
//
// Layout. One block per (128 query rows, b·h, slice of output columns), the
// heaviest causal tiles first; 288 threads: two consumer warpgroups of 64
// query rows each and one producer warp. Nine warps put three on one SM
// quarter of 16K registers, so ptxas caps a thread at 168 registers; the
// D = 128 kernel uses 159, which leaves no room for Q in registers or
// 128-key tiles. Tiles are cut into panels of 64 columns (128 bytes): Q and K
// hold NQK panels (the head dim rounded up to 64, 128 or 256), V and the O
// accumulator NO panels of one output slice. Head dims up to 128 are one
// slice (NO = NQK). Head dims 129-256 are two slices of 128 columns, one per
// block (grid z): S needs all of D, but O does not, so each block computes S
// over the full D and accumulates one slice of O, which keeps O at 64 f32
// registers a thread, as at D = 128. Shared memory at D = 256: Q 64 KB, a K
// tile 32 KB and a V slice 16 KB, three stages 144 KB, 208 KB in all of the
// 227 KB a block may have (D <= 192: three panels, 168 KB). TMA writes each
// panel with the
// 128-byte swizzle (16-byte chunk c of row r lands at chunk c ^ (r % 8)), and
// the wgmma descriptors read that layout: Q and K K-major (rows 128 bytes
// apart, 8-row groups 1024 bytes apart, a k16 step advancing the start by 32
// bytes inside the swizzled row), V MN-major through the transpose bit (a k16
// step is 16 key rows, 2048 bytes). The m64n64 f32 accumulator of S holds row
// g and g + 8 of each warp's 16 rows at columns 8j + 2t and 8j + 2t + 1 (g =
// lane / 4, t = lane % 4); packed in pairs into T x2 it is exactly wgmma's
// A-from-registers fragment for the next k16 step of P·V, so P never goes
// through shared memory. Ragged edges: TMA fills rows past Sq or Sk and
// columns past D with zeros; keys past Sk get -inf logits (p = 0). Key tiles
// past the last visible key of the block are skipped only when every row of
// the block sees some key, where skipping is exact. Given a stats pointer
// (training, head dims up to 128), it also writes each row's m and 1 / l for
// the backward kernel (flash_attention_bwd_sm90.cu), which so needs no pass
// of its own over Q·Kᵀ; serving passes null. The kernel allocates nothing
// and runs on the caller's stream.

#include "flash_sm90_common.cuh"

namespace {

constexpr int kStages = 3;

// T: __nv_bfloat16 or __half. NQK: 64-column panels of Q and K, the head
// dim rounded up to a multiple of 64 (1 to 4); NO: panels of V and O in one
// output slice, 1 or 2. stats: null, or (for the backward kernel, at head
// dims up to 128, one output slice) each row's (m in log2 units,
// 1 / max(l, 1e-20), 0, 0) into (batch_heads, sq_pad) float4, zeros past sq.
template <typename T, int NQK, int NO>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      T* __restrict__ o, int sq, int sk, int d,
                      float scale, int causal, float4* __restrict__ stats,
                      int sq_pad) {
  constexpr int kKTile = NQK * kKVPanel;
  constexpr int kVTile = NO * kKVPanel;
  extern __shared__ uint8_t smem_raw[];
  // barriers: Q; then per stage K full, V full, stage empty
  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + NQK * kQPanel;      // stage s at + s * kKTile
  const uint32_t v_s = k_s + kStages * kKTile;   // stage s at + s * kVTile
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
  // this block's output columns o0 .. o0 + NO*64 - 1; a V panel past d
  // (the second one of the last slice at D = 136..192) loads the last panel
  // again instead, so no TMA box lies wholly outside the tensor and every
  // wgmma runs unconditionally: its output columns are never stored
  const int o0 = blockIdx.z * NO * kPanel;
  const int v_last = (d - 1) / kPanel * kPanel;

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
      mbar_expect_tx(bar_q, NQK * kQPanel);
      for (int p = 0; p < NQK; ++p)
        tma_load(q_s + p * kQPanel, &qmap, p * kPanel, q0, bh, bar_q);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(bar_empty + 8 * s, (t / kStages - 1) & 1);
        mbar_expect_tx(bar_k + 8 * s, kKTile);
        for (int p = 0; p < NQK; ++p)
          tma_load(k_s + s * kKTile + p * kKVPanel, &kmap, p * kPanel,
                   t * kBlockN, bh, bar_k + 8 * s);
        mbar_expect_tx(bar_v + 8 * s, kVTile);
        for (int p = 0; p < NO; ++p)
          tma_load(v_s + s * kVTile + p * kKVPanel, &vmap,
                   min(o0 + p * kPanel, v_last), t * kBlockN, bh,
                   bar_v + 8 * s);
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

  float oacc[NO][32];
  float sacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sacc[i] = 0.f;
#pragma unroll
    for (int p = 0; p < NO; ++p) oacc[p][i] = 0.f;
  }
  uint32_t p_hi[16], p_lo[16];
  RowState rows;
  float alpha0, alpha1;

  mbar_wait(bar_q, 0);
  mbar_wait(bar_k, 0);
  fence_regs(sacc);
  wgmma_fence();
  issue_qk16<T, NQK>(sacc, q_wg, k_s);
  wgmma_wait<0>();
  fence_regs(sacc);
  softmax_tile(sacc, 0, edge(0), sk, r0, offset, causal, scale_log2, t4, rows,
               alpha0, alpha1);
  split_p<T>(sacc, p_hi, p_lo);  // O is still 0: nothing to rescale

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
    issue_qk16<T, NQK>(sacc, q_wg, k_s + s * kKTile);
    issue_pv16<T, NO>(oacc, p_hi, p_lo, v_s + sp * kVTile);
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
    split_p<T>(sacc, p_hi, p_lo);
  }
  // the last tile's P·V (its stage is never waited for again)
  const int sl = (n_tiles - 1) % kStages;
  mbar_wait(bar_v + 8 * sl, ((n_tiles - 1) / kStages) & 1);
  fence_regs(oacc);
  fence_regs(p_hi);
  fence_regs(p_lo);
  wgmma_fence();
  issue_pv16<T, NO>(oacc, p_hi, p_lo, v_s + sl * kVTile);
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
  if (stats != nullptr && t4 == 0) {
    stats[(long long)bh * sq_pad + r0] =
        r0 < sq ? make_float4(rows.m0, 1.f / den0, 0.f, 0.f)
                : make_float4(0.f, 0.f, 0.f, 0.f);
    stats[(long long)bh * sq_pad + r1] =
        r1 < sq ? make_float4(rows.m1, 1.f / den1, 0.f, 0.f)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  T* og = o + (long long)bh * sq * d;
#pragma unroll
  for (int p = 0; p < NO; ++p) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = o0 + p * kPanel + 8 * j + 2 * t4;
      if (col >= d) continue;
      if (r0 < sq)
        *reinterpret_cast<uint32_t*>(og + (long long)r0 * d + col) =
            pack2(T(), oacc[p][4 * j] / den0, oacc[p][4 * j + 1] / den0,
                  nullptr);
      if (r1 < sq)
        *reinterpret_cast<uint32_t*>(og + (long long)r1 * d + col) =
            pack2(T(), oacc[p][4 * j + 2] / den1, oacc[p][4 * j + 3] / den1,
                  nullptr);
    }
  }
}

template <typename T, int NQK, int NO>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km,
                   const CUtensorMap& vm, void* o, int batch_heads, int sq,
                   int sk, int d, float scale, int causal, void* stats,
                   cudaStream_t stream) {
  const int smem = NQK * kQPanel + kStages * (NQK + NO) * kKVPanel + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<T, NQK, NO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int q_blocks = (sq + kBlockM - 1) / kBlockM;
  const dim3 grid(batch_heads, q_blocks,
                  (d + NO * kPanel - 1) / (NO * kPanel));
  flash_fwd_sm90_kernel<T, NQK, NO><<<grid, kThreads, smem, stream>>>(
      qm, km, vm, static_cast<T*>(o), sq, sk, d, scale, causal,
      static_cast<float4*>(stats), q_blocks * kBlockM);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(CUtensorMapDataType type, const void* q, const void* k,
                const void* v, void* o, int batch_heads, int sq, int sk,
                int d, float scale, int causal, void* stats,
                cudaStream_t stream) {
  if (d % 8 != 0 || d > 256 || (sq + kBlockM - 1) / kBlockM > 65535 ||
      (stats != nullptr && d > 128) ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o |
       (uintptr_t)stats) % 16 != 0)
    return cudaErrorInvalidValue;
  const cudaError_t bound = bind_device(q);
  if (bound != cudaSuccess) return bound;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  if (!make_map(encode, &qm, type, q, batch_heads, sq, d, kBlockM) ||
      !make_map(encode, &km, type, k, batch_heads, sk, d, kBlockN) ||
      !make_map(encode, &vm, type, v, batch_heads, sk, d, kBlockN))
    return cudaErrorInvalidValue;
  if (d <= 64)
    return launch<T, 1, 1>(qm, km, vm, o, batch_heads, sq, sk, d, scale,
                           causal, stats, stream);
  if (d <= 128)
    return launch<T, 2, 2>(qm, km, vm, o, batch_heads, sq, sk, d, scale,
                           causal, stats, stream);
  if (d <= 192)
    return launch<T, 3, 2>(qm, km, vm, o, batch_heads, sq, sk, d, scale,
                           causal, stats, stream);
  return launch<T, 4, 2>(qm, km, vm, o, batch_heads, sq, sk, d, scale, causal,
                         stats, stream);
}

}  // namespace

// The 16-bit routes, entered by flash_attention_bf16 and flash_attention_f16
// (flash_attention.cu). q, o: (batch_heads, sq, d); k, v: (batch_heads, sk,
// d); contiguous bf16 (is_half 0) or f16 (is_half 1) with 16-byte aligned
// bases; d a multiple of 8 up to 256 (the TMA row stride is a multiple of 16
// bytes); stats: null, or at d <= 128 the backward kernel's row stats,
// batch_heads x (sq rounded up to 128) float4, 16-byte aligned.
cudaError_t flash_attention_sm90_16bit(const void* q, const void* k,
                                       const void* v, void* o,
                                       int batch_heads, int sq, int sk, int d,
                                       float scale, int causal, void* stats,
                                       int is_half, cudaStream_t stream) {
  if (is_half)
    return run<__half>(CU_TENSOR_MAP_DATA_TYPE_FLOAT16, q, k, v, o,
                       batch_heads, sq, sk, d, scale, causal, stats, stream);
  return run<__nv_bfloat16>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, k, v, o,
                            batch_heads, sq, sk, d, scale, causal, stats,
                            stream);
}
