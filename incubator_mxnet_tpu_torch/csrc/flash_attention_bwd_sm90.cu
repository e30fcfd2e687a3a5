// Flash-attention backward for Hopper (sm_90a) on 16-bit inputs, bfloat16 or
// float16, head dims 1..128: dQ, dK and dV on wgmma, TMA loads into
// 128-byte-swizzled shared memory, P and dS split into two halves of the
// input's type, and neither P nor dS ever in device memory.
//
// Replaces the JAX build's backward of flash attention,
// incubator_mxnet_tpu/ops/attention.py:_flash_bwd (:168; jnp under XLA, the
// gradient of the TPU kernel _flash_kernel :56), on the card's bf16 and f16
// routes; f32, dtype mixes, head dims above 128 and second derivatives keep
// the torch-op version (ops/attention.py _flash_backward). It computes what
// _flash_bwd computes: the row stats m (max) and l (sum) of the scaled
// logits, kept apart; P = exp(s - m) / max(l, 1e-20); delta = sum(g·out) in
// f32 from the 16-bit out; dS = P·(dP - delta)·scale, zeroed at masked
// logits; dV = Pᵀ·g, dK = dSᵀ·Q, dQ = dS·K, each rounded once to the input's
// type. The causal diagonal is anchored at the end of the key axis (row i
// sees keys j <= i + Sk - Sq) and masked logits take the -1e30 sentinel, so a
// row that sees no key has uniform P (1/Sk): it adds to dV at every key and
// gives no dQ or dK.
//
// Exactness on the tensor cores. S = Q·Kᵀ and dP = g·Vᵀ are single bf16 (f16)
// products into f32: their operands are the 16-bit inputs, whose products are
// exact in f32. P and dS are f32 values, so each of dV, dK and dQ is two
// products, P_hi·g + P_lo·g with P_hi = T(P) and P_lo = T(P - P_hi) (the same
// for dS), as the forward splits P (flash_attention_sm90.cu): the halves
// carry P and dS to about 2^-17 relative in bf16 (2^-22 in f16, down to f16's
// subnormal step), where one rounding would carry them to 2^-9 (2^-12). The
// scale is folded with log2(e) into exp2f.
//
// What bounds it on this card: at the training shape (8, 32, 1024, 1024, 128)
// causal bf16, q, k, v, out and g read once and dq, dk, dv written once are
// 537 MB, 0.160 ms at 3.35 TB/s; the products with the 16-bit operands exact
// and P and dS carried to f32 are 16·D flop a visible (query, key) pair (S and
// dP once, dV, dK and dQ twice), 2.75e11 flop, 0.278 ms at 989 TFLOP/s: it is
// bound by operations. This design issues more (chip_smoke.py counts it from
// the tile walks): S and dP once in the dQ kernel and again in each of the
// dK/dV kernel's two 64-column output slices, over whole tiles across the
// diagonal.
//
// Design: the forward (flash_attention_sm90.cu) writes each row's m (log2
// units) and 1 / max(l, 1e-20) as a float4 of (batch_heads, Sq rounded up to
// 128) rows when training, since it has them; then two kernels on the
// caller's stream, none with atomics, so two runs give the same bits.
//  1. dQ, queries outer: one block per 128 query rows (two consumer
//     warpgroups of 64 rows and one producer warp, 288 threads, as the
//     forward); Q and g resident, K and V tiles of 64 keys through a 3-stage
//     TMA ring. First each row's delta = sum(g·out) from out and g (16 bytes
//     a load), kept and written beside the row's stats for kernel 2. Per
//     tile: S = Q·Kᵀ and dP = g·Vᵀ, then P and dS in registers from the row
//     stats, dS split in two halves packed as wgmma's A-from-registers
//     fragment, dQ += dS_hi·K + dS_lo·K (K read MN-major through the
//     transpose bit, as V in the forward). Key tiles past the block's last
//     visible key are skipped: dS is 0 there, also for rows that see no key.
//  2. dK and dV, keys outer: one block per 128 keys and one 64-column output
//     slice (grid z); K and V resident, tiles of 64 query rows of Q and g and
//     their stats through the ring. Per tile: Sᵀ = K·Qᵀ and dPᵀ = V·gᵀ, so Pᵀ
//     and dSᵀ land in the accumulator layout that is wgmma's A fragment, and
//     are split pair by pair as they are computed; then dV += Pᵀ_hi·g +
//     Pᵀ_lo·g and dK += dSᵀ_hi·Q + dSᵀ_lo·Q on the slice's panel of g and Q
//     (MN-major). A query tile is skipped only when every row sees some key
//     and none sees a key of this block: rows that see no key add uniform P
//     to dV at every key.
// Registers: nine warps put three on one SM quarter of 16K registers, so
// ptxas caps a thread at 168. dQ holds its 64 f32 accumulators at D = 128,
// S and dP 64 more; dK and dV over 64 keys x 128 columns would be 128 on
// their own, so each block of kernel 2 accumulates one 64-column slice of
// both (64 registers) and computes Sᵀ and dPᵀ again for each slice. Inside
// a warpgroup the two products, the elementwise pass and the two updates run
// in turn; the two warpgroups of a block overlap each other, and the
// producer keeps the next tiles in flight. The elementwise pass tests the
// mask only on tiles that cross an edge or the diagonal. Ragged edges: TMA
// fills rows past Sq or Sk and columns past D with zeros; elements past Sq or
// Sk get P = 0 and dS = 0; a 128-row resident tile whose second half lies
// wholly past the tensor loads its first half only (the rows of the second
// are never stored).

#include "flash_sm90_common.cuh"

namespace {

constexpr int kStages = 3;
constexpr int kStatsTile = kBlockN * 16;  // the float4 stats of a 64-row tile

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// one resident 128-row tile of NQK panels: two TMA boxes of 64 rows a panel,
// the second only where it starts inside the tensor (the caller's expect_tx
// counts the same boxes)
__device__ __forceinline__ void load_resident(uint32_t dst,
                                              const CUtensorMap* map, int nqk,
                                              int row0, int rows, int bh,
                                              uint32_t bar) {
  const int halves = row0 + kBlockN < rows ? 2 : 1;
  for (int p = 0; p < nqk; ++p)
    for (int h = 0; h < halves; ++h)
      tma_load(dst + p * kQPanel + h * kKVPanel, map, p * kPanel,
               row0 + h * kBlockN, bh, bar);
}

__device__ __forceinline__ float2 unpack2(__nv_bfloat16, uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}
__device__ __forceinline__ float2 unpack2(__half, uint32_t x) {
  return __half22float2(*reinterpret_cast<__half2*>(&x));
}

// sum(a·b) over 8 T values in a 16-byte load each, in f32
template <typename T>
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const uint32_t* x = reinterpret_cast<const uint32_t*>(&a);
  const uint32_t* y = reinterpret_cast<const uint32_t*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = unpack2(T(), x[i]), w = unpack2(T(), y[i]);
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
  return s;
}

// store a thread's share of a 64 x 64 f32 accumulator as T: rows r0 and
// r0 + 8 (below `rows`), columns c0 + 8j + 2t4 (+1) (below d)
template <typename T>
__device__ __forceinline__ void store_tile(T* base, const float (&acc)[32],
                                           int r0, int rows, int c0, int d,
                                           int t4) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = c0 + 8 * j + 2 * t4;
    if (col >= d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r0 + 8 * h < rows)
        *reinterpret_cast<uint32_t*>(base + (long long)(r0 + 8 * h) * d +
                                     col) =
            pack2(T(), acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], nullptr);
  }
}

// dS of one tile of the dQ kernel, in place of dP: row r0 + 8h (stats rs[h]
// = (m, 1 / l, delta)), key n0 + 8j + 2t4 + e. kEdge: the tile crosses the
// key axis's end or the causal diagonal, so each element is masked (dS = 0)
// or not; an interior tile takes no test.
template <bool kEdge>
__device__ __forceinline__ void dq_tile_ds(const float (&s)[32],
                                           float (&dp)[32],
                                           const float4 (&rs)[2], int n0,
                                           int r0, int t4, int sk, int offset,
                                           int causal, float scale_log2,
                                           float scale) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        const int col = n0 + 8 * j + 2 * t4 + e;
        const float p = exp2f(s[i] * scale_log2 - rs[h].x) * rs[h].y;
        const float ds = p * (dp[i] - rs[h].z) * scale;
        dp[i] = !kEdge || (col < sk && !(causal && col > r0 + 8 * h + offset))
                    ? ds
                    : 0.f;
      }
    }
  }
}

// Pᵀ and dSᵀ of one tile of the dK/dV kernel, each split into two halves of
// T packed as wgmma's A fragment (register pair (2r, 2r+1) of the
// accumulator is register r), pair by pair as they are computed so that the
// f32 values die at once: row = key kr0 + 8h, column = query i0 + c with
// stats st[c] = (m, 1 / l, delta) in shared memory. kEdge: the tile crosses
// Sq's or Sk's end or the causal diagonal, so each element is tested: past an
// end P = 0 and dS = 0; above the diagonal the logit is the sentinel (P
// uniform in a row that sees no key, else 0) and dS = 0.
template <typename T, bool kEdge>
__device__ __forceinline__ void dkdv_tile_split(
    const float (&s)[32], const float (&dp)[32], const float4* st, int i0,
    int kr0, int t4, int sq, int sk, int offset, int causal,
    float scale_log2, float scale, uint32_t (&p_hi)[16],
    uint32_t (&p_lo)[16], uint32_t (&ds_hi)[16], uint32_t (&ds_lo)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // keep the stats loads of column group j here: hoisted all together
    // they would hold 64 registers beside S, dP and the accumulators
    asm volatile("" ::: "memory");
    const float4 rs[2] = {st[8 * j + 2 * t4], st[8 * j + 2 * t4 + 1]};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        float x = s[i] * scale_log2;
        bool live = true, open = true;
        if (kEdge) {
          const int key = kr0 + 8 * h, query = i0 + 8 * j + 2 * t4 + e;
          if (query >= sq || key >= sk) {
            live = false;
          } else if (causal && key > query + offset) {
            x = kSentinel;
            open = false;
          }
        }
        p[e] = live ? exp2f(x - rs[e].x) * rs[e].y : 0.f;
        ds[e] = live && open ? p[e] * (dp[i] - rs[e].z) * scale : 0.f;
      }
      const int r = 2 * j + h;
      float2 back;
      p_hi[r] = pack2(T(), p[0], p[1], &back);
      p_lo[r] = pack2(T(), p[0] - back.x, p[1] - back.y, nullptr);
      ds_hi[r] = pack2(T(), ds[0], ds[1], &back);
      ds_lo[r] = pack2(T(), ds[0] - back.x, ds[1] - back.y, nullptr);
    }
  }
}

// Kernel 1: dQ, one block per 128 query rows, walking key tiles; it also
// completes the row stats with delta for kernel 2.
template <typename T, int NQK>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap gmap,
                    const T* __restrict__ g, const T* __restrict__ out,
                    float4* __restrict__ stats,
                    T* __restrict__ dq, int sq, int sk, int d, int sq_pad,
                    float scale, int causal) {
  constexpr int kTile = NQK * kKVPanel;  // one 64-key tile of K or V
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t g_s = q_s + NQK * kQPanel;
  const uint32_t ring = g_s + NQK * kQPanel;  // stage s: K, then V
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;
  const int q_rows = min(kBlockM, sq - q0);
  const int offset = sk - sq;
  // dS is 0 past a row's last visible key, also for a row that sees none,
  // so every block stops after its last visible key (one tile at least)
  int n_end = sk;
  if (causal) n_end = max(1, min(sk, q0 + q_rows + offset));
  const int n_tiles = (n_end + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    if (lane == 0) {
      mbar_expect_tx(bar_q, 2 * NQK * (q0 + kBlockN < sq ? 2 : 1) * kKVPanel);
      load_resident(q_s, &qmap, NQK, q0, sq, bh, bar_q);
      load_resident(g_s, &gmap, NQK, q0, sq, bh, bar_q);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(bar_empty + 8 * s, (t / kStages - 1) & 1);
        const uint32_t k_t = ring + s * 2 * kTile;
        mbar_expect_tx(bar_full + 8 * s, 2 * kTile);
        for (int p = 0; p < NQK; ++p) {
          tma_load(k_t + p * kKVPanel, &kmap, p * kPanel, t * kBlockN, bh,
                   bar_full + 8 * s);
          tma_load(k_t + kTile + p * kKVPanel, &vmap, p * kPanel, t * kBlockN,
                   bh, bar_full + 8 * s);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int t4 = lane % 4;
  const int r0 = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_wg = q_s + wg * 64 * 128;
  const uint32_t g_wg = g_s + wg * 64 * 128;
  // (m, 1 / l) of rows r0 and r0 + 8 from the forward (zeros past Sq), and
  // their delta = sum(g·out), the quad's four threads taking every fourth
  // 8-column chunk (d is a multiple of 8, so a chunk is one 16-byte load)
  // while the producer's first loads are in flight; kernel 2 reads it back
  float4 rs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    rs[h] = stats[(long long)bh * sq_pad + r];
    float delta = 0.f;
    if (r < sq) {
      const T* gr = g + ((long long)bh * sq + r) * d;
      const T* orow = out + ((long long)bh * sq + r) * d;
      for (int c = 8 * t4; c < d; c += 32)
        delta += dot8<T>(*reinterpret_cast<const uint4*>(orow + c),
                         *reinterpret_cast<const uint4*>(gr + c));
    }
    delta += __shfl_xor_sync(0xffffffffu, delta, 1);
    delta += __shfl_xor_sync(0xffffffffu, delta, 2);
    rs[h].z = delta;
    if (t4 == 0) stats[(long long)bh * sq_pad + r].z = delta;
  }
  float dqacc[NQK][32];
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int p = 0; p < NQK; ++p) dqacc[p][i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int n0 = t * kBlockN;
    const uint32_t k_t = ring + s * 2 * kTile;
    mbar_wait(bar_full + 8 * s, (t / kStages) & 1);
    // S and dP of this tile only: the first k16 step overwrites, so nothing
    // is initialized or carried from the last tile
    float sacc[32], pacc[32];
    wgmma_fence();
    issue_qk16<T, NQK>(sacc, q_wg, k_t);
    issue_qk16<T, NQK>(pacc, g_wg, k_t + kTile);
    wgmma_wait<0>();
    fence_regs(sacc);
    fence_regs(pacc);
    if (n0 + kBlockN > sk || (causal && n0 + kBlockN - 1 > q0 + offset))
      dq_tile_ds<true>(sacc, pacc, rs, n0, r0, t4, sk, offset, causal,
                       scale_log2, scale);
    else
      dq_tile_ds<false>(sacc, pacc, rs, n0, r0, t4, sk, offset, causal,
                        scale_log2, scale);
    uint32_t ds_hi[16], ds_lo[16];
    split_p<T>(pacc, ds_hi, ds_lo);
    fence_regs(dqacc);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    wgmma_fence();
    issue_pv16<T, NQK>(dqacc, ds_hi, ds_lo, k_t);
    wgmma_wait<0>();
    fence_regs(dqacc);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  T* dqg = dq + (long long)bh * sq * d;
#pragma unroll
  for (int p = 0; p < NQK; ++p)
    store_tile(dqg, dqacc[p], r0, sq, p * kPanel, d, t4);
}

// Kernel 2: dK and dV, one block per 128 keys and 64-column output slice,
// walking query tiles.
template <typename T, int NQK>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap gmap,
                      const float4* __restrict__ stats, T* __restrict__ dk,
                      T* __restrict__ dv, int sq, int sk, int d, int sq_pad,
                      float scale, int causal) {
  constexpr int kTile = NQK * kKVPanel;           // 64 query rows of Q or g
  constexpr int kStage = 2 * kTile + kStatsTile;  // Q, g, their rows' stats
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  const uint32_t k_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t v_s = k_s + NQK * kQPanel;
  const uint32_t ring = v_s + NQK * kQPanel;  // stage s at + s * kStage
  const uint32_t bar_kv = smem_u32(&bars[0]);
  const uint32_t bar_full = bar_kv + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int n0 = blockIdx.y * kBlockM;  // the heaviest causal keys first
  const int c0 = blockIdx.z * kPanel;   // this block's output columns
  const int offset = sk - sq;
  // The walk over query tiles: tiles 0 .. t_lo-1 hold rows that see no key
  // (uniform P, so they add to dV here); of the others, tiles below t_start
  // see no key of this block and are skipped (P = 0 and dS = 0 there).
  const int n_qt = (sq + kBlockN - 1) / kBlockN;
  int t_lo = 0, t_start = 0;
  if (causal) {
    if (offset < 0) t_lo = min(n_qt, (-offset + kBlockN - 1) / kBlockN);
    const int first = n0 - offset - (kBlockN - 1);
    t_start = max(t_lo, first > 0 ? (first + kBlockN - 1) / kBlockN : 0);
  }
  const int n_walk = t_lo + n_qt - t_start;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * NQK * (n0 + kBlockN < sk ? 2 : 1) * kKVPanel);
      load_resident(k_s, &kmap, NQK, n0, sk, bh, bar_kv);
      load_resident(v_s, &vmap, NQK, n0, sk, bh, bar_kv);
      for (int w = 0; w < n_walk; ++w) {
        const int s = w % kStages;
        if (w >= kStages) mbar_wait(bar_empty + 8 * s, (w / kStages - 1) & 1);
        const int t = w < t_lo ? w : t_start + w - t_lo;
        const uint32_t q_t = ring + s * kStage;
        mbar_expect_tx(bar_full + 8 * s, 2 * kTile + kStatsTile);
        for (int p = 0; p < NQK; ++p) {
          tma_load(q_t + p * kKVPanel, &qmap, p * kPanel, t * kBlockN, bh,
                   bar_full + 8 * s);
          tma_load(q_t + kTile + p * kKVPanel, &gmap, p * kPanel, t * kBlockN,
                   bh, bar_full + 8 * s);
        }
        bulk_load(q_t + 2 * kTile,
                  stats + (long long)bh * sq_pad + t * kBlockN, kStatsTile,
                  bar_full + 8 * s);
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int t4 = lane % 4;
  const int kw0 = n0 + wg * 64;  // this warpgroup's 64 keys
  const int kr0 = kw0 + (warp % 4) * 16 + lane / 4;  // keys kr0, kr0 + 8
  const float scale_log2 = scale * kLog2e;
  const uint32_t k_wg = k_s + wg * 64 * 128;
  const uint32_t v_wg = v_s + wg * 64 * 128;
  float dkacc[1][32], dvacc[1][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    dkacc[0][i] = 0.f;
    dvacc[0][i] = 0.f;
  }

  mbar_wait(bar_kv, 0);
  for (int w = 0; w < n_walk; ++w) {
    const int s = w % kStages;
    const int i0 = (w < t_lo ? w : t_start + w - t_lo) * kBlockN;
    const uint32_t q_t = ring + s * kStage;
    const uint32_t g_t = q_t + kTile;
    const float4* st = reinterpret_cast<const float4*>(
        smem_raw + (g_t + kTile - smem_u32(smem_raw)));
    mbar_wait(bar_full + 8 * s, (w / kStages) & 1);
    float sacc[32], pacc[32];  // Sᵀ and dPᵀ of this tile only
    wgmma_fence();
    issue_qk16<T, NQK>(sacc, k_wg, q_t);
    issue_qk16<T, NQK>(pacc, v_wg, g_t);
    wgmma_wait<0>();
    fence_regs(sacc);
    fence_regs(pacc);
    uint32_t p_hi[16], p_lo[16], ds_hi[16], ds_lo[16];
    if (i0 + kBlockN > sq || kw0 + 64 > sk ||
        (causal && kw0 + 63 > i0 + offset))
      dkdv_tile_split<T, true>(sacc, pacc, st, i0, kr0, t4, sq, sk, offset,
                               causal, scale_log2, scale, p_hi, p_lo, ds_hi,
                               ds_lo);
    else
      dkdv_tile_split<T, false>(sacc, pacc, st, i0, kr0, t4, sq, sk, offset,
                                causal, scale_log2, scale, p_hi, p_lo, ds_hi,
                                ds_lo);
    fence_regs(dkacc);
    fence_regs(dvacc);
    fence_regs(p_hi);
    fence_regs(p_lo);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    wgmma_fence();
    issue_pv16<T, 1>(dvacc, p_hi, p_lo, g_t + blockIdx.z * kKVPanel);
    issue_pv16<T, 1>(dkacc, ds_hi, ds_lo, q_t + blockIdx.z * kKVPanel);
    wgmma_wait<0>();
    fence_regs(dkacc);
    fence_regs(dvacc);
    fence_regs(p_hi);
    fence_regs(p_lo);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  const long long base = (long long)bh * sk * d;
  store_tile(dk + base, dkacc[0], kr0, sk, c0, d, t4);
  store_tile(dv + base, dvacc[0], kr0, sk, c0, d, t4);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int NQK>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km,
                   const CUtensorMap& vm, const CUtensorMap& gm,
                   const void* out, const void* g, float4* stats, void* dq,
                   void* dk, void* dv, int batch_heads, int sq, int sk, int d,
                   float scale, int causal, cudaStream_t stream) {
  const int q_blocks = (sq + kBlockM - 1) / kBlockM;
  const int sq_pad = q_blocks * kBlockM;
  const int smem_dq = 2 * NQK * kQPanel + kStages * 2 * NQK * kKVPanel + 1024;
  const int smem_dkdv =
      2 * NQK * kQPanel + kStages * (2 * NQK * kKVPanel + kStatsTile) + 1024;
  // this library links its own CUDA runtime: clear its last error first, so
  // that the checks below report this launch's failures only (a fault of an
  // earlier kernel is sticky and shows again)
  cudaGetLastError();
  cudaError_t err;
  if ((err = allow_smem(flash_bwd_dq_kernel<T, NQK>, smem_dq)) ||
      (err = allow_smem(flash_bwd_dkdv_kernel<T, NQK>, smem_dkdv)))
    return err;
  flash_bwd_dq_kernel<T, NQK>
      <<<dim3(batch_heads, q_blocks), kThreads, smem_dq, stream>>>(
          qm, km, vm, gm, static_cast<const T*>(g),
          static_cast<const T*>(out), stats, static_cast<T*>(dq), sq, sk, d,
          sq_pad, scale, causal);
  if ((err = cudaGetLastError())) return err;
  flash_bwd_dkdv_kernel<T, NQK>
      <<<dim3(batch_heads, (sk + kBlockM - 1) / kBlockM, NQK), kThreads,
         smem_dkdv, stream>>>(qm, km, vm, gm, stats, static_cast<T*>(dk),
                              static_cast<T*>(dv), sq, sk, d, sq_pad, scale,
                              causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(CUtensorMapDataType type, const void* q, const void* k,
                const void* v, const void* out, const void* g, void* dq,
                void* dk, void* dv, void* stats, int batch_heads, int sq,
                int sk, int d, float scale, int causal, cudaStream_t stream) {
  if (d % 8 != 0 || d > 128 || (sq + kBlockM - 1) / kBlockM > 65535 ||
      (sk + kBlockM - 1) / kBlockM > 65535 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out |
       (uintptr_t)g | (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv |
       (uintptr_t)stats) % 16 != 0)
    return cudaErrorInvalidValue;
  const cudaError_t bound = bind_device(q);
  if (bound != cudaSuccess) return bound;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm, gm;
  if (!make_map(encode, &qm, type, q, batch_heads, sq, d, kBlockN) ||
      !make_map(encode, &km, type, k, batch_heads, sk, d, kBlockN) ||
      !make_map(encode, &vm, type, v, batch_heads, sk, d, kBlockN) ||
      !make_map(encode, &gm, type, g, batch_heads, sq, d, kBlockN))
    return cudaErrorInvalidValue;
  float4* st = static_cast<float4*>(stats);
  if (d <= 64)
    return launch<T, 1>(qm, km, vm, gm, out, g, st, dq, dk, dv, batch_heads,
                        sq, sk, d, scale, causal, stream);
  return launch<T, 2>(qm, km, vm, gm, out, g, st, dq, dk, dv, batch_heads, sq,
                      sk, d, scale, causal, stream);
}

}  // namespace

// The 16-bit backward, entered by flash_attention_bwd_bf16 and
// flash_attention_bwd_f16 (flash_attention.cu). q, out, g, dq:
// (batch_heads, sq, d); k, v, dk, dv: (batch_heads, sk, d); contiguous bf16
// (is_half 0) or f16 (is_half 1) with 16-byte aligned bases; d a multiple of
// 8 up to 128; stats: batch_heads x (sq rounded up to 128) float4 of the
// forward's row stats, 16-byte aligned, to which kernel 1 adds delta.
cudaError_t flash_attention_bwd_sm90_16bit(
    const void* q, const void* k, const void* v, const void* out,
    const void* g, void* dq, void* dk, void* dv, void* stats,
    int batch_heads, int sq, int sk, int d, float scale, int causal,
    int is_half, cudaStream_t stream) {
  if (is_half)
    return run<__half>(CU_TENSOR_MAP_DATA_TYPE_FLOAT16, q, k, v, out, g, dq,
                       dk, dv, stats, batch_heads, sq, sk, d, scale, causal,
                       stream);
  return run<__nv_bfloat16>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, k, v, out, g,
                            dq, dk, dv, stats, batch_heads, sq, sk, d, scale,
                            causal, stream);
}
