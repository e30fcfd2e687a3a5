// Flash-attention forward for Hopper (sm_90a) on float32 inputs: each f32
// operand split into three bf16 pieces, six bf16 wgmma products per f32
// product on the tensor cores, TMA loads into 128-byte-swizzled shared memory.
//
// Replaces the TPU kernel incubator_mxnet_tpu/ops/attention.py:_flash_kernel
// (:56, launched by _flash_forward_pallas :98) on the float32 route, which
// also takes any mix of input dtypes (the reference promotes a mix to f32 and
// returns q's dtype); bf16 and f16 inputs take flash_attention_sm90.cu, and
// flash_attention.cu holds the routes' C entry points. It computes the
// reference's function in f32:
// o = softmax(q·kᵀ·scale)·v with every product at the TPU kernel's
// Precision.HIGHEST, masked logits at the finite -1e30 sentinel, the causal
// diagonal anchored at the end of the key axis (row i sees keys
// j <= i + Sk - Sq), a row that sees no key averaging V uniformly, and
// o = acc / max(l, 1e-20), written as f32.
//
// Exactness on the tensor cores. On the TPU's matrix unit XLA computes
// HIGHEST as six bf16 passes over a three-way bf16 split of each operand;
// this kernel does the same on bf16 wgmma. x = x_h + x_m + x_l with
// x_h = bf16(x), x_m = bf16(x - x_h), x_l = bf16(x - x_h - x_m) carries x to
// 24 bits. A·B is the sum of the six products whose pieces' ranks add up to
// at most 2 (hh, hm, mh, mm, hl, lh), each exact in f32, accumulated into one
// f32 accumulator with the small terms first and hh last. The terms left out
// are below 2^-24 relative. The split pass (split3_kernel) writes the bf16
// planes of q (scaled first, as the TPU kernel scales q), k and v from the
// caller's strides, each read at its own dtype: a bf16 input is its own
// plane h (m = l = 0), an f16 input (11-bit significand, exponents inside
// bf16's) splits exactly into h and m, so a mix needs no cast copy; P is
// split the same way in registers. The emulation in
// tests/test_torch_attention.py replays this arithmetic against the JAX build
// at 2e-5, and one piece instead of three breaks 1e-4 there.
//
// What bounds it on this card: at (8, 32, 1024, 128) causal f32 the work the
// mask lets through is 68.8 GFLOP on 537 MB of q, k, v and o: 0.160 ms for the
// bytes at 3.35 TB/s, 1.03 ms for the operations on the CUDA cores' 67 TFLOP/s
// of f32, and 0.417 ms for the split's six bf16 products (413 GFLOP) at
// 989 TFLOP/s, the least time of f32-exact work on the tensor cores. The
// split pass moves 403 MB of f32 in and 604 MB of planes out (0.30 ms).
//
// Layout. One block per (128 query rows, b·h), the heaviest causal tiles
// first; 288 threads: two consumer warpgroups of 64 query rows each and one
// producer warp. Q's three planes stay in shared memory (96 KB at D = 128).
// K and V pass through a ring of eight slots, each holding one bf16 plane of
// one 64-key tile (16 KB at D = 128): per tile the producer loads K_h, K_m,
// K_l, V_h, V_m, V_l in that order, each slot with a full and an empty
// mbarrier. 96 + 128 KB fits the 227 KB a block may have; whole stages of
// K and V (96 KB each) would not fit twice beside Q. A warpgroup computes S
// (six products, 48 wgmma m64n64k16 at D = 128, both operands in shared
// memory), waits, frees the three K slots, runs the online softmax in log2
// units, splits P into three bf16x2 fragments in registers, and issues
// O += P·V (six products, V through the transpose bit), then frees the three
// V slots. The two warpgroups drift apart, so one's softmax runs while the
// other's products are on the tensor cores. Keeping S of one tile in flight
// with P·V of the previous one, as the bf16 kernel does, holds the S
// accumulator (32 registers), three P pieces (48) and O (64) at once: at the
// 168-register cap of nine warps ptxas spilled and serialized the wgmmas,
// and the kernel ran slower (PERF.md). In the sequential order ptxas gives
// the D = 128 kernel 164 registers and no spills. The wgmma layouts, the swizzle and the ragged edges are those
// of flash_attention_sm90.cu. The kernels allocate nothing and run on the
// caller's stream.
//
// Head dims 129-256 (the template's NWG = 1 instance). Q's three planes at
// 128 rows x 256 columns would take 192 KB, so a block takes 64 query rows
// and one consumer warpgroup (160 threads), and, as the 16-bit kernel does,
// one slice of 128 output columns (grid z): S over the full D, O over the
// slice. Shared memory: Q's planes 3 x 64 x 256 x 2 = 96 KB; a ring of four
// slots of one plane of one 64-key tile, sized for K at D = 256 (32 KB; a V
// slice plane fills 16 KB of one), 128 KB; 224 KB of the 227 KB a block may
// have (D <= 192: Q 72 KB and six 24 KB slots, 216 KB). The producer loads
// K's three planes, then V's; the consumer releases K's before it waits for
// V's, so four slots never deadlock. Registers: O (64), S (32) and P's three
// pieces (48) as at D = 128, and five warps leave ptxas its 255-register cap
// (65536 / 160 / 1 block).

#include "flash_sm90_common.cuh"

namespace {

constexpr int kSplitThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// x (b, h, s, d) of TIn (f32, bf16 or f16) at element strides st0..st3,
// times mul, into planes (3, b·h, s, dp) bf16 with zeros in columns d ..
// dp-1; one thread per 8 columns of a row, one 16-byte store per plane.
template <typename TIn>
__global__ void __launch_bounds__(kSplitThreads)
split3_kernel(const TIn* __restrict__ x, long long st0, long long st1,
              long long st2, long long st3, int h, int s, int d, int dp,
              float mul, long long groups, __nv_bfloat16* __restrict__ out) {
  const long long g = (long long)blockIdx.x * kSplitThreads + threadIdx.x;
  if (g >= groups) return;
  const int per_row = dp / 8;
  const long long row = g / per_row;  // over (b·h, s)
  const int c0 = (int)(g - row * per_row) * 8;
  const long long bh = row / s;
  const long long b = bh / h;
  const TIn* src = x + b * st0 + (bh - b * h) * st1 + (row - bh * s) * st2;
  float v[8];
  if (std::is_same<TIn, float>::value && st3 == 1 && c0 + 8 <= d &&
      (reinterpret_cast<uintptr_t>(src + c0) & 15) == 0) {
    const float4 a = *reinterpret_cast<const float4*>(src + c0);
    const float4 c = *reinterpret_cast<const float4*>(src + c0 + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = c0 + e < d ? to_f32(src[(c0 + e) * st3]) : 0.f;
  }
  uint32_t w[kPieces][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split_pair(v[2 * i] * mul, v[2 * i + 1] * mul, &w[0][i], 4);
  const long long plane = groups * 8;  // elements of one plane
#pragma unroll
  for (int p = 0; p < kPieces; ++p)
    *reinterpret_cast<uint4*>(out + p * plane + row * dp + c0) =
        make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
}

// S = Σ_i Q_a(i)·K_b(i)ᵀ for this warpgroup's 64 rows and one tile of 64
// keys: six products of k16 steps of 32 bytes inside each 128-byte panel;
// q_wg is the warpgroup's rows in Q plane 0 (QPANEL bytes a panel, plane a at
// + a·NQK panels), k_pl[b] the slot of K plane b; one commit group
template <int NQK, int QPANEL>
__device__ __forceinline__ void issue_qk(float (&sacc)[32], uint32_t q_wg,
                                         const uint32_t (&k_pl)[kPieces]) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int kk = 0; kk < 4 * NQK; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss(sacc,
               smem_desc(q_wg + (a_piece(i) * NQK + kk / 4) * QPANEL + off, 16,
                         1024),
               smem_desc(k_pl[b_piece(i)] + (kk / 4) * kKVPanel + off, 16,
                         1024),
               i > 0 || kk > 0);
    }
  }
  wgmma_commit();
}

// O += Σ_i P_a(i)·V_b(i), one panel of V (64 output columns) at a time, a
// k16 step being 16 key rows (2048 bytes); registers 4kk .. 4kk+3 of a P
// piece are the A operand of step kk; one commit group
template <int NO>
__device__ __forceinline__ void issue_pv(float (&oacc)[NO][32],
                                         const uint32_t (&p)[kPieces][16],
                                         const uint32_t (&v_pl)[kPieces]) {
#pragma unroll
  for (int pn = 0; pn < NO; ++pn) {
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(oacc[pn], &p[a_piece(i)][4 * kk],
                 smem_desc(v_pl[b_piece(i)] + pn * kKVPanel + kk * 2048, 1024,
                           1024));
    }
  }
  wgmma_commit();
}

// NQK: 64-column panels of Q and K, the head dim rounded up to a multiple of
// 64 (1 to 4); NO: panels of V and O in one output slice; NWG: consumer
// warpgroups, 64 query rows each; SLOTS: ring slots of one (tile, plane)
template <int NQK, int NO, int NWG, int SLOTS>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
flash_fwd_f32_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          float* __restrict__ o, int sq, int sk, int d,
                          int causal) {
  constexpr int kRows = 64 * NWG;                // query rows of a block
  constexpr int kConsumerWarps = 4 * NWG;
  constexpr int kQPanelB = kRows * kPanel * 2;   // bytes of one Q panel
  constexpr int kQPlane = NQK * kQPanelB;        // bytes of one Q plane
  constexpr int kSlot = (NQK > NO ? NQK : NO) * kKVPanel;  // a K or V plane
  extern __shared__ uint8_t smem_raw[];
  // barriers: Q; then per slot full, empty
  __shared__ __align__(8) uint64_t bars[1 + 2 * SLOTS];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = q_s + kPieces * kQPlane;  // slot r at + r * kSlot
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full = bar_q + 8;  // + 8 * slot
  const uint32_t bar_empty = bar_full + 8 * SLOTS;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  // the heaviest causal tiles (last query rows) are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int q_rows = min(kRows, sq - q0);
  const int offset = sk - sq;  // row i sees keys j <= i + offset
  int n_end = sk;
  if (causal && q0 + offset >= 0) n_end = min(sk, q0 + q_rows + offset);
  const int n_tiles = (n_end + kBlockN - 1) / kBlockN;
  // this block's output columns o0 .. o0 + NO*64 - 1; a V panel past the
  // planes' width dp loads the last panel again instead, so no TMA box lies
  // wholly outside the planes and every wgmma runs unconditionally: its
  // output columns are never stored
  const int dp = (d + 7) / 8 * 8;
  const int o0 = blockIdx.z * NO * kPanel;
  const int v_last = (dp - 1) / kPanel * kPanel;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int r = 0; r < SLOTS; ++r) {
      mbar_init(bar_full + 8 * r, 1);
      mbar_init(bar_empty + 8 * r, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: Q's three planes once, then item i = 6t + j of the ring,
    // j = 0..2 the planes h, m, l of K of tile t (NQK panels), j = 3..5 those
    // of V (the slice's NO panels)
    if (lane == 0) {
      mbar_expect_tx(bar_q, kPieces * kQPlane);
      for (int pc = 0; pc < kPieces; ++pc)
        for (int pn = 0; pn < NQK; ++pn)
          tma_load_4d(q_s + pc * kQPlane + pn * kQPanelB, &qmap, pn * kPanel,
                      q0, bh, pc, bar_q);
      for (int i = 0; i < 2 * kPieces * n_tiles; ++i) {
        const int t = i / (2 * kPieces), j = i % (2 * kPieces);
        const int r = i % SLOTS;
        const bool is_k = j < kPieces;
        const int panels = is_k ? NQK : NO;
        if (i >= SLOTS) mbar_wait(bar_empty + 8 * r, (i / SLOTS - 1) & 1);
        mbar_expect_tx(bar_full + 8 * r, panels * kKVPanel);
        for (int pn = 0; pn < panels; ++pn)
          tma_load_4d(ring + r * kSlot + pn * kKVPanel, is_k ? &kmap : &vmap,
                      is_k ? pn * kPanel : min(o0 + pn * kPanel, v_last),
                      t * kBlockN, bh, j % kPieces, bar_full + 8 * r);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows wg*64 .. wg*64+63 of the block; this
  // thread holds rows r0 and r0 + 8
  const int wg = warp / 4;
  const int t4 = lane % 4;
  const int r0 = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const uint32_t q_wg = q_s + wg * 64 * 128;  // its 64 rows of each Q panel
  const auto edge = [&](int n0) {  // does the tile need the per-key mask?
    return n0 + kBlockN > sk || (causal && n0 + kBlockN - 1 > q0 + offset);
  };
  // wait for the planes of item 6t + first .. + first + 2, and their slots
  const auto acquire = [&](int t, int first, uint32_t (&pl)[kPieces]) {
#pragma unroll
    for (int pc = 0; pc < kPieces; ++pc) {
      const int i = 2 * kPieces * t + first + pc;
      pl[pc] = ring + (i % SLOTS) * kSlot;
      mbar_wait(bar_full + 8 * (i % SLOTS), (i / SLOTS) & 1);
    }
  };
  const auto release = [&](int t, int first) {
    __syncwarp();
    if (lane == 0) {
#pragma unroll
      for (int pc = 0; pc < kPieces; ++pc)
        mbar_arrive(bar_empty + 8 * ((2 * kPieces * t + first + pc) % SLOTS));
    }
  };

  float oacc[NO][32];
  float sacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sacc[i] = 0.f;
#pragma unroll
    for (int pn = 0; pn < NO; ++pn) oacc[pn][i] = 0.f;
  }
  uint32_t pp[kPieces][16];
  RowState rows;
  float alpha0, alpha1;

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    uint32_t k_pl[kPieces], v_pl[kPieces];
    acquire(t, 0, k_pl);
    fence_regs(sacc);
    wgmma_fence();
    issue_qk<NQK, kQPanelB>(sacc, q_wg, k_pl);
    wgmma_wait<0>();
    fence_regs(sacc);
    release(t, 0);
    // q was scaled in the split pass: log2(e) alone takes S to log2 units
    softmax_tile(sacc, t * kBlockN, edge(t * kBlockN), sk, r0, offset, causal,
                 kLog2e, t4, rows, alpha0, alpha1);
    rescale(oacc, alpha0, alpha1);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      split_pair(sacc[2 * i], sacc[2 * i + 1], &pp[0][i], 16);
    acquire(t, kPieces, v_pl);
    fence_regs(oacc);
    fence_regs(pp);
    wgmma_fence();
    issue_pv<NO>(oacc, pp, v_pl);
    wgmma_wait<0>();
    fence_regs(oacc);
    fence_regs(pp);
    release(t, kPieces);
  }

  // o = acc / max(l, 1e-20), f32
  const int r1 = r0 + 8;
  float l0 = rows.l0, l1 = rows.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-20f);
  const float den1 = fmaxf(l1, 1e-20f);
  float* og = o + (long long)bh * sq * d;
#pragma unroll
  for (int pn = 0; pn < NO; ++pn) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = o0 + pn * kPanel + 8 * j + 2 * t4;
      if (r0 < sq)
        store_pair(og + (long long)r0 * d, col, d, oacc[pn][4 * j] / den0,
                   oacc[pn][4 * j + 1] / den0);
      if (r1 < sq)
        store_pair(og + (long long)r1 * d, col, d, oacc[pn][4 * j + 2] / den1,
                   oacc[pn][4 * j + 3] / den1);
    }
  }
}

template <int NQK, int NO, int NWG, int SLOTS>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km,
                   const CUtensorMap& vm, float* o, int batch_heads, int sq,
                   int sk, int d, int causal, cudaStream_t stream) {
  const int slot = (NQK > NO ? NQK : NO) * kKVPanel;
  const int smem = kPieces * NQK * 64 * NWG * kPanel * 2 + SLOTS * slot + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_sm90_kernel<NQK, NO, NWG, SLOTS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch_heads, (sq + 64 * NWG - 1) / (64 * NWG),
                  (d + NO * kPanel - 1) / (NO * kPanel));
  flash_fwd_f32_sm90_kernel<NQK, NO, NWG, SLOTS>
      <<<grid, NWG * 128 + 32, smem, stream>>>(qm, km, vm, o, sq, sk, d,
                                               causal);
  return cudaGetLastError();
}

template <typename TIn>
cudaError_t split(const void* x, long long st0, long long st1, long long st2,
                  long long st3, int h, int s, int d, int dp, float mul,
                  long long groups, long long blocks, void* planes,
                  cudaStream_t stream) {
  split3_kernel<TIn><<<(unsigned)blocks, kSplitThreads, 0, stream>>>(
      static_cast<const TIn*>(x), st0, st1, st2, st3, h, s, d, dp, mul,
      groups, static_cast<__nv_bfloat16*>(planes));
  return cudaGetLastError();
}

}  // namespace

// The split pass of the f32 route: x (b, h, s, d) at element strides
// st0..st3, f32 (dtype 0), bf16 (1) or f16 (2), times mul, into planes
// (3, b·h, s, dp) bf16, dp = d rounded up to a multiple of 8, 16-byte aligned.
cudaError_t flash_attention_sm90_f32_split(const void* x, long long st0,
                                           long long st1, long long st2,
                                           long long st3, void* planes, int b,
                                           int h, int s, int d, float mul,
                                           int dtype, cudaStream_t stream) {
  const int dp = (d + 7) / 8 * 8;
  if (b < 1 || h < 1 || s < 1 || d < 1 || (uintptr_t)planes % 16 != 0)
    return cudaErrorInvalidValue;
  const long long groups = (long long)b * h * s * (dp / 8);
  const long long blocks = (groups + kSplitThreads - 1) / kSplitThreads;
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  if (dtype == 1)
    return split<__nv_bfloat16>(x, st0, st1, st2, st3, h, s, d, dp, mul,
                                groups, blocks, planes, stream);
  if (dtype == 2)
    return split<__half>(x, st0, st1, st2, st3, h, s, d, dp, mul, groups,
                         blocks, planes, stream);
  return split<float>(x, st0, st1, st2, st3, h, s, d, dp, mul, groups, blocks,
                      planes, stream);
}

// The f32 route's attention over the split planes: qp (3, batch_heads, sq,
// dp) of q already scaled, kp and vp (3, batch_heads, sk, dp), bf16, 16-byte
// aligned; o (batch_heads, sq, d) f32 contiguous; 1 <= d <= 256.
cudaError_t flash_attention_sm90_f32(const void* qp, const void* kp,
                                     const void* vp, float* o,
                                     int batch_heads, int sq, int sk, int d,
                                     int causal, cudaStream_t stream) {
  const int dp = (d + 7) / 8 * 8;
  if (d < 1 || d > 256 || (sq + 63) / 64 > 65535 ||
      ((uintptr_t)qp | (uintptr_t)kp | (uintptr_t)vp) % 16 != 0)
    return cudaErrorInvalidValue;
  const cudaError_t bound = bind_device(qp);
  if (bound != cudaSuccess) return bound;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int q_rows = d <= 128 ? 128 : 64;  // the instance's query rows
  CUtensorMap qm, km, vm;
  if (!make_planes_map(encode, &qm, qp, batch_heads, sq, dp, q_rows) ||
      !make_planes_map(encode, &km, kp, batch_heads, sk, dp, kBlockN) ||
      !make_planes_map(encode, &vm, vp, batch_heads, sk, dp, kBlockN))
    return cudaErrorInvalidValue;
  if (d <= 64)
    return launch<1, 1, 2, 8>(qm, km, vm, o, batch_heads, sq, sk, d, causal,
                              stream);
  if (d <= 128)
    return launch<2, 2, 2, 8>(qm, km, vm, o, batch_heads, sq, sk, d, causal,
                              stream);
  if (d <= 192)
    return launch<3, 2, 1, 6>(qm, km, vm, o, batch_heads, sq, sk, d, causal,
                              stream);
  return launch<4, 2, 1, 4>(qm, km, vm, o, batch_heads, sq, sk, d, causal,
                            stream);
}
