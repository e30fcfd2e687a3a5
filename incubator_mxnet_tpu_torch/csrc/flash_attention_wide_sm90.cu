// Flash-attention forward for Hopper (sm_90a) at head dims above 256: wgmma
// on the tensor cores, TMA loads into 128-byte-swizzled shared memory, with
// Q and K streamed through a ring of 64 x 64 panels so that shared memory
// stays bounded at every head dim.
//
// Replaces the TPU kernel incubator_mxnet_tpu/ops/attention.py:_flash_kernel
// (:56, launched by _flash_forward_pallas :98) for D > 256, which the TPU
// build pads to a multiple of 128 and runs through the same kernel. Two
// routes, the counterparts of the two routes at D <= 256:
//   route A, all bf16 or all f16 (flash_fwd_wide16_kernel): the 16-bit
//     route's exactness rules (flash_attention_sm90.cu): S on bf16 (f16)
//     wgmma into f32, whose products of two 16-bit values are exact, and
//     O += P_hi·V + P_lo·V with P split into two halves of the type;
//   route B, f32 and any mix of dtypes (flash_fwd_wide_f32_kernel): the f32
//     route's (flash_attention_f32_sm90.cu) over the three bf16 planes of
//     q·scale, k and v that its split pass writes (split3_kernel, any D):
//     six bf16 products per f32 product, the small terms first, and P split
//     into three pieces. Q and K stream panel by panel, so S walks the
//     head-dim panels twice per key tile: the five small products (lh, hl,
//     mm, mh, hm) of every panel, then hh of every panel. Adding a late
//     panel's small terms to the hh sums of the earlier panels instead (one
//     walk) put the kernel 2.8e-5 from the JAX build at D = 1100 on the card
//     (tests/test_torch_flash_backward.py; the tensor cores' f32 sums lose
//     the small terms' low bits against a large accumulator); in two walks
//     it stays within 2e-5, for about 0.16 ms at (8, 8, 1024, 512) causal.
// flash_attention.cu holds their C entry points. Both compute the
// reference's function: o = softmax(q·kᵀ·scale)·v with every product at the
// TPU kernel's Precision.HIGHEST, masked logits at the finite -1e30
// sentinel, the causal diagonal anchored at the end of the key axis (row i
// sees keys j <= i + Sk - Sq), a row that sees no key averaging V uniformly,
// and o = acc / max(l, 1e-20), rounded once to the 16-bit type (route A) or
// written in f32 (route B; the wrapper returns q's dtype).
//
// What bounds it on this card: at (8, 8, 1024, 512) causal, the serving
// shape's work at D = 512, the mask lets through 68.7 GFLOP (S 34.4, P·V
// 34.4) on 268 MB of bf16 q, k, v and o: 0.080 ms for the bytes at
// 3.35 TB/s against 0.069 ms of bf16 tensor work at 989 TFLOP/s, so the
// bytes bound route A; in f32, 537 MB (0.160 ms) against the split's six
// products, 413 GFLOP, 0.417 ms, so the operations bound route B. The
// designs issue more. Route A computes S once per 256 output columns
// (twice at D = 512) and P·V twice (the split); counted over whole 64 x 64
// tiles across the diagonal (chip_smoke.py's wide_tensor_work) that is
// 146 GFLOP, a floor of 0.148 ms. Route B computes S once per 256 output
// columns with six products and P·V with six, 657 GFLOP, a floor of
// 0.664 ms, beside its split pass (403 MB in, 604 MB out, 0.30 ms); its
// second walk reads Q_h and K_h again (8 panels per head-dim panel instead
// of 6), shared-memory traffic the floor does not count.
//
// What the design does about the five causes that held back the port's
// CUDA-core kernel for these head dims (PERF.md):
//  1. CUDA-core f32 FMAs: every product is wgmma m64n64k16, both operands of
//     S from shared memory through descriptors, P from registers for P·V;
//  2. S recomputed for every 128-column output slice: a block owns 256
//     output columns (3 or 4 panels, NO), so S is computed once per 256
//     columns (ceil(D / 256) times, twice at D = 512);
//  3. scalar loads widened to f32: no thread loads an operand; TMA writes
//     16-bit panels (route B: bf16 planes) that wgmma reads itself;
//  4. no overlap: one producer warp keeps up to 16 or 27 panels in flight
//     by TMA on per-slot mbarriers; the consumers issue S panel by panel, one
//     commit group each, and free a panel's slots once a later group is
//     issued and its own have completed (up to kLag groups of 4 wgmma in
//     flight); route A issues P·V of tile t-1 after S of tile t and runs
//     the softmax of tile t while that P·V is still on the tensor cores
//     (route B runs S, softmax and P·V in turn: its three P pieces and O
//     leave no registers for overlap);
//  5. P through shared memory: the S accumulator's pairs are wgmma's
//     A-from-registers fragment, so P stays in registers.
//
// Layout. One block per (64 query rows, b·h, slice of 256 output columns),
// the heaviest causal tiles first; 160 threads: one consumer warpgroup and
// one producer warp. One warpgroup lifts ptxas's register cap from 168 (nine
// warps) to 255: O over 256 columns is 128 f32 registers a thread, beside S
// (32) and P's pieces (32 in route A, 48 in route B). The slice width is 3 or
// 4 panels of 64 (NO = ceil(panels / ceil(panels / 4))), so D = 320 takes
// two slices of 3 panels and D = 512 two of 4; a V panel past D loads the
// last panel again (its columns are never stored), so every wgmma runs
// unconditionally. Every ring slot is one 64 x 64 panel, 8 KB, with a full
// and an empty mbarrier. Per key tile, route A's producer loads K's panels
// (and, where Q is streamed, each Q panel before its K panel) for S, then
// V's slice panels for P·V; route B's loads Q's and K's plane panels for
// each head-dim panel, then K's h panels again (and Q's, where it streams)
// for the hh walk, then V's three planes of each slice panel. Up to 12
// head-dim panels (D <= 768), Q (route A) or Q's plane h (route B) stays in
// shared memory, beside a 16-slot ring (225 KB at 12 panels); above that it
// streams beside K through a 27-slot ring (217 KB). Route B's planes m and l
// always stream: a 64-row block's three planes at D = 512 are 192 KB.
// Resident panels are loaded once per block instead of once per key tile,
// and the deeper ring keeps more panels in flight. The ring's size is known
// at compile time, so that an item's slot is a cheap modulo. The swizzle,
// the wgmma descriptors, the masks and the ragged edges are those of
// flash_attention_sm90.cu: TMA fills rows past Sq or Sk and columns past D
// with zeros, keys past Sk get -inf logits (p = 0), and key tiles past the
// last visible key of the block are skipped only when every row of the block
// sees some key. The kernels allocate nothing and run on the caller's
// stream.

#include "flash_sm90_common.cuh"

namespace {

constexpr int kRows = 64;                     // query rows a block
constexpr int kWarps = 4;                     // consumer warps: one warpgroup
constexpr int kWideThreads = kWarps * 32 + 32;
constexpr int kSlot = kKVPanel;               // one 64 x 64 16-bit panel
// Q (route A) and Q's plane h (route B) stay in shared memory up to this
// many panels (D <= 768), else they stream beside K
constexpr int kResidentPanels = 12;
// ring slots beside resident panels (up to 12: 224 KB with the ring) and
// without them; known at compile time, so that an item's slot is a cheap
// modulo
constexpr int kSlotsResident = 16;
constexpr int kSlotsStreamed = 27;
// commit groups of 4 wgmma (an S panel of route A, an hh panel of route B)
// left in flight before the oldest one's slots are freed
constexpr int kLag = 5;

// The ring both routes share: SLOTS slots with per-slot full and empty
// barriers, an item counter that producer and consumer advance in the same
// order.
template <int SLOTS>
struct Ring {
  static constexpr unsigned slots = SLOTS;
  uint32_t base, bar_full, bar_empty;
  __device__ uint32_t slot(unsigned i) const {
    return base + (i % slots) * kSlot;
  }
  __device__ void wait_full(unsigned i) const {
    mbar_wait(bar_full + 8 * (i % slots), (i / slots) & 1);
  }
  // producer: wait until item i's slot is free, and announce its bytes
  __device__ uint32_t acquire(unsigned i) const {
    const unsigned r = i % slots;
    if (i >= slots) mbar_wait(bar_empty + 8 * r, ((i / slots) - 1) & 1);
    mbar_expect_tx(bar_full + 8 * r, kSlot);
    return bar_full + 8 * r;
  }
  // consumer: one arrive per warp frees items first .. first + n - 1
  __device__ void release(unsigned first, int n, int lane) const {
    __syncwarp();
    if (lane == 0)
      for (int j = 0; j < n; ++j)
        mbar_arrive(bar_empty + 8 * ((first + j) % slots));
  }
};

// A block's rows, key tiles and output slice.
struct Block {
  int bh, q0, offset, n_tiles, o0, v_last;
};

__device__ __forceinline__ Block block_geometry(int sq, int sk, int dp,
                                                int no, int causal) {
  Block g;
  g.bh = blockIdx.x;
  // the heaviest causal tiles (last query rows) are scheduled first
  g.q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int q_rows = min(kRows, sq - g.q0);
  g.offset = sk - sq;  // row i sees keys j <= i + offset
  int n_end = sk;
  if (causal && g.q0 + g.offset >= 0)
    n_end = min(sk, g.q0 + q_rows + g.offset);
  g.n_tiles = (n_end + kBlockN - 1) / kBlockN;
  g.o0 = blockIdx.z * no * kPanel;
  g.v_last = (dp - 1) / kPanel * kPanel;
  return g;
}

// Initialize the barriers (Q's, then each slot's full and empty); every
// thread returns with the ring.
template <int SLOTS>
__device__ __forceinline__ Ring<SLOTS> init_ring(uint32_t base,
                                                 uint64_t* bars) {
  constexpr int slots = SLOTS;
  Ring<SLOTS> ring{base, smem_u32(&bars[1]), smem_u32(&bars[1 + slots])};
  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&bars[0]), 1);
    for (int r = 0; r < slots; ++r) {
      mbar_init(ring.bar_full + 8 * r, 1);
      mbar_init(ring.bar_empty + 8 * r, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return ring;
}

// o = acc / max(l, 1e-20) for this thread's two rows: the quad's sums
__device__ __forceinline__ void row_denominators(const RowState& rows,
                                                 float& den0, float& den1) {
  float l0 = rows.l0, l1 = rows.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  den0 = fmaxf(l0, 1e-20f);
  den1 = fmaxf(l1, 1e-20f);
}

// Route A's S = Q·Kᵀ of one key tile over the np head-dim panels from ring
// item `item` on (with QRES, Q's panels resident at q_s; else each Q panel
// is the item before its K panel), a commit group a panel; panel p's slots
// are freed once panel p + kLag is issued and p is done. Returns the next
// item, with the last min(np, kLag) panels' groups in flight and their slots
// held.
template <typename T, bool QRES, typename R>
__device__ __forceinline__ int issue_s16(float (&sacc)[32], const R& ring,
                                         uint32_t q_s, int item, int np,
                                         int lane) {
  constexpr int kPer = QRES ? 1 : 2;  // ring items of one panel
  // S starts from zeros in registers: every wgmma accumulates, since a
  // first wgmma that overwrites (scale-d 0, a runtime predicate in this
  // loop) made ptxas serialize the kernel's wgmmas (C7515)
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
  fence_regs(sacc);
  for (int p = 0; p < np; ++p) {
    const int i = item + p * kPer;
    const uint32_t a = QRES ? q_s + p * kSlot : ring.slot(i);
    const uint32_t b = ring.slot(i + kPer - 1);
    ring.wait_full(i);
    if (!QRES) ring.wait_full(i + 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<T>(sacc, smem_desc(a + kk * 32, 16, 1024),
                  smem_desc(b + kk * 32, 16, 1024), 1);
    wgmma_commit();
    if (p >= kLag) {
      wgmma_wait<kLag>();
      ring.release(i - kLag * kPer, kPer, lane);
    }
  }
  return item + np * kPer;
}

// Route A's O += P_hi·V + P_lo·V over the slice's NO panels, ring items
// item .. item + NO - 1, one commit group; returns the next item. The caller
// fences oacc, p_hi and p_lo first.
template <typename T, int NO, typename R>
__device__ __forceinline__ int issue_pv16_slice(float (&oacc)[NO][32],
                                                uint32_t (&p_hi)[16],
                                                uint32_t (&p_lo)[16],
                                                const R& ring, int item) {
  uint32_t v[NO];
#pragma unroll
  for (int p = 0; p < NO; ++p) {
    v[p] = ring.slot(item + p);
    ring.wait_full(item + p);
  }
  wgmma_fence();
#pragma unroll
  for (int p = 0; p < NO; ++p) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = smem_desc(v[p] + kk * 2048, 1024, 1024);
      wgmma_rs<T>(oacc[p], &p_hi[4 * kk], dv);
      wgmma_rs<T>(oacc[p], &p_lo[4 * kk], dv);
    }
  }
  wgmma_commit();
  return item + NO;
}

// Route A. T: __nv_bfloat16 or __half; NO: 64-column panels of the block's
// output slice (3 or 4); QRES: Q's np panels resident (else streamed, each Q
// panel just before its K panel). d is a multiple of 8.
template <typename T, int NO, bool QRES>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_fwd_wide16_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        T* __restrict__ o, int sq, int sk, int d, int np,
                        float scale, int causal) {
  constexpr int kPer = QRES ? 1 : 2;  // ring items of one S panel
  constexpr int kSlots = QRES ? kSlotsResident : kSlotsStreamed;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kSlots];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const auto ring = init_ring<kSlots>(q_s + (QRES ? np * kSlot : 0), bars);
  const uint32_t bar_q = smem_u32(&bars[0]);
  const Block g = block_geometry(sq, sk, d, NO, causal);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp == kWarps) {
    // producer: Q once where it stays; per key tile t the items of S(t),
    // then those of V(t-1), so that the consumer finds them in its order
    if (lane == 0) {
      if (QRES) {
        mbar_expect_tx(bar_q, np * kSlot);
        for (int p = 0; p < np; ++p)
          tma_load(q_s + p * kSlot, &qmap, p * kPanel, g.q0, g.bh, bar_q);
      }
      int i = 0;
      const auto put_s = [&](int t) {
        for (int p = 0; p < np; ++p) {
          if (!QRES) {
            const uint32_t bar = ring.acquire(i);
            tma_load(ring.slot(i++), &qmap, p * kPanel, g.q0, g.bh, bar);
          }
          const uint32_t bar = ring.acquire(i);
          tma_load(ring.slot(i++), &kmap, p * kPanel, t * kBlockN, g.bh, bar);
        }
      };
      const auto put_v = [&](int t) {
        for (int p = 0; p < NO; ++p) {
          const uint32_t bar = ring.acquire(i);
          tma_load(ring.slot(i++), &vmap, min(g.o0 + p * kPanel, g.v_last),
                   t * kBlockN, g.bh, bar);
        }
      };
      put_s(0);
      for (int t = 1; t < g.n_tiles; ++t) {
        put_s(t);
        put_v(t - 1);
      }
      put_v(g.n_tiles - 1);
    }
    return;
  }

  // consumer warpgroup: this thread holds rows r0 and r0 + 8
  const int t4 = lane % 4;
  const int r0 = g.q0 + warp * 16 + lane / 4;
  const float scale_log2 = scale * kLog2e;
  const auto edge = [&](int n0) {  // does the tile need the per-key mask?
    return n0 + kBlockN > sk || (causal && n0 + kBlockN - 1 > g.q0 + g.offset);
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
  int item = 0;  // the next ring item

  if (QRES) mbar_wait(bar_q, 0);
  const int held = min(np, kLag) * kPer;  // S's items still held at its end
  item = issue_s16<T, QRES>(sacc, ring, q_s, item, np, lane);
  wgmma_wait<0>();
  fence_regs(sacc);
  ring.release(item - held, held, lane);
  softmax_tile(sacc, 0, edge(0), sk, r0, g.offset, causal, scale_log2, t4,
               rows, alpha0, alpha1);
  split_p<T>(sacc, p_hi, p_lo);  // O is still 0: nothing to rescale
  for (int t = 1; t < g.n_tiles; ++t) {
    // S of tile t; then P·V of tile t-1, and the softmax of tile t while
    // that P·V is still on the tensor cores
    item = issue_s16<T, QRES>(sacc, ring, q_s, item, np, lane);
    wgmma_wait<0>();
    fence_regs(sacc);
    ring.release(item - held, held, lane);
    const int v_first = item;
    fence_regs(oacc);
    fence_regs(p_hi);
    fence_regs(p_lo);
    item = issue_pv16_slice<T, NO>(oacc, p_hi, p_lo, ring, item);
    softmax_tile(sacc, t * kBlockN, edge(t * kBlockN), sk, r0, g.offset,
                 causal, scale_log2, t4, rows, alpha0, alpha1);
    wgmma_wait<0>();
    fence_regs(oacc);
    fence_regs(p_hi);
    fence_regs(p_lo);
    ring.release(v_first, NO, lane);
    rescale(oacc, alpha0, alpha1);
    split_p<T>(sacc, p_hi, p_lo);
  }
  fence_regs(oacc);
  fence_regs(p_hi);
  fence_regs(p_lo);
  issue_pv16_slice<T, NO>(oacc, p_hi, p_lo, ring, item);  // the last P·V
  wgmma_wait<0>();
  fence_regs(oacc);
  fence_regs(p_hi);
  fence_regs(p_lo);

  float den0, den1;
  row_denominators(rows, den0, den1);
  const int r1 = r0 + 8;
  T* og = o + (long long)g.bh * sq * d;
#pragma unroll
  for (int p = 0; p < NO; ++p) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = g.o0 + p * kPanel + 8 * j + 2 * t4;
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

// Route B over the split planes (3, b·h, rows, dp) bf16 of q·scale, k and v.
// NO: 64-column panels of the output slice (3 or 4); QRES: the np panels of
// Q's plane h resident (else streamed with the other planes); np: head-dim
// panels.
template <int NO, bool QRES>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_fwd_wide_f32_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          float* __restrict__ o, int sq, int sk, int d,
                          int np, int causal) {
  // ring items of a panel's small products (Q's planes h, m, l and K's, less
  // Q's h where it stays) and of its hh product
  constexpr int kPerS = 2 * kPieces - QRES;
  constexpr int kPerH = 2 - QRES;
  constexpr int kSlots = QRES ? kSlotsResident : kSlotsStreamed;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kSlots];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const auto ring = init_ring<kSlots>(q_s + (QRES ? np * kSlot : 0), bars);
  const uint32_t bar_q = smem_u32(&bars[0]);
  const int dp = (d + 7) / 8 * 8;
  const Block g = block_geometry(sq, sk, dp, NO, causal);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp == kWarps) {
    // producer: per key tile, for each head-dim panel Q's planes h, m, l and
    // K's (the small products), then for each head-dim panel Q's plane h and
    // K's (hh), then for each slice panel V's planes h, m, l
    if (lane == 0) {
      if (QRES) {
        mbar_expect_tx(bar_q, np * kSlot);
        for (int p = 0; p < np; ++p)
          tma_load_4d(q_s + p * kSlot, &qmap, p * kPanel, g.q0, g.bh, 0,
                      bar_q);
      }
      int i = 0;
      const auto put_qk = [&](int t, int p, int pc) {
        uint32_t bar;
        if (!QRES || pc > 0) {
          bar = ring.acquire(i);
          tma_load_4d(ring.slot(i++), &qmap, p * kPanel, g.q0, g.bh, pc, bar);
        }
        bar = ring.acquire(i);
        tma_load_4d(ring.slot(i++), &kmap, p * kPanel, t * kBlockN, g.bh, pc,
                    bar);
      };
      for (int t = 0; t < g.n_tiles; ++t) {
        for (int p = 0; p < np; ++p)
          for (int pc = 0; pc < kPieces; ++pc) put_qk(t, p, pc);
        for (int p = 0; p < np; ++p) put_qk(t, p, 0);
        for (int p = 0; p < NO; ++p) {
          for (int pc = 0; pc < kPieces; ++pc) {
            const uint32_t bar = ring.acquire(i);
            tma_load_4d(ring.slot(i++), &vmap,
                        min(g.o0 + p * kPanel, g.v_last), t * kBlockN, g.bh,
                        pc, bar);
          }
        }
      }
    }
    return;
  }

  const int t4 = lane % 4;
  const int r0 = g.q0 + warp * 16 + lane / 4;
  const auto edge = [&](int n0) {
    return n0 + kBlockN > sk || (causal && n0 + kBlockN - 1 > g.q0 + g.offset);
  };

  float oacc[NO][32];
  float sacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sacc[i] = 0.f;
#pragma unroll
    for (int p = 0; p < NO; ++p) oacc[p][i] = 0.f;
  }
  uint32_t pp[kPieces][16];
  RowState rows;
  float alpha0, alpha1;
  int item = 0;

  if (QRES) mbar_wait(bar_q, 0);
  for (int t = 0; t < g.n_tiles; ++t) {
    // S = Σ_i Q_a(i)·K_b(i)ᵀ in two walks over the head-dim panels, a commit
    // group a panel: the five small products (lh, hl, mm, mh, hm) of every
    // panel first, then hh of every panel, so that the small terms are
    // summed while the accumulator is small and hh comes last, as the f32
    // route sums each product over the whole head dim in turn
    fence_regs(sacc);
    for (int p = 0; p < np; ++p) {
      const int i = item + p * kPerS;
      uint32_t pl[2 * kPieces];  // Q h, K h, Q m, K m, Q l, K l
      pl[0] = q_s + p * kSlot;   // replaced below where Q's h streams
#pragma unroll
      for (int j = 0; j < kPerS; ++j) {
        pl[j + QRES] = ring.slot(i + j);
        ring.wait_full(i + j);
      }
      wgmma_fence();
#pragma unroll
      for (int x = 0; x < 5; ++x) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(sacc, smem_desc(pl[2 * a_piece(x)] + kk * 32, 16, 1024),
                   smem_desc(pl[2 * b_piece(x) + 1] + kk * 32, 16, 1024),
                   p > 0 || x > 0 || kk > 0);
      }
      wgmma_commit();
      if (p > 0) {
        wgmma_wait<1>();
        ring.release(i - kPerS, kPerS, lane);
      }
    }
    item += np * kPerS;
    for (int p = 0; p < np; ++p) {
      const int i = item + kPerH * p;
      const uint32_t qh = QRES ? q_s + p * kSlot : ring.slot(i);
      const uint32_t kh = ring.slot(i + kPerH - 1);
      ring.wait_full(i);
      if (!QRES) ring.wait_full(i + 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(sacc, smem_desc(qh + kk * 32, 16, 1024),
                 smem_desc(kh + kk * 32, 16, 1024), 1);
      wgmma_commit();
      if (p == 0) {  // the last small-product panel
        wgmma_wait<1>();
        ring.release(i - kPerS, kPerS, lane);
      } else if (p >= kLag) {
        wgmma_wait<kLag>();
        ring.release(i - kPerH * kLag, kPerH, lane);
      }
    }
    item += kPerH * np;
    wgmma_wait<0>();
    fence_regs(sacc);
    ring.release(item - kPerH * min(np, kLag), kPerH * min(np, kLag), lane);
    // q was scaled in the split pass: log2(e) alone takes S to log2 units
    softmax_tile(sacc, t * kBlockN, edge(t * kBlockN), sk, r0, g.offset,
                 causal, kLog2e, t4, rows, alpha0, alpha1);
    rescale(oacc, alpha0, alpha1);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      split_pair(sacc[2 * i], sacc[2 * i + 1], &pp[0][i], 16);
    // O += Σ_i P_a(i)·V_b(i), a commit group a slice panel
    fence_regs(oacc);
    fence_regs(pp);
#pragma unroll
    for (int p = 0; p < NO; ++p) {
      const int i = item + p * kPieces;
      uint32_t pl[kPieces];
#pragma unroll
      for (int j = 0; j < kPieces; ++j) {
        pl[j] = ring.slot(i + j);
        ring.wait_full(i + j);
      }
      wgmma_fence();
#pragma unroll
      for (int x = 0; x < 6; ++x) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(oacc[p], &pp[a_piece(x)][4 * kk],
                   smem_desc(pl[b_piece(x)] + kk * 2048, 1024, 1024));
      }
      wgmma_commit();
      if (p > 0) {
        wgmma_wait<1>();
        ring.release(i - kPieces, kPieces, lane);
      }
    }
    item += NO * kPieces;
    wgmma_wait<0>();
    fence_regs(oacc);
    fence_regs(pp);
    ring.release(item - kPieces, kPieces, lane);
  }

  float den0, den1;
  row_denominators(rows, den0, den1);
  const int r1 = r0 + 8;
  float* og = o + (long long)g.bh * sq * d;
#pragma unroll
  for (int p = 0; p < NO; ++p) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = g.o0 + p * kPanel + 8 * j + 2 * t4;
      if (r0 < sq)
        store_pair(og + (long long)r0 * d, col, d, oacc[p][4 * j] / den0,
                   oacc[p][4 * j + 1] / den0);
      if (r1 < sq)
        store_pair(og + (long long)r1 * d, col, d, oacc[p][4 * j + 2] / den1,
                   oacc[p][4 * j + 3] / den1);
    }
  }
}

// The panels of a head dim of dp columns, and the slices' width: slices of
// at most 4 panels, as even as 3 or 4 panels make them.
inline int panels(int dp) { return (dp + kPanel - 1) / kPanel; }
inline int slice_panels(int np) {
  const int slices = (np + 3) / 4;
  return (np + slices - 1) / slices <= 3 ? 3 : 4;
}

// The dynamic shared memory of a launch: the resident panels, the ring, and
// room to align them to 1024 bytes.
inline int smem_bytes(int resident) {
  return (resident + (resident ? kSlotsResident : kSlotsStreamed)) * kSlot +
         1024;
}

template <typename T, int NO, bool QRES>
cudaError_t launch16(const CUtensorMap& qm, const CUtensorMap& km,
                     const CUtensorMap& vm, void* o, int batch_heads, int sq,
                     int sk, int d, int np, float scale, int causal,
                     cudaStream_t stream) {
  const auto kernel = flash_fwd_wide16_kernel<T, NO, QRES>;
  const int resident = QRES ? np : 0;
  const int smem = smem_bytes(resident);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch_heads, (sq + kRows - 1) / kRows, (np + NO - 1) / NO);
  kernel<<<grid, kWideThreads, smem, stream>>>(
      qm, km, vm, static_cast<T*>(o), sq, sk, d, np, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run16(CUtensorMapDataType type, const void* q, const void* k,
                  const void* v, void* o, int batch_heads, int sq, int sk,
                  int d, float scale, int causal, cudaStream_t stream) {
  if (d % 8 != 0 || d <= 256 || (sq + kRows - 1) / kRows > 65535 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0)
    return cudaErrorInvalidValue;
  const cudaError_t bound = bind_device(q);
  if (bound != cudaSuccess) return bound;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  if (!make_map(encode, &qm, type, q, batch_heads, sq, d, kRows) ||
      !make_map(encode, &km, type, k, batch_heads, sk, d, kBlockN) ||
      !make_map(encode, &vm, type, v, batch_heads, sk, d, kBlockN))
    return cudaErrorInvalidValue;
  const int np = panels(d);
  const bool resident = np <= kResidentPanels;
  if (slice_panels(np) == 3)
    return resident ? launch16<T, 3, true>(qm, km, vm, o, batch_heads, sq, sk,
                                           d, np, scale, causal, stream)
                    : launch16<T, 3, false>(qm, km, vm, o, batch_heads, sq,
                                            sk, d, np, scale, causal, stream);
  return resident ? launch16<T, 4, true>(qm, km, vm, o, batch_heads, sq, sk,
                                         d, np, scale, causal, stream)
                  : launch16<T, 4, false>(qm, km, vm, o, batch_heads, sq, sk,
                                          d, np, scale, causal, stream);
}

template <int NO, bool QRES>
cudaError_t launch_f32(const CUtensorMap& qm, const CUtensorMap& km,
                       const CUtensorMap& vm, float* o, int batch_heads,
                       int sq, int sk, int d, int np, int causal,
                       cudaStream_t stream) {
  const auto kernel = flash_fwd_wide_f32_kernel<NO, QRES>;
  const int resident = QRES ? np : 0;
  const int smem = smem_bytes(resident);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch_heads, (sq + kRows - 1) / kRows, (np + NO - 1) / NO);
  kernel<<<grid, kWideThreads, smem, stream>>>(qm, km, vm, o, sq, sk, d, np,
                                               causal);
  return cudaGetLastError();
}

}  // namespace

// Route A, entered by flash_attention_wide_bf16 and flash_attention_wide_f16
// (flash_attention.cu). q, o: (batch_heads, sq, d); k, v: (batch_heads, sk,
// d); contiguous bf16 (is_half 0) or f16 (is_half 1) with 16-byte aligned
// bases; d a multiple of 8 above 256.
cudaError_t flash_attention_wide_sm90_16bit(const void* q, const void* k,
                                            const void* v, void* o,
                                            int batch_heads, int sq, int sk,
                                            int d, float scale, int causal,
                                            int is_half, cudaStream_t stream) {
  if (is_half)
    return run16<__half>(CU_TENSOR_MAP_DATA_TYPE_FLOAT16, q, k, v, o,
                         batch_heads, sq, sk, d, scale, causal, stream);
  return run16<__nv_bfloat16>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, k, v, o,
                              batch_heads, sq, sk, d, scale, causal, stream);
}

// Route B over the split pass's planes: qp (3, batch_heads, sq, dp) of q
// already scaled, kp and vp (3, batch_heads, sk, dp), bf16, 16-byte aligned,
// dp = d rounded up to a multiple of 8; o (batch_heads, sq, d) f32
// contiguous; d above 256.
cudaError_t flash_attention_wide_sm90_f32(const void* qp, const void* kp,
                                          const void* vp, float* o,
                                          int batch_heads, int sq, int sk,
                                          int d, int causal,
                                          cudaStream_t stream) {
  const int dp = (d + 7) / 8 * 8;
  if (d <= 256 || (sq + kRows - 1) / kRows > 65535 ||
      ((uintptr_t)qp | (uintptr_t)kp | (uintptr_t)vp) % 16 != 0)
    return cudaErrorInvalidValue;
  const cudaError_t bound = bind_device(qp);
  if (bound != cudaSuccess) return bound;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  if (!make_planes_map(encode, &qm, qp, batch_heads, sq, dp, kRows) ||
      !make_planes_map(encode, &km, kp, batch_heads, sk, dp, kBlockN) ||
      !make_planes_map(encode, &vm, vp, batch_heads, sk, dp, kBlockN))
    return cudaErrorInvalidValue;
  const int np = panels(dp);
  const bool resident = np <= kResidentPanels;
  if (slice_panels(np) == 3)
    return resident ? launch_f32<3, true>(qm, km, vm, o, batch_heads, sq, sk,
                                          d, np, causal, stream)
                    : launch_f32<3, false>(qm, km, vm, o, batch_heads, sq, sk,
                                           d, np, causal, stream);
  return resident ? launch_f32<4, true>(qm, km, vm, o, batch_heads, sq, sk, d,
                                        np, causal, stream)
                  : launch_f32<4, false>(qm, km, vm, o, batch_heads, sq, sk,
                                         d, np, causal, stream);
}
