// Building blocks shared by the Hopper (sm_90a) flash-attention kernels: the
// 16-bit forward, bf16 and f16 (flash_attention_sm90.cu), the f32 forward
// (flash_attention_f32_sm90.cu), the forward at head dims above 256
// (flash_attention_wide_sm90.cu) and the 16-bit backward
// (flash_attention_bwd_sm90.cu). mbarriers with a trap on a stuck wait, TMA
// tile loads, wgmma m64n64k16 (bf16 or f16 operands, f32 accumulator) on
// 128-byte-swizzled shared memory, the empty register fences around
// asynchronous wgmma, the 16-bit routes' S = A·Bᵀ and O += P·V products with
// P split into two halves, the f32 routes' three-way bf16 split and the order
// of their six products, the online softmax of one S tile in log2 units, the
// binding of the operands' device in the calling thread, and the CUDA
// driver's tensor-map encoder with the 16-bit routes' panel maps and the f32
// routes' plane maps.
// Layout and exactness notes are in the kernels' sources.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math_constants.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kBlockM = 128;                 // query rows per block
constexpr int kBlockN = 64;                  // keys per tile
constexpr int kPanel = 64;                   // bf16 columns per swizzled panel
constexpr int kConsumers = 256;              // two warpgroups
constexpr int kThreads = kConsumers + 32;    // and one producer warp
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

// TMA: one box of a 4-d tensor map (coordinates innermost first)
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
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

// the 32 f32 registers of a thread's share of a 64 x 64 accumulator, as
// read-write asm operands
#define WGMMA_ACC32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define WGMMA_D32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"
// wgmma m64n64k16 with both operands in shared memory (K-major), and with A
// from registers and B MN-major (transpose bit), for element type TY
#define WGMMA_SS(TY)                                                          \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                               \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " WGMMA_D32       \
  ", %32, %33, p, 1, 1, 0, 0;\n}\n"
#define WGMMA_RS(TY)                                                          \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                               \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " WGMMA_D32       \
  ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"

// d (64 x 64, f32) = A·B (+ d when accumulate), A 64 x 16 and B 16 x 64 of
// element type T (bf16 or f16), both K-major in shared memory
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(WGMMA_SS("f16")
                 : WGMMA_ACC32(d)
                 : "l"(desc_a), "l"(desc_b), "r"(accumulate));
  else
    asm volatile(WGMMA_SS("bf16")
                 : WGMMA_ACC32(d)
                 : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64, f32) += A·B, A 64 x 16 of T from registers (four T x2 per
// thread) and B 16 x 64 of T MN-major from shared memory (transpose bit)
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t desc_b) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(WGMMA_RS("f16")
                 : WGMMA_ACC32(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
                   "r"(1));
  else
    asm volatile(WGMMA_RS("bf16")
                 : WGMMA_ACC32(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
                   "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (a, b) rounded to T and packed as one T x2 register; *back gets the two
// rounded values in f32
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16, float a, float b,
                                          float2* back) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  if (back != nullptr) *back = __bfloat1622float2(h);
  return bf16x2_bits(h);
}
__device__ __forceinline__ uint32_t pack2(__half, float a, float b,
                                          float2* back) {
  __half2 h = __floats2half2_rn(a, b);
  if (back != nullptr) *back = __half22float2(h);
  return *reinterpret_cast<uint32_t*>(&h);
}

// S = A·Bᵀ for one warpgroup: A its 64 rows of a resident 128-row tile (Q in
// the forward; panels kQPanel apart), B one 64-row tile of the ring (K;
// panels kKVPanel apart), both K-major, over NQK panels of 64 columns in k16
// steps of 32 bytes inside each 128-byte row; one commit group
template <typename T, int NQK>
__device__ __forceinline__ void issue_qk16(float (&sacc)[32], uint32_t a_wg,
                                           uint32_t b_t) {
#pragma unroll
  for (int kk = 0; kk < 4 * NQK; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss<T>(sacc, smem_desc(a_wg + (kk / 4) * kQPanel + off, 16, 1024),
                smem_desc(b_t + (kk / 4) * kKVPanel + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P_hi·V + P_lo·V, one panel of V (64 output columns) at a time, a k16
// step being 16 rows of the 64-row tile V (2048 bytes); registers 4kk ..
// 4kk+3 of P are the A operand of step kk; one commit group
template <typename T, int NO>
__device__ __forceinline__ void issue_pv16(float (&oacc)[NO][32],
                                           const uint32_t (&p_hi)[16],
                                           const uint32_t (&p_lo)[16],
                                           uint32_t v_t) {
#pragma unroll
  for (int p = 0; p < NO; ++p) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = smem_desc(v_t + p * kKVPanel + kk * 2048, 1024, 1024);
      wgmma_rs<T>(oacc[p], &p_hi[4 * kk], dv);
      wgmma_rs<T>(oacc[p], &p_lo[4 * kk], dv);
    }
  }
  wgmma_commit();
}

// P = P_hi + P_lo, both packed in pairs into T x2: the accumulator pair
// (2i, 2i+1) is register i of wgmma's A-from-registers fragment
template <typename T>
__device__ __forceinline__ void split_p(const float (&p)[32],
                                        uint32_t (&p_hi)[16],
                                        uint32_t (&p_lo)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    float2 hf;
    p_hi[i] = pack2(T(), p[2 * i], p[2 * i + 1], &hf);
    p_lo[i] = pack2(T(), p[2 * i] - hf.x, p[2 * i + 1] - hf.y, nullptr);
  }
}

// The f32 routes' split (flash_attention_f32_sm90.cu, and route B of
// flash_attention_wide_sm90.cu).
constexpr int kPieces = 3;  // bf16 planes of each f32 operand: h, m, l

// Product i of the split, i = 0..5, in issue order lh, hl, mm, mh, hm, hh:
// the piece of the A operand and of the B operand (0 = h, 1 = m, 2 = l).
__device__ __forceinline__ constexpr int a_piece(int i) {
  return i == 0 ? 2 : (i == 2 || i == 3) ? 1 : 0;
}
__device__ __forceinline__ constexpr int b_piece(int i) {
  return i == 1 ? 2 : (i == 2 || i == 4) ? 1 : 0;
}

__device__ __forceinline__ void fence_regs(uint32_t (&r)[kPieces][16]) {
#pragma unroll
  for (int p = 0; p < kPieces; ++p) fence_regs(r[p]);
}

// The three bf16 pieces of the pair (x0, x1), packed as bf16x2 into w[0],
// w[stride], w[2 * stride]: each piece is the rounding of what the earlier
// ones left, and the subtractions are exact in f32.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t* w,
                                           int stride) {
#pragma unroll
  for (int p = 0; p < kPieces; ++p) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(x0, x1);
    w[p * stride] = bf16x2_bits(b);
    const float2 f = __bfloat1622float2(b);
    x0 -= f.x;
    x1 -= f.y;
  }
}

// o[col], o[col + 1] of one row, as far as they lie inside d
__device__ __forceinline__ void store_pair(float* row, int col, int d,
                                           float x0, float x1) {
  if (col + 1 < d && (d & 1) == 0) {
    *reinterpret_cast<float2*>(row + col) = make_float2(x0, x1);
  } else {
    if (col < d) row[col] = x0;
    if (col + 1 < d) row[col + 1] = x1;
  }
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


// Make the primary context of the device that holds p current in the calling
// thread. The tensor-map encoder is a CUDA driver call and fails without a
// current context (CUDA_ERROR_INVALID_CONTEXT), and this library's own runtime
// binds device 0 by default: a thread that has made no CUDA call yet has
// neither, such as autograd's worker thread when the caching allocator serves
// every buffer of a backward from memory it already holds.
inline cudaError_t bind_device(const void* p) {
  cudaPointerAttributes attr;
  const cudaError_t err = cudaPointerGetAttributes(&attr, p);
  if (err != cudaSuccess) return err;
  return cudaSetDevice(attr.device);
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

// A (batch_heads, rows, d) tensor of 16-bit `type` as a 3-d TMA map whose box
// is one panel of 64 columns by box_rows rows of one (batch, head): rows past
// `rows` and columns past d read as zeros.
bool make_map(EncodeTiledFn encode, CUtensorMap* map, CUtensorMapDataType type,
              const void* ptr, int batch_heads, int rows, int d,
              int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)batch_heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kPanel, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The planes (3, batch_heads, rows, dp) bf16 as a 4-d TMA map (columns,
// rows, b·h, plane) whose box is one panel of 64 columns by box_rows rows of
// one plane of one (batch, head): rows past `rows` and columns past dp read
// as zeros.
bool make_planes_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr,
                     int batch_heads, int rows, int dp, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)dp, (cuuint64_t)rows,
                              (cuuint64_t)batch_heads, (cuuint64_t)kPieces};
  const cuuint64_t strides[3] = {(cuuint64_t)dp * 2,
                                 (cuuint64_t)rows * dp * 2,
                                 (cuuint64_t)batch_heads * rows * dp * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kPanel, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
