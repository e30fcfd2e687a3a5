// Flash-attention forward for Hopper (sm_90a), float32 route: CUDA cores,
// f32 arithmetic. The bf16 route is flash_attention_sm90.cu (wgmma, TMA); the
// C entry point flash_attention_fwd below picks the route by dtype.
//
// Replaces the TPU kernel incubator_mxnet_tpu/ops/attention.py:_flash_kernel
// (launched by _flash_forward_pallas). It computes the same function:
//   o = softmax(q·kᵀ·scale) · v   over (B, H, S, D) tensors,
// with an online max/sum rescaling over key tiles, the finite -1e30 sentinel
// for masked logits (so a query row that sees no key averages V uniformly, as
// the reference does), the causal diagonal anchored at the END of the key axis
// (row i sees keys j <= i + Sk - Sq), and o = acc / max(l, 1e-20). Every
// product and sum is float32, as the TPU kernel's Precision.HIGHEST is (no
// TF32).
//
// What bounds it on this card: at the serving shape (8, 32, 1024, 128) causal
// the work needs ~69 GFLOP; its float32 FMAs on the CUDA cores have a 67
// TFLOP/s ceiling, about 1 ms, far above the bytes' bound (0.16 ms for f32
// q, k, v and o at 3.35 TB/s). An f32-exact tensor-core design (split TF32)
// is later work; the serving path runs bf16 and does not launch this kernel.
//
// Design: one thread block per (query tile of 64 rows, batch*head). The Q tile
// is staged once in shared memory (pre-scaled); K and V tiles of 64 keys are
// staged one after the other through one shared buffer; m, l and the output
// accumulator stay in registers. 128 threads = 16 row groups x 8 column
// groups: a thread owns 4 query rows, 8 keys of each S tile (strided by 8)
// and ceil(D/8) output columns (strided by 8). Row max and row sum reduce over
// the 8 lanes of a row group with warp shuffles. Shared rows are padded by
// one float so strided column reads hit distinct banks. Under the causal mask,
// key tiles past the last visible key of the block are skipped, which is exact
// (their p is exp(-1e30 - m) = 0) unless some row of the block sees no key at
// all, and then every tile is visited as the reference's uniform average needs.
// Ragged edges (Sq, Sk not multiples of 64, D below its bucket) are masked in
// the kernel. The kernel allocates nothing; it runs on the caller's stream.

#include <cuda_runtime.h>
#include <math_constants.h>

// the bf16 route, in flash_attention_sm90.cu
cudaError_t flash_attention_sm90_bf16(const void* q, const void* k,
                                      const void* v, void* o,
                                      int batch_heads, int sq, int sk, int d,
                                      float scale, int causal,
                                      cudaStream_t stream);

namespace {

constexpr int kBlockM = 64;    // query rows per block
constexpr int kBlockN = 64;    // keys per tile
constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kRows = 4;       // query rows per thread
constexpr int kCols = 8;       // keys per thread in one S tile
constexpr float kSentinel = -1e30f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }

// Stage a (rows x d) tile of a row-major (*, d) matrix as float32 in shared
// memory with row stride ld, scaled by mul; rows at or past n_valid read 0.
template <typename T>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, int rows,
                                           int n_valid, int d, int ld,
                                           float mul) {
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    dst[r * ld + c] =
        r < n_valid ? load_f32(src + (long long)r * d + c) * mul : 0.f;
  }
}

// DPT: output columns per thread, ceil(D / 8) rounded up to 4, 8 or 16.
template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
                 int d, float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  const int ldp = kBlockN + 1;
  float* q_s = smem;                     // kBlockM x ld
  float* kv_s = q_s + kBlockM * ld;      // kBlockN x ld: K, then V
  float* p_s = kv_s + kBlockN * ld;      // kBlockM x ldp

  const int tid = threadIdx.x;
  const int ty = tid / kCols;            // rows ty*4 .. ty*4+3
  const int tx = tid % kCols;            // keys tx + 8j, columns tx + 8i
  const long long bh = blockIdx.x;
  // the heaviest causal tiles (last query rows) are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;
  const int q_rows = min(kBlockM, sq - q0);
  const T* kg = k + bh * sk * d;
  const T* vg = v + bh * sk * d;

  stage_tile(q_s, q + (bh * sq + q0) * d, kBlockM, q_rows, d, ld, scale);

  float m[kRows], l[kRows], acc[kRows][DPT];
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    m[a] = kSentinel;
    l[a] = 0.f;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[a][i] = 0.f;
  }

  const int offset = sk - sq;  // row i sees keys j <= i + offset
  int n_end = sk;
  if (causal && q0 + offset >= 0) n_end = min(sk, q0 + q_rows + offset);

  for (int n0 = 0; n0 < n_end; n0 += kBlockN) {
    const int n_rows = min(kBlockN, sk - n0);
    __syncthreads();  // the previous tile's reads of kv_s and p_s are done
    stage_tile(kv_s, kg + (long long)n0 * d, kBlockN, n_rows, d, ld, 1.f);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[a][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a) qv[a] = q_s[(ty * kRows + a) * ld + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = kv_s[(tx + kCols * j) * ld + c];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[a][j] = fmaf(qv[a], kv[j], s[a][j]);
    }

#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int row = q0 + ty * kRows + a;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = n0 + tx + kCols * j;
        if (col >= sk) {
          s[a][j] = -CUDART_INF_F;  // past the key axis: p = 0
        } else if (causal && col > row + offset) {
          s[a][j] = kSentinel;
        }
        mx = fmaxf(mx, s[a][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[a], mx);
      const float alpha = expf(m[a] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[a][j] = expf(s[a][j] - m_new);
        rs += s[a][j];
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[a] = l[a] * alpha + rs;
      m[a] = m_new;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[a][i] *= alpha;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        p_s[(ty * kRows + a) * ldp + tx + kCols * j] = s[a][j];
    }
    __syncthreads();  // every thread is done reading K and writing P
    stage_tile(kv_s, vg + (long long)n0 * d, kBlockN, n_rows, d, ld, 1.f);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBlockN; ++j) {
      float pv[kRows];
#pragma unroll
      for (int a = 0; a < kRows; ++a) pv[a] = p_s[(ty * kRows + a) * ldp + j];
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        const int c = tx + kCols * i;
        const float vv = c < d ? kv_s[j * ld + c] : 0.f;
#pragma unroll
        for (int a = 0; a < kRows; ++a) acc[a][i] = fmaf(pv[a], vv, acc[a][i]);
      }
    }
  }

  T* og = o + (bh * sq + q0) * d;
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int r = ty * kRows + a;
    if (r >= q_rows) continue;
    const float denom = fmaxf(l[a], 1e-20f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int c = tx + kCols * i;
      if (c < d) store_from_f32(og + (long long)r * d + c, acc[a][i] / denom);
    }
  }
}

template <typename T, int DPT>
cudaError_t launch_dpt(const void* q, const void* k, const void* v, void* o,
                       int batch_heads, int sq, int sk, int d, float scale,
                       int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(kBlockM + kBlockN) * (d + 1) +
                       (size_t)kBlockM * (kBlockN + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch_heads, (sq + kBlockM - 1) / kBlockM);
  flash_fwd_kernel<T, DPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, d, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch_heads, int sq, int sk, int d, float scale,
                   int causal, cudaStream_t stream) {
  if (d <= 32)
    return launch_dpt<T, 4>(q, k, v, o, batch_heads, sq, sk, d, scale, causal,
                            stream);
  if (d <= 64)
    return launch_dpt<T, 8>(q, k, v, o, batch_heads, sq, sk, d, scale, causal,
                            stream);
  return launch_dpt<T, 16>(q, k, v, o, batch_heads, sq, sk, d, scale, causal,
                           stream);
}

}  // namespace

// q, o: (batch_heads, sq, d); k, v: (batch_heads, sk, d); all contiguous and
// of one dtype, which picks the route: 0 = float32 (this file's CUDA-core
// kernel), 1 = bfloat16 (flash_attention_sm90.cu, which also needs d a
// multiple of 8 and 16-byte aligned pointers); 1 <= d <= 128; sq, sk >= 1;
// ceil(sq / 64) <= 65535. Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int batch_heads, int sq, int sk,
                                   int d, float scale, int causal, int dtype,
                                   void* stream) {
  if (d < 1 || d > 128 || sq < 1 || sk < 1 || batch_heads < 1 ||
      (sq + kBlockM - 1) / kBlockM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, o, batch_heads, sq, sk, d, scale,
                              causal, s);
  if (dtype == 1)
    return (int)flash_attention_sm90_bf16(q, k, v, o, batch_heads, sq, sk, d,
                                          scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
