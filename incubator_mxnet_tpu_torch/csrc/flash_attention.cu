// C entry points of the flash-attention library (loaded with ctypes by
// incubator_mxnet_tpu_torch/cuda_build.py), one for each route of the kernel
// that replaces the TPU kernel incubator_mxnet_tpu/ops/attention.py:
// _flash_kernel:
//   bfloat16, float16: flash_attention_sm90.cu (wgmma, TMA, P split into two
//             halves of the input's type);
//   float32, and any mix of dtypes: flash_attention_f32_sm90.cu (each
//             operand split into three bf16 planes by a pass of its own, which
//             reads each input at its own dtype, six products on wgmma).
// Head dims 1..256 on those routes; head dims above 256:
// flash_attention_wide_sm90.cu (wgmma, TMA, Q and K streamed in 64-column
// panels), route A for bfloat16 and float16 (P split into two halves), route
// B for float32 and any mix (over the same split pass's planes, six
// products). The backward of the bfloat16 and float16 routes at
// head dims 1..128 (the gradient of _flash_kernel, the JAX build's
// _flash_bwd): flash_attention_bwd_sm90.cu (two wgmma kernels, dQ and
// dK/dV, over the row stats that the forward wrote). Each returns the cudaError_t of its launch (0 = success);
// the launches run on the caller's stream and allocate nothing.

#include <cuda_runtime.h>

cudaError_t flash_attention_sm90_16bit(const void* q, const void* k,
                                       const void* v, void* o,
                                       int batch_heads, int sq, int sk, int d,
                                       float scale, int causal, void* stats,
                                       int is_half, cudaStream_t stream);
cudaError_t flash_attention_sm90_f32_split(const void* x, long long st0,
                                           long long st1, long long st2,
                                           long long st3, void* planes, int b,
                                           int h, int s, int d, float mul,
                                           int dtype, cudaStream_t stream);
cudaError_t flash_attention_sm90_f32(const void* qp, const void* kp,
                                     const void* vp, float* o,
                                     int batch_heads, int sq, int sk, int d,
                                     int causal, cudaStream_t stream);
cudaError_t flash_attention_bwd_sm90_16bit(
    const void* q, const void* k, const void* v, const void* out,
    const void* g, void* dq, void* dk, void* dv, void* stats,
    int batch_heads, int sq, int sk, int d, float scale, int causal,
    int is_half, cudaStream_t stream);
cudaError_t flash_attention_wide_sm90_16bit(const void* q, const void* k,
                                            const void* v, void* o,
                                            int batch_heads, int sq, int sk,
                                            int d, float scale, int causal,
                                            int is_half, cudaStream_t stream);
cudaError_t flash_attention_wide_sm90_f32(const void* qp, const void* kp,
                                          const void* vp, float* o,
                                          int batch_heads, int sq, int sk,
                                          int d, int causal,
                                          cudaStream_t stream);

namespace {

constexpr int kMaxHeadDim = 256;

bool valid_rows(int batch_heads, int sq, int sk) {
  return sq >= 1 && sk >= 1 && batch_heads >= 1 && (sq + 63) / 64 <= 65535;
}

bool valid_shape(int batch_heads, int sq, int sk, int d) {
  return d >= 1 && d <= kMaxHeadDim && valid_rows(batch_heads, sq, sk);
}

// head dims above kMaxHeadDim: the wide routes
bool valid_wide_shape(int batch_heads, int sq, int sk, int d) {
  return d > kMaxHeadDim && valid_rows(batch_heads, sq, sk);
}

}  // namespace

// q, o: (batch_heads, sq, d); k, v: (batch_heads, sk, d); contiguous bf16
// with 16-byte aligned bases; d a multiple of 8 up to 256. stats: null, or
// (training, d <= 128) f32 (batch_heads, sq rounded up to 128, 4), 16-byte
// aligned, where each row's (m, 1 / l) for the backward kernel is written.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int batch_heads,
                                    int sq, int sk, int d, float scale,
                                    int causal, void* stats, void* stream) {
  if (!valid_shape(batch_heads, sq, sk, d)) return (int)cudaErrorInvalidValue;
  return (int)flash_attention_sm90_16bit(q, k, v, o, batch_heads, sq, sk, d,
                                         scale, causal, stats, 0,
                                         static_cast<cudaStream_t>(stream));
}

// The same for float16 q, k, v, o.
extern "C" int flash_attention_f16(const void* q, const void* k,
                                   const void* v, void* o, int batch_heads,
                                   int sq, int sk, int d, float scale,
                                   int causal, void* stats, void* stream) {
  if (!valid_shape(batch_heads, sq, sk, d)) return (int)cudaErrorInvalidValue;
  return (int)flash_attention_sm90_16bit(q, k, v, o, batch_heads, sq, sk, d,
                                         scale, causal, stats, 1,
                                         static_cast<cudaStream_t>(stream));
}

// The f32 routes' split pass (any d >= 1): x (b, h, s, d) at element strides
// st0..st3, of dtype 0 (f32), 1 (bf16) or 2 (f16), times mul, into planes
// (3, b·h, s, dp) bf16 (dp = d rounded up to a multiple of 8, zeros past d),
// 16-byte aligned.
extern "C" int flash_attention_f32_split(const void* x, long long st0,
                                         long long st1, long long st2,
                                         long long st3, void* planes, int b,
                                         int h, int s, int d, float mul,
                                         int dtype, void* stream) {
  if (dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  return (int)flash_attention_sm90_f32_split(
      x, st0, st1, st2, st3, planes, b, h, s, d, mul, dtype,
      static_cast<cudaStream_t>(stream));
}

// The f32 route's attention over the planes of the split pass: qp
// (3, batch_heads, sq, dp) of q times its scale, kp and vp (3, batch_heads,
// sk, dp); o (batch_heads, sq, d) f32 contiguous.
extern "C" int flash_attention_f32(const void* qp, const void* kp,
                                   const void* vp, void* o, int batch_heads,
                                   int sq, int sk, int d, int causal,
                                   void* stream) {
  if (!valid_shape(batch_heads, sq, sk, d)) return (int)cudaErrorInvalidValue;
  return (int)flash_attention_sm90_f32(qp, kp, vp, static_cast<float*>(o),
                                       batch_heads, sq, sk, d, causal,
                                       static_cast<cudaStream_t>(stream));
}

// Route A of the head dims above 256: q, o (batch_heads, sq, d); k, v
// (batch_heads, sk, d); contiguous bf16 with 16-byte aligned bases; d a
// multiple of 8 above 256.
extern "C" int flash_attention_wide_bf16(const void* q, const void* k,
                                         const void* v, void* o,
                                         int batch_heads, int sq, int sk,
                                         int d, float scale, int causal,
                                         void* stream) {
  if (!valid_wide_shape(batch_heads, sq, sk, d))
    return (int)cudaErrorInvalidValue;
  return (int)flash_attention_wide_sm90_16bit(
      q, k, v, o, batch_heads, sq, sk, d, scale, causal, 0,
      static_cast<cudaStream_t>(stream));
}

// The same for float16 q, k, v, o.
extern "C" int flash_attention_wide_f16(const void* q, const void* k,
                                        const void* v, void* o,
                                        int batch_heads, int sq, int sk,
                                        int d, float scale, int causal,
                                        void* stream) {
  if (!valid_wide_shape(batch_heads, sq, sk, d))
    return (int)cudaErrorInvalidValue;
  return (int)flash_attention_wide_sm90_16bit(
      q, k, v, o, batch_heads, sq, sk, d, scale, causal, 1,
      static_cast<cudaStream_t>(stream));
}

// Route B of the head dims above 256, over the planes of the split pass: qp
// (3, batch_heads, sq, dp) of q times its scale, kp and vp (3, batch_heads,
// sk, dp); o (batch_heads, sq, d) f32 contiguous.
extern "C" int flash_attention_wide_f32(const void* qp, const void* kp,
                                        const void* vp, void* o,
                                        int batch_heads, int sq, int sk,
                                        int d, int causal, void* stream) {
  if (!valid_wide_shape(batch_heads, sq, sk, d))
    return (int)cudaErrorInvalidValue;
  return (int)flash_attention_wide_sm90_f32(
      qp, kp, vp, static_cast<float*>(o), batch_heads, sq, sk, d, causal,
      static_cast<cudaStream_t>(stream));
}

// The backward of the bf16 route: q, out, g, dq (batch_heads, sq, d); k, v,
// dk, dv (batch_heads, sk, d); contiguous bf16 with 16-byte aligned bases, d
// a multiple of 8 up to 128; stats: the forward's row stats (its stats
// argument), where the backward adds each row's delta.
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k,
                                        const void* v, const void* out,
                                        const void* g, void* dq, void* dk,
                                        void* dv, void* stats,
                                        int batch_heads, int sq, int sk, int d,
                                        float scale, int causal,
                                        void* stream) {
  if (!valid_shape(batch_heads, sq, sk, d)) return (int)cudaErrorInvalidValue;
  return (int)flash_attention_bwd_sm90_16bit(
      q, k, v, out, g, dq, dk, dv, stats, batch_heads, sq, sk, d, scale,
      causal, 0, static_cast<cudaStream_t>(stream));
}

// The same for float16 q, k, v, out, g, dq, dk, dv.
extern "C" int flash_attention_bwd_f16(const void* q, const void* k,
                                       const void* v, const void* out,
                                       const void* g, void* dq, void* dk,
                                       void* dv, void* stats, int batch_heads,
                                       int sq, int sk, int d, float scale,
                                       int causal, void* stream) {
  if (!valid_shape(batch_heads, sq, sk, d)) return (int)cudaErrorInvalidValue;
  return (int)flash_attention_bwd_sm90_16bit(
      q, k, v, out, g, dq, dk, dv, stats, batch_heads, sq, sk, d, scale,
      causal, 1, static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
