// C entry points of the flash-attention library (loaded with ctypes by
// incubator_mxnet_tpu_torch/cuda_build.py), one for each route of the kernel
// that replaces the TPU kernel incubator_mxnet_tpu/ops/attention.py:
// _flash_kernel:
//   bfloat16, float16: flash_attention_sm90.cu (wgmma, TMA, P split into two
//             halves of the input's type);
//   float32, and any mix of dtypes: flash_attention_f32_sm90.cu (each
//             operand split into three bf16 planes by a pass of its own, which
//             reads each input at its own dtype, six products on wgmma).
// Head dims 1..256 on every route. Each returns the cudaError_t of its launch
// (0 = success); the launches run on the caller's stream and allocate
// nothing.

#include <cuda_runtime.h>

cudaError_t flash_attention_sm90_16bit(const void* q, const void* k,
                                       const void* v, void* o,
                                       int batch_heads, int sq, int sk, int d,
                                       float scale, int causal, int is_half,
                                       cudaStream_t stream);
cudaError_t flash_attention_sm90_f32_split(const void* x, long long st0,
                                           long long st1, long long st2,
                                           long long st3, void* planes, int b,
                                           int h, int s, int d, float mul,
                                           int dtype, cudaStream_t stream);
cudaError_t flash_attention_sm90_f32(const void* qp, const void* kp,
                                     const void* vp, float* o,
                                     int batch_heads, int sq, int sk, int d,
                                     int causal, cudaStream_t stream);

namespace {

constexpr int kMaxHeadDim = 256;

bool valid_shape(int batch_heads, int sq, int sk, int d) {
  return d >= 1 && d <= kMaxHeadDim && sq >= 1 && sk >= 1 &&
         batch_heads >= 1 && (sq + 63) / 64 <= 65535;
}

}  // namespace

// q, o: (batch_heads, sq, d); k, v: (batch_heads, sk, d); contiguous bf16
// with 16-byte aligned bases; d a multiple of 8 up to 256.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int batch_heads,
                                    int sq, int sk, int d, float scale,
                                    int causal, void* stream) {
  if (!valid_shape(batch_heads, sq, sk, d)) return (int)cudaErrorInvalidValue;
  return (int)flash_attention_sm90_16bit(q, k, v, o, batch_heads, sq, sk, d,
                                         scale, causal, 0,
                                         static_cast<cudaStream_t>(stream));
}

// The same for float16 q, k, v, o.
extern "C" int flash_attention_f16(const void* q, const void* k,
                                   const void* v, void* o, int batch_heads,
                                   int sq, int sk, int d, float scale,
                                   int causal, void* stream) {
  if (!valid_shape(batch_heads, sq, sk, d)) return (int)cudaErrorInvalidValue;
  return (int)flash_attention_sm90_16bit(q, k, v, o, batch_heads, sq, sk, d,
                                         scale, causal, 1,
                                         static_cast<cudaStream_t>(stream));
}

// The f32 route's split pass: x (b, h, s, d) at element strides st0..st3, of
// dtype 0 (f32), 1 (bf16) or 2 (f16), times mul, into planes (3, b·h, s, dp)
// bf16 (dp = d rounded up to a multiple of 8, zeros past d), 16-byte aligned.
extern "C" int flash_attention_f32_split(const void* x, long long st0,
                                         long long st1, long long st2,
                                         long long st3, void* planes, int b,
                                         int h, int s, int d, float mul,
                                         int dtype, void* stream) {
  if (d > kMaxHeadDim || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
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

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
