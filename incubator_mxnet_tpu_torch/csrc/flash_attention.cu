// C entry points of the flash-attention library (loaded with ctypes by
// incubator_mxnet_tpu_torch/cuda_build.py), one for each route of the kernel
// that replaces the TPU kernel incubator_mxnet_tpu/ops/attention.py:
// _flash_kernel:
//   bfloat16: flash_attention_sm90.cu (wgmma, TMA, P split into two halves);
//   float32:  flash_attention_f32_sm90.cu (each operand split into three
//             bf16 planes by a pass of its own, six products on wgmma).
// Each returns the cudaError_t of its launch (0 = success); the launches run
// on the caller's stream and allocate nothing.

#include <cuda_runtime.h>

cudaError_t flash_attention_sm90_bf16(const void* q, const void* k,
                                      const void* v, void* o,
                                      int batch_heads, int sq, int sk, int d,
                                      float scale, int causal,
                                      cudaStream_t stream);
cudaError_t flash_attention_sm90_f32_split(const float* x, long long st0,
                                           long long st1, long long st2,
                                           long long st3, void* planes, int b,
                                           int h, int s, int d, float mul,
                                           cudaStream_t stream);
cudaError_t flash_attention_sm90_f32(const void* qp, const void* kp,
                                     const void* vp, float* o,
                                     int batch_heads, int sq, int sk, int d,
                                     int causal, cudaStream_t stream);

namespace {

bool valid_shape(int batch_heads, int sq, int sk, int d) {
  return d >= 1 && d <= 128 && sq >= 1 && sk >= 1 && batch_heads >= 1 &&
         (sq + 127) / 128 <= 65535;
}

}  // namespace

// q, o: (batch_heads, sq, d); k, v: (batch_heads, sk, d); contiguous bf16
// with 16-byte aligned bases; d a multiple of 8 up to 128.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int batch_heads,
                                    int sq, int sk, int d, float scale,
                                    int causal, void* stream) {
  if (!valid_shape(batch_heads, sq, sk, d)) return (int)cudaErrorInvalidValue;
  return (int)flash_attention_sm90_bf16(q, k, v, o, batch_heads, sq, sk, d,
                                        scale, causal,
                                        static_cast<cudaStream_t>(stream));
}

// The f32 route's split pass: x (b, h, s, d) f32 at element strides
// st0..st3, times mul, into planes (3, b·h, s, dp) bf16 (dp = d rounded up
// to a multiple of 8, zeros past d), 16-byte aligned.
extern "C" int flash_attention_f32_split(const void* x, long long st0,
                                         long long st1, long long st2,
                                         long long st3, void* planes, int b,
                                         int h, int s, int d, float mul,
                                         void* stream) {
  if (d > 128) return (int)cudaErrorInvalidValue;
  return (int)flash_attention_sm90_f32_split(
      static_cast<const float*>(x), st0, st1, st2, st3, planes, b, h, s, d,
      mul, static_cast<cudaStream_t>(stream));
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
