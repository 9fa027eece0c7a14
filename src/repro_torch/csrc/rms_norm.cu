// Row-invariant RMS normalization for sm_90a:
//   y[r] = round(x[r] * rsqrt(mean(x[r]^2) + eps)) * w
// in float32, the normalized row rounded to x's dtype before the scale, as
// the port's layers.rms_norm (and the JAX package's) computes it.
//
// No Pallas kernel corresponds to it (the JAX package's rms_norm is plain
// jnp, src/repro/models/layers.py).  It exists for the batch-invariance
// contract: PyTorch's reduction over the last dimension chooses its threads
// per row from the number of rows, so the sum of squares of a row is added
// in another order at M = 1 than at M = 2048.  Here one block of 256
// threads owns one row: thread t sums elements t, t + 256, ... in order,
// then a fixed tree (warp shuffles, then the 8 warp sums) adds the threads'
// partials.  The order is set by the row length alone.
//
// Bound on the card: bytes (each row read once and written once).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace repro {
namespace norm {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int d,
                    long long ldx, float eps) {
  __shared__ float part[kThreads / 32];
  __shared__ float scale;
  const T* xr = x + (long long)blockIdx.x * ldx;
  T* yr = y + (long long)blockIdx.x * d;
  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f(xr[i]);
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < kThreads / 32 ? part[threadIdx.x] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o /= 2) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (threadIdx.x == 0) scale = rsqrtf(t / (float)d + eps);
  }
  __syncthreads();
  const float r = scale;
  for (int i = threadIdx.x; i < d; i += kThreads)
    yr[i] = from_f<T>(to_f(from_f<T>(to_f(xr[i]) * r)) * to_f(w[i]));
}

}  // namespace norm
}  // namespace repro

// dtype 0: float32, 1: bfloat16.  x rows of d elements, ldx apart; y
// contiguous.  Returns a cudaError_t value.
extern "C" int rms_norm_launch(const void* x, const void* w, void* y, int rows, int d,
                               long long ldx, float eps, int dtype, void* stream) {
  using namespace repro::norm;
  if (rows <= 0 || d <= 0 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    rms_norm_kernel<float><<<rows, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y), d,
        ldx, eps);
  else
    rms_norm_kernel<__nv_bfloat16><<<rows, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), d, ldx, eps);
  return cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
