// Row-invariant LayerNorm (with bias) for sm_90a:
//   mu = mean(x[r]),  var = mean((x[r] - mu)^2)
//   y[r] = round(round(round((x[r] - mu) * rsqrt(var + eps)) * w) + b)
// in float32, rounded to x's dtype after the normalization, after the scale
// and after the bias, as the JAX package's layers.layer_norm computes it
// (jnp.var is the centred second pass, not E[x^2] - mu^2).
//
// No Pallas kernel corresponds to it (the JAX package's layer_norm is plain
// jnp, src/repro/models/layers.py:22-28).  It exists, as rms_norm.cu does,
// for the batch-invariance contract: PyTorch's reductions choose their
// threads per row from the number of rows, and co-execution and the
// server's --verify compare rows computed in batches of different sizes.
//
// The row walk is rms_norm's (norm_rows.cuh): one warp a row, lane l owning
// chunks l, l + 32, ... of 8 elements, each sum taken in that order element
// by element, then the fixed shuffle tree.  Two sums a row, the mean and
// then the centred squares, both in that order, so a row's bits follow d
// alone.  Bound on the card: bytes (x read once, w and b read, y written
// once); with VPL chunks a lane held in registers (2 at whisper's d 384) a
// row makes one trip to memory.  Rows longer than 16 chunks a lane
// (d > 4096) read x three times.
#include "norm_rows.cuh"

namespace repro {
namespace norm {

// (x - mu) * r rounded to T, times w rounded, plus b rounded; the products
// and sums kept apart (no fused multiply-add), as the reference computes
// them one operation at a time.  16-byte stores where allowed.
template <typename T>
__device__ __forceinline__ void store_ln_chunk(T* yr, const Chunk<T>& x, const Chunk<T>& w,
                                               const Chunk<T>& b, float mu, float r, int c, int d,
                                               bool vec) {
  alignas(16) T out[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float n = to_f(from_f<T>(__fmul_rn(__fsub_rn(elem(x, e), mu), r)));
    out[e] = from_f<T>(__fadd_rn(to_f(from_f<T>(__fmul_rn(n, elem(w, e)))), elem(b, e)));
  }
  if (vec && 8 * c + 8 <= d) {
#pragma unroll
    for (int i = 0; i < (int)sizeof(T) / 2; ++i)
      reinterpret_cast<uint4*>(yr + 8 * c)[i] = reinterpret_cast<const uint4*>(out)[i];
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (8 * c + e < d) yr[8 * c + e] = out[e];
  }
}

// The sum of a chunk's elements, and of their squared distances from mu
// (elements past d add nothing), into s in element order.
template <typename T>
__device__ __forceinline__ float add_chunk(float s, const Chunk<T>& v) {
#pragma unroll
  for (int e = 0; e < 8; ++e) s = __fadd_rn(s, elem(v, e));
  return s;
}

template <typename T>
__device__ __forceinline__ float add_centred(float s, const Chunk<T>& v, float mu, int c, int d) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float t = 8 * c + e < d ? __fsub_rn(elem(v, e), mu) : 0.f;
    s = fmaf(t, t, s);
  }
  return s;
}

// VPL > 0: the lane's chunks of x, w and b are all loaded before the sums
// and stay in registers (one trip to memory); VPL == 0: any d, x read again
// for each sum and the store.
template <typename T, int VPL>
__global__ void __launch_bounds__(32 * kRows)
    layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
                      T* __restrict__ y, int rows, int d, long long ldx, float eps, int vec,
                      int vec_out) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRows + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + (long long)row * ldx;
  T* yr = y + (long long)row * d;
  const int chunks = (d + 7) / 8;
  float s = 0.f, q = 0.f;
  if constexpr (VPL > 0) {
    Chunk<T> xv[VPL], wv[VPL], bv[VPL];
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = lane + 32 * j;
      if (c < chunks) {
        xv[j] = load_chunk(xr, c, d, vec);
        wv[j] = load_chunk(w, c, d, vec_out);
        bv[j] = load_chunk(b, c, d, vec_out);
      }
    }
#pragma unroll
    for (int j = 0; j < VPL; ++j)
      if (lane + 32 * j < chunks) s = add_chunk(s, xv[j]);
    const float mu = warp_sum(s) / (float)d;
#pragma unroll
    for (int j = 0; j < VPL; ++j)
      if (lane + 32 * j < chunks) q = add_centred(q, xv[j], mu, lane + 32 * j, d);
    const float r = rsqrtf(warp_sum(q) / (float)d + eps);
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = lane + 32 * j;
      if (c < chunks) store_ln_chunk(yr, xv[j], wv[j], bv[j], mu, r, c, d, vec_out);
    }
  } else {
    for (int c = lane; c < chunks; c += 32) s = add_chunk(s, load_chunk(xr, c, d, vec));
    const float mu = warp_sum(s) / (float)d;
    for (int c = lane; c < chunks; c += 32) q = add_centred(q, load_chunk(xr, c, d, vec), mu, c, d);
    const float r = rsqrtf(warp_sum(q) / (float)d + eps);
    for (int c = lane; c < chunks; c += 32)
      store_ln_chunk(yr, load_chunk(xr, c, d, vec), load_chunk(w, c, d, vec_out),
                     load_chunk(b, c, d, vec_out), mu, r, c, d, vec_out);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* y, int rows, int d,
                   long long ldx, float eps, int vpl, cudaStream_t st) {
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (ldx * sizeof(T)) % 16 == 0;
  const bool vec_out = reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0 && (d * sizeof(T)) % 16 == 0;
  const dim3 grid((rows + kRows - 1) / kRows);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(b);
  T* yp = static_cast<T*>(y);
#define REPRO_LN_CASE(V)                                                                  \
  case V:                                                                                 \
    layer_norm_kernel<T, V><<<grid, 32 * kRows, 0, st>>>(xp, wp, bp, yp, rows, d, ldx, eps, \
                                                          vec, vec_out);                  \
    break;
  switch (vpl) {
    REPRO_LN_CASE(0)
    REPRO_LN_CASE(2)
    REPRO_LN_CASE(4)
    REPRO_LN_CASE(8)
    REPRO_LN_CASE(10)
    REPRO_LN_CASE(12)
    REPRO_LN_CASE(16)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_LN_CASE
  return cudaGetLastError();
}

}  // namespace norm
}  // namespace repro

// dtype 0: float32, 1: bfloat16.  x rows of d elements, ldx apart; w, b (d,)
// and y contiguous.  vpl: chunks a lane holds in registers (kernels/rms_norm.py:
// plan, the same row walk), 0 for the loop that reads x again; a vpl that does
// not cover d is refused.  Returns a cudaError_t value.
extern "C" int layer_norm_launch(const void* x, const void* w, const void* b, void* y, int rows,
                                 int d, long long ldx, float eps, int dtype, int vpl,
                                 void* stream) {
  using namespace repro::norm;
  if (rows <= 0 || d <= 0 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  if (vpl < 0 || (vpl > 0 && 256LL * vpl < d)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, b, y, rows, d, ldx, eps, vpl, st);
  return launch<__nv_bfloat16>(x, w, b, y, rows, d, ldx, eps, vpl, st);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
