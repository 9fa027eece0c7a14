// Row-invariant RMS normalization for sm_90a:
//   y[r] = round(x[r] * rsqrt(mean(x[r]^2) + eps)) * w
// in float32, the normalized row rounded to x's dtype before the scale, as
// the port's layers.rms_norm (and the JAX package's) computes it.
//
// No Pallas kernel corresponds to it (the JAX package's rms_norm is plain
// jnp, src/repro/models/layers.py).  It exists for the batch-invariance
// contract: PyTorch's reduction over the last dimension chooses its threads
// per row from the number of rows, so the sum of squares of a row is added
// in another order at M = 1 than at M = 2048.
//
// Here one warp owns one row, four rows a block (norm_rows.cuh).  The row is
// cut into chunks of 8 elements (16 bytes in bf16); lane l owns chunks l,
// l + 32, l + 64, ... and sums their squares in that order, element by
// element, then a fixed shuffle tree (xor 16, 8, 4, 2, 1) adds the lanes.
// The order is set by d alone: not by the number of rows, nor by the load
// path.
// Bound on the card: bytes (each row read once and written once).  The
// design keeps to one read and one trip to memory: a lane issues all its
// loads of x and w before the sum (decode's few rows are bound by that
// trip's latency) and holds them in registers until the scale (VPL chunks a
// lane: 10 at d 2560, 16 at d 4096); 16-byte loads and stores where the row
// start is 16-byte aligned, element loads in the same order otherwise.
// Rows longer than 16 chunks a lane (d > 4096) read x a second time.
#include "norm_rows.cuh"

namespace repro {
namespace norm {

// Normalize, round to T, times w, round; 16-byte stores where allowed.
template <typename T>
__device__ __forceinline__ void store_chunk(T* yr, const Chunk<T>& x, const Chunk<T>& w, float r,
                                            int c, int d, bool vec) {
  alignas(16) T out[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = from_f<T>(to_f(from_f<T>(elem(x, e) * r)) * elem(w, e));
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

// VPL > 0: the lane's chunks of x and w are all loaded before the sum and
// stay in registers (one trip to memory); VPL == 0: any d, x read again for
// the scale.
template <typename T, int VPL>
__global__ void __launch_bounds__(32 * kRows)
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int rows,
                    int d, long long ldx, float eps, int vec, int vec_out) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRows + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + (long long)row * ldx;
  T* yr = y + (long long)row * d;
  const int chunks = (d + 7) / 8;
  float s = 0.f;
  if constexpr (VPL > 0) {
    Chunk<T> xv[VPL], wv[VPL];
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = lane + 32 * j;
      if (c < chunks) {
        xv[j] = load_chunk(xr, c, d, vec);
        wv[j] = load_chunk(w, c, d, vec_out);
      }
    }
#pragma unroll
    for (int j = 0; j < VPL; ++j)
      if (lane + 32 * j < chunks)
#pragma unroll
        for (int e = 0; e < 8; ++e) s = fmaf(elem(xv[j], e), elem(xv[j], e), s);
    s = warp_sum(s);
    const float r = rsqrtf(s / (float)d + eps);
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = lane + 32 * j;
      if (c < chunks) store_chunk(yr, xv[j], wv[j], r, c, d, vec_out);
    }
  } else {
    for (int c = lane; c < chunks; c += 32) {
      const Chunk<T> v = load_chunk(xr, c, d, vec);
#pragma unroll
      for (int e = 0; e < 8; ++e) s = fmaf(elem(v, e), elem(v, e), s);
    }
    s = warp_sum(s);
    const float r = rsqrtf(s / (float)d + eps);
    for (int c = lane; c < chunks; c += 32)
      store_chunk(yr, load_chunk(xr, c, d, vec), load_chunk(w, c, d, vec_out), r, c, d, vec_out);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int rows, int d, long long ldx,
                   float eps, int vpl, cudaStream_t st) {
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (ldx * sizeof(T)) % 16 == 0;
  const bool vec_out = reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0 && (d * sizeof(T)) % 16 == 0;
  const dim3 grid((rows + kRows - 1) / kRows);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
#define REPRO_NORM_CASE(V)                                                                 \
  case V:                                                                                  \
    rms_norm_kernel<T, V><<<grid, 32 * kRows, 0, st>>>(xp, wp, yp, rows, d, ldx, eps, vec, vec_out); \
    break;
  switch (vpl) {
    REPRO_NORM_CASE(0)
    REPRO_NORM_CASE(2)
    REPRO_NORM_CASE(4)
    REPRO_NORM_CASE(8)
    REPRO_NORM_CASE(10)
    REPRO_NORM_CASE(12)
    REPRO_NORM_CASE(16)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_NORM_CASE
  return cudaGetLastError();
}

}  // namespace norm
}  // namespace repro

// dtype 0: float32, 1: bfloat16.  x rows of d elements, ldx apart; y
// contiguous.  vpl: chunks a lane holds in registers (kernels/rms_norm.py:
// plan), 0 for the two-pass loop; a vpl that does not cover d is refused.
// Returns a cudaError_t value.
extern "C" int rms_norm_launch(const void* x, const void* w, void* y, int rows, int d,
                               long long ldx, float eps, int dtype, int vpl, void* stream) {
  using namespace repro::norm;
  if (rows <= 0 || d <= 0 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  if (vpl < 0 || (vpl > 0 && 256LL * vpl < d)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, y, rows, d, ldx, eps, vpl, st);
  return launch<__nv_bfloat16>(x, w, y, rows, d, ldx, eps, vpl, st);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
