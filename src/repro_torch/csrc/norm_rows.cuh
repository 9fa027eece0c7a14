// The row walk shared by the row-invariant norms (rms_norm.cu, layer_norm.cu):
// one warp owns one row, kRows rows a block; the row is cut into chunks of 8
// elements (16 bytes in bf16), lane l owning chunks l, l + 32, l + 64, ...
// Each norm sums its lane's chunks in that order, element by element, then
// adds the lanes with a fixed shuffle tree (warp_sum), so a row's sums follow
// d alone: not the number of rows, nor the load path (16-byte loads where the
// row start is aligned, element loads in the same order otherwise).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace repro {
namespace norm {

constexpr int kRows = 4;  // rows (warps) of one block

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

// One chunk of 8 elements as loaded: one 16-byte word in bf16, two in
// float32.
template <typename T>
struct Chunk {
  uint4 q[sizeof(T) / 2];
};

__device__ __forceinline__ uint32_t word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// Element e of a chunk in float32 (e a constant after unrolling).
template <typename T>
__device__ __forceinline__ float elem(const Chunk<T>& c, int e) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t u = word(c.q[0], e / 2);
    return __uint_as_float(e % 2 ? u & 0xffff0000u : u << 16);
  } else {
    return __uint_as_float(word(c.q[e / 4], e % 4));
  }
}

template <typename T>
__device__ __forceinline__ uint32_t bits(T v) {
  if constexpr (sizeof(T) == 2)
    return __bfloat16_as_ushort(v);
  else
    return __float_as_uint(v);
}

// Chunk c of a row: 16-byte loads where it lies wholly in the row and the
// row is aligned (vec), element loads otherwise; zeros past d.
template <typename T>
__device__ __forceinline__ Chunk<T> load_chunk(const T* p, int c, int d, bool vec) {
  Chunk<T> out;
  if (vec && 8 * c + 8 <= d) {
#pragma unroll
    for (int i = 0; i < (int)sizeof(T) / 2; ++i) out.q[i] = reinterpret_cast<const uint4*>(p + 8 * c)[i];
  } else {
    uint32_t v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = 8 * c + e < d ? bits(p[8 * c + e]) : 0u;
#pragma unroll
    for (int i = 0; i < (int)sizeof(T) / 2; ++i) {
      if constexpr (sizeof(T) == 2)
        out.q[i] = make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16, v[4] | v[5] << 16,
                              v[6] | v[7] << 16);
      else
        out.q[i] = make_uint4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    }
  }
  return out;
}

// The lanes' partial sums added by the fixed tree xor 16, 8, 4, 2, 1: every
// lane ends with the same total.
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

}  // namespace norm
}  // namespace repro
