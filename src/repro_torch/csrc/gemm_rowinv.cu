// Row-invariant matrix product y = x @ w (+ bias) for sm_90a.
//
// No Pallas kernel of the JAX package corresponds to this one: the JAX
// package computes the model's products with plain jnp einsums (for example
// src/repro/models/layers.py:195, the SwiGLU products), which XLA lowers.
// The port needs its own because of a contract, not a speed: a served stream
// must equal one-shot generate of its request alone, bitwise.  A library
// GEMM picks its kernel by M, so row r of an M = 1 product and of an M = 8
// product are summed in different orders and round differently.  Here the
// order in which an output element sums over K is fixed by K alone:
//
//   acc = 0; for k0 = 0, 16, 32, ... < K: acc = mma(x[r, k0:k0+16], w[k0:k0+16, n], acc)
//
// one m16n8k16 tensor-core product (bf16 in, f32 accumulate) after another
// in ascending k0, whatever the tile over M and N.  There is no split over K.
// The tile over M and N follows M (the only freedom the rule leaves):
//   M <= 64  a GEMV-like tile of 16 rows x 32 columns, 4 warps, BK = 128 and
//            4 stages: decode reads each weight once, and many narrow blocks
//            keep enough of the card's memory bandwidth busy;
//   M > 64   128 x 128 tiles, 8 warps of 64 x 32, BK = 32 and 3 stages.
// Both stage x and w by cp.async (16-byte copies, the ragged edges zero
// filled by the copy's source size) when every row stride is a multiple of 8
// elements and every pointer 16-byte aligned, and by plain loads otherwise;
// k16 steps wholly past K are skipped, so both tiles run the same sequence
// of products.
//
// float32 inputs take route f32: SIMT FMAs over 64 x 64 tiles, acc = fma(
// x[r, k], w[k, n], acc) for k ascending, the same rule.
//
// The output has x's dtype.  A bias is added as PyTorch adds it after the
// product: bf16 rounds the product first, then rounds the sum.
//
// w is (K, N) row-major (wt = 0) or stored transposed, (N, K) row-major
// (wt = 1: a tied head reads the embedding table as it is).  A batch of
// `batch` independent products (a block-diagonal weight: recurrentgemma's
// gates) runs as one launch, with its own strides for x, w, bias and y.
//
// Bound on the card: bytes at decode (the weight, K*N*2 bytes, against a few
// rows), the tensor cores at prefill (2*M*N*K operations).  mma.sync from
// registers reaches a part of Hopper's peak only; wgmma and TMA are later
// work.
#include "attention_mma.cuh"

namespace repro {
namespace gemm {

using bf16 = __nv_bfloat16;

struct Args {
  const void* x;
  const void* w;
  const void* bias;
  void* y;
  int M, N, K;
  long long lda, ldw, ldy;      // row strides, elements
  long long sx, sw, sb, sy;     // strides between the products of a batch
};

__device__ __forceinline__ void cp_async16_n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(mma::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(mma::smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(mma::smem_u32(p)));
}

constexpr int kPad = 8;  // bf16 padding of a staged row: ldmatrix without bank conflicts

template <int BM, int BN, int BK, bool WT>
struct Tiles {
  static constexpr int A = BM * (BK + kPad);                         // x: [BM][BK+8]
  static constexpr int B = WT ? BN * (BK + kPad) : BK * (BN + kPad);  // w: [BN][BK+8] or [BK][BN+8]
  static constexpr int Stage = A + B;                                // bf16 elements
};

// Stage tile kt of x and w into shared memory: 16-byte cp.async copies
// (VEC) or plain loads, zeros past M, N and K.
template <int BM, int BN, int BK, bool WT, bool VEC, int THREADS>
__device__ __forceinline__ void load_stage(bf16* sa, bf16* sb, const Args& a, const bf16* x,
                                           const bf16* w, int m0, int n0, int k0) {
  constexpr int LA = BK + kPad;
  if constexpr (VEC) {
    constexpr int CA = BK / 8;
    for (int i = threadIdx.x; i < BM * CA; i += THREADS) {
      const int r = i / CA, c = (i - r * CA) * 8;
      const int gm = m0 + r, gk = k0 + c;
      int bytes = gm < a.M ? 2 * (a.K - gk) : 0;
      bytes = bytes < 0 ? 0 : bytes > 16 ? 16 : bytes;
      const bf16* src = bytes ? x + gm * a.lda + gk : x;
      cp_async16_n(sa + r * LA + c, src, bytes);
    }
    if constexpr (WT) {
      for (int i = threadIdx.x; i < BN * CA; i += THREADS) {
        const int r = i / CA, c = (i - r * CA) * 8;
        const int gn = n0 + r, gk = k0 + c;
        int bytes = gn < a.N ? 2 * (a.K - gk) : 0;
        bytes = bytes < 0 ? 0 : bytes > 16 ? 16 : bytes;
        const bf16* src = bytes ? w + gn * a.ldw + gk : w;
        cp_async16_n(sb + r * LA + c, src, bytes);
      }
    } else {
      constexpr int CB = BN / 8, LB = BN + kPad;
      for (int i = threadIdx.x; i < BK * CB; i += THREADS) {
        const int r = i / CB, c = (i - r * CB) * 8;
        const int gk = k0 + r, gn = n0 + c;
        int bytes = gk < a.K ? 2 * (a.N - gn) : 0;
        bytes = bytes < 0 ? 0 : bytes > 16 ? 16 : bytes;
        const bf16* src = bytes ? w + gk * a.ldw + gn : w;
        cp_async16_n(sb + r * LB + c, src, bytes);
      }
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i - r * BK;
      const int gm = m0 + r, gk = k0 + c;
      sa[r * LA + c] = gm < a.M && gk < a.K ? x[gm * a.lda + gk] : zero;
    }
    if constexpr (WT) {
      for (int i = threadIdx.x; i < BN * BK; i += THREADS) {
        const int r = i / BK, c = i - r * BK;
        const int gn = n0 + r, gk = k0 + c;
        sb[r * LA + c] = gn < a.N && gk < a.K ? w[gn * a.ldw + gk] : zero;
      }
    } else {
      constexpr int LB = BN + kPad;
      for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
        const int r = i / BN, c = i - r * BN;
        const int gk = k0 + r, gn = n0 + c;
        sb[r * LB + c] = gk < a.K && gn < a.N ? w[gk * a.ldw + gn] : zero;
      }
    }
  }
}

// One block: a BM x BN tile of y, warps of WM x WN, STAGES-deep cp.async
// ring of BK-wide slices of x and w.
template <int BM, int BN, int BK, int WM, int WN, int STAGES, bool WT, bool VEC>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
    gemm_bf16_kernel(Args a) {
  constexpr int WARPS_N = BN / WN;
  constexpr int THREADS = (BM / WM) * WARPS_N * 32;
  constexpr int MI = WM / 16, NI = WN / 8;
  constexpr int LA = BK + kPad;
  using T = Tiles<BM, BN, BK, WT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int z = blockIdx.z;
  const bf16* x = static_cast<const bf16*>(a.x) + z * a.sx;
  const bf16* w = static_cast<const bf16*>(a.w) + z * a.sw;
  const bf16* bias = a.bias ? static_cast<const bf16*>(a.bias) + z * a.sb : nullptr;
  bf16* y = static_cast<bf16*>(a.y) + z * a.sy;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (a.K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage<BM, BN, BK, WT, VEC, THREADS>(smem + s * T::Stage, smem + s * T::Stage + T::A,
                                               a, x, w, m0, n0, s * BK);
    mma::cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    mma::cp_wait<STAGES - 2>();
    __syncthreads();
    {  // refill the slot computed in the previous iteration
      const int kn = kt + STAGES - 1;
      if (kn < nk) {
        bf16* st = smem + (kn % STAGES) * T::Stage;
        load_stage<BM, BN, BK, WT, VEC, THREADS>(st, st + T::A, a, x, w, m0, n0, kn * BK);
      }
      mma::cp_commit();
    }
    const bf16* sa = smem + (kt % STAGES) * T::Stage;
    const bf16* sb = sa + T::A;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (kt * BK + kk * 16 >= a.K) break;  // uniform: no product of zeros past K
      uint32_t af[MI][4], bfr[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        mma::ldsm_x4(af[i], sa + (wm * WM + i * 16 + lane % 16) * LA + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int nb = wn * WN + j * 8;
        if constexpr (WT)
          ldsm_x2(bfr[j][0], bfr[j][1],
                  sb + (nb + lane % 8) * LA + kk * 16 + ((lane / 8) % 2) * 8);
        else
          ldsm_x2_t(bfr[j][0], bfr[j][1], sb + (kk * 16 + lane % 16) * (BN + kPad) + nb);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma::mma16816(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  mma::cp_wait<0>();

#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm * WM + i * 16 + lane / 4 + (e / 2) * 8;
        const int c = n0 + wn * WN + j * 8 + (lane % 4) * 2 + e % 2;
        if (r < a.M && c < a.N) {
          bf16 v = __float2bfloat16(acc[i][j][e]);
          if (bias) v = __float2bfloat16(__bfloat162float(v) + __bfloat162float(bias[c]));
          y[r * a.ldy + c] = v;
        }
      }
}

// float32: SIMT FMAs, 64 x 64 tiles of 4 x 4 outputs a thread, k ascending.
constexpr int kF32Tile = 64, kF32K = 16, kF32Threads = 256;

template <bool WT>
__global__ void __launch_bounds__(kF32Threads) gemm_f32_kernel(Args a) {
  __shared__ float xs[kF32K][kF32Tile + 4];
  __shared__ float ws[kF32K][kF32Tile + 4];
  const int z = blockIdx.z;
  const float* x = static_cast<const float*>(a.x) + z * a.sx;
  const float* w = static_cast<const float*>(a.w) + z * a.sw;
  const float* bias = a.bias ? static_cast<const float*>(a.bias) + z * a.sb : nullptr;
  float* y = static_cast<float*>(a.y) + z * a.sy;
  const int m0 = blockIdx.y * kF32Tile, n0 = blockIdx.x * kF32Tile;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < a.K; k0 += kF32K) {
    for (int i = threadIdx.x; i < kF32K * kF32Tile; i += kF32Threads) {
      const int r = i / kF32K, c = i % kF32K;  // x row r, k c
      const int gm = m0 + r, gk = k0 + c;
      xs[c][r] = gm < a.M && gk < a.K ? x[gm * a.lda + gk] : 0.f;
      const int gn = n0 + (WT ? r : i % kF32Tile), gk2 = k0 + (WT ? c : i / kF32Tile);
      const float wv = gn < a.N && gk2 < a.K ? w[WT ? gn * a.ldw + gk2 : gk2 * a.ldw + gn] : 0.f;
      if (WT)
        ws[c][r] = wv;
      else
        ws[i / kF32Tile][i % kF32Tile] = wv;
    }
    __syncthreads();
    const int kend = a.K - k0 < kF32K ? a.K - k0 : kF32K;
    for (int kk = 0; kk < kend; ++kk) {
      float xv[4], wv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        xv[u] = xs[kk][tr + 16 * u];
        wv[u] = ws[kk][tc + 16 * u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(xv[u], wv[v], acc[u][v]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = m0 + tr + 16 * u, c = n0 + tc + 16 * v;
      if (r < a.M && c < a.N) y[r * a.ldy + c] = bias ? acc[u][v] + bias[c] : acc[u][v];
    }
}

template <int BM, int BN, int BK, int WM, int WN, int STAGES, bool WT, bool VEC>
cudaError_t launch_bf16(const Args& a, int batch, cudaStream_t stream) {
  auto kernel = gemm_bf16_kernel<BM, BN, BK, WM, WN, STAGES, WT, VEC>;
  constexpr size_t smem = (size_t)STAGES * Tiles<BM, BN, BK, WT>::Stage * sizeof(bf16);
  static bool attr = false;  // one opt-in per instance, before its first launch
  if (!attr) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, batch);
  kernel<<<grid, (BM / WM) * (BN / WN) * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// The tile follows M; the order of every sum follows K alone (see the top).
template <bool WT, bool VEC>
cudaError_t route_bf16(const Args& a, int batch, cudaStream_t stream) {
  if (a.M <= 64) return launch_bf16<16, 32, 128, 16, 8, 4, WT, VEC>(a, batch, stream);
  return launch_bf16<128, 128, 32, 64, 32, 3, WT, VEC>(a, batch, stream);
}

}  // namespace gemm
}  // namespace repro

// dtype 0: float32, 1: bfloat16.  Returns a cudaError_t value (its text:
// kernel_error_string, from attention_tile.cuh).
extern "C" int gemm_rowinv_launch(const void* x, const void* w, const void* bias, void* y,
                                  int M, int N, int K, long long lda, long long ldw,
                                  long long ldy, int batch, long long sx, long long sw,
                                  long long sb, long long sy, int wt, int dtype,
                                  void* stream) {
  using namespace repro::gemm;
  if (M <= 0 || N <= 0 || K <= 0 || batch <= 0 || batch > 65535 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if ((M + 15) / 16 > 65535) return cudaErrorInvalidValue;
  const Args a{x, w, bias, y, M, N, K, lda, ldw, ldy, sx, sw, sb, sy};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid((N + kF32Tile - 1) / kF32Tile, (M + kF32Tile - 1) / kF32Tile, batch);
    if (wt)
      gemm_f32_kernel<true><<<grid, kF32Threads, 0, st>>>(a);
    else
      gemm_f32_kernel<false><<<grid, kF32Threads, 0, st>>>(a);
    return cudaGetLastError();
  }
  // 16-byte copies need 16-byte aligned pointers and row starts.
  const bool vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)w % 16 == 0) && lda % 8 == 0 &&
                   ldw % 8 == 0 && (batch == 1 || (sx % 8 == 0 && sw % 8 == 0));
  if (wt) return vec ? route_bf16<true, true>(a, batch, st) : route_bf16<true, false>(a, batch, st);
  return vec ? route_bf16<false, true>(a, batch, st) : route_bf16<false, false>(a, batch, st);
}
