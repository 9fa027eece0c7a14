// Grouped, row-invariant expert products of the MoE family, for sm_90a:
//
//   y[e, c, :] = A[e, c, :] @ w[e]                 (c < count[e])
//   y[e, c, :] = silu(A[e, c, :] @ w[e]) * (A[e, c, :] @ w_up[e])   (fused)
//   y[e, c, :] = 0                                 (count[e] <= c < C)
//
// No Pallas kernel of the JAX package corresponds to this one: the JAX
// package runs the MoE FFN's expert products as plain jnp einsums over the
// whole (E, C, d) capacity buffer (src/repro/models/moe.py:112-117), every
// expert and every capacity row.  A decode step fills a few rows of a few
// experts (8 tokens at top-2 reach at most 16 of arctic-480b's 128), so the
// einsum as written streams 8x the weight bytes the call needs.  This kernel
// skips them: a block reads count[e] on the device and, when its tile holds
// no filled row, writes its zeros and returns before it loads anything.  An
// empty row's product is zero and the combine never reads it, so the
// function is the reference's.
//
// A (E, C, K) is either the buffer itself (rows == nullptr: slot (e, c) is
// row e * C + c of x) or gathered through the row map: slot (e, c) is token
// row rows[e * C + c] of x (T, K), -1 a zero row, so gate and up never
// materialize the buffer.  count and rows are device memory, read by the
// kernel: no host read, so a CUDA graph replays the launch with whatever
// routing the step computed.
//
// Contract (the served-equals-one-shot contract of kernels/gemm.py): each
// output element is one chain of wgmma m64n32k16 products (bf16 in, f32
// accumulate) over K in ascending k, fixed by K alone -- gemm_rowinv's gemv
// route, the same instruction on the same stage layout -- so a routed row
// gives the same bits whatever count[e], C, the other rows of its tile or
// the number of experts in the call.  The fused gate and up are two such
// chains, rounded to bf16 each, then silu and the product as PyTorch
// rounds them (F.silu(bf16) * bf16).
//
// Each block: one 64 x 32 output tile of one expert.  A consumer warpgroup
// issues wgmma on an 8-stage (6 fused) ring of 64 k; a producer warpgroup
// fills it: one thread asks TMA for the weight tiles (a 3-D map over
// (N, K, E): one expert leaf holds up to 5.6e9 elements, so offsets never
// pass through 32-bit products), and all 128 threads gather the tile's
// filled rows of A with 16-byte loads into the layout TMA's 128-byte
// swizzle gives; the unfilled rows stay zero from the start.  Bound by the
// weight bytes of the experts that hold rows (decode), the same bytes for
// a prefill that fills every expert.  The grid is (N / 32, C / 64, E), so a
// call sized for its (E, C, N) exits early in the blocks of empty experts.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>
#include <unordered_map>

namespace repro {
namespace moe {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64, kBN = 32, kBK = 64;
constexpr int kABytes = kBM * kBK * 2;  // one stage's A tile: 64 rows of 128 bytes
constexpr int kBBytes = kBK * kBN * 2;  // one weight tile: 64 k rows of 64 bytes
constexpr int kThreads = 256;           // consumer warpgroup, producer warpgroup

template <bool FUSED>
struct Shape {
  static constexpr int NB = FUSED ? 2 : 1;
  static constexpr int STAGES = FUSED ? 6 : 8;
  static constexpr int STAGE = kABytes + NB * kBBytes;
  // stages, the full and empty barriers, slack to align the ring to 1024
  static constexpr int SMEM = STAGES * STAGE + 16 * STAGES + 1024;
};

struct Args {
  const bf16* x;
  const int* rows;   // (E, C), or nullptr: the buffer's own rows
  const int* count;  // (E,)
  bf16* y;           // (E, C, N)
  long long lda;     // elements between rows of x
  int E, C, K, N;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The 16-byte chunk c of row r of an A tile under TMA's 128-byte swizzle.
__device__ __forceinline__ int swz128(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// A shared-memory matrix descriptor: start, leading and stride byte offsets
// (16-byte units), layout (1: 128-byte swizzle, 2: 64-byte swizzle).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) | ((uint64_t)sbo << 32) |
         ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_acc(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma m64n32k16, bf16 in, f32 accumulate (acc += A B), A K-major, B
// MN-major (the (K, N) row-major weight).
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// The descriptors of k16 step kk of a stage: A rows of 64 k (128-byte
// swizzle), the weight's one 32-wide MN-major atom (64-byte swizzle), as
// gemm_rowinv's narrow and gemv routes lay them out.
__device__ __forceinline__ uint64_t desc_a(uint32_t a, int kk) { return desc(a + kk * 32, 1, 64, 1); }
__device__ __forceinline__ uint64_t desc_b(uint32_t b, int kk) {
  return desc(b + kk * 16 * 64, (kBK * 64) >> 4, 32, 2);
}

// silu(g) * u as PyTorch computes F.silu(g) * u on bf16 tensors: g and u
// rounded to bf16, silu in float and rounded, the product rounded.
__device__ __forceinline__ bf16 silu_mul(float g, float u) {
  const float gb = __bfloat162float(__float2bfloat16(g));
  const float s = __bfloat162float(__float2bfloat16(gb / (1.0f + expf(-gb))));
  return __float2bfloat16(s * __bfloat162float(__float2bfloat16(u)));
}

template <bool FUSED>
__global__ void __launch_bounds__(kThreads, 2)
    moe_gemm_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tu,
                    const Args a) {
  using S = Shape<FUSED>;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM, e = blockIdx.z;
  const int tid = threadIdx.x;
  const int cnt = min(a.count[e], a.C);
  const int live = max(0, min(cnt - m0, kBM));  // filled rows of this tile
  const int mrows = min(a.C - m0, kBM);         // rows of this tile inside C
  bf16* y = a.y + ((long long)e * a.C + m0) * a.N;
  if (live == 0) {  // an empty tile: zeros, and no load
    for (int i = tid; i < mrows * (kBN / 2); i += kThreads) {
      const int r = i / (kBN / 2), c = n0 + 2 * (i % (kBN / 2));
      if (c < a.N)
        *reinterpret_cast<__nv_bfloat162*>(y + (long long)r * a.N + c) =
            __floats2bfloat162_rn(0.f, 0.f);
    }
    return;
  }

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* ring = smem_raw + (base - raw);
  const uint32_t bars = base + S::STAGES * S::STAGE;  // full[s]: + 8 s; empty[s]: + 8 (STAGES + s)
  // The unfilled rows of every stage's A tile stay zero.
  for (int i = tid; i < S::STAGES * (kABytes / 16); i += kThreads) {
    const int s = i / (kABytes / 16), j = i % (kABytes / 16);
    *reinterpret_cast<uint4*>(ring + s * S::STAGE + j * 16) = make_uint4(0, 0, 0, 0);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (tid == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(bars + 8 * s, 129);  // the TMA thread's expect_tx, then 128 producers
      mbar_init(bars + 8 * (S::STAGES + s), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int nkt = (a.K + kBK - 1) / kBK;
  if (wg == 1) {  // the producer warpgroup
    const int p = tid - 128;
    // This thread's A chunks: column chunk c of rows p / 8 + 16 j.
    const int c = p % 8;
    long long src[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = p / 8 + 16 * j;
      const long long slot = (long long)e * a.C + m0 + r;
      src[j] = r >= live ? -1 : a.rows ? (long long)a.rows[slot] : slot;
    }
    for (int kt = 0; kt < nkt; ++kt) {
      const int s = kt % S::STAGES, u = kt / S::STAGES;
      if (u > 0) mbar_wait(bars + 8 * (S::STAGES + s), (u - 1) & 1);
      const int k0 = kt * kBK;
      const uint32_t full = bars + 8 * s;
      const uint32_t sb = base + s * S::STAGE + kABytes;
      if (p == 0) {
        mbar_expect_tx(full, S::NB * kBBytes);
        tma_load3(sb, &tw, full, n0, k0, e);
        if constexpr (FUSED) tma_load3(sb + kBBytes, &tu, full, n0, k0, e);
      }
      uint8_t* sa = ring + s * S::STAGE;
      const int kc = k0 + 8 * c;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = p / 8 + 16 * j;
        if (r >= live) break;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (src[j] >= 0 && kc < a.K)
          v = __ldg(reinterpret_cast<const uint4*>(a.x + src[j] * a.lda + kc));
        *reinterpret_cast<uint4*>(sa + swz128(r, c)) = v;
      }
      // the generic proxy's stores, visible to wgmma's async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full);
    }
  } else {  // the consumer warpgroup
    const int lane = tid % 32;
    float acc[16], acc2[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = acc2[i] = 0.f;
    fence_acc(acc);
    fence_acc(acc2);
    // Whole k tiles issue their four k16 steps; the last issues only the
    // steps that reach below K.
    const int steps_last = ((a.K - (nkt - 1) * kBK) + 15) / 16;
    auto release = [&](int s) {
      if (lane == 0) mbar_arrive(bars + 8 * (S::STAGES + s));
    };
    for (int kt = 0; kt < nkt; ++kt) {
      const int s = kt % S::STAGES;
      mbar_wait(bars + 8 * s, (kt / S::STAGES) & 1);
      const uint32_t sa = base + s * S::STAGE, sb = sa + kABytes;
      const int steps = kt + 1 < nkt ? kBK / 16 : steps_last;
      wg_fence();
      if (steps == 4) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_n32(acc, desc_a(sa, kk), desc_b(sb, kk));
          if constexpr (FUSED) wgmma_n32(acc2, desc_a(sa, kk), desc_b(sb + kBBytes, kk));
        }
      } else {
        for (int kk = 0; kk < steps; ++kk) {
          wgmma_n32(acc, desc_a(sa, kk), desc_b(sb, kk));
          if constexpr (FUSED) wgmma_n32(acc2, desc_a(sa, kk), desc_b(sb + kBBytes, kk));
        }
      }
      wg_commit();
      wg_wait<1>();  // stage kt - 1's products are done: release its slot
      if (kt > 0) release((kt - 1) % S::STAGES);
    }
    wg_wait<0>();
    fence_acc(acc);
    fence_acc(acc2);
    release((nkt - 1) % S::STAGES);

    // Epilogue: thread t holds rows w * 16 + lane / 4 (+ 8) and columns
    // 8 j + 2 (lane % 4) (+ 1) of the tile; rows past the filled ones are
    // written as zeros.
    const int rw = tid / 32 * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = n0 + j * 8 + (lane % 4) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rw + 8 * h;
        if (r >= mrows || col >= a.N) continue;
        const int i = 4 * j + 2 * h;
        __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
        if (r < live) {
          if constexpr (FUSED)
            v = __halves2bfloat162(silu_mul(acc[i], acc2[i]), silu_mul(acc[i + 1], acc2[i + 1]));
          else
            v = __floats2bfloat162_rn(acc[i], acc[i + 1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(y + (long long)r * a.N + col) = v;
      }
    }
  }
}

// ---- host side: tensor maps and launches ----

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encoder() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A weight map is set by its pointer and shape: cached by those, so a call
// with known weights (every decode step) encodes nothing.
struct MapKey {
  const void* ptr;
  long long E, K, N;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && E == o.E && K == o.K && N == o.N;
  }
};

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<const void*>()(k.ptr);
    for (long long v : {k.E, k.K, k.N}) h = h * 1099511628211ull ^ std::hash<long long>()(v);
    return h;
  }
};

constexpr size_t kMapCacheMax = 4096;

// The 3-D map of an (E, K, N) row-major bf16 weight: dims (N, K, E), box
// 32 x 64 x 1 under the 64-byte swizzle.
bool weight_map(CUtensorMap* out, const void* ptr, int E, int K, int N) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  const MapKey key{ptr, E, K, N};
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return true;
  }
  const EncodeTiledFn enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t strides[2] = {2ull * N, 2ull * N * K};
  const cuuint32_t box[3] = {kBN, kBK, 1}, ones[3] = {1, 1, 1};
  if (enc(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
          ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (cache.size() >= kMapCacheMax) cache.clear();
  cache.emplace(key, *out);
  return true;
}

template <bool FUSED>
cudaError_t launch(const Args& a, const void* w, const void* w_up, cudaStream_t stream) {
  using S = Shape<FUSED>;
  auto kernel = moe_gemm_kernel<FUSED>;
  CUtensorMap tw, tu;
  memset(&tw, 0, sizeof(tw));
  memset(&tu, 0, sizeof(tu));
  if (!weight_map(&tw, w, a.E, a.K, a.N)) return cudaErrorInvalidValue;
  if (FUSED && !weight_map(&tu, w_up, a.E, a.K, a.N)) return cudaErrorInvalidValue;
  static bool attr = false;  // one opt-in per instance, before its first launch
  if (!attr) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  const dim3 grid((a.N + kBN - 1) / kBN, (a.C + kBM - 1) / kBM, a.E);
  kernel<<<grid, kThreads, S::SMEM, stream>>>(tw, tu, a);
  return cudaGetLastError();
}

}  // namespace moe
}  // namespace repro

// x: (T, K) token rows gathered through rows (E, C) int32, or (rows null)
// the (E, C, K) buffer; count (E,) int32; w, w_up (E, K, N) bf16, w_up null
// for the plain product; y (E, C, N) bf16.  K and N multiples of 8, lda a
// multiple of 8, 16-byte aligned x, w, w_up.  Returns a cudaError_t value.
extern "C" int moe_gemm_launch(const void* x, const void* rows, const void* count,
                               const void* w, const void* w_up, void* y, int E, int C, int K,
                               int N, long long lda, void* stream) {
  using namespace repro::moe;
  if (E <= 0 || E > 65535 || C <= 0 || (C + kBM - 1) / kBM > 65535 || K <= 0 || N <= 0 ||
      K % 8 || N % 8 || lda % 8 || lda < K || !x || !count || !w || !y)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(w_up)) % 16)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(x), static_cast<const int*>(rows),
               static_cast<const int*>(count), static_cast<bf16*>(y), lda, E, C, K, N};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return w_up ? launch<true>(a, w, w_up, st) : launch<false>(a, w, nullptr, st);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
