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
// computes only the row tiles that hold a filled row; an empty row's
// product is zero and is written as zero, so the function is the
// reference's.  The zeros are part of the function: the model's combine
// reads slot C - 1 for a dropped assignment (times a zero weight), so a
// row past count[e] must never hold a NaN.
//
// A (E, C, K) is either the buffer itself (rows == nullptr, as down reads
// it: slot (e, c) is row e * C + c of x) or gathered through the row map
// (gate and up: slot (e, c) is token row rows[e * C + c] of x (T, K), -1 a
// zero row), so gate and up never materialize the buffer.  count and rows
// are device memory, read by the kernel: no host read, so a CUDA graph
// replays the launch with whatever routing the step computed.
//
// Contract (the served-equals-one-shot contract of kernels/gemm.py): each
// output element is one chain of wgmma m64nNk16 products (bf16 in, f32
// accumulate, B MN-major) over K in ascending k, fixed by K alone, with no
// split over K and k16 steps wholly past K skipped.  The instruction's
// width does not enter an element's sum (n32, n64, n128 and n256 give the
// same dot product: gemm_rowinv.cu), so a routed row has the same bits
// whatever C, count[e], the other rows of its tile or the number of
// experts in the call, and equals gemm_rowinv's product of the same row and
// expert (chip_smoke.py holds both).  The fused gate and up are two
// such chains, rounded to bf16 each, then silu and the product as PyTorch
// rounds them (F.silu(bf16) * bf16).
//
// Each block is persistent: one wave of blocks (at most one an SM, the
// launch's argument) walks the filled tiles.  A block stages count[] in
// shared memory and prefix-sums the filled row tiles, ceil(count[e] / 64)
// for each expert; tile t is (expert, row tile, column tile) with the
// column tile fastest, and block b takes t = b, b + gridDim.x, ...  So the
// blocks that run at once share one expert's A from L2 while its weight
// columns stream from HBM once.  Rows and experts no tile covers are written as zeros by
// the consumer warps before their walk, while the producer already fills
// the ring; no block is launched for them.
//
// A producer warpgroup fills a ring of 5 stages (64 k, 40 KB each) behind
// mbarriers; one consumer warpgroup issues wgmma on it and writes the tile.
// The ring's stage counter runs on across tiles, so the next tile's loads
// overlap this tile's epilogue.  A stage holds the A tile (64 rows of 128
// bytes, 128-byte swizzle) and two weight parts of 128 columns: gate and up
// at the same columns (fused), or two neighbouring column blocks (down), so
// both forms keep two m64n128 accumulators and a tile is 128 (fused) or 256
// (down) columns wide: A is read once per 128 or 256 output columns.  The weight parts arrive by TMA in boxes of 64
// columns (128-byte rows, 128-byte swizzle) from a 3-D map over (N, K, E):
// one expert leaf holds up to 5.6e9 elements, so offsets never pass
// through 32-bit products.  No producer thread waits on its own load:
//   down    A is the buffer in memory: TMA, a 3-D map over (K, C, E) whose
//           box holds min(C rounded up to 8, 64) rows, so a decode call
//           moves only its 8 rows.  One thread issues a stage.
//   gate/up A is gathered through rows, which TMA cannot do (fused calls on
//           the buffer take the same path): 16-byte cp.async copies into
//           the layout TMA's swizzle gives (zero-filled for a -1 row),
//           completed on the stage's full barrier by
//           cp.async.mbarrier.arrive.noinc; each thread reads its tile's
//           row indices once a tile.  The consumer fences the async proxy
//           before wgmma reads what cp.async wrote.
// Rows past the box stay zero from the start; rows of the box past the
// tile's filled ones are computed, and written as zeros (a row's sum reads
// only its own row of A).  The consumer stages each output part in shared
// memory and sends it by TMA stores (a map over (N, C, E), boxes of 64
// columns and of the A box's rows), which clip the rows past C and the
// columns past N; the next tile's wgmma starts while they drain.
//
// One tile serves every C, decode (C 8) as prefill (C 48-56): the call is
// bound by the filled experts' weight bytes, and the tensor work (at most
// 64 rows a tile) stays well under them.  kernels/moe_gemm.py:plan owns the
// launch (tile, stages, blocks); the launch refuses a tile or ring this
// file was not built for.
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

constexpr int kBM = 64, kBK = 64;
constexpr int kBox = 64;                // columns of one weight or output TMA box
constexpr int kABytes = kBM * kBK * 2;  // one stage's A tile: 64 rows of 128 bytes
constexpr int kThreads = 256;           // consumer warpgroup, producer warpgroup
constexpr int kMaxE = 512;              // experts whose counts a block stages
constexpr int kBNP = 128;               // columns of one weight part (kernels/moe_gemm.py PART)
constexpr int kStages = 5;              // ring stages (kernels/moe_gemm.py STAGES)
static_assert(kBNP % kBox == 0, "a weight part is whole TMA boxes");
constexpr int kBPart = kBK * kBNP * 2;          // one weight part: 64 k rows of kBNP columns
constexpr int kStage = kABytes + 2 * kBPart;    // 40 KB
constexpr int kStaging = kBM * kBNP * 2;        // one output part, in 64-column boxes
// stages, the output staging, the full and empty barriers, slack to align the ring to 1024
constexpr int kSmem = kStages * kStage + kStaging + 16 * kStages + 1024;

struct Args {
  const bf16* x;
  const int* rows;   // (E, C), or nullptr: the buffer's own rows
  const int* count;  // (E,)
  bf16* y;           // (E, C, N)
  long long lda;     // elements between rows of x
  int E, C, K, N;
  int box_m;         // rows of A a stage loads: C rounded up to 8, at most 64
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

// 16 bytes from global to shared memory, asynchronously; bytes = 0 writes
// zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

// The barrier's arrival of this thread, once its cp.async copies so far land
// (the barrier's count includes it: noinc).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// A bulk tensor store from shared memory, in this thread's bulk group.
__device__ __forceinline__ void tma_store3(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                           int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// The staging may be written again once the committed stores have read it.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }
// The consumer warpgroup's own barrier (barrier 0 is __syncthreads').
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 128;\n" ::: "memory"); }

// The 16-byte chunk c of row r of an A tile under TMA's 128-byte swizzle.
__device__ __forceinline__ int swz128(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// A shared-memory matrix descriptor: start, leading and stride byte offsets
// (16-byte units), layout (1: 128-byte swizzle).
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
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma m64nNk16, bf16 in, f32 accumulate (acc += A B), A K-major, B
// MN-major (the (K, N) row-major weight).
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// The descriptors of k16 step kk of a stage: A rows of 64 k, and a weight
// part MN-major in 64-wide atoms of 64 k rows, both under the 128-byte
// swizzle, as gemm_rowinv lays them.
__device__ __forceinline__ uint64_t desc_a(uint32_t a, int kk) { return desc(a + kk * 32, 1, 64, 1); }
__device__ __forceinline__ uint64_t desc_b(uint32_t b, int kk) {
  return desc(b + kk * 16 * 128, (kBK * 128) >> 4, 64, 1);
}

// silu(g) * u as PyTorch computes F.silu(g) * u on bf16 tensors: g and u
// rounded to bf16, silu in float and rounded, the product rounded.
__device__ __forceinline__ bf16 silu_mul(float g, float u) {
  const float gb = __bfloat162float(__float2bfloat16(g));
  const float s = __bfloat162float(__float2bfloat16(gb / (1.0f + expf(-gb))));
  return __float2bfloat16(s * __bfloat162float(__float2bfloat16(u)));
}

// tw, tu: the weight maps (tu: w_up, fused only); tx: the buffer's map
// (down only).
template <bool FUSED>
__global__ void __launch_bounds__(kThreads, 1)
    moe_gemm_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                    const __grid_constant__ CUtensorMap tu, const __grid_constant__ CUtensorMap ty,
                    const Args a) {
  constexpr int TN = FUSED ? kBNP : 2 * kBNP;  // output columns of a tile
  __shared__ int s_cnt[kMaxE];      // filled rows of each expert
  __shared__ int s_pre[kMaxE + 1];  // filled row tiles before each expert
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* ring = smem_raw + (base - raw);
  const uint32_t staging = base + kStages * kStage;  // the epilogue's output part
  uint8_t* stage_out = ring + kStages * kStage;
  const uint32_t bars = staging + kStaging;  // full[s]: + 8 s; empty[s]: + 8 (kStages + s)
  const int tid = threadIdx.x, lane = tid % 32;

  for (int e = tid; e < a.E; e += kThreads) s_cnt[e] = min(max(a.count[e], 0), a.C);
  // Rows of every stage's A tile past the box stay zero.
  for (int i = tid; i < kStages * (kBM - a.box_m) * 8; i += kThreads) {
    const int s = i / ((kBM - a.box_m) * 8), j = i % ((kBM - a.box_m) * 8);
    *reinterpret_cast<uint4*>(ring + s * kStage + (a.box_m + j / 8) * 128 + (j % 8) * 16) =
        make_uint4(0, 0, 0, 0);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the TMA thread's expect_tx, then (gate/up) each producer's cp.async arrival
      mbar_init(bars + 8 * s, FUSED ? 1 + 128 : 1);
      mbar_init(bars + 8 * (kStages + s), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid < 32) {  // the prefix of filled row tiles: a range of experts a lane
    const int per = (a.E + 31) / 32, lo = min(a.E, tid * per), hi = min(a.E, lo + per);
    int own = 0;
    for (int e = lo; e < hi; ++e) own += (s_cnt[e] + kBM - 1) / kBM;
    int incl = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (tid >= o) incl += v;
    }
    int run = incl - own;
    for (int e = lo; e < hi; ++e) {
      s_pre[e] = run;
      run += (s_cnt[e] + kBM - 1) / kBM;
    }
    if (tid == 31) s_pre[a.E] = incl;
  }
  __syncthreads();

  const int tiles_n = (a.N + TN - 1) / TN;
  const int tiles = s_pre[a.E] * tiles_n;
  // Tile t: the (t / tiles_n)-th filled row tile, column tile t % tiles_n.
  auto tile_of = [&](int t, int& e, int& m0, int& n0, int& live) {
    const int u = t / tiles_n;
    int lo = 0, hi = a.E - 1;  // the last expert whose first row tile is at or before u
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_pre[mid] <= u)
        lo = mid;
      else
        hi = mid - 1;
    }
    e = lo;
    m0 = (u - s_pre[lo]) * kBM;
    n0 = (t % tiles_n) * TN;
    live = min(s_cnt[lo] - m0, kBM);
  };
  const int nkt = (a.K + kBK - 1) / kBK;
  // The warpgroup's role, warp-uniform as ptxas can see: wgmma issued on a
  // path it takes as divergent is serialized.
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (wg == 1) {  // the producer warpgroup
    const int p = tid - 128;
    if (!FUSED && p != 0) return;  // down: one thread issues every TMA
    const int c = p % 8;           // gate/up: this thread's chunk of rows p / 8 + 16 j
    int g = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int e, m0, n0, live;
      tile_of(t, e, m0, n0, live);
      [[maybe_unused]] long long src[4];  // rows of x, read once a tile (-1: a zero row)
      if constexpr (FUSED) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = p / 8 + 16 * j;
          const long long slot = (long long)e * a.C + m0 + r;
          src[j] = r >= live ? -1 : a.rows ? (long long)a.rows[slot] : slot;
        }
      }
      for (int kt = 0; kt < nkt; ++kt, ++g) {
        const int s = g % kStages, u = g / kStages;
        if (u > 0) mbar_wait(bars + 8 * (kStages + s), (u - 1) & 1);
        const int k0 = kt * kBK;
        const uint32_t full = bars + 8 * s;
        const uint32_t sa = base + s * kStage, sb = sa + kABytes;
        if (p == 0) {
          mbar_expect_tx(full, (FUSED ? 0 : a.box_m * kBK * 2) + 2 * kBPart);
          if constexpr (!FUSED) tma_load3(sa, &tx, full, k0, m0, e);
#pragma unroll
          for (int j = 0; j < kBNP / kBox; ++j) {
            tma_load3(sb + j * kBox * kBK * 2, &tw, full, n0 + j * kBox, k0, e);
            if constexpr (FUSED)
              tma_load3(sb + kBPart + j * kBox * kBK * 2, &tu, full, n0 + j * kBox, k0, e);
            else
              tma_load3(sb + kBPart + j * kBox * kBK * 2, &tw, full, n0 + kBNP + j * kBox,
                        k0, e);
          }
        }
        if constexpr (FUSED) {
          const int kc = k0 + 8 * c;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = p / 8 + 16 * j;
            if (r >= live) break;
            const bool ok = src[j] >= 0 && kc < a.K;
            cp_async16(sa + swz128(r, c), ok ? a.x + src[j] * a.lda + kc : a.x, ok ? 16 : 0);
          }
          cp_async_arrive(full);
        }
      }
    }
  } else {  // the consumer warpgroup
    // Zeros first, in the rows no tile covers (every row of an empty expert,
    // an expert's row tiles past its filled ones), spread over every
    // consumer warp of the grid; the producer fills the ring meanwhile.
    {
      const int warp = blockIdx.x * 4 + tid / 32, warps = gridDim.x * 4;
      const long long units = (long long)a.E * a.C;
      for (long long u = warp; u < units; u += warps) {
        const int e = (int)(u / a.C), r = (int)(u % a.C);
        if (r < min((s_pre[e + 1] - s_pre[e]) * kBM, a.C)) continue;
        uint4* row = reinterpret_cast<uint4*>(a.y + u * a.N);
        for (int i = lane; i < a.N / 8; i += 32) row[i] = make_uint4(0, 0, 0, 0);
      }
    }
    // Whole k tiles issue their four k16 steps; the last issues only the
    // steps that reach below K.
    const int steps_last = ((a.K - (nkt - 1) * kBK) + 15) / 16;
    auto release = [&](int s) {
      if (lane == 0) mbar_arrive(bars + 8 * (kStages + s));
    };
    const int rw = tid / 32 * 16 + lane / 4;
    int g = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int e, m0, n0, live;
      tile_of(t, e, m0, n0, live);
      float acc[kBNP / 2], acc2[kBNP / 2];
#pragma unroll
      for (int i = 0; i < kBNP / 2; ++i) acc[i] = acc2[i] = 0.f;
      fence_acc(acc);
      fence_acc(acc2);
      for (int kt = 0; kt < nkt; ++kt, ++g) {
        const int s = g % kStages;
        mbar_wait(bars + 8 * s, (g / kStages) & 1);
        // cp.async wrote A through the generic proxy; wgmma reads it
        // through the async proxy.
        if constexpr (FUSED) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const uint32_t sa = base + s * kStage, sb = sa + kABytes;
        const int steps = kt + 1 < nkt ? kBK / 16 : steps_last;
        wg_fence();
        if (steps == 4) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_n128(acc, desc_a(sa, kk), desc_b(sb, kk));
            wgmma_n128(acc2, desc_a(sa, kk), desc_b(sb + kBPart, kk));
          }
        } else {
          for (int kk = 0; kk < steps; ++kk) {
            wgmma_n128(acc, desc_a(sa, kk), desc_b(sb, kk));
            wgmma_n128(acc2, desc_a(sa, kk), desc_b(sb + kBPart, kk));
          }
        }
        wg_commit();
        wg_wait<1>();  // stage g - 1's products are done: release its slot
        if (kt > 0) release((g - 1) % kStages);
      }
      wg_wait<0>();
      fence_acc(acc);
      fence_acc(acc2);
      release((g - 1) % kStages);

      // Epilogue: thread t holds rows w * 16 + lane / 4 (+ 8) and columns
      // 8 j + 2 (lane % 4) (+ 1) of each part; rows of the box past the
      // filled ones are written as zeros.  Each output part is staged in
      // shared memory as 64-column boxes under the 128-byte swizzle (no bank
      // conflicts) and leaves by TMA stores, which clip the rows past C and
      // the columns past N; the consumers go on to the next tile while the
      // stores drain.
#pragma unroll
      for (int q = 0; q < (FUSED ? 1 : 2); ++q) {
        if (tid == 0) bulk_wait_read();  // the last part's stores have read the staging
        consumer_sync();
#pragma unroll
        for (int j = 0; j < kBNP / 8; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = rw + 8 * h, i = 4 * j + 2 * h;
            if (r >= a.box_m) continue;
            __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
            if (r < live) {
              if constexpr (FUSED)
                v = __halves2bfloat162(silu_mul(acc[i], acc2[i]), silu_mul(acc[i + 1], acc2[i + 1]));
              else
                v = q == 0 ? __floats2bfloat162_rn(acc[i], acc[i + 1])
                           : __floats2bfloat162_rn(acc2[i], acc2[i + 1]);
            }
            *reinterpret_cast<__nv_bfloat162*>(stage_out + (j / 8) * (kBM * 128) + r * 128 +
                                                (((j % 8) ^ (r & 7)) << 4) + (lane % 4) * 4) = v;
          }
        }
        // the generic proxy's stores, visible to the TMA stores' async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        consumer_sync();
        if (tid == 0) {
#pragma unroll
          for (int c = 0; c < kBNP / kBox; ++c) {
            const int col = n0 + q * kBNP + c * kBox;
            if (col < a.N) tma_store3(&ty, staging + c * (kBM * 128), col, m0, e);
          }
          bulk_commit();
        }
      }
    }
    if (tid == 0) bulk_wait();  // every store done before the block's shared memory goes
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

// Everything a map holds; two equal keys make equal maps.  The weights'
// maps are set by their pointer and shape, so a call with known weights
// (every decode step) encodes only the buffer's map, and that one only
// when the buffer moved.
struct MapKey {
  const void* ptr;
  cuuint64_t dims[3], strides[2];
  cuuint32_t box[3];
  int swizzle;
  bool operator==(const MapKey& o) const { return memcmp(this, &o, sizeof(MapKey)) == 0; }
};

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    const unsigned char* p = reinterpret_cast<const unsigned char*>(&k);
    size_t h = 1469598103934665603ull;
    for (size_t i = 0; i < sizeof(MapKey); ++i) h = (h ^ p[i]) * 1099511628211ull;
    return h;
  }
};

constexpr size_t kMapCacheMax = 4096;

bool tensor_map(CUtensorMap* out, const void* ptr, const cuuint64_t dims[3],
                const cuuint64_t strides[2], const cuuint32_t box[3], CUtensorMapSwizzle sw) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  MapKey key;
  memset(&key, 0, sizeof(key));
  key.ptr = ptr;
  memcpy(key.dims, dims, sizeof(key.dims));
  memcpy(key.strides, strides, sizeof(key.strides));
  memcpy(key.box, box, sizeof(key.box));
  key.swizzle = static_cast<int>(sw);
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return true;
  }
  const EncodeTiledFn enc = encoder();
  if (!enc) return false;
  const cuuint32_t ones[3] = {1, 1, 1};
  if (enc(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
          ones, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (cache.size() >= kMapCacheMax) cache.clear();
  cache.emplace(key, *out);
  return true;
}

// The 3-D map of an (E, K, N) row-major bf16 weight: dims (N, K, E), box
// 64 x 64 x 1 under the 128-byte swizzle.
bool weight_map(CUtensorMap* out, const void* ptr, int E, int K, int N) {
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t strides[2] = {2ull * N, 2ull * N * K};
  const cuuint32_t box[3] = {kBox, kBK, 1};
  return tensor_map(out, ptr, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// bn, stages, blocks: the plan's tile width, ring and grid.
template <bool FUSED>
cudaError_t launch(Args a, const void* w, const void* w_up, int bn, int stages, int blocks,
                   cudaStream_t stream) {
  constexpr int TN = FUSED ? kBNP : 2 * kBNP;
  if (bn != TN || stages != kStages || blocks <= 0) return cudaErrorInvalidValue;
  auto kernel = moe_gemm_kernel<FUSED>;
  a.box_m = a.C < kBM ? (a.C + 7) / 8 * 8 : kBM;
  CUtensorMap tx, tw, tu, ty;
  memset(&ty, 0, sizeof(ty));
  memset(&tx, 0, sizeof(tx));
  memset(&tw, 0, sizeof(tw));
  memset(&tu, 0, sizeof(tu));
  if (!weight_map(&tw, w, a.E, a.K, a.N)) return cudaErrorInvalidValue;
  if (FUSED && !weight_map(&tu, w_up, a.E, a.K, a.N)) return cudaErrorInvalidValue;
  if (!FUSED) {  // the buffer (E, C, K), rows lda apart: dims (K, C, E)
    const cuuint64_t dims[3] = {(cuuint64_t)a.K, (cuuint64_t)a.C, (cuuint64_t)a.E};
    const cuuint64_t strides[2] = {2ull * a.lda, 2ull * a.lda * a.C};
    const cuuint32_t box[3] = {kBK, (cuuint32_t)a.box_m, 1};
    if (!tensor_map(&tx, a.x, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
      return cudaErrorInvalidValue;
  }
  {  // the output (E, C, N): dims (N, C, E), a box of 64 columns and box_m rows
    const cuuint64_t dims[3] = {(cuuint64_t)a.N, (cuuint64_t)a.C, (cuuint64_t)a.E};
    const cuuint64_t strides[2] = {2ull * a.N, 2ull * a.N * a.C};
    const cuuint32_t box[3] = {kBox, (cuuint32_t)a.box_m, 1};
    if (!tensor_map(&ty, a.y, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
      return cudaErrorInvalidValue;
  }
  static bool attr = false;  // one opt-in per instance, before its first launch
  if (!attr) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  // The most tiles a call can fill, every expert's every row tile, must
  // index in 32 bits.
  const long long most = (long long)a.E * ((a.C + kBM - 1) / kBM) * ((a.N + TN - 1) / TN);
  if (most > INT32_MAX) return cudaErrorInvalidValue;
  kernel<<<blocks, kThreads, kSmem, stream>>>(tx, tw, tu, ty, a);
  return cudaGetLastError();
}

}  // namespace moe
}  // namespace repro

// x: (T, K) token rows gathered through rows (E, C) int32, or (rows null)
// the (E, C, K) buffer with rows lda apart; count (E,) int32; w, w_up
// (E, K, N) bf16, w_up null for the plain product; y (E, C, N) bf16.  E at
// most 512, K and N multiples of 8, lda a multiple of 8, 16-byte aligned
// x, w, w_up and y.  bn, stages, blocks: kernels/moe_gemm.py:plan's tile
// width (128 fused, 256 down), ring stages (5) and grid; any other tile or
// ring is refused.  Returns a cudaError_t value.
extern "C" int moe_gemm_launch(const void* x, const void* rows, const void* count,
                               const void* w, const void* w_up, void* y, int E, int C, int K,
                               int N, long long lda, int bn, int stages, int blocks,
                               void* stream) {
  using namespace repro::moe;
  if (E <= 0 || E > kMaxE || C <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8 || lda % 8 ||
      lda < K || !x || !count || !w || !y)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(w_up) | reinterpret_cast<uintptr_t>(y)) % 16)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(x), static_cast<const int*>(rows),
               static_cast<const int*>(count), static_cast<bf16*>(y), lda, E, C, K, N, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return w_up ? launch<true>(a, w, w_up, bn, stages, blocks, st)
              : launch<false>(a, w, nullptr, bn, stages, blocks, st);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
