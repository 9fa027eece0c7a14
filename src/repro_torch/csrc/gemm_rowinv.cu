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
//   acc = 0; for k0 = 0, 16, 32, ... < K: acc += wgmma(x[r, k0:k0+16], w[k0:k0+16, n])
//
// one chain of wgmma m64nNk16 products (bf16 in, f32 accumulate, both
// operands in shared memory under a 128- or 64-byte swizzle) in ascending
// k0, with no split over K.  A partial last k16 step reads zeros past K;
// k16 steps wholly past K are skipped, never multiplied as zeros.  Every
// bf16 route issues that same chain on the same instruction family, whatever
// its tile width (n256, n128 or n32: each element is the same dot product),
// the block's place among the tiles, or how its stages were filled, so the
// route may follow M and N (kernels/gemm.py:plan, which the wrapper passes
// here; chip_smoke.py holds every route's bits equal).  No route uses
// mma.sync: nothing promises that its k16 step rounds as wgmma's does.
//
// Each block: consumer warpgroups issue wgmma on the stages of a ring in
// shared memory, and a producer warpgroup fills the ring behind mbarriers,
// by TMA (cp.async.bulk.tensor; maps cached below) where the operands allow
// it.  The epilogue stages the output tile in shared memory and writes
// whole 16-byte pieces of rows.
//   wide    M > 64 with at least one wave of 128 x 256 tiles (prefill): two
//           consumer warpgroups of 64 x 256, a 4-stage ring of BK = 64
//           (48 KB a stage), setmaxnreg to give the consumers the
//           registers, one tile a block.  Bound by the tensor cores; tiles
//           run M-fastest when the weight is the larger operand, so a wave
//           reads a few weight columns once and x from L2.
//   narrow  other aligned products with M > 64 (x_proj's N 288): 64 x 32
//           tiles, a 5-stage ring, three blocks an SM.  x_proj is bound by
//           the latency of its chain: 512 dependent k16 steps.
//   gemv    M <= 64, N < 32768 (decode): 64 x 32 tiles, an 8-stage ring,
//           two blocks an SM.  x's box holds only its M rows (rounded to
//           8), the rest of the A tile stays zero: TMA issues a request per
//           box row, and the weight's rows are what must stream.  Bound by
//           the weight's bytes, and for long K (down_proj's 432 steps) by
//           the chain's latency.
//   head    M <= 64, N >= 32768 (the vocabularies): 64 x 128 tiles, 128-byte
//           rows of the weight in each request, a 6-stage ring.  Bound by
//           the weight's bytes.
//   plain   the narrow tile, filled by the producer warpgroup's plain loads
//           into the layout TMA's swizzle gives: any pointer and row stride
//           (TMA needs 16-byte aligned bases and strides).
// Every route but wide is persistent: one wave of blocks walks the tiles,
// the ring's stages running on across them, so the next tile loads while
// this one's epilogue runs.
//
// x is wgmma's A operand (K-major); a (K, N) row-major weight is B in
// MN-major order (the transpose bit), a tied head's (N, K) table (wt = 1)
// K-major.  float32 inputs take route f32: SIMT FMAs over 64 x 64 tiles,
// acc = fma(x[r, k], w[k, n], acc) for k ascending, the same rule.
//
// The output has x's dtype.  A bias is added as PyTorch adds it after the
// product: bf16 rounds the product first, then rounds the sum.  A batch of
// `batch` independent products (a block-diagonal weight: recurrentgemma's
// gates) runs as one launch, with its own strides for x, w, bias and y.
//
// TMA maps are made on the host by cuTensorMapEncodeTiled (reached through
// cudaGetDriverEntryPoint) and cached by everything a map holds: pointer,
// dims, strides, box and swizzle; decode is host-bound, so a call with
// known operands encodes nothing.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>
#include <unordered_map>

namespace repro {
namespace gemm {

using bf16 = __nv_bfloat16;

// The plan's route codes (kernels/gemm.py:ROUTES).
enum Route { kF32 = 0, kWide = 1, kNarrow = 2, kPlain = 3, kGemv = 4, kHead = 5 };

struct Args {
  const void* x;
  const void* w;
  const void* bias;
  void* y;
  int M, N, K;
  long long lda, ldw, ldy;      // row strides, elements
  long long sx, sw, sb, sy;     // strides between the products of a batch
  int x_bm;                     // x's map orders its dims (K, batch, M), not (K, M, batch)
  int box_m;                    // rows of x's TMA box: BM, or M rounded up to 8 when M < BM
  int batch;
  int m_fast;                   // tiles in M-fastest order: the weight is the larger operand
};

constexpr int kBK = 64;  // k of one stage: one 128-byte swizzled row of bf16

template <int WGS, int BN, int STAGES, bool PERSIST>
struct Shape {
  static constexpr int BM = 64 * WGS;
  static constexpr int A_BYTES = BM * kBK * 2;
  static constexpr int B_BYTES = BN * kBK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGING = BM * (BN * 2 + 16);  // the epilogue's staged rows
  // Persistent blocks stage their output beside the ring (the producer is
  // already filling it with the next tile); a block of one tile stages it
  // in the drained ring.
  static constexpr int OWN_STAGING = PERSIST ? STAGING : 0;
  // stages, staging, the full and empty barriers, slack to align the ring to 1024
  static constexpr int SMEM = STAGES * STAGE + OWN_STAGING + 16 * STAGES + 1024;
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

// The 16-byte chunk c of row r of a stage's operand tile, as TMA's swizzle
// lays it out: rows of 128 bytes (x, and the (N, K) table's rows of 64 k),
// or the 32-wide k rows of 64 bytes of a (K, N) weight's narrow tile.
__device__ __forceinline__ int swz128(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }
__device__ __forceinline__ int swz64(int r, int c) { return r * 64 + ((c ^ ((r >> 1) & 3)) << 4); }

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
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma m64nNk16, bf16 in, f32 accumulate (scale-d = 1: acc += A B), A
// K-major; TB = 1 when B is MN-major.
template <int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int BN, int TB>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256)
    wgmma_n256<TB>(d, da, db);
  else if constexpr (BN == 128)
    wgmma_n128<TB>(d, da, db);
  else if constexpr (BN == 64)
    wgmma_n64<TB>(d, da, db);
  else
    wgmma_n32<TB>(d, da, db);
}

// B's descriptor for k16 step kk of a stage: the (N, K) table is K-major
// like A (rows of 64 k, 128-byte swizzle); a (K, N) weight is MN-major, in
// 64-wide atoms of 64 k rows (128-byte swizzle) or one 32-wide atom
// (64-byte swizzle).
template <int BN, bool WT>
__device__ __forceinline__ uint64_t desc_b(uint32_t b, int kk) {
  if constexpr (WT)
    return desc(b + kk * 32, 1, 64, 1);
  else if constexpr (BN >= 64)
    return desc(b + kk * 16 * 128, (kBK * 128) >> 4, 64, 1);
  else
    return desc(b + kk * 16 * 64, (kBK * 64) >> 4, 32, 2);
}

// Eight elements of row r from column c of a row-major matrix with ld
// between rows, zeros past (rows, cols): one 16-byte chunk of a stage.
__device__ __forceinline__ uint4 load8(const uint16_t* p, long long ld, int r, int c, int rows,
                                       int cols) {
  uint16_t v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = r < rows && c + e < cols ? p[r * ld + c + e] : 0;
  uint4 out;
  out.x = v[0] | (uint32_t)v[1] << 16;
  out.y = v[2] | (uint32_t)v[3] << 16;
  out.z = v[4] | (uint32_t)v[5] << 16;
  out.w = v[6] | (uint32_t)v[7] << 16;
  return out;
}

// How a stage is filled: by TMA (one thread), or by plain loads (all 128
// threads of the producer warpgroup) into the layout TMA's swizzle gives.
enum Load { kTma = 0, kPlainLoads = 1 };

// One block: a (64 WGS) x BN tile of y.  Warpgroups 0..WGS-1 consume the
// ring with wgmma; warpgroup WGS produces it.
template <int WGS, int BN, bool WT, int LOAD, int STAGES, int MINB, bool PERSIST>
__global__ void __launch_bounds__((WGS + 1) * 128, MINB)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                      const Args a) {
  using S = Shape<WGS, BN, STAGES, PERSIST>;
  static_assert(BN == 256 || BN == 128 || BN == 64 || BN == 32, "wgmma instances");
  static_assert(LOAD == kTma || WT || BN == 32, "the plain loads fill 32-wide (K, N) tiles");
  static_assert(PERSIST || STAGES * S::STAGE >= S::STAGING, "the drained ring holds the output");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* ring = smem_raw + (base - raw);
  uint8_t* staging = ring + (PERSIST ? STAGES * S::STAGE : 0);  // the epilogue's tiles
  const uint32_t bars = base + STAGES * S::STAGE + S::OWN_STAGING;  // full[s]: + 8 s; empty[s]: + 8 (STAGES + s)
  const int tid = threadIdx.x;
  // The warpgroup's role, warp-uniform as ptxas can see: wgmma issued on a
  // path it takes as divergent is serialized.
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int tiles_n = (a.N + BN - 1) / BN, tiles_m = (a.M + S::BM - 1) / S::BM;
  const int tiles = tiles_n * tiles_m * a.batch;
  // Tile order: M fastest when the weight is the larger operand (a wave of
  // blocks then shares a few weight columns, read once, and x from L2), N
  // fastest otherwise.  The order touches no element's sum.
  auto tile_of = [&](int t, int& n0, int& m0, int& z) {
    n0 = (a.m_fast ? t / tiles_m % tiles_n : t % tiles_n) * BN;
    m0 = (a.m_fast ? t % tiles_m : t / tiles_n % tiles_m) * S::BM;
    z = t / (tiles_n * tiles_m);
  };
  const int nkt = (a.K + kBK - 1) / kBK;
  // Rows of x a tile loads; the rest of every stage's A tile stays zero.
  const int live = a.box_m;
  if (LOAD == kTma && live < S::BM) {
    for (int i = tid; i < STAGES * (S::BM - live) * 8; i += blockDim.x) {
      const int s = i / ((S::BM - live) * 8), j = i % ((S::BM - live) * 8);
      *reinterpret_cast<uint4*>(ring + s * S::STAGE + (live + j / 8) * 128 + (j % 8) * 16) =
          make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, LOAD == kTma ? 1 : 128);
      mbar_init(bars + 8 * (STAGES + s), 4 * WGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Block b takes tiles b, b + gridDim.x, ... (N fastest).  Persistent
  // blocks take several: the ring's stage counter g runs on across them, so
  // the producer loads the next tile while the consumers finish this one.
  if (wg == WGS) {  // the producer warpgroup
    if constexpr (WGS == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int p = tid - WGS * 128;
    if (LOAD == kTma && p != 0) return;
    const int bytes = live * kBK * 2 + S::B_BYTES;
    int g = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int n0, m0, z;
      tile_of(t, n0, m0, z);
      for (int kt = 0; kt < nkt; ++kt, ++g) {
        const int s = g % STAGES, u = g / STAGES;
        if (u > 0) mbar_wait(bars + 8 * (STAGES + s), (u - 1) & 1);
        const int k0 = kt * kBK;
        if constexpr (LOAD == kTma) {
          const uint32_t full = bars + 8 * s;
          const uint32_t sa = base + s * S::STAGE, sb = sa + S::A_BYTES;
          mbar_expect_tx(full, bytes);
          if (a.x_bm)
            tma_load3(sa, &tx, full, k0, z, m0);
          else
            tma_load3(sa, &tx, full, k0, m0, z);
          if constexpr (WT) {
            tma_load3(sb, &tw, full, k0, n0, z);
          } else {
            constexpr int BOX = BN >= 64 ? 64 : BN;
#pragma unroll
            for (int j = 0; j < BN / BOX; ++j)
              tma_load3(sb + j * BOX * kBK * 2, &tw, full, n0 + j * BOX, k0, z);
          }
        } else {
          const uint16_t* x = static_cast<const uint16_t*>(a.x) + z * a.sx;
          const uint16_t* w = static_cast<const uint16_t*>(a.w) + z * a.sw;
          uint8_t* sa = ring + s * S::STAGE;
          uint8_t* sb = sa + S::A_BYTES;
          for (int i = p; i < S::BM * 8; i += 128) {
            const int r = i / 8, c = i % 8;
            *reinterpret_cast<uint4*>(sa + swz128(r, c)) =
                load8(x, a.lda, m0 + r, k0 + 8 * c, a.M, a.K);
          }
          if constexpr (WT) {
            for (int i = p; i < BN * 8; i += 128) {
              const int r = i / 8, c = i % 8;
              *reinterpret_cast<uint4*>(sb + swz128(r, c)) =
                  load8(w, a.ldw, n0 + r, k0 + 8 * c, a.N, a.K);
            }
          } else {
            for (int i = p; i < kBK * 4; i += 128) {
              const int r = i / 4, c = i % 4;
              *reinterpret_cast<uint4*>(sb + swz64(r, c)) =
                  load8(w, a.ldw, k0 + r, n0 + 8 * c, a.K, a.N);
            }
          }
          // the generic proxy's stores, visible to wgmma's async proxy
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(bars + 8 * s);
        }
      }
    }
  } else {  // the consumer warpgroups
    if constexpr (WGS == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    constexpr int PITCH = BN * 2 + 16;  // bytes of a staged row: no bank conflicts
    uint8_t* tile = staging + wg * 64 * PITCH;
    const int t128 = tid % 128, lane = tid % 32;
    const int rw = t128 / 32 * 16 + lane / 4;
    const bool vec = ((a.ldy | a.sy) & 7) == 0 && (reinterpret_cast<uintptr_t>(a.y) & 15) == 0;
    // Whole k tiles issue their four k16 steps without a branch; the last
    // tile issues only the steps that reach below K (a uniform choice).
    const int steps_last = ((a.K - (nkt - 1) * kBK) + 15) / 16;
    int g = 0;
    auto release = [&](int s) {  // every consumer warp lets the stage go
      if (lane == 0) mbar_arrive(bars + 8 * (STAGES + s));
    };
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int n0, m0, z;
      tile_of(t, n0, m0, z);
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      fence_acc(acc);
      for (int kt = 0; kt < nkt; ++kt, ++g) {
        const int s = g % STAGES;
        mbar_wait(bars + 8 * s, (g / STAGES) & 1);
        const uint32_t sa = base + s * S::STAGE + wg * 64 * 128;
        const uint32_t sb = base + s * S::STAGE + S::A_BYTES;
        const int steps = kt + 1 < nkt ? kBK / 16 : steps_last;
        wg_fence();
        if (steps == 4) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            mma<BN, WT ? 0 : 1>(acc, desc(sa + kk * 32, 1, 64, 1), desc_b<BN, WT>(sb, kk));
        } else {
          for (int kk = 0; kk < steps; ++kk)
            mma<BN, WT ? 0 : 1>(acc, desc(sa + kk * 32, 1, 64, 1), desc_b<BN, WT>(sb, kk));
        }
        wg_commit();
        wg_wait<1>();  // stage g - 1's products are done: release its slot
        if (kt > 0) release((g - 1) % STAGES);
      }
      wg_wait<0>();
      fence_acc(acc);
      release((g - 1) % STAGES);

      // Epilogue: round the sum (and add the bias, rounding again) in
      // registers, stage the warpgroup's 64 x BN tile, then write whole
      // 16-byte pieces of rows.
      const bf16* bias = a.bias ? static_cast<const bf16*>(a.bias) + z * a.sb : nullptr;
      if constexpr (!PERSIST)  // every consumer is done reading the ring
        asm volatile("bar.sync 3, %0;\n" ::"n"(WGS * 128) : "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the last tile's reads
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int cl = j * 8 + (lane % 4) * 2, c = n0 + cl;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          bf16 v0 = __float2bfloat16(acc[4 * j + 2 * h]);
          bf16 v1 = __float2bfloat16(acc[4 * j + 2 * h + 1]);
          if (bias) {
            if (c < a.N) v0 = __float2bfloat16(__bfloat162float(v0) + __bfloat162float(bias[c]));
            if (c + 1 < a.N)
              v1 = __float2bfloat16(__bfloat162float(v1) + __bfloat162float(bias[c + 1]));
          }
          *reinterpret_cast<__nv_bfloat162*>(tile + (rw + 8 * h) * PITCH + cl * 2) =
              __halves2bfloat162(v0, v1);
        }
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      bf16* y = static_cast<bf16*>(a.y) + z * a.sy;
      for (int i = t128; i < 64 * (BN / 8); i += 128) {
        const int r = i / (BN / 8), c8 = i % (BN / 8);
        const int gr = m0 + wg * 64 + r, gc = n0 + c8 * 8;
        if (gr >= a.M || gc >= a.N) continue;
        const uint8_t* src = tile + r * PITCH + c8 * 16;
        bf16* dst = y + (long long)gr * a.ldy + gc;
        if (vec && gc + 8 <= a.N) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < 8 && gc + e < a.N; ++e) dst[e] = reinterpret_cast<const bf16*>(src)[e];
        }
      }
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

// Everything a map holds; two equal keys make equal maps.
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
long long maps_encoded = 0;  // cache misses, under the cache's lock

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
  ++maps_encoded;
  if (cache.size() >= kMapCacheMax) cache.clear();
  cache.emplace(key, *out);
  return true;
}

// Whether TMA can read x and w: 16-byte aligned bases, row and batch
// strides, and rows (kernels/gemm.py:operands computes the same "tma").
bool tma_ok(const Args& a, int batch) {
  const bool strides = a.lda % 8 == 0 && a.ldw % 8 == 0 &&
                       (batch == 1 || (a.sx % 8 == 0 && a.sw % 8 == 0));
  return (reinterpret_cast<uintptr_t>(a.x) % 16 == 0) &&
         (reinterpret_cast<uintptr_t>(a.w) % 16 == 0) && strides && a.K % 8 == 0 &&
         a.N % 8 == 0;
}

// The maps of x (box 64 k x box_m rows) and w (64 k x BN) of a TMA route.
template <int BN, bool WT>
bool make_maps(CUtensorMap* tx, CUtensorMap* tw, Args* a, int batch) {
  const cuuint64_t M = a->M, N = a->N, K = a->K, B = batch;
  a->x_bm = batch > 1 && a->sx < a->lda;
  {
    const cuuint64_t ld = 2 * a->lda, sz = batch > 1 ? 2 * a->sx : ld * M;
    const cuuint64_t dims[3] = {K, a->x_bm ? B : M, a->x_bm ? M : B};
    const cuuint64_t strides[2] = {a->x_bm ? sz : ld, a->x_bm ? ld : sz};
    const cuuint32_t bm = a->box_m;
    const cuuint32_t box[3] = {kBK, a->x_bm ? 1u : bm, a->x_bm ? bm : 1u};
    if (!tensor_map(tx, a->x, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B)) return false;
  }
  const cuuint64_t ld = 2 * a->ldw;
  if (WT) {
    const cuuint64_t dims[3] = {K, N, B};
    const cuuint64_t strides[2] = {ld, batch > 1 ? 2 * a->sw : ld * N};
    const cuuint32_t box[3] = {kBK, BN, 1};
    return tensor_map(tw, a->w, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  const cuuint64_t dims[3] = {N, K, B};
  const cuuint64_t strides[2] = {ld, batch > 1 ? 2 * a->sw : ld * K};
  const cuuint32_t box[3] = {BN >= 64 ? 64u : (cuuint32_t)BN, kBK, 1};
  return tensor_map(tw, a->w, dims, strides, box,
                    BN >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

// The current device's SMs, read once per device.
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!counts[dev] &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return counts[dev];
}

template <int WGS, int BN, bool WT, int LOAD, int STAGES, int MINB, bool PERSIST>
cudaError_t launch_wgmma(Args a, int batch, cudaStream_t stream) {
  using S = Shape<WGS, BN, STAGES, PERSIST>;
  auto kernel = gemm_wgmma_kernel<WGS, BN, WT, LOAD, STAGES, MINB, PERSIST>;
  CUtensorMap tx, tw;
  memset(&tx, 0, sizeof(tx));
  memset(&tw, 0, sizeof(tw));
  a.box_m = a.M < S::BM ? (a.M + 7) / 8 * 8 : S::BM;
  if (LOAD == kTma && !tma_ok(a, batch)) return cudaErrorInvalidValue;
  if (LOAD == kTma && !make_maps<BN, WT>(&tx, &tw, &a, batch)) return cudaErrorInvalidValue;
  static bool attr = false;  // one opt-in per instance, before its first launch
  if (!attr) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const long long tiles =
      (long long)((a.N + BN - 1) / BN) * ((a.M + S::BM - 1) / S::BM) * batch;
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  const long long slots = PERSIST ? (long long)sm_count() * MINB : tiles;  // one wave, or a block a tile
  kernel<<<(unsigned)(tiles < slots ? tiles : slots), (WGS + 1) * 128, S::SMEM, stream>>>(tx, tw,
                                                                                            a);
  return cudaGetLastError();
}

template <bool WT>
cudaError_t route_bf16(const Args& a, int batch, int route, cudaStream_t stream) {
  switch (route) {
    case kWide: return launch_wgmma<2, 256, WT, kTma, 4, 1, false>(a, batch, stream);
    case kNarrow: return launch_wgmma<1, 32, WT, kTma, 5, 3, true>(a, batch, stream);
    case kPlain: return launch_wgmma<1, 32, WT, kPlainLoads, 5, 3, true>(a, batch, stream);
    case kGemv: return launch_wgmma<1, 32, WT, kTma, 8, 2, true>(a, batch, stream);
    case kHead: return launch_wgmma<1, 128, WT, kTma, 6, 1, true>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace gemm
}  // namespace repro

// dtype 0: float32, 1: bfloat16.  route: the plan's route (kernels/gemm.py
// ROUTES); a route this dtype or these operands cannot take is refused with
// cudaErrorInvalidValue.  Returns a cudaError_t value.
extern "C" int gemm_rowinv_launch(const void* x, const void* w, const void* bias, void* y,
                                  int M, int N, int K, long long lda, long long ldw,
                                  long long ldy, int batch, long long sx, long long sw,
                                  long long sb, long long sy, int wt, int dtype, int route,
                                  void* stream) {
  using namespace repro::gemm;
  if (M <= 0 || N <= 0 || K <= 0 || batch <= 0 || batch > 65535 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if ((M + 63) / 64 > 65535) return cudaErrorInvalidValue;
  // M-fastest tile order where the weight outgrows x and some of L2 (8 MB).
  const bool m_fast = N > M && (long long)K * N >= (4LL << 20);
  const Args a{x, w, bias, y, M, N, K, lda, ldw, ldy, sx, sw, sb, sy, 0, 0, batch, m_fast};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (route != kF32) return cudaErrorInvalidValue;
    const dim3 grid((N + kF32Tile - 1) / kF32Tile, (M + kF32Tile - 1) / kF32Tile, batch);
    if (wt)
      gemm_f32_kernel<true><<<grid, kF32Threads, 0, st>>>(a);
    else
      gemm_f32_kernel<false><<<grid, kF32Threads, 0, st>>>(a);
    return cudaGetLastError();
  }
  return wt ? route_bf16<true>(a, batch, route, st) : route_bf16<false>(a, batch, route, st);
}

// TMA maps encoded so far (each costs host time; a call whose operands'
// maps are cached encodes none).
extern "C" long long gemm_rowinv_maps_encoded() { return repro::gemm::maps_encoded; }

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
