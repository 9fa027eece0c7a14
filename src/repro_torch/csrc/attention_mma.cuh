// Tensor-core tile body of the bfloat16 attention kernels (flash_attention.cu,
// flash_decode.cu, flash_decode_paged.cu), FlashAttention-2 style, for sm_90a.
//
// A block of kWarps warps owns up to 64 query rows that all read one K/V head.
// It walks KV tiles [t_lo, t_hi) of `bk` keys in stages of `sb` keys
// (sb divides bk).  Each stage's K, V (bf16, rows padded by kPad elements so
// ldmatrix reads them without bank conflicts) and key positions arrive by
// cp.async in a ring of two stages: stage i + 1 is in flight while stage i
// is computed, and each stage costs two block barriers.  Warp w owns row
// group w / ks (16 rows) and key part w % ks (kw = sb / ks keys of each
// stage):
//   S = Q K^T    mma.sync m16n8k16 bf16 -> f32, Q and K by ldmatrix;
//   mask, online softmax in registers (base-2 exponentials, the scale folded
//                into log2(e) * scale); masked keys get p = 0 explicitly;
//   O += P V     p rounded to bf16 as the A fragment (as in the reference),
//                V by ldmatrix.trans, O in f32 registers.
// With ks > 1 the key parts of a row group are merged after the last stage,
// in shared memory, in ascending part order.  A block writes its rows
// normalised (O / max(l, 1e-30): a row with no valid key is exact zeros), or
// its partial (m, l, O) for combine_chunks_kernel, which merges a slot's key
// chunks in ascending order.
//
// Every order of summation here is fixed by the plan (ks, sb) and the block's
// own tile range: a row's result does not depend on the batch around it nor
// on the other rows of its block (the decode launches take ks from one query
// token's rows, so a verify row is bitwise its one-row launch), and
// a paged tile (PagedTiles) gives the same bits as the same keys in a
// contiguous tile (ContigTiles).
//
// The float32 routes keep attend_rows (attention_tile.cuh): TF32 products
// would not meet their 1e-4 check.
#pragma once

#include <stdint.h>
#include <type_traits>

#include "attention_tile.cuh"

namespace repro {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows of one block
constexpr int kPad = 8;             // bf16 padding of a staged row (16 bytes)
constexpr int kChunkKeys = 256;     // keys of one decode chunk (with bk: chunk_tiles)
constexpr float kLog2e = 1.4426950408889634f;

// How a block of `rows` rows (in row groups of 16) splits a tile of `bk`
// keys: ks key parts, stages of sb keys, kw = sb / ks keys per warp and stage.
// sb is the largest of 64, 32, 16 that divides bk with kw within the
// registers' reach (kw <= 32 at hd > 128).  sb == 0: bk is not a multiple of
// 16 and the tile body cannot take it.  kernels/_build.py mirrors this.
struct Plan {
  int ks, sb, kw;
};

__host__ __device__ inline Plan plan(int rows, int bk, int hd) {
  const int rg = (rows + 15) / 16;
  const int rgp = rg <= 1 ? 1 : rg <= 2 ? 2 : 4;
  const int kw_max = hd > 128 ? 32 : 64;
  for (int sb = 64; sb >= 16; sb /= 2) {
    if (bk % sb) continue;
    const int ks = kWarps / rgp < sb / 16 ? kWarps / rgp : sb / 16;
    if (sb / ks <= kw_max) return Plan{ks, sb, sb / ks};
  }
  return Plan{0, 0, 0};
}

// Heads of one kv group that share a block of the prefill's bf16 route (and
// of its backward's dq pass): the largest divisor of n_rep up to 16.
inline int heads_per_block(int n_rep) {
  int G = 1;
  for (int d = 1; d <= n_rep && d <= 16; ++d)
    if (n_rep % d == 0) G = d;
  return G;
}

__host__ __device__ inline size_t q_bytes(const Plan& p, int hd) {
  return (size_t)(kRows / p.ks) * (hd + kPad) * sizeof(bf16);
}

// The stage ring, or (ks > 1) the key parts' merge buffer, which reuses it.
__host__ __device__ inline size_t ring_bytes(const Plan& p, int hd) {
  const size_t ring = 4 * (size_t)p.sb * (hd + kPad) * sizeof(bf16);
  const size_t merge = p.ks > 1 ? (size_t)kWarps * 16 * (hd + 2) * sizeof(float) : 0;
  return ring > merge ? ring : merge;
}

__host__ __device__ inline size_t smem_bytes(const Plan& p, int hd) {
  return q_bytes(p, hd) + ring_bytes(p, hd) + 2 * (size_t)p.sb * sizeof(int) +
         2 * sizeof(int2);
}

// Keys of one decode chunk, in tiles: set by bk and kChunkKeys alone.
__host__ __device__ inline int chunk_tiles(int bk) {
  return bk >= kChunkKeys ? 1 : kChunkKeys / bk;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even), the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage keys [u * sb, u * sb + sb) of tile r into ks_/vs_ (rows of ld
// elements) and their positions into kps; keys j >= r.n read as zeros at
// position -1.  *span is the stage's first and last position when they are
// pos0 + j for every key (no recorded positions, no ragged end), else an
// empty span (1, 0).  bf16 storage goes by cp.async; float32 storage is
// rounded to bf16 on the way (register loads, as load_tile rounds it), four
// 16-byte loads in flight per thread.
template <int HD, typename TKV>
__device__ __forceinline__ void stage_keys(bf16* ks_, bf16* vs_, int* kps, int2* span,
                                           const TKV* __restrict__ k,
                                           const TKV* __restrict__ v, const TileRef& r, int u,
                                           int sb) {
  constexpr int C = HD / 8;  // 8-element (16-byte bf16) chunks per key
  constexpr int LD = HD + kPad;
  const int j0 = u * sb;
  for (int i = threadIdx.x; i < sb * C; i += kThreads) {
    const int jj = i / C, c = i - jj * C;
    const int j = j0 + jj;
    const bool ok = j < r.n;
    const size_t off = r.base + (size_t)(ok ? j : 0) * r.stride + (size_t)c * 8;
    if constexpr (std::is_same<TKV, bf16>::value) {
      cp_async16(ks_ + jj * LD + c * 8, k + off, ok);
      cp_async16(vs_ + jj * LD + c * 8, v + off, ok);
    } else {
      float4 f[4] = {};
      if (ok) {
        const float4* kp4 = reinterpret_cast<const float4*>(k + off);
        const float4* vp4 = reinterpret_cast<const float4*>(v + off);
        f[0] = kp4[0];
        f[1] = kp4[1];
        f[2] = vp4[0];
        f[3] = vp4[1];
      }
      const uint4 kb = make_uint4(pack_bf16(f[0].x, f[0].y), pack_bf16(f[0].z, f[0].w),
                                  pack_bf16(f[1].x, f[1].y), pack_bf16(f[1].z, f[1].w));
      const uint4 vb = make_uint4(pack_bf16(f[2].x, f[2].y), pack_bf16(f[2].z, f[2].w),
                                  pack_bf16(f[3].x, f[3].y), pack_bf16(f[3].z, f[3].w));
      *reinterpret_cast<uint4*>(ks_ + jj * LD + c * 8) = kb;
      *reinterpret_cast<uint4*>(vs_ + jj * LD + c * 8) = vb;
    }
  }
  if (threadIdx.x == 0)
    *span = !r.kp && j0 + sb <= r.n ? make_int2(r.pos0 + j0, r.pos0 + j0 + sb - 1)
                                    : make_int2(1, 0);
  for (int jj = threadIdx.x; jj < sb; jj += kThreads) {
    const int j = j0 + jj;
    if (j < r.n && r.kp)
      cp_async4(kps + jj, r.kp + j);
    else
      kps[jj] = j < r.n ? r.pos0 + j : -1;
  }
}

// needed_tiles of one slot (kernels/flash_decode.py), by the whole block:
// 1 + the last tile of bk keys holding a key that one of the sq rows can
// see, 0 <= kp <= pos + sq - 1 (and kp > pos - window when window > 0); at
// least 1.  key_pos(s) is the recorded position of key s < n_keys.  Every
// block of a slot computes the same count, with no host sync.
template <typename KeyPos>
__device__ int block_needed_tiles(KeyPos key_pos, int n_keys, int bk, int pos, int sq,
                                  int window) {
  __shared__ int last;
  if (threadIdx.x == 0) last = -1;
  __syncthreads();
  int mine = -1;
  for (int s = threadIdx.x; s < n_keys; s += kThreads) {
    const int kp = key_pos(s);
    if (kp >= 0 && kp <= pos + sq - 1 && (window <= 0 || kp > pos - window)) mine = s;
  }
  if (mine >= 0) atomicMax(&last, mine);
  __syncthreads();
  return last < 0 ? 1 : last / bk + 1;
}

// Recorded positions of a contiguous slot, and of a paged slot through its
// table row (key s in table entry s / bl).
struct ContigKeyPos {
  const int* kpos;
  __device__ __forceinline__ int operator()(int s) const { return kpos[s]; }
};

struct PagedKeyPos {
  const int* table;
  const int* kpos;
  size_t kpos_blk_stride;
  int bl;
  __device__ __forceinline__ int operator()(int s) const {
    return kpos[(size_t)table[s / bl] * kpos_blk_stride + s % bl];
  }
};

// Where a block's rows go: normalised into `out` through the RowMap (acc ==
// nullptr), or as one chunk's partial: acc (rows x hd) and ml (rows x 2:
// the running max in base-2 units and the sum l).  With normalised rows, lse
// (the prefill's autograd forward; null on every inference launch) also
// takes each row's log-sum-exp of its scaled scores in base 2, m + log2 l, at
// lse[row's offset / hd]; the output's bits do not depend on it.
struct Partial {
  float* acc;
  float* ml;
  float* lse = nullptr;
};

template <int HD>
__device__ __forceinline__ void emit2(bf16* __restrict__ out, const Partial& part,
                                      const RowMap& rm, int r0, int r, int d, float a0,
                                      float a1, float m, float l) {
  if (part.acc) {
    *reinterpret_cast<float2*>(part.acc + (size_t)r * HD + d) = make_float2(a0, a1);
    if (d == 0) *reinterpret_cast<float2*>(part.ml + (size_t)r * 2) = make_float2(m, l);
  } else {
    const int gr = r0 + r;
    const float inv = fmaxf(l, 1e-30f);
    const size_t row = rm.base + (size_t)(gr / rm.div) * rm.stride + (size_t)(gr % rm.div) * HD;
    *reinterpret_cast<uint32_t*>(out + row + d) = pack_bf16(a0 / inv, a1 / inv);
    if (part.lse && d == 0) part.lse[row / HD] = m + log2f(inv);
  }
}

// Rows r0 .. r0 + rows - 1 of the RowMap (rows <= kRows) against KV tiles
// [t_lo, t_hi) of bk keys, staged sb keys at a time, in ks = sb / KW key parts
// (rows <= kRows / ks).
// Row r's position is mask.base + (r0 + r) / mask.div.
template <int HD, int KW, typename TKV, typename Tiles>
__device__ void attend_rows_mma(const bf16* __restrict__ q, bf16* __restrict__ out,
                                Partial part, RowMap rm, int r0, int rows,
                                const TKV* __restrict__ k, const TKV* __restrict__ v,
                                Tiles tiles, int t_lo, int t_hi, int bk, int sb,
                                float scale_log2, Mask mask) {
  constexpr int LD = HD + kPad;
  constexpr int NT = HD / 8;  // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ks = sb / KW;
  const int qrows = kRows / ks;
  const Plan pl{ks, sb, KW};
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + q_bytes(pl, HD));
  int* kps = reinterpret_cast<int*>(smem_raw + q_bytes(pl, HD) + ring_bytes(pl, HD));
  int2* spans = reinterpret_cast<int2*>(kps + 2 * sb);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < qrows * (HD / 8); i += kThreads) {
    const int r = i / (HD / 8), c = i - r * (HD / 8);
    const int gr = r0 + r;
    const bool ok = r < rows;
    const size_t off = ok ? rm.base + (size_t)(gr / rm.div) * rm.stride +
                                (size_t)(gr % rm.div) * HD + (size_t)c * 8
                          : 0;
    cp_async16(qs + r * LD + c * 8, q + off, ok);
  }
  const int per_tile = bk / sb;
  const int n = (t_hi - t_lo) * per_tile;  // stages
  if (n > 0)
    stage_keys<HD>(ring, ring + sb * LD, kps, spans, k, v, tiles(t_lo), 0, sb);
  cp_commit();

  const int rg = warp / ks, part_k = warp - rg * ks;
  const bool active = rg * 16 < rows;
  const int key0 = part_k * KW;
  const int g = lane >> 2, tq = lane & 3;
  const int ra = rg * 16 + g;  // this thread's rows: ra and ra + 8
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < n; ++i) {
    const int buf = i & 1;
    if (i + 1 < n) {
      const int nb = buf ^ 1;
      const int t = t_lo + (i + 1) / per_tile, u = (i + 1) % per_tile;
      stage_keys<HD>(ring + nb * 2 * sb * LD, ring + (nb * 2 + 1) * sb * LD, kps + nb * sb,
                     spans + nb, k, v, tiles(t), u, sb);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if (active) {
      const bf16* kt = ring + buf * 2 * sb * LD;
      const bf16* vt = kt + sb * LD;
      const int* kp = kps + buf * sb;
      float s[KW / 8][4];
#pragma unroll
      for (int j = 0; j < KW / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const bf16* qw = qs + rg * 16 * LD;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, qw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < KW / 16; ++np) {
          uint32_t b[4];
          ldsm_x4(b, kt + (key0 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                         ((lane >> 3) & 1) * 8);
          mma16816(s[2 * np], a, b[0], b[1]);
          mma16816(s[2 * np + 1], a, b[2], b[3]);
        }
      }
      // A stage whose keys all pass the mask for all 16 rows of the warp
      // (the causal prefill's tiles below the diagonal) skips the per-key test.
      const int2 sp = spans[buf];
      const int p_lo = mask.base + (r0 + rg * 16) / mask.div;
      const int p_hi = mask.base + (r0 + rg * 16 + 15) / mask.div;
      const bool dense = sp.x <= sp.y && sp.x >= 0 && (!mask.causal || sp.y <= p_lo) &&
                         (mask.window <= 0 || sp.x > p_hi - mask.window);
      if (dense) {
#pragma unroll
        for (int j = 0; j < KW / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
      } else {
#pragma unroll
        for (int j = 0; j < KW / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpv = kp[key0 + j * 8 + 2 * tq + (e & 1)];
            s[j][e] = mask(r0 + ra + (e >> 1) * 8, kpv) ? s[j][e] * scale_log2 : kNegInf;
          }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < KW / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int o2 = 1; o2 <= 2; o2 <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
      }
      const float al0 = exp2f(m0 - mx0), al1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < KW / 8; ++j) {
        // Masked keys: p = 0 explicitly (an all-masked row has m == kNegInf).
        s[j][0] = s[j][0] == kNegInf ? 0.f : exp2f(s[j][0] - m0);
        s[j][1] = s[j][1] == kNegInf ? 0.f : exp2f(s[j][1] - m0);
        s[j][2] = s[j][2] == kNegInf ? 0.f : exp2f(s[j][2] - m1);
        s[j][3] = s[j][3] == kNegInf ? 0.f : exp2f(s[j][3] - m1);
        sum0 += s[j][0] + s[j][1];
        sum1 += s[j][2] + s[j][3];
      }
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        o[j][0] *= al0;
        o[j][1] *= al0;
        o[j][2] *= al1;
        o[j][3] *= al1;
      }
#pragma unroll
      for (int kc = 0; kc < KW / 16; ++kc) {
        const uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                               pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                               pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                               pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t b[4];
          ldsm_x4_t(b, vt + (key0 + kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                           dp * 16 + (lane >> 4) * 8);
          mma16816(o[2 * dp], a, b[0], b[1]);
          mma16816(o[2 * dp + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }
  cp_wait<0>();

#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
  }
  if (ks == 1) {
    if (!active) return;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int d = j * 8 + 2 * tq;
      if (ra < rows) emit2<HD>(out, part, rm, r0, ra, d, o[j][0], o[j][1], m0, l0);
      if (ra + 8 < rows) emit2<HD>(out, part, rm, r0, ra + 8, d, o[j][2], o[j][3], m1, l1);
    }
    return;
  }
  // Merge the ks key parts of each row group, in ascending part order.  The
  // ring is free: every warp passed the last stage's barrier.
  float* cacc = reinterpret_cast<float*>(ring);  // [warp][16][HD]
  float* cml = cacc + kWarps * 16 * HD;          // [warp][16][2]
  if (active) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int d = j * 8 + 2 * tq;
      *reinterpret_cast<float2*>(cacc + (warp * 16 + g) * HD + d) = make_float2(o[j][0], o[j][1]);
      *reinterpret_cast<float2*>(cacc + (warp * 16 + g + 8) * HD + d) =
          make_float2(o[j][2], o[j][3]);
    }
    if (tq == 0) {
      *reinterpret_cast<float2*>(cml + (warp * 16 + g) * 2) = make_float2(m0, l0);
      *reinterpret_cast<float2*>(cml + (warp * 16 + g + 8) * 2) = make_float2(m1, l1);
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * (HD / 2); i += kThreads) {
    const int r = i / (HD / 2), d = 2 * (i - r * (HD / 2));
    const int w0 = (r / 16) * ks, rr = r % 16;
    float mm = kNegInf;
    for (int p = 0; p < ks; ++p) mm = fmaxf(mm, cml[((w0 + p) * 16 + rr) * 2]);
    float wt = exp2f(cml[(w0 * 16 + rr) * 2] - mm);
    float ll = cml[(w0 * 16 + rr) * 2 + 1] * wt;
    float a0 = cacc[(w0 * 16 + rr) * HD + d] * wt, a1 = cacc[(w0 * 16 + rr) * HD + d + 1] * wt;
    for (int p = 1; p < ks; ++p) {
      const int w = (w0 + p) * 16 + rr;
      wt = exp2f(cml[w * 2] - mm);
      ll += cml[w * 2 + 1] * wt;
      a0 += cacc[w * HD + d] * wt;
      a1 += cacc[w * HD + d + 1] * wt;
    }
    emit2<HD>(out, part, rm, r0, r, d, a0, a1, mm, ll);
  }
}

// Merge each slot's key chunks into its output rows: chunk c of slot b and kv
// head g holds the partial (m, l, acc) of rows r < rows at
// ((b * KV + g) * chunks + c) * rows + r, and chunk 0 wrote the slot's
// needed tiles to nt[b * KV + g].  The slot's chunks are the first
// ceil(nt / chunk_tiles) and are merged in ascending order, so the result
// depends on the slot alone.  A single chunk gives the bits a block writes
// directly (weight exp2(0) == 1).  Grid (KV, B, ceil(rows * hd / kThreads)),
// one output element a thread.
__global__ void __launch_bounds__(kThreads)
    combine_chunks_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                          const int* __restrict__ nt, bf16* __restrict__ out, int sq, int H,
                          int KV, int hd, int chunk_tiles, int chunks) {
  const int g = blockIdx.x, b = blockIdx.y;
  const int n_rep = H / KV, rows = sq * n_rep;
  const int i = blockIdx.z * kThreads + threadIdx.x;
  if (i >= rows * hd) return;
  const int nc = (nt[b * KV + g] + chunk_tiles - 1) / chunk_tiles;
  const size_t c0 = ((size_t)b * KV + g) * chunks;
  const RowMap rm{((size_t)b * sq * H + (size_t)g * n_rep) * hd, n_rep, (size_t)H * hd};
  {
    const int r = i / hd, d = i - r * hd;
    float mm = kNegInf;
    for (int c = 0; c < nc; ++c) mm = fmaxf(mm, part_ml[((c0 + c) * rows + r) * 2]);
    float wt = exp2f(part_ml[(c0 * rows + r) * 2] - mm);
    float ll = part_ml[(c0 * rows + r) * 2 + 1] * wt;
    float a = part_acc[(c0 * rows + r) * hd + d] * wt;
    for (int c = 1; c < nc; ++c) {
      const size_t w = (c0 + c) * rows + r;
      wt = exp2f(part_ml[w * 2] - mm);
      ll += part_ml[w * 2 + 1] * wt;
      a += part_acc[w * hd + d] * wt;
    }
    out[rm.base + (size_t)(r / n_rep) * rm.stride + (size_t)(r % n_rep) * hd + d] =
        __float2bfloat16(a / fmaxf(ll, 1e-30f));
  }
}

}  // namespace mma
}  // namespace repro
