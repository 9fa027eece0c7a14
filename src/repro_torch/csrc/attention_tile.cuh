// Block-level online-softmax attention shared by the three attention kernels
// (flash_attention.cu, flash_decode.cu, flash_decode_paged.cu): the masks,
// row maps and tile addresses (Mask, RowMap, TileRef, ContigTiles,
// PagedTiles) of both tile bodies, and attend_rows, the float FMA body of
// the float32 routes (and of bfloat16 at shapes the tensor-core body of
// attention_mma.cuh does not take).
//
// One thread block owns `rows` query rows that all read the same K/V head.
// It walks KV tiles [t_lo, t_hi) of `bk` keys; for each tile it
//   1. loads K (16-byte loads, cast to the query dtype, held as float) and
//      the keys' recorded positions into shared memory,
//   2. scores every (row, key) pair with float FMAs and masks it
//      (score_tile),
//   3. updates the running max / sum of each row (one warp per row) while
//      V replaces K in the same buffer,
//   4. accumulates p @ V into a float accumulator in shared memory
//      (pv_tile).
// Masked keys get p = 0 explicitly, so a row with no valid key ends with
// l = 0 and is written as exact zeros (divide by max(l, 1e-30)).  p is
// rounded to the value dtype before the PV product, as in the reference.
//
// The row order of every reduction depends on the block's own rows and
// tiles only: a slot's output never depends on the batch around it.
// Float32 stays on float FMAs: TF32 tensor-core products would not meet
// the float32 routes' 1e-4 check.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace repro {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 64;
constexpr int kMaxBlockK = 128;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block can opt into on sm_90
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as the reference's casts
}

// x rounded to T's precision and held as float.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Dynamic shared memory of attend_rows, in bytes.  The Python wrappers
// compute the same sum to reject shapes before a launch.
inline size_t smem_bytes(int rows, int hd, int bk) {
  return sizeof(float) * (2 * (size_t)rows * hd + (size_t)bk * (hd + 1) +
                          (size_t)rows * bk + 3 * (size_t)rows) +
         sizeof(int) * (size_t)bk;
}

// Where the keys of one KV tile live: element d of the block's head of key
// j lives at base + j * stride + d, for j < n; its recorded position is
// kp[j], or pos0 + j when kp is null.  Keys j >= n read as empty: value 0,
// position -1.
struct TileRef {
  size_t base;
  size_t stride;
  int n;
  const int* kp;
  int pos0;
};

// Tile t of one head of a contiguous timeline of S keys (key s at
// base + s * stride), in tiles of bk keys.  kpos (S) or null (key s sits at
// position s).
struct ContigTiles {
  size_t base;
  size_t stride;
  const int* kpos;
  int S;
  int bk;
  __device__ __forceinline__ TileRef operator()(int t) const {
    const int s0 = t * bk;
    return TileRef{base + (size_t)s0 * stride, stride, min(bk, S - s0),
                   kpos ? kpos + s0 : nullptr, s0};
  }
};

// Tile t of one slot in a pool of blocks of bl keys: the block table maps
// logical tile t to physical block table[t], whose key j of this head lives
// at block * blk_stride + head_off + j * tok_stride and whose recorded
// positions are kpos[block * kpos_blk_stride + j].  The strides let the
// kernel read one layer's view of a layer-stacked pool in place.
struct PagedTiles {
  const int* table;
  size_t blk_stride;
  size_t head_off;
  size_t tok_stride;
  const int* kpos;
  size_t kpos_blk_stride;
  int bl;
  __device__ __forceinline__ TileRef operator()(int t) const {
    const size_t blk = (size_t)table[t];
    return TileRef{blk * blk_stride + head_off, tok_stride, bl, kpos + blk * kpos_blk_stride,
                   0};
  }
};

// The keys of tile r of a K or V head into tile (row j at tile + j * ldt),
// cast to TQ and held as float; keys j >= r.n read as 0.  Each thread keeps
// kLoadsInFlight 16-byte loads in flight before it converts and stores them:
// the loads' latency, not their bytes, bounds a simple tile copy.  Needs
// hd a multiple of 16 / sizeof(T) and 16-byte aligned rows (the wrappers
// check both).
constexpr int kLoadsInFlight = 4;

template <typename TQ, typename T>
__device__ __forceinline__ void load_tile(float* tile, int ldt, const T* __restrict__ src,
                                          const TileRef& r, int bk, int hd) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte load
  const int vpr = hd / V;            // loads per key
  const int n = bk * vpr;
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kLoadsInFlight) {
    uint4 buf[kLoadsInFlight];
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const int i = i0 + u * kThreads;
      const int j = i / vpr, c = i - j * vpr;
      buf[u] = (i < n && j < r.n)
                   ? *reinterpret_cast<const uint4*>(src + r.base + (size_t)j * r.stride + c * V)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) {
        const int j = i / vpr, c = i - j * vpr;
        const T* e = reinterpret_cast<const T*>(&buf[u]);
#pragma unroll
        for (int t = 0; t < V; ++t) tile[j * ldt + c * V + t] = round_to<TQ>(to_float(e[t]));
      }
    }
  }
}

// Row r of a block is query (r / div) at head offset (r % div): its element d
// lives at base + (r / div) * stride + (r % div) * hd + d.
struct RowMap {
  size_t base;
  int div;
  size_t stride;
};

// Row r sits at absolute position base + r / div.  A key recorded at kp is
// valid for it iff 0 <= kp, kp <= position (when causal) and
// kp > position - window (when window > 0).  A prefix-LM mask (prefix > 0,
// PaliGemma's prefill) also lets a row inside the prefix see every key of
// the prefix, whatever the causal and window limits: the causal limit of
// row p is max(p, prefix - 1).
struct Mask {
  int base;
  int div;
  int causal;
  int window;
  int prefix = 0;
  // A key at kp for a row at position rp.
  __device__ __forceinline__ bool at(int rp, int kp) const {
    const bool pre = rp < prefix && kp < prefix;
    return kp >= 0 && (!causal || kp <= rp || pre) && (window <= 0 || kp > rp - window || pre);
  }
  __device__ __forceinline__ bool operator()(int r, int kp) const { return at(base + r / div, kp); }
};

// Tiles [lo, hi) of bk keys that rows at positions first..last can reach
// (rows inside a prefix of P positions reach all of it): the prefill
// kernel's tile range (flash_attention.cu) and its backward's
// (flash_attention_bwd.cu).
__device__ __forceinline__ int2 tile_range(int first, int last, int Sk, int bk, int causal,
                                           int window, int prefix) {
  const int kv_end = causal ? min(Sk, max(last, prefix - 1) + 1) : Sk;
  const int kv_begin = window > 0 && first >= prefix ? max(0, first - window + 1) : 0;
  const int lo = kv_begin / bk;
  return make_int2(lo, kv_end > kv_begin ? (kv_end + bk - 1) / bk : lo);
}

// Its inverse: the row tiles [lo, hi) of bq rows (row r at position
// q_offset + r / div, n_rows rows) whose tile_range reaches key tile t.  A
// tile's range [x, y) has x growing with the tile, and is empty exactly
// when its window starts at or past Sk (then every later tile's is too), so
// the tiles with x <= t and a range are a prefix [0, hi); within it y grows,
// and lo is the first whose y passes t.  Two binary searches, the same in
// kernels/flash_attention.py (_inverse_tile_range).
__device__ __forceinline__ int2 inverse_tile_range(int t, int n_rows, int div, int bq,
                                                   int q_offset, int Sk, int bk, int causal,
                                                   int window, int prefix) {
  auto range = [&](int i) {
    const int r0 = i * bq;
    return tile_range(q_offset + r0 / div, q_offset + (min(r0 + bq, n_rows) - 1) / div, Sk, bk,
                      causal, window, prefix);
  };
  int lo = 0, hi = (n_rows + bq - 1) / bq;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    const int2 r = range(mid);
    if (r.x <= t && r.x < r.y)
      lo = mid + 1;
    else
      hi = mid;
  }
  const int end = lo;
  lo = 0;
  hi = end;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (range(mid).y > t)
      hi = mid;
    else
      lo = mid + 1;
  }
  return make_int2(lo, end);
}

// Rows per thread in the score and PV loops: each shared-memory read of K
// or V feeds RB independent FMA chains (the q and p reads are warp
// broadcasts).  Blocks with fewer rows than kRowBlock use RB = 1.  Every
// output keeps the order of its own sum, so RB does not change results.
constexpr int kRowBlock = 4;

// sc[r][j] = q_r . k_j * scale, or kNegInf where the mask rejects key j.
template <int RB, typename M>
__device__ __forceinline__ void score_tile(float* sc, const float* qs, const float* tile,
                                           int ldt, const int* kp_s, int rows, int bk,
                                           int hd, float scale, M mask) {
  const int groups = (rows + RB - 1) / RB;
  for (int i = threadIdx.x; i < groups * bk; i += kThreads) {
    const int r0 = (i / bk) * RB, j = i % bk;
    const float* kr = tile + j * ldt;
    const float* qr[RB];
    float dot[RB];
#pragma unroll
    for (int u = 0; u < RB; ++u) {
      qr[u] = qs + min(r0 + u, rows - 1) * hd;
      dot[u] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int u = 0; u < RB; ++u) dot[u] = fmaf(qr[u][d], kd, dot[u]);
    }
    const int kp = kp_s[j];
#pragma unroll
    for (int u = 0; u < RB; ++u)
      if (r0 + u < rows) sc[(r0 + u) * bk + j] = mask(r0 + u, kp) ? dot[u] * scale : kNegInf;
  }
}

// acc[r][d] = acc[r][d] * alpha[r] + sum_j p[r][j] * v[j][d].
template <int RB>
__device__ __forceinline__ void pv_tile(float* acc, const float* sc, const float* tile, int ldt,
                                        const float* a_s, int rows, int bk, int hd) {
  const int groups = (rows + RB - 1) / RB;
  for (int i = threadIdx.x; i < groups * hd; i += kThreads) {
    const int r0 = (i / hd) * RB, d = i % hd;
    const float* pr[RB];
    float pv[RB];
#pragma unroll
    for (int u = 0; u < RB; ++u) {
      pr[u] = sc + min(r0 + u, rows - 1) * bk;
      pv[u] = 0.f;
    }
#pragma unroll 4
    for (int j = 0; j < bk; ++j) {
      const float vd = tile[j * ldt + d];
#pragma unroll
      for (int u = 0; u < RB; ++u) pv[u] = fmaf(pr[u][j], vd, pv[u]);
    }
#pragma unroll
    for (int u = 0; u < RB; ++u)
      if (r0 + u < rows) acc[(r0 + u) * hd + d] = acc[(r0 + u) * hd + d] * a_s[r0 + u] + pv[u];
  }
}

// Tiles maps a tile index to the TileRef of its keys (ContigTiles for a
// contiguous timeline, PagedTiles for a block pool): one tile body serves
// every attention kernel, so a paged tile gives the same bits as the same
// keys in a contiguous tile.  With lse (the prefill's autograd forward) each
// row's log-sum-exp of its scaled scores in base 2, m log2(e) + log2 l, goes
// to lse[row's offset / hd] beside its output, which it does not change.
template <typename TQ, typename TKV, typename Tiles>
__device__ void attend_rows(const TQ* __restrict__ q, TQ* __restrict__ out, RowMap rm,
                            int rows, const TKV* __restrict__ k,
                            const TKV* __restrict__ v, Tiles tiles, int t_lo, int t_hi,
                            int bk, int hd, float scale, Mask mask,
                            float* __restrict__ lse = nullptr) {
  extern __shared__ float smem[];
  float* qs = smem;                 // rows x hd
  float* acc = qs + rows * hd;      // rows x hd
  float* tile = acc + rows * hd;    // bk x (hd + 1): K, then V
  float* sc = tile + bk * (hd + 1); // rows x bk: scores, then p
  float* m_s = sc + rows * bk;      // rows
  float* l_s = m_s + rows;          // rows
  float* a_s = l_s + rows;          // rows
  int* kp_s = reinterpret_cast<int*>(a_s + rows);  // bk
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ldt = hd + 1;  // padded K rows: score_tile reads them conflict-free

  for (int i = tid; i < rows * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    qs[i] = to_float(q[rm.base + (size_t)(r / rm.div) * rm.stride + (size_t)(r % rm.div) * hd + d]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  for (int t = t_lo; t < t_hi; ++t) {
    const TileRef ref = tiles(t);
    load_tile<TQ>(tile, ldt, k, ref, bk, hd);
    for (int j = tid; j < bk; j += kThreads)
      kp_s[j] = j < ref.n ? (ref.kp ? ref.kp[j] : ref.pos0 + j) : -1;
    __syncthreads();

    if (rows >= kRowBlock)
      score_tile<kRowBlock>(sc, qs, tile, ldt, kp_s, rows, bk, hd, scale, mask);
    else
      score_tile<1>(sc, qs, tile, ldt, kp_s, rows, bk, hd, scale, mask);
    __syncthreads();

    for (int r = warp; r < rows; r += kWarps) {
      float* sr = sc + r * bk;
      float mx = kNegInf;
      for (int j = lane; j < bk; j += 32) mx = fmaxf(mx, sr[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < bk; j += 32) {
        const float p = mask(r, kp_s[j]) ? expf(sr[j] - m_new) : 0.f;
        sum += p;
        sr[j] = round_to<TQ>(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    load_tile<TQ>(tile, ldt, v, ref, bk, hd);
    __syncthreads();

    if (rows >= kRowBlock)
      pv_tile<kRowBlock>(acc, sc, tile, ldt, a_s, rows, bk, hd);
    else
      pv_tile<1>(acc, sc, tile, ldt, a_s, rows, bk, hd);
    __syncthreads();
  }

  for (int i = tid; i < rows * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    out[rm.base + (size_t)(r / rm.div) * rm.stride + (size_t)(r % rm.div) * hd + d] =
        from_float<TQ>(acc[i] / fmaxf(l_s[r], 1e-30f));
  }
  if (lse)
    for (int r = tid; r < rows; r += kThreads)
      lse[(rm.base + (size_t)(r / rm.div) * rm.stride + (size_t)(r % rm.div) * hd) / hd] =
          m_s[r] * 1.4426950408889634f + log2f(fmaxf(l_s[r], 1e-30f));
}

}  // namespace repro

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
