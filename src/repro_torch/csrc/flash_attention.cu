// FlashAttention forward for sm_90a: prefill attention.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention -> _flash_fwd_impl, body _kernel).  q (B,Sq,H,hd), k/v
// (B,Sk,KV,hd); causal with q_offset (query i sits at position
// i + q_offset), sliding window, or bidirectional; GQA reads kv head
// h / n_rep; keys past Sk are masked (the reference's kv-length mask on
// its padded tail).  Online softmax over KV tiles in float32.  A prefix
// length P > 0 makes the causal mask a prefix-LM one (PaliGemma's prefill,
// which the JAX package computes in plain jnp, models/attention.py:108-125):
// rows inside the first P positions see all of them, so the causal limit
// of row p is max(p, P - 1) and the tile range of a block reaching the
// prefix runs to the prefix's last tile.
//
// Bound on the card, at the main path's shapes (qwen1.5-4b, 8 x 256, H 20,
// hd 128, causal): q, k, v and out are 41.9 MB, 0.0125 ms at 3.35 TB/s,
// against 2.7 GFLOP of products, 0.0027 ms at 989 TFLOP/s: bytes.  At
// recurrentgemma-2b's 2 x 2048 (hd 256, MQA) the products bind (0.043 ms).
//
// bfloat16, hd 64/112/128/256 (attend_rows_mma, attention_mma.cuh): the products
// run on the tensor cores (mma.sync m16n8k16) with K/V tiles brought in by
// cp.async two stages deep, so a tile's copy overlaps the previous tile's
// products, and the softmax state stays in registers.  A block owns 64 rows,
// 16 per warp.  Its rows are G heads of one kv group interleaved with the
// query positions (row i: position i / G, head hg * G + i % G of the group;
// G is the largest divisor of n_rep up to 16): the block stages each K/V
// tile once for all of its heads, and its causal/window tile range covers
// only its 64 / G positions.  Grid (B * KV * n_rep / G, ceil(Sq * G / 64)),
// the deepest row tiles first.  A stage whose keys all pass the mask for a
// warp's rows skips the per-key test.  On the TPU the KV axis was the
// innermost, sequential grid dimension carrying (m, l, acc) in VMEM; here a
// loop inside the block takes its place, bounded by the tile range the
// block's rows can reach.
//
// float32 (and bf16 at other head sizes or tiles that are not a multiple of
// 16 keys) keeps attend_rows (attention_tile.cuh): one block per (q tile of
// bq rows, batch * head), float FMAs from shared memory, held at 1e-4.
//
// Given an lse pointer (the autograd forward's launch; inference passes
// null) either body also writes each row's log-sum-exp, which the backward
// (flash_attention_bwd.cu) reads; the output's bits are the same either way.
#include "attention_mma.cuh"

namespace repro {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           float* __restrict__ lse, int Sq, int Sk, int H, int KV, int hd,
                           int bq, int bk, int causal, int window, int q_offset, int prefix,
                           float scale) {
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int g = h / (H / KV);
  const int q0 = blockIdx.x * bq;
  const int rows = min(bq, Sq - q0);
  const int first = q0 + q_offset;  // absolute positions of the tile's rows
  const int2 tr = tile_range(first, first + rows - 1, Sk, bk, causal, window, prefix);
  const RowMap rm{(((size_t)b * Sq + q0) * H + h) * hd, 1, (size_t)H * hd};
  const Mask mask{first, 1, causal, window, prefix};
  const ContigTiles tiles{((size_t)b * Sk * KV + g) * hd, (size_t)KV * hd, nullptr, Sk, bk};
  attend_rows<T, T>(q, out, rm, rows, k, v, tiles, tr.x, tr.y, bk, hd, scale, mask, lse);
}

template <int HD, int KW>
__global__ void __launch_bounds__(mma::kThreads)
    flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                               int Sq, int Sk, int H, int KV, int G, int bk, int sb, int causal,
                               int window, int q_offset, int prefix, float scale_log2) {
  const int n_rep = H / KV, groups = n_rep / G;
  const int bgh = blockIdx.x;  // (batch, kv head, head group)
  const int b = bgh / (KV * groups), rest = bgh - b * KV * groups;
  const int g = rest / groups, hg = rest - g * groups;
  // Row tiles from the last: under a causal mask the deepest rows reach the
  // most tiles, and they start first.
  const int r0 = (gridDim.y - 1 - blockIdx.y) * mma::kRows;
  const int rows = min(mma::kRows, Sq * G - r0);
  const int2 tr = tile_range(q_offset + r0 / G, q_offset + (r0 + rows - 1) / G, Sk, bk,
                             causal, window, prefix);
  const RowMap rm{((size_t)b * Sq * H + (size_t)g * n_rep + (size_t)hg * G) * HD, G,
                  (size_t)H * HD};
  const Mask mask{q_offset, G, causal, window, prefix};
  const ContigTiles tiles{((size_t)b * Sk * KV + g) * HD, (size_t)KV * HD, nullptr, Sk, bk};
  mma::attend_rows_mma<HD, KW>(q, out, mma::Partial{nullptr, nullptr, lse}, rm, r0, rows, k, v,
                               tiles, tr.x, tr.y, bk, sb, scale_log2, mask);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                   int Sq, int Sk, int H, int KV, int hd, int bq, int bk, int causal, int window,
                   int q_offset, int prefix, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(bq, hd, bk);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + bq - 1) / bq, B * H);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, Sq, Sk, H, KV, hd, bq, bk, causal, window, q_offset, prefix,
      scale);
  return cudaGetLastError();
}

template <int HD, int KW>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, float* lse,
                       int B, int Sq, int Sk, int H, int KV, int G, int bk, const mma::Plan& p,
                       int causal, int window, int q_offset, int prefix, float scale,
                       cudaStream_t stream) {
  const size_t smem = mma::smem_bytes(p, HD);
  auto kernel = flash_attention_mma_kernel<HD, KW>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * KV * (H / KV / G), (Sq * G + mma::kRows - 1) / mma::kRows);
  kernel<<<grid, mma::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, Sq, Sk, H,
      KV, G, bk, p.sb, causal, window, q_offset, prefix, scale * mma::kLog2e);
  return cudaGetLastError();
}

}  // namespace repro

// dtype codes: 0 = float32, 1 = bfloat16.  bfloat16 at hd 64/112/128/256 with bk
// a multiple of 16 runs the tensor-core body (bq is then the fixed 64 rows of
// a block); everything else runs attend_rows.  prefix: the prefix-LM length
// (0: none).  lse: null, or (B, Sq, H) float32 for each row's log-sum-exp of
// its scaled scores in base 2 (the autograd forward's, which
// flash_attention_bwd.cu reads).  Returns a cudaError_t value.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      float* lse, int B, int Sq, int Sk, int H, int KV, int hd,
                                      int bq, int bk, int causal, int window, int q_offset,
                                      int prefix, float scale, int dtype, void* stream) {
  using namespace repro;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || bq <= 0 ||
      bq > kMaxRows || bk <= 0 || bk > kMaxBlockK || prefix < 0)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const mma::Plan p = mma::plan(mma::kRows, bk, hd);
  if (dtype == 1 && p.sb > 0 && (hd == 64 || hd == 112 || hd == 128 || hd == 256)) {
    const int G = mma::heads_per_block(H / KV);
    if ((Sq * G + mma::kRows - 1) / mma::kRows > 65535 || mma::smem_bytes(p, hd) > kMaxSmem)
      return cudaErrorInvalidValue;
#define REPRO_FA_MMA(HD_, KW_)                                                              \
  if (hd == HD_ && p.kw == KW_)                                                             \
    return launch_mma<HD_, KW_>(q, k, v, out, lse, B, Sq, Sk, H, KV, G, bk, p, causal,     \
                                window, q_offset, prefix, scale, st);
    REPRO_FA_MMA(64, 16) REPRO_FA_MMA(64, 32) REPRO_FA_MMA(64, 64)
    REPRO_FA_MMA(112, 16) REPRO_FA_MMA(112, 32) REPRO_FA_MMA(112, 64)
    REPRO_FA_MMA(128, 16) REPRO_FA_MMA(128, 32) REPRO_FA_MMA(128, 64)
    REPRO_FA_MMA(256, 16) REPRO_FA_MMA(256, 32)
#undef REPRO_FA_MMA
    return cudaErrorInvalidValue;
  }
  if ((long long)B * H > 65535 || smem_bytes(bq, hd, bk) > kMaxSmem)
    return cudaErrorInvalidValue;
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, lse, B, Sq, Sk, H, KV, hd, bq, bk, causal,
                                 window, q_offset, prefix, scale, st);
  if (dtype == 0)
    return launch<float>(q, k, v, out, lse, B, Sq, Sk, H, KV, hd, bq, bk, causal, window,
                         q_offset, prefix, scale, st);
  return cudaErrorInvalidValue;
}
