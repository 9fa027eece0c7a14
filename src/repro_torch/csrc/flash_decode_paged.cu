// Ragged batched decode attention over a paged KV block pool, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py
// (flash_decode_paged, body _paged_kernel).  The cache is a pool of N
// physical blocks of bl keys: k/v (N, bl, KV, hd) and kpos (N, bl), read
// through their physical-block strides, so one layer's view of a
// layer-stacked pool (N, layers, bl, KV, hd) is read in place, never copied.
// tables (B, nmax) maps logical tile t of slot b to physical block
// tables[b, t].  Row j of slot b attends keys with 0 <= kpos <= pos[b] + j
// (and kpos > pos[b] + j - window for a rolling cache), as flash_decode.
//
// Bound on the card: bytes, as flash_decode (each needed K/V block read
// once, ~2 * rows FLOPs per value read): 23.6 MB, 0.0071 ms at 3.35 TB/s at
// the served path's last step (B 8, 18 blocks of 16 keys, KV 20, hd 128).
//
// Layout: flash_decode's, with PagedTiles as the tile address.  On the TPU
// the block table was a scalar-prefetch operand of the index maps; here a
// block reads its own table row, one entry per tile, when it issues that
// tile's copy (one stage ahead of the products).  bfloat16 queries run
// flash_decode's tensor-core body and key chunks (chunk_tiles(bl) tiles a
// chunk, grid (KV, B, chunks), combine_chunks_kernel when chunks > 1); each
// block counts its slot's needed tiles through the table row
// (block_needed_tiles with PagedKeyPos), and a multi-row launch takes
// flash_decode's row blocks, with the key parts of one query token's rows.  float32 queries run attend_rows,
// grid (KV, B), on needed tiles computed by the wrapper from the
// table-gathered kpos.  Neither syncs with the host.  Logical tile t of a slot
// holds the same keys as rows t*bl .. t*bl+bl-1 of the gathered contiguous
// cache and every sum runs in the same order, so the output is
// bit-identical to flash_decode at block_k = bl on the gathered layout.
// This kernel still walks one bl-key block per stage (two block barriers
// each, and at bl = 16 one warp's products): several table entries per stage
// would be later work.
#include "attention_mma.cuh"

namespace repro {

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
    flash_decode_paged_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                              const TKV* __restrict__ v, const int* __restrict__ kpos,
                              const int* __restrict__ tables, const int* __restrict__ pos,
                              const int* __restrict__ nt, TQ* __restrict__ out, int nmax,
                              int bl, int sq, int H, int KV, int hd, long long blk_stride,
                              long long kpos_blk_stride, int window, float scale) {
  const int g = blockIdx.x, b = blockIdx.y;
  const int n_rep = H / KV;
  // Row r: query token r / n_rep of the slot, head g * n_rep + r % n_rep.
  const RowMap rm{((size_t)b * sq * H + (size_t)g * n_rep) * hd, n_rep, (size_t)H * hd};
  const Mask mask{pos[b], n_rep, 1, window};
  const PagedTiles tiles{tables + (size_t)b * nmax, (size_t)blk_stride, (size_t)g * hd,
                         (size_t)KV * hd, kpos, (size_t)kpos_blk_stride, bl};
  attend_rows<TQ, TKV>(q, out, rm, sq * n_rep, k, v, tiles, 0, min(nt[b], nmax), bl, hd,
                       scale, mask);
}

template <int HD, int KW, typename TKV>
__global__ void __launch_bounds__(mma::kThreads)
    flash_decode_paged_mma_kernel(const __nv_bfloat16* __restrict__ q, const TKV* __restrict__ k,
                                  const TKV* __restrict__ v, const int* __restrict__ kpos,
                                  const int* __restrict__ tables, const int* __restrict__ pos,
                                  __nv_bfloat16* __restrict__ out, float* __restrict__ part_acc,
                                  float* __restrict__ part_ml, int* __restrict__ part_nt,
                                  int nmax, int bl, int sb, int block_rows, int sq, int H,
                                  int KV, long long blk_stride, long long kpos_blk_stride,
                                  int window, float scale_log2, int chunk_tiles, int chunks) {
  const int rb = gridDim.x / KV;  // row blocks of one kv head
  const int g = blockIdx.x / rb, b = blockIdx.y, c = blockIdx.z;
  const int r0 = (blockIdx.x - g * rb) * block_rows;
  const int n_rep = H / KV, rows = sq * n_rep;
  const int n_t = mma::block_needed_tiles(
      mma::PagedKeyPos{tables + (size_t)b * nmax, kpos, (size_t)kpos_blk_stride, bl}, nmax * bl,
      bl, pos[b], sq, window);
  if (c == 0 && r0 == 0 && chunks > 1 && threadIdx.x == 0) part_nt[b * KV + g] = n_t;
  const int t_lo = c * chunk_tiles;
  if (t_lo >= n_t) return;
  const RowMap rm{((size_t)b * sq * H + (size_t)g * n_rep) * HD, n_rep, (size_t)H * HD};
  const Mask mask{pos[b], n_rep, 1, window};
  const PagedTiles tiles{tables + (size_t)b * nmax, (size_t)blk_stride, (size_t)g * HD,
                         (size_t)KV * HD, kpos, (size_t)kpos_blk_stride, bl};
  const size_t slot = (((size_t)b * KV + g) * chunks + c) * rows + r0;
  const mma::Partial part = chunks > 1 ? mma::Partial{part_acc + slot * HD, part_ml + slot * 2}
                                       : mma::Partial{nullptr, nullptr};
  mma::attend_rows_mma<HD, KW>(q, out, part, rm, r0, min(block_rows, rows - r0), k, v, tiles,
                               t_lo, min(t_lo + chunk_tiles, n_t), bl, sb, scale_log2, mask);
}

template <int HD, int KW, typename TKV>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* kpos,
                       const void* tables, const void* pos, void* out, void* scratch, int B,
                       int nmax, int bl, int sq, int H, int KV,
                       long long blk_stride, long long kpos_blk_stride, const mma::Plan& p,
                       int window, float scale, int chunks, cudaStream_t stream) {
  const size_t smem = mma::smem_bytes(p, HD);
  auto kernel = flash_decode_paged_mma_kernel<HD, KW, TKV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = sq * (H / KV);
  const int block_rows = mma::kRows / p.ks, rb = (rows + block_rows - 1) / block_rows;
  float* acc = static_cast<float*>(scratch);
  float* ml = acc ? acc + (size_t)B * KV * chunks * rows * HD : nullptr;
  int* part_nt = acc ? reinterpret_cast<int*>(ml + (size_t)B * KV * chunks * rows * 2) : nullptr;
  const int ct = mma::chunk_tiles(bl);
  kernel<<<dim3(KV * rb, B, chunks), mma::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int*>(kpos),
      static_cast<const int*>(tables), static_cast<const int*>(pos),
      static_cast<__nv_bfloat16*>(out), acc, ml, part_nt, nmax, bl, p.sb, block_rows, sq, H, KV,
      blk_stride, kpos_blk_stride, window, scale * mma::kLog2e, ct, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  const dim3 grid(KV, B, (rows * HD + mma::kThreads - 1) / mma::kThreads);
  mma::combine_chunks_kernel<<<grid, mma::kThreads, 0, stream>>>(
      acc, ml, part_nt, static_cast<__nv_bfloat16*>(out), sq, H, KV, HD, ct, chunks);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kpos,
                   const void* tables, const void* pos, const void* nt, void* out, int B,
                   int nmax, int bl, int sq, int H, int KV, int hd, long long blk_stride,
                   long long kpos_blk_stride, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(sq * (H / KV), hd, bl);
  cudaError_t err = cudaFuncSetAttribute(flash_decode_paged_kernel<TQ, TKV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  flash_decode_paged_kernel<TQ, TKV><<<dim3(KV, B), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const int*>(kpos), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<const int*>(nt), static_cast<TQ*>(out), nmax,
      bl, sq, H, KV, hd, blk_stride, kpos_blk_stride, window, scale);
  return cudaGetLastError();
}

}  // namespace repro

// k and v share one physical-block stride (elements); each block's
// (bl, KV, hd) keys are contiguous.  dtype codes: 0 = float32,
// 1 = bfloat16.  `nt`, `chunks` and `scratch` as flash_decode_launch's,
// with nmax tiles of bl keys.  Returns a cudaError_t value.
extern "C" int flash_decode_paged_launch(const void* q, const void* k, const void* v,
                                         const void* kpos, const void* tables,
                                         const void* pos, const void* nt, void* out,
                                         void* scratch, int B, int nmax, int bl, int sq, int H,
                                         int KV, int hd, long long blk_stride,
                                         long long kpos_blk_stride, int window, float scale,
                                         int q_dtype, int kv_dtype, int chunks, void* stream) {
  using namespace repro;
  if (B <= 0 || nmax <= 0 || bl <= 0 || bl > kMaxBlockK || sq <= 0 || KV <= 0 ||
      H % KV != 0 || hd <= 0 || sq * (H / KV) > kMaxRows || B > 65535 || blk_stride <= 0 ||
      kpos_blk_stride <= 0)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const int rows = sq * (H / KV);
  const mma::Plan p = mma::plan(H / KV, bl, hd);  // one token's rows: as flash_decode's
  if (q_dtype == 1 && p.sb > 0 && (hd == 64 || hd == 112 || hd == 128 || hd == 256) &&
      (kv_dtype == 0 || kv_dtype == 1)) {
    const int want = (nmax + mma::chunk_tiles(bl) - 1) / mma::chunk_tiles(bl);
    if (chunks != want || (chunks > 1 && !scratch) || chunks > 65535 ||
        mma::smem_bytes(p, hd) > kMaxSmem)
      return cudaErrorInvalidValue;
#define REPRO_FDP_MMA(HD_, KW_)                                                              \
  if (hd == HD_ && p.kw == KW_) {                                                            \
    if (kv_dtype == 1)                                                                       \
      return launch_mma<HD_, KW_, __nv_bfloat16>(q, k, v, kpos, tables, pos, out, scratch,   \
                                                 B, nmax, bl, sq, H, KV, blk_stride,         \
                                                 kpos_blk_stride, p, window, scale, chunks,  \
                                                 st);                                        \
    return launch_mma<HD_, KW_, float>(q, k, v, kpos, tables, pos, out, scratch, B,         \
                                       nmax, bl, sq, H, KV, blk_stride, kpos_blk_stride, p,  \
                                       window, scale, chunks, st);                           \
  }
    REPRO_FDP_MMA(64, 16) REPRO_FDP_MMA(64, 32) REPRO_FDP_MMA(64, 64)
    REPRO_FDP_MMA(112, 16) REPRO_FDP_MMA(112, 32) REPRO_FDP_MMA(112, 64)
    REPRO_FDP_MMA(128, 16) REPRO_FDP_MMA(128, 32) REPRO_FDP_MMA(128, 64)
    REPRO_FDP_MMA(256, 16) REPRO_FDP_MMA(256, 32)
#undef REPRO_FDP_MMA
    return cudaErrorInvalidValue;
  }
  if (chunks != 1 || smem_bytes(rows, hd, bl) > kMaxSmem) return cudaErrorInvalidValue;
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, kpos, tables, pos, nt, out, B, nmax,
                                                bl, sq, H, KV, hd, blk_stride,
                                                kpos_blk_stride, window, scale, st);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch<__nv_bfloat16, float>(q, k, v, kpos, tables, pos, nt, out, B, nmax, bl, sq,
                                        H, KV, hd, blk_stride, kpos_blk_stride, window, scale,
                                        st);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, __nv_bfloat16>(q, k, v, kpos, tables, pos, nt, out, B, nmax, bl, sq,
                                        H, KV, hd, blk_stride, kpos_blk_stride, window, scale,
                                        st);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float>(q, k, v, kpos, tables, pos, nt, out, B, nmax, bl, sq, H, KV,
                                hd, blk_stride, kpos_blk_stride, window, scale, st);
  return cudaErrorInvalidValue;
}
