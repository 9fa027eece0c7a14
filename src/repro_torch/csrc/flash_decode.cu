// Ragged batched decode attention for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py
// (flash_decode, body _kernel).  Row j of slot b attends the cache as
// stored: keys with 0 <= kpos <= pos[b] + j (and kpos > pos[b] + j - window
// for a rolling cache).  GQA and the Sq query rows are folded into one row
// axis, rows = Sq * n_rep, so each K/V tile is read once for its whole
// query-head group.
//
// Bound on the card: bytes.  A step reads each needed K/V tile once; at the
// main path's last step (qwen1.5-4b: B 8, 288 keys, KV 20, hd 128) that is
// 23.6 MB, 0.0070 ms at 3.35 TB/s, at ~2 * rows FLOPs per value read, far
// below the ~295 FLOPs per byte where the tensor cores would bind.  At
// recurrentgemma-2b's (KV 1, hd 256) it is 2.4 MB, 0.0007 ms.
//
// bfloat16 queries (hd 64/112/128/256, bk a multiple of 16) run the tensor-core
// body (attend_rows_mma, attention_mma.cuh) with a batch-invariant split
// over the keys, so that a few slots and kv heads still fill the card:
// - a slot's needed tiles are cut into chunks of chunk_tiles(bk) =
//   256 / bk tiles (one tile when bk >= 256), a number set by bk alone;
// - grid (KV, B, chunks), chunks = ceil(ceil(S / bk) / chunk_tiles) from the
//   host's S; every block counts its slot's needed tiles nt[b] from kpos
//   (block_needed_tiles: on the device, no host sync, no extra launch), and
//   a block whose chunk starts at or past nt[b] exits;
// - with one chunk the block writes its rows; otherwise every chunk writes
//   its partial (m, l, acc) to scratch and combine_chunks_kernel merges a
//   slot's chunks in ascending order.
// - the block's four warps split each stage's keys into ks key parts, merged
//   in fixed order at the end, with ks = mma::plan(n_rep, bk, hd).ks: the
//   plan of one query token's n_rep rows, never of Sq.  A multi-row launch
//   (speculative verify: Sq = k + 1) whose rows outgrow one block's
//   kRows / ks rows takes more row blocks, grid (KV * row blocks, B,
//   chunks), each summing its rows' keys in the single-row order.
// So a row's sums run in an order set by (n_rep, bk, hd) alone: its output is
// bitwise the same whatever batch it is decoded in, and row j of a verify is
// bitwise the one-row launch at pos + j.  Tiles and key chunks past a row's
// position are wholly masked: p = 0 and alpha = exp2(0) = 1 leave its sums
// as they were, and a chunk partial of (m = -1e30, l = 0, acc = 0) enters the
// merge with weight exp2(-1e30 - m) = 0, after the row's own chunks.  Inside a
// block the rows are padded to 16 and every row count runs the mma
// fragments, also one row (qwen1.5-4b, no GQA): the step is bound by its
// bytes, and the padded products of a 64-key stage take a fraction of the
// stage's copy.  A float32 cache under bf16 queries is rounded to bf16 on its
// way into shared memory.
//
// float32 queries (and bf16 at other head sizes or tiles) keep attend_rows
// (attention_tile.cuh), one block per (kv head, slot), grid (KV, B).
#include "attention_mma.cuh"

namespace repro {

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v, const int* __restrict__ kpos,
                        const int* __restrict__ pos, const int* __restrict__ nt,
                        TQ* __restrict__ out, int S, int sq, int H, int KV, int hd, int bk,
                        int window, float scale) {
  const int g = blockIdx.x, b = blockIdx.y;
  const int n_rep = H / KV;
  // Row r: query token r / n_rep of the slot, head g * n_rep + r % n_rep.
  const RowMap rm{((size_t)b * sq * H + (size_t)g * n_rep) * hd, n_rep, (size_t)H * hd};
  const Mask mask{pos[b], n_rep, 1, window};
  const ContigTiles tiles{((size_t)b * S * KV + g) * hd, (size_t)KV * hd,
                          kpos + (size_t)b * S, S, bk};
  attend_rows<TQ, TKV>(q, out, rm, sq * n_rep, k, v, tiles, 0, nt[b], bk, hd, scale, mask);
}

template <int HD, int KW, typename TKV>
__global__ void __launch_bounds__(mma::kThreads)
    flash_decode_mma_kernel(const __nv_bfloat16* __restrict__ q, const TKV* __restrict__ k,
                            const TKV* __restrict__ v, const int* __restrict__ kpos,
                            const int* __restrict__ pos, __nv_bfloat16* __restrict__ out,
                            float* __restrict__ part_acc, float* __restrict__ part_ml,
                            int* __restrict__ part_nt, int S, int sq, int H, int KV, int bk,
                            int sb, int block_rows, int window, float scale_log2,
                            int chunk_tiles, int chunks) {
  const int rb = gridDim.x / KV;  // row blocks of one kv head
  const int g = blockIdx.x / rb, b = blockIdx.y, c = blockIdx.z;
  const int r0 = (blockIdx.x - g * rb) * block_rows;
  const int n_rep = H / KV, rows = sq * n_rep;
  const int n_t = mma::block_needed_tiles(mma::ContigKeyPos{kpos + (size_t)b * S}, S, bk,
                                          pos[b], sq, window);
  if (c == 0 && r0 == 0 && chunks > 1 && threadIdx.x == 0) part_nt[b * KV + g] = n_t;
  const int t_lo = c * chunk_tiles;
  if (t_lo >= n_t) return;
  const RowMap rm{((size_t)b * sq * H + (size_t)g * n_rep) * HD, n_rep, (size_t)H * HD};
  const Mask mask{pos[b], n_rep, 1, window};
  const ContigTiles tiles{((size_t)b * S * KV + g) * HD, (size_t)KV * HD,
                          kpos + (size_t)b * S, S, bk};
  const size_t slot = (((size_t)b * KV + g) * chunks + c) * rows + r0;
  const mma::Partial part = chunks > 1 ? mma::Partial{part_acc + slot * HD, part_ml + slot * 2}
                                       : mma::Partial{nullptr, nullptr};
  mma::attend_rows_mma<HD, KW>(q, out, part, rm, r0, min(block_rows, rows - r0), k, v, tiles,
                               t_lo, min(t_lo + chunk_tiles, n_t), bk, sb, scale_log2, mask);
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kpos,
                   const void* pos, const void* nt, void* out, int B, int S, int sq, int H,
                   int KV, int hd, int bk, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(sq * (H / KV), hd, bk);
  cudaError_t err = cudaFuncSetAttribute(flash_decode_kernel<TQ, TKV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  flash_decode_kernel<TQ, TKV><<<dim3(KV, B), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const int*>(kpos), static_cast<const int*>(pos),
      static_cast<const int*>(nt), static_cast<TQ*>(out), S, sq, H, KV, hd, bk, window,
      scale);
  return cudaGetLastError();
}

template <int HD, int KW, typename TKV>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* kpos,
                       const void* pos, void* out, void* scratch, int B,
                       int S, int sq, int H, int KV, int bk, const mma::Plan& p, int window,
                       float scale, int chunks, cudaStream_t stream) {
  const size_t smem = mma::smem_bytes(p, HD);
  auto kernel = flash_decode_mma_kernel<HD, KW, TKV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = sq * (H / KV);
  const int block_rows = mma::kRows / p.ks, rb = (rows + block_rows - 1) / block_rows;
  float* acc = static_cast<float*>(scratch);
  float* ml = acc ? acc + (size_t)B * KV * chunks * rows * HD : nullptr;
  int* part_nt = acc ? reinterpret_cast<int*>(ml + (size_t)B * KV * chunks * rows * 2) : nullptr;
  const int ct = mma::chunk_tiles(bk);
  kernel<<<dim3(KV * rb, B, chunks), mma::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int*>(kpos), static_cast<const int*>(pos),
      static_cast<__nv_bfloat16*>(out), acc, ml, part_nt, S, sq, H, KV, bk, p.sb, block_rows,
      window, scale * mma::kLog2e, ct, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  const dim3 grid(KV, B, (rows * HD + mma::kThreads - 1) / mma::kThreads);
  mma::combine_chunks_kernel<<<grid, mma::kThreads, 0, stream>>>(
      acc, ml, part_nt, static_cast<__nv_bfloat16*>(out), sq, H, KV, HD, ct, chunks);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Chunk launch: chunked prefill's rows (the JAX package's chunk_attention,
// which calls flash_decode at its prefill tile size).  Row j of slot b sits
// at position pos[b] + j, any Sq; keys are the cache as stored, masked by
// recorded position (0 <= kpos <= pos[b] + j).  The launch takes the
// prefill kernel's (flash_attention.cu) partition, so that a chunk row
// equals the prefill row at its position bitwise:
// - tiles of bk keys (flash_attention's block_k), walked from tile 0 in
//   ascending order by one block, with no key chunks and no combine kernel;
// - on the tensor-core body the plan of a 64-row prefill block
//   (mma::plan(kRows, bk, hd): ks = 1 key part, the same stage width)
//   whatever the chunk length; the grid is (KV, B, 64-row groups of the
//   slot's Sq * n_rep rows), row r at position r / n_rep and head
//   g * n_rep + r % n_rep, as decode folds them;
// - each block counts its tiles on the device (block_needed_tiles over its
//   own rows, no host sync).
// On the cache invariant that logical index i holds kpos in {i, -1} a row
// then sees the same keys in the same stages as the prefill row; stages past
// its position are wholly masked (p = 0, alpha = exp2(0) = 1) and change
// none of its sums.  The float32 route keeps attend_rows on flash_attention's
// grid (64 positions of one head a block), its tiles counted by needed_tiles.
//
// Bound on the card: bytes.  At qwen1.5-4b's served chunk (B 8, 64 rows,
// H = KV = 20, hd 128) at cursor 192 a block reads its slot's 256 keys of
// one head once: 21.0 MB of k/v, 0.0063 ms at 3.35 TB/s, against 1.3 GFLOP
// of products (0.0014 ms at 989 TFLOP/s).

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
    flash_decode_chunk_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                              const TKV* __restrict__ v, const int* __restrict__ kpos,
                              const int* __restrict__ pos, const int* __restrict__ nt,
                              TQ* __restrict__ out, int S, int sq, int H, int KV, int hd, int bq,
                              int bk, int window, float scale) {
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int g = h / (H / KV);
  const int q0 = blockIdx.x * bq;
  const int rows = min(bq, sq - q0);
  const RowMap rm{(((size_t)b * sq + q0) * H + h) * hd, 1, (size_t)H * hd};
  const Mask mask{pos[b] + q0, 1, 1, window};
  const ContigTiles tiles{((size_t)b * S * KV + g) * hd, (size_t)KV * hd,
                          kpos + (size_t)b * S, S, bk};
  attend_rows<TQ, TKV>(q, out, rm, rows, k, v, tiles, 0, nt[b], bk, hd, scale, mask);
}

template <int HD, int KW, typename TKV>
__global__ void __launch_bounds__(mma::kThreads)
    flash_decode_chunk_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                  const TKV* __restrict__ k, const TKV* __restrict__ v,
                                  const int* __restrict__ kpos, const int* __restrict__ pos,
                                  __nv_bfloat16* __restrict__ out, int S, int sq, int H,
                                  int KV, int bk, int sb, int window, float scale_log2) {
  const int g = blockIdx.x, b = blockIdx.y;
  const int n_rep = H / KV, total = sq * n_rep;
  // Row groups from the last: the deepest rows reach the most tiles.
  const int r0 = (gridDim.z - 1 - blockIdx.z) * mma::kRows;
  const int rows = min(mma::kRows, total - r0);
  const int p_first = pos[b] + r0 / n_rep, p_last = pos[b] + (r0 + rows - 1) / n_rep;
  const int n_t = mma::block_needed_tiles(mma::ContigKeyPos{kpos + (size_t)b * S}, S, bk,
                                          p_first, p_last - p_first + 1, window);
  const RowMap rm{((size_t)b * sq * H + (size_t)g * n_rep) * HD, n_rep, (size_t)H * HD};
  const Mask mask{pos[b], n_rep, 1, window};
  const ContigTiles tiles{((size_t)b * S * KV + g) * HD, (size_t)KV * HD,
                          kpos + (size_t)b * S, S, bk};
  mma::attend_rows_mma<HD, KW>(q, out, mma::Partial{nullptr, nullptr}, rm, r0, rows, k, v,
                               tiles, 0, n_t, bk, sb, scale_log2, mask);
}

template <typename TQ, typename TKV>
cudaError_t launch_chunk(const void* q, const void* k, const void* v, const void* kpos,
                         const void* pos, const void* nt, void* out, int B, int S, int sq,
                         int H, int KV, int hd, int bk, int window, float scale,
                         cudaStream_t stream) {
  const int bq = sq < kMaxRows ? sq : kMaxRows;
  const size_t smem = smem_bytes(bq, hd, bk);
  cudaError_t err = cudaFuncSetAttribute(flash_decode_chunk_kernel<TQ, TKV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + bq - 1) / bq, B * H);
  flash_decode_chunk_kernel<TQ, TKV><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const int*>(kpos), static_cast<const int*>(pos),
      static_cast<const int*>(nt), static_cast<TQ*>(out), S, sq, H, KV, hd, bq, bk, window,
      scale);
  return cudaGetLastError();
}

template <int HD, int KW, typename TKV>
cudaError_t launch_chunk_mma(const void* q, const void* k, const void* v, const void* kpos,
                             const void* pos, void* out, int B, int S, int sq, int H, int KV,
                             int bk, const mma::Plan& p, int window, float scale,
                             cudaStream_t stream) {
  const size_t smem = mma::smem_bytes(p, HD);
  auto kernel = flash_decode_chunk_mma_kernel<HD, KW, TKV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int groups = (sq * (H / KV) + mma::kRows - 1) / mma::kRows;
  kernel<<<dim3(KV, B, groups), mma::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int*>(kpos), static_cast<const int*>(pos),
      static_cast<__nv_bfloat16*>(out), S, sq, H, KV, bk, p.sb, window, scale * mma::kLog2e);
  return cudaGetLastError();
}

}  // namespace repro

// dtype codes: 0 = float32, 1 = bfloat16.  `nt` (B) is needed_tiles, read
// by the attend_rows route; the tensor-core route counts each slot's tiles
// itself and ignores it.  `chunks` is that route's key-chunk count
// (ceil(ceil(S / bk) / chunk_tiles(bk)); 1 on the attend_rows route); with
// chunks > 1, `scratch` holds B * KV * (chunks * rows * (hd + 2) + 1)
// 4-byte words.  Returns a cudaError_t value.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* kpos, const void* pos, const void* nt,
                                   void* out, void* scratch, int B, int S, int sq, int H,
                                   int KV, int hd, int bk, int window, float scale,
                                   int q_dtype, int kv_dtype, int chunks, void* stream) {
  using namespace repro;
  if (B <= 0 || S <= 0 || sq <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || bk <= 0 ||
      bk > kMaxBlockK || sq * (H / KV) > kMaxRows || B > 65535)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const int rows = sq * (H / KV);
  // The key parts of one query token's n_rep rows, whatever Sq (see above).
  const mma::Plan p = mma::plan(H / KV, bk, hd);
  if (q_dtype == 1 && p.sb > 0 && (hd == 64 || hd == 112 || hd == 128 || hd == 256) &&
      (kv_dtype == 0 || kv_dtype == 1)) {
    const int want = ((S + bk - 1) / bk + mma::chunk_tiles(bk) - 1) / mma::chunk_tiles(bk);
    if (chunks != want || (chunks > 1 && !scratch) || chunks > 65535 ||
        mma::smem_bytes(p, hd) > kMaxSmem)
      return cudaErrorInvalidValue;
#define REPRO_FD_MMA(HD_, KW_)                                                               \
  if (hd == HD_ && p.kw == KW_) {                                                            \
    if (kv_dtype == 1)                                                                       \
      return launch_mma<HD_, KW_, __nv_bfloat16>(q, k, v, kpos, pos, out, scratch, B, S,     \
                                                 sq, H, KV, bk, p, window, scale, chunks,    \
                                                 st);                                        \
    return launch_mma<HD_, KW_, float>(q, k, v, kpos, pos, out, scratch, B, S, sq, H, KV,   \
                                       bk, p, window, scale, chunks, st);                    \
  }
    REPRO_FD_MMA(64, 16) REPRO_FD_MMA(64, 32) REPRO_FD_MMA(64, 64)
    REPRO_FD_MMA(112, 16) REPRO_FD_MMA(112, 32) REPRO_FD_MMA(112, 64)
    REPRO_FD_MMA(128, 16) REPRO_FD_MMA(128, 32) REPRO_FD_MMA(128, 64)
    REPRO_FD_MMA(256, 16) REPRO_FD_MMA(256, 32)
#undef REPRO_FD_MMA
    return cudaErrorInvalidValue;
  }
  if (chunks != 1 || smem_bytes(rows, hd, bk) > kMaxSmem) return cudaErrorInvalidValue;
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, kpos, pos, nt, out, B, S, sq, H,
                                                KV, hd, bk, window, scale, st);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch<__nv_bfloat16, float>(q, k, v, kpos, pos, nt, out, B, S, sq, H, KV, hd,
                                        bk, window, scale, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, __nv_bfloat16>(q, k, v, kpos, pos, nt, out, B, S, sq, H, KV, hd,
                                        bk, window, scale, st);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float>(q, k, v, kpos, pos, nt, out, B, S, sq, H, KV, hd, bk,
                                window, scale, st);
  return cudaErrorInvalidValue;
}

// The chunk launch (see above).  `nt` (B) is needed_tiles at sq rows, read
// by the attend_rows route; the tensor-core route counts each block's tiles
// itself and ignores it.  bfloat16 queries at hd 64/112/128/256 with bk a
// multiple of 16 run the tensor-core body with the plan of a 64-row block.
// Returns a cudaError_t value.
extern "C" int flash_decode_chunk_launch(const void* q, const void* k, const void* v,
                                         const void* kpos, const void* pos, const void* nt,
                                         void* out, int B, int S, int sq, int H, int KV, int hd,
                                         int bk, int window, float scale, int q_dtype,
                                         int kv_dtype, void* stream) {
  using namespace repro;
  if (B <= 0 || S <= 0 || sq <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || bk <= 0 ||
      bk > kMaxBlockK || B > 65535)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const mma::Plan p = mma::plan(mma::kRows, bk, hd);
  if (q_dtype == 1 && p.sb > 0 && (hd == 64 || hd == 112 || hd == 128 || hd == 256) &&
      (kv_dtype == 0 || kv_dtype == 1)) {
    if ((sq * (H / KV) + mma::kRows - 1) / mma::kRows > 65535 ||
        mma::smem_bytes(p, hd) > kMaxSmem)
      return cudaErrorInvalidValue;
#define REPRO_FDC_MMA(HD_, KW_)                                                              \
  if (hd == HD_ && p.kw == KW_) {                                                            \
    if (kv_dtype == 1)                                                                       \
      return launch_chunk_mma<HD_, KW_, __nv_bfloat16>(q, k, v, kpos, pos, out, B, S, sq, H, \
                                                       KV, bk, p, window, scale, st);        \
    return launch_chunk_mma<HD_, KW_, float>(q, k, v, kpos, pos, out, B, S, sq, H, KV, bk,  \
                                             p, window, scale, st);                          \
  }
    REPRO_FDC_MMA(64, 16) REPRO_FDC_MMA(64, 32) REPRO_FDC_MMA(64, 64)
    REPRO_FDC_MMA(112, 16) REPRO_FDC_MMA(112, 32) REPRO_FDC_MMA(112, 64)
    REPRO_FDC_MMA(128, 16) REPRO_FDC_MMA(128, 32) REPRO_FDC_MMA(128, 64)
    REPRO_FDC_MMA(256, 16) REPRO_FDC_MMA(256, 32)
#undef REPRO_FDC_MMA
    return cudaErrorInvalidValue;
  }
  const int bq = sq < kMaxRows ? sq : kMaxRows;
  if ((long long)B * H > 65535 || smem_bytes(bq, hd, bk) > kMaxSmem)
    return cudaErrorInvalidValue;
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_chunk<__nv_bfloat16, __nv_bfloat16>(q, k, v, kpos, pos, nt, out, B, S, sq,
                                                      H, KV, hd, bk, window, scale, st);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_chunk<__nv_bfloat16, float>(q, k, v, kpos, pos, nt, out, B, S, sq, H, KV,
                                              hd, bk, window, scale, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_chunk<float, __nv_bfloat16>(q, k, v, kpos, pos, nt, out, B, S, sq, H, KV,
                                              hd, bk, window, scale, st);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_chunk<float, float>(q, k, v, kpos, pos, nt, out, B, S, sq, H, KV, hd, bk,
                                      window, scale, st);
  return cudaErrorInvalidValue;
}
