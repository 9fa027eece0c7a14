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
// Layout: one block per (kv head, slot), grid (KV, B), the grid of
// flash_decode.  The block loops over its slot's first nt[b] logical tiles,
// nt computed on the device from the table-gathered kpos (no host sync),
// and resolves tables[b, t] inside the loop: on the TPU the block table was
// a scalar-prefetch operand of the index maps; here the block reads its own
// table row.  Each tile of bl keys runs the tile body of flash_decode
// (attend_rows in attention_tile.cuh, with PagedTiles as its tile address):
// logical tile t of a slot holds the same keys as rows t*bl .. t*bl+bl-1 of
// the gathered contiguous cache, and tiles are reduced in the same order, so
// the output is bit-identical to flash_decode at block_k = bl on the
// gathered layout.
//
// Bound on the card: bytes, as flash_decode (each needed K/V tile read
// once, ~2 * rows FLOPs per value read).  This first form pays more loop
// overhead than flash_decode: a tile of bl = 16 keys per loop step, with
// three block-wide barriers each, where flash_decode takes 128.
#include "attention_tile.cuh"

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
// 1 = bfloat16.  Returns a cudaError_t value.
extern "C" int flash_decode_paged_launch(const void* q, const void* k, const void* v,
                                         const void* kpos, const void* tables,
                                         const void* pos, const void* nt, void* out, int B,
                                         int nmax, int bl, int sq, int H, int KV, int hd,
                                         long long blk_stride, long long kpos_blk_stride,
                                         int window, float scale, int q_dtype, int kv_dtype,
                                         void* stream) {
  using namespace repro;
  if (B <= 0 || nmax <= 0 || bl <= 0 || bl > kMaxBlockK || sq <= 0 || KV <= 0 ||
      H % KV != 0 || hd <= 0 || sq * (H / KV) > kMaxRows || B > 65535 || blk_stride <= 0 ||
      kpos_blk_stride <= 0 || smem_bytes(sq * (H / KV), hd, bl) > kMaxSmem)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
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
