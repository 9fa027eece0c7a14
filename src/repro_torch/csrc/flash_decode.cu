// Ragged batched decode attention for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py
// (flash_decode, body _kernel).  Row j of slot b attends the cache as
// stored: keys with 0 <= kpos <= pos[b] + j (and kpos > pos[b] + j - window
// for a rolling cache).  GQA and the Sq query rows are folded into one row
// axis, rows = Sq * n_rep, so each K/V tile is read once for its whole
// query-head group.
//
// Layout: one block per (kv head, slot), grid (KV, B).  The block loops over
// its slot's first nt[b] KV tiles, nt read from device memory: that loop
// bound replaces the TPU's index-map clamp plus pl.when, and nothing is
// synchronised with the host.  A slot's reduction order depends on the slot
// alone (no split-K whose split count follows the batch).
//
// Bound on the card: bytes.  Every decode step reads each needed K/V tile
// once (B * KV * needed keys * hd * 2 values) and does ~2 * rows FLOPs per
// value read, far below the ~295 FLOPs per byte where the tensor cores would
// bind.  This first form reads each K/V element once into shared memory and
// never again from device memory; its speed is limited by the plain FMA
// loops over shared memory and by one block per (slot, kv head), which
// leaves SMs idle at small batch.  Split-KV across blocks would break the
// per-slot reduction order and is not used.
#include "attention_tile.cuh"

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

}  // namespace repro

// dtype codes: 0 = float32, 1 = bfloat16.  Returns a cudaError_t value.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* kpos, const void* pos, const void* nt,
                                   void* out, int B, int S, int sq, int H, int KV, int hd,
                                   int bk, int window, float scale, int q_dtype,
                                   int kv_dtype, void* stream) {
  using namespace repro;
  if (B <= 0 || S <= 0 || sq <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || bk <= 0 ||
      bk > kMaxBlockK || sq * (H / KV) > kMaxRows || B > 65535 ||
      smem_bytes(sq * (H / KV), hd, bk) > kMaxSmem)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
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
