// FlashAttention forward for sm_90a: prefill attention.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention -> _flash_fwd_impl, body _kernel).  q (B,Sq,H,hd), k/v
// (B,Sk,KV,hd); causal with q_offset (query i sits at position
// i + q_offset), sliding window, or bidirectional; GQA reads kv head
// h / n_rep; keys past Sk are masked (the reference's kv-length mask on
// its padded tail).  Online softmax over KV tiles in float32.
//
// Layout: one block per (q tile, batch * head), grid (ceil(Sq/bq), B*H).
// On the TPU the KV axis was the innermost, sequential grid dimension
// carrying (m, l, acc) in VMEM; here a loop inside the block takes its
// place, bounded by the tile range the block's rows can reach under the
// causal / window mask, so unreachable tiles cost nothing.
//
// Bound on the card: at prefill lengths of a few hundred tokens the
// function moves q, k, v and out once (bytes) at about as many FLOPs per
// byte as hd, below the ~295 FLOPs per byte of the bf16 tensor cores, so
// the bound is bytes; at long prompts it becomes operations.  This first
// form computes with float FMAs from shared memory, not with tensor cores,
// so it is bound by those FMA loops; mma.sync / wgmma tiles are later work.
#include "attention_tile.cuh"

namespace repro {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
                           int H, int KV, int hd, int bq, int bk, int causal, int window,
                           int q_offset, float scale) {
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int g = h / (H / KV);
  const int q0 = blockIdx.x * bq;
  const int rows = min(bq, Sq - q0);
  const int first = q0 + q_offset;  // absolute positions of the tile's rows
  const int last = first + rows - 1;
  const int kv_end = causal ? min(Sk, last + 1) : Sk;
  const int kv_begin = window > 0 ? max(0, first - window + 1) : 0;
  const int t_lo = kv_begin / bk;
  const int t_hi = kv_end > kv_begin ? (kv_end + bk - 1) / bk : t_lo;
  const RowMap rm{(((size_t)b * Sq + q0) * H + h) * hd, 1, (size_t)H * hd};
  const Mask mask{first, 1, causal, window};
  const ContigTiles tiles{((size_t)b * Sk * KV + g) * hd, (size_t)KV * hd, nullptr, Sk, bk};
  attend_rows<T, T>(q, out, rm, rows, k, v, tiles, t_lo, t_hi, bk, hd, scale, mask);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                   int Sk, int H, int KV, int hd, int bq, int bk, int causal, int window,
                   int q_offset, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(bq, hd, bk);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + bq - 1) / bq, B * H);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, H, KV, hd, bq, bk, causal, window, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace repro

// dtype codes: 0 = float32, 1 = bfloat16.  Returns a cudaError_t value.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int Sq, int Sk, int H, int KV, int hd, int bq,
                                      int bk, int causal, int window, int q_offset,
                                      float scale, int dtype, void* stream) {
  using namespace repro;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || bq <= 0 ||
      bq > kMaxRows || bk <= 0 || bk > kMaxBlockK || (long long)B * H > 65535 ||
      smem_bytes(bq, hd, bk) > kMaxSmem)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KV, hd, bq, bk, causal, window,
                                 q_offset, scale, st);
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, Sq, Sk, H, KV, hd, bq, bk, causal, window,
                         q_offset, scale, st);
  return cudaErrorInvalidValue;
}
