// RG-LRU diagonal linear recurrence for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (rglru_scan, body _kernel):
//   h[b,t,w] = a[b,t,w] * h[b,t-1,w] + bb[b,t,w],  h[b,-1,w] = h0[b,w]
// All float32.  Returns every h (B,S,W) and the last one (B,W).
//
// The TPU kernel walks a sequential grid axis of 256-step chunks and
// carries the (block_w,) state in VMEM scratch.  Here one thread owns one
// sequence (b, w) and keeps h in a register over the whole time loop, so
// no divisibility of S or W is needed.  Neighbouring threads own
// neighbouring w, so every load and store is coalesced along W.
//
// Bound on the card: bytes (a, b and hs, 3 * B*S*W floats; 63 MB at B 8,
// S 256, W 2560), one FMA per 12 bytes.  Only B*W threads exist (20 480 at
// the main path's shapes) and each runs a chain of S dependent FMAs, so the
// card is thinly filled and the loads' latency, not their bytes, is what
// the design works on: blocks of 64 threads spread the sequences over more
// SMs, and the time loop is unrolled by kU steps whose a and b loads are
// all issued before the chain uses them, with the next kU steps' loads in
// flight while the current ones compute.  A chunked parallel scan, which
// would fill the card at small B*W, is later work.
#include <cuda_runtime.h>
#include <stddef.h>

namespace repro {

constexpr int kThreads = 64;
constexpr int kU = 16;  // time steps whose loads are in flight at once

__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ bb,
                      const float* __restrict__ h0, float* __restrict__ hs,
                      float* __restrict__ h_last, int S, int W) {
  const int b = blockIdx.y, w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const size_t base = (size_t)b * S * W + w;
  float h = h0[(size_t)b * W + w];
  float ra[kU], rb[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    ra[u] = u < S ? a[base + (size_t)u * W] : 0.f;
    rb[u] = u < S ? bb[base + (size_t)u * W] : 0.f;
  }
  for (int t0 = 0; t0 < S; t0 += kU) {
    float ca[kU], cb[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      ca[u] = ra[u];
      cb[u] = rb[u];
    }
    const int t1 = t0 + kU;
#pragma unroll
    for (int u = 0; u < kU; ++u) {  // the next steps' loads, in flight below
      ra[u] = t1 + u < S ? a[base + (size_t)(t1 + u) * W] : 0.f;
      rb[u] = t1 + u < S ? bb[base + (size_t)(t1 + u) * W] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (t0 + u < S) {
        h = ca[u] * h + cb[u];
        hs[base + (size_t)(t0 + u) * W] = h;
      }
    }
  }
  h_last[(size_t)b * W + w] = h;
}

}  // namespace repro

// Returns a cudaError_t value.
extern "C" int rglru_scan_launch(const void* a, const void* b, const void* h0, void* hs,
                                 void* h_last, int B, int S, int W, void* stream) {
  using namespace repro;
  if (B <= 0 || B > 65535 || S <= 0 || W <= 0) return cudaErrorInvalidValue;
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(hs), static_cast<float*>(h_last), S,
      W);
  return cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
