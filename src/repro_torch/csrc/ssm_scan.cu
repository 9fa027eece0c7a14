// Mamba selective scan for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py (ssm_scan,
// body _kernel).  Per time step t and state element (b, d, n), with dt
// already through softplus:
//   h = exp(dt[b,t,d] * A[d,n]) * h + (dt[b,t,d] * x[b,t,d]) * B[b,t,n]
//   y[b,t,d] = sum_n h * C[b,t,n]
// All float32.  Returns y (B,S,di) and the last state h_last (B,di,N).
//
// The TPU kernel walks a sequential grid axis of 256-step chunks and
// carries the (block_d, N) state in VMEM scratch from one chunk to the
// next.  Blocks on the card run in no order, so here the whole time loop
// lives inside the block: one thread owns one state element (b, d, n) and
// keeps h in a register from t = 0 to S - 1.  The NP lanes of a channel
// (NP = N rounded up to a power of two, at most 32) sit in one warp, and y
// is their sum by __shfl_xor_sync.  No divisibility of S or di is needed.
//
// Bound on the card: bytes, then the exponentials.  dt, x and y are
// B*S*di floats each (67 MB at B 8, S 256, di 8192) against B*S*di*N
// exponentials (268 M), which is about as much time at the SFU's rate; the
// B and C rows are shared by every channel of a slot and are small.  The
// design keeps every byte read once: a block stages kT time steps of its
// channels' dt and x and of the slot's B and C rows in shared memory, and
// loads the next kT steps into registers while it computes the current
// ones, so those loads are in flight during the recurrence.  y goes out
// through shared memory, kT steps at a time.  expf (not __expf) keeps the
// kernel within 1e-4 of the plain version.
#include <cuda_runtime.h>
#include <stddef.h>

namespace repro {

constexpr int kThreads = 256;

// Elements [0, kT * width) of a (kT, width) stage: row tt and column col
// read from global memory at base + (t0 + tt) * row_stride + col when
// col < cols and t0 + tt < S, else 0.  Thread tid owns elements tid,
// tid + kThreads, ...
template <int PER, int kT>
struct Stage {
  float v[PER];

  __device__ __forceinline__ void load(const float* __restrict__ src, size_t base,
                                       size_t row_stride, int width, int cols, int t0, int S) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int tt = i / width, col = i - tt * width;
      v[u] = (tt < kT && col < cols && t0 + tt < S)
                 ? src[base + (size_t)(t0 + tt) * row_stride + col]
                 : 0.f;
    }
  }

  __device__ __forceinline__ void store(float* dst, int width) const {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < kT * width) dst[i] = v[u];
    }
  }
};

template <int NP>
__global__ void __launch_bounds__(kThreads)
    ssm_scan_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                    const float* __restrict__ bm, const float* __restrict__ cm,
                    const float* __restrict__ a, const float* __restrict__ h0,
                    float* __restrict__ y, float* __restrict__ h_last, int S, int di, int N) {
  constexpr int CPB = kThreads / NP;  // channels per block
  // Time steps staged in shared memory at once: 32, or fewer where a block
  // holds so many channels (N <= 2) that 32 steps of dt, x and y would pass
  // the 48 KB of static shared memory.
  constexpr int kT = NP >= 4 ? 32 : 8 * NP;
  constexpr int PER_DX = (kT * CPB + kThreads - 1) / kThreads;
  constexpr int PER_BC = (kT * NP + kThreads - 1) / kThreads;
  __shared__ float dt_s[kT * CPB], x_s[kT * CPB], y_s[kT * CPB];
  __shared__ float b_s[kT * NP], c_s[kT * NP];

  const int b = blockIdx.y, d0 = blockIdx.x * CPB;
  const int n = threadIdx.x % NP, c = threadIdx.x / NP, d = d0 + c;
  const bool live = d < di && n < N;
  const size_t state = ((size_t)b * di + d) * N + n;
  const float A = live ? a[(size_t)d * N + n] : 0.f;
  float h = live ? h0[state] : 0.f;  // dead lanes stay 0 and add 0 to y

  const int cols = min(CPB, di - d0);
  const size_t dx_base = (size_t)b * S * di + d0, bc_base = (size_t)b * S * N;
  Stage<PER_DX, kT> dt_r, x_r;
  Stage<PER_BC, kT> b_r, c_r;
  dt_r.load(dt, dx_base, di, CPB, cols, 0, S);
  x_r.load(x, dx_base, di, CPB, cols, 0, S);
  b_r.load(bm, bc_base, N, NP, N, 0, S);
  c_r.load(cm, bc_base, N, NP, N, 0, S);

  for (int t0 = 0; t0 < S; t0 += kT) {
    dt_r.store(dt_s, CPB);
    x_r.store(x_s, CPB);
    b_r.store(b_s, NP);
    c_r.store(c_s, NP);
    __syncthreads();
    if (t0 + kT < S) {  // the next steps' loads stay in flight below
      dt_r.load(dt, dx_base, di, CPB, cols, t0 + kT, S);
      x_r.load(x, dx_base, di, CPB, cols, t0 + kT, S);
      b_r.load(bm, bc_base, N, NP, N, t0 + kT, S);
      c_r.load(cm, bc_base, N, NP, N, t0 + kT, S);
    }
    const int T = min(kT, S - t0);
    for (int tt = 0; tt < T; ++tt) {
      const float dtv = dt_s[tt * CPB + c];
      const float da = expf(dtv * A);
      h = da * h + (dtv * x_s[tt * CPB + c]) * b_s[tt * NP + n];
      float p = h * c_s[tt * NP + n];
#pragma unroll
      for (int o = NP / 2; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
      if (n == 0) y_s[tt * CPB + c] = p;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < T * CPB; i += kThreads) {
      const int tt = i / CPB, col = i - tt * CPB;
      if (col < cols) y[dx_base + (size_t)(t0 + tt) * di + col] = y_s[i];
    }
  }
  if (live) h_last[state] = h;
}

template <int NP>
cudaError_t launch(const float* dt, const float* x, const float* bm, const float* cm,
                   const float* a, const float* h0, float* y, float* h_last, int B, int S,
                   int di, int N, cudaStream_t stream) {
  constexpr int CPB = kThreads / NP;
  const dim3 grid((di + CPB - 1) / CPB, B);
  ssm_scan_kernel<NP><<<grid, kThreads, 0, stream>>>(dt, x, bm, cm, a, h0, y, h_last, S, di, N);
  return cudaGetLastError();
}

}  // namespace repro

// Returns a cudaError_t value.
extern "C" int ssm_scan_launch(const void* dt, const void* x, const void* bm, const void* cm,
                               const void* a, const void* h0, void* y, void* h_last, int B,
                               int S, int di, int N, void* stream) {
  using namespace repro;
  if (B <= 0 || B > 65535 || S <= 0 || di <= 0 || N <= 0 || N > 32)
    return cudaErrorInvalidValue;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  float *yo = static_cast<float*>(y), *ho = static_cast<float*>(h_last);
  const auto st = static_cast<cudaStream_t>(stream);
  if (N <= 1) return launch<1>(f(dt), f(x), f(bm), f(cm), f(a), f(h0), yo, ho, B, S, di, N, st);
  if (N <= 2) return launch<2>(f(dt), f(x), f(bm), f(cm), f(a), f(h0), yo, ho, B, S, di, N, st);
  if (N <= 4) return launch<4>(f(dt), f(x), f(bm), f(cm), f(a), f(h0), yo, ho, B, S, di, N, st);
  if (N <= 8) return launch<8>(f(dt), f(x), f(bm), f(cm), f(a), f(h0), yo, ho, B, S, di, N, st);
  if (N <= 16)
    return launch<16>(f(dt), f(x), f(bm), f(cm), f(a), f(h0), yo, ho, B, S, di, N, st);
  return launch<32>(f(dt), f(x), f(bm), f(cm), f(a), f(h0), yo, ho, B, S, di, N, st);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
