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
// lives inside the block, and no divisibility of S or di is needed.
//
// Bound on the card: bytes, and the exponentials just behind them.  dt, x
// and y are B*S*di floats each (201 MB at B 8, S 256, di 8192: 0.060 ms at
// 3.35 TB/s); the B and C rows are shared by every channel of a slot and
// are small.  The same shape needs B*S*di*N exponentials (268 M), and the
// SFU computes 16 a clock on each SM: 0.064 ms on 132 SMs at 1.98 GHz (the
// SFU floor).  Everything else has to fit beside those two, so the design
// spends about five instructions per state element and step, one of them
// the SFU's:
//   - One thread owns one channel (b, d) and keeps all N states in
//     registers (NP = N rounded up to 4, 8, 16 or 32; lanes above N hold
//     h = 0, A = 0, B = C = 0 and add exact zeros).  dt * x is formed once
//     per step, the decay is one ex2.approx of dt * (A * log2 e), with A
//     scaled once at the start, and y is a sum over n in registers: no
//     shuffles, no one-lane stores.  ex2.approx keeps the kernel within
//     1e-4 of the plain version (chip_smoke.py checks it).
//   - A block holds a run of consecutive channels of one batch row.  It
//     stages kSteps steps of their dt and x and of the row's B and C in
//     shared memory by cp.async, in a ring of kStages stages (16-byte
//     copies, 4-byte ones where di or N is not a multiple of 4 or a tensor
//     is not 16-byte aligned), so the next stage is in flight while one is
//     computed.  B and C are read as float4 broadcasts, a step ahead of
//     their use; a stage's y stays in registers and goes out at its end,
//     one coalesced row per step.
//   - The SFU's latency needs many warps or much reading ahead: at B 8, di
//     8192 there are only four warps a scheduler, so the launch bounds ask
//     ptxas for four blocks an SM, which lets it spend up to 128 registers
//     a thread on reading ahead.
//   - Every product and sum is written with an explicit rounding
//     intrinsic, in a fixed order set by NP alone: a channel's bits do not
//     depend on the block size or the batch around it.  The block size
//     (channels per block, 32 to 128) is chosen by scan_plan in
//     kernels/ssm_scan.py, which this file's launch mirrors, so that the
//     grid covers the SMs at small batches.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace repro {
namespace ssm {

constexpr int kSteps = 16;          // time steps of one stage
constexpr int kStages = 2;          // stages in the ring
constexpr int kMaxChannels = 128;   // channels (threads) of one block
constexpr float kLog2e = 1.4426950408889634f;

// Floats of one stage: dt and x of `cpb` channels, then the B and C rows
// padded to np.  kernels/ssm_scan.py (scan_plan) mirrors this.
__host__ __device__ constexpr int stage_floats(int np, int cpb) {
  return 2 * kSteps * (cpb + np);
}

__host__ __device__ constexpr size_t smem_bytes(int np, int cpb) {
  return (size_t)kStages * stage_floats(np, cpb) * sizeof(float);
}

struct Args {
  const float* __restrict__ dt;
  const float* __restrict__ x;
  const float* __restrict__ bm;
  const float* __restrict__ cm;
  const float* __restrict__ a;
  const float* __restrict__ h0;
  float* __restrict__ y;
  float* __restrict__ h_last;
  int S, di, N;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 or 4 bytes global -> shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// Stage steps [t0, t0 + kSteps) of the block's channels [d0, d0 + cols) of
// batch row b into `st`: dt[kSteps][cpb], x[kSteps][cpb], B[kSteps][NP],
// C[kSteps][NP].  Steps past S and channels past di are zero-filled; the
// padding columns [N, NP) of B and C are never written here.
template <int NP>
__device__ __forceinline__ void load_stage(float* st, const Args& p, int b, int d0, int cols,
                                           int t0, int cpb, bool vec_d, bool vec_n) {
  const int tid = threadIdx.x, T = min(kSteps, p.S - t0);
  float *dts = st, *xs = st + kSteps * cpb, *bs = st + 2 * kSteps * cpb, *cs = bs + kSteps * NP;
  const size_t row0 = ((size_t)b * p.S + t0) * p.di + d0;
  if (vec_d) {
    // A row is cpb / 4 pieces of 16 bytes, so the block copies 4 rows at a
    // time: thread tid takes column 4 * (tid % (cpb / 4)) of rows
    // tid / (cpb / 4) + 4k.
    const int q = cpb / 4, j = 4 * (tid % q);
#pragma unroll
    for (int tt = tid / q; tt < kSteps; tt += 4) {
      const bool ok = tt < T && j < cols;
      const size_t g = ok ? row0 + (size_t)tt * p.di + j : 0;
      cp_async16(dts + tt * cpb + j, p.dt + g, ok);
      cp_async16(xs + tt * cpb + j, p.x + g, ok);
    }
  } else {
    for (int tt = 0; tt < kSteps; ++tt) {
      const bool ok = tt < T && tid < cols;
      const size_t g = ok ? row0 + (size_t)tt * p.di + tid : 0;
      cp_async4(dts + tt * cpb + tid, p.dt + g, ok);
      cp_async4(xs + tt * cpb + tid, p.x + g, ok);
    }
  }
  const int N = p.N;
  const size_t bc0 = ((size_t)b * p.S + t0) * N;  // T rows of N floats, contiguous
  if (vec_n) {
    const int q = N / 4;
    for (int i = tid; i < kSteps * q; i += cpb) {
      const int tt = i / q, j = 4 * (i - tt * q);
      const bool ok = tt < T;
      const size_t g = ok ? bc0 + (size_t)tt * N + j : 0;
      cp_async16(bs + tt * NP + j, p.bm + g, ok);
      cp_async16(cs + tt * NP + j, p.cm + g, ok);
    }
  } else {
    for (int i = tid; i < kSteps * N; i += cpb) {
      const int tt = i / N, j = i - tt * N;
      const bool ok = tt < T;
      const size_t g = ok ? bc0 + i : 0;
      cp_async4(bs + tt * NP + j, p.bm + g, ok);
      cp_async4(cs + tt * NP + j, p.cm + g, ok);
    }
  }
}

// One step's inputs of one channel, read from a stage: its dt and x, and
// the B and C rows as float4 broadcasts.
template <int NP>
struct Operands {
  float dt, x;
  float4 b[NP / 4], c[NP / 4];

  __device__ __forceinline__ void load(const float* st, int tt, int cpb) {
    const float *bs = st + 2 * kSteps * cpb + tt * NP, *cs = bs + kSteps * NP;
    dt = st[tt * cpb + threadIdx.x];
    x = st[(kSteps + tt) * cpb + threadIdx.x];
#pragma unroll
    for (int q = 0; q < NP / 4; ++q) {
      b[q] = reinterpret_cast<const float4*>(bs)[q];
      c[q] = reinterpret_cast<const float4*>(cs)[q];
    }
  }
};

// One time step of one channel: h <- exp2(dt * a2) * h + (dt * x) * B,
// y = sum_n h * C over four partial sums (n mod 4) added in fixed order.
template <int NP>
__device__ __forceinline__ float step(float (&h)[NP], const float (&a2)[NP],
                                      const Operands<NP>& in) {
  const float dtx = __fmul_rn(in.dt, in.x);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < NP / 4; ++q) {
    const float bv[4] = {in.b[q].x, in.b[q].y, in.b[q].z, in.b[q].w};
    const float cv[4] = {in.c[q].x, in.c[q].y, in.c[q].z, in.c[q].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int n = 4 * q + k;
      h[n] = __fmaf_rn(ex2(__fmul_rn(in.dt, a2[n])), h[n], __fmul_rn(dtx, bv[k]));
      acc[k] = __fmaf_rn(h[n], cv[k], acc[k]);
    }
  }
  return __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3]));
}

// Blocks of kMaxChannels threads that must fit on an SM at once: four
// keep B 8, di 8192 (512 blocks) in one wave on 132 SMs with up to 128
// registers a thread; the N = 32 instance needs more registers and gets
// three.
template <int NP>
constexpr int min_blocks() {
  return NP > 16 ? 3 : 4;
}

// Grid (ceil(di / cpb), B), cpb = blockDim.x threads, one per channel.
template <int NP>
__global__ void __launch_bounds__(kMaxChannels, min_blocks<NP>())
    ssm_scan_kernel(const Args p, const int vec_d, const int vec_n) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int cpb = blockDim.x, tid = threadIdx.x, N = p.N;
  const int b = blockIdx.y, d0 = blockIdx.x * cpb, d = d0 + tid;
  const int cols = min(cpb, p.di - d0);
  const bool live = tid < cols;
  const int sf = stage_floats(NP, cpb);

  // B and C columns [N, NP) of every stage are zeros for good: the copies
  // never write them.
  if (N < NP) {
    const int pad = NP - N;
    for (int i = tid; i < kStages * 2 * kSteps * pad; i += cpb) {
      const int row = i / pad, s = row / (2 * kSteps);
      smem[s * sf + 2 * kSteps * cpb + (row - s * 2 * kSteps) * NP + N + (i - row * pad)] = 0.f;
    }
  }

  float h[NP], a2[NP];
#pragma unroll
  for (int n = 0; n < NP; ++n) h[n] = a2[n] = 0.f;
  const size_t state = ((size_t)b * p.di + d) * N;
  if (live) {
    if (vec_n) {
#pragma unroll
      for (int n = 0; n < NP; n += 4) {
        if (n < N) {
          const float4 av = *reinterpret_cast<const float4*>(p.a + (size_t)d * N + n);
          const float4 hv = *reinterpret_cast<const float4*>(p.h0 + state + n);
          a2[n] = __fmul_rn(av.x, kLog2e), a2[n + 1] = __fmul_rn(av.y, kLog2e);
          a2[n + 2] = __fmul_rn(av.z, kLog2e), a2[n + 3] = __fmul_rn(av.w, kLog2e);
          h[n] = hv.x, h[n + 1] = hv.y, h[n + 2] = hv.z, h[n + 3] = hv.w;
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        if (n < N) {
          a2[n] = __fmul_rn(p.a[(size_t)d * N + n], kLog2e);
          h[n] = p.h0[state + n];
        }
      }
    }
  }

  const int n_stages = (p.S + kSteps - 1) / kSteps;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) load_stage<NP>(smem + s * sf, p, b, d0, cols, s * kSteps, cpb, vec_d, vec_n);
    cp_commit();
  }
  float* yp = p.y + (size_t)b * p.S * p.di + d;
  for (int c = 0; c < n_stages; ++c) {
    cp_wait<kStages - 2>();  // stage c has landed (this thread's copies)
    __syncthreads();         // ...and every thread's; stage c - 1 is done with
    const int nxt = c + kStages - 1;
    if (nxt < n_stages)
      load_stage<NP>(smem + (nxt % kStages) * sf, p, b, d0, cols, nxt * kSteps, cpb, vec_d,
                     vec_n);
    cp_commit();
    const float* st = smem + (c % kStages) * sf;
    const int t0 = c * kSteps, T = min(kSteps, p.S - t0);
    float* yt = yp + (size_t)t0 * p.di;
    if (T == kSteps) {
      // A whole stage: the next step's operands are read while this one
      // computes, and y stays in registers until the stage's last step.
      Operands<NP> in[2];
      float yv[kSteps];
      in[0].load(st, 0, cpb);
#pragma unroll
      for (int tt = 0; tt < kSteps; ++tt) {
        if (tt + 1 < kSteps) in[(tt + 1) & 1].load(st, tt + 1, cpb);
        yv[tt] = step<NP>(h, a2, in[tt & 1]);
      }
      if (live) {
#pragma unroll
        for (int tt = 0; tt < kSteps; ++tt) yt[(size_t)tt * p.di] = yv[tt];
      }
    } else {
      for (int tt = 0; tt < T; ++tt) {
        Operands<NP> in;
        in.load(st, tt, cpb);
        const float yv = step<NP>(h, a2, in);
        if (live) yt[(size_t)tt * p.di] = yv;
      }
    }
  }

  if (live) {
    float* ho = p.h_last + state;
    if (vec_n) {
#pragma unroll
      for (int n = 0; n < NP; n += 4)
        if (n < N)
          *reinterpret_cast<float4*>(ho + n) = make_float4(h[n], h[n + 1], h[n + 2], h[n + 3]);
    } else {
#pragma unroll
      for (int n = 0; n < NP; ++n)
        if (n < N) ho[n] = h[n];
    }
  }
}

// Every block fits the 48 KB a launch may take without opting in.
static_assert(smem_bytes(32, kMaxChannels) <= 48 * 1024, "stage ring too large");

template <int NP>
cudaError_t launch(const Args& p, int B, int cpb, int vec_d, int vec_n, cudaStream_t stream) {
  const dim3 grid((p.di + cpb - 1) / cpb, B);
  ssm_scan_kernel<NP><<<grid, cpb, smem_bytes(NP, cpb), stream>>>(p, vec_d, vec_n);
  return cudaGetLastError();
}

}  // namespace ssm
}  // namespace repro

// Launch as kernels/ssm_scan.py's scan_plan says: cpb channels per block
// (32, 64 or 128), and 16-byte copies of dt/x (vec_d: di % 4 == 0) and of
// B/C and the state rows (vec_n: N % 4 == 0), each only on 16-byte aligned
// tensors.  Returns a cudaError_t value.
extern "C" int ssm_scan_launch(const void* dt, const void* x, const void* bm, const void* cm,
                               const void* a, const void* h0, void* y, void* h_last, int B,
                               int S, int di, int N, int cpb, int vec_d, int vec_n,
                               void* stream) {
  using namespace repro::ssm;
  const auto misaligned = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) != 0; };
  if (B <= 0 || B > 65535 || S <= 0 || di <= 0 || N <= 0 || N > 32 ||
      (cpb != 32 && cpb != 64 && cpb != 128))
    return cudaErrorInvalidValue;
  if (vec_d && (di % 4 || misaligned(dt) || misaligned(x))) return cudaErrorInvalidValue;
  if (vec_n && (N % 4 || misaligned(bm) || misaligned(cm) || misaligned(a) || misaligned(h0) ||
                misaligned(h_last)))
    return cudaErrorInvalidValue;
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  const Args p{f(dt), f(x), f(bm), f(cm), f(a), f(h0), static_cast<float*>(y),
               static_cast<float*>(h_last), S, di, N};
  const auto st = static_cast<cudaStream_t>(stream);
  if (N <= 4) return launch<4>(p, B, cpb, vec_d, vec_n, st);
  if (N <= 8) return launch<8>(p, B, cpb, vec_d, vec_n, st);
  if (N <= 16) return launch<16>(p, B, cpb, vec_d, vec_n, st);
  return launch<32>(p, B, cpb, vec_d, vec_n, st);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
