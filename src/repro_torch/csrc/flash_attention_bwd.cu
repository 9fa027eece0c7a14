// FlashAttention backward for sm_90a: dq, dk and dv of flash_attention.cu's
// attention, from the forward's output and saved log-sum-exp.
//
// Replaces no pallas_call: the JAX package's VJP of flash_attention
// (src/repro/kernels/flash_attention.py:106-120, _flash_vjp_bwd) recomputes
// attention in jnp and differentiates that.  This computes the same gradient
// FlashAttention-2 style, for every mask the forward takes (causal with
// q_offset, sliding window, bidirectional with Sq != Sk, prefix-LM) and GQA
// through h / n_rep:
//   S  = Q K^T,  P = exp2(S * scale * log2 e - lse)   (a tile at a time;
//                                            lse in base 2, as the forward saves it)
//   dP = dO V^T,  D = rowsum(P * dP) / rowsum(P)   (the dq pass, per row)
//   dV += P^T dO,  dS = P * (dP - D)
//   dK += dS^T Q * scale,  dQ += dS K * scale.
// D is summed from the recomputed P in float32 and divided by its row sum,
// so that each row's dS sums to zero as the reference's softmax backward's
// does.  An error that scales a whole row of P or shifts its D (lse rounded
// to float32 at a row's large scores, S recomputed in another order than
// the forward's, or FlashAttention-2's rowsum(dO * O) with O rounded to
// bf16) otherwise enters dS as that factor times P D, against a dS of
// about (1 - max P) |dP| where attention is peaked: paligemma-3b's layers
// (mean row max P 0.997) read dQ and dK 4e-2 to 5e-2 off float64 without
// the division (PERF.md, C15).  It costs the dq pass a first walk of S and
// dP.
// Masked (query, key) pairs get P = 0 explicitly, so keys that no row
// reaches get zero gradients, and tiles outside every row's mask are skipped
// with the forward's tile_range (dq) and its inverse (dk, dv).
//
// Two launches, no atomics, so two runs give the same bits (the train
// step's graphed == eager, ZeRO-1 and restore contracts hold it bitwise):
// - the dq pass, a block a (batch, kv head, head group, 64 rows), the
//   forward's rows and grid: G heads of one kv group interleaved with the
//   query positions; it walks its key tiles in ascending order twice, first
//   summing D for its rows (and writing it), then forming dS and dQ;
// - the dk/dv pass, a block a (batch, kv head, key tile of BK keys), walking
//   the tiles of 64 rows that reach its keys in ascending order, the rows
//   being every query head of the group interleaved with the positions (row
//   r: position r / n_rep, head r % n_rep of the group): GQA's sum over the
//   n_rep heads happens inside the block, in that fixed order.
//
// bfloat16 at hd 64/128/256 runs on the tensor cores (mma.sync m16n8k16,
// operands by ldmatrix, .trans for the operands whose reduction runs along
// their rows; float32 accumulators in registers).  P is rounded to bf16 for
// dV, as the forward rounds it for O, and dS for dQ and dK:
// - dq pass: 4 warps, 16 rows each; Q and dO staged once, K/V tiles by
//   cp.async in the forward's two-stage ring (stage_keys), 64 keys a stage
//   (32 at hd 256, where dQ's 128 accumulators a thread bind the registers).
// - dk/dv pass: 8 warps; K and V of the block's keys staged once, Q and dO
//   tiles (with their rows' lse and D) by cp.async two stages deep.  For each
//   row tile, warp (kg, p) first computes S^T and dP^T for keys kg*16..+16
//   against row part p, writing P^T and dS^T (bf16) to shared memory; after a
//   barrier the same warp accumulates dV and dK for those keys over the whole
//   tile for head-dim part p.  BK = 64 keys (4 key groups x 2 parts) at hd 64
//   and 128; at hd 256 shared memory and registers bind (dK and dV for 16 keys
//   x 128 dims would take 128 accumulators a thread beside the staged tiles),
//   so BK = 32 (2 key groups x 4 parts of 64 dims), which also doubles the
//   blocks of MQA's one kv head: recurrentgemma-2b's B 1 x 4096 fills 128 of
//   the 132 SMs, paligemma-3b's B 8 x 288 72 (its 9 key tiles a sequence are
//   all there is without splitting the head group; the blocks' walks are
//   long, 8 heads x 288 rows, so the card runs at 72 of 132 SMs).
//
// Bound on the card (qwen1.5-4b's train shape, B 2 x 512, H 20, hd 128,
// causal): q, k, v, out, dO in and dq, dk, dv out are 36.7 MB, 0.011 ms at
// 3.35 TB/s, against 6.7 GFLOP (5 products of 2 hd flops a pair), 0.0068
// ms: bytes.  At recurrentgemma-2b's local attention (B 2 x 4096, 10 q heads
// over 1, hd 256, window 2048) the products bind (0.33 ms).
//
// float32, and bfloat16 at other head sizes, run a simple FMA route with
// 32 x 32 tiles from shared memory (the mesh's float32 train steps): the
// same two passes, a thread four rows (keys) of an element, the operand the
// four share staged transposed for 16-byte reads; held at 1e-4; its D is
// rowsum(dO * O), the same sum in float32.
#include "attention_mma.cuh"

namespace repro {
namespace bwd {

using mma::bf16;
constexpr float kLog2e = mma::kLog2e;
constexpr int kDkdvWarps = 8;
constexpr int kDkdvThreads = 32 * kDkdvWarps;
constexpr int kDkdvRows = 64;  // rows of one dk/dv row tile (bf16 route)
// Keys of a dq-pass tile (bf16 route): the forward's BLOCK_K, its tile
// range's grain, walked in stages of SB keys.
constexpr int kDqKeys = 64;
constexpr int kFmaTile = 32;   // rows and keys of the FMA route's tiles
constexpr int kFmaRb = 4;      // rows (keys) a thread of the FMA route sums at once

// Offset of row r's first element through a RowMap of rows of hd elements;
// divided by hd it is the row's index in (B, Sq, H), lse's and D's layout.
__device__ __forceinline__ size_t row_off(const RowMap& rm, int r, int hd) {
  return rm.base + (size_t)(r / rm.div) * rm.stride + (size_t)(r % rm.div) * hd;
}

// ------------------------------------------------------------ tensor cores
template <int HD, int SB>
__global__ void __launch_bounds__(mma::kThreads)
    flash_attention_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                      const bf16* __restrict__ v, const bf16* __restrict__ out,
                                      const float* __restrict__ lse,
                                      const bf16* __restrict__ dout, bf16* __restrict__ dq,
                                      float* __restrict__ dsum, int Sq, int Sk, int H, int KV,
                                      int G, int causal, int window, int q_offset, int prefix,
                                      float scale) {
  constexpr int bk = kDqKeys;
  constexpr int LD = HD + mma::kPad;
  constexpr int NT = HD / 8;
  constexpr int R = mma::kRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + R * LD;
  bf16* ring = dos + R * LD;  // 2 stages x (K, V) x SB keys
  int* kps = reinterpret_cast<int*>(ring + 4 * SB * LD);
  int2* spans = reinterpret_cast<int2*>(kps + 2 * SB);
  float* lm = reinterpret_cast<float*>(spans + 2);  // R: the rows' lse
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int n_rep = H / KV, groups = n_rep / G;
  const int bgh = blockIdx.x;
  const int b = bgh / (KV * groups), rest = bgh - b * KV * groups;
  const int g = rest / groups, hg = rest - g * groups;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * R;  // the deepest rows first, as the forward
  const int rows = min(R, Sq * G - r0);
  const int2 tr = tile_range(q_offset + r0 / G, q_offset + (r0 + rows - 1) / G, Sk, bk, causal,
                             window, prefix);
  const RowMap rm{((size_t)b * Sq * H + (size_t)g * n_rep + (size_t)hg * G) * HD, G,
                  (size_t)H * HD};
  const Mask mask{q_offset, G, causal, window, prefix};
  const ContigTiles tiles{((size_t)b * Sk * KV + g) * HD, (size_t)KV * HD, nullptr, Sk, bk};

  // Q and dO rows and the rows' log-sum-exp by cp.async.
  for (int i = tid; i < R * (HD / 8); i += mma::kThreads) {
    const int r = i / (HD / 8), c = i - r * (HD / 8);
    const bool ok = r < rows;
    const size_t off = ok ? row_off(rm, r0 + r, HD) + (size_t)c * 8 : 0;
    mma::cp_async16(qs + r * LD + c * 8, q + off, ok);
    mma::cp_async16(dos + r * LD + c * 8, dout + off, ok);
  }
  for (int r = tid; r < R; r += mma::kThreads) {
    if (r < rows) {
      mma::cp_async4(lm + r, lse + row_off(rm, r0 + r, HD) / HD);
    } else {
      lm[r] = 0.f;
    }
  }
  mma::cp_commit();
  const int per_tile = bk / SB;
  const int n = (tr.y - tr.x) * per_tile;  // stages

  const int rg = warp;
  const bool active = rg * 16 < rows;
  const int gq = lane >> 2, tq = lane & 3;
  const int ra = rg * 16 + gq;  // this thread's rows: ra and ra + 8
  const int pos0 = q_offset + (r0 + ra) / G, pos1 = q_offset + (r0 + ra + 8) / G;
  const float scale_log2 = scale * kLog2e;
  float M0 = 0.f, M1 = 0.f, D0 = 0.f, D1 = 0.f, P0 = 0.f, P1 = 0.f;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // Two walks over the key tiles: the first sums D = rowsum(P * dP) /
  // rowsum(P) (each thread over its keys, then its quad), the second forms
  // dS and dQ (see the note at the top).
  for (int walk = 0; walk < 2; ++walk) {
    if (walk == 1) {
#pragma unroll
      for (int o2 = 1; o2 <= 2; o2 <<= 1) {
        D0 += __shfl_xor_sync(0xffffffffu, D0, o2);
        D1 += __shfl_xor_sync(0xffffffffu, D1, o2);
        P0 += __shfl_xor_sync(0xffffffffu, P0, o2);
        P1 += __shfl_xor_sync(0xffffffffu, P1, o2);
      }
      D0 = P0 > 0.f ? D0 / P0 : 0.f;
      D1 = P1 > 0.f ? D1 / P1 : 0.f;
      if (active && tq == 0) {
        if (ra < rows) dsum[row_off(rm, r0 + ra, HD) / HD] = D0;
        if (ra + 8 < rows) dsum[row_off(rm, r0 + ra + 8, HD) / HD] = D1;
      }
    }
    if (n > 0)
      mma::stage_keys<HD>(ring, ring + SB * LD, kps, spans, k, v, tiles(tr.x), 0, SB);
    mma::cp_commit();
    for (int i = 0; i < n; ++i) {
      const int buf = i & 1;
      if (i + 1 < n) {
        const int nb = buf ^ 1;
        const int t = tr.x + (i + 1) / per_tile, u = (i + 1) % per_tile;
        mma::stage_keys<HD>(ring + nb * 2 * SB * LD, ring + (nb * 2 + 1) * SB * LD,
                            kps + nb * SB, spans + nb, k, v, tiles(t), u, SB);
      }
      mma::cp_commit();
      mma::cp_wait<1>();
      __syncthreads();
      if (walk == 0 && i == 0) {
        M0 = lm[ra];
        M1 = lm[ra + 8];
      }
      if (active) {
        const bf16* kt = ring + buf * 2 * SB * LD;
        const bf16* vt = kt + SB * LD;
        const int* kp = kps + buf * SB;
        float s[SB / 8][4], dp[SB / 8][4];
#pragma unroll
        for (int j = 0; j < SB / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        const bf16* qw = qs + rg * 16 * LD;
        const bf16* dw = dos + rg * 16 * LD;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t a[4], ad[4];
          mma::ldsm_x4(a, qw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
          mma::ldsm_x4(ad, dw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int np = 0; np < SB / 16; ++np) {
            const int off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8;
            uint32_t bk4[4], bv4[4];
            mma::ldsm_x4(bk4, kt + off);
            mma::ldsm_x4(bv4, vt + off);
            mma::mma16816(s[2 * np], a, bk4[0], bk4[1]);
            mma::mma16816(s[2 * np + 1], a, bk4[2], bk4[3]);
            mma::mma16816(dp[2 * np], ad, bv4[0], bv4[1]);
            mma::mma16816(dp[2 * np + 1], ad, bv4[2], bv4[3]);
          }
        }
        // A stage whose keys all pass the mask for the warp's 16 rows
        // skips the per-key test (the forward's test).
        const int2 sp = spans[buf];
        const int p_lo = mask.base + (r0 + rg * 16) / mask.div;
        const int p_hi = mask.base + (r0 + rg * 16 + 15) / mask.div;
        const bool dense = sp.x <= sp.y && sp.x >= 0 && (!mask.causal || sp.y <= p_lo) &&
                           (mask.window <= 0 || sp.x > p_hi - mask.window);
#pragma unroll
        for (int j = 0; j < SB / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok =
                dense || mask.at(e < 2 ? pos0 : pos1, kp[j * 8 + 2 * tq + (e & 1)]);
            const float p = ok ? exp2f(s[j][e] * scale_log2 - (e < 2 ? M0 : M1)) : 0.f;
            if (walk == 0) {
              if (e < 2) {
                D0 = fmaf(p, dp[j][e], D0);
                P0 += p;
              } else {
                D1 = fmaf(p, dp[j][e], D1);
                P1 += p;
              }
            } else {
              s[j][e] = p * (dp[j][e] - (e < 2 ? D0 : D1));  // dS
            }
          }
        if (walk == 1) {
#pragma unroll
          for (int kc = 0; kc < SB / 16; ++kc) {
            const uint32_t a[4] = {mma::pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                                   mma::pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                                   mma::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                                   mma::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
            for (int dp2 = 0; dp2 < HD / 16; ++dp2) {
              uint32_t b4[4];
              mma::ldsm_x4_t(b4, kt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                     dp2 * 16 + (lane >> 4) * 8);
              mma::mma16816(acc[2 * dp2], a, b4[0], b4[1]);
              mma::mma16816(acc[2 * dp2 + 1], a, b4[2], b4[3]);
            }
          }
        }
      }
      __syncthreads();
    }
  }
  mma::cp_wait<0>();
  if (!active) return;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int d = j * 8 + 2 * tq;
    if (ra < rows)
      *reinterpret_cast<uint32_t*>(dq + row_off(rm, r0 + ra, HD) + d) =
          mma::pack_bf16(acc[j][0] * scale, acc[j][1] * scale);
    if (ra + 8 < rows)
      *reinterpret_cast<uint32_t*>(dq + row_off(rm, r0 + ra + 8, HD) + d) =
          mma::pack_bf16(acc[j][2] * scale, acc[j][3] * scale);
  }
}

template <int HD, int BK>
struct DkdvPlan {
  static constexpr int BQ = kDkdvRows;
  static constexpr int KG = BK / 16;             // key groups of 16
  static constexpr int NP = kDkdvWarps / KG;     // parts: of a row tile, then of hd
  static constexpr int CW = BQ / NP;             // rows of a warp's S^T part
  static constexpr int DW = HD / NP;             // dims of a warp's dK/dV part
  static constexpr int LD = HD + mma::kPad;
  static constexpr int LP = BQ + mma::kPad;
  static_assert(KG * NP == kDkdvWarps && CW % 16 == 0 && DW % 16 == 0, "dk/dv warp split");
  // K, V; two stages of (Q, dO); P^T and dS^T; two stages of (the rows'
  // lse, D, positions).
  static constexpr size_t smem =
      (2 * (size_t)BK * LD + 4 * (size_t)BQ * LD + 2 * (size_t)BK * LP) * sizeof(bf16) +
      6 * (size_t)BQ * sizeof(float);
};

template <int HD, int BK>
__global__ void __launch_bounds__(kDkdvThreads)
    flash_attention_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                        const bf16* __restrict__ v,
                                        const float* __restrict__ lse,
                                        const bf16* __restrict__ dout,
                                        const float* __restrict__ dsum, bf16* __restrict__ dk,
                                        bf16* __restrict__ dv, int Sq, int Sk, int H, int KV,
                                        int causal, int window, int q_offset, int prefix,
                                        float scale) {
  using P = DkdvPlan<HD, BK>;
  constexpr int BQ = P::BQ, NP = P::NP, CW = P::CW, DW = P::DW, LD = P::LD, LP = P::LP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks_ = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs_ = ks_ + BK * LD;
  bf16* st = vs_ + BK * LD;  // stage s: Q at st + s * 2 * BQ * LD, dO after it
  bf16* ps = st + 4 * BQ * LD;
  bf16* dss = ps + BK * LP;  // dS^T
  float* rl = reinterpret_cast<float*>(dss + BK * LP);  // 2 x BQ lse
  float* rd = rl + 2 * BQ;                              // 2 x BQ D
  int* rpos = reinterpret_cast<int*>(rd + 2 * BQ);      // 2 x BQ positions
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int bg = blockIdx.x, b = bg / KV, g = bg - b * KV;
  const int t = blockIdx.y, key0 = t * BK, nk = min(BK, Sk - key0);
  const int n_rep = H / KV, n_rows = Sq * n_rep;
  const RowMap rm{((size_t)b * Sq * H + (size_t)g * n_rep) * HD, n_rep, (size_t)H * HD};
  const Mask mask{q_offset, n_rep, causal, window, prefix};
  const int2 ir = inverse_tile_range(t, n_rows, n_rep, BQ, q_offset, Sk, BK, causal, window,
                                     prefix);

  for (int i = tid; i < BK * (HD / 8); i += kDkdvThreads) {
    const int j = i / (HD / 8), c = i - j * (HD / 8);
    const bool ok = j < nk;
    const size_t off = (((size_t)b * Sk + key0 + (ok ? j : 0)) * KV + g) * HD + (size_t)c * 8;
    mma::cp_async16(ks_ + j * LD + c * 8, k + off, ok);
    mma::cp_async16(vs_ + j * LD + c * 8, v + off, ok);
  }
  // Row tile i into stage s: Q and dO rows, their lse and D (rows past the
  // end: zeros, and masked below).
  auto stage = [&](int s, int i) {
    bf16* qd = st + s * 2 * BQ * LD;
    bf16* dd = qd + BQ * LD;
    const int r0 = i * BQ;
    for (int e = tid; e < BQ * (HD / 8); e += kDkdvThreads) {
      const int r = e / (HD / 8), c = e - r * (HD / 8);
      const bool ok = r0 + r < n_rows;
      const size_t off = ok ? row_off(rm, r0 + r, HD) + (size_t)c * 8 : 0;
      mma::cp_async16(qd + r * LD + c * 8, q + off, ok);
      mma::cp_async16(dd + r * LD + c * 8, dout + off, ok);
    }
    for (int r = tid; r < BQ; r += kDkdvThreads) {
      rpos[s * BQ + r] = q_offset + (r0 + r) / n_rep;
      if (r0 + r < n_rows) {
        const size_t ri = row_off(rm, r0 + r, HD) / HD;
        mma::cp_async4(rl + s * BQ + r, lse + ri);
        mma::cp_async4(rd + s * BQ + r, dsum + ri);
      } else {
        rl[s * BQ + r] = rd[s * BQ + r] = 0.f;
      }
    }
  };
  const int n = max(0, ir.y - ir.x);
  if (n > 0) stage(0, ir.x);
  mma::cp_commit();

  const int kg = warp / NP, part = warp - kg * NP;
  const int gq = lane >> 2, tq = lane & 3;
  const int kr = kg * 16 + gq;  // this thread's keys: kr and kr + 8 of the tile
  const bool kok0 = kr < nk, kok1 = kr + 8 < nk;
  const float scale_log2 = scale * kLog2e;
  float dka[DW / 8][4], dva[DW / 8][4];
#pragma unroll
  for (int j = 0; j < DW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int it = 0; it < n; ++it) {
    const int buf = it & 1;
    if (it + 1 < n) stage(buf ^ 1, ir.x + it + 1);
    mma::cp_commit();
    mma::cp_wait<1>();
    __syncthreads();
    const int r0 = (ir.x + it) * BQ;
    const bf16* qd = st + buf * 2 * BQ * LD;
    const bf16* dd = qd + BQ * LD;
    const float* L = rl + buf * BQ;
    const float* Dr = rd + buf * BQ;
    const int* Rp = rpos + buf * BQ;
    {
      // S^T and dP^T: keys kg*16..+16 against rows part*CW..+CW.
      float s[CW / 8][4], dp[CW / 8][4];
#pragma unroll
      for (int j = 0; j < CW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4], av[4];
        mma::ldsm_x4(a, ks_ + (kg * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
        mma::ldsm_x4(av, vs_ + (kg * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < CW / 16; ++np) {
          const int off = (part * CW + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                          kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t bq4[4], bd4[4];
          mma::ldsm_x4(bq4, qd + off);
          mma::ldsm_x4(bd4, dd + off);
          mma::mma16816(s[2 * np], a, bq4[0], bq4[1]);
          mma::mma16816(s[2 * np + 1], a, bq4[2], bq4[3]);
          mma::mma16816(dp[2 * np], av, bd4[0], bd4[1]);
          mma::mma16816(dp[2 * np + 1], av, bd4[2], bd4[3]);
        }
      }
      // A part whose 16 keys all pass the mask for all its rows skips the
      // per-pair test.
      const int k_lo = key0 + kg * 16, k_hi = k_lo + 15, c0 = part * CW;
      const bool dense = k_hi < Sk && r0 + c0 + CW <= n_rows &&
                         (!causal || k_hi <= Rp[c0]) &&
                         (window <= 0 || k_lo > Rp[c0 + CW - 1] - window);
#pragma unroll
      for (int j = 0; j < CW / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = part * CW + j * 8 + 2 * tq + (e & 1);
          const bool ok = dense || (((e >> 1) ? kok1 : kok0) && r0 + col < n_rows &&
                                    mask.at(Rp[col], key0 + kr + (e >> 1) * 8));
          const float p = ok ? exp2f(s[j][e] * scale_log2 - L[col]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - Dr[col]);
        }
        const int c = part * CW + j * 8 + 2 * tq;
        *reinterpret_cast<uint32_t*>(ps + kr * LP + c) = mma::pack_bf16(s[j][0], s[j][1]);
        *reinterpret_cast<uint32_t*>(ps + (kr + 8) * LP + c) = mma::pack_bf16(s[j][2], s[j][3]);
        *reinterpret_cast<uint32_t*>(dss + kr * LP + c) = mma::pack_bf16(dp[j][0], dp[j][1]);
        *reinterpret_cast<uint32_t*>(dss + (kr + 8) * LP + c) =
            mma::pack_bf16(dp[j][2], dp[j][3]);
      }
    }
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q: keys kg*16..+16, dims part*DW..+DW.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t a[4], ad[4];
      mma::ldsm_x4(a, ps + (kg * 16 + (lane & 15)) * LP + kk * 16 + (lane >> 4) * 8);
      mma::ldsm_x4(ad, dss + (kg * 16 + (lane & 15)) * LP + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int dp2 = 0; dp2 < DW / 16; ++dp2) {
        const int off = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + part * DW +
                        dp2 * 16 + (lane >> 4) * 8;
        uint32_t bd4[4], bq4[4];
        mma::ldsm_x4_t(bd4, dd + off);
        mma::ldsm_x4_t(bq4, qd + off);
        mma::mma16816(dva[2 * dp2], a, bd4[0], bd4[1]);
        mma::mma16816(dva[2 * dp2 + 1], a, bd4[2], bd4[3]);
        mma::mma16816(dka[2 * dp2], ad, bq4[0], bq4[1]);
        mma::mma16816(dka[2 * dp2 + 1], ad, bq4[2], bq4[3]);
      }
    }
    __syncthreads();
  }
  mma::cp_wait<0>();
#pragma unroll
  for (int j = 0; j < DW / 8; ++j) {
    const int d = part * DW + j * 8 + 2 * tq;
    if (kok0) {
      const size_t off = (((size_t)b * Sk + key0 + kr) * KV + g) * HD + d;
      *reinterpret_cast<uint32_t*>(dk + off) =
          mma::pack_bf16(dka[j][0] * scale, dka[j][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off) = mma::pack_bf16(dva[j][0], dva[j][1]);
    }
    if (kok1) {
      const size_t off = (((size_t)b * Sk + key0 + kr + 8) * KV + g) * HD + d;
      *reinterpret_cast<uint32_t*>(dk + off) =
          mma::pack_bf16(dka[j][2] * scale, dka[j][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + off) = mma::pack_bf16(dva[j][2], dva[j][3]);
    }
  }
}

// ---------------------------------------------------------------- FMA route
// Both passes stage the operand that a thread's four rows (keys) share
// transposed, kFmaLdr floats a dimension, so that one 16-byte read gives the
// four values an FMA group needs: every inner step is two scalar reads (each
// conflict-free along the warp) and two 16-byte broadcasts for eight FMAs.
constexpr int kFmaLdr = kFmaTile + 4;
static_assert(kFmaRb == 4 && kFmaTile % kFmaRb == 0, "the FMA passes' float4 groups");

// Shared memory of the FMA route's passes, in bytes (kernels/flash_attention.py
// mirrors both).
inline size_t dq_fma_smem(int hd) {
  const size_t t = kFmaTile, r = kFmaLdr;
  return sizeof(float) * (2 * hd * r + t * hd + 2 * t * (hd + 1) + t * r + 2 * t) +
         sizeof(int) * t;
}

inline size_t dkdv_fma_smem(int hd) {
  const size_t t = kFmaTile, r = kFmaLdr;
  return sizeof(float) * (2 * hd * r + 2 * t * (hd + 1) + 2 * t * hd + 2 * t * r + 2 * t);
}

// The dq pass: a block a (q tile of 32 rows, batch * head), Q and dO staged
// transposed.  For each key tile a thread scores kFmaRb rows against one key
// (S and dP), then accumulates dQ for kFmaRb rows of one dimension from dS,
// which is staged transposed (key-major) for it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dq_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                      const T* __restrict__ v, const T* __restrict__ out,
                                      const float* __restrict__ lse, const T* __restrict__ dout,
                                      T* __restrict__ dq, float* __restrict__ dsum, int Sq,
                                      int Sk, int H, int KV, int hd, int causal, int window,
                                      int q_offset, int prefix, float scale) {
  constexpr int bq = kFmaTile, bk = kFmaTile, RB = kFmaRb, LR = kFmaLdr;
  extern __shared__ float smem[];
  const int ldt = hd + 1;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int g = h / (H / KV);
  const int q0 = blockIdx.x * bq;
  const int rows = min(bq, Sq - q0);
  const int first = q0 + q_offset;
  const int2 tr = tile_range(first, first + rows - 1, Sk, bk, causal, window, prefix);
  const RowMap rm{(((size_t)b * Sq + q0) * H + h) * hd, 1, (size_t)H * hd};
  const Mask mask{first, 1, causal, window, prefix};
  const ContigTiles tiles{((size_t)b * Sk * KV + g) * hd, (size_t)KV * hd, nullptr, Sk, bk};
  float* qT = smem;              // hd x LR: Q, transposed
  float* doT = qT + hd * LR;     // hd x LR: dO, transposed
  float* acc = doT + hd * LR;    // bq x hd: O, then dQ
  float* kt = acc + bq * hd;     // bk x (hd + 1)
  float* vt = kt + bk * ldt;     // bk x (hd + 1)
  float* dsT = vt + bk * ldt;    // bk x LR: dS, transposed
  float* ls = dsT + bk * LR;     // bq: the rows' lse
  float* dr = ls + bq;           // bq
  int* kp_s = reinterpret_cast<int*>(dr + bq);  // bk
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < bq * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    const bool ok = r < rows;
    const size_t off = row_off(rm, ok ? r : 0, hd) + d;
    qT[d * LR + r] = ok ? to_float(q[off]) : 0.f;
    doT[d * LR + r] = ok ? to_float(dout[off]) : 0.f;
    acc[i] = ok ? to_float(out[off]) : 0.f;
  }
  __syncthreads();
  for (int r = warp; r < rows; r += kWarps) {
    float dd = 0.f;
    for (int d = lane; d < hd; d += 32) dd = fmaf(acc[r * hd + d], doT[d * LR + r], dd);
    dd = warp_sum(dd);
    if (lane == 0) {
      const size_t ri = row_off(rm, r, hd) / hd;
      dr[r] = dd;
      dsum[ri] = dd;
      ls[r] = lse[ri];
    }
  }
  __syncthreads();
  for (int i = tid; i < bq * hd; i += kThreads) acc[i] = 0.f;
  const float scale_log2 = scale * kLog2e;

  for (int t = tr.x; t < tr.y; ++t) {
    const TileRef ref = tiles(t);
    load_tile<T>(kt, ldt, k, ref, bk, hd);
    load_tile<T>(vt, ldt, v, ref, bk, hd);
    for (int j = tid; j < bk; j += kThreads) kp_s[j] = j < ref.n ? ref.pos0 + j : -1;
    __syncthreads();
    for (int i = tid; i < (bq / RB) * bk; i += kThreads) {
      const int r0 = (i / bk) * RB, j = i % bk;
      const float* kr = kt + j * ldt;
      const float* vr = vt + j * ldt;
      float sd[RB] = {}, pd[RB] = {};
      for (int d = 0; d < hd; ++d) {
        const float kd = kr[d], vd = vr[d];
        const float4 qv = *reinterpret_cast<const float4*>(qT + d * LR + r0);
        const float4 ov = *reinterpret_cast<const float4*>(doT + d * LR + r0);
        sd[0] = fmaf(qv.x, kd, sd[0]);
        sd[1] = fmaf(qv.y, kd, sd[1]);
        sd[2] = fmaf(qv.z, kd, sd[2]);
        sd[3] = fmaf(qv.w, kd, sd[3]);
        pd[0] = fmaf(ov.x, vd, pd[0]);
        pd[1] = fmaf(ov.y, vd, pd[1]);
        pd[2] = fmaf(ov.z, vd, pd[2]);
        pd[3] = fmaf(ov.w, vd, pd[3]);
      }
      float dsv[RB];
#pragma unroll
      for (int u = 0; u < RB; ++u) {
        const int r = r0 + u;
        const float p = r < rows && mask(r, kp_s[j]) ? exp2f(sd[u] * scale_log2 - ls[r]) : 0.f;
        dsv[u] = r < rows ? p * (pd[u] - dr[r]) : 0.f;
      }
      *reinterpret_cast<float4*>(dsT + j * LR + r0) = make_float4(dsv[0], dsv[1], dsv[2], dsv[3]);
    }
    __syncthreads();
    for (int i = tid; i < (bq / RB) * hd; i += kThreads) {
      const int r0 = (i / hd) * RB, d = i % hd;
      float a[RB];
#pragma unroll
      for (int u = 0; u < RB; ++u) a[u] = acc[(r0 + u) * hd + d];
      for (int j = 0; j < bk; ++j) {
        const float kd = kt[j * ldt + d];
        const float4 sv = *reinterpret_cast<const float4*>(dsT + j * LR + r0);
        a[0] = fmaf(sv.x, kd, a[0]);
        a[1] = fmaf(sv.y, kd, a[1]);
        a[2] = fmaf(sv.z, kd, a[2]);
        a[3] = fmaf(sv.w, kd, a[3]);
      }
#pragma unroll
      for (int u = 0; u < RB; ++u) acc[(r0 + u) * hd + d] = a[u];
    }
    __syncthreads();
  }
  for (int i = tid; i < rows * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    dq[row_off(rm, r, hd) + d] = from_float<T>(acc[i] * scale);
  }
}

// The dk/dv pass: a block a (key tile of 32 keys, batch * kv head), K and V
// staged transposed, walking the row tiles (n_rep heads interleaved with the
// positions) that reach it.  For each row tile a thread scores one row
// against kFmaRb keys (S and dP), then accumulates dK and dV for kFmaRb keys
// of one dimension.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dkdv_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                        const T* __restrict__ v, const float* __restrict__ lse,
                                        const T* __restrict__ dout,
                                        const float* __restrict__ dsum, T* __restrict__ dk,
                                        T* __restrict__ dv, int Sq, int Sk, int H, int KV,
                                        int hd, int causal, int window, int q_offset, int prefix,
                                        float scale) {
  constexpr int bq = kFmaTile, bk = kFmaTile, RB = kFmaRb, LR = kFmaLdr;
  extern __shared__ float smem[];
  const int ldt = hd + 1;
  const int bg = blockIdx.y, b = bg / KV, g = bg - b * KV;
  const int t = blockIdx.x, key0 = t * bk;
  const int n_rep = H / KV, n_rows = Sq * n_rep;
  const RowMap rm{((size_t)b * Sq * H + (size_t)g * n_rep) * hd, n_rep, (size_t)H * hd};
  const Mask mask{q_offset, n_rep, causal, window, prefix};
  const ContigTiles tiles{((size_t)b * Sk * KV + g) * hd, (size_t)KV * hd, nullptr, Sk, bk};
  const TileRef ref = tiles(t);
  const int2 ir = inverse_tile_range(t, n_rows, n_rep, bq, q_offset, Sk, bk, causal, window,
                                     prefix);
  float* kT = smem;              // hd x LR: K, transposed
  float* vT = kT + hd * LR;      // hd x LR: V, transposed
  float* qs = vT + hd * LR;      // bq x (hd + 1)
  float* dos = qs + bq * ldt;    // bq x (hd + 1)
  float* dka = dos + bq * ldt;   // bk x hd
  float* dva = dka + bk * hd;    // bk x hd
  float* ps = dva + bk * hd;     // bq x LR
  float* ds = ps + bq * LR;      // bq x LR
  float* ls = ds + bq * LR;      // bq: the rows' lse
  float* dr = ls + bq;           // bq
  const int tid = threadIdx.x;
  const float scale_log2 = scale * kLog2e;

  for (int i = tid; i < bk * hd; i += kThreads) {
    const int j = i / hd, d = i - j * hd;
    const bool ok = j < ref.n;
    const size_t off = ref.base + (size_t)(ok ? j : 0) * ref.stride + d;
    kT[d * LR + j] = ok ? to_float(k[off]) : 0.f;
    vT[d * LR + j] = ok ? to_float(v[off]) : 0.f;
    dka[i] = dva[i] = 0.f;
  }
  for (int it = ir.x; it < ir.y; ++it) {
    const int r0 = it * bq, rows = min(bq, n_rows - r0);
    __syncthreads();
    for (int i = tid; i < bq * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      const bool ok = r < rows;
      const size_t off = row_off(rm, r0 + (ok ? r : 0), hd) + d;
      qs[r * ldt + d] = ok ? to_float(q[off]) : 0.f;
      dos[r * ldt + d] = ok ? to_float(dout[off]) : 0.f;
    }
    for (int r = tid; r < rows; r += kThreads) {
      const size_t ri = row_off(rm, r0 + r, hd) / hd;
      ls[r] = lse[ri];
      dr[r] = dsum[ri];
    }
    __syncthreads();
    for (int i = tid; i < bq * (bk / RB); i += kThreads) {
      const int r = i / (bk / RB), jb = (i % (bk / RB)) * RB;
      const float* qr = qs + r * ldt;
      const float* orow = dos + r * ldt;
      float sd[RB] = {}, pd[RB] = {};
      for (int d = 0; d < hd; ++d) {
        const float qd = qr[d], od = orow[d];
        const float4 kv4 = *reinterpret_cast<const float4*>(kT + d * LR + jb);
        const float4 vv4 = *reinterpret_cast<const float4*>(vT + d * LR + jb);
        sd[0] = fmaf(qd, kv4.x, sd[0]);
        sd[1] = fmaf(qd, kv4.y, sd[1]);
        sd[2] = fmaf(qd, kv4.z, sd[2]);
        sd[3] = fmaf(qd, kv4.w, sd[3]);
        pd[0] = fmaf(od, vv4.x, pd[0]);
        pd[1] = fmaf(od, vv4.y, pd[1]);
        pd[2] = fmaf(od, vv4.z, pd[2]);
        pd[3] = fmaf(od, vv4.w, pd[3]);
      }
      float pv[RB], dsv[RB];
#pragma unroll
      for (int u = 0; u < RB; ++u) {
        const int j = jb + u;
        pv[u] = r < rows && j < ref.n && mask(r0 + r, key0 + j)
                    ? exp2f(sd[u] * scale_log2 - ls[r]) : 0.f;
        dsv[u] = r < rows ? pv[u] * (pd[u] - dr[r]) : 0.f;
      }
      *reinterpret_cast<float4*>(ps + r * LR + jb) = make_float4(pv[0], pv[1], pv[2], pv[3]);
      *reinterpret_cast<float4*>(ds + r * LR + jb) = make_float4(dsv[0], dsv[1], dsv[2], dsv[3]);
    }
    __syncthreads();
    for (int i = tid; i < (bk / RB) * hd; i += kThreads) {
      const int jb = (i / hd) * RB, d = i % hd;
      float a[RB], c[RB];
#pragma unroll
      for (int u = 0; u < RB; ++u) {
        a[u] = dva[(jb + u) * hd + d];
        c[u] = dka[(jb + u) * hd + d];
      }
      for (int r = 0; r < rows; ++r) {
        const float od = dos[r * ldt + d], qd = qs[r * ldt + d];
        const float4 p4 = *reinterpret_cast<const float4*>(ps + r * LR + jb);
        const float4 s4 = *reinterpret_cast<const float4*>(ds + r * LR + jb);
        a[0] = fmaf(p4.x, od, a[0]);
        a[1] = fmaf(p4.y, od, a[1]);
        a[2] = fmaf(p4.z, od, a[2]);
        a[3] = fmaf(p4.w, od, a[3]);
        c[0] = fmaf(s4.x, qd, c[0]);
        c[1] = fmaf(s4.y, qd, c[1]);
        c[2] = fmaf(s4.z, qd, c[2]);
        c[3] = fmaf(s4.w, qd, c[3]);
      }
#pragma unroll
      for (int u = 0; u < RB; ++u) {
        dva[(jb + u) * hd + d] = a[u];
        dka[(jb + u) * hd + d] = c[u];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < ref.n * hd; i += kThreads) {
    const int j = i / hd, d = i - j * hd;
    const size_t off = ref.base + (size_t)j * ref.stride + d;
    dk[off] = from_float<T>(dka[i] * scale);
    dv[off] = from_float<T>(dva[i]);
  }
}

// ------------------------------------------------------------------ launches
template <int HD, int SB, int BK>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* out,
                       const float* lse, const void* dout, void* dq, void* dk, void* dv,
                       float* dsum, int B, int Sq, int Sk, int H, int KV, int causal,
                       int window, int q_offset, int prefix, float scale, cudaStream_t stream) {
  constexpr int LD = HD + mma::kPad;
  const int G = mma::heads_per_block(H / KV);
  const dim3 grid_dq(B * KV * (H / KV / G), (Sq * G + mma::kRows - 1) / mma::kRows);
  const dim3 grid_kv(B * KV, (Sk + BK - 1) / BK);
  if (grid_dq.y > 65535 || grid_kv.y > 65535) return cudaErrorInvalidValue;
  const size_t smem_dq = (2 * (size_t)mma::kRows * LD + 4 * (size_t)SB * LD) * sizeof(bf16) +
                         2 * SB * sizeof(int) + 2 * sizeof(int2) +
                         (size_t)mma::kRows * sizeof(float);
  const size_t smem_kv = DkdvPlan<HD, BK>::smem;
  auto kdq = flash_attention_bwd_dq_mma_kernel<HD, SB>;
  auto kkv = flash_attention_bwd_dkdv_mma_kernel<HD, BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return err;
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* dob = static_cast<const bf16*>(dout);
  kdq<<<grid_dq, mma::kThreads, smem_dq, stream>>>(
      qb, kb, vb, static_cast<const bf16*>(out), lse, dob, static_cast<bf16*>(dq), dsum, Sq, Sk,
      H, KV, G, causal, window, q_offset, prefix, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kkv<<<grid_kv, kDkdvThreads, smem_kv, stream>>>(qb, kb, vb, lse, dob, dsum,
                                                   static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                                                   Sq, Sk, H, KV, causal, window, q_offset,
                                                   prefix, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma(const void* q, const void* k, const void* v, const void* out,
                       const float* lse, const void* dout, void* dq, void* dk, void* dv,
                       float* dsum, int B, int Sq, int Sk, int H, int KV, int hd, int causal,
                       int window, int q_offset, int prefix, float scale, cudaStream_t stream) {
  const dim3 grid_dq((Sq + kFmaTile - 1) / kFmaTile, B * H);
  const dim3 grid_kv((Sk + kFmaTile - 1) / kFmaTile, B * KV);
  if (grid_dq.y > 65535 || grid_kv.y > 65535) return cudaErrorInvalidValue;
  const size_t smem_dq = dq_fma_smem(hd), smem_kv = dkdv_fma_smem(hd);
  if (smem_dq > kMaxSmem || smem_kv > kMaxSmem) return cudaErrorInvalidValue;
  auto kdq = flash_attention_bwd_dq_fma_kernel<T>;
  auto kkv = flash_attention_bwd_dkdv_fma_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  kdq<<<grid_dq, kThreads, smem_dq, stream>>>(
      qt, kt, vt, static_cast<const T*>(out), lse, dot, static_cast<T*>(dq), dsum, Sq, Sk, H, KV,
      hd, causal, window, q_offset, prefix, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kkv<<<grid_kv, kThreads, smem_kv, stream>>>(
      qt, kt, vt, lse, dot, dsum, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, KV, hd,
      causal, window, q_offset, prefix, scale);
  return cudaGetLastError();
}

}  // namespace bwd
}  // namespace repro

// dq, dk, dv (the shapes and dtype of q, k, v) of flash_attention_launch's
// attention at dout, from its output and lse ((B, Sq, H) float32: the rows'
// log-sum-exp of their scaled scores in base 2); dsum is
// (B, Sq, H) float32 scratch for D.  dtype codes: 0 = float32, 1 =
// bfloat16.  bfloat16 at hd 64/128/256 runs the tensor-core passes,
// everything else the FMA passes.  Returns a cudaError_t value.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* out, const float* lse, const void* dout,
                                          void* dq, void* dk, void* dv, float* dsum, int B,
                                          int Sq, int Sk, int H, int KV, int hd, int causal,
                                          int window, int q_offset, int prefix, float scale,
                                          int dtype, void* stream) {
  using namespace repro;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || prefix < 0)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && (hd == 64 || hd == 128 || hd == 256)) {
    if (hd == 64)
      return bwd::launch_mma<64, 64, 64>(q, k, v, out, lse, dout, dq, dk, dv, dsum, B, Sq, Sk,
                                         H, KV, causal, window, q_offset, prefix, scale, st);
    if (hd == 128)
      return bwd::launch_mma<128, 64, 64>(q, k, v, out, lse, dout, dq, dk, dv, dsum, B, Sq, Sk,
                                          H, KV, causal, window, q_offset, prefix, scale, st);
    return bwd::launch_mma<256, 32, 32>(q, k, v, out, lse, dout, dq, dk, dv, dsum, B, Sq, Sk, H,
                                        KV, causal, window, q_offset, prefix, scale, st);
  }
  if (dtype == 1)
    return bwd::launch_fma<__nv_bfloat16>(q, k, v, out, lse, dout, dq, dk, dv, dsum, B, Sq, Sk,
                                          H, KV, hd, causal, window, q_offset, prefix, scale, st);
  if (dtype == 0)
    return bwd::launch_fma<float>(q, k, v, out, lse, dout, dq, dk, dv, dsum, B, Sq, Sk, H, KV,
                                  hd, causal, window, q_offset, prefix, scale, st);
  return cudaErrorInvalidValue;
}
