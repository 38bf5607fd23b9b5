// Backward of the Mamba2 SSD intra-chunk step on the TF32 tensor cores of
// Hopper (sm_90a), fp32 accuracy, plain C interface.
//
// Replaces: no TPU kernel. The JAX package trains through the XLA version of
// the step (src/repro/models/ssm.py:22, SSD_CHUNK_IMPL = "xla"); this is the
// backward of csrc/ssd_chunk.cu, which replaces
// src/repro/kernels/ssd_chunk.py::ssd_chunk_pallas. For every chunk g and
// head h, with cum_i = sum_{k<=i} dA_k, L_ij = exp(cum_i - cum_j) [i >= j],
// S_ij = C_i . B_j (shared by the heads), M = L o S and
// e_j = exp(cum_{Q-1} - cum_j), the forward is Y_i = sum_j M_ij xw_j and
// S_chunk = sum_j e_j xw_j (x) B_j. Given dY and dS (the gradient of
// S_chunk):
//
//   U_j      = dS . B_j                                   [P]
//   dxw_j    = sum_{i>=j} M_ij dY_i + e_j U_j
//   dM_ij    = dY_i . xw_j,  R_ij = dM_ij M_ij,  T_j = e_j (xw_j . U_j)
//   dScr_ij  = sum_h dM_ij L_ij                           (over the heads)
//   dC_i     = sum_j dScr_ij B_j
//   dB_j     = sum_i dScr_ij C_i + sum_h e_j sum_p xw_j[p] dS[p, :]
//   d dA_m   = sum_{i>=m} sum_{j<m} R_ij + sum_{j<m} T_j
//
// The last line is the reverse cumsum of dcum_i = sum_{j<=i} R_ij -
// sum_{k>=i} R_ki - T_i + [i = Q-1] sum_j T_j written without its
// differences: a position m moves the decay of exactly the pairs that
// straddle it (i >= m > j) and the state weight of the keys before it. So
// no large row and column sums cancel, and d dA_0 is 0 by construction.
//
// What bounds it on this card: operations. At Mamba2-2.7B's training call
// (G 16 chunks of Q 256, H 80 heads of P 64, N 128) the backward does four
// products a head (U and the state term, Q.P.N each; dxw and dM, Q^2/2.P
// each) and three a chunk (the scores again, dC, dB; Q^2/2.N each): 21.9
// GFLOP on 305 MB of inputs and outputs. At the 495 TFLOP/s of the TF32
// tensor cores that is 0.044 ms, and 0.133 ms for the three passes that
// fp32 accuracy takes (below); 0.327 ms on the 67 TFLOP/s fp32 cores; 0.091
// ms for the bytes at 3.35 TB/s. mma.sync issues from each warp with its
// operands in registers, so the A operand's hi/lo splits, the decay's
// exponentials and the fragment loads share the issue slots with the MMAs:
// issue slots, under the tensor cores' rate, are what bound this design.
//
// What the design does about it (the house design of ssd_chunk.cu and
// flash_attention_bwd.cu, with the pieces of tensor_core.cuh):
//  * Every product is mma.sync.m16n8k8 TF32 with fp32 accumulators, each
//    fp32 operand split hi + lo and the product taken as lo.hi + hi.lo +
//    hi.hi (3xTF32): one TF32 pass misses fp32 tolerance
//    (tests/test_torch_ssd_bwd_numerics.py). A block is 4 warps and owns a
//    64 x 64 output tile, warp w rows 16w .. 16w + 15, all 64 columns.
//  * The tensor cores truncate as they accumulate, so every product sums
//    each 32-deep stage of its contraction from zero and adds it to the
//    running sum in fp32 (which rounds to nearest). The long contractions
//    are M^T dY over up to Q rows, dC and dB over a chunk, and dB's state
//    term over (heads of a split) x P, 1280 deep at Mamba2 and 4096 at
//    Jamba-1.5-Large's published shape: one accumulator there drifts toward
//    zero by up to ~3e-5 x max (the numerics test).
//  * Operand tiles arrive through a two-stage cp.async ring (16-byte
//    copies; 8 or 4 bytes where a row is not 16-byte aligned, as xw / dY
//    rows at P 21, 37 or 72): stage s + 1 loads while stage s computes. Rows
//    past Q and columns past P or N are zero-filled by the copy (src-size
//    0), so ragged edges need no masks in the products.
//  * B-operand tiles are split into hi/lo once a stage for the whole block,
//    key pairs 2k, 2k + 1 side by side (a lane reads both keys' hi and lo
//    with one 16-byte load), as ssd_chunk.cu's split_tile. A operands are
//    read as A slot t = key 2t, slot t + 4 = key 2t + 1 (the k order of a
//    product is free), along a row (8-byte pairs, rows padded to 40 floats)
//    or down a column (rows padded to 68), on distinct banks.
//  * The decay lives in registers: dxw's A operand (M^T, read down the
//    score tile's columns) and pairs' accumulator (dM) are multiplied by
//    L_ij = exp(cum_i - cum_j), cum kept as the double scan's hi + lo pair,
//    with the mask in the exponent (j > i or i >= Q gives exp(-inf) = 0):
//    the kernel never forms exp of the upper triangle, which overflows to
//    inf once a chunk decays past e^88, and inf times a 0 mask is NaN.
//  * The pairs launch reduces R from its accumulators: row sums by quad
//    shuffles, column sums by shuffles over the 8 lane groups and a fixed
//    walk over the 4 warps, then warp scans for the prefixes and suffixes
//    that the d dA sums take; on a diagonal tile, the rows' exclusive
//    prefixes by quad scans, masked to the lower triangle, then column
//    sums. No shared tile of R and no single-thread loop.
//  * No atomics: every sum has an order fixed by the shape, so two
//    launches on the same inputs give the same bits. Seven launches on the
//    caller's stream (six with one head group):
//      1. cum: each (chunk, head)'s prefix sums of dA, scanned in double
//         and kept as a pair of floats hi + lo (as the forward keeps them);
//      2. scores: C . B^T of each chunk, its 64 x 64 tiles on and below the
//         diagonal, into a scratch [G, Qp, Qp] (Qp = Q rounded up to 64);
//      3. dxw: a block per (key tile, chunk, head) forms U and T for its
//         keys and walks the rows at or below them for M^T dY;
//      4. pairs: a block per (chunk, tile pair, group of heads) forms dM,
//         then for each head of the group adds dM o L to the pair's score
//         gradient (one partial a group) and reduces R to the sums that
//         launch 7 needs for the straddling pairs: column-prefix, row-suffix
//         and the total (on the diagonal tile, the straddle sum itself);
//      5. dscr: the groups' partials summed in group order, once, into the
//         first group's slot (skipped with one group);
//      6. dB / dC: dC and dB from the summed score gradient; the dB blocks
//         also take the state term, a contraction over (head, P) that each
//         block runs for one split of the heads into its own partial;
//      7. d dA from the pair sums and the prefix of T (summed in double),
//         and dB from its head-split partials.
//    The head groups of launch 4 and the head splits of launch 6 are chosen
//    by the caller from the shape alone.
//  * Occupancy. 128 threads a block; 56.5 KB of dynamic shared memory a
//    product launch (the ring and the split tile), 74.8 KB for pairs, which
//    keeps its group's score gradient there: the lane's own elements,
//    registers being the scarcer. ptxas (-Xptxas -v, sm_90a; chip_smoke.py
//    prints it): scores 154 registers, dxw 168 (its stages' k8 steps
//    unrolled by 2), pairs 168, all three blocks an SM; dbdc 232, two
//    blocks an SM (faster than three at 168, which spilled); no spills and
//    no stack in any launch.
//
// What wgmma + TMA would add: wgmma issues a 64-row product per warpgroup
// from shared memory, the only way to the full TF32 rate, and would take
// the hi/lo splits and fragment loads off the issue slots; a producer warp
// would keep a TMA ring full. wgmma reads a TF32 B operand only K-major, so
// the products whose B runs along the contraction's rows (dY, B, C and dS
// tiles) would need a transposed tile in shared memory; dxw's and the state
// term's A operands, scaled by the decay in registers, can stay in
// registers, which wgmma accepts for A.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kT = 16 * kWarps;        // tile: output rows and columns, positions
constexpr int kNF = kT / 8;            // n8 fragments a warp
constexpr int kStep = 32;              // contraction a ring stage
constexpr int kKS = kStep / 8;         // k8 steps a stage
constexpr int kStages = 2;             // cp.async ring depth
constexpr int kSP = kStep + 8;         // row stride, rows of a stage read as 8-byte pairs
constexpr int kSR = kT + 4;            // row stride, rows read at 2t and 2t + 1
constexpr int kSH = kT + 2;            // float4s a key-pair row of a split tile
constexpr int kPart = 132;             // floats a (pair, head): jv, iv, tot
constexpr int kMaxQ = 4096;            // chunk length
constexpr int kMaxTiles = kMaxQ / kT;
constexpr int kFinalThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// a ring stage: the A tile (along rows: [kT][kSP]; down columns: [kStep][kSR])
// then the raw B tile (rows of the contraction: [kStep][kT]; columns of the
// output, the contraction along each: [kT][kSP])
constexpr int kStageA = kT * kSP;
constexpr int kStageB = kT * kSP;
static_assert(kStep * kSR <= kStageA && kStep * kT <= kStageB, "stage fits");
constexpr int kStage = kStageA + kStageB;
constexpr size_t kSmemRing =
    sizeof(float) * kStages * kStage + sizeof(float4) * (kStep / 2) * kSH;

__host__ __device__ __forceinline__ int tiles(int q) { return (q + kT - 1) / kT; }

// (I, J <= I) of pair p = I (I + 1) / 2 + J
__device__ __forceinline__ void pair_tiles(int p, int& I, int& J) {
  I = 0;
  while (p > I) p -= ++I;
  J = p;
}

// exp(cum_i - cum_j) from the hi + lo pairs, 0 unless `keep`: the mask is
// taken in the exponent, so no exp of the upper triangle is ever formed
__device__ __forceinline__ float decay(bool keep, float hi_i, float lo_i,
                                       float hi_j, float lo_j) {
  const float rel = (hi_i - hi_j) + (lo_i - lo_j);
  return exp2f(keep ? rel * kLog2e : -CUDART_INF_F);
}

// Rows [0, nrows) of W floats into dst (stride ds) by cp.async. Row r comes
// from src(r), or is zero where src(r) is null; columns at or past lim are
// zero. vec: bytes a copy (16, 8 or 4), which every source row, `base` and
// 4 * lim are aligned to.
template <int W, typename Src>
__device__ __forceinline__ void copy_rows(float* dst, int ds, int nrows,
                                          int vec, int lim, const float* base,
                                          Src src) {
  const int per = vec >> 2, cpr = W / per;  // copies a row
  for (int i = threadIdx.x; i < nrows * cpr; i += kThreads) {
    const int r = i / cpr, c = (i - r * cpr) * per;
    const float* s = src(r);
    const bool ok = s != nullptr && c < lim;
    float* d = dst + r * ds + c;
    const float* from = ok ? s + c : base;
    if (vec == 16)
      cp_async<16>(d, from, ok);
    else if (vec == 8)
      cp_async<8>(d, from, ok);
    else
      cp_async<4>(d, from, ok);
  }
}

// A raw B tile split once for the whole block: hl[k][c] = {hi(b[2k][c]),
// hi(b[2k+1][c]), lo(b[2k][c]), lo(b[2k+1][c])} in rows of kSH float4s
// (kSH = 2 mod 8: the 16-byte loads of a warp, 4 key pairs x 8 columns, hit
// distinct banks). split_rows: b holds the contraction's rows, [kStep][kT];
// split_cols: b holds the output's columns, [kT][kSP].
__device__ __forceinline__ void split_rows(const float* b, float4* hl) {
  for (int i = threadIdx.x; i < (kStep / 2) * kT; i += kThreads) {
    const int kp = i / kT, c = i - kp * kT;
    uint32_t h0, l0, h1, l1;
    frag<true>(b[2 * kp * kT + c], h0, l0);
    frag<true>(b[(2 * kp + 1) * kT + c], h1, l1);
    hl[kp * kSH + c] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                                   __uint_as_float(l0), __uint_as_float(l1));
  }
}
__device__ __forceinline__ void split_cols(const float* b, float4* hl) {
  for (int i = threadIdx.x; i < (kStep / 2) * kT; i += kThreads) {
    const int kp = i % (kStep / 2), c = i / (kStep / 2);
    const float2 v = *reinterpret_cast<const float2*>(b + c * kSP + 2 * kp);
    uint32_t h0, l0, h1, l1;
    frag<true>(v.x, h0, l0);
    frag<true>(v.y, h1, l1);
    hl[kp * kSH + c] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                                   __uint_as_float(l0), __uint_as_float(l1));
  }
}

// The A fragment of k8 step kk: x = rows g, g + 8 at key 2t, then rows g,
// g + 8 at key 2t + 1 (slots t and t + 4). row_frag reads a tile along its
// rows ([kT][kSP], 8-byte pairs), col_frag down its columns ([kStep][kSR]).
__device__ __forceinline__ void row_frag(const float* a, int kk,
                                         float (&x)[4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* p = a + (warp * 16 + (lane >> 2)) * kSP + 2 * (lane & 3) + 8 * kk;
  const float2 r0 = *reinterpret_cast<const float2*>(p);
  const float2 r1 = *reinterpret_cast<const float2*>(p + 8 * kSP);
  x[0] = r0.x;
  x[1] = r1.x;
  x[2] = r0.y;
  x[3] = r1.y;
}
__device__ __forceinline__ void col_frag(const float* a, int kk,
                                         float (&x)[4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* p = a + (8 * kk + 2 * (lane & 3)) * kSR + warp * 16 + (lane >> 2);
  x[0] = p[0];
  x[1] = p[8];
  x[2] = p[kSR];
  x[3] = p[kSR + 8];
}

// acc += one ring stage's product: A fragments from afrag(kk, x), B from
// the split tile hl, over kNF n8 fragments (the first nf live). The stage is
// summed from zero and then added to acc in fp32: the tensor cores truncate
// as they accumulate. kUnroll: k8 steps unrolled (dxw takes 2, which keeps
// it under three blocks' 168 registers without a spill).
template <int kUnroll, typename AFrag>
__device__ __forceinline__ void stage_mma(float (&acc)[kNF][4],
                                          const float4* hl, int nf,
                                          AFrag afrag) {
  const int lane = threadIdx.x & 31;
  const float4* b0 = hl + (lane & 3) * kSH + (lane >> 2);
  float part[kNF][4];
#pragma unroll
  for (int n = 0; n < kNF; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
#pragma unroll kUnroll
  for (int kk = 0; kk < kKS; ++kk) {
    float x[4];
    afrag(kk, x);
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) frag<true>(x[i], ah[i], al[i]);
#pragma unroll
    for (int n = 0; n < kNF; ++n) {
      if (n < nf) {
        const float4 v = b0[4 * kk * kSH + n * 8];
        const uint32_t bh[2] = {__float_as_uint(v.x), __float_as_uint(v.y)};
        const uint32_t bl[2] = {__float_as_uint(v.z), __float_as_uint(v.w)};
        mma3<true, true>(part[n], ah, al, bh, bl);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < kNF; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}

__device__ __forceinline__ void zero(float (&acc)[kNF][4]) {
#pragma unroll
  for (int n = 0; n < kNF; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// The two-stage cp.async ring over `steps` stages: load(s, buf) issues
// stage s's copies into ring buffer buf, body(s, buf) runs (every thread)
// once they have arrived; stage s + 1 loads while stage s computes.
template <typename Load, typename Body>
__device__ __forceinline__ void ring(int steps, Load load, Body body) {
  if (steps <= 0) return;
  load(0, 0);
  cp_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) load(s + 1, (s + 1) & 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    body(s, s & 1);
    __syncthreads();  // the next stage's copies overwrite this one
  }
  cp_wait<0>();
}

// acc[n][e] -> out rows r0 + 16w + g + 8 (e >> 1) < rows, columns c0 + 8n +
// 2t + (e & 1) < cols, row stride ld
__device__ __forceinline__ void store_tile(const float (&acc)[kNF][4],
                                           float* out, size_t ld, int r0,
                                           int rows, int c0, int cols) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + warp * 16 + (lane >> 2) + 8 * hh;
    if (r >= rows) continue;
    float* row = out + static_cast<size_t>(r) * ld;
#pragma unroll
    for (int n = 0; n < kNF; ++n) {
      const int c = c0 + n * 8 + 2 * (lane & 3);
      if (c < cols) row[c] = acc[n][2 * hh];
      if (c + 1 < cols) row[c + 1] = acc[n][2 * hh + 1];
    }
  }
}

// ------------------------------------------------------------------ 1. cum
// cumh + cuml = the prefix sums of dA[g, :, h] in double, as two floats, at
// [(g H + h) Qp + i]; 0 on [Q, Qp). A warp a (chunk, head).
__global__ void __launch_bounds__(kThreads)
ssd_bwd_cum_kernel(const float* __restrict__ dA, float* __restrict__ cumh,
                   float* __restrict__ cuml, int G, int Q, int H, int Qp) {
  const int lane = threadIdx.x & 31;
  const int gh = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (gh >= G * H) return;
  const int g = gh / H, h = gh - g * H;
  const float* a = dA + static_cast<size_t>(g) * Q * H + h;
  float* ch = cumh + static_cast<size_t>(gh) * Qp;
  float* cl = cuml + static_cast<size_t>(gh) * Qp;
  const int seg = (Q + 31) / 32;
  const int lo = min(Q, lane * seg), hi = min(Q, lo + seg);
  double run = 0.0;
  for (int j = lo; j < hi; ++j) run += a[static_cast<size_t>(j) * H];
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  double acc = incl - run;
  for (int j = lo; j < hi; ++j) {
    acc += a[static_cast<size_t>(j) * H];
    const float f = static_cast<float>(acc);
    ch[j] = f;
    cl[j] = static_cast<float>(acc - f);
  }
  for (int j = Q + lane; j < Qp; j += 32) ch[j] = cl[j] = 0.f;
}

// --------------------------------------------------------------- 2. scores
// CB[g][i][j] = C_i . B_j on the 64 x 64 tiles (I, J <= I); zero past Q.
// A: C rows along N; B: B rows (the output's columns) along N.
__global__ void __launch_bounds__(kThreads, 3)
ssd_bwd_scores_kernel(const float* __restrict__ Bm,
                      const float* __restrict__ Cm, float* __restrict__ CB,
                      int Q, int N, int Qp, int n_pairs, int vec_n) {
  extern __shared__ __align__(16) float smem[];
  float4* hl = reinterpret_cast<float4*>(smem + kStages * kStage);
  const int g = blockIdx.x / n_pairs;
  int I, J;
  pair_tiles(blockIdx.x - g * n_pairs, I, J);
  const int i0 = I * kT, j0 = J * kT;
  const float* Cg = Cm + static_cast<size_t>(g) * Q * N;
  const float* Bg = Bm + static_cast<size_t>(g) * Q * N;
  float acc[kNF][4];
  zero(acc);
  ring(
      (N + kStep - 1) / kStep,
      [&](int s, int buf) {
        float* a = smem + buf * kStage;
        const int n0 = s * kStep;
        copy_rows<kStep>(a, kSP, kT, vec_n, N - n0, Cg, [&](int r) {
          return i0 + r < Q ? Cg + static_cast<size_t>(i0 + r) * N + n0
                            : static_cast<const float*>(nullptr);
        });
        copy_rows<kStep>(a + kStageA, kSP, kT, vec_n, N - n0, Bg, [&](int r) {
          return j0 + r < Q ? Bg + static_cast<size_t>(j0 + r) * N + n0
                            : static_cast<const float*>(nullptr);
        });
      },
      [&](int, int buf) {
        const float* a = smem + buf * kStage;
        split_cols(a + kStageA, hl);
        __syncthreads();
        stage_mma<kKS>(acc, hl, kNF,
                  [&](int kk, float(&x)[4]) { row_frag(a, kk, x); });
      });
  store_tile(acc, CB + static_cast<size_t>(g) * Qp * Qp, Qp, i0, Qp, j0, Qp);
}

// ------------------------------------------------------------------ 3. dxw
// A block per (key tile J, chunk g, head h), the longest (J = 0) first; for
// each 64-wide P tile: U = B . dS^T over N (A: B rows along N; B: dS rows,
// the output's columns, along N), the tile's share of T_j = xw_j . U_j, then
// dxw = e_j U_j + sum_{i >= j} M_ij dY_i (A: the score tile read down its
// columns, times the decay; B: dY rows). T_j = e_j (xw_j . U_j) at the end.
__global__ void __launch_bounds__(kThreads, 3)
ssd_bwd_dxw_kernel(const float* __restrict__ xw, const float* __restrict__ Bm,
                   const float* __restrict__ dY, const float* __restrict__ dS,
                   const float* __restrict__ CB,
                   const float* __restrict__ cumh,
                   const float* __restrict__ cuml, float* __restrict__ dxw,
                   float* __restrict__ Tj, int G, int Q, int H, int P, int N,
                   int Qp, int vec_n, int vec_x, int vec_s) {
  extern __shared__ __align__(16) float smem[];
  float4* hl = reinterpret_cast<float4*>(smem + kStages * kStage);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, t = lane & 3;
  const int J = blockIdx.x / (G * H), gh = blockIdx.x - J * (G * H);
  const int g = gh / H, h = gh - g * H;
  const int j0 = J * kT;
  const size_t row = static_cast<size_t>(H) * P;  // one position of xw / dY
  const float* xg = xw + static_cast<size_t>(g) * Q * row + static_cast<size_t>(h) * P;
  const float* yg = dY + static_cast<size_t>(g) * Q * row + static_cast<size_t>(h) * P;
  const float* sg = dS + static_cast<size_t>(gh) * P * N;   // [P][N]
  const float* Bg = Bm + static_cast<size_t>(g) * Q * N;
  const float* cbg = CB + static_cast<size_t>(g) * Qp * Qp;
  const float* ch = cumh + static_cast<size_t>(gh) * Qp;
  const float* cl = cuml + static_cast<size_t>(gh) * Qp;
  // this lane's keys j0 + 16w + g8 + 8 hh: cum and e_j
  int jr[2];
  float cj[2], lj[2], ej[2], tsum[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    jr[hh] = j0 + warp * 16 + g8 + 8 * hh;
    cj[hh] = ch[jr[hh]];
    lj[hh] = cl[jr[hh]];
    ej[hh] = jr[hh] < Q ? exp2f(((ch[Q - 1] - cj[hh]) + (cl[Q - 1] - lj[hh])) *
                                kLog2e)
                        : 0.f;
  }
  float acc[kNF][4];
  for (int p0 = 0; p0 < P; p0 += kT) {
    const int nf = min(kNF, (P - p0 + 7) / 8);
    zero(acc);
    ring(
        (N + kStep - 1) / kStep,
        [&](int s, int buf) {
          float* a = smem + buf * kStage;
          const int n0 = s * kStep;
          copy_rows<kStep>(a, kSP, kT, vec_n, N - n0, Bg, [&](int r) {
            return j0 + r < Q ? Bg + static_cast<size_t>(j0 + r) * N + n0
                              : static_cast<const float*>(nullptr);
          });
          copy_rows<kStep>(a + kStageA, kSP, kT, vec_s, N - n0, sg, [&](int r) {
            return p0 + r < P ? sg + static_cast<size_t>(p0 + r) * N + n0
                              : static_cast<const float*>(nullptr);
          });
        },
        [&](int, int buf) {
          const float* a = smem + buf * kStage;
          split_cols(a + kStageA, hl);
          __syncthreads();
          stage_mma<2>(acc, hl, nf,
                    [&](int kk, float(&x)[4]) { row_frag(a, kk, x); });
        });
    // this P tile's share of xw_j . U_j: the lane's columns in order, then
    // the quad
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float s = 0.f;
      if (jr[hh] < Q) {
        const float* xr = xg + static_cast<size_t>(jr[hh]) * row;
#pragma unroll
        for (int n = 0; n < kNF; ++n)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int p = p0 + n * 8 + 2 * t + b;
            if (p < P) s = fmaf(xr[p], acc[n][2 * hh + b], s);
          }
      }
      s += __shfl_xor_sync(kFull, s, 1);
      s += __shfl_xor_sync(kFull, s, 2);
      tsum[hh] += s;
    }
#pragma unroll
    for (int n = 0; n < kNF; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= ej[e >> 1];
    // + sum_{i >= j} M[i][j] dY[i][p] over the rows i in [j0, Q)
    ring(
        (Q - j0 + kStep - 1) / kStep,
        [&](int s, int buf) {
          float* a = smem + buf * kStage;
          const int i0 = j0 + s * kStep;
          copy_rows<kT>(a, kSR, kStep, 16, kT, cbg, [&](int r) {
            return i0 + r < Q ? cbg + static_cast<size_t>(i0 + r) * Qp + j0
                              : static_cast<const float*>(nullptr);
          });
          copy_rows<kT>(a + kStageA, kT, kStep, vec_x, P - p0, yg, [&](int r) {
            return i0 + r < Q ? yg + static_cast<size_t>(i0 + r) * row + p0
                              : static_cast<const float*>(nullptr);
          });
        },
        [&](int s, int buf) {
          const float* a = smem + buf * kStage;
          const int i0 = j0 + s * kStep;
          split_rows(a + kStageA, hl);
          __syncthreads();
          stage_mma<2>(acc, hl, nf, [&](int kk, float(&x)[4]) {
            col_frag(a, kk, x);
            const int i = i0 + 8 * kk + 2 * t;  // keys i, i + 1 of slots t, t + 4
            const float2 ci = *reinterpret_cast<const float2*>(ch + i);
            const float2 li = *reinterpret_cast<const float2*>(cl + i);
            x[0] *= decay(i >= jr[0] && i < Q, ci.x, li.x, cj[0], lj[0]);
            x[1] *= decay(i >= jr[1] && i < Q, ci.x, li.x, cj[1], lj[1]);
            x[2] *= decay(i + 1 >= jr[0] && i + 1 < Q, ci.y, li.y, cj[0], lj[0]);
            x[3] *= decay(i + 1 >= jr[1] && i + 1 < Q, ci.y, li.y, cj[1], lj[1]);
          });
        });
    store_tile(acc, dxw + static_cast<size_t>(g) * Q * row +
                        static_cast<size_t>(h) * P,
               row, j0, Q, p0, P);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    if (t == 0 && jr[hh] < Q)
      Tj[static_cast<size_t>(gh) * Qp + jr[hh]] = ej[hh] * tsum[hh];
}

// The column sums of a pair tile's R (acc, as the m16n8 accumulators of the
// 4 warps) into sCol[w][c], one row of 64 a warp: a lane's two rows, then
// the 8 lane groups by shuffles. Ends with __syncthreads().
__device__ __forceinline__ void column_sums(const float (&acc)[kNF][4],
                                            float* sCol) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < kNF; ++n)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      float v = acc[n][b] + acc[n][2 + b];
      v += __shfl_xor_sync(kFull, v, 4);
      v += __shfl_xor_sync(kFull, v, 8);
      v += __shfl_xor_sync(kFull, v, 16);
      if ((lane >> 2) == 0) sCol[warp * kT + n * 8 + 2 * (lane & 3) + b] = v;
    }
}

// R off the diagonal -> pp: [0, 64) the exclusive prefix of the column sums,
// [64, 128) the inclusive suffix of the row sums, [128] the total. Warp 0
// scans the columns (2 a lane, the 4 warps' shares in order), warp 1 the
// rows.
__device__ __forceinline__ void reduce_off_diagonal(
    const float (&acc)[kNF][4], float* sCol, float* sRow, float* pp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  column_sums(acc, sCol);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float v = 0.f;
#pragma unroll
    for (int n = 0; n < kNF; ++n) v += acc[n][2 * hh] + acc[n][2 * hh + 1];
    v += __shfl_xor_sync(kFull, v, 1);
    v += __shfl_xor_sync(kFull, v, 2);
    if ((lane & 3) == 0) sRow[warp * 16 + (lane >> 2) + 8 * hh] = v;
  }
  __syncthreads();
  if (warp == 0) {  // columns 2 lane, 2 lane + 1
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += sCol[w * kT + 2 * lane];
      b += sCol[w * kT + 2 * lane + 1];
    }
    float incl = a + b;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += u;
    }
    float before = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) before = 0.f;
    pp[2 * lane] = before;
    pp[2 * lane + 1] = before + a;
    if (lane == 31) pp[2 * kT] = incl;
  } else if (warp == 1) {  // rows 2 lane, 2 lane + 1
    const float a = sRow[2 * lane], b = sRow[2 * lane + 1];
    float incl = a + b;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_down_sync(kFull, incl, o);
      if (lane + o < 32) incl += u;
    }
    float after = __shfl_down_sync(kFull, incl, 1);
    if (lane == 31) after = 0.f;
    const float sb = b + after;
    pp[kT + 2 * lane + 1] = sb;
    pp[kT + 2 * lane] = a + sb;
  }
}

// R on the diagonal -> pp[c] = sum_{r >= c} sum_{c' < c} R[r][c']: each
// row's exclusive prefix over its columns (the 8 n8 fragments in order, a
// quad scan within each), kept where the row is at or after the column,
// then summed down the columns. acc is overwritten.
__device__ __forceinline__ void reduce_diagonal(float (&acc)[kNF][4],
                                                float* sCol, float* pp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + (lane >> 2) + 8 * hh;
    float off = 0.f;
#pragma unroll
    for (int n = 0; n < kNF; ++n) {
      const float r0 = acc[n][2 * hh], s = r0 + acc[n][2 * hh + 1];
      float incl = s;
      float u = __shfl_up_sync(kFull, incl, 1, 4);
      if (t >= 1) incl += u;
      u = __shfl_up_sync(kFull, incl, 2, 4);
      if (t >= 2) incl += u;
      float before = __shfl_up_sync(kFull, incl, 1, 4);
      if (t == 0) before = 0.f;
      const float quad = __shfl_sync(kFull, incl, 3, 4);
      const int c = n * 8 + 2 * t;
      const float p0 = off + before;
      acc[n][2 * hh] = r >= c ? p0 : 0.f;
      acc[n][2 * hh + 1] = r >= c + 1 ? p0 + r0 : 0.f;
      off += quad;
    }
  }
  column_sums(acc, sCol);
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += sCol[w * kT + 2 * lane + b];
      pp[2 * lane + b] = v;
    }
  }
}

// ---------------------------------------------------------------- 4. pairs
// A block per (chunk g, tile pair (I, J <= I), group of heads): for each
// head, dM = dY_I . xw_J^T over P (A: dY rows along P; B: xw rows, the
// output's columns, along P); dSp[g][grp] = sum over the group's heads of
// dM o L on the pair's tile, and for each head the pair's sums of R for
// d dA at part[((g H + h) n_pairs + pair)]: off the diagonal, [0, 64) the
// prefix over the tile's keys before m of the column sums, [64, 128) the
// suffix over its rows at or after m of the row sums, [128] the total; on
// it, [0, 64) sum_{i >= m} sum_{j < m} R_ij within the tile.
__global__ void __launch_bounds__(kThreads, 3)
ssd_bwd_pairs_kernel(const float* __restrict__ xw,
                     const float* __restrict__ dY,
                     const float* __restrict__ CB,
                     const float* __restrict__ cumh,
                     const float* __restrict__ cuml, float* __restrict__ dSp,
                     float* __restrict__ part, int Q, int H, int P, int Qp,
                     int n_pairs, int n_groups, int vec_x) {
  extern __shared__ __align__(16) float smem[];
  float4* hl = reinterpret_cast<float4*>(smem + kStages * kStage);
  float* sCol = reinterpret_cast<float*>(hl + (kStep / 2) * kSH);  // [kWarps][kT]
  float* sRow = sCol + kWarps * kT;                                // [kT]
  float* sDs = sRow + kT;  // [kT][kSR]: the group's score gradient
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, t = lane & 3;
  const int grp = blockIdx.x % n_groups;
  const int rest = blockIdx.x / n_groups;
  const int pair = rest % n_pairs, g = rest / n_pairs;
  int I, J;
  pair_tiles(pair, I, J);
  const int i0 = I * kT, j0 = J * kT;
  const int per = (H + n_groups - 1) / n_groups;
  const int h_lo = grp * per, nh = max(0, min(H, h_lo + per) - h_lo);
  const int kps = (P + kStep - 1) / kStep;  // stages a head
  const size_t row = static_cast<size_t>(H) * P;
  const float* xg = xw + static_cast<size_t>(g) * Q * row;
  const float* yg = dY + static_cast<size_t>(g) * Q * row;
  const float* cbg = CB + static_cast<size_t>(g) * Qp * Qp;
  const int rl0 = warp * 16 + g8;  // this lane's tile rows rl0, rl0 + 8
  float acc[kNF][4];
  // the lane's own elements of the group's score gradient (no sharing: it
  // stays in shared memory to keep three blocks an SM)
  float* ds = sDs + rl0 * kSR + 2 * t;
#pragma unroll
  for (int n = 0; n < kNF; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(ds + 8 * hh * kSR + 8 * n) = make_float2(0.f, 0.f);

  ring(
      nh * kps,
      [&](int s, int buf) {
        float* a = smem + buf * kStage;
        const int h = h_lo + s / kps, p0 = (s % kps) * kStep;
        const size_t col = static_cast<size_t>(h) * P + p0;
        copy_rows<kStep>(a, kSP, kT, vec_x, P - p0, yg, [&](int r) {
          return i0 + r < Q ? yg + static_cast<size_t>(i0 + r) * row + col
                            : static_cast<const float*>(nullptr);
        });
        copy_rows<kStep>(a + kStageA, kSP, kT, vec_x, P - p0, xg, [&](int r) {
          return j0 + r < Q ? xg + static_cast<size_t>(j0 + r) * row + col
                            : static_cast<const float*>(nullptr);
        });
      },
      [&](int s, int buf) {
        const float* a = smem + buf * kStage;
        const int kp = s % kps;
        if (kp == 0) zero(acc);
        split_cols(a + kStageA, hl);
        __syncthreads();
        stage_mma<kKS>(acc, hl, kNF,
                  [&](int kk, float(&x)[4]) { row_frag(a, kk, x); });
        if (kp != kps - 1) return;
        // the head's dM is whole: L, the score gradient, R
        const size_t gh = static_cast<size_t>(g) * H + h_lo + s / kps;
        const float* ch = cumh + gh * Qp;
        const float* cl = cuml + gh * Qp;
        const float ci[2] = {ch[i0 + rl0], ch[i0 + rl0 + 8]};
        const float li[2] = {cl[i0 + rl0], cl[i0 + rl0 + 8]};
#pragma unroll
        for (int n = 0; n < kNF; ++n) {
          const int j = j0 + n * 8 + 2 * t;
          const float2 cj = *reinterpret_cast<const float2*>(ch + j);
          const float2 lj = *reinterpret_cast<const float2*>(cl + j);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i = i0 + rl0 + 8 * hh;
            const float2 cb = __ldg(reinterpret_cast<const float2*>(
                cbg + static_cast<size_t>(i) * Qp + j));
            const float L0 = decay(i >= j && i < Q, ci[hh], li[hh], cj.x, lj.x);
            const float L1 =
                decay(i >= j + 1 && i < Q, ci[hh], li[hh], cj.y, lj.y);
            const float d0 = acc[n][2 * hh] * L0, d1 = acc[n][2 * hh + 1] * L1;
            float2* dsp = reinterpret_cast<float2*>(ds + 8 * hh * kSR + 8 * n);
            const float2 was = *dsp;
            *dsp = make_float2(was.x + d0, was.y + d1);
            acc[n][2 * hh] = d0 * cb.x;
            acc[n][2 * hh + 1] = d1 * cb.y;
          }
        }
        float* pp = part + (gh * n_pairs + pair) * kPart;
        if (I > J)
          reduce_off_diagonal(acc, sCol, sRow, pp);
        else
          reduce_diagonal(acc, sCol, pp);
      });
#pragma unroll
  for (int n = 0; n < kNF; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float2 v = *reinterpret_cast<const float2*>(ds + 8 * hh * kSR + 8 * n);
      acc[n][2 * hh] = v.x;
      acc[n][2 * hh + 1] = v.y;
    }
  store_tile(acc, dSp + (static_cast<size_t>(g) * n_groups + grp) * Qp * Qp,
             Qp, i0, Qp, j0, Qp);
}

// ----------------------------------------------------------------- 5. dscr
// A block per (chunk g, tile pair): the groups' score-gradient partials
// summed in group order into the first group's slot
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dscr_kernel(float* __restrict__ dSp, int Qp, int n_pairs,
                    int n_groups) {
  const int g = blockIdx.x / n_pairs;
  int I, J;
  pair_tiles(blockIdx.x - g * n_pairs, I, J);
  const size_t stride = static_cast<size_t>(Qp) * Qp;
  float* base = dSp + static_cast<size_t>(g) * n_groups * stride;
  for (int e = threadIdx.x; e < kT * kT / 4; e += kThreads) {
    const int r = e / (kT / 4), c = 4 * (e - r * (kT / 4));
    float* at = base + static_cast<size_t>(I * kT + r) * Qp + J * kT + c;
    const float4 v0 = *reinterpret_cast<const float4*>(at);
    float x = v0.x, y = v0.y, z = v0.z, w = v0.w;
    for (int q = 1; q < n_groups; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(at + q * stride);
      x += v.x;
      y += v.y;
      z += v.z;
      w += v.w;
    }
    *reinterpret_cast<float4*>(at) = make_float4(x, y, z, w);
  }
}

// ---------------------------------------------------------------- 6. dB, dC
// Blocks [0, n_db): dB partials (chunk g, key tile, N tile, head split s),
// the longest first: split 0 takes sum_{i >= j} dScr_ij C_i (A: the score
// gradient read down its columns; B: C rows), every split its heads'
// sum_p (e_j xw_j[p]) dS[p, :] (A: xw rows along P, times e_j; B: dS rows),
// into dBp[g][s]. Then dC blocks (chunk g, row tile, N tile): sum_{j <= i}
// dScr_ij B_j (A: the score gradient along its rows; B: B rows). dScr is
// the first group's slot of dSp, summed by launch 5.
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_dbdc_kernel(const float* __restrict__ xw, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ dS,
                    const float* __restrict__ dSp,
                    const float* __restrict__ cumh,
                    const float* __restrict__ cuml, float* __restrict__ dC,
                    float* __restrict__ dBp, int G, int Q, int H, int P,
                    int N, int Qp, int n_groups, int n_splits, int vec_n,
                    int vec_x, int vec_s) {
  extern __shared__ __align__(16) float smem[];
  float4* hl = reinterpret_cast<float4*>(smem + kStages * kStage);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nT = tiles(Q), nN = (N + kT - 1) / kT;
  const int n_db = G * nT * nN * n_splits;
  const bool is_db = static_cast<int>(blockIdx.x) < n_db;
  int id = is_db ? blockIdx.x : blockIdx.x - n_db;
  int split = 0;
  if (is_db) {
    split = id % n_splits;
    id /= n_splits;
  }
  const int nt = id % nN;
  id /= nN;
  const int tt = id % nT, g = id / nT;
  const int r0 = tt * kT, n0 = nt * kT;
  const int nf = min(kNF, (N - n0 + 7) / 8);
  const float* dsg = dSp + static_cast<size_t>(g) * n_groups * Qp * Qp;
  const float* Bg = Bm + static_cast<size_t>(g) * Q * N + n0;
  const float* Cg = Cm + static_cast<size_t>(g) * Q * N + n0;
  float acc[kNF][4];
  zero(acc);
  if (!is_db) {
    ring(
        (min(Q, r0 + kT) + kStep - 1) / kStep,
        [&](int s, int buf) {
          float* a = smem + buf * kStage;
          const int j0 = s * kStep;
          copy_rows<kStep>(a, kSP, kT, 16, kStep, dsg, [&](int r) {
            return r0 + r < Q ? dsg + static_cast<size_t>(r0 + r) * Qp + j0
                              : static_cast<const float*>(nullptr);
          });
          copy_rows<kT>(a + kStageA, kT, kStep, vec_n, N - n0, Bg, [&](int r) {
            return j0 + r < Q ? Bg + static_cast<size_t>(j0 + r) * N
                              : static_cast<const float*>(nullptr);
          });
        },
        [&](int, int buf) {
          const float* a = smem + buf * kStage;
          split_rows(a + kStageA, hl);
          __syncthreads();
          stage_mma<kKS>(acc, hl, nf,
                    [&](int kk, float(&x)[4]) { row_frag(a, kk, x); });
        });
    store_tile(acc, dC + static_cast<size_t>(g) * Q * N, N, r0, Q, n0, N);
    return;
  }
  const int main = split == 0 ? (Q - r0 + kStep - 1) / kStep : 0;
  const int per = (H + n_splits - 1) / n_splits;
  const int h_lo = split * per, nh = max(0, min(H, h_lo + per) - h_lo);
  const int kps = (P + kStep - 1) / kStep;  // stages a head
  const size_t row = static_cast<size_t>(H) * P;
  const float* xg = xw + static_cast<size_t>(g) * Q * row;
  const int jr0 = r0 + warp * 16 + (lane >> 2);  // this lane's keys jr0, jr0 + 8
  float ej[2] = {0.f, 0.f};
  ring(
      main + nh * kps,
      [&](int s, int buf) {
        float* a = smem + buf * kStage;
        if (s < main) {
          const int i0 = r0 + s * kStep;
          copy_rows<kT>(a, kSR, kStep, 16, kT, dsg, [&](int r) {
            return i0 + r < Q ? dsg + static_cast<size_t>(i0 + r) * Qp + r0
                              : static_cast<const float*>(nullptr);
          });
          copy_rows<kT>(a + kStageA, kT, kStep, vec_n, N - n0, Cg, [&](int r) {
            return i0 + r < Q ? Cg + static_cast<size_t>(i0 + r) * N
                              : static_cast<const float*>(nullptr);
          });
          return;
        }
        const int q = s - main, h = h_lo + q / kps, p0 = (q % kps) * kStep;
        const size_t col = static_cast<size_t>(h) * P + p0;
        copy_rows<kStep>(a, kSP, kT, vec_x, P - p0, xg, [&](int r) {
          return r0 + r < Q ? xg + static_cast<size_t>(r0 + r) * row + col
                            : static_cast<const float*>(nullptr);
        });
        const float* sg = dS + (static_cast<size_t>(g) * H + h) * P * N + n0;
        copy_rows<kT>(a + kStageA, kT, kStep, vec_s, N - n0, sg, [&](int r) {
          return p0 + r < P ? sg + static_cast<size_t>(p0 + r) * N
                            : static_cast<const float*>(nullptr);
        });
      },
      [&](int s, int buf) {
        const float* a = smem + buf * kStage;
        split_rows(a + kStageA, hl);
        __syncthreads();
        if (s < main) {
          stage_mma<kKS>(acc, hl, nf,
                    [&](int kk, float(&x)[4]) { col_frag(a, kk, x); });
          return;
        }
        const int q = s - main;
        if (q % kps == 0) {  // a new head: e_j for the lane's keys
          const size_t gh = static_cast<size_t>(g) * H + h_lo + q / kps;
          const float* ch = cumh + gh * Qp;
          const float* cl = cuml + gh * Qp;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int j = jr0 + 8 * hh;
            ej[hh] = j < Q ? exp2f(((ch[Q - 1] - ch[j]) + (cl[Q - 1] - cl[j])) *
                                   kLog2e)
                           : 0.f;
          }
        }
        stage_mma<kKS>(acc, hl, nf, [&](int kk, float(&x)[4]) {
          row_frag(a, kk, x);
          x[0] *= ej[0];
          x[1] *= ej[1];
          x[2] *= ej[0];
          x[3] *= ej[1];
        });
      });
  store_tile(acc, dBp + (static_cast<size_t>(g) * n_splits + split) * Qp * N,
             N, r0, Q, n0, N);
}

// ---------------------------------------------------------------- 7. d dA
// Blocks [0, G H): d dA of (chunk g, head h) for every position m in tile
// M = m / 64, t = m % 64: the prefix of T before m, the totals of the
// pairs (I > M, J < M), the column prefixes of the pairs (I >= M, M) and
// the row suffixes of the pairs (M, J < M), all in double. Then blocks
// (chunk g, key tile): dB = the sum of its head-split partials in order.
__global__ void __launch_bounds__(kFinalThreads)
ssd_bwd_final_kernel(const float* __restrict__ Tj,
                     const float* __restrict__ part,
                     const float* __restrict__ dBp, float* __restrict__ ddA,
                     float* __restrict__ dB, int G, int Q, int H, int N,
                     int Qp, int n_pairs, int n_splits) {
  __shared__ double sTp[kMaxQ];
  __shared__ double sTot[kMaxTiles];
  const int tid = threadIdx.x;
  const int nT = tiles(Q);
  if (static_cast<int>(blockIdx.x) >= G * H) {
    const int id = blockIdx.x - G * H;
    const int g = id / nT, j0 = (id - g * nT) * kT;
    const int rows = min(kT, Q - j0);
    for (int e = tid; e < rows * N; e += kFinalThreads) {
      const size_t at = static_cast<size_t>(j0) * N + e;
      float s = 0.f;
      for (int q = 0; q < n_splits; ++q)
        s += dBp[(static_cast<size_t>(g) * n_splits + q) * Qp * N + at];
      dB[static_cast<size_t>(g) * Q * N + at] = s;
    }
    return;
  }
  const int gh = blockIdx.x, g = gh / H, h = gh - g * H;
  const float* T = Tj + static_cast<size_t>(gh) * Qp;
  const float* pp = part + static_cast<size_t>(gh) * n_pairs * kPart;
  if (tid < 32) {  // exclusive prefix of T: a lane's segment, then a scan
    const int lane = tid, seg = (Q + 31) / 32;
    const int lo = min(Q, lane * seg), hi = min(Q, lo + seg);
    double run = 0.0;
    for (int j = lo; j < hi; ++j) run += T[j];
    double incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    double acc = incl - run;
    for (int j = lo; j < hi; ++j) {
      sTp[j] = acc;
      acc += T[j];
    }
  } else if (tid - 32 < nT) {
    const int M = tid - 32;
    double s = 0.0;
    for (int Jt = 0; Jt < M; ++Jt)
      for (int It = M + 1; It < nT; ++It)
        s += pp[static_cast<size_t>(It * (It + 1) / 2 + Jt) * kPart + 2 * kT];
    sTot[M] = s;
  }
  __syncthreads();
  for (int m = tid; m < Q; m += kFinalThreads) {
    const int M = m / kT, t = m - M * kT;
    double w = sTp[m] + sTot[M];
    for (int It = M; It < nT; ++It)
      w += pp[static_cast<size_t>(It * (It + 1) / 2 + M) * kPart + t];
    for (int Jt = 0; Jt < M; ++Jt)
      w += pp[static_cast<size_t>(M * (M + 1) / 2 + Jt) * kPart + kT + t];
    ddA[(static_cast<size_t>(g) * Q + m) * H + h] = static_cast<float>(w);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// dA [G,Q,H]; xw, dY [G,Q,H,P]; Bm, Cm [G,Q,N]; dS [G,H,P,N] -> ddA [G,Q,H],
// dxw [G,Q,H,P], dB, dC [G,Q,N]. Scratch, with Qp = Q rounded up to 64,
// nP = (Qp / 64)(Qp / 64 + 1) / 2 tile pairs: cum [2, G, H, Qp]; CB [G, Qp,
// Qp]; dSp [G, n_groups, Qp, Qp]; T [G, H, Qp]; part [G, H, nP, 132]; dBp
// [G, n_splits, Qp, N]. All fp32, contiguous, on the device; Q <= 4096;
// 1 <= n_groups, n_splits <= H. Seven launches (six with one group) on
// `stream`; does not synchronise; returns the first launch error.
extern "C" int ssd_chunk_bwd_f32(const float* dA, const float* xw,
                                 const float* Bm, const float* Cm,
                                 const float* dY, const float* dS, float* ddA,
                                 float* dxw, float* dB, float* dC, float* cum,
                                 float* CB, float* dSp, float* Tj, float* part,
                                 float* dBp, int G, int Q, int H, int P, int N,
                                 int n_groups, int n_splits,
                                 cudaStream_t stream) {
  if (G <= 0 || Q <= 0 || H <= 0 || P <= 0 || N <= 0) return 0;
  if (Q > kMaxQ || n_groups < 1 || n_groups > H || n_splits < 1 ||
      n_splits > H)
    return static_cast<int>(cudaErrorInvalidValue);
  int vec_n = copy_bytes(Bm, sizeof(float) * N);
  const int vec_c = copy_bytes(Cm, sizeof(float) * N);
  if (vec_c < vec_n) vec_n = vec_c;
  const int vec_s = copy_bytes(dS, sizeof(float) * N);
  int vec_x = copy_bytes(xw, sizeof(float) * P);
  const int vec_y = copy_bytes(dY, sizeof(float) * P);
  if (vec_y < vec_x) vec_x = vec_y;
  if (vec_n == 0 || vec_s == 0 || vec_x == 0 ||
      reinterpret_cast<uintptr_t>(CB) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dSp) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nT = tiles(Q), Qp = nT * kT, nN = (N + kT - 1) / kT;
  const long long n_pairs = static_cast<long long>(nT) * (nT + 1) / 2;
  const long long gh = static_cast<long long>(G) * H;
  const long long n_pair_blocks = G * n_pairs * n_groups;
  const long long n_dbdc = static_cast<long long>(G) * nT * nN * (n_splits + 1);
  if (gh * nT > 0x7fffffffLL || n_pair_blocks > 0x7fffffffLL ||
      n_dbdc > 0x7fffffffLL || gh + G * nT > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem_pairs =
      kSmemRing + sizeof(float) * ((kWarps + 1) * kT + kT * kSR);
  cudaError_t err = allow_smem(ssd_bwd_scores_kernel, kSmemRing);
  if (err == cudaSuccess) err = allow_smem(ssd_bwd_dxw_kernel, kSmemRing);
  if (err == cudaSuccess) err = allow_smem(ssd_bwd_pairs_kernel, smem_pairs);
  if (err == cudaSuccess) err = allow_smem(ssd_bwd_dbdc_kernel, kSmemRing);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* cumh = cum;
  float* cuml = cum + gh * Qp;
  ssd_bwd_cum_kernel<<<static_cast<unsigned>((gh + kWarps - 1) / kWarps),
                       kThreads, 0, stream>>>(dA, cumh, cuml, G, Q, H, Qp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_scores_kernel<<<static_cast<unsigned>(G * n_pairs), kThreads,
                          kSmemRing, stream>>>(
      Bm, Cm, CB, Q, N, Qp, static_cast<int>(n_pairs), vec_n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dxw_kernel<<<static_cast<unsigned>(gh * nT), kThreads, kSmemRing,
                       stream>>>(xw, Bm, dY, dS, CB, cumh, cuml, dxw, Tj, G,
                                 Q, H, P, N, Qp, vec_n, vec_x, vec_s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_pairs_kernel<<<static_cast<unsigned>(n_pair_blocks), kThreads,
                         smem_pairs, stream>>>(
      xw, dY, CB, cumh, cuml, dSp, part, Q, H, P, Qp,
      static_cast<int>(n_pairs), n_groups, vec_x);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_groups > 1) {
    ssd_bwd_dscr_kernel<<<static_cast<unsigned>(G * n_pairs), kThreads, 0,
                          stream>>>(dSp, Qp, static_cast<int>(n_pairs),
                                    n_groups);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssd_bwd_dbdc_kernel<<<static_cast<unsigned>(n_dbdc), kThreads, kSmemRing,
                        stream>>>(xw, Bm, Cm, dS, dSp, cumh, cuml, dC, dBp, G,
                                  Q, H, P, N, Qp, n_groups, n_splits, vec_n,
                                  vec_x, vec_s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_final_kernel<<<static_cast<unsigned>(gh + G * nT), kFinalThreads, 0,
                         stream>>>(Tj, part, dBp, ddA, dB, G, Q, H, N, Qp,
                                   static_cast<int>(n_pairs), n_splits);
  return static_cast<int>(cudaGetLastError());
}
