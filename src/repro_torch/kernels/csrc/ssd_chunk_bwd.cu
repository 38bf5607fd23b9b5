// Backward of the Mamba2 SSD intra-chunk step on Hopper (sm_90a), fp32 on
// the fp32 cores, plain C interface.
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
// GFLOP on 305 MB of inputs and outputs, so 0.33 ms at the 67 TFLOP/s of
// the fp32 cores, 0.09 ms for the bytes at 3.35 TB/s.
//
// What the design does about it, for now: it is the simple version. Every
// product runs on the fp32 cores from shared memory, 64 x 64 output tiles
// a block of 256 threads, each thread a 4 x 4 register tile, the
// contraction in steps of 32 (float4 reads of both operands). No atomics:
// every sum has a fixed order, so two launches on the same inputs give the
// same bits. Six launches on the caller's stream:
//   1. cum: each (chunk, head)'s prefix sums of dA, scanned in double and
//      kept as a pair of floats hi + lo (as the forward keeps them);
//   2. scores: C . B^T of each chunk, its 64 x 64 tiles on and below the
//      diagonal, into a scratch [G, Qp, Qp] (Qp = Q rounded up to 64);
//   3. dxw: a block per (key tile, chunk, head) forms U and T for its keys
//      and walks the row tiles at or below the diagonal for M^T dY;
//   4. pairs: a block per (chunk, tile pair, group of heads) forms dM, then
//      for each head of the group adds dM o L to the pair's score gradient
//      (one partial a group, summed by launch 5 in group order) and reduces
//      R to the three sums that launch 6 needs for the straddling pairs:
//      column-prefix, row-suffix and the total (on the diagonal tile, the
//      straddle sum itself);
//   5. dB / dC: dC and dB from the summed score gradient; the dB blocks
//      also take the state term, a contraction over (head, P) that each
//      block runs for one split of the heads into its own partial;
//   6. d dA from the pair sums and the prefix of T (summed in double), and
//      dB from its head-split partials.
// The head groups of launch 4 and the head splits of launch 5 are chosen
// by the caller from the shape alone, so the order of every sum is a
// function of the shape. What wgmma would add is the same as for the
// forward (its header): the products on the tensor cores in 3xTF32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;                 // tile: output rows and columns
constexpr int kK = 32;                 // contraction step
constexpr int kThreads = 256;          // 16 x 16 threads, 4 x 4 each
constexpr int kLD = kT + 4;            // operand row stride (float4 aligned)
constexpr int kPart = 132;             // floats a (pair, head): jv, iv, tot
constexpr int kMaxQ = 4096;            // chunk length
constexpr int kMaxTiles = kMaxQ / kT;
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ __forceinline__ int tiles(int q) { return (q + kT - 1) / kT; }

// acc[a][b] += sum_{k < kK} sA[k][4 ty + a] sB[k][4 tx + b]
__device__ __forceinline__ void tile_fma(float (&acc)[4][4],
                                         const float* sA, const float* sB) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 8
  for (int k = 0; k < kK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(sA + k * kLD + 4 * ty);
    const float4 b = *reinterpret_cast<const float4*>(sB + k * kLD + 4 * tx);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// s[k][c] = f(k, c) for k < kK, c < kT; consecutive threads take
// consecutive c (a source read along the tile's columns)
template <typename F>
__device__ __forceinline__ void fill_rows(float* s, F f) {
  for (int i = threadIdx.x; i < kK * kT; i += kThreads) {
    const int k = i / kT, c = i - k * kT;
    s[k * kLD + c] = f(k, c);
  }
}
// the same with consecutive threads on consecutive k (a source read along
// the contraction: the tile is stored transposed)
template <typename F>
__device__ __forceinline__ void fill_cols(float* s, F f) {
  for (int i = threadIdx.x; i < kK * kT; i += kThreads) {
    const int c = i / kK, k = i - c * kK;
    s[k * kLD + c] = f(k, c);
  }
}

// exp(x) as the forward computes it
__device__ __forceinline__ float expf_(float x) { return exp2f(x * kLog2e); }

// (I, J <= I) of pair p = I (I + 1) / 2 + J
__device__ __forceinline__ void pair_tiles(int p, int& I, int& J) {
  I = 0;
  while (p > I) p -= ++I;
  J = p;
}

// ------------------------------------------------------------------ 1. cum
// cumh + cuml = the prefix sums of dA[g, :, h] in double, as two floats, at
// [(g H + h) Qp + i]; 0 on [Q, Qp). A warp a (chunk, head).
__global__ void __launch_bounds__(kThreads)
ssd_bwd_cum_kernel(const float* __restrict__ dA, float* __restrict__ cumh,
                   float* __restrict__ cuml, int G, int Q, int H, int Qp) {
  const int lane = threadIdx.x & 31;
  const int gh = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
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
    const double t = __shfl_up_sync(0xffffffffu, incl, o);
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
// CB[g][i][j] = C_i . B_j on the 64 x 64 tiles (I, J <= I); zero past Q
__global__ void __launch_bounds__(kThreads)
ssd_bwd_scores_kernel(const float* __restrict__ Bm,
                      const float* __restrict__ Cm, float* __restrict__ CB,
                      int Q, int N, int Qp, int n_pairs) {
  __shared__ __align__(16) float sA[kK * kLD];
  __shared__ __align__(16) float sB[kK * kLD];
  const int g = blockIdx.x / n_pairs;
  int I, J;
  pair_tiles(blockIdx.x - g * n_pairs, I, J);
  const int i0 = I * kT, j0 = J * kT;
  const float* Cg = Cm + static_cast<size_t>(g) * Q * N;
  const float* Bg = Bm + static_cast<size_t>(g) * Q * N;
  float acc[4][4];
  zero(acc);
  for (int n0 = 0; n0 < N; n0 += kK) {
    __syncthreads();
    fill_cols(sA, [&](int k, int c) {
      const int i = i0 + c, n = n0 + k;
      return i < Q && n < N ? Cg[static_cast<size_t>(i) * N + n] : 0.f;
    });
    fill_cols(sB, [&](int k, int c) {
      const int j = j0 + c, n = n0 + k;
      return j < Q && n < N ? Bg[static_cast<size_t>(j) * N + n] : 0.f;
    });
    __syncthreads();
    tile_fma(acc, sA, sB);
  }
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float* out = CB + static_cast<size_t>(g) * Qp * Qp;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      out[static_cast<size_t>(i0 + 4 * ty + a) * Qp + j0 + 4 * tx + b] =
          acc[a][b];
}

// ------------------------------------------------------------------ 3. dxw
// A block per (key tile J, chunk g, head h), the longest (J = 0) first:
// dxw_j = e_j U_j + sum_{i >= j} M_ij dY_i and T_j = e_j (xw_j . U_j)
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dxw_kernel(const float* __restrict__ xw, const float* __restrict__ Bm,
                   const float* __restrict__ dY, const float* __restrict__ dS,
                   const float* __restrict__ CB,
                   const float* __restrict__ cumh,
                   const float* __restrict__ cuml, float* __restrict__ dxw,
                   float* __restrict__ Tj, int G, int Q, int H, int P, int N,
                   int Qp) {
  __shared__ __align__(16) float sA[kK * kLD];
  __shared__ __align__(16) float sB[kK * kLD];
  __shared__ float sCj[kT], sLj[kT], sE[kT], sT[kT];
  __shared__ float sRed[kT][17];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nT = tiles(Q);
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
  if (tid < kT) {
    const int j = j0 + tid;
    sCj[tid] = ch[j];
    sLj[tid] = cl[j];
    sE[tid] = j < Q ? expf_((ch[Q - 1] - ch[j]) + (cl[Q - 1] - cl[j])) : 0.f;
    sT[tid] = 0.f;
  }
  float acc[4][4];
  for (int p0 = 0; p0 < P; p0 += kT) {
    // U[j][p] = sum_n B[j][n] dS[p][n]
    zero(acc);
    for (int n0 = 0; n0 < N; n0 += kK) {
      __syncthreads();
      fill_cols(sA, [&](int k, int c) {
        const int j = j0 + c, n = n0 + k;
        return j < Q && n < N ? Bg[static_cast<size_t>(j) * N + n] : 0.f;
      });
      fill_cols(sB, [&](int k, int c) {
        const int p = p0 + c, n = n0 + k;
        return p < P && n < N ? sg[static_cast<size_t>(p) * N + n] : 0.f;
      });
      __syncthreads();
      tile_fma(acc, sA, sB);
    }
    // this P tile's share of xw_j . U_j, summed over tx in order
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = j0 + 4 * ty + a;
      float s = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int p = p0 + 4 * tx + b;
        if (j < Q && p < P) s = fmaf(xg[j * row + p], acc[a][b], s);
      }
      sRed[4 * ty + a][tx] = s;
    }
    __syncthreads();
    if (tid < kT) {
      float s = 0.f;
      for (int t = 0; t < 16; ++t) s += sRed[tid][t];
      sT[tid] += s;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] *= sE[4 * ty + a];
    // + sum_{i >= j} M[i][j] dY[i][p], row tiles I >= J
    for (int I = J; I < nT; ++I) {
      for (int k0 = 0; k0 < kT; k0 += kK) {
        const int i0 = I * kT + k0;
        __syncthreads();
        fill_rows(sA, [&](int k, int c) {
          const int i = i0 + k, j = j0 + c;
          if (i >= Q || j >= Q || j > i) return 0.f;
          return expf_((ch[i] - sCj[c]) + (cl[i] - sLj[c])) *
                 cbg[static_cast<size_t>(i) * Qp + j];
        });
        fill_rows(sB, [&](int k, int c) {
          const int i = i0 + k, p = p0 + c;
          return i < Q && p < P ? yg[i * row + p] : 0.f;
        });
        __syncthreads();
        tile_fma(acc, sA, sB);
      }
    }
    float* out = dxw + static_cast<size_t>(g) * Q * row + static_cast<size_t>(h) * P;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = j0 + 4 * ty + a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int p = p0 + 4 * tx + b;
        if (j < Q && p < P) out[j * row + p] = acc[a][b];
      }
    }
  }
  __syncthreads();
  if (tid < kT && j0 + tid < Q)
    Tj[static_cast<size_t>(gh) * Qp + j0 + tid] = sE[tid] * sT[tid];
}

// ---------------------------------------------------------------- 4. pairs
// A block per (chunk g, tile pair (I, J <= I), group of heads): dSp[g][grp]
// = sum over the group's heads of dM o L on the pair's tile, and for each
// head the pair's sums of R for d dA at part[((g H + h) n_pairs + pair)]:
// off the diagonal, [0, 64) the prefix over the tile's keys before m of
// the column sums, [64, 128) the suffix over its rows at or after m of the
// row sums, [128] the total; on it, [0, 64) sum_{i >= m} sum_{j < m} R_ij
// within the tile.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_pairs_kernel(const float* __restrict__ xw,
                     const float* __restrict__ dY,
                     const float* __restrict__ CB,
                     const float* __restrict__ cumh,
                     const float* __restrict__ cuml, float* __restrict__ dSp,
                     float* __restrict__ part, int Q, int H, int P, int Qp,
                     int n_pairs, int n_groups) {
  __shared__ __align__(16) float sA[kK * kLD];
  __shared__ __align__(16) float sB[kK * kLD];
  __shared__ float sR[kT][kT + 1];
  __shared__ float sCi[kT], sLi[kT], sCj[kT], sLj[kT], sCs[kT], sRs[kT];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int grp = blockIdx.x % n_groups;
  const int rest = blockIdx.x / n_groups;
  const int pair = rest % n_pairs, g = rest / n_pairs;
  int I, J;
  pair_tiles(pair, I, J);
  const int i0 = I * kT, j0 = J * kT;
  const int per = (H + n_groups - 1) / n_groups;
  const int h_lo = grp * per, h_hi = min(H, h_lo + per);
  const size_t row = static_cast<size_t>(H) * P;
  const float* cbg = CB + static_cast<size_t>(g) * Qp * Qp;
  float cb[4][4], ds[4][4], dm[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      cb[a][b] = cbg[static_cast<size_t>(i0 + 4 * ty + a) * Qp + j0 + 4 * tx + b];
  zero(ds);
  for (int h = h_lo; h < h_hi; ++h) {
    const size_t gh = static_cast<size_t>(g) * H + h;
    const float* xg = xw + static_cast<size_t>(g) * Q * row + static_cast<size_t>(h) * P;
    const float* yg = dY + static_cast<size_t>(g) * Q * row + static_cast<size_t>(h) * P;
    __syncthreads();
    if (tid < kT) {
      sCi[tid] = cumh[gh * Qp + i0 + tid];
      sLi[tid] = cuml[gh * Qp + i0 + tid];
    } else if (tid < 2 * kT) {
      sCj[tid - kT] = cumh[gh * Qp + j0 + tid - kT];
      sLj[tid - kT] = cuml[gh * Qp + j0 + tid - kT];
    }
    zero(dm);
    for (int p0 = 0; p0 < P; p0 += kK) {
      __syncthreads();
      fill_cols(sA, [&](int k, int c) {
        const int i = i0 + c, p = p0 + k;
        return i < Q && p < P ? yg[i * row + p] : 0.f;
      });
      fill_cols(sB, [&](int k, int c) {
        const int j = j0 + c, p = p0 + k;
        return j < Q && p < P ? xg[j * row + p] : 0.f;
      });
      __syncthreads();
      tile_fma(dm, sA, sB);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = 4 * ty + a, c = 4 * tx + b;
        const int i = i0 + r, j = j0 + c;
        const float L = i < Q && j < Q && j <= i
                            ? expf_((sCi[r] - sCj[c]) + (sLi[r] - sLj[c]))
                            : 0.f;
        const float dl = dm[a][b] * L;
        ds[a][b] += dl;
        sR[r][c] = dl * cb[a][b];
      }
    __syncthreads();
    float* pp = part + (gh * n_pairs + pair) * kPart;
    if (I > J) {
      if (tid < kT) {
        float s = 0.f;
        for (int r = 0; r < kT; ++r) s += sR[r][tid];
        sCs[tid] = s;
      } else if (tid < 2 * kT) {
        const int r = tid - kT;
        float s = 0.f;
        for (int c = 0; c < kT; ++c) s += sR[r][c];
        sRs[r] = s;
      }
      __syncthreads();
      if (tid == 0) {
        float s = 0.f;
        for (int t = 0; t < kT; ++t) {
          pp[t] = s;
          s += sCs[t];
        }
        pp[2 * kT] = s;
      } else if (tid == 32) {
        float s = 0.f;
        for (int t = kT - 1; t >= 0; --t) {
          s += sRs[t];
          pp[kT + t] = s;
        }
      }
    } else {
      if (tid < kT) {  // row r's exclusive prefix sums, in place
        float s = 0.f;
        for (int c = 0; c < kT; ++c) {
          const float v = sR[tid][c];
          sR[tid][c] = s;
          s += v;
        }
      }
      __syncthreads();
      if (tid < kT) {
        float s = 0.f;
        for (int r = tid; r < kT; ++r) s += sR[r][tid];
        pp[tid] = s;
      }
    }
  }
  float* out = dSp + (static_cast<size_t>(g) * n_groups + grp) * Qp * Qp;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      out[static_cast<size_t>(i0 + 4 * ty + a) * Qp + j0 + 4 * tx + b] =
          ds[a][b];
}

// ---------------------------------------------------------------- 5. dB, dC
// Blocks [0, n_db): dB partials (chunk g, key tile, N tile, head split s),
// the longest first: split 0 takes sum_{i >= j} dScr_ij C_i, every split
// its heads' sum_p (e_j xw_j[p]) dS[p, :], into dBp[g][s]. Then dC blocks
// (chunk g, row tile, N tile): sum_{j <= i} dScr_ij B_j. dScr is the sum of
// the groups' partials of launch 4, in group order.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dbdc_kernel(const float* __restrict__ xw, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ dS,
                    const float* __restrict__ dSp,
                    const float* __restrict__ cumh,
                    const float* __restrict__ cuml, float* __restrict__ dC,
                    float* __restrict__ dBp, int G, int Q, int H, int P,
                    int N, int Qp, int n_groups, int n_splits) {
  __shared__ __align__(16) float sA[kK * kLD];
  __shared__ __align__(16) float sB[kK * kLD];
  __shared__ float sE[kT];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
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
  const size_t grp_stride = static_cast<size_t>(Qp) * Qp;
  const float* dsg = dSp + static_cast<size_t>(g) * n_groups * grp_stride;
  auto dscr = [&](int i, int j) {
    const float* p = dsg + static_cast<size_t>(i) * Qp + j;
    float s = 0.f;
    for (int q = 0; q < n_groups; ++q) s += p[q * grp_stride];
    return s;
  };
  const float* Bg = Bm + static_cast<size_t>(g) * Q * N;
  const float* Cg = Cm + static_cast<size_t>(g) * Q * N;
  float acc[4][4];
  zero(acc);
  if (is_db) {
    if (split == 0) {
      for (int I = tt; I < nT; ++I)
        for (int k0 = 0; k0 < kT; k0 += kK) {
          const int i0 = I * kT + k0;
          __syncthreads();
          fill_rows(sA, [&](int k, int c) { return dscr(i0 + k, r0 + c); });
          fill_rows(sB, [&](int k, int c) {
            const int i = i0 + k, n = n0 + c;
            return i < Q && n < N ? Cg[static_cast<size_t>(i) * N + n] : 0.f;
          });
          __syncthreads();
          tile_fma(acc, sA, sB);
        }
    }
    const int per = (H + n_splits - 1) / n_splits;
    const size_t row = static_cast<size_t>(H) * P;
    for (int h = split * per; h < min(H, (split + 1) * per); ++h) {
      const size_t gh = static_cast<size_t>(g) * H + h;
      const float* ch = cumh + gh * Qp;
      const float* cl = cuml + gh * Qp;
      const float* xg = xw + static_cast<size_t>(g) * Q * row + static_cast<size_t>(h) * P;
      const float* sg = dS + gh * P * N;
      __syncthreads();
      if (tid < kT) {
        const int j = r0 + tid;
        sE[tid] = j < Q ? expf_((ch[Q - 1] - ch[j]) + (cl[Q - 1] - cl[j]))
                        : 0.f;
      }
      for (int p0 = 0; p0 < P; p0 += kK) {
        __syncthreads();
        fill_cols(sA, [&](int k, int c) {
          const int j = r0 + c, p = p0 + k;
          return j < Q && p < P ? sE[c] * xg[j * row + p] : 0.f;
        });
        fill_rows(sB, [&](int k, int c) {
          const int p = p0 + k, n = n0 + c;
          return p < P && n < N ? sg[static_cast<size_t>(p) * N + n] : 0.f;
        });
        __syncthreads();
        tile_fma(acc, sA, sB);
      }
    }
    float* out = dBp + (static_cast<size_t>(g) * n_splits + split) * Qp * N;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = r0 + 4 * ty + a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int n = n0 + 4 * tx + b;
        if (j < Q && n < N) out[static_cast<size_t>(j) * N + n] = acc[a][b];
      }
    }
    return;
  }
  for (int Jt = 0; Jt <= tt; ++Jt)
    for (int k0 = 0; k0 < kT; k0 += kK) {
      const int jj = Jt * kT + k0;
      __syncthreads();
      fill_cols(sA, [&](int k, int c) { return dscr(r0 + c, jj + k); });
      fill_rows(sB, [&](int k, int c) {
        const int j = jj + k, n = n0 + c;
        return j < Q && n < N ? Bg[static_cast<size_t>(j) * N + n] : 0.f;
      });
      __syncthreads();
      tile_fma(acc, sA, sB);
    }
  float* out = dC + static_cast<size_t>(g) * Q * N;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = r0 + 4 * ty + a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int n = n0 + 4 * tx + b;
      if (i < Q && n < N) out[static_cast<size_t>(i) * N + n] = acc[a][b];
    }
  }
}

// ---------------------------------------------------------------- 6. d dA
// Blocks [0, G H): d dA of (chunk g, head h) for every position m in tile
// M = m / 64, t = m % 64: the prefix of T before m, the totals of the
// pairs (I > M, J < M), the column prefixes of the pairs (I >= M, M) and
// the row suffixes of the pairs (M, J < M), all in double. Then blocks
// (chunk g, key tile): dB = the sum of its head-split partials in order.
__global__ void __launch_bounds__(kThreads)
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
    for (int e = tid; e < rows * N; e += kThreads) {
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
      const double t = __shfl_up_sync(0xffffffffu, incl, o);
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
  for (int m = tid; m < Q; m += kThreads) {
    const int M = m / kT, t = m - M * kT;
    double w = sTp[m] + sTot[M];
    for (int It = M; It < nT; ++It)
      w += pp[static_cast<size_t>(It * (It + 1) / 2 + M) * kPart + t];
    for (int Jt = 0; Jt < M; ++Jt)
      w += pp[static_cast<size_t>(M * (M + 1) / 2 + Jt) * kPart + kT + t];
    ddA[(static_cast<size_t>(g) * Q + m) * H + h] = static_cast<float>(w);
  }
}

}  // namespace

// dA [G,Q,H]; xw, dY [G,Q,H,P]; Bm, Cm [G,Q,N]; dS [G,H,P,N] -> ddA [G,Q,H],
// dxw [G,Q,H,P], dB, dC [G,Q,N]. Scratch, with Qp = Q rounded up to 64,
// nP = (Qp / 64)(Qp / 64 + 1) / 2 tile pairs: cum [2, G, H, Qp]; CB [G, Qp,
// Qp]; dSp [G, n_groups, Qp, Qp]; T [G, H, Qp]; part [G, H, nP, 132]; dBp
// [G, n_splits, Qp, N]. All fp32, contiguous, on the device; Q <= 4096;
// 1 <= n_groups, n_splits <= H. Six launches on `stream`; does not
// synchronise; returns the first launch error.
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
  const int nT = tiles(Q), Qp = nT * kT, nN = (N + kT - 1) / kT;
  const long long n_pairs = static_cast<long long>(nT) * (nT + 1) / 2;
  const long long gh = static_cast<long long>(G) * H;
  const long long n_pair_blocks = G * n_pairs * n_groups;
  const long long n_dbdc = static_cast<long long>(G) * nT * nN * (n_splits + 1);
  if (gh * nT > 0x7fffffffLL || n_pair_blocks > 0x7fffffffLL ||
      n_dbdc > 0x7fffffffLL || gh + G * nT > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  float* cumh = cum;
  float* cuml = cum + gh * Qp;
  ssd_bwd_cum_kernel<<<static_cast<unsigned>((gh + 7) / 8), kThreads, 0,
                       stream>>>(dA, cumh, cuml, G, Q, H, Qp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_scores_kernel<<<static_cast<unsigned>(G * n_pairs), kThreads, 0,
                          stream>>>(Bm, Cm, CB, Q, N, Qp,
                                    static_cast<int>(n_pairs));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dxw_kernel<<<static_cast<unsigned>(gh * nT), kThreads, 0,
                       stream>>>(xw, Bm, dY, dS, CB, cumh, cuml, dxw, Tj, G,
                                 Q, H, P, N, Qp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_pairs_kernel<<<static_cast<unsigned>(n_pair_blocks), kThreads, 0,
                         stream>>>(xw, dY, CB, cumh, cuml, dSp, part, Q, H, P,
                                   Qp, static_cast<int>(n_pairs), n_groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dbdc_kernel<<<static_cast<unsigned>(n_dbdc), kThreads, 0,
                        stream>>>(xw, Bm, Cm, dS, dSp, cumh, cuml, dC, dBp, G,
                                  Q, H, P, N, Qp, n_groups, n_splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_final_kernel<<<static_cast<unsigned>(gh + G * nT), kThreads, 0,
                         stream>>>(Tj, part, dBp, ddA, dB, G, Q, H, N, Qp,
                                   static_cast<int>(n_pairs), n_splits);
  return static_cast<int>(cudaGetLastError());
}
