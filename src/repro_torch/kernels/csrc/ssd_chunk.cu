// Mamba2 SSD intra-chunk step on the tensor cores of Hopper (sm_90a),
// fp32 accuracy, plain C interface.
//
// Replaces: src/repro/kernels/ssd_chunk.py::ssd_chunk_pallas (the Pallas TPU
// kernel behind repro.kernels.ops.ssd_chunk, called from
// repro.models.ssm.ssd_full). For every chunk g and head h:
//
//   cum_i     = sum_{j<=i} dA[g,j,h]
//   Y[g,i,h]  = sum_{j<=i} exp(cum_i - cum_j) (C[g,i] . B[g,j]) xw[g,j,h]
//   S[g,h]    = sum_j exp(cum_{Q-1} - cum_j) xw[g,j,h] (x) B[g,j]
//
// What bounds it on this card: issue slots, under arithmetic. At
// Mamba2-2.7B widths (H 80, P 64, N 128, Q 256, G 16 chunks a call) the
// call needs 11.0 GFLOP (causal Y ~Q^2/2*H*P*2, S Q*H*P*N*2, scores
// Q^2/2*N*2 a chunk) on 215 MB of inputs and outputs: 0.164 ms at the
// 67 TFLOP/s of the fp32 cores, 0.022 ms at the 495 TFLOP/s TF32 rate,
// 0.064 ms for the bytes at 3.35 TB/s. All three products run as
// warp-level TF32 tensor-core MMAs. fp32 inputs need fp32 accuracy (one
// TF32 pass leaves ~5e-4 of max|y| on Y, 24 times the 2e-5 tolerance:
// tests/test_torch_kernels.py), so every product is split 3xTF32: three
// passes over the 12.3 GFLOP the blocks do (diagonal tiles whole) take
// 0.074 ms. mma.sync issues from each warp with its operands in
// registers, so the A operand's decay exponentials and hi/lo splits and
// the fragment loads share the issue slots with the MMAs.
//
// What the design does about it:
//  * Two launches under one call. The first computes the score matrix
//    C.B^T of every chunk, [G, Q, Q] (64 x 64 tiles on and below the
//    diagonal), into a scratch buffer: it does not depend on the head,
//    so it is computed once for all H heads (the TPU kernel recomputed
//    it per block of heads) and, at 4 MB on the main path, stays in L2
//    for the second launch. The decay matrix [G, Q, Q, H], the reason
//    the TPU kernel exists, never reaches device memory.
//  * The second launch holds two kinds of blocks of 4 warps. An "S"
//    block owns (chunk, head, 64 P x 64 N) and contracts over the whole
//    chunk; a "Y" block owns (chunk, head, 64 rows, 64 P) and walks the
//    32-key tiles at or below its rows. S blocks and the Y blocks of the
//    last row tiles do the most work and are issued first, so the tail
//    of the launch is the short Y blocks.
//  * Products are mma.sync.m16n8k8 TF32 with fp32 accumulators. For an
//    fp32 operand x, hi = tf32(x), lo = tf32(x - hi), rounded to nearest
//    with ties away from zero (cvt.rna.tf32.f32's rounding, computed as
//    (bits + 0x1000) & ~0x1fff), and each product is lo.hi + hi.lo +
//    hi.hi: the dropped lo.lo term is ~2^-22 relative, fp32's own error.
//  * The decay lives in registers. A Y warp loads its A fragment of the
//    score tile from shared memory, multiplies it by exp(cum_i - cum_j)
//    (zero above the diagonal; tiles every row of the warp sees whole
//    skip the mask) and only then splits it. The k order of a product
//    is free, so A slot t carries key 2t and slot t + 4 key 2t + 1: a
//    lane reads its two keys of a row with one 8-byte load. The S
//    blocks read xw transposed as their A operand the same way and
//    weight it by exp(cum_end - cum_j), kept per key in shared memory,
//    before the split.
//  * The B operand (xw for Y, B for S) is the same for the 4 warps, so
//    the block splits each tile once as it arrives, into hi/lo pairs of
//    keys 2t and 2t + 1 side by side: a lane reads both keys' hi and lo
//    with one 16-byte load and does no split arithmetic for B.
//  * Each Y block holds one head's 16 x 64 accumulator a warp (32
//    registers a lane) and no score tile, so no score is recomputed.
//    ptxas: 128 registers, no spills; 55.8 KB of shared memory at Q 256,
//    so four blocks (16 warps) share an SM.
//  * Tiles come in through a two-stage cp.async ring (16-byte copies; 8
//    or 4 bytes where a row is not 16-byte aligned): tile s + 1 loads
//    while tile s computes. Rows past Q and columns past N or P are
//    zero-filled by the copy (src-size 0), so ragged edges and a
//    partial last k8 step need no masks. The score scratch's rows are
//    padded to a multiple of 4 floats, so its copies are always 16 bytes.
//  * Shared-memory rows that warps read as fragments are padded so the
//    loads hit distinct banks: 40 floats for rows read as 8-byte pairs (8
//    rows x 4 lanes a half-warp), 68 for rows read at 2t and 2t + 1 (8
//    columns x 4 lanes), 66 float4s for the split tiles.
//  * cum is scanned per block in double (a lane's serial segment, then a
//    shuffle scan) and kept as a pair of floats, hi + lo, and cum_i -
//    cum_j is taken as (hi_i - hi_j) + (lo_i - lo_j). A single fp32 cum
//    rounds each value by up to 2^-24 |cum|: over a 4096-position chunk
//    (|cum| ~ 330 at dA ~ -|N(0, 0.1)|) that moves a decay near the
//    diagonal by up to 2 * 2^-24 * 330 ~ 4e-5 relative, twice the
//    tolerance; the pair leaves the exponent only the error of the
//    difference itself. Any Q <= 4096, H, P and N.
//
// What wgmma + TMA would add: wgmma issues a 64-row product per
// warpgroup from shared memory and is the only way to the full TF32 rate.
// The Y product's A operand (decay times scores) is made in registers, so
// it would be written to shared memory (hi and lo) for wgmma to read, or
// fed from registers, which wgmma allows for A; a producer warp would keep
// a TMA ring full.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows a block: Y rows, S P-rows, scores
constexpr int kCols = 64;           // P or N columns a block; score keys
constexpr int kNF = kCols / 8;      // n8 fragments a warp
constexpr int kStep = 32;           // keys (Y, S) or dims (scores) a stage
constexpr int kKS = kStep / 8;      // k8 steps a stage
constexpr int kStages = 2;          // cp.async ring depth
constexpr int kMaxQ = 4096;         // chunk length
constexpr int kSP = kStep + 8;      // row stride, rows read as 8-byte pairs
constexpr int kSR = kCols + 4;      // row stride, rows read at 2t and 2t+1
constexpr int kSH = kCols + 2;      // float4s a key-pair row of a split tile
constexpr float kLog2e = 1.4426950408889634f;

// floats of one ring stage: scores (C and B, 64 rows x 32 dims each,
// stride kSP); Y (score tile 64 rows x 32 keys, stride kSP; xw 32 keys x
// 64 P, unpadded); S (xw 32 keys x 64 P, stride kSR; B 32 keys x 64 N,
// unpadded). The unpadded tiles are B operands, read only by split_tile.
constexpr int kStageScores = 2 * kRows * kSP;
constexpr int kStageY = kRows * kSP + kStep * kCols;
constexpr int kStageS = kStep * kSR + kStep * kCols;
constexpr int kStageMain = kStageY > kStageS ? kStageY : kStageS;

__host__ __device__ __forceinline__ int pad64(int q) { return (q + 63) & ~63; }
__host__ __device__ __forceinline__ int pad4(int q) { return (q + 3) & ~3; }

// the A fragment of x[0..3] (rows g, g+8 at slot t; rows g, g+8 at t+4)
__device__ __forceinline__ void split_a(const float (&x)[4], uint32_t (&ah)[4],
                                        uint32_t (&al)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) frag<true>(x[i], ah[i], al[i]);
}
// A B-operand tile b (kStep keys x kCols columns, unpadded) split once
// for the whole block: hl[k][c] = {hi(b[2k][c]), hi(b[2k+1][c]),
// lo(b[2k][c]), lo(b[2k+1][c])}, rows of kSH float4s (kSH = 2 mod 8: the
// 16-byte loads of 8 lanes, 4 key pairs x 2 columns, hit distinct banks)
__device__ __forceinline__ void split_tile(const float* b, float4* hl) {
  for (int i = threadIdx.x; i < (kStep / 2) * kCols; i += kThreads) {
    const int kp = i / kCols, c = i - kp * kCols;
    uint32_t h0, l0, h1, l1;
    frag<true>(b[2 * kp * kCols + c], h0, l0);
    frag<true>(b[(2 * kp + 1) * kCols + c], h1, l1);
    hl[kp * kSH + c] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                                   __uint_as_float(l0), __uint_as_float(l1));
  }
}
// c[n] += a . B over kNF n8 fragments (the first nf live); b0 points at
// this lane's key pair (slot t: key 2t, slot t + 4: key 2t + 1) and
// column g of a split tile, column 8n is b0[8n]
__device__ __forceinline__ void mma_row(float (&c)[kNF][4],
                                        const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4],
                                        const float4* b0, int nf) {
#pragma unroll
  for (int n = 0; n < kNF; ++n) {
    if (n < nf) {
      const float4 v = b0[n * 8];
      const uint32_t bh[2] = {__float_as_uint(v.x), __float_as_uint(v.y)};
      const uint32_t bl[2] = {__float_as_uint(v.z), __float_as_uint(v.w)};
      mma3<true, true>(c[n], ah, al, bh, bl);
    }
  }
}

// Rows [0, nrows) of W floats into dst (stride ds). Row r comes from
// src(r), or is zero where src(r) is null; columns at or past lim are
// zero. vec: bytes a copy (16, 8 or 4), which every source row, `base`
// and 4 * lim are aligned to.
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

// cum[0..Q) + lo[0..Q) = the prefix sums of dA[g, :, h], summed in
// double (cum its rounding to fp32, lo the rest); both 0 on [Q, pad64(Q)).
// Warp 0 scans: a lane's serial segment, then a shuffle scan of the
// segment totals. Ends with __syncthreads().
__device__ void scan_cum(const float* __restrict__ dA, float* cum, float* lo,
                         int g, int Q, int H, int h) {
  const int Qp = pad64(Q);
  for (int i = threadIdx.x; i < Qp; i += kThreads) {
    cum[i] = i < Q ? dA[(static_cast<size_t>(g) * Q + i) * H + h] : 0.f;
    lo[i] = 0.f;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int seg = (Q + 31) / 32;
    const int a = min(Q, lane * seg), e = min(Q, a + seg);
    double run = 0.0;
    for (int j = a; j < e; ++j) run += cum[j];
    double incl = run;  // inclusive scan of the segment totals
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    double acc = incl - run;
    for (int j = a; j < e; ++j) {
      acc += cum[j];
      const float hi = static_cast<float>(acc);
      cum[j] = hi;
      lo[j] = static_cast<float>(acc - hi);
    }
  }
  __syncthreads();
}

// --------------------------------------------------------------- scores
// CB[g, i, j] = C[g, i] . B[g, j] for the 64 x 64 tiles (it, jt <= it);
// CB rows are Qs = pad4(Q) floats. Block: (chunk, tile pair); warp w
// owns rows 16w..16w+15 and all 64 keys.
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scores_kernel(const float* __restrict__ Bm,
                        const float* __restrict__ Cm, float* __restrict__ CB,
                        int Q, int N, int n_pairs, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t = lane & 3;
  const int g = blockIdx.x / n_pairs;
  int it = 0, rem = blockIdx.x - g * n_pairs;  // pair -> (it, jt <= it)
  while (rem > it) rem -= ++it;
  const int jt = rem;
  const int i0 = it * kRows, j0 = jt * kCols;
  const float* Cg = Cm + static_cast<size_t>(g) * Q * N;
  const float* Bg = Bm + static_cast<size_t>(g) * Q * N;

  auto load = [&](int n0, int stage) {
    float* cs = smem + stage * kStageScores;
    float* bs = cs + kRows * kSP;
    copy_rows<kStep>(cs, kSP, kRows, vec, N - n0, Cg, [&](int r) {
      return i0 + r < Q ? Cg + static_cast<size_t>(i0 + r) * N + n0
                        : static_cast<const float*>(nullptr);
    });
    copy_rows<kStep>(bs, kSP, kCols, vec, N - n0, Bg, [&](int r) {
      return j0 + r < Q ? Bg + static_cast<size_t>(j0 + r) * N + n0
                        : static_cast<const float*>(nullptr);
    });
  };

  float acc[kNF][4];
#pragma unroll
  for (int n = 0; n < kNF; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int steps = (N + kStep - 1) / kStep;
  load(0, 0);
  cp_commit();
  for (int s = 0; s < steps; ++s) {
    const int stage = s & 1;
    if (s + 1 < steps) load((s + 1) * kStep, stage ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* cs = smem + stage * kStageScores + (warp * 16 + g8) * kSP + 2 * t;
    const float* bs = smem + stage * kStageScores + kRows * kSP + g8 * kSP + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      // slot t = dim 8kk + 2t, slot t + 4 = dim 8kk + 2t + 1
      const float2 r0 = *reinterpret_cast<const float2*>(cs + kk * 8);
      const float2 r1 = *reinterpret_cast<const float2*>(cs + 8 * kSP + kk * 8);
      const float x[4] = {r0.x, r1.x, r0.y, r1.y};
      uint32_t ah[4], al[4];
      split_a(x, ah, al);
#pragma unroll
      for (int n = 0; n < kNF; ++n) {
        const float2 y = *reinterpret_cast<const float2*>(bs + n * 8 * kSP + kk * 8);
        uint32_t bh[2], bl[2];
        frag<true>(y.x, bh[0], bl[0]);
        frag<true>(y.y, bh[1], bl[1]);
        mma3<true, true>(acc[n], ah, al, bh, bl);
      }
    }
    __syncthreads();  // the next stage's copies overwrite this one
  }
  cp_wait<0>();

  // acc[n][e]: row 16w + g8 + 8 (e >> 1), key 8n + 2t + (e & 1)
  const int Qs = pad4(Q);
  float* out = CB + static_cast<size_t>(g) * Q * Qs;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + warp * 16 + g8 + 8 * h;
    if (i >= Q) continue;
#pragma unroll
    for (int n = 0; n < kNF; ++n) {
      const int j = j0 + n * 8 + 2 * t;  // even, and Qs is a multiple of 4
      if (j < Qs)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(i) * Qs + j) =
            make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
    }
  }
}

// ----------------------------------------------------------------- Y, S
// Blocks [0, n_s): S blocks (chunk, head, P tile, N tile); then Y blocks
// (row tile, from the last; chunk, head, P tile).
__global__ void __launch_bounds__(kThreads, 4)
ssd_chunk_kernel(const float* __restrict__ dA, const float* __restrict__ xw,
                 const float* __restrict__ Bm, const float* __restrict__ CB,
                 float* __restrict__ Y, float* __restrict__ S, int G, int Q,
                 int H, int P, int N, int n_s, int vec_x, int vec_b) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                            // [kStages][kStageMain]
  float4* hl = reinterpret_cast<float4*>(    // [kStep / 2][kSH], split B
      smem + kStages * kStageMain);
  float* cum = smem + kStages * kStageMain + 4 * (kStep / 2) * kSH;
  float* clo = cum + pad64(Q);                   // cum [pad64(Q)], hi; lo
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t = lane & 3;
  const int nP = (P + kCols - 1) / kCols;
  const size_t xw_row = static_cast<size_t>(H) * P;  // one position
  float acc[kNF][4];
#pragma unroll
  for (int n = 0; n < kNF; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  if (static_cast<int>(blockIdx.x) < n_s) {
    // ------------------------------------------------------------ S block
    // S[p][n] = sum_j (xw[j][p] w_j) B[j][n], w_j = exp(cum_end - cum_j):
    // A = the weighted xw tile read transposed, B = the B tile
    const int nN = (N + kCols - 1) / kCols;
    int id = blockIdx.x;
    const int nt = id % nN;
    id /= nN;
    const int pt = id % nP;
    id /= nP;
    const int h = id % H, g = id / H;
    const int p0 = pt * kCols, n0 = nt * kCols;
    const float* xg = xw + static_cast<size_t>(g) * Q * xw_row +
                      static_cast<size_t>(h) * P + p0;
    const float* Bg = Bm + static_cast<size_t>(g) * Q * N + n0;
    auto load = [&](int j0, int stage) {
      float* xs = ring + stage * kStageMain;
      float* bs = xs + kStep * kSR;
      copy_rows<kCols>(xs, kSR, kStep, vec_x, P - p0, xg, [&](int r) {
        return j0 + r < Q ? xg + (j0 + r) * xw_row
                          : static_cast<const float*>(nullptr);
      });
      copy_rows<kCols>(bs, kCols, kStep, vec_b, N - n0, Bg, [&](int r) {
        return j0 + r < Q ? Bg + static_cast<size_t>(j0 + r) * N
                          : static_cast<const float*>(nullptr);
      });
    };
    load(0, 0);
    cp_commit();
    scan_cum(dA, cum, clo, g, Q, H, h);
    const float c_end = cum[Q - 1], c_end_lo = clo[Q - 1];
    __syncthreads();
    for (int j = tid; j < pad64(Q); j += kThreads)  // weights; 0 past Q
      cum[j] = j < Q ? exp2f(((c_end - cum[j]) + (c_end_lo - clo[j])) *
                             kLog2e)
                     : 0.f;
    __syncthreads();

    const int nf = min(kNF, (N - n0 + 7) / 8);
    const int steps = (Q + kStep - 1) / kStep;
    for (int s = 0; s < steps; ++s) {
      const int stage = s & 1;
      if (s + 1 < steps) load((s + 1) * kStep, stage ^ 1);
      cp_commit();
      cp_wait<1>();
      __syncthreads();
      split_tile(ring + stage * kStageMain + kStep * kSR, hl);
      __syncthreads();
      const float* xs = ring + stage * kStageMain + 2 * t * kSR + warp * 16 + g8;
      const float* w = cum + s * kStep + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        // slot t = key 8kk + 2t, slot t + 4 = key 8kk + 2t + 1
        const float2 wk = *reinterpret_cast<const float2*>(w + kk * 8);
        const float* x0 = xs + kk * 8 * kSR;
        const float x[4] = {x0[0] * wk.x, x0[8] * wk.x, x0[kSR] * wk.y,
                            x0[kSR + 8] * wk.y};
        uint32_t ah[4], al[4];
        split_a(x, ah, al);
        mma_row(acc, ah, al, hl + (4 * kk + t) * kSH + g8, nf);
      }
      __syncthreads();
    }
    cp_wait<0>();
    // acc[n][e]: P row p0 + 16w + g8 + 8 (e >> 1), N column n0 + 8n + 2t + (e & 1)
    float* Sh = S + (static_cast<size_t>(g) * H + h) * P * N;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = p0 + warp * 16 + g8 + 8 * hh;
      if (p >= P) continue;
      float* row = Sh + static_cast<size_t>(p) * N;
#pragma unroll
      for (int n = 0; n < kNF; ++n) {
        const int c = n0 + n * 8 + 2 * t;
        if (c < N) row[c] = acc[n][2 * hh];
        if (c + 1 < N) row[c + 1] = acc[n][2 * hh + 1];
      }
    }
    return;
  }

  // -------------------------------------------------------------- Y block
  // Y[i][p] = sum_{j <= i} exp(cum_i - cum_j) CB[i][j] xw[j][p]: A = the
  // score tile times the decay, B = the xw tile
  const int nQ = (Q + kRows - 1) / kRows;
  int id = blockIdx.x - n_s;
  const int per_tile = G * H * nP;
  const int it = nQ - 1 - id / per_tile;  // the longest rows first
  id %= per_tile;
  const int pt = id % nP;
  id /= nP;
  const int h = id % H, g = id / H;
  const int i0 = it * kRows, p0 = pt * kCols;
  const int Qs = pad4(Q);
  const float* cbg = CB + static_cast<size_t>(g) * Q * Qs;
  const float* xg = xw + static_cast<size_t>(g) * Q * xw_row +
                    static_cast<size_t>(h) * P + p0;
  auto load = [&](int j0, int stage) {
    float* cs = ring + stage * kStageMain;
    float* xs = cs + kRows * kSP;
    copy_rows<kStep>(cs, kSP, kRows, 16, Qs - j0, cbg, [&](int r) {
      return i0 + r < Q ? cbg + static_cast<size_t>(i0 + r) * Qs + j0
                        : static_cast<const float*>(nullptr);
    });
    copy_rows<kCols>(xs, kCols, kStep, vec_x, P - p0, xg, [&](int r) {
      return j0 + r < Q ? xg + (j0 + r) * xw_row
                        : static_cast<const float*>(nullptr);
    });
  };
  load(0, 0);
  cp_commit();
  scan_cum(dA, cum, clo, g, Q, H, h);

  const int row = i0 + warp * 16 + g8;  // this lane's rows: row, row + 8
  const float ci0 = cum[row], ci1 = cum[row + 8];
  const float cl0 = clo[row], cl1 = clo[row + 8];
  const int nf = min(kNF, (P - p0 + 7) / 8);
  const int steps = min(i0 + kRows, Q) / kStep +
                    (min(i0 + kRows, Q) % kStep != 0);
  for (int s = 0; s < steps; ++s) {
    const int stage = s & 1;
    if (s + 1 < steps) load((s + 1) * kStep, stage ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int j0 = s * kStep;
    // every key of the tile at or before every row of this warp
    const bool whole = j0 + kStep - 1 <= i0 + warp * 16;
    const float* cs = ring + stage * kStageMain + (warp * 16 + g8) * kSP + 2 * t;
    split_tile(ring + stage * kStageMain + kRows * kSP, hl);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      // slot t = key j0 + 8kk + 2t, slot t + 4 = that key + 1
      const int key = j0 + kk * 8 + 2 * t;
      const float2 r0 = *reinterpret_cast<const float2*>(cs + kk * 8);
      const float2 r1 = *reinterpret_cast<const float2*>(cs + 8 * kSP + kk * 8);
      const float2 cj = *reinterpret_cast<const float2*>(cum + key);
      const float2 lj = *reinterpret_cast<const float2*>(clo + key);
      float x[4] = {
          exp2f(((ci0 - cj.x) + (cl0 - lj.x)) * kLog2e) * r0.x,
          exp2f(((ci1 - cj.x) + (cl1 - lj.x)) * kLog2e) * r1.x,
          exp2f(((ci0 - cj.y) + (cl0 - lj.y)) * kLog2e) * r0.y,
          exp2f(((ci1 - cj.y) + (cl1 - lj.y)) * kLog2e) * r1.y};
      if (!whole) {  // above the diagonal: 0 (a select: exp may be inf)
        x[0] = key <= row ? x[0] : 0.f;
        x[1] = key <= row + 8 ? x[1] : 0.f;
        x[2] = key + 1 <= row ? x[2] : 0.f;
        x[3] = key + 1 <= row + 8 ? x[3] : 0.f;
      }
      uint32_t ah[4], al[4];
      split_a(x, ah, al);
      mma_row(acc, ah, al, hl + (4 * kk + t) * kSH + g8, nf);
    }
    __syncthreads();
  }
  cp_wait<0>();
  // acc[n][e]: row row + 8 (e >> 1), P column p0 + 8n + 2t + (e & 1)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = row + 8 * hh;
    if (i >= Q) continue;
    float* Yr = Y + (static_cast<size_t>(g) * Q + i) * xw_row +
                static_cast<size_t>(h) * P;
#pragma unroll
    for (int n = 0; n < kNF; ++n) {
      const int c = p0 + n * 8 + 2 * t;
      if (c < P) Yr[c] = acc[n][2 * hh];
      if (c + 1 < P) Yr[c + 1] = acc[n][2 * hh + 1];
    }
  }
}

}  // namespace

// dA [G,Q,H]; xw [G,Q,H,P]; Bm/Cm [G,Q,N] -> Y [G,Q,H,P], S [G,H,P,N];
// CB is scratch of G * Q * ((Q + 3) & ~3) floats (the score matrices). All
// fp32, contiguous, on the device; Q <= 4096. Two launches on `stream`;
// does not synchronise; returns the first launch error.
extern "C" int ssd_chunk_f32(const float* dA, const float* xw, const float* Bm,
                             const float* Cm, float* Y, float* S, float* CB,
                             int G, int Q, int H, int P, int N,
                             cudaStream_t stream) {
  if (G <= 0 || Q <= 0 || H <= 0 || P <= 0 || N <= 0) return 0;
  if (Q > kMaxQ) return static_cast<int>(cudaErrorInvalidValue);
  int vec_b = copy_bytes(Bm, sizeof(float) * N);
  const int vec_c = copy_bytes(Cm, sizeof(float) * N);
  if (vec_c < vec_b) vec_b = vec_c;
  const int vec_x = copy_bytes(xw, sizeof(float) * P);
  if (vec_b == 0 || vec_x == 0 ||
      reinterpret_cast<uintptr_t>(CB) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nQ = (Q + kRows - 1) / kRows, nP = (P + kCols - 1) / kCols;
  const int nN = (N + kCols - 1) / kCols;
  const long long n_pairs = static_cast<long long>(nQ) * (nQ + 1) / 2;
  const long long n_s = static_cast<long long>(G) * H * nP * nN;
  const long long n_y = static_cast<long long>(G) * nQ * H * nP;
  if (G * n_pairs > 0x7fffffffLL || n_s + n_y > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);

  const size_t smem_scores = sizeof(float) * kStages * kStageScores;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_scores));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_scores_kernel<<<static_cast<unsigned>(G * n_pairs), kThreads,
                            smem_scores, stream>>>(
      Bm, Cm, CB, Q, N, static_cast<int>(n_pairs), vec_b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem = sizeof(float) * (static_cast<size_t>(kStages) *
                                          kStageMain + 2 * pad64(Q)) +
                      sizeof(float4) * (kStep / 2) * kSH;
  err = cudaFuncSetAttribute(ssd_chunk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_kernel<<<static_cast<unsigned>(n_s + n_y), kThreads, smem,
                     stream>>>(dA, xw, Bm, CB, Y, S, G, Q, H, P, N,
                               static_cast<int>(n_s), vec_x, vec_b);
  return static_cast<int>(cudaGetLastError());
}
