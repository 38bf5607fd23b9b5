// Mamba2 SSD intra-chunk step for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/ssd_chunk.py::ssd_chunk_pallas (the Pallas TPU
// kernel behind repro.kernels.ops.ssd_chunk, called from
// repro.models.ssm.ssd_full). For every chunk g and head h:
//
//   cum_i     = sum_{j<=i} dA[g,j,h]
//   Y[g,i,h]  = sum_{j<=i} exp(cum_i - cum_j) (C[g,i] . B[g,j]) xw[g,j,h]
//   S[g,h]    = sum_j exp(cum_{Q-1} - cum_j) xw[g,j,h] (x) B[g,j]
//
// What bounds it on this card: arithmetic. At Mamba2-2.7B widths (H 80,
// P 64, N 128, Q 256) one chunk does ~0.7 GFLOP (causal Y ~Q^2/2*H*P*2,
// S ~Q*H*P*N*2, scores Q^2*N*2) on ~13 MB of inputs and outputs, ~50
// flop/byte, above the fp32 ridge (67 TFLOP/s over 3.35 TB/s, ~20
// flop/byte). This first version runs on the fp32 CUDA cores.
//
// What the design does about it:
//  * The [Q, Q] decay matrix never reaches device memory (the XLA path in
//    repro/kernels/ref.py materialises it as [G, Q, Q, H], which is the TPU
//    kernel's reason to exist): a block builds it 64 x 64 at a time in
//    shared memory, as exp(cum_i - cum_j) times the score tile, and uses it
//    at once.
//  * One launch covers every chunk of every sequence (G = batch x chunks):
//    the intra-chunk outputs do not depend on the carried state. The launch
//    holds two kinds of blocks. A "Y" block owns (chunk, 64 rows, 4 heads,
//    64 columns of P): for each key tile at or below its rows it computes
//    the score tile C_I . B_J^T once and reuses it for its 4 heads (the
//    Pallas kernel reused it over block_h heads). Key tiles above the
//    diagonal are skipped. An "S" block owns (chunk, head, 64 x 64 of
//    P x N) and contracts over the chunk's Q positions.
//  * No block_h divisor search: any H, Q, P and N; ragged edges are masked
//    in the kernel.
//  * Each block scans dA for its heads in shared memory (a warp per head:
//    per-lane serial sums over a segment, then a shuffle scan).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;          // tile edge: rows, keys, P and N columns
constexpr int kTp = kT + 1;     // padded row of a shared tile
constexpr int kHeads = 4;       // heads per Y block
constexpr int kMaxQ = 4096;     // chunk length (shared memory for cum)

// cum[h][0..Q) = inclusive prefix sum of dA[g, :, h0 + h] for nh heads;
// warp w scans head w (nh <= 8). Ends with __syncthreads().
__device__ void scan_heads(const float* __restrict__ dA, float* cum, int g,
                           int Q, int H, int h0, int nh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < nh * Q; i += kThreads) {
    const int hh = i / Q, j = i - hh * Q;
    cum[i] = dA[(static_cast<size_t>(g) * Q + j) * H + h0 + hh];
  }
  __syncthreads();
  if (warp < nh) {
    float* c = cum + warp * Q;
    const int seg = (Q + 31) / 32;
    const int a = min(Q, lane * seg), e = min(Q, a + seg);
    float run = 0.f;
    for (int j = a; j < e; ++j) {
      run += c[j];
      c[j] = run;
    }
    float incl = run;  // inclusive scan of the segment totals
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    const float offset = incl - run;
    for (int j = a; j < e; ++j) c[j] += offset;
  }
  __syncthreads();
}

// dynamic shared memory (floats), the larger of the two roles:
//  Y: cum [kHeads][Q], C tile, B tile, decay-weighted score tile
//     [kT][kTp] each, xw tile [kT][kT]
//  S: cum [Q], xw tile (weighted) [kT][kT], B tile [kT][kT]
size_t smem_bytes(int Q) {
  const size_t y = static_cast<size_t>(kHeads) * Q + 3 * kT * kTp + kT * kT;
  const size_t s = static_cast<size_t>(Q) + 2 * kT * kT;
  return sizeof(float) * (y > s ? y : s);
}

__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ dA, const float* __restrict__ xw,
                 const float* __restrict__ Bm, const float* __restrict__ Cm,
                 float* __restrict__ Y, float* __restrict__ S, int G, int Q,
                 int H, int P, int N, int n_y_blocks) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int nQ = (Q + kT - 1) / kT, nP = (P + kT - 1) / kT;
  const int nHg = (H + kHeads - 1) / kHeads;
  const size_t xw_row = static_cast<size_t>(H) * P;  // one position

  if (static_cast<int>(blockIdx.x) < n_y_blocks) {
    // ------------------------------------------------------------ Y block
    int id = blockIdx.x;
    const int pt = id % nP;
    id /= nP;
    const int hg = id % nHg;
    id /= nHg;
    const int it = id % nQ;
    const int g = id / nQ;
    const int h0 = hg * kHeads, nh = min(kHeads, H - h0);
    const int i0 = it * kT, p0 = pt * kT;

    float* cum = smem;                       // [kHeads][Q]
    float* cs = cum + kHeads * Q;            // C tile [kT][kTp]
    float* bs = cs + kT * kTp;               // B tile [kT][kTp]
    float* ms = bs + kT * kTp;               // decay * scores [kT][kTp]
    float* xs = ms + kT * kTp;               // xw tile [kT][kT]
    scan_heads(dA, cum, g, Q, H, h0, nh);

    float acc[kHeads][4][4];
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[hh][r][c] = 0.f;

    const float* Cg = Cm + static_cast<size_t>(g) * Q * N;
    const float* Bg = Bm + static_cast<size_t>(g) * Q * N;
    for (int j0 = 0; j0 <= i0; j0 += kT) {
      // scores[i][j] = C[i0 + i] . B[j0 + j]: rows ty + 16r, keys tx + 16c
      float sc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;
      for (int n0 = 0; n0 < N; n0 += kT) {
        for (int i = tid; i < kT * kT; i += kThreads) {
          const int r = i / kT, n = i - r * kT;
          const bool nok = n0 + n < N;
          cs[r * kTp + n] = nok && i0 + r < Q
                                ? Cg[static_cast<size_t>(i0 + r) * N + n0 + n]
                                : 0.f;
          bs[r * kTp + n] = nok && j0 + r < Q
                                ? Bg[static_cast<size_t>(j0 + r) * N + n0 + n]
                                : 0.f;
        }
        __syncthreads();
        for (int n = 0; n < kT; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = cs[(ty + 16 * r) * kTp + n];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = bs[(tx + 16 * c) * kTp + n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) sc[r][c] = fmaf(cv[r], bv[c], sc[r][c]);
        }
        __syncthreads();
      }
      // unrolled with a block-uniform guard, so acc[hh] stays in registers
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh) {
        if (hh >= nh) break;
        const float* ch = cum + hh * Q;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx + 16 * c;
            ms[(ty + 16 * r) * kTp + tx + 16 * c] =
                j <= i && i < Q ? expf(ch[i] - ch[j]) * sc[r][c] : 0.f;
          }
        }
        const int h = h0 + hh;
        for (int i = tid; i < kT * kT; i += kThreads) {
          const int j = i / kT, p = i - j * kT;
          xs[i] = j0 + j < Q && p0 + p < P
                      ? xw[(static_cast<size_t>(g) * Q + j0 + j) * xw_row +
                           static_cast<size_t>(h) * P + p0 + p]
                      : 0.f;
        }
        __syncthreads();
        const int jn = min(kT, Q - j0);
        for (int j = 0; j < jn; ++j) {
          float xv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) xv[c] = xs[j * kT + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float m = ms[(ty + 16 * r) * kTp + j];
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[hh][r][c] = fmaf(m, xv[c], acc[hh][r][c]);
          }
        }
        __syncthreads();
      }
    }
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      if (hh >= nh) break;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i >= Q) continue;
        float* Yr = Y + (static_cast<size_t>(g) * Q + i) * xw_row +
                    static_cast<size_t>(h0 + hh) * P;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = p0 + tx + 16 * c;
          if (p < P) Yr[p] = acc[hh][r][c];
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- S block
  int id = blockIdx.x - n_y_blocks;
  const int nN = (N + kT - 1) / kT;
  const int nt = id % nN;
  id /= nN;
  const int pt = id % nP;
  id /= nP;
  const int h = id % H;
  const int g = id / H;
  const int p0 = pt * kT, n0 = nt * kT;

  float* cum = smem;                         // [Q]
  float* xs = cum + Q;                       // weighted xw [kT j][kT p]
  float* bs = xs + kT * kT;                  // B tile [kT j][kT n]
  scan_heads(dA, cum, g, Q, H, h, 1);
  const float c_end = cum[Q - 1];

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  const float* Bg = Bm + static_cast<size_t>(g) * Q * N;
  for (int j0 = 0; j0 < Q; j0 += kT) {
    for (int i = tid; i < kT * kT; i += kThreads) {
      const int j = i / kT, t = i - j * kT;
      const bool jok = j0 + j < Q;
      xs[i] = jok && p0 + t < P
                  ? xw[(static_cast<size_t>(g) * Q + j0 + j) * xw_row +
                       static_cast<size_t>(h) * P + p0 + t] *
                        expf(c_end - cum[j0 + j])
                  : 0.f;
      bs[i] = jok && n0 + t < N
                  ? Bg[static_cast<size_t>(j0 + j) * N + n0 + t]
                  : 0.f;
    }
    __syncthreads();
    const int jn = min(kT, Q - j0);
    for (int j = 0; j < jn; ++j) {
      float xv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) xv[r] = xs[j * kT + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = bs[j * kT + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xv[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }
  float* Sh = S + (static_cast<size_t>(g) * H + h) * P * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = p0 + ty + 16 * r;
    if (p >= P) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx + 16 * c;
      if (n < N) Sh[static_cast<size_t>(p) * N + n] = acc[r][c];
    }
  }
}

}  // namespace

// dA [G,Q,H]; xw [G,Q,H,P]; Bm/Cm [G,Q,N] -> Y [G,Q,H,P], S [G,H,P,N]. All
// fp32, contiguous, on the device; Q <= 4096. One launch on `stream`; does
// not synchronise; returns cudaGetLastError().
extern "C" int ssd_chunk_f32(const float* dA, const float* xw, const float* Bm,
                             const float* Cm, float* Y, float* S, int G, int Q,
                             int H, int P, int N, cudaStream_t stream) {
  if (G <= 0 || Q <= 0 || H <= 0 || P <= 0 || N <= 0) return 0;
  if (Q > kMaxQ) return static_cast<int>(cudaErrorInvalidValue);
  const int nQ = (Q + kT - 1) / kT, nP = (P + kT - 1) / kT;
  const int nN = (N + kT - 1) / kT, nHg = (H + kHeads - 1) / kHeads;
  const long long n_y = static_cast<long long>(G) * nQ * nHg * nP;
  const long long n_s = static_cast<long long>(G) * H * nP * nN;
  if (n_y + n_s > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(Q);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_kernel<<<static_cast<unsigned>(n_y + n_s), kThreads, smem,
                     stream>>>(dA, xw, Bm, Cm, Y, S, G, Q, H, P, N,
                               static_cast<int>(n_y));
  return static_cast<int>(cudaGetLastError());
}
