// Grouped-expert SwiGLU FFN for Hopper (sm_90a), plain C interface.
//
//   y[e] = (silu(x[e] @ w1[s]) * (x[e] @ w3[s])) @ w2[s],   s = slots[e]
//
// Replaces: src/repro/kernels/moe_gemm.py::moe_gemm_pallas (the Pallas TPU
// kernel behind repro.kernels.ops.moe_ffn, which the offload engine's
// _grouped_ffn calls for every chunk of resident experts).
//
// What bounds it on this card: the bytes of the expert weights. On the
// decode path every expert computes the whole batch, C <= 8 rows, so each
// fp32 weight (4 bytes) feeds 2*C flops: at C = 4 that is 2 flop/byte,
// against the ~20 flop/byte (67 TFLOP/s fp32 over 3.35 TB/s) where fp32
// arithmetic would start to bind. The kernel is a weight stream; tensor
// cores (wgmma) and TMA pipelines buy nothing until C is in the hundreds.
//
// What the design does about it:
//  * Every weight byte is read once from device memory (for C <= kRows),
//    with coalesced 16-byte loads (float4 a lane) whenever the widths are
//    multiples of 4 and the pointers 16-byte aligned, 4-byte loads
//    otherwise. Ragged C, d and F are masked in-kernel (the Pallas wrapper
//    padded them on the host instead).
//  * The Pallas grid carries the second product's fp32 sum across
//    sequential F steps. Hopper blocks run in no order, so each product is
//    split over its contraction axis into slices of at most kSliceMax
//    rows, one block per (column tile, expert, slice), each writing an
//    fp32 partial sum; a small deterministic pass adds the partials (no
//    atomics). Four launches: up-projection partials (w1 and w3 together)
//    -> a = silu(sum h) * sum g -> down-projection partials (w2) -> y.
//    The split gives ~1800 blocks at Mixtral widths with 4 experts, so
//    every SM streams several tiles at once.
//  * A block stages its slice of the activations (x or a) in shared
//    memory once, then each warp issues kUnroll rows of weight loads
//    before their FMAs, keeping many loads in flight per SM.
//  * Weights are read in place from the expert cache's slot buffers
//    through slots[e]: no gather copy of 704 MB per Mixtral expert.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;        // warps per block, splitting slice rows
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;         // activation rows (C) per pass over a tile
constexpr int kUnroll = 4;       // weight rows a warp loads before its FMAs
constexpr int kSliceMax = 1024;  // contraction rows per block, at most
// shared memory: the activation slice [kSliceMax][kRows], reused for the
// cross-warp reduction [kWarps][kRows][32 * VEC] (VEC <= 4)
constexpr int kSmemFloats = kSliceMax * kRows;
static_assert(kWarps * kRows * 128 <= kSmemFloats, "reduction must fit");

template <int VEC>
__device__ __forceinline__ void load_cols(const float* __restrict__ row,
                                          int col, int n, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    // n % 4 == 0 and col % 4 == 0, so col < n means the whole float4 fits
    if (col < n) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(row + col));
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.f;
    }
  } else {
    v[0] = col < n ? __ldg(row + col) : 0.f;
  }
}

// part[m][ks][e][c][n] = sum_{k in slice ks} in[e][c][k] * W_m[s][k][n]
// for the NMAT weight matrices W_0 (and W_1), s = slots[e].
// Grid: (column tiles of 32*VEC, experts, slices).
template <int VEC, int NMAT>
__global__ void __launch_bounds__(kThreads)
skinny_partial(const float* __restrict__ in, const float* __restrict__ w0,
               const float* __restrict__ w1, const int* __restrict__ slots,
               float* __restrict__ part0, float* __restrict__ part1, int E,
               int C, int K, int N, int slice) {
  constexpr int TW = 32 * VEC;
  constexpr int PER = kRows * TW / kThreads;
  __shared__ __align__(16) float smem[kSmemFloats];
  const int e = blockIdx.y, ks = blockIdx.z;
  const int n0 = blockIdx.x * TW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = n0 + lane * VEC;
  const int k0 = ks * slice;
  const int len = min(slice, K - k0);
  const size_t wbase = static_cast<size_t>(slots[e]) * K * N;
  const float* W[2] = {w0 + wbase, NMAT > 1 ? w1 + wbase : nullptr};
  float* P[2] = {part0, part1};
  const float* X = in + static_cast<size_t>(e) * C * K;

  for (int c0 = 0; c0 < C; c0 += kRows) {
    const int nc = min(kRows, C - c0);
    // stage in[e][c0 + c][k0 + j] as smem[j * kRows + c]; zeros past the
    // slice (up to the kUnroll rows the loop below reads) and past C, so
    // the FMA loop needs no branch
    const int rows = (len + kUnroll - 1) / kUnroll * kUnroll;
    for (int i = threadIdx.x; i < rows * kRows; i += kThreads) {
      const int c = i / rows, j = i % rows;
      smem[j * kRows + c] =
          (c < nc && j < len)
              ? __ldg(X + static_cast<size_t>(c0 + c) * K + k0 + j)
              : 0.f;
    }
    __syncthreads();

    float acc[NMAT][kRows][VEC];
#pragma unroll
    for (int m = 0; m < NMAT; ++m)
#pragma unroll
      for (int c = 0; c < kRows; ++c)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[m][c][v] = 0.f;

    for (int r0 = warp * kUnroll; r0 < len; r0 += kWarps * kUnroll) {
      float u[kUnroll][NMAT][VEC];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
#pragma unroll
        for (int m = 0; m < NMAT; ++m) {
          if (r0 + j < len) {
            load_cols<VEC>(W[m] + static_cast<size_t>(k0 + r0 + j) * N,
                           col, N, u[j][m]);
          } else {
#pragma unroll
            for (int v = 0; v < VEC; ++v) u[j][m][v] = 0.f;
          }
        }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const float4* xr =
            reinterpret_cast<const float4*>(smem + (r0 + j) * kRows);
        const float4 xa = xr[0], xb = xr[1];   // kRows == 8
        const float xv[kRows] = {xa.x, xa.y, xa.z, xa.w,
                                 xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int m = 0; m < NMAT; ++m)
#pragma unroll
          for (int c = 0; c < kRows; ++c)
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              acc[m][c][v] = fmaf(xv[c], u[j][m][v], acc[m][c][v]);
      }
    }
    __syncthreads();  // the activation slice is dead; smem turns reduction

#pragma unroll
    for (int m = 0; m < NMAT; ++m) {
      float* red = smem;  // [kWarps][kRows][TW]
#pragma unroll
      for (int c = 0; c < kRows; ++c)
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          red[(warp * kRows + c) * TW + lane * VEC + v] = acc[m][c][v];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        const int c = idx / TW, n = n0 + idx % TW;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[(w * kRows + c) * TW + idx % TW];
        if (c < nc && n < N)
          P[m][((static_cast<size_t>(ks) * E + e) * C + c0 + c) * N + n] = s;
      }
      __syncthreads();
    }
  }
}

// a[i] = silu(sum_ks h[ks][i]) * sum_ks g[ks][i],  i over E*C*F
__global__ void swiglu_finish(const float* __restrict__ h,
                              const float* __restrict__ g,
                              float* __restrict__ a, size_t n, int ks) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float hs = 0.f, gs = 0.f;
    for (int k = 0; k < ks; ++k) {
      hs += h[k * n + i];
      gs += g[k * n + i];
    }
    a[i] = hs / (1.f + expf(-hs)) * gs;
  }
}

// y[i] = sum_ks part[ks][i],  i over E*C*d
__global__ void sum_partials(const float* __restrict__ part,
                             float* __restrict__ y, size_t n, int ks) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < ks; ++k) s += part[k * n + i];
    y[i] = s;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

int elementwise_blocks(size_t n) {
  const size_t blocks = (n + 255) / 256;
  return static_cast<int>(blocks < 4096 ? blocks : 4096);
}

template <int VEC>
void launch(const float* x, const float* w1, const float* w3,
            const float* w2, const int* slots, float* hp, float* gp,
            float* a, float* yp, float* y, int E, int C, int d, int F,
            int ks_up, int ks_down, cudaStream_t stream) {
  constexpr int TW = 32 * VEC;
  const size_t n_a = static_cast<size_t>(E) * C * F;
  const size_t n_y = static_cast<size_t>(E) * C * d;
  skinny_partial<VEC, 2><<<dim3((F + TW - 1) / TW, E, ks_up), kThreads, 0,
                           stream>>>(x, w1, w3, slots, hp, gp, E, C, d, F,
                                     (d + ks_up - 1) / ks_up);
  swiglu_finish<<<elementwise_blocks(n_a), 256, 0, stream>>>(hp, gp, a, n_a,
                                                            ks_up);
  skinny_partial<VEC, 1><<<dim3((d + TW - 1) / TW, E, ks_down), kThreads, 0,
                           stream>>>(a, w2, nullptr, slots, yp, nullptr, E, C,
                                     F, d, (F + ks_down - 1) / ks_down);
  sum_partials<<<elementwise_blocks(n_y), 256, 0, stream>>>(yp, y, n_y,
                                                           ks_down);
}

}  // namespace

// x [E,C,d]; w1/w3 [S,d,F]; w2 [S,F,d]; slots [E] int32 in [0,S);
// scratch: hp/gp [ks_up,E,C,F], a [E,C,F], yp [ks_down,E,C,d]; y [E,C,d]
// out. The contraction slices ceil(d/ks_up) and ceil(F/ks_down) must not
// exceed 1024 rows. All fp32, contiguous, on the device. Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int moe_ffn_f32(const float* x, const float* w1, const float* w3,
                           const float* w2, const int* slots, float* hp,
                           float* gp, float* a, float* yp, float* y, int E,
                           int C, int d, int F, int ks_up, int ks_down,
                           cudaStream_t stream) {
  if (E <= 0 || C <= 0 || d <= 0 || F <= 0) return 0;
  if (ks_up < 1 || ks_down < 1 || (d + ks_up - 1) / ks_up > kSliceMax ||
      (F + ks_down - 1) / ks_down > kSliceMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = d % 4 == 0 && F % 4 == 0 && aligned16(w1) &&
                    aligned16(w3) && aligned16(w2);
  if (vec4)
    launch<4>(x, w1, w3, w2, slots, hp, gp, a, yp, y, E, C, d, F, ks_up,
              ks_down, stream);
  else
    launch<1>(x, w1, w3, w2, slots, hp, gp, a, yp, y, E, C, d, F, ks_up,
              ks_down, stream);
  return static_cast<int>(cudaGetLastError());
}
