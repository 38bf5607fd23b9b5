// Full-sequence (prefill) attention with an fp32 online softmax, for Hopper
// (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (the Pallas TPU kernel behind repro.kernels.ops.flash_attention, called
// from repro.models.attention._sdpa for gqa_full in prefill/forward).
//
//   out[b,s,h,:] = softmax_k(q[b,s,h,:] . k[b,k,h/G,:] * scale + mask) v[b,k,h/G,:]
//
// with G = H / KV query heads per KV head, a causal mask (k <= s), a
// sliding window (s - k < window, when window > 0), masked scores set to
// NEG_INF = -1e30 as in the reference, and keys past Sk excluded.
//
// What bounds it on this card: arithmetic. A causal prefill of S tokens
// does ~2*B*H*S^2*(hd+vd)/2 flops on 2*B*S*(H*hd + KV*(hd+vd)) bytes of
// inputs and outputs (Mixtral widths, S = 2048: ~69 GFLOP on ~200 MB), far
// above the ridge of either fp32 cores (67 TFLOP/s over 3.35 TB/s, ~20
// flop/byte) or the tensor cores. This first version runs on the fp32 CUDA
// cores, so its floor is the fp32 rate; wgmma/TMA come in a later PR.
//
// What the design does about it:
//  * One block per (batch row, KV head, tile of query positions) computes
//    the G query heads of that KV head together: its 64 rows are G heads x
//    64/G positions, so every K/V tile is read from device memory once per
//    block and used for all G heads (the JAX wrapper repeats K/V per query
//    head instead). K/V are read in place from the [B,S,KV,hd] projections.
//  * The block walks only the key tiles its rows can see: tiles wholly above
//    the causal diagonal or wholly outside the window are skipped (the
//    Pallas grid visits every tile and masks). If some row of the block sees
//    no key at all (only when Sq > Sk with a window), the block walks every
//    tile, and the row ends up uniform over all keys, as in the reference.
//  * The ragged edges (Sq, Sk not multiples of the tile) are masked in the
//    kernel; the Pallas wrapper padded them on the host.
//  * Running max, denominator and the [64 x vd] accumulator stay in shared
//    memory and registers across the block's key loop (the Pallas kernel
//    kept them in VMEM scratch across its sequential grid axis). A row whose
//    first visited tiles are all masked accumulates exp(0) terms against
//    m = -1e30; the first real score rescales them by exp(-1e30 - m) = 0
//    exactly, as in the Pallas kernel.
//  * Q, K and V tiles are staged in shared memory as fp32 (bf16 inputs are
//    widened on load); scores, softmax and P.V accumulate in fp32; the
//    output is written in the input type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;       // query rows per block (G heads x positions)
constexpr int kTile = 32;       // keys per tile: one per lane in the softmax
constexpr int kMaxHd = 256;     // q/k width
constexpr int kMaxG = kRows;    // query heads per KV head
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// dynamic shared memory (floats): Q [kRows][hd]; K tile [kTile][hd + 1]
// (padded: thread tx reading key tx + 16c at dimension d hits bank
// (key * (hd + 1) + d) % 32, distinct for the 16 keys); V tile [kTile][vd];
// scores / weights [kRows][kTile + 1]; per row the running max, the
// denominator and this tile's rescale factor
size_t smem_bytes(int hd, int vd) {
  return sizeof(float) *
         (static_cast<size_t>(kRows) * hd + kTile * (hd + 1) + kTile * vd +
          kRows * (kTile + 1) + 3 * kRows);
}

// VC: output columns per thread / 16, a compile-time bound (vd <= 16 * VC)
// so the accumulator stays in registers
template <typename T, int VC>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int H, int KV, int G, int BQ, int hd, int vd,
                       int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int kp = hd + 1, pp = kTile + 1;
  float* qs = smem;                      // [kRows][hd]
  float* ks = qs + kRows * hd;           // [kTile][hd + 1]
  float* vs = ks + kTile * kp;           // [kTile][vd]
  float* ps = vs + kTile * vd;           // [kRows][kTile + 1]
  float* run_m = ps + kRows * pp;        // [kRows]
  float* run_l = run_m + kRows;          // [kRows]
  float* corr = run_l + kRows;           // [kRows]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, Sq - q0);       // live positions in this tile
  // row r: head g = r / BQ, position q0 + r % BQ; rows past G*BQ or past
  // Sq are idle (zero q, never stored)
  const size_t q_row = static_cast<size_t>(H) * hd;       // one position
  const size_t k_row = static_cast<size_t>(KV) * hd;
  const size_t v_row = static_cast<size_t>(KV) * vd;

  for (int i = tid; i < kRows * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    const int g = r / BQ, s = r - g * BQ;
    float val = 0.f;
    if (g < G && s < nq)
      val = to_f(q[(static_cast<size_t>(b) * Sq + q0 + s) * q_row +
                   static_cast<size_t>(kvh * G + g) * hd + d]);
    qs[i] = val;
  }
  if (tid < kRows) {
    run_m[tid] = kNegInf;
    run_l[tid] = 0.f;
  }

  // keys this tile of positions can see
  const int q_last = q0 + nq - 1;
  int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  int hi = causal ? min(Sk - 1, q_last) : Sk - 1;
  const int lo_last = window > 0 ? max(0, q_last - window + 1) : 0;
  if (lo_last > hi) {  // the last row sees no key: walk them all
    lo = 0;
    hi = Sk - 1;
  }

  float acc[4][VC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < VC; ++c) acc[r][c] = 0.f;

  for (int k0 = (lo / kTile) * kTile; k0 <= hi; k0 += kTile) {
    const int nk = min(kTile, Sk - k0);
    // --- K and V tiles (zeros past Sk: their weight is 0, and 0 * junk
    // could be NaN)
    for (int i = tid; i < kTile * hd; i += kThreads) {
      const int j = i / hd, d = i - j * hd;
      ks[j * kp + d] =
          j < nk ? to_f(k[(static_cast<size_t>(b) * Sk + k0 + j) * k_row +
                          static_cast<size_t>(kvh) * hd + d])
                 : 0.f;
    }
    for (int i = tid; i < kTile * vd; i += kThreads) {
      const int j = i / vd, d = i - j * vd;
      vs[i] = j < nk ? to_f(v[(static_cast<size_t>(b) * Sk + k0 + j) * v_row +
                              static_cast<size_t>(kvh) * vd + d])
                     : 0.f;
    }
    __syncthreads();

    // --- scores: thread (ty, tx) takes rows ty + 16r, keys tx + 16c
    {
      float s[4][2];
#pragma unroll
      for (int r = 0; r < 4; ++r) s[r][0] = s[r][1] = 0.f;
      for (int d = 0; d < hd; ++d) {
        const float k0v = ks[tx * kp + d], k1v = ks[(tx + 16) * kp + d];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float qv = qs[(ty + 16 * r) * hd + d];
          s[r][0] = fmaf(qv, k0v, s[r][0]);
          s[r][1] = fmaf(qv, k1v, s[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = ty + 16 * r;
        const int pos = q0 + row % BQ;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = tx + 16 * c, key = k0 + j;
          float val;
          if (j >= nk) {
            val = -CUDART_INF_F;  // past Sk: no part in the softmax
          } else if ((causal && key > pos) ||
                     (window > 0 && pos - key >= window)) {
            val = kNegInf;
          } else {
            val = s[r][c] * scale;
          }
          ps[row * pp + j] = val;
        }
      }
    }
    __syncthreads();

    // --- online softmax: warp w takes rows w, w + 8, ...; lane = key
    for (int row = warp; row < kRows; row += kThreads / 32) {
      const float sv = ps[row * pp + lane];
      float mt = sv;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = run_m[row];
      const float m_new = fmaxf(m_old, mt);
      const float w = expf(sv - m_new);
      float sum = w;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[row * pp + lane] = w;
      if (lane == 0) {
        const float cr = expf(m_old - m_new);
        corr[row] = cr;
        run_l[row] = run_l[row] * cr + sum;
        run_m[row] = m_new;
      }
    }
    __syncthreads();

    // --- acc = acc * corr + P . V: rows ty + 16r, columns tx + 16c
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float cr = corr[ty + 16 * r];
#pragma unroll
      for (int c = 0; c < VC; ++c) acc[r][c] *= cr;
    }
    for (int j = 0; j < nk; ++j) {
      float vr[VC];
#pragma unroll
      for (int c = 0; c < VC; ++c) {
        const int col = tx + 16 * c;
        vr[c] = col < vd ? vs[j * vd + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float w = ps[(ty + 16 * r) * pp + j];
#pragma unroll
        for (int c = 0; c < VC; ++c) acc[r][c] = fmaf(w, vr[c], acc[r][c]);
      }
    }
    __syncthreads();  // the next tile overwrites ks, vs, ps, corr
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty + 16 * r;
    const int g = row / BQ, s = row - g * BQ;
    if (g >= G || s >= nq) continue;
    const float lg = fmaxf(run_l[row], 1e-30f);
    T* O = out + (static_cast<size_t>(b) * Sq + q0 + s) * H * vd +
           static_cast<size_t>(kvh * G + g) * vd;
#pragma unroll
    for (int c = 0; c < VC; ++c) {
      const int col = tx + 16 * c;
      if (col < vd) store(O + col, acc[r][c] / lg);
    }
  }
}

template <typename T, int VC>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream, const void* q,
                   const void* k, const void* v, void* out, int Sq, int Sk,
                   int H, int KV, int G, int BQ, int hd, int vd, int causal,
                   int window, float scale) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, VC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_attention_kernel<T, VC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, KV, G, BQ,
      hd, vd, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(dim3 grid, size_t smem, cudaStream_t stream,
                     const void* q, const void* k, const void* v, void* out,
                     int Sq, int Sk, int H, int KV, int G, int BQ, int hd,
                     int vd, int causal, int window, float scale) {
  if (vd <= 64)
    return launch<T, 4>(grid, smem, stream, q, k, v, out, Sq, Sk, H, KV, G,
                        BQ, hd, vd, causal, window, scale);
  if (vd <= 128)
    return launch<T, 8>(grid, smem, stream, q, k, v, out, Sq, Sk, H, KV, G,
                        BQ, hd, vd, causal, window, scale);
  return launch<T, 16>(grid, smem, stream, q, k, v, out, Sq, Sk, H, KV, G, BQ,
                       hd, vd, causal, window, scale);
}

}  // namespace

// q [B,Sq,H,hd]; k [B,Sk,KV,hd]; v [B,Sk,KV,vd]; out [B,Sq,H,vd]. All of one
// type (bf16 != 0: bfloat16, else fp32), contiguous, on the device;
// H % KV == 0, H / KV <= 64, hd <= 256, vd <= hd. window 0 means unbounded.
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int bf16, int B,
                                   int Sq, int Sk, int H, int KV, int hd,
                                   int vd, int causal, int window,
                                   float scale, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || vd <= 0) return 0;
  if (Sk <= 0 || KV <= 0 || H % KV != 0 || H / KV > kMaxG || hd <= 0 ||
      hd > kMaxHd || vd > hd || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / KV;
  const int BQ = kRows / G;  // query positions per block
  const size_t smem = smem_bytes(hd, vd);
  const dim3 grid((Sq + BQ - 1) / BQ, B * KV);
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(grid, smem, stream, q, k, v, out, Sq, Sk,
                                     H, KV, G, BQ, hd, vd, causal, window,
                                     scale)
           : dispatch<float>(grid, smem, stream, q, k, v, out, Sq, Sk, H, KV,
                             G, BQ, hd, vd, causal, window, scale);
  return static_cast<int>(err);
}
