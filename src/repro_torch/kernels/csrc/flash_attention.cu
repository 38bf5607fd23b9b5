// Full-sequence (prefill) attention with an fp32 online softmax on the
// tensor cores of Hopper (sm_90a), plain C interface.
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
// does ~2*B*H*S^2*(hd+vd)/2 flops on 2*B*S*(H*hd + KV*(hd+vd)) bytes
// (Mixtral widths, B=2, S=2048: 68.8 GFLOP on 168 MB, which take 0.050 ms
// at 3.35 TB/s). Both products run as warp-level TF32 tensor-core MMAs:
// 68.8 GFLOP take 0.139 ms at the 495 TFLOP/s TF32 rate (1.03 ms at the
// 67 TFLOP/s of the fp32 cores). fp32 inputs need fp32 accuracy (one TF32
// pass leaves ~1e-3 error on the output, six times the 2e-4 tolerance:
// tests/test_torch_kernels.py), so each product is split 3xTF32: three MMA passes put this design's
// floor at 0.42 ms. mma.sync issues from each warp with its operands in
// registers, so the splits, fragment loads and the softmax share the
// issue slots with the MMAs; wgmma (below) is the way past that.
//
// What the design does about it:
//  * One block of 4 warps per (batch row, KV head, tile of query
//    positions) computes the G query heads of that KV head together: its
//    64 rows are G heads x 64/G positions, so every K/V tile is read once
//    per block and serves all G heads. K/V are read in place from the
//    [B,S,KV,hd] projections. Warp w owns rows 16w..16w+15. Blocks are
//    issued longest causal row range first.
//  * S = Q.K^T and O += P.V are mma.sync.m16n8k8 TF32 with fp32
//    accumulators. For an fp32 operand x, hi = tf32(x), lo = tf32(x - hi),
//    rounded to nearest with ties away from zero (cvt.rna.tf32.f32's
//    rounding, computed as (bits + 0x1000) & ~0x1fff: the same bits at
//    full integer rate), and each product is lo.hi + hi.lo + hi.hi: the
//    dropped lo.lo term is ~2^-22 relative, the error of fp32 itself.
//    bf16 widens to TF32 exactly, so for bf16 Q, K and V the lo terms are
//    dropped at compile time (S is one pass, P.V two: P is fp32 and is
//    still split).
//  * The k order of a product is free, so Q.K^T runs its 8 dims of a step
//    as A slot t = dim 2t, slot t + 4 = dim 2t + 1 (and K likewise): each
//    lane loads a Q or K fragment pair with one 8-byte shared load.
//  * The online softmax stays in registers: a row of the m16n8
//    accumulator lives on the 4 lanes of a quad, so the row max is two
//    xor-shuffles, each lane keeps a partial denominator (one quad sum at
//    the end), and the O accumulator is rescaled in registers. Scores are
//    kept in log2 units (scale * log2 e) for exp2f. Tiles that every row
//    of a warp sees whole skip the per-element masks.
//  * P goes from the S accumulator to the P.V A operand with no shared
//    memory and no shuffle. A lane holds P at keys 2t and 2t+1 of each
//    8-key step, while the A operand wants keys t and t+4; A slot t
//    carries key 2t and slot t+4 key 2t+1, and the V fragment is read
//    with the same permutation (rows 2t and 2t+1 of the V tile).
//  * K/V tiles of 16 keys come in through a two-stage cp.async ring
//    (16-byte copies; 8 or 4 bytes where a row or pointer is not 16-byte
//    aligned, element loads where it is not 4-byte aligned): tile j+1
//    loads while tile j computes. Keys past Sk are zero-filled by the
//    copy (src-size 0), so 0 * junk never reaches O. Q is staged once.
//  * Shared-memory rows are padded so the fragment loads of a warp hit
//    distinct banks: Q and K rows (8-byte pair loads, 8 rows x 4 lanes a
//    half-warp) to 8 mod 32 words (fp32) or 8 mod 16 elements (bf16); V
//    rows (rows 2t and 2t+1 x 8 columns) to 16 mod 32 bytes. The columns
//    past hd (or vd) up to the next multiple of 8 are zeroed once, so a
//    ragged hd takes a partial last k-step.
//  * The block walks only the key tiles its rows can see: tiles wholly
//    above the causal diagonal or wholly outside the window are skipped.
//    If some row of the block sees no key at all (only when Sq > Sk with
//    a window), the block walks every tile, and the row ends up uniform
//    over all keys, as in the reference. A row whose first visited tiles
//    are all masked accumulates exp(0) terms against m = -1e30; the first
//    real score rescales them by exp(-1e30 - m) = 0 exactly.
//  * Occupancy: 16-key tiles keep shared memory at 69 KB at hd = vd = 128
//    fp32 (Q 64 x 136, two stages of K 16 x 136 and V 16 x 132 floats),
//    and __launch_bounds__(128, 3) caps registers, so three blocks (12
//    warps) share an SM; 135 KB and one block at hd = vd = 256. The value
//    width is a template bound (<= 64/128/256) so the O accumulator
//    (vd / 8 fragments of 4 floats a lane) stays in registers. ptxas
//    (-Xptxas -v, sm_90a; chip_smoke.py prints it): fp32 122/151/216
//    registers for vd <= 64/128/256, bf16 137/164/249; no spills, no
//    stack; the shared memory is all dynamic.
//
// What wgmma + TMA would add: wgmma issues one 64-row product per
// warpgroup asynchronously from shared memory and is the only path to the
// full TF32 rate, and TMA moves a tile with one thread and an mbarrier
// instead of 128 threads of cp.async. wgmma's TF32 B operand must be
// K-major in shared memory, which V (key-major for P.V) is not, so V would
// be transposed in shared memory on arrival; a producer warp would keep
// the TMA ring full, and the hi/lo splits would be made once a tile in
// shared memory instead of once a fragment in every warp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows a block: G heads x positions
constexpr int kTile = 16;           // keys per K/V tile: 2 mma n-tiles
constexpr int kNT = kTile / 8;
constexpr int kStages = 2;          // cp.async ring depth
constexpr int kMaxHd = 256;         // q/k width
constexpr int kMaxG = kRows;        // query heads per KV head
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
template <typename T>
__device__ __forceinline__ T zero() {
  return T(0.f);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}
// elements p[0], p[1] (p 2-element aligned) as floats
__device__ __forceinline__ void load_pair(const float* p, float& x0,
                                          float& x1) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  x0 = v.x;
  x1 = v.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float& x0,
                                          float& x1) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  x0 = __low2float(v);
  x1 = __high2float(v);
}

// shared-memory row strides (elements) for rows of w elements. Q and K:
// 8 mod 32 words (fp32) or 8 mod 16 elements (bf16); V: 16 mod 32 bytes
template <typename T>
__host__ __device__ __forceinline__ int qk_stride(int w) {
  if (sizeof(T) == 4) {
    const int w8 = (w + 7) & ~7;
    return w8 + ((8 - w8) & 31);
  }
  return (w + 15) / 16 * 16 + 8;
}
template <typename T>
__host__ __device__ __forceinline__ int v_stride(int w) {
  constexpr int e = 32 / static_cast<int>(sizeof(T));
  return (w + e - 1) / e * e + e / 2;
}

// dynamic shared memory: Q [kRows][sq]; K [kStages][kTile][sq];
// V [kStages][kTile][sv]
template <typename T>
size_t smem_bytes(int hd, int vd) {
  return sizeof(T) *
         (static_cast<size_t>(kRows + kStages * kTile) * qk_stride<T>(hd) +
          static_cast<size_t>(kStages * kTile) * v_stride<T>(vd));
}

// Rows [0, nrows) of w elements into dst (stride ds); row r comes from
// src(r), or is zero where src(r) is null. vec: bytes a copy (16, 8, 4;
// every source row and pointer aligned to it), 0 for element loads.
template <typename T, typename Src>
__device__ __forceinline__ void copy_rows(T* dst, int ds, int nrows, int w,
                                          int vec, const T* base, Src src) {
  if (vec == 0) {
    for (int i = threadIdx.x; i < nrows * w; i += kThreads) {
      const int r = i / w, c = i - r * w;
      const T* s = src(r);
      dst[r * ds + c] = s ? s[c] : zero<T>();
    }
    return;
  }
  const int per = vec / static_cast<int>(sizeof(T));
  const int cpr = w / per;  // copies a row
  for (int i = threadIdx.x; i < nrows * cpr; i += kThreads) {
    const int r = i / cpr, c = (i - r * cpr) * per;
    const T* s = src(r);
    T* d = dst + r * ds + c;
    const T* from = s ? s + c : base;
    if (vec == 16)
      cp_async<16>(d, from, s != nullptr);
    else if (vec == 8)
      cp_async<8>(d, from, s != nullptr);
    else
      cp_async<4>(d, from, s != nullptr);
  }
}

// VT: value n-tiles of 8 columns, a compile-time bound (vd <= 8 * VT) so
// the O accumulator stays in registers; up to vd 128 three blocks an SM
template <typename T, int VT>
__global__ void __launch_bounds__(kThreads, VT <= 16 ? 3 : 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int H, int KV, int G, int BQ, int hd, int vd,
                       int causal, int window, float scale, int vec) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sq = qk_stride<T>(hd), sv = v_stride<T>(vd);
  T* qs = reinterpret_cast<T*>(smem_raw);  // [kRows][sq]
  T* ks = qs + kRows * sq;                 // [kStages][kTile][sq]
  T* vs = ks + kStages * kTile * sq;       // [kStages][kTile][sv]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma group, lane in the group
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int nq = min(BQ, Sq - q0);  // live positions in this tile
  const size_t q_row = static_cast<size_t>(H) * hd;  // one position
  const size_t k_row = static_cast<size_t>(KV) * hd;
  const size_t v_row = static_cast<size_t>(KV) * vd;
  const T* kb = k + static_cast<size_t>(b) * Sk * k_row +
                static_cast<size_t>(kvh) * hd;
  const T* vb = v + static_cast<size_t>(b) * Sk * v_row +
                static_cast<size_t>(kvh) * vd;

  // zero the columns past hd / vd that the last k8 step or n8 tile reads
  const int hd8 = (hd + 7) & ~7, vd8 = (vd + 7) & ~7;
  for (int i = tid; i < (kRows + kStages * kTile) * (hd8 - hd); i += kThreads)
    qs[(i / (hd8 - hd)) * sq + hd + i % (hd8 - hd)] = zero<T>();
  for (int i = tid; i < kStages * kTile * (vd8 - vd); i += kThreads)
    vs[(i / (vd8 - vd)) * sv + vd + i % (vd8 - vd)] = zero<T>();

  // row r: head kvh * G + r / BQ, position q0 + r % BQ; rows past G * BQ
  // or past Sq are idle (zero q, never stored)
  copy_rows(qs, sq, kRows, hd, vec, q, [&](int r) -> const T* {
    const int hg = r / BQ, s = r - hg * BQ;
    return hg < G && s < nq
               ? q + (static_cast<size_t>(b) * Sq + q0 + s) * q_row +
                     static_cast<size_t>(kvh * G + hg) * hd
               : nullptr;
  });
  auto load_tile = [&](int tile, int stage) {
    const int k0 = tile * kTile;
    copy_rows(ks + stage * kTile * sq, sq, kTile, hd, vec, k,
              [&](int j) -> const T* {
                return k0 + j < Sk ? kb + static_cast<size_t>(k0 + j) * k_row
                                   : nullptr;
              });
    copy_rows(vs + stage * kTile * sv, sv, kTile, vd, vec, v,
              [&](int j) -> const T* {
                return k0 + j < Sk ? vb + static_cast<size_t>(k0 + j) * v_row
                                   : nullptr;
              });
  };

  // keys this tile of positions can see
  const int q_last = q0 + nq - 1;
  int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  int hi = causal ? min(Sk - 1, q_last) : Sk - 1;
  const int lo_last = window > 0 ? max(0, q_last - window + 1) : 0;
  if (lo_last > hi) {  // the last row sees no key: walk them all
    lo = 0;
    hi = Sk - 1;
  }
  const int tile_lo = lo / kTile, tile_hi = hi / kTile;
  load_tile(tile_lo, 0);
  cp_commit();  // group: Q and the first tile

  // this lane's two rows (h = 0: row g, h = 1: row g + 8 of the warp)
  const int row0 = warp * 16 + g;
  const int pos[2] = {q0 + row0 % BQ, q0 + (row0 + 8) % BQ};
  float m[2] = {kNegInf, kNegInf};  // running max, quad-uniform
  float l[2] = {0.f, 0.f};          // this lane's part of the denominator
  float o[VT][4];
#pragma unroll
  for (int n = 0; n < VT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const int nks = hd8 / 8, nvt = vd8 / 8;
  const T* qw = qs + warp * 16 * sq + 2 * t;
  const float sc = scale * kLog2e;  // scores in log2 units, for exp2f

  for (int tile = tile_lo; tile <= tile_hi; ++tile) {
    const int stage = (tile - tile_lo) & 1;
    if (tile < tile_hi) load_tile(tile + 1, stage ^ 1);
    cp_commit();  // (empty on the last tile: keeps wait_group 1 uniform)
    cp_wait<1>();
    __syncthreads();
    const T* kt = ks + stage * kTile * sq + g * sq + 2 * t;
    const T* vt = vs + stage * kTile * sv;

    // --- S = Q.K^T: this warp's 16 rows x 16 keys, 2 n-tiles of 8 keys;
    // k-step slot t is dim 8kk + 2t, slot t + 4 dim 8kk + 2t + 1
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < nks; ++kk) {
      float x[4];
      load_pair(qw + g * sq + kk * 8, x[0], x[2]);
      load_pair(qw + (g + 8) * sq + kk * 8, x[1], x[3]);
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) frag<kSplit>(x[i], ah[i], al[i]);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        float y0, y1;
        load_pair(kt + j * 8 * sq + kk * 8, y0, y1);
        uint32_t bh[2], bl[2];
        frag<kSplit>(y0, bh[0], bl[0]);
        frag<kSplit>(y1, bh[1], bl[1]);
        mma3<kSplit, kSplit>(s[j], ah, al, bh, bl);
      }
    }

    // --- masks and the online softmax; s[j][e] is row g + 8 * (e >> 1),
    // key k0 + 8j + 2t + (e & 1). A tile every row of the warp sees whole
    // skips the masks.
    const int k0 = tile * kTile, k_end = k0 + kTile - 1;
    const bool whole = __all_sync(
        0xffffffffu, k_end < Sk &&
                         (!causal || k_end <= min(pos[0], pos[1])) &&
                         (window == 0 || max(pos[0], pos[1]) - k0 < window));
    float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, key = k0 + j * 8 + 2 * t + (e & 1);
        float val;
        if (whole) {
          val = s[j][e] * sc;
        } else if (key >= Sk) {
          val = -CUDART_INF_F;  // past Sk: no part in the softmax
        } else if ((causal && key > pos[h]) ||
                   (window > 0 && pos[h] - key >= window)) {
          val = kNegInf;
        } else {
          val = s[j][e] * sc;
        }
        s[j][e] = val;
        mt[h] = fmaxf(mt[h], val);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
      const float m_new = fmaxf(m[h], mt[h]);
      corr[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int n = 0; n < VT; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // --- O += P.V, 8 keys a step; A slot t carries key 2t, slot t + 4
    // key 2t + 1 (the S accumulator's own columns), V rows likewise
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      uint32_t ah[4], al[4];
      frag<true>(s[j][0], ah[0], al[0]);
      frag<true>(s[j][2], ah[1], al[1]);
      frag<true>(s[j][1], ah[2], al[2]);
      frag<true>(s[j][3], ah[3], al[3]);
      const T* v0 = vt + (j * 8 + 2 * t) * sv + g;
#pragma unroll
      for (int n = 0; n < VT; ++n) {
        if (n < nvt) {
          uint32_t bh[2], bl[2];
          frag<kSplit>(to_f(v0[n * 8]), bh[0], bl[0]);
          frag<kSplit>(to_f(v0[sv + n * 8]), bh[1], bl[1]);
          mma3<true, kSplit>(o[n], ah, al, bh, bl);
        }
      }
    }
    __syncthreads();  // the next tile's copies overwrite this stage
  }
  cp_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const int hg = row / BQ, s = row - hg * BQ;
    if (hg >= G || s >= nq) continue;
    const float lg = fmaxf(l[h], 1e-30f);
    T* O = out + (static_cast<size_t>(b) * Sq + q0 + s) * H * vd +
           static_cast<size_t>(kvh * G + hg) * vd;
#pragma unroll
    for (int n = 0; n < VT; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < vd) store(O + col, o[n][2 * h] / lg);
      if (col + 1 < vd) store(O + col + 1, o[n][2 * h + 1] / lg);
    }
  }
}

template <typename T, int VT>
cudaError_t launch(dim3 grid, cudaStream_t stream, const void* q,
                   const void* k, const void* v, void* out, int Sq, int Sk,
                   int H, int KV, int G, int BQ, int hd, int vd, int causal,
                   int window, float scale, int vec) {
  const size_t smem = smem_bytes<T>(hd, vd);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, VT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_attention_kernel<T, VT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, KV, G, BQ,
      hd, vd, causal, window, scale, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(dim3 grid, cudaStream_t stream, const void* q,
                     const void* k, const void* v, void* out, int Sq, int Sk,
                     int H, int KV, int G, int BQ, int hd, int vd, int causal,
                     int window, float scale) {
  int vec = copy_bytes(q, sizeof(T) * hd);
  const int vec_k = copy_bytes(k, sizeof(T) * hd);
  const int vec_v = copy_bytes(v, sizeof(T) * vd);
  if (vec_k < vec) vec = vec_k;
  if (vec_v < vec) vec = vec_v;
  if (vd <= 64)
    return launch<T, 8>(grid, stream, q, k, v, out, Sq, Sk, H, KV, G, BQ, hd,
                        vd, causal, window, scale, vec);
  if (vd <= 128)
    return launch<T, 16>(grid, stream, q, k, v, out, Sq, Sk, H, KV, G, BQ,
                         hd, vd, causal, window, scale, vec);
  return launch<T, 32>(grid, stream, q, k, v, out, Sq, Sk, H, KV, G, BQ, hd,
                       vd, causal, window, scale, vec);
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
  const dim3 grid((Sq + BQ - 1) / BQ, B * KV);
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(grid, stream, q, k, v, out, Sq, Sk, H,
                                     KV, G, BQ, hd, vd, causal, window, scale)
           : dispatch<float>(grid, stream, q, k, v, out, Sq, Sk, H, KV, G, BQ,
                             hd, vd, causal, window, scale);
  return static_cast<int>(err);
}
