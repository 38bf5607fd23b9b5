// Backward of full-sequence attention (the function flash_attention.cu
// computes), fp32, on the CUDA cores of Hopper (sm_90a), plain C interface.
//
// Replaces: nothing in Pallas. The JAX package trains through XLA blockwise
// attention (repro.models.attention, ATTN_IMPL = "xla_blockwise") and has no
// Pallas backward; the port's _sdpa always calls the flash kernel, so on the
// card training needs this kernel.
//
// With P = softmax(S), S[i,j] = scale * q_i . k_j where key j is visible to
// query i, NEG_INF (-1e30) where it is masked (causal, window), and keys
// past Sk absent:
//
//   dV[j]  = sum_i P[i,j] dO[i]
//   dS[i,j] = P[i,j] (dO[i] . v_j - D[i]),  D[i] = dO[i] . O[i]
//   dQ[i]  = scale * sum_j dS[i,j] k_j,  dK[j] = scale * sum_i dS[i,j] q_i
//
// summed over the G = H / KV query heads of a KV head for dK and dV. A
// masked score is a constant: its dS is zero. A row that sees no key at all
// (only Sq > Sk under a window) is uniform over all Sk keys, as in the
// forward: its P is 1 / Sk everywhere, so it feeds dV and nothing else.
//
// Two launches from this source, in order on one stream:
//  (1) rows: one block per (batch row, KV head, tile of query positions),
//      its 64 rows G heads x 64 / G positions as in the forward. Pass 1 walks
//      the visible key tiles once for each row's max m and denominator l
//      (the online softmax, in log2 units) and its output O = P.V in fp32,
//      so D = dO . O comes from the same P as dS: the forward's output is
//      not read (its 3xTF32 error, ~2.5e-5 of max |O| at Qwen1.5-0.5B's
//      first layer, would reach dQ through D at ~7e-5 of max |dQ|, where
//      the P-weighted mean key is large against dQ). Pass 2 walks the tiles
//      again for P = exp2(s - m) / l, dP, dS and dQ, kept in registers.
//      m, 1 / l and D go to a scratch [3, B, Sq, H] for (2).
//  (2) keys: one block per (batch row, KV head, tile of 32 keys) walks the
//      query tiles that can see its keys, every G head of the group in the
//      same block, recomputes S, P, dP and dS from the stats, and keeps dK
//      and dV in registers: each key is written by one block, no atomics.
//
// What bounds it on this card: operations. Per visible (query, key) pair
// and head the two launches do 2*(hd + vd) (pass 1: S, O) + 2*(2*hd + vd)
// (S, dP, dQ) + 2*(2*hd + 2*vd) (S, dP, dV, dK) flops, 10 hd + 8 vd in
// all, on plain fp32 FMA units (67 TFLOP/s): autograd of the forward needs
// S and dP (2 hd + 2 vd) and dQ, dK, dV (4 hd + 2 vd), so the rest is the
// price of keeping no [Sq, Sk] matrix and no forward state but q, k, v.
// Each thread holds a 4 x 2 patch of the 64 x 32 score tile (8 FMAs for
// 6 shared loads a step) and a 4 x w/16 (O, dQ) or 4 x w/32 (dK, dV) patch
// of the accumulators. Tiles are staged with plain loads between barriers,
// no cp.async ring, and no tensor cores: a first kernel that is right.
// wgmma with 3xTF32 splits, as the forward uses, is the way to the rate.
//
// Shared memory rows are padded to an odd number of words, so the 16 key
// (or query) rows a half-warp reads at one column hit 16 distinct banks.
// At hd = vd = 256 a block takes 215 KB (one block an SM); at 128, 117 KB;
// at 64, 68 KB.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;   // query rows a tile: G heads x kRows / G positions
constexpr int kKeys = 32;   // keys a tile
constexpr int kMaxHd = 256;
constexpr int kMaxG = kRows;
constexpr int kPS = kKeys + 1;  // row stride of the P and dS tiles
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ __forceinline__ int pad(int w) { return w | 1; }

struct Shape {
  int B, Sq, Sk, H, KV, G, BP, hd, vd, causal, window;
  float scale;
};

// dynamic shared memory (floats): Q [kRows][pad(hd)], dO [kRows][pad(vd)],
// K [kKeys][pad(hd)], V [kKeys][pad(vd)], P and dS [kRows][kPS], and the
// rows' m, 1 / l, D [3][kRows]
size_t smem_bytes(int hd, int vd) {
  return sizeof(float) *
         (static_cast<size_t>(kRows + kKeys) * (pad(hd) + pad(vd)) +
          2 * kRows * kPS + 3 * kRows);
}

struct Smem {
  float *q, *dout, *k, *v, *p, *ds, *m, *il, *d;
  int sq, sv;
  __device__ Smem(float* base, int hd, int vd) : sq(pad(hd)), sv(pad(vd)) {
    q = base;
    dout = q + kRows * sq;
    k = dout + kRows * sv;
    v = k + kKeys * sq;
    p = v + kKeys * sv;
    ds = p + kRows * kPS;
    m = ds + kRows * kPS;
    il = m + kRows;
    d = il + kRows;
  }
};

// row r of a query tile starting at position q0: head kvh * G + r / BP,
// position q0 + r % BP; live iff r / BP < G and the position < Sq
__device__ __forceinline__ bool row_live(const Shape& sh, int q0, int r,
                                         int& head_in_group, int& pos) {
  head_in_group = r / sh.BP;
  pos = q0 + r - head_in_group * sh.BP;
  return head_in_group < sh.G && pos < sh.Sq;
}

// the query tile's rows of src [B, Sq, H, w] into dst (stride ds); dead
// rows are zero
__device__ void load_rows(float* dst, int ds, const float* __restrict__ src,
                          int w, const Shape& sh, int b, int kvh, int q0) {
  for (int i = threadIdx.x; i < kRows * w; i += kThreads) {
    const int r = i / w, c = i - r * w;
    int hg, pos;
    float x = 0.f;
    if (row_live(sh, q0, r, hg, pos))
      x = src[((static_cast<size_t>(b) * sh.Sq + pos) * sh.H + kvh * sh.G +
               hg) * w + c];
    dst[r * ds + c] = x;
  }
}

// keys k0 .. k0 + kKeys - 1 of src [B, Sk, KV, w] into dst; keys past Sk
// are zero
__device__ void load_keys(float* dst, int ds, const float* __restrict__ src,
                          int w, const Shape& sh, int b, int kvh, int k0) {
  for (int i = threadIdx.x; i < kKeys * w; i += kThreads) {
    const int j = i / w, c = i - j * w;
    dst[j * ds + c] =
        k0 + j < sh.Sk
            ? src[((static_cast<size_t>(b) * sh.Sk + k0 + j) * sh.KV + kvh) *
                      w + c]
            : 0.f;
  }
}

// acc[i][j] = a[4 ty + i] . b[2 tx + j] over w columns: this thread's 4 x 2
// patch of a 64 x 32 product of row tiles (Q.K^T, dO.V^T)
__device__ __forceinline__ void dot_tile(float (&acc)[4][2], const float* a,
                                         int sa, const float* b, int sb,
                                         int w, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.f;
  const float* a0 = a + 4 * ty * sa;
  const float* b0 = b + 2 * tx * sb;
#pragma unroll 4
  for (int c = 0; c < w; ++c) {
    const float y0 = b0[c], y1 = b0[sb + c];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = a0[i * sa + c];
      acc[i][0] = fmaf(x, y0, acc[i][0]);
      acc[i][1] = fmaf(x, y1, acc[i][1]);
    }
  }
}

// 0: visible; 1: masked (NEG_INF, no gradient); 2: past Sk (no part)
__device__ __forceinline__ int key_state(const Shape& sh, int pos, int key) {
  if (key >= sh.Sk) return 2;
  if ((sh.causal && key > pos) || (sh.window > 0 && pos - key >= sh.window))
    return 1;
  return 0;
}

// scores in log2 units, as the online softmax keeps them
__device__ __forceinline__ float score2(const Shape& sh, int state, float s) {
  return state == 0 ? s * sh.scale * kLog2e
                    : (state == 1 ? kNegInf : -CUDART_INF_F);
}

// the key tiles [lo, hi] that query positions [q0, q_last] can see; every
// tile if the last position sees no key (it is uniform over all of them)
__device__ __forceinline__ void key_range(const Shape& sh, int q0,
                                          int q_last, int& lo, int& hi) {
  int k_lo = sh.window > 0 ? max(0, q0 - sh.window + 1) : 0;
  int k_hi = sh.causal ? min(sh.Sk - 1, q_last) : sh.Sk - 1;
  const int lo_last = sh.window > 0 ? max(0, q_last - sh.window + 1) : 0;
  if (lo_last > k_hi) {
    k_lo = 0;
    k_hi = sh.Sk - 1;
  }
  lo = k_lo / kKeys;
  hi = k_hi / kKeys;
}

// sum over the 16 lanes of a half-warp (one ty)
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// (1) rows: stats and dQ. HC: O and dQ columns a thread, tx + 16 c
// (hd <= 16 HC)
template <int HC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout, float* __restrict__ dq,
                      float* __restrict__ stats, Shape sh) {
  extern __shared__ __align__(16) float smem[];
  Smem s(smem, sh.hd, sh.vd);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.y / sh.KV, kvh = blockIdx.y % sh.KV;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * sh.BP;  // longest first
  const int q_last = min(q0 + sh.BP, sh.Sq) - 1;
  load_rows(s.q, s.sq, q, sh.hd, sh, b, kvh, q0);
  load_rows(s.dout, s.sv, dout, sh.vd, sh, b, kvh, q0);

  int hg[4], pos[4];
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) live[i] = row_live(sh, q0, 4 * ty + i, hg[i], pos[i]);

  int t_lo, t_hi;
  key_range(sh, q0, q_last, t_lo, t_hi);

  // pass 1: each row's max, denominator (log2 units) and unnormalised
  // output o = sum exp2(s - m) v, rescaled as m grows
  float m[4], l[4];
  float acc[4][HC];  // o in pass 1, dQ in pass 2
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < HC; ++c) acc[i][c] = 0.f;
  }
  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kKeys;
    __syncthreads();
    load_keys(s.k, s.sq, k, sh.hd, sh, b, kvh, k0);
    load_keys(s.v, s.sv, v, sh.vd, sh, b, kvh, k0);
    __syncthreads();
    float sc[4][2];
    dot_tile(sc, s.q, s.sq, s.k, s.sq, sh.hd, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        x[j] = score2(sh, key_state(sh, pos[i], k0 + 2 * tx + j), sc[i][j]);
      const float m_new = fmaxf(m[i], half_max(fmaxf(x[0], x[1])));
      const float corr = exp2f(m[i] - m_new);
      const float p0 = exp2f(x[0] - m_new), p1 = exp2f(x[1] - m_new);
      l[i] = l[i] * corr + p0 + p1;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < HC; ++c) acc[i][c] *= corr;
      s.p[(4 * ty + i) * kPS + 2 * tx] = p0;
      s.p[(4 * ty + i) * kPS + 2 * tx + 1] = p1;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = s.p[(4 * ty + i) * kPS + j];
#pragma unroll
      for (int c = 0; c < HC; ++c) {
        const int col = tx + 16 * c;
        if (col < sh.vd) {
          const float y = s.v[j * s.sv + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(x[i], y, acc[i][c]);
        }
      }
    }
  }
  float il[4], dd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    il[i] = 1.f / half_sum(l[i]);
    // D = dO . O over the row, O = o / l
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < HC; ++c) {
      const int col = tx + 16 * c;
      if (col < sh.vd)
        part = fmaf(s.dout[(4 * ty + i) * s.sv + col], acc[i][c], part);
    }
    dd[i] = half_sum(part) * il[i];
    if (live[i] && tx == 0) {
      const size_t at =
          (static_cast<size_t>(b) * sh.Sq + pos[i]) * sh.H + kvh * sh.G + hg[i];
      const size_t plane = static_cast<size_t>(sh.B) * sh.Sq * sh.H;
      stats[at] = m[i];
      stats[plane + at] = il[i];
      stats[2 * plane + at] = dd[i];
    }
  }

  // pass 2: P, dP, dS and dQ += dS.K
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < HC; ++c) acc[i][c] = 0.f;
  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kKeys;
    __syncthreads();
    load_keys(s.k, s.sq, k, sh.hd, sh, b, kvh, k0);
    load_keys(s.v, s.sv, v, sh.vd, sh, b, kvh, k0);
    __syncthreads();
    float sc[4][2], dp[4][2];
    dot_tile(sc, s.q, s.sq, s.k, s.sq, sh.hd, ty, tx);
    dot_tile(dp, s.dout, s.sv, s.v, s.sv, sh.vd, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int st = key_state(sh, pos[i], k0 + 2 * tx + j);
        const float p = exp2f(score2(sh, st, sc[i][j]) - m[i]) * il[i];
        s.ds[(4 * ty + i) * kPS + 2 * tx + j] =
            st == 0 ? p * (dp[i][j] - dd[i]) : 0.f;
      }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = s.ds[(4 * ty + i) * kPS + j];
#pragma unroll
      for (int c = 0; c < HC; ++c) {
        const int col = tx + 16 * c;
        if (col < sh.hd) {
          const float y = s.k[j * s.sq + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(x[i], y, acc[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!live[i]) continue;
    float* row = dq + ((static_cast<size_t>(b) * sh.Sq + pos[i]) * sh.H +
                       kvh * sh.G + hg[i]) * sh.hd;
#pragma unroll
    for (int c = 0; c < HC; ++c) {
      const int col = tx + 16 * c;
      if (col < sh.hd) row[col] = acc[i][c] * sh.scale;
    }
  }
}

// (2) keys: dK and dV. KC: columns a thread, cx + 32 c (hd, vd <= 32 KC)
template <int KC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_keys_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ stats, float* __restrict__ dk,
                      float* __restrict__ dv, Shape sh) {
  extern __shared__ __align__(16) float smem[];
  Smem s(smem, sh.hd, sh.vd);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int ky = tid >> 5, cx = tid & 31;  // keys 4 ky .. 4 ky + 3
  const int b = blockIdx.y / sh.KV, kvh = blockIdx.y % sh.KV;
  const int k0 = blockIdx.x * kKeys;  // small k0 sees the most rows: first
  const int k_last = min(k0 + kKeys, sh.Sk) - 1;
  load_keys(s.k, s.sq, k, sh.hd, sh, b, kvh, k0);
  load_keys(s.v, s.sv, v, sh.vd, sh, b, kvh, k0);

  // the positions that can see these keys; all of them from the first row
  // that sees no key at all (it is uniform over every key)
  const int p_lo = sh.causal ? k0 : 0;
  int p_hi = sh.window > 0 ? min(sh.Sq - 1, k_last + sh.window - 1)
                           : sh.Sq - 1;
  if (sh.window > 0 && sh.Sk + sh.window - 1 <= sh.Sq - 1) p_hi = sh.Sq - 1;
  const size_t plane = static_cast<size_t>(sh.B) * sh.Sq * sh.H;

  float ak[4][KC], av[4][KC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < KC; ++c) ak[i][c] = av[i][c] = 0.f;
  for (int t = p_lo / sh.BP; t <= p_hi / sh.BP && p_lo <= p_hi; ++t) {
    const int q0 = t * sh.BP;
    __syncthreads();
    load_rows(s.q, s.sq, q, sh.hd, sh, b, kvh, q0);
    load_rows(s.dout, s.sv, dout, sh.vd, sh, b, kvh, q0);
    for (int r = tid; r < kRows; r += kThreads) {
      int hg, pos;
      float mm = 0.f, ii = 0.f, dd = 0.f;  // dead rows: P = 0
      if (row_live(sh, q0, r, hg, pos)) {
        const size_t at =
            (static_cast<size_t>(b) * sh.Sq + pos) * sh.H + kvh * sh.G + hg;
        mm = stats[at];
        ii = stats[plane + at];
        dd = stats[2 * plane + at];
      }
      s.m[r] = mm;
      s.il[r] = ii;
      s.d[r] = dd;
    }
    __syncthreads();
    float sc[4][2], dp[4][2];
    dot_tile(sc, s.q, s.sq, s.k, s.sq, sh.hd, ty, tx);
    dot_tile(dp, s.dout, s.sv, s.v, s.sv, sh.vd, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      int hg, pos;
      row_live(sh, q0, r, hg, pos);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int st = key_state(sh, pos, k0 + 2 * tx + j);
        const float p = exp2f(score2(sh, st, sc[i][j]) - s.m[r]) * s.il[r];
        s.p[r * kPS + 2 * tx + j] = p;
        s.ds[r * kPS + 2 * tx + j] = st == 0 ? p * (dp[i][j] - s.d[r]) : 0.f;
      }
    }
    __syncthreads();
    // dV += P^T.dO, dK += dS^T.Q over the tile's rows
#pragma unroll 2
    for (int r = 0; r < kRows; ++r) {
      float pp[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pp[i] = s.p[r * kPS + 4 * ky + i];
        dsv[i] = s.ds[r * kPS + 4 * ky + i];
      }
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const int col = cx + 32 * c;
        if (col < sh.vd) {
          const float y = s.dout[r * s.sv + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i][c] = fmaf(pp[i], y, av[i][c]);
        }
        if (col < sh.hd) {
          const float y = s.q[r * s.sq + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) ak[i][c] = fmaf(dsv[i], y, ak[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ky + i;
    if (key >= sh.Sk) continue;
    const size_t row = (static_cast<size_t>(b) * sh.Sk + key) * sh.KV + kvh;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const int col = cx + 32 * c;
      if (col < sh.hd) dk[row * sh.hd + col] = ak[i][c] * sh.scale;
      if (col < sh.vd) dv[row * sh.vd + col] = av[i][c];
    }
  }
}

template <int W>
cudaError_t launch(const Shape& sh, cudaStream_t stream, const float* q,
                   const float* k, const float* v, const float* dout,
                   float* dq, float* dk, float* dv, float* stats) {
  const size_t smem = smem_bytes(sh.hd, sh.vd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_rows_kernel<W / 16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_keys_kernel<W / 32>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 rows_grid((sh.Sq + sh.BP - 1) / sh.BP, sh.B * sh.KV);
  flash_bwd_rows_kernel<W / 16><<<rows_grid, kThreads, smem, stream>>>(
      q, k, v, dout, dq, stats, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 keys_grid((sh.Sk + kKeys - 1) / kKeys, sh.B * sh.KV);
  flash_bwd_keys_kernel<W / 32><<<keys_grid, kThreads, smem, stream>>>(
      q, k, v, dout, stats, dk, dv, sh);
  return cudaGetLastError();
}

}  // namespace

// q, dq [B,Sq,H,hd]; k, dk [B,Sk,KV,hd]; v, dv [B,Sk,KV,vd]; dout
// [B,Sq,H,vd]; stats a scratch of 3 * B * Sq * H floats. fp32, contiguous,
// on the device; H % KV == 0, H / KV <= 64, hd <= 256, vd <= hd. window 0
// means unbounded. Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int flash_attention_bwd(const float* q, const float* k,
                                   const float* v, const float* dout,
                                   float* dq, float* dk, float* dv,
                                   float* stats, int B, int Sq, int Sk, int H,
                                   int KV, int hd, int vd, int causal,
                                   int window, float scale,
                                   cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || hd <= 0) return 0;
  if (Sk <= 0 || KV <= 0 || H % KV != 0 || H / KV > kMaxG || hd > kMaxHd ||
      vd <= 0 || vd > hd || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Shape sh;
  sh.B = B;
  sh.Sq = Sq;
  sh.Sk = Sk;
  sh.H = H;
  sh.KV = KV;
  sh.G = H / KV;
  sh.BP = kRows / sh.G;
  sh.hd = hd;
  sh.vd = vd;
  sh.causal = causal;
  sh.window = window;
  sh.scale = scale;
  cudaError_t err;
  if (hd <= 64)
    err = launch<64>(sh, stream, q, k, v, dout, dq, dk, dv, stats);
  else if (hd <= 128)
    err = launch<128>(sh, stream, q, k, v, dout, dq, dk, dv, stats);
  else
    err = launch<256>(sh, stream, q, k, v, dout, dq, dk, dv, stats);
  return static_cast<int>(err);
}
