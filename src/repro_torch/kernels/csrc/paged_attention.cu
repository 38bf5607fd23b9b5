// Single-token GQA decode attention through a block table, for Hopper
// (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/paged_attention.py::paged_attention_pallas
// (the Pallas TPU kernel behind repro.kernels.ops.paged_attention, called
// from repro.models.attention.gqa_decode_paged).
//
// What bounds it on this card: at decode sizes, latency. Each key and
// value row is read once and used for G = H / KV query heads (4 at
// Mixtral widths): ~4 flop per byte of K/V, far below the fp32 ridge, so
// bytes bind in principle. But a decode call moves well under a
// megabyte (a few rows, tens to hundreds of keys), which the card streams
// in well under a microsecond; what remains is the chain of dependent
// memory round trips inside a block, how many bytes one SM can have in
// flight (a block's tile copies land only as fast as its SM takes them),
// and how few blocks there are. Long rows (thousands of keys) are bound
// by bytes, spread over as many SMs as their splits.
//
// What the design does about it:
//  * Keys are split over blocks: block (split s, KV head, batch row) takes
//    the row's keys [s * S, (s + 1) * S) for a fixed split length S (a
//    multiple of the 32-key tile, chosen by the launcher), for all G query
//    heads of its KV head, so every K/V row is fetched once and used G
//    times. Blocks past the row's last visible key exit at once.
//  * Round trips a block waits on: (1) its row's position and its split's
//    table entries, loaded together (the entries do not depend on the
//    position); (2) the K/V tiles, brought into shared memory by 16-byte
//    cp.async copies (8 or 4 bytes where a row or pointer is not 16-byte
//    aligned), every copy of a tile issued before any is waited on, in a
//    two-stage ring: tile t + 1's copies are in flight while tile t is
//    scored and folded. Masked keys and table entries outside [0, N) are
//    zero-filled by the copy (src-size 0) and never read.
//  * A tile is scored from shared memory: a warp per query head, a lane
//    per key (16-byte shared loads, rows padded so a quarter-warp hits
//    distinct banks), fp32 online softmax (two shuffle reductions, one exp
//    a lane); then every thread folds P.V into the head dims it owns.
//  * A row with one split writes its output directly. A row with more
//    writes each split's running max, denominator and unnormalised output
//    to scratch (allocated by the launcher), and the row is combined in
//    split order, so its result depends only on its own position and keys
//    (and S), never on B, the other rows, or T past its keys.
//  * Masking follows the reference exactly: keys at logical index > pos
//    score NEG_INF = -1e30 (they only occur when pos < 0, where the softmax
//    is uniform over all T * bs keys), and the output divides by
//    max(l, 1e-30).
#include <cuda_runtime.h>
#include <math_constants.h>

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;        // query heads per KV head
constexpr int kMaxHd = 256;      // head_dim
constexpr int kTile = 32;        // keys per tile: one per lane
constexpr int kStages = 2;       // cp.async ring depth
constexpr int kMaxSplit = 256;   // keys per split
constexpr int kSplitPerThread = kMaxSplit / kThreads;
constexpr float kNegInf = -1e30f;

// K/V row stride in shared memory: 4 * an odd number of floats >= hd, so
// the 16-byte loads of 8 lanes (one key each) hit 8 distinct bank groups
__host__ __device__ inline int row_pad(int hd) { return 4 * (((hd + 3) / 4) | 1); }

// floats of the ring of K and V tiles [kStages][kTile][hp], which the
// combine reuses for its per-split factors [2][splits][G] and [G]
__host__ __device__ inline size_t ring_floats(int G, int hd, int splits) {
  const size_t ring = 2 * kStages * kTile * static_cast<size_t>(row_pad(hd));
  const size_t comb = (2 * static_cast<size_t>(splits) + 1) * G;
  return ring > comb ? ring : comb;
}

// dynamic shared memory: q [G][hd4]; the ring; softmax weights
// [kMaxG][kTile]; per head the running max, denominator and this tile's
// rescale factor; the split's key slots [kMaxSplit] and a flag
size_t smem_bytes(int G, int hd, int splits) {
  const int hd4 = (hd + 3) / 4 * 4;
  return sizeof(float) * (static_cast<size_t>(G) * hd4 +
                          ring_floats(G, hd, splits) + kMaxG * kTile +
                          3 * kMaxG) +
         sizeof(int) * (kMaxSplit + 1);
}

// out [G][hd] for one (row, KV head) from its n splits' partials pm/pl
// [n][G], po [n][G][hd] (written by other blocks: read through L2), in
// split order: M = max m_s, e_s = exp(m_s - M), L = sum l_s e_s, O = sum
// o_s e_s; out = O / max(L, 1e-30). f: shared memory for [2n + 1][G].
// Every load of a step is issued before any is used.
template <int MAXG, int DIMS>
__device__ void combine_row(const float* pm, const float* pl,
                            const float* po, float* out, int n, int G,
                            int hd, float* f) {
  float* e = f;               // [n][G]: m_s, then e_s
  float* l = f + n * G;       // [n][G]
  float* ml = l + n * G;      // [G]: M, then max(L, 1e-30)
  for (int i = threadIdx.x; i < n * G; i += kThreads) {
    e[i] = __ldcg(pm + i);
    l[i] = __ldcg(pl + i);
  }
  __syncthreads();
  if (threadIdx.x < G) {
    float M = -CUDART_INF_F;
    for (int s = 0; s < n; ++s) M = fmaxf(M, e[s * G + threadIdx.x]);
    ml[threadIdx.x] = M;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n * G; i += kThreads)
    e[i] = expf(e[i] - ml[i % G]);
  __syncthreads();
  if (threadIdx.x < G) {
    float L = 0.f;
    for (int s = 0; s < n; ++s)
      L = fmaf(l[s * G + threadIdx.x], e[s * G + threadIdx.x], L);
    ml[threadIdx.x] = fmaxf(L, 1e-30f);
  }
  float acc[MAXG][DIMS];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int i = 0; i < DIMS; ++i) acc[g][i] = 0.f;
#pragma unroll 4
  for (int s = 0; s < n; ++s) {
    const float* os = po + static_cast<size_t>(s) * G * hd;
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        const float w = e[s * G + g];
#pragma unroll
        for (int i = 0; i < DIMS; ++i) {
          const int dd = threadIdx.x + kThreads * i;
          if (dd < hd) acc[g][i] = fmaf(__ldcg(os + g * hd + dd), w, acc[g][i]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
#pragma unroll
      for (int i = 0; i < DIMS; ++i) {
        const int dd = threadIdx.x + kThreads * i;
        if (dd < hd) out[g * hd + dd] = acc[g][i] / ml[g];
      }
    }
  }
}

// issue the copies of one tile's K and V rows: warp w copies rows w, w + 4,
// ... (lanes along head_dim); slot[r] is row r's key slot in the pool
// (physical block * bs + offset), -1 for a row to zero-fill (past nlive,
// or its block outside the pool)
__device__ __forceinline__ void issue_tile(
    float* ks, float* vs, const float* kpool, const float* vpool,
    const int* slot, int nlive, size_t row_stride, size_t head_off, int hd,
    int hp, int vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = vec / 4;
  for (int r = warp; r < kTile; r += kWarps) {
    const int sl = r < nlive ? slot[r] : -1;
    const bool ok = sl >= 0;
    const size_t row = ok ? static_cast<size_t>(sl) * row_stride + head_off : 0;
    for (int c = lane * per; c < hd; c += 32 * per) {
      float* kd = ks + r * hp + c;
      float* vd = vs + r * hp + c;
      if (vec == 16) {
        cp_async<16>(kd, kpool + row + c, ok);
        cp_async<16>(vd, vpool + row + c, ok);
      } else if (vec == 8) {
        cp_async<8>(kd, kpool + row + c, ok);
        cp_async<8>(vd, vpool + row + c, ok);
      } else {
        cp_async<4>(kd, kpool + row + c, ok);
        cp_async<4>(vd, vpool + row + c, ok);
      }
    }
  }
}

// MAXG: a compile-time bound on G (the host picks the next power of two);
// DIMS: head dims a thread owns (hd <= 128 * DIMS), so the per-head and
// per-dim loops below unroll into straight-line code
template <int MAXG, int DIMS>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ kpool,
                       const float* __restrict__ vpool,
                       const int* __restrict__ tables,
                       const int* __restrict__ pos, float* __restrict__ out,
                       float* __restrict__ part_m, float* __restrict__ part_l,
                       float* __restrict__ part_o, int* __restrict__ tickets,
                       int N, int KV, int G, int hd, int bs, int T, int S,
                       int vec, float scale) {
  extern __shared__ float smem[];
  const int hd4 = (hd + 3) / 4 * 4, hp = row_pad(hd);
  float* qs = smem;                           // [G][hd4]
  const int max_split = (T * bs + S - 1) / S;
  float* kring = qs + G * hd4;                // [kStages][kTile][hp]
  float* vring = kring + kStages * kTile * hp;
  float* pw = kring + ring_floats(G, hd, max_split);  // [kMaxG][kTile]
  float* run_m = pw + kMaxG * kTile;          // [kMaxG]
  float* run_l = run_m + kMaxG;               // [kMaxG]
  float* corr = run_l + kMaxG;                // [kMaxG]
  int* slot = reinterpret_cast<int*>(corr + kMaxG);  // [kMaxSplit]
  int* flag = slot + kMaxSplit;

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int total = T * bs;
  const int k0 = split * S;
  const int* tbl = tables + static_cast<size_t>(b) * T;

  // --- round trip 1: the position and the split's table entries together
  const int p = __ldg(pos + b);
  int mine[kSplitPerThread];
#pragma unroll
  for (int j = 0; j < kSplitPerThread; ++j) {
    const int i = threadIdx.x + j * kThreads;
    mine[j] = i < S && k0 + i < total ? __ldg(tbl + (k0 + i) / bs) : -1;
  }
  // keys 0..p are visible; with p < 0 every key is masked and the softmax
  // is uniform over all of them, as in the reference
  const int n_keys = p < 0 ? total : min(p + 1, total);
  const int n_split = (n_keys + S - 1) / S;
  // stored before the exit test, so the table loads are not sunk past it
  // into a round trip of their own
#pragma unroll
  for (int j = 0; j < kSplitPerThread; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < S)
      slot[i] = mine[j] >= 0 && mine[j] < N ? mine[j] * bs + (k0 + i) % bs
                                            : -1;
  }
  if (split >= n_split) return;  // block-uniform
  if (threadIdx.x < kMaxG) {
    run_m[threadIdx.x] = kNegInf;
    run_l[threadIdx.x] = 0.f;
  }
  __syncthreads();

  const int n_here = min(S, n_keys - k0);           // keys of this split
  const int n_tiles = (n_here + kTile - 1) / kTile;
  const size_t row_stride = static_cast<size_t>(KV) * hd;  // one key slot
  const size_t head_off = static_cast<size_t>(kvh) * hd;
  // q rides with tile 0's group
  {
    const float* Q = q + (static_cast<size_t>(b) * KV + kvh) * G * hd;
    const int per = vec / 4, cpr = hd / per;
    for (int i = threadIdx.x; i < G * cpr; i += kThreads) {
      const int g = i / cpr, c = (i - g * cpr) * per;
      if (vec == 16)
        cp_async<16>(qs + g * hd4 + c, Q + g * hd + c, true);
      else if (vec == 8)
        cp_async<8>(qs + g * hd4 + c, Q + g * hd + c, true);
      else
        cp_async<4>(qs + g * hd4 + c, Q + g * hd + c, true);
    }
  }
  issue_tile(kring, vring, kpool, vpool, slot, n_here, row_stride, head_off,
             hd, hp, vec);
  cp_commit();

  float acc[MAXG][DIMS];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int i = 0; i < DIMS; ++i) acc[g][i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    // --- round trip 2, overlapped: tile j + 1 into the other stage
    if (j + 1 < n_tiles) {
      const int st = (j + 1) % kStages;
      issue_tile(kring + st * kTile * hp, vring + st * kTile * hp, kpool,
                 vpool, slot + (j + 1) * kTile, n_here - (j + 1) * kTile,
                 row_stride, head_off, hd, hp, vec);
    }
    cp_commit();  // possibly empty: keeps the group count uniform
    cp_wait<1>();
    __syncthreads();
    const float* ks = kring + (j % kStages) * kTile * hp;
    const float* vs = vring + (j % kStages) * kTile * hp;
    const int nt = min(kTile, n_here - j * kTile);

    // --- scores and softmax weights: warp w takes heads w, w + 4, ...;
    // lane t scores key t against the head's query from shared memory
    const int t = lane;
    const int key = k0 + j * kTile + t;
    const bool live = t < nt;
    const bool ok = live && slot[j * kTile + t] >= 0 && key <= p;
    for (int g = warp; g < G; g += kWarps) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      if (live) {
        const float4* kr = reinterpret_cast<const float4*>(ks + t * hp);
        const float4* qr = reinterpret_cast<const float4*>(qs + g * hd4);
        const int n4 = hd / 4;
#pragma unroll 8
        for (int c = 0; c < n4; ++c) {
          const float4 kv = kr[c], qv = qr[c];
          s0 = fmaf(qv.x, kv.x, s0);
          s1 = fmaf(qv.y, kv.y, s1);
          s2 = fmaf(qv.z, kv.z, s2);
          s3 = fmaf(qv.w, kv.w, s3);
        }
        for (int dd = n4 * 4; dd < hd; ++dd)
          s0 = fmaf(qs[g * hd4 + dd], ks[t * hp + dd], s0);
      }
      // masked keys score NEG_INF like the reference; lanes past the
      // split take no part (-inf: excluded from the max, weight 0)
      const float s = !live ? -CUDART_INF_F
                      : ok  ? ((s0 + s1) + (s2 + s3)) * scale
                            : kNegInf;
      float mt = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = run_m[g];
      const float m_new = fmaxf(m_old, mt);
      const float w = expf(s - m_new);
      float sum = w;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      pw[g * kTile + t] = w;
      __syncwarp();
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        corr[g] = c;
        run_l[g] = run_l[g] * c + sum;
        run_m[g] = m_new;
      }
    }
    __syncthreads();

    // --- fold: each thread owns head dims, acc = acc * corr + P . V
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {  // block-uniform
        const float c = corr[g];
#pragma unroll
        for (int i = 0; i < DIMS; ++i) acc[g][i] *= c;
      }
    }
    // four keys a step: each head's four weights in one 16-byte load (pw
    // is 0 past nt, and those V rows are zero-filled)
#pragma unroll 2
    for (int t4 = 0; t4 < nt; t4 += 4) {
      float vr[4][DIMS];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < DIMS; ++i) {
          const int dd = threadIdx.x + kThreads * i;
          vr[u][i] = dd < hd ? vs[(t4 + u) * hp + dd] : 0.f;
        }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float4 w = *reinterpret_cast<const float4*>(pw + g * kTile + t4);
#pragma unroll
          for (int i = 0; i < DIMS; ++i) {
            acc[g][i] = fmaf(w.x, vr[0][i], acc[g][i]);
            acc[g][i] = fmaf(w.y, vr[1][i], acc[g][i]);
            acc[g][i] = fmaf(w.z, vr[2][i], acc[g][i]);
            acc[g][i] = fmaf(w.w, vr[3][i], acc[g][i]);
          }
        }
      }
    }
    __syncthreads();  // the stage is refilled, pw and corr rewritten
  }

  const size_t rk = static_cast<size_t>(b) * KV + kvh;
  float* O = out + rk * G * hd;
  if (n_split == 1) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        const float lg = fmaxf(run_l[g], 1e-30f);
#pragma unroll
        for (int i = 0; i < DIMS; ++i) {
          const int dd = threadIdx.x + kThreads * i;
          if (dd < hd) O[g * hd + dd] = acc[g][i] / lg;
        }
      }
    }
    return;
  }

  // --- partials of this split: [B * KV][max splits][G] (m, l) and
  // [B * KV][max splits][G][hd] (o)
  const size_t ps = rk * max_split + split;
  if (threadIdx.x < G) {
    part_m[ps * G + threadIdx.x] = run_m[threadIdx.x];
    part_l[ps * G + threadIdx.x] = run_l[threadIdx.x];
  }
  float* po = part_o + ps * G * hd;
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
#pragma unroll
      for (int i = 0; i < DIMS; ++i) {
        const int dd = threadIdx.x + kThreads * i;
        if (dd < hd) po[g * hd + dd] = acc[g][i];
      }
    }
  }

  // the row's last split to finish combines it (its ring is free by now)
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *flag = atomicAdd(tickets + rk, 1) == n_split - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const size_t p0 = rk * max_split;
  combine_row<MAXG, DIMS>(part_m + p0 * G, part_l + p0 * G,
                          part_o + p0 * G * hd, O, n_split, G, hd, kring);
}

template <int MAXG, int DIMS, typename... Args>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                   Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<MAXG, DIMS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  paged_attention_kernel<MAXG, DIMS><<<grid, kThreads, smem, stream>>>(
      args...);
  return cudaGetLastError();
}

template <int DIMS, typename... Args>
cudaError_t launch_g(int G, Args... args) {
  return G <= 1   ? launch<1, DIMS>(args...)
         : G <= 2 ? launch<2, DIMS>(args...)
         : G <= 4 ? launch<4, DIMS>(args...)
         : G <= 8 ? launch<8, DIMS>(args...)
                  : launch<16, DIMS>(args...);
}

}  // namespace

// q [B,KV,G,hd]; k/v pool [N,bs,KV,hd]; tables [B,T] int32; pos [B] int32;
// out [B,KV,G,hd]. All fp32 (except the int32 index arrays), contiguous, on
// the device; G <= 16, hd <= 256. S: keys a split, a multiple of 32 up to
// 256. When T * bs > S, part_m / part_l [B * KV * ceil(T * bs / S) * G] and
// part_o [... * hd] are scratch for the splits' partials and tickets is
// B * KV int32 zeros (the last split of a row to finish combines it); else
// they may be null. Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int paged_attention_f32(const float* q, const float* kpool,
                                   const float* vpool, const int* tables,
                                   const int* pos, float* out, float* part_m,
                                   float* part_l, float* part_o, int* tickets,
                                   int B, int N, int KV, int G, int hd,
                                   int bs, int T, int S, float scale,
                                   cudaStream_t stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || hd <= 0) return 0;
  if (G > kMaxG || hd > kMaxHd || bs <= 0 || T <= 0 || S <= 0 ||
      S % kTile != 0 || S > kMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  const int total = T * bs;
  const int max_split = (total + S - 1) / S;
  if (max_split > 1 && (part_m == nullptr || part_l == nullptr ||
                        part_o == nullptr || tickets == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // the widest copy every q, K and V row and pointer is aligned to
  const void* rows[3] = {q, kpool, vpool};
  int vec = 16;
  for (const void* p : rows) {
    const int v = copy_bytes(p, static_cast<size_t>(hd) * sizeof(float));
    vec = v < vec ? v : vec;
  }
  if (vec == 0) return static_cast<int>(cudaErrorMisalignedAddress);
  const size_t smem = smem_bytes(G, hd, max_split);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(max_split, KV, B);
  const cudaError_t err =
      hd <= kThreads
          ? launch_g<1>(G, grid, smem, stream, q, kpool, vpool, tables, pos,
                        out, part_m, part_l, part_o, tickets, N, KV, G, hd,
                        bs, T, S, vec, scale)
          : launch_g<2>(G, grid, smem, stream, q, kpool, vpool, tables, pos,
                        out, part_m, part_l, part_o, tickets, N, KV, G, hd,
                        bs, T, S, vec, scale);
  return static_cast<int>(err);
}
