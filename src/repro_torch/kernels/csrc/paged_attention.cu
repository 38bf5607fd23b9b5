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
// memory round trips inside a block (block table -> K/V -> scores ->
// softmax -> output) and the launch itself.
//
// What the design does about it:
//  * One block per (batch row, KV head) computes all G query heads of that
//    KV head, so every K/V row is fetched from device memory once and
//    reused G times.
//  * The block reads its own block_tables[b, :] and pos[b] from device
//    memory; this replaces the TPU kernel's scalar prefetch. It walks only
//    the row's keys 0..pos (the Pallas grid visits all T blocks and masks),
//    in tiles of 32 keys. Per tile there are exactly two dependent round
//    trips to device memory: the tile's table entries, then all of its K
//    and V rows, loaded by every thread at once into shared memory. The
//    rest runs from shared memory with short dependency chains: a warp
//    per query head scores the tile's keys one per lane and turns them
//    into fp32 online-softmax weights (two shuffle reductions, one exp a
//    lane); then every thread folds P.V into the head dimensions it
//    owns, rescaling by the running max once per tile.
//  * Masking follows the reference exactly: keys at logical index > pos
//    score NEG_INF = -1e30 (they only occur when pos < 0), and the output
//    divides by max(l, 1e-30).
//  * A table entry outside [0, N) is never dereferenced: its keys are
//    masked. (The allocator never produces one; the guard keeps a bad
//    table from reading outside the pool.)
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;        // query heads per KV head
constexpr int kMaxHd = 256;      // head_dim
constexpr int kDimsPerThread = kMaxHd / kThreads;
constexpr int kTile = 32;        // keys per tile: one per lane
constexpr float kNegInf = -1e30f;

// dynamic shared memory: q [G][hd]; the K tile [kTile][hd + 1] (padded so
// lane t reading key t's dimension dd hits bank (t + dd) % 32); the V tile
// [kTile][hd]; softmax weights [kMaxG][kTile]; per head the running max,
// denominator and this tile's rescale factor; the tile's physical blocks
size_t smem_bytes(int G, int hd) {
  return sizeof(float) * (static_cast<size_t>(G) * hd + kTile * (hd + 1) +
                          kTile * hd + kMaxG * kTile + 3 * kMaxG) +
         sizeof(int) * kTile;
}

// MAXG: a compile-time bound on G (the host picks the next power of two),
// so the per-head loops below unroll into straight-line code
template <int MAXG>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ kpool,
                       const float* __restrict__ vpool,
                       const int* __restrict__ tables,
                       const int* __restrict__ pos, float* __restrict__ out,
                       int N, int KV, int G, int hd, int bs, int T,
                       float scale) {
  extern __shared__ float smem[];
  const int hp = hd + 1;
  float* qs = smem;                       // [G][hd]
  float* ks = qs + G * hd;                // [kTile][hd + 1]
  float* vs = ks + kTile * hp;            // [kTile][hd]
  float* pw = vs + kTile * hd;            // [kMaxG][kTile]
  float* run_m = pw + kMaxG * kTile;      // [kMaxG]
  float* run_l = run_m + kMaxG;           // [kMaxG]
  float* corr = run_l + kMaxG;            // [kMaxG]
  int* phys = reinterpret_cast<int*>(corr + kMaxG);   // [kTile]

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row_stride = static_cast<size_t>(KV) * hd;  // one key slot
  const float* Q = q + (static_cast<size_t>(b) * KV + kvh) * G * hd;
  for (int i = threadIdx.x; i < G * hd; i += kThreads) qs[i] = Q[i];
  if (threadIdx.x < kMaxG) {
    run_m[threadIdx.x] = kNegInf;
    run_l[threadIdx.x] = 0.f;
  }

  const int p = pos[b];
  const int total = T * bs;
  // keys 0..p are visible; with p < 0 every key is masked and the softmax
  // is uniform over all of them, as in the reference
  const int n_keys = p < 0 ? total : min(p + 1, total);
  const int* tbl = tables + static_cast<size_t>(b) * T;

  float acc[MAXG][kDimsPerThread];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) acc[g][i] = 0.f;

  for (int t0 = 0; t0 < n_keys; t0 += kTile) {
    const int nt = min(kTile, n_keys - t0);
    // --- round trip 1: the tile's physical blocks (-1: outside the pool)
    if (threadIdx.x < nt) {
      const int blk = tbl[(t0 + threadIdx.x) / bs];
      phys[threadIdx.x] = blk >= 0 && blk < N ? blk : -1;
    }
    __syncthreads();
    // --- round trip 2: every K and V row of the tile, all threads at once
    // (warp w copies keys w, w + 4, ...; lanes along head_dim)
    for (int t = warp; t < nt; t += kWarps) {
      const int blk = phys[t];
      const size_t row = (static_cast<size_t>(blk < 0 ? 0 : blk) * bs
                          + (t0 + t) % bs) * row_stride
                         + static_cast<size_t>(kvh) * hd;
      for (int dd = lane; dd < hd; dd += 32) {
        ks[t * hp + dd] = blk < 0 ? 0.f : __ldg(kpool + row + dd);
        vs[t * hd + dd] = blk < 0 ? 0.f : __ldg(vpool + row + dd);
      }
    }
    __syncthreads();

    // --- scores and softmax weights: warp w takes heads w, w + 4, ...;
    // lane t scores key t against the head's query from shared memory
    const int t = lane;
    const bool live = t < nt;
    const bool ok = live && phys[t] >= 0 && t0 + t <= p;
    for (int g = warp; g < G; g += kWarps) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      if (live) {
        const float* kr = ks + t * hp;
        const float* qr = qs + g * hd;
        int dd = 0;
        for (; dd + 3 < hd; dd += 4) {
          s0 = fmaf(qr[dd], kr[dd], s0);
          s1 = fmaf(qr[dd + 1], kr[dd + 1], s1);
          s2 = fmaf(qr[dd + 2], kr[dd + 2], s2);
          s3 = fmaf(qr[dd + 3], kr[dd + 3], s3);
        }
        for (; dd < hd; ++dd) s0 = fmaf(qr[dd], kr[dd], s0);
      }
      // masked keys score NEG_INF like the reference; lanes past the
      // tile take no part (-inf: excluded from the max, weight 0)
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
        for (int i = 0; i < kDimsPerThread; ++i) acc[g][i] *= c;
      }
    }
    for (int tt = 0; tt < nt; ++tt) {
      float vr[kDimsPerThread];
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i) {
        const int dd = threadIdx.x + kThreads * i;
        vr[i] = dd < hd ? vs[tt * hd + dd] : 0.f;
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float w = pw[g * kTile + tt];
#pragma unroll
          for (int i = 0; i < kDimsPerThread; ++i)
            acc[g][i] = fmaf(w, vr[i], acc[g][i]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites phys, ks, vs, pw, corr
  }

  float* O = out + (static_cast<size_t>(b) * KV + kvh) * G * hd;
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      const float lg = fmaxf(run_l[g], 1e-30f);
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i) {
        const int dd = threadIdx.x + kThreads * i;
        if (dd < hd) O[g * hd + dd] = acc[g][i] / lg;
      }
    }
  }
}

template <int MAXG, typename... Args>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                   Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<MAXG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  paged_attention_kernel<MAXG><<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// q [B,KV,G,hd]; k/v pool [N,bs,KV,hd]; tables [B,T] int32; pos [B] int32;
// out [B,KV,G,hd]. All fp32 (except the int32 index arrays), contiguous, on
// the device; G <= 16, hd <= 256. Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
extern "C" int paged_attention_f32(const float* q, const float* kpool,
                                   const float* vpool, const int* tables,
                                   const int* pos, float* out, int B, int N,
                                   int KV, int G, int hd, int bs, int T,
                                   float scale, cudaStream_t stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || hd <= 0) return 0;
  if (G > kMaxG || hd > kMaxHd || bs <= 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(G, hd);
  const dim3 grid(KV, B);
  const cudaError_t err =
      G <= 1   ? launch<1>(grid, smem, stream, q, kpool, vpool, tables, pos,
                           out, N, KV, G, hd, bs, T, scale)
      : G <= 2 ? launch<2>(grid, smem, stream, q, kpool, vpool, tables, pos,
                           out, N, KV, G, hd, bs, T, scale)
      : G <= 4 ? launch<4>(grid, smem, stream, q, kpool, vpool, tables, pos,
                           out, N, KV, G, hd, bs, T, scale)
      : G <= 8 ? launch<8>(grid, smem, stream, q, kpool, vpool, tables, pos,
                           out, N, KV, G, hd, bs, T, scale)
               : launch<16>(grid, smem, stream, q, kpool, vpool, tables, pos,
                            out, N, KV, G, hd, bs, T, scale);
  return static_cast<int>(err);
}
