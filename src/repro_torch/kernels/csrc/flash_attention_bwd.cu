// Backward of full-sequence attention (the function flash_attention.cu
// computes), fp32 on the TF32 and bf16 on the bf16 tensor cores of Hopper
// (sm_90a), plain C interface.
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
//   dS[i,j] = P[i,j] (dP[i,j] - D[i]),  dP[i,j] = dO[i] . v_j,
//   D[i] = sum_j P[i,j] dP[i,j]  (= dO[i] . O[i])
//   dQ[i]  = scale * sum_j dS[i,j] k_j,  dK[j] = scale * sum_i dS[i,j] q_i
//
// summed over the G = H / KV query heads of a KV head for dK and dV. A
// masked score is a constant: its dS is zero. A row that sees no key at all
// (only Sq > Sk under a window) is uniform over all Sk keys, as in the
// forward: its P is 1 / Sk everywhere, so it feeds dV and nothing else.
//
// Two launches from this source, in order on one stream, no atomics (the
// fp32 kernels as below; the bf16 ones, "bf16 inputs and outputs", keep
// the algorithm):
//  (1) rows: one block of 4 warps per (batch row, KV head, tile of query
//      positions), its 64 rows G heads x 64 / G positions as in the
//      forward, warp w rows 16w .. 16w + 15. Q and dO are staged once; K/V
//      tiles of 16 keys stream through a two-stage cp.async ring, twice.
//      Pass 1 computes S = Q.K^T and dP = dO.V^T for each row's max m,
//      denominator l (online softmax, log2 units) and l D = sum exp2(s - m)
//      dP, rescaled as l is. Pass 2 computes S and dP again (the same
//      instructions on the same data: bitwise the same), P = exp2(s - m) / l,
//      dS = P (dP - D) and dQ += dS.K. m, 1 / l and D go to the
//      [3, B, Sq, H]-sized scratch, laid out [3][B][KV][Sq][G] so that 32
//      (position, head) rows of a group are 32 consecutive floats, for (2).
//  (2) keys: one block of 4 warps per (batch row, KV head, 32 keys), K and
//      V staged once; the (position, head) rows that can see those keys,
//      every G head of the group, stream through a two-stage cp.async ring
//      in tiles of 32 (Q, dO and the rows' m, 1 / l, D). Warp w takes keys
//      16 (w & 1) .. + 15 and rows 16 (w >> 1) .. + 15 of each tile. With
//      the keys as the M rows it computes S^T = K.Q^T and dP^T = V.dO^T,
//      then P^T and dS^T, and dV += P^T.dO, dK += dS^T.Q in registers; the
//      two row streams' dK and dV are summed in shared memory at the end, so
//      each key is written by one block. Two streams halve the longest walk:
//      under a causal mask the first keys see every row, and with one stream
//      of 64 keys a block Mixtral's call (B 1, KV 8) is 256 blocks, one wave
//      on the card, as long as its longest block (PERF.md, section 6).
//  Both launches issue the longest row or key range first.
//
// D comes from the kernel's own products. Since sum_j dS[i,j] must be 0, an
// error e in D[i] reaches dQ[i] as e * sum_j P[i,j] k_j, which is large
// where the keys share a large common part (Qwen1.5's k bias). D = sum P dP
// from the same 3xTF32 S and dP that form dS cancels to fp32 rounding; D =
// dO . O with the forward's O (its own S, another sum order) misses 2e-5 x
// max |dQ| (tests/test_torch_flash_bwd_numerics.py).
//
// What bounds it on this card: operations. Autograd of the forward needs
// S and dP (2 hd + 2 vd flops a visible (query, key) pair and head) and
// dQ, dK, dV (4 hd + 2 vd): 85.9 GFLOP at both training calls of
// chip_smoke.py (Qwen1.5-0.5B: B 4, S 2048, H = KV = 16, hd 64, causal;
// Mixtral: B 1, S 2048, H 32, KV 8, hd 128), 0.174 ms at the 495 TFLOP/s
// of the TF32 tensor cores, 0.521 ms as the 3xTF32 floor, 1.283 ms on the
// 67 TFLOP/s fp32 cores. This kernel executes 10 hd + 8 vd a pair and head
// (S and dP three times, once in each pass and once in the keys launch):
// the price of keeping no [Sq, Sk] matrix, no forward state but q, k, v,
// and no atomics. mma.sync issues from each warp with its operands in
// registers, so the hi / lo splits (five integer and float operations an
// operand) and the fragment loads share the issue slots with the MMAs.
//
// What the design does about it:
//  * Every product is mma.sync.m16n8k8 TF32 with fp32 accumulators, each
//    fp32 operand split hi + lo (3xTF32: lo.hi + hi.lo + hi.hi; one TF32
//    pass misses fp32 tolerance), as in the forward (tensor_core.cuh).
//  * The tensor cores truncate as they accumulate. S and dP keep the
//    small terms (lo.hi + hi.lo) in their own accumulator, added at the end
//    (and two short dependency chains a k-step instead of one of three);
//    dQ, dK and dV sum each 16-key or 16-row tile from zero and add it to
//    the running sum in fp32, which rounds to nearest: one accumulator over
//    thousands of rows drifts toward zero (PERF.md, section 6).
//  * P and dS never touch shared memory: the m16n8 accumulator of S (rows)
//    or S^T (keys) is the A operand of the next product in registers, A
//    slot t carrying column 2t and slot t + 4 column 2t + 1, and the B tile
//    is read at rows 2t and 2t + 1 to match.
//  * Q, K, V and dO tiles are read both along a row (S, dP: lane (g, t)
//    reads row g, column t) and down a column (dQ, dK, dV: rows 2t, 2t + 1,
//    column g). Rows are padded to 4 mod 8 words, which puts both patterns
//    of a warp on 32 distinct banks; every fragment is one 4-byte load.
//    Columns past hd (or vd) up to the next multiple of 8 are zeroed once.
//  * Tiles arrive by cp.async (16-byte copies; 8 or 4 bytes where a row is
//    not 16-byte aligned): tile j + 1 loads while tile j computes. Keys past
//    Sk and dead rows are zero-filled by the copy (src-size 0).
//  * Tiles that every row of a warp sees whole skip the per-element masks.
//  * Occupancy: each launch stages 96 rows of stride(hd) + stride(vd)
//    floats (the keys launch also 768 bytes of row stats): 99.8 KB at
//    hd = vd = 128, two blocks an SM; 51.8 KB at 64; 195.8 KB at 256, one.
//    The width is a template bound (<= 64/128/256) so the dQ accumulator
//    (rows: hd / 8 fragments of 4 floats a lane) and dK + dV (keys: twice
//    that, 128 floats a lane at 128) stay in registers. ptxas (-Xptxas -v,
//    sm_90a; chip_smoke.py prints it), registers for hd <= 64/128/256:
//    rows 128/200/242, keys 153/232/255; no spills and no stack at 64 and
//    128, so hd 64 runs four rows blocks (16 warps) and three keys blocks
//    an SM, hd 128 two of each. At 256 (coverage shapes only: MQA and MLA
//    widths) the keys kernel's 256 accumulator floats a lane spill (568
//    bytes stored, 312 bytes of stack).
//
// bf16 inputs and outputs (training a published config in its own dtype):
// kernels of their own, flash_bwd_rows_bf16 and flash_bwd_keys_bf16, the
// algorithm above (two launches, stats then dQ, then dK and dV; D from the
// kernel's own S and dP; masks, uniform rows, longest first) on the bf16
// tensor cores.
//  * Tiles stay bf16 in shared memory (half the fp32 bytes) and arrive by
//    16-byte cp.async copies (8 or 4 bytes where a row is not 16-byte
//    aligned; one element a load where it is only 2-byte aligned, hd 37),
//    with no widening: rows launch, 32-key K/V tiles in a ring of 3
//    stages at hd <= 64 and 192, 2 at 128 and 256 (shared memory keeps 3
//    blocks an SM at 128); keys launch, 32-row Q/dO tiles and their stats
//    in a ring of 3. Row strides are the width rounded up to 16 plus 8
//    elements, an odd number of 16-byte units: every ldmatrix phase reads
//    8 distinct bank groups. A copy's source row is found with no
//    division (the 16-byte path walks chunks and rows by thread index;
//    the keys launch's row / G is a multiply-high by ceil(2^32 / G)).
//  * Every product is mma.sync.m16n8k16 bf16 with fp32 accumulators,
//    fragments by ldmatrix: S = Q.K^T and dP = dO.V^T (S^T, dP^T in the
//    keys launch) one pass each, exact products, in one loop (two
//    independent chains); dQ += dS.K, dV += P^T.dO and dK += dS^T.Q take
//    their B operand by ldmatrix.trans (they contract over the key or row
//    axis). The m16n8 accumulators of S (or S^T) are the A fragment of a
//    k16 step as they stand, so P and dS never touch shared memory.
//  * P and dS are fp32 and go in as bf16 hi + bf16 lo (lo = bf16(x - hi):
//    two passes against the exact bf16 B operand, 16 bits of x). One
//    rounded pass misses 2^-8 x max of float64: dS cancels (sum_j dS = 0)
//    and a shared key part turns its rounding into dQ error (1e-2 to
//    3e-2 x max); one pass of P leaves dV 1.1e-3 to 2.0e-3 x max before
//    the output's own rounding (tests/test_torch_flash_bwd_bf16_numerics.py).
//  * Each 16-key or 16-row product is summed from zero (lo pass, then
//    hi) and added to the running fp32 sum; dQ, dK and dV are rounded to
//    bf16 once, at the store. No atomics: bitwise repeatable.
//  * Widths are template bounds so the accumulators fit: hd <= 64, 128
//    (dQ 2 hd / 16 n-tiles a lane; dK + dV twice that), MLA's 192 / 128
//    and 256. At 192 / 128 dK + dV are 40 n-tiles: the keys launch runs 8
//    warps a block, two on each (keys, rows) block, each computing S^T
//    and dP^T whole and accumulating every other 16-column group (80
//    floats a lane, not 160); the same at 256. ptxas (sm_90a; the
//    registers for rows / keys at hd <= 64, 128, 192 / 128, 256): see
//    PERF.md section 6; no spills and no stack at any of them.
//  * The keys launch splits a keys block's rows over a cluster of up to
//    4 blocks when the blocks would not fill the card's slots twice over
//    (a causal walk's blocks average half the longest; GQA walks G heads'
//    rows, so Qwen2.5-3B's call is 256 blocks of up to 16384 rows: one
//    ragged wave). Rank r walks the r-th run of row tiles; rank 0 adds
//    the others' dK and dV from their shared memory (distributed shared
//    memory), in rank order.
//  * Work: the least autograd needs is 6 hd + 4 vd flops a visible
//    (query, key) pair and head (bwd_cost). The kernels execute 14 hd +
//    10 vd of MMA passes (rows: S and dP twice, dQ two passes; keys: S^T
//    and dP^T once, dV and dK two passes each), 2.4x at hd = vd; at 192 /
//    128, 16 hd + 12 vd (S^T and dP^T twice), 2.77x; plus the causal
//    diagonal's masked half-tiles. What bounds it at the recorded calls
//    (989 TFLOP/s bf16): operations: Qwen1.5-0.5B's (B 4, H = KV = 16,
//    hd 64) and Qwen2.5-3B's (B 2, H 16, KV 2, hd 128) 85.9 GFLOP, 0.0869
//    ms; DeepSeek-V2's MLA call (B 1, H = KV = 128, hd 192, vd 128)
//    447 GFLOP, 0.452 ms; their bytes take 0.035, 0.018 and 0.18 ms.
//
// What is left: wgmma + TMA (bf16 wgmma takes B from shared memory in
// either major order, so dQ, dK and dV need no transposed tile), and the
// issue and latency cost of mma.sync from few warps a block. Cutting the
// executed work below 14 hd + 10 vd needs an LSE output from the
// forward, or dQ by atomics.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows launch: query rows a block
constexpr int kTile = 16;           // rows launch: keys a ring stage
constexpr int kKeys = 32;           // keys launch: keys a block (2 x 16)
constexpr int kRowTile = 32;        // keys launch: rows a ring stage
static_assert(kRows + 2 * kTile == kKeys + 2 * kRowTile,
              "both launches stage 96 rows");
constexpr int kStages = 2;
constexpr int kMaxHd = 256;
constexpr int kMaxG = kRows;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// shared-memory row stride (floats) for rows of w: 4 mod 8 words, so a
// warp's row reads (row g, column t: words 4g' + t) and column reads (rows
// 2t and 2t + 1, column g: words 8t' + g) hit 32 distinct banks; a
// multiple of 4 keeps 16-byte copies aligned
__host__ __device__ __forceinline__ int stride(int w) {
  return ((w + 7) & ~7) + 4;
}

struct Shape {
  int B, Sq, Sk, H, KV, G, BP, hd, vd, causal, window, vec;
  float scale;
};

// dynamic shared memory (floats). rows: Q [kRows][sq], dO [kRows][sv],
// K [kStages][kTile][sq], V [kStages][kTile][sv]. keys: K [kKeys][sq],
// V [kKeys][sv], Q [kStages][kRowTile][sq], dO [kStages][kRowTile][sv],
// the rows' m, 1 / l, D [kStages][3][kRowTile]
size_t smem_bytes(int hd, int vd) {
  return sizeof(float) *
         (static_cast<size_t>(kKeys + kStages * kRowTile) *
              (stride(hd) + stride(vd)) +
          kStages * 3 * kRowTile);
}

// Rows [0, nrows) of w fp32 elements into dst (stride ds) by cp.async
// (complete at cp_wait); row r comes from src(r), or is zero where src(r)
// is null. vec: bytes a copy (16, 8 or 4; every source row and pointer
// aligned to it).
template <typename Src>
__device__ __forceinline__ void copy_rows(float* dst, int ds, int nrows,
                                          int w, int vec, const float* base,
                                          Src src) {
  const int per = vec / 4;
  const int cpr = w / per;  // copies a row
  for (int i = threadIdx.x; i < nrows * cpr; i += kThreads) {
    const int r = i / cpr, c = (i - r * cpr) * per;
    const float* s = src(r);
    float* d = dst + r * ds + c;
    const float* from = s ? s + c : base;
    if (vec == 16)
      cp_async<16>(d, from, s != nullptr);
    else if (vec == 8)
      cp_async<8>(d, from, s != nullptr);
    else
      cp_async<4>(d, from, s != nullptr);
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// zero columns [w, w rounded up to 8) of nrows rows: the last k-step or
// n-tile reads them, no copy writes them
__device__ __forceinline__ void zero_pad(float* buf, int nrows, int ds,
                                         int w) {
  const int extra = ((w + 7) & ~7) - w;
  for (int i = threadIdx.x; i < nrows * extra; i += kThreads)
    buf[(i / extra) * ds + w + i % extra] = 0.f;
}

// acc[j] = A.B^T (j < 2), 3xTF32: the warp's 16 rows of A against 16 rows
// of B (two n-tiles of 8) over nks k-steps of 8 columns; a and b point at
// row g, column t of their tiles (lane (g, t)), k slot t is column 8kk + t
// and slot t + 4 column 8kk + t + 4. The small terms (lo.hi + hi.lo) have
// their own accumulator, added at the end: a k-step's three products form
// two short dependency chains instead of one of three, and the small sum
// is not truncated against the large one. Without kSplit both operands
// are widened bf16 (TF32 already): one pass.
template <bool kSplit>
__device__ __forceinline__ void dot_nt(float (&acc)[2][4], const float* a,
                                       int sa, const float* b, int sb,
                                       int nks) {
  float small[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = small[j][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < nks; ++kk) {
    const float* ak = a + 8 * kk;
    uint32_t ah[4], al[4];
    frag<kSplit>(ak[0], ah[0], al[0]);
    frag<kSplit>(ak[8 * sa], ah[1], al[1]);
    frag<kSplit>(ak[4], ah[2], al[2]);
    frag<kSplit>(ak[8 * sa + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* bk = b + 8 * j * sb + 8 * kk;
      uint32_t bh[2], bl[2];
      frag<kSplit>(bk[0], bh[0], bl[0]);
      frag<kSplit>(bk[4], bh[1], bl[1]);
      if constexpr (kSplit) {
        mma(small[j], al, bh);
        mma(small[j], ah, bl);
      }
      mma(acc[j], ah, bh);
    }
  }
  if constexpr (kSplit) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += small[j][e];
  }
}

// acc[n] += C.B[:, 8n .. 8n + 7] for n < nt (NT a bound): C is the warp's
// 16 x 16 block held in two m16n8 accumulators c[j] (rows g and g + 8,
// columns 8j + 2t and 8j + 2t + 1), taken as the A operand of two k-steps
// with slot t = column 8j + 2t and slot t + 4 = column 8j + 2t + 1; b points
// at row 2t, column g of B, whose rows match C's 16 columns. Each n-tile is
// summed from zero and then added to acc[n] in fp32: the tensor cores
// truncate as they accumulate, so a sum over thousands of rows kept in
// one accumulator drifts toward zero. Without kLoB, B is a widened bf16
// input: two passes (lo.hi + hi.hi).
template <int NT, bool kLoB>
__device__ __forceinline__ void dot_acc(float (&acc)[NT][4],
                                        const float (&c)[2][4], const float* b,
                                        int sb, int nt) {
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    frag<true>(c[j][0], ah[j][0], al[j][0]);
    frag<true>(c[j][2], ah[j][1], al[j][1]);
    frag<true>(c[j][1], ah[j][2], al[j][2]);
    frag<true>(c[j][3], ah[j][3], al[j][3]);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n < nt) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* bj = b + 8 * j * sb + 8 * n;
        uint32_t bh[2], bl[2];
        frag<kLoB>(bj[0], bh[0], bl[0]);
        frag<kLoB>(bj[sb], bh[1], bl[1]);
        mma3<true, kLoB>(part, ah[j], al[j], bh, bl);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
    }
  }
}

// row r of a query tile starting at position q0: head kvh * G + r / BP,
// position q0 + r % BP; live iff r / BP < G and the position < Sq
__device__ __forceinline__ bool row_live(const Shape& sh, int q0, int r,
                                         int& head_in_group, int& pos) {
  head_in_group = r / sh.BP;
  pos = q0 + r - head_in_group * sh.BP;
  return head_in_group < sh.G && pos < sh.Sq;
}

// 0: visible; 1: masked (NEG_INF, no gradient); 2: past Sk (no part)
__device__ __forceinline__ int key_state(const Shape& sh, int pos, int key) {
  if (key >= sh.Sk) return 2;
  if ((sh.causal && key > pos) || (sh.window > 0 && pos - key >= sh.window))
    return 1;
  return 0;
}

// a score in log2 units, as the online softmax keeps them
__device__ __forceinline__ float score2(int state, float s, float sc) {
  return state == 0 ? s * sc : (state == 1 ? kNegInf : -CUDART_INF_F);
}

// the key tiles [lo, hi] (of kT keys) that query positions [q0, q_last]
// can see; every tile if the last position sees no key (it is uniform
// over all of them)
template <int kT = kTile>
__device__ __forceinline__ void key_range(const Shape& sh, int q0,
                                          int q_last, int& lo, int& hi) {
  int k_lo = sh.window > 0 ? max(0, q0 - sh.window + 1) : 0;
  int k_hi = sh.causal ? min(sh.Sk - 1, q_last) : sh.Sk - 1;
  const int lo_last = sh.window > 0 ? max(0, q_last - sh.window + 1) : 0;
  if (lo_last > k_hi) {
    k_lo = 0;
    k_hi = sh.Sk - 1;
  }
  lo = k_lo / kT;
  hi = k_hi / kT;
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

// (1) rows: the stats and dQ. T: the element type of q, k, v, dout and dq
// (float or __nv_bfloat16); HT: dQ n-tiles a lane (hd, vd <= 8 HT)
template <typename T, int HT>
__global__ void __launch_bounds__(kThreads, HT <= 8 ? 4 : (HT <= 16 ? 2 : 1))
flash_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      T* __restrict__ dq, float* __restrict__ stats,
                      Shape sh) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  const int sq = stride(sh.hd), sv = stride(sh.vd);
  float* qs = smem;                       // [kRows][sq]
  float* dos = qs + kRows * sq;           // [kRows][sv]
  float* ks = dos + kRows * sv;           // [kStages][kTile][sq]
  float* vs = ks + kStages * kTile * sq;  // [kStages][kTile][sv]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma group, lane in the group
  const int bkv = sh.B * sh.KV;
  const int b = (blockIdx.x % bkv) / sh.KV, kvh = blockIdx.x % sh.KV;
  const int nqt = (sh.Sq + sh.BP - 1) / sh.BP;
  const int q0 = (nqt - 1 - blockIdx.x / bkv) * sh.BP;  // longest first
  const int q_last = min(q0 + sh.BP, sh.Sq) - 1;
  const size_t k_row = static_cast<size_t>(sh.KV) * sh.hd;
  const size_t v_row = static_cast<size_t>(sh.KV) * sh.vd;
  const T* kb = k + static_cast<size_t>(b) * sh.Sk * k_row +
                static_cast<size_t>(kvh) * sh.hd;
  const T* vb = v + static_cast<size_t>(b) * sh.Sk * v_row +
                static_cast<size_t>(kvh) * sh.vd;

  zero_pad(qs, kRows, sq, sh.hd);
  zero_pad(dos, kRows, sv, sh.vd);
  zero_pad(ks, kStages * kTile, sq, sh.hd);
  zero_pad(vs, kStages * kTile, sv, sh.vd);
  // (batch, position, head) rows of a [B, Sq, H, w] tensor
  auto head_row = [&](const T* base, int w, int r) -> const T* {
    int hg, pos;
    return row_live(sh, q0, r, hg, pos)
               ? base + ((static_cast<size_t>(b) * sh.Sq + pos) * sh.H +
                         kvh * sh.G + hg) * w
               : nullptr;
  };
  copy_rows(qs, sq, kRows, sh.hd, sh.vec, q,
            [&](int r) { return head_row(q, sh.hd, r); });
  copy_rows(dos, sv, kRows, sh.vd, sh.vec, dout,
            [&](int r) { return head_row(dout, sh.vd, r); });
  auto load_tile = [&](int tile, int stage) {
    const int k0 = tile * kTile;
    copy_rows(ks + stage * kTile * sq, sq, kTile, sh.hd, sh.vec, k,
              [&](int j) -> const T* {
                return k0 + j < sh.Sk ? kb + (k0 + j) * k_row : nullptr;
              });
    copy_rows(vs + stage * kTile * sv, sv, kTile, sh.vd, sh.vec, v,
              [&](int j) -> const T* {
                return k0 + j < sh.Sk ? vb + (k0 + j) * v_row : nullptr;
              });
  };

  int t_lo, t_hi;
  key_range(sh, q0, q_last, t_lo, t_hi);
  const int nt = t_hi - t_lo + 1;
  load_tile(t_lo, 0);
  cp_commit();  // group: Q, dO and the first tile

  // this lane's two rows (h = 0: row g, h = 1: row g + 8 of the warp)
  const int row0 = warp * 16 + g;
  int hg[2], pos[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) live[h] = row_live(sh, q0, row0 + 8 * h, hg[h], pos[h]);
  float m[2] = {kNegInf, kNegInf};  // running max, quad-uniform
  float l[2] = {0.f, 0.f};          // this lane's part of the denominator
  float d[2] = {0.f, 0.f};          // pass 1: this lane's part of l D; pass 2: D
  float il[2] = {0.f, 0.f};
  float acc[HT][4];
#pragma unroll
  for (int n = 0; n < HT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int nks_q = (sh.hd + 7) / 8, nks_v = (sh.vd + 7) / 8;
  const float* qw = qs + row0 * sq + t;
  const float* dow = dos + row0 * sv + t;
  const float sc = sh.scale * kLog2e;

  for (int i = 0; i < 2 * nt; ++i) {
    const int stage = i & 1;
    if (i + 1 < 2 * nt) load_tile(t_lo + (i + 1) % nt, stage ^ 1);
    cp_commit();  // (empty on the last tile: keeps wait_group 1 uniform)
    cp_wait<1>();
    __syncthreads();
    const int k0 = (t_lo + i % nt) * kTile;
    const float* kt = ks + stage * kTile * sq;
    const float* vt = vs + stage * kTile * sv;

    // S = Q.K^T, dP = dO.V^T: this warp's 16 rows x 16 keys; s[j][e] is
    // row g + 8 (e >> 1), key k0 + 8j + 2t + (e & 1)
    float s[2][4], dp[2][4];
    dot_nt<kSplit>(s, qw, sq, kt + g * sq + t, sq, nks_q);
    dot_nt<kSplit>(dp, dow, sv, vt + g * sv + t, sv, nks_v);
    const int k_end = k0 + kTile - 1;
    const bool whole = __all_sync(
        kFull, k_end < sh.Sk &&
                   (!sh.causal || k_end <= min(pos[0], pos[1])) &&
                   (sh.window == 0 || max(pos[0], pos[1]) - k0 < sh.window));
    unsigned vis = 0;  // bit 4j + e: s[j][e] visible
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int st =
            whole ? 0 : key_state(sh, pos[e >> 1], k0 + 8 * j + 2 * t + (e & 1));
        s[j][e] = score2(st, s[j][e], sc);
        vis |= (st == 0 ? 1u : 0u) << (4 * j + e);
      }

    if (i < nt) {  // pass 1: m, l and l D, online
      float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], quad_max(mt[h]));
        const float corr = exp2f(m[h] - m_new);
        m[h] = m_new;
        l[h] *= corr;
        d[h] *= corr;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[j][e] - m[e >> 1]);
          l[e >> 1] += p;
          d[e >> 1] = fmaf(p, dp[j][e], d[e >> 1]);
        }
      if (i == nt - 1) {  // the row's stats, for pass 2 and the keys launch
        const size_t plane = static_cast<size_t>(sh.B) * sh.Sq * sh.H;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          il[h] = 1.f / quad_sum(l[h]);
          d[h] = quad_sum(d[h]) * il[h];
          if (live[h] && t == 0) {
            const size_t at =
                ((static_cast<size_t>(b) * sh.KV + kvh) * sh.Sq + pos[h]) *
                    sh.G + hg[h];
            stats[at] = m[h];
            stats[plane + at] = il[h];
            stats[2 * plane + at] = d[h];
          }
        }
      }
    } else {  // pass 2: dS = P (dP - D), dQ += dS.K
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float p = exp2f(s[j][e] - m[h]) * il[h];
          s[j][e] = (vis >> (4 * j + e)) & 1u ? p * (dp[j][e] - d[h]) : 0.f;
        }
      dot_acc<HT, kSplit>(acc, s, kt + 2 * t * sq + g, sq, nks_q);
    }
    __syncthreads();  // the next tile's copies overwrite this stage
  }
  cp_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
    T* row = dq + ((static_cast<size_t>(b) * sh.Sq + pos[h]) * sh.H +
                   kvh * sh.G + hg[h]) * sh.hd;
#pragma unroll
    for (int n = 0; n < HT; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < sh.hd) store(row + col, acc[n][2 * h] * sh.scale);
      if (col + 1 < sh.hd) store(row + col + 1, acc[n][2 * h + 1] * sh.scale);
    }
  }
}

// (2) keys: dK and dV. HT: dK and dV n-tiles a lane (hd, vd <= 8 HT).
// Warp w takes keys 16 (w & 1) .. + 15 of the block's 32 and rows
// 16 (w >> 1) .. + 15 of each 32-row tile: two row streams, whose dK and
// dV are summed in shared memory at the end. T as in (1).
template <typename T, int HT>
__global__ void __launch_bounds__(kThreads, HT <= 8 ? 3 : (HT <= 16 ? 2 : 1))
flash_bwd_keys_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ stats, T* __restrict__ dk,
                      T* __restrict__ dv, Shape sh) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  const int sq = stride(sh.hd), sv = stride(sh.vd);
  float* ks = smem;                            // [kKeys][sq]
  float* vs = ks + kKeys * sq;                 // [kKeys][sv]
  float* qs = vs + kKeys * sv;                 // [kStages][kRowTile][sq]
  float* dos = qs + kStages * kRowTile * sq;   // [kStages][kRowTile][sv]
  float* sts = dos + kStages * kRowTile * sv;  // [kStages][3][kRowTile]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kg = warp & 1, rs = warp >> 1;  // key group, row stream
  const int bkv = sh.B * sh.KV;
  const int b = (blockIdx.x % bkv) / sh.KV, kvh = blockIdx.x % sh.KV;
  const int k0 = (blockIdx.x / bkv) * kKeys;  // small k0 sees the most rows
  const int k_last = min(k0 + kKeys, sh.Sk) - 1;
  const size_t k_row = static_cast<size_t>(sh.KV) * sh.hd;
  const size_t v_row = static_cast<size_t>(sh.KV) * sh.vd;
  const T* kb = k + static_cast<size_t>(b) * sh.Sk * k_row +
                static_cast<size_t>(kvh) * sh.hd;
  const T* vb = v + static_cast<size_t>(b) * sh.Sk * v_row +
                static_cast<size_t>(kvh) * sh.vd;

  zero_pad(ks, kKeys, sq, sh.hd);
  zero_pad(vs, kKeys, sv, sh.vd);
  zero_pad(qs, kStages * kRowTile, sq, sh.hd);
  zero_pad(dos, kStages * kRowTile, sv, sh.vd);
  copy_rows(ks, sq, kKeys, sh.hd, sh.vec, k, [&](int j) -> const T* {
    return k0 + j < sh.Sk ? kb + (k0 + j) * k_row : nullptr;
  });
  copy_rows(vs, sv, kKeys, sh.vd, sh.vec, v, [&](int j) -> const T* {
    return k0 + j < sh.Sk ? vb + (k0 + j) * v_row : nullptr;
  });

  // the positions that can see these keys; all of them from the first row
  // that sees no key at all (it is uniform over every key). Row rho of the
  // walk is position rho / G, head rho % G of the group.
  const int p_lo = sh.causal ? k0 : 0;
  int p_hi = sh.window > 0 ? min(sh.Sq - 1, k_last + sh.window - 1)
                           : sh.Sq - 1;
  if (sh.window > 0 && sh.Sk + sh.window - 1 <= sh.Sq - 1) p_hi = sh.Sq - 1;
  const int rho0 = p_lo * sh.G;
  const int rho_end = p_lo <= p_hi ? (p_hi + 1) * sh.G : rho0;
  const int nsteps = (rho_end - rho0 + kRowTile - 1) / kRowTile;
  const size_t plane = static_cast<size_t>(sh.B) * sh.Sq * sh.H;
  const float* stb =
      stats + (static_cast<size_t>(b) * sh.KV + kvh) * sh.Sq * sh.G;
  auto load_rows = [&](int step, int stage) {
    const int first = rho0 + step * kRowTile;
    auto row = [&](const T* base, int w, int r) -> const T* {
      const int rho = first + r;
      if (rho >= rho_end) return nullptr;
      const int pos = rho / sh.G;
      return base + ((static_cast<size_t>(b) * sh.Sq + pos) * sh.H +
                     kvh * sh.G + rho - pos * sh.G) * w;
    };
    copy_rows(qs + stage * kRowTile * sq, sq, kRowTile, sh.hd, sh.vec, q,
              [&](int r) { return row(q, sh.hd, r); });
    copy_rows(dos + stage * kRowTile * sv, sv, kRowTile, sh.vd, sh.vec, dout,
              [&](int r) { return row(dout, sh.vd, r); });
    for (int i = threadIdx.x; i < 3 * kRowTile; i += kThreads) {
      const int c = i / kRowTile, rho = first + i - c * kRowTile;
      const bool ok = rho < rho_end;
      cp_async<4>(sts + stage * 3 * kRowTile + i,
                  ok ? stb + c * plane + rho : stats, ok);
    }
  };
  if (nsteps > 0) load_rows(0, 0);
  cp_commit();  // group: K, V and the first row tile

  const int kw0 = k0 + 16 * kg;  // this warp's keys kw0 .. kw0 + 15
  const int key[2] = {kw0 + g, kw0 + g + 8};
  const float* kw = ks + (16 * kg + g) * sq + t;
  const float* vw = vs + (16 * kg + g) * sv + t;
  float ak[HT][4], av[HT][4];
#pragma unroll
  for (int n = 0; n < HT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[n][e] = av[n][e] = 0.f;
  const int nks_q = (sh.hd + 7) / 8, nks_v = (sh.vd + 7) / 8;
  const float sc = sh.scale * kLog2e;

  for (int step = 0; step < nsteps; ++step) {
    const int stage = step & 1;
    if (step + 1 < nsteps) load_rows(step + 1, stage ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    // this warp's 16 rows of the tile, and their m, 1 / l, D
    const float* qt = qs + (stage * kRowTile + 16 * rs) * sq;
    const float* dot = dos + (stage * kRowTile + 16 * rs) * sv;
    const float* mrow = sts + stage * 3 * kRowTile + 16 * rs;
    const int first = rho0 + step * kRowTile + 16 * rs;

    // S^T = K.Q^T, dP^T = V.dO^T: this warp's 16 keys x 16 rows; s[j][e]
    // is key g + 8 (e >> 1), row 8j + 2t + (e & 1)
    float s[2][4], dp[2][4];
    dot_nt<kSplit>(s, kw, sq, qt + g * sq + t, sq, nks_q);
    dot_nt<kSplit>(dp, vw, sv, dot + g * sv + t, sv, nks_v);
    // rows past rho_end are zero (q, dO, m, 1 / l, D): P = 0, dS = 0
    const int pos_first = first / sh.G;
    const int pos_last = (min(first + 16, rho_end) - 1) / sh.G;
    const bool whole = kw0 + 15 < sh.Sk &&
                       (!sh.causal || kw0 + 15 <= pos_first) &&
                       (sh.window == 0 || pos_last - kw0 < sh.window);
    int rpos[4];  // position of rows 2t, 2t + 1, 8 + 2t, 9 + 2t; -1: dead
    if (!whole) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int rho = first + 8 * (c >> 1) + 2 * t + (c & 1);
        rpos[c] = rho < rho_end ? rho / sh.G : -1;
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * j + 2 * t + (e & 1);
        const int c = 2 * j + (e & 1);
        const int st =
            whole ? 0 : (rpos[c] < 0 ? 2 : key_state(sh, rpos[c], key[e >> 1]));
        const float p = exp2f(score2(st, s[j][e], sc) - mrow[r]) *
                        mrow[kRowTile + r];
        s[j][e] = p;
        dp[j][e] = st == 0 ? p * (dp[j][e] - mrow[2 * kRowTile + r]) : 0.f;
      }
    // dV += P^T.dO, dK += dS^T.Q over the warp's 16 rows
    dot_acc<HT, kSplit>(av, s, dot + 2 * t * sv + g, sv, nks_v);
    dot_acc<HT, kSplit>(ak, dp, qt + 2 * t * sq + g, sq, nks_q);
    __syncthreads();  // the next tile's copies overwrite this stage
  }
  cp_wait<0>();

  // stream 1's dK and dV through the ring's space to stream 0, which adds
  // them (a fixed order) and stores: [4 (nks_q + nks_v) values][2 key
  // groups][32 lanes], at most 64 (hd + vd + 16) floats: the ring holds
  // 64 (stride(hd) + stride(vd))
  __syncthreads();
  float* part = qs;
  auto at = [&](int i) { return (i * 2 + kg) * 32 + lane; };
  if (rs == 1) {
#pragma unroll
    for (int n = 0; n < HT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (n < nks_q) part[at(4 * n + e)] = ak[n][e];
        if (n < nks_v) part[at(4 * (nks_q + n) + e)] = av[n][e];
      }
  }
  __syncthreads();
  if (rs == 1) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= sh.Sk) continue;
    const size_t row =
        (static_cast<size_t>(b) * sh.Sk + key[h]) * sh.KV + kvh;
#pragma unroll
    for (int n = 0; n < HT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t + e, i = 4 * n + 2 * h + e;
        if (col < sh.hd)
          store(dk + row * sh.hd + col,
                (ak[n][2 * h + e] + part[at(i)]) * sh.scale);
        if (col < sh.vd)
          store(dv + row * sh.vd + col,
                av[n][2 * h + e] + part[at(4 * nks_q + i)]);
      }
    }
  }
}

template <typename T, int HT>
cudaError_t launch(const Shape& sh, cudaStream_t stream, const void* q_,
                   const void* k_, const void* v_, const void* dout_,
                   void* dq_, void* dk_, void* dv_, float* stats) {
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  const T* dout = static_cast<const T*>(dout_);
  const size_t smem = smem_bytes(sh.hd, sh.vd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_rows_kernel<T, HT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_keys_kernel<T, HT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int bkv = sh.B * sh.KV;
  const int rows_grid = bkv * ((sh.Sq + sh.BP - 1) / sh.BP);
  flash_bwd_rows_kernel<T, HT><<<rows_grid, kThreads, smem, stream>>>(
      q, k, v, dout, static_cast<T*>(dq_), stats, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int keys_grid = bkv * ((sh.Sk + kKeys - 1) / kKeys);
  flash_bwd_keys_kernel<T, HT><<<keys_grid, kThreads, smem, stream>>>(
      q, k, v, dout, stats, static_cast<T*>(dk_), static_cast<T*>(dv_), sh);
  return cudaGetLastError();
}

// ---- bf16: tiles stay bf16 in shared memory, products on the bf16 tensor
// cores (mma.sync m16n8k16, fragments by ldmatrix)

using bf16 = __nv_bfloat16;
constexpr int kKeyTileH = 32;  // bf16 rows launch: keys a ring stage
constexpr int kMaxCluster = 4;  // bf16 keys launch: blocks sharing 32 keys
constexpr int kKeyStages = 3;   // bf16 keys launch: ring stages

// shared-memory row stride (elements) of a bf16 tile: the width rounded
// up to whole k16 steps, plus 8. A row is then an odd number of 16-byte
// units, so the 8 rows an ldmatrix phase reads (16 bytes each, both the
// plain and the .trans form) sit on 8 distinct 16-byte bank groups
__host__ __device__ __forceinline__ int hstride(int w) {
  return ((w + 15) & ~15) + 8;
}

// dynamic shared memory (bytes) of each bf16 launch. rows (ns stages):
// Q [kRows][sq], dO [kRows][sv], K [ns][kKeyTileH][sq], V [ns][kKeyTileH]
// [sv]. keys: K [kKeys][sq], V [kKeys][sv], Q [kKeyStages][kRowTile][sq],
// dO [kKeyStages][kRowTile][sv], then fp32 m, 1 / l, D
// [kKeyStages][3][kRowTile]
size_t rows_smem_bf16(int hd, int vd, int ns) {
  return sizeof(bf16) * static_cast<size_t>(kRows + ns * kKeyTileH) *
         (hstride(hd) + hstride(vd));
}
size_t keys_smem_bf16(int hd, int vd) {
  return sizeof(bf16) * static_cast<size_t>(kKeys + kKeyStages * kRowTile) *
             (hstride(hd) + hstride(vd)) +
         sizeof(float) * kKeyStages * 3 * kRowTile;
}

// Rows [0, nrows) of w bf16 elements into dst (stride ds) by kN threads;
// row r comes from src(r), or is zero where src(r) is null. vec 16, 8 or
// 4: cp.async copies of that many bytes (complete at cp_wait); vec 2 (a
// row only 2-byte aligned, e.g. hd 37): one element a load, complete when
// the call returns. At vec 16 thread i copies chunks i % 8, i % 8 + 8, ...
// of rows i / 8, i / 8 + kN / 8, ... (a quarter warp writes 128
// contiguous bytes of a row), with no division a copy
template <int kN, typename Src>
__device__ __forceinline__ void stage_rows(bf16* dst, int ds, int nrows,
                                           int w, int vec, const bf16* base,
                                           Src src) {
  if (vec == 16) {
    for (int c = 8 * (threadIdx.x & 7); c < w; c += 64)
      for (int r = threadIdx.x >> 3; r < nrows; r += kN / 8) {
        const bf16* s = src(r);
        cp_async<16>(dst + r * ds + c, s ? s + c : base, s != nullptr);
      }
    return;
  }
  if (vec == 2) {
    for (int i = threadIdx.x; i < nrows * w; i += kN) {
      const int r = i / w, c = i - r * w;
      const bf16* s = src(r);
      dst[r * ds + c] = s ? s[c] : __float2bfloat16(0.f);
    }
    return;
  }
  const int per = vec / 2;
  const int cpr = w / per;  // copies a row
  for (int i = threadIdx.x; i < nrows * cpr; i += kN) {
    const int r = i / cpr, c = (i - r * cpr) * per;
    const bf16* s = src(r);
    bf16* d = dst + r * ds + c;
    const bf16* from = s ? s + c : base;
    if (vec == 8)
      cp_async<8>(d, from, s != nullptr);
    else
      cp_async<4>(d, from, s != nullptr);
  }
}

// n / G for the keys launch's row index: n * ceil(2^32 / G) >> 32 (gmul;
// 0 for G = 1), exact for n G < 2^32, so for every row of Sq G < 2^26
__device__ __forceinline__ int div_g(int n, unsigned gmul) {
  return gmul ? static_cast<int>(__umulhi(static_cast<unsigned>(n), gmul))
              : n;
}

// zero columns [w, w rounded up to 16) of nrows rows: the last k16 step
// reads them, no copy writes them
template <int kN>
__device__ __forceinline__ void zero_pad_h(bf16* buf, int nrows, int ds,
                                           int w) {
  const int extra = ((w + 15) & ~15) - w;
  for (int i = threadIdx.x; i < nrows * extra; i += kN)
    buf[(i / extra) * ds + w + i % extra] = __float2bfloat16(0.f);
}

// 2^x by the SFU (ex2.approx.ftz: relative error below 2^-22, flushes
// subnormal results to 0), without exp2f's range handling
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 matrices of 16-bit elements; lane l gives the address of
// row l % 8 of matrix l / 8. Plain: lane (g, t) gets row g, columns 2t and
// 2t + 1 of each; .trans: rows 2t and 2t + 1 of column g
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a.b, m16n8k16: a [16x16] row-major bf16 fragment, b [16x8]
// col-major (b0: k 2t, 2t + 1 of column g; b1: k 2t + 8, 2t + 9), fp32 c
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// hi = bf16(x), lo = bf16(x - hi) of two fp32 values, the lower column in
// the low half of each word
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 back = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - back.x, x1 - back.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// the warp's 16 x 16 block held as two m16n8 accumulators c0, c1 (rows g
// and g + 8, columns 2t, 2t + 1 and 8 + 2t, 9 + 2t) is the A fragment of a
// k16 step as it stands: split each value hi + lo
__device__ __forceinline__ void a_frags(const float (&c0)[4],
                                        const float (&c1)[4],
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split2(c0[0], c0[1], hi[0], lo[0]);
  split2(c0[2], c0[3], hi[1], lo[1]);
  split2(c1[0], c1[1], hi[2], lo[2]);
  split2(c1[2], c1[3], hi[3], lo[3]);
}

// s[2i + j] = A.B^T and p[2i + j] = C.D^T: the warp's 16 rows of A (C)
// against rows 16i + 8j .. + 7 of B (D), i < NB, over nks1 (nks2 <= nks1)
// k16 steps, in one loop: two independent chains a step. a, c: this
// lane's ldmatrix addresses in A and C (row a_row, column a_col of the
// warp's block), b, d: in B and D (row b_row, column b_col); sb, sd:
// bytes of 16 rows of B and D. One pass: both operands are bf16, their
// products exact in fp32
template <int NB, int KMAX>
__device__ __forceinline__ void dot2_nt16(float (&s)[2 * NB][4], uint32_t a,
                                          uint32_t b, uint32_t sb, int nks1,
                                          float (&p)[2 * NB][4], uint32_t c,
                                          uint32_t d, uint32_t sd, int nks2) {
#pragma unroll
  for (int n = 0; n < 2 * NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = p[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KMAX; ++kk) {
    if (kk >= nks1) break;
    uint32_t af[4];
    ldsm4(af, a + 32 * kk);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      uint32_t bf[4];
      ldsm4(bf, b + i * sb + 32 * kk);
      mma16(s[2 * i], af, bf[0], bf[1]);
      mma16(s[2 * i + 1], af, bf[2], bf[3]);
    }
    if (kk < nks2) {
      ldsm4(af, c + 32 * kk);
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        uint32_t bf[4];
        ldsm4(bf, d + i * sd + 32 * kk);
        mma16(p[2 * i], af, bf[0], bf[1]);
        mma16(p[2 * i + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// acc[2i + j] += C.B[:, 16 c + 8j .. + 7] for the i-th of the ng column
// groups c this warp owns (i < NG, each gs bytes after the last): C is a
// 16 x 16 block of fp32 values as hi + lo A fragments, B's 16 rows match
// C's columns, b is this lane's ldmatrix.trans address (row a_row, column
// a_col) in the first group. Each product is summed from zero (lo pass,
// then hi) and added to acc[n] in fp32: the tensor cores truncate as they
// accumulate, so one accumulator over thousands of rows drifts
template <int NG>
__device__ __forceinline__ void dot_acc16(float (&acc)[2 * NG][4],
                                          const uint32_t (&hi)[4],
                                          const uint32_t (&lo)[4], uint32_t b,
                                          uint32_t gs, int ng) {
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    if (i < ng) {
      uint32_t bf[4];
      ldsm4t(bf, b + i * gs);
      float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
      mma16(p0, lo, bf[0], bf[1]);
      mma16(p1, lo, bf[2], bf[3]);
      mma16(p0, hi, bf[0], bf[1]);
      mma16(p1, hi, bf[2], bf[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[2 * i][e] += p0[e];
        acc[2 * i + 1][e] += p1[e];
      }
    }
  }
}

// one or two adjacent bf16 outputs: a 4-byte store where the row allows
// it (vec >= 4: every row 4-byte aligned, the width even)
__device__ __forceinline__ void store2(bf16* row, int col, int w, int vec,
                                       float x0, float x1) {
  if (col + 1 < w && vec >= 4) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) =
        __floats2bfloat162_rn(x0, x1);
  } else {
    if (col < w) row[col] = __float2bfloat16(x0);
    if (col + 1 < w) row[col + 1] = __float2bfloat16(x1);
  }
}

// (1) rows, bf16: the algorithm of flash_bwd_rows_kernel on kKeyTileH-key
// tiles. HK: k16 steps of hd the dQ accumulator covers (hd <= 16 HK)
template <int HK, int NS>
__global__ void __launch_bounds__(kThreads, HK <= 8 ? 3 : 2)
flash_bwd_rows_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    bf16* __restrict__ dq, float* __restrict__ stats,
                    Shape sh) {
  constexpr int kKT = kKeyTileH;
  extern __shared__ __align__(16) unsigned char smem_h[];
  const int sq = hstride(sh.hd), sv = hstride(sh.vd);
  bf16* qs = reinterpret_cast<bf16*>(smem_h);  // [kRows][sq]
  bf16* dos = qs + kRows * sq;                  // [kRows][sv]
  bf16* ks = dos + kRows * sv;                  // [NS][kKT][sq]
  bf16* vs = ks + NS * kKT * sq;                // [NS][kKT][sv]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bkv = sh.B * sh.KV;
  const int b = (blockIdx.x % bkv) / sh.KV, kvh = blockIdx.x % sh.KV;
  const int nqt = (sh.Sq + sh.BP - 1) / sh.BP;
  const int q0 = (nqt - 1 - blockIdx.x / bkv) * sh.BP;  // longest first
  const int q_last = min(q0 + sh.BP, sh.Sq) - 1;
  const size_t k_row = static_cast<size_t>(sh.KV) * sh.hd;
  const size_t v_row = static_cast<size_t>(sh.KV) * sh.vd;
  const bf16* kb = k + static_cast<size_t>(b) * sh.Sk * k_row +
                   static_cast<size_t>(kvh) * sh.hd;
  const bf16* vb = v + static_cast<size_t>(b) * sh.Sk * v_row +
                   static_cast<size_t>(kvh) * sh.vd;

  zero_pad_h<kThreads>(qs, kRows, sq, sh.hd);
  zero_pad_h<kThreads>(dos, kRows, sv, sh.vd);
  zero_pad_h<kThreads>(ks, NS * kKT, sq, sh.hd);
  zero_pad_h<kThreads>(vs, NS * kKT, sv, sh.vd);
  auto head_row = [&](const bf16* base, int w, int r) -> const bf16* {
    int hg, pos;
    return row_live(sh, q0, r, hg, pos)
               ? base + ((static_cast<size_t>(b) * sh.Sq + pos) * sh.H +
                         kvh * sh.G + hg) * w
               : nullptr;
  };
  stage_rows<kThreads>(qs, sq, kRows, sh.hd, sh.vec, q,
                       [&](int r) { return head_row(q, sh.hd, r); });
  stage_rows<kThreads>(dos, sv, kRows, sh.vd, sh.vec, dout,
                       [&](int r) { return head_row(dout, sh.vd, r); });
  auto load_tile = [&](int tile, int stage) {
    const int k0 = tile * kKT;
    auto krow = [&](int j) -> const bf16* {
      return k0 + j < sh.Sk ? kb + (k0 + j) * k_row : nullptr;
    };
    auto vrow = [&](int j) -> const bf16* {
      return k0 + j < sh.Sk ? vb + (k0 + j) * v_row : nullptr;
    };
    stage_rows<kThreads>(ks + stage * kKT * sq, sq, kKT, sh.hd, sh.vec, k,
                         krow);
    stage_rows<kThreads>(vs + stage * kKT * sv, sv, kKT, sh.vd, sh.vec, v,
                         vrow);
  };

  int t_lo, t_hi;
  key_range<kKT>(sh, q0, q_last, t_lo, t_hi);
  const int nt = t_hi - t_lo + 1;
  for (int i = 0; i < NS - 1; ++i) {
    if (i < 2 * nt) load_tile(t_lo + i % nt, i);
    cp_commit();  // the first group also holds Q and dO
  }

  const int row0 = warp * 16 + g;
  int hg[2], pos[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    live[h] = row_live(sh, q0, row0 + 8 * h, hg[h], pos[h]);
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float d[2] = {0.f, 0.f};
  float il[2] = {0.f, 0.f};
  float acc[2 * HK][4];
#pragma unroll
  for (int n = 0; n < 2 * HK; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int nks_q = (sh.hd + 15) / 16, nks_v = (sh.vd + 15) / 16;
  // ldmatrix lane offsets: A pattern (A operands; B of a product over the
  // key axis, .trans) and B pattern (B of A.B^T)
  const int r8 = lane & 7, mi = lane >> 3;
  const int a_row = r8 + 8 * (mi & 1), a_col = 8 * (mi >> 1);
  const int b_row = r8 + 8 * (mi >> 1), b_col = 8 * (mi & 1);
  const uint32_t qa = smem_addr(qs + (16 * warp + a_row) * sq + a_col);
  const uint32_t doa = smem_addr(dos + (16 * warp + a_row) * sv + a_col);
  const uint32_t kbt = smem_addr(ks + b_row * sq + b_col);
  const uint32_t vbt = smem_addr(vs + b_row * sv + b_col);
  const uint32_t kat = smem_addr(ks + a_row * sq + a_col);
  const uint32_t k_stage = 2 * kKT * sq, v_stage = 2 * kKT * sv;  // bytes
  const float sc = sh.scale * kLog2e;

  for (int i = 0; i < 2 * nt; ++i) {
    const int stage = i % NS;
    cp_wait<NS - 2>();  // tile i has landed
    __syncthreads();  // ... for every thread; tile i - 1's stage is free
    const int ahead = i + NS - 1;
    if (ahead < 2 * nt) load_tile(t_lo + ahead % nt, ahead % NS);
    cp_commit();  // (empty near the end: keeps wait_group uniform)
    const int k0 = (t_lo + i % nt) * kKT;

    // S = Q.K^T, dP = dO.V^T: this warp's 16 rows x 32 keys; s[j][e] is
    // row g + 8 (e >> 1), key k0 + 8j + 2t + (e & 1)
    float s[4][4], dp[4][4];
    dot2_nt16<2, HK>(s, qa, kbt + stage * k_stage, 32 * sq, nks_q, dp, doa,
                 vbt + stage * v_stage, 32 * sv, nks_v);
    const int k_end = k0 + kKT - 1;
    const bool whole = __all_sync(
        kFull, k_end < sh.Sk &&
                   (!sh.causal || k_end <= min(pos[0], pos[1])) &&
                   (sh.window == 0 || max(pos[0], pos[1]) - k0 < sh.window));
    unsigned vis = 0;  // bit 4j + e: s[j][e] visible
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int st =
            whole ? 0 : key_state(sh, pos[e >> 1], k0 + 8 * j + 2 * t + (e & 1));
        s[j][e] = score2(st, s[j][e], sc);
        vis |= (st == 0 ? 1u : 0u) << (4 * j + e);
      }

    if (i < nt) {  // pass 1: m, l and l D, online
      float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], quad_max(mt[h]));
        const float corr = exp2_sfu(m[h] - m_new);
        m[h] = m_new;
        l[h] *= corr;
        d[h] *= corr;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_sfu(s[j][e] - m[e >> 1]);
          l[e >> 1] += p;
          d[e >> 1] = fmaf(p, dp[j][e], d[e >> 1]);
        }
      if (i == nt - 1) {  // the row's stats, for pass 2 and the keys launch
        const size_t plane = static_cast<size_t>(sh.B) * sh.Sq * sh.H;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          il[h] = 1.f / quad_sum(l[h]);
          d[h] = quad_sum(d[h]) * il[h];
          if (live[h] && t == 0) {
            const size_t at =
                ((static_cast<size_t>(b) * sh.KV + kvh) * sh.Sq + pos[h]) *
                    sh.G + hg[h];
            stats[at] = m[h];
            stats[plane + at] = il[h];
            stats[2 * plane + at] = d[h];
          }
        }
      }
    } else {  // pass 2: dS = P (dP - D), dQ += dS.K, one k16 step a half
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float p = exp2_sfu(s[j][e] - m[h]) * il[h];
          s[j][e] = (vis >> (4 * j + e)) & 1u ? p * (dp[j][e] - d[h]) : 0.f;
        }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t hi[4], lo[4];
        a_frags(s[2 * half], s[2 * half + 1], hi, lo);
        dot_acc16<HK>(acc, hi, lo,
                      kat + stage * k_stage + half * 32 * sq, 32, nks_q);
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
    bf16* row = dq + ((static_cast<size_t>(b) * sh.Sq + pos[h]) * sh.H +
                      kvh * sh.G + hg[h]) * sh.hd;
#pragma unroll
    for (int n = 0; n < 2 * HK; ++n)
      store2(row, 8 * n + 2 * t, sh.hd, sh.vec, acc[n][2 * h] * sh.scale,
             acc[n][2 * h + 1] * sh.scale);
  }
}

// (2) keys, bf16: the algorithm of flash_bwd_keys_kernel, 4 SPLIT warps a
// block. Warp w takes keys 16 (w & 1) .. + 15, rows 16 ((w >> 1) & 1) ..
// + 15 of each row tile (two row streams) and, of the 16-column groups of
// dK and dV, those c with c % SPLIT == w >> 2: SPLIT warps share a
// (keys, rows) block, each computes its S^T and dP^T whole and
// accumulates its own columns, so dK + dV at hd 192 / vd 128 take 80
// floats a lane, not 160. A cluster of blocks shares 32 keys: rank r
// walks the r-th of as many runs of the row tiles, and rank 0 adds the
// others' dK and dV from their shared memory, in rank order. HK, VK: k16
// steps of hd and vd the accumulators cover (hd <= 16 HK, vd <= 16 VK)
template <int HK, int VK, int SPLIT>
__global__ void __launch_bounds__(kThreads * SPLIT,
                                  SPLIT == 1 && HK <= 4 ? 3 : (SPLIT == 1 ? 2 : 1))
flash_bwd_keys_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ stats, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, Shape sh) {
  constexpr int kN = kThreads * SPLIT;
  constexpr int HKW = (HK + SPLIT - 1) / SPLIT, VKW = (VK + SPLIT - 1) / SPLIT;
  extern __shared__ __align__(16) unsigned char smem_h[];
  const int sq = hstride(sh.hd), sv = hstride(sh.vd);
  bf16* ks = reinterpret_cast<bf16*>(smem_h);  // [kKeys][sq]
  bf16* vs = ks + kKeys * sq;                   // [kKeys][sv]
  bf16* qs = vs + kKeys * sv;                   // [kKeyStages][kRowTile][sq]
  bf16* dos = qs + kKeyStages * kRowTile * sq;     // [kKeyStages][kRowTile][sv]
  float* sts = reinterpret_cast<float*>(dos + kKeyStages * kRowTile * sv);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kg = warp & 1, rs = (warp >> 1) & 1, part = warp >> 2;
  const cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int cs = cluster.num_blocks(), rank = cluster.block_rank();
  const int blk = blockIdx.x / cs;
  const int bkv = sh.B * sh.KV;
  const int b = (blk % bkv) / sh.KV, kvh = blk % sh.KV;
  const int k0 = (blk / bkv) * kKeys;  // small k0 sees the most rows
  const int k_last = min(k0 + kKeys, sh.Sk) - 1;
  const size_t k_row = static_cast<size_t>(sh.KV) * sh.hd;
  const size_t v_row = static_cast<size_t>(sh.KV) * sh.vd;
  const bf16* kb = k + static_cast<size_t>(b) * sh.Sk * k_row +
                   static_cast<size_t>(kvh) * sh.hd;
  const bf16* vb = v + static_cast<size_t>(b) * sh.Sk * v_row +
                   static_cast<size_t>(kvh) * sh.vd;

  zero_pad_h<kN>(ks, kKeys, sq, sh.hd);
  zero_pad_h<kN>(vs, kKeys, sv, sh.vd);
  zero_pad_h<kN>(qs, kKeyStages * kRowTile, sq, sh.hd);
  zero_pad_h<kN>(dos, kKeyStages * kRowTile, sv, sh.vd);
  stage_rows<kN>(ks, sq, kKeys, sh.hd, sh.vec, k, [&](int j) -> const bf16* {
    return k0 + j < sh.Sk ? kb + (k0 + j) * k_row : nullptr;
  });
  stage_rows<kN>(vs, sv, kKeys, sh.vd, sh.vec, v, [&](int j) -> const bf16* {
    return k0 + j < sh.Sk ? vb + (k0 + j) * v_row : nullptr;
  });

  // the rows that can see these keys, as in flash_bwd_keys_kernel
  const int p_lo = sh.causal ? k0 : 0;
  int p_hi = sh.window > 0 ? min(sh.Sq - 1, k_last + sh.window - 1)
                           : sh.Sq - 1;
  if (sh.window > 0 && sh.Sk + sh.window - 1 <= sh.Sq - 1) p_hi = sh.Sq - 1;
  const int rho0 = p_lo * sh.G;
  const int rho_end = p_lo <= p_hi ? (p_hi + 1) * sh.G : rho0;
  const int nsteps = (rho_end - rho0 + kRowTile - 1) / kRowTile;
  const int s_lo = rank * nsteps / cs, s_hi = (rank + 1) * nsteps / cs;
  const size_t plane = static_cast<size_t>(sh.B) * sh.Sq * sh.H;
  const float* stb =
      stats + (static_cast<size_t>(b) * sh.KV + kvh) * sh.Sq * sh.G;
  const unsigned gmul = sh.G == 1 ? 0u : 0xffffffffu / sh.G + 1u;
  // row rho of the walk, (position rho / G, head kvh G + rho % G), is row
  // (b Sq + pos) H + kvh G + rho - pos G = b Sq H + kvh G + rho + pos (H - G)
  const size_t row_base = static_cast<size_t>(b) * sh.Sq * sh.H + kvh * sh.G;
  auto load_rows = [&](int step, int stage) {
    const int first = rho0 + step * kRowTile;
    auto row = [&](const bf16* base, int w, int r) -> const bf16* {
      const int rho = first + r;
      if (rho >= rho_end) return nullptr;
      return base + (row_base + rho + static_cast<size_t>(div_g(rho, gmul)) *
                                          (sh.H - sh.G)) * w;
    };
    auto qrow = [&](int r) { return row(q, sh.hd, r); };
    auto dorow = [&](int r) { return row(dout, sh.vd, r); };
    stage_rows<kN>(qs + stage * kRowTile * sq, sq, kRowTile, sh.hd, sh.vec,
                   q, qrow);
    stage_rows<kN>(dos + stage * kRowTile * sv, sv, kRowTile, sh.vd, sh.vec,
                   dout, dorow);
    for (int i = threadIdx.x; i < 3 * kRowTile; i += kN) {
      const int c = i / kRowTile, rho = first + i - c * kRowTile;
      const bool ok = rho < rho_end;
      cp_async<4>(sts + stage * 3 * kRowTile + i,
                  ok ? stb + c * plane + rho : stats, ok);
    }
  };
  for (int i = 0; i < kKeyStages - 1; ++i) {
    if (s_lo + i < s_hi) load_rows(s_lo + i, i);
    cp_commit();  // the first group also holds K and V
  }

  const int kw0 = k0 + 16 * kg;  // this warp's keys kw0 .. kw0 + 15
  const int key[2] = {kw0 + g, kw0 + g + 8};
  float ak[2 * HKW][4], av[2 * VKW][4];
#pragma unroll
  for (int n = 0; n < 2 * HKW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < 2 * VKW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) av[n][e] = 0.f;
  const int nks_q = (sh.hd + 15) / 16, nks_v = (sh.vd + 15) / 16;
  const int ng_q = (nks_q - part + SPLIT - 1) / SPLIT;  // groups owned
  const int ng_v = (nks_v - part + SPLIT - 1) / SPLIT;
  const int r8 = lane & 7, mi = lane >> 3;
  const int a_row = r8 + 8 * (mi & 1), a_col = 8 * (mi >> 1);
  const int b_row = r8 + 8 * (mi >> 1), b_col = 8 * (mi & 1);
  const uint32_t ka = smem_addr(ks + (16 * kg + a_row) * sq + a_col);
  const uint32_t va = smem_addr(vs + (16 * kg + a_row) * sv + a_col);
  // this row stream's rows of stage 0: B pattern (S^T, dP^T) and, at the
  // warp's first column group, A pattern (.trans: dV, dK)
  const uint32_t qbt = smem_addr(qs + (16 * rs + b_row) * sq + b_col);
  const uint32_t dobt = smem_addr(dos + (16 * rs + b_row) * sv + b_col);
  const uint32_t qat =
      smem_addr(qs + (16 * rs + a_row) * sq + 16 * part + a_col);
  const uint32_t doat =
      smem_addr(dos + (16 * rs + a_row) * sv + 16 * part + a_col);
  const uint32_t q_stage = 2 * kRowTile * sq, do_stage = 2 * kRowTile * sv;
  const float sc = sh.scale * kLog2e;

  for (int step = s_lo; step < s_hi; ++step) {
    const int stage = (step - s_lo) % kKeyStages;
    cp_wait<kKeyStages - 2>();  // tile step has landed
    __syncthreads();  // ... for every thread; the last tile's stage is free
    const int ahead = step + kKeyStages - 1;
    if (ahead < s_hi) load_rows(ahead, (ahead - s_lo) % kKeyStages);
    cp_commit();
    const float* mrow = sts + stage * 3 * kRowTile + 16 * rs;
    const int first = rho0 + step * kRowTile + 16 * rs;

    // S^T = K.Q^T, dP^T = V.dO^T: this warp's 16 keys x 16 rows; s[j][e]
    // is key g + 8 (e >> 1), row 8j + 2t + (e & 1)
    float s[2][4], dp[2][4];
    dot2_nt16<1, HK>(s, ka, qbt + stage * q_stage, 0, nks_q, dp, va,
                 dobt + stage * do_stage, 0, nks_v);
    // rows past rho_end are zero (q, dO, m, 1 / l, D): P = 0, dS = 0
    const int pos_first = div_g(first, gmul);
    const int pos_last = div_g(min(first + 16, rho_end) - 1, gmul);
    const bool whole = kw0 + 15 < sh.Sk &&
                       (!sh.causal || kw0 + 15 <= pos_first) &&
                       (sh.window == 0 || pos_last - kw0 < sh.window);
    int rpos[4];  // position of rows 2t, 2t + 1, 8 + 2t, 9 + 2t; -1: dead
    if (!whole) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int rho = first + 8 * (c >> 1) + 2 * t + (c & 1);
        rpos[c] = rho < rho_end ? div_g(rho, gmul) : -1;
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * j + 2 * t + (e & 1);
        const int c = 2 * j + (e & 1);
        const int st =
            whole ? 0 : (rpos[c] < 0 ? 2 : key_state(sh, rpos[c], key[e >> 1]));
        const float p = exp2_sfu(score2(st, s[j][e], sc) - mrow[r]) *
                        mrow[kRowTile + r];
        s[j][e] = p;
        dp[j][e] = st == 0 ? p * (dp[j][e] - mrow[2 * kRowTile + r]) : 0.f;
      }
    // dV += P^T.dO, dK += dS^T.Q over the warp's 16 rows (one k16 step)
    uint32_t hi[4], lo[4];
    a_frags(s[0], s[1], hi, lo);
    dot_acc16<VKW>(av, hi, lo, doat + stage * do_stage, 32 * SPLIT, ng_v);
    a_frags(dp[0], dp[1], hi, lo);
    dot_acc16<HKW>(ak, hi, lo, qat + stage * q_stage, 32 * SPLIT, ng_q);
  }
  cp_wait<0>();

  // the block's dK and dV: row stream 1's through the ring's space to
  // stream 0, which adds them, then the cluster's other blocks' to rank
  // 0, in rank order (fixed orders). fp32 [4 values of each n8 tile of dK,
  // then of dV][2 key groups][32 lanes], 512 (nks_q + nks_v) floats; the
  // ring holds 64 (sq + sv) bf16, more
  __syncthreads();
  float* part_sum = reinterpret_cast<float*>(qs);
  // value e of this warp's n8 tile 2i + j of dK (dV: after dK's 2 nks_q)
  auto k_at = [&](int i, int j, int e) {
    return ((4 * (2 * (i * SPLIT + part) + j) + e) * 2 + kg) * 32 + lane;
  };
  auto v_at = [&](int i, int j, int e) {
    return ((4 * (2 * nks_q + 2 * (i * SPLIT + part) + j) + e) * 2 + kg) *
               32 + lane;
  };
  auto put = [&](float* to) {
#pragma unroll
    for (int i = 0; i < HKW; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (i < ng_q) to[k_at(i, j, e)] = ak[2 * i + j][e];
#pragma unroll
    for (int i = 0; i < VKW; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (i < ng_v) to[v_at(i, j, e)] = av[2 * i + j][e];
  };
  auto add = [&](const float* from) {
#pragma unroll
    for (int i = 0; i < HKW; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (i < ng_q) ak[2 * i + j][e] += from[k_at(i, j, e)];
#pragma unroll
    for (int i = 0; i < VKW; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (i < ng_v) av[2 * i + j][e] += from[v_at(i, j, e)];
  };
  if (rs == 1) put(part_sum);
  __syncthreads();
  if (rs == 0) add(part_sum);
  if (cs > 1) {
    __syncthreads();  // stream 0 has read stream 1's part
    if (rs == 0 && rank != 0) put(part_sum);
    cluster.sync();
    if (rs == 0 && rank == 0)
      for (int r = 1; r < cs; ++r) add(cluster.map_shared_rank(part_sum, r));
    cluster.sync();  // a block's shared memory outlives the reads of it
  }
  if (rs == 1 || rank != 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= sh.Sk) continue;
    const size_t row =
        (static_cast<size_t>(b) * sh.Sk + key[h]) * sh.KV + kvh;
#pragma unroll
    for (int i = 0; i < HKW; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (i < ng_q)
          store2(dk + row * sh.hd, 16 * (i * SPLIT + part) + 8 * j + 2 * t,
                 sh.hd, sh.vec, ak[2 * i + j][2 * h] * sh.scale,
                 ak[2 * i + j][2 * h + 1] * sh.scale);
#pragma unroll
    for (int i = 0; i < VKW; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (i < ng_v)
          store2(dv + row * sh.vd, 16 * (i * SPLIT + part) + 8 * j + 2 * t,
                 sh.vd, sh.vec, av[2 * i + j][2 * h],
                 av[2 * i + j][2 * h + 1]);
  }
}

template <int HK, int VK, int SPLIT, int NS>
cudaError_t launch_bf16(const Shape& sh, cudaStream_t stream, const void* q_,
                        const void* k_, const void* v_, const void* dout_,
                        void* dq_, void* dk_, void* dv_, float* stats) {
  const bf16* q = static_cast<const bf16*>(q_);
  const bf16* k = static_cast<const bf16*>(k_);
  const bf16* v = static_cast<const bf16*>(v_);
  const bf16* dout = static_cast<const bf16*>(dout_);
  const size_t rows_smem = rows_smem_bf16(sh.hd, sh.vd, NS);
  const size_t keys_smem = keys_smem_bf16(sh.hd, sh.vd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_rows_bf16<HK, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(rows_smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_keys_bf16<HK, VK, SPLIT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(keys_smem));
  if (err != cudaSuccess) return err;
  const int bkv = sh.B * sh.KV;
  const int rows_grid = bkv * ((sh.Sq + sh.BP - 1) / sh.BP);
  flash_bwd_rows_bf16<HK, NS><<<rows_grid, kThreads, rows_smem, stream>>>(
      q, k, v, dout, static_cast<bf16*>(dq_), stats, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // each keys block's rows split over a cluster of cs blocks, as many as
  // it takes for the blocks to fill the card's slots: a causal walk's
  // blocks average half the longest one (the first keys see every row),
  // so with fewer blocks than twice the slots the launch is one ragged
  // wave as long as its longest block (GQA: G heads' rows a walk)
  const int keys_blocks = bkv * ((sh.Sk + kKeys - 1) / kKeys);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, flash_bwd_keys_bf16<HK, VK, SPLIT>, kThreads * SPLIT,
      keys_smem);
  if (err != cudaSuccess) return err;
  const int slots = (sh.causal ? 2 : 1) * sms * per_sm;
  const int cs = max(1, min(kMaxCluster, slots / keys_blocks));
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(keys_blocks * cs);
  cfg.blockDim = dim3(kThreads * SPLIT);
  cfg.dynamicSmemBytes = keys_smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, flash_bwd_keys_bf16<HK, VK, SPLIT>, q, k,
                            v, dout, static_cast<const float*>(stats),
                            static_cast<bf16*>(dk_), static_cast<bf16*>(dv_),
                            sh);
}

// the instantiation whose accumulators cover hd and vd: <= 64, <= 128,
// MLA's 192 / 128 (dK + dV split over two warps a block), <= 256
cudaError_t dispatch_bf16(const Shape& sh, cudaStream_t stream, const void* q,
                          const void* k, const void* v, const void* dout,
                          void* dq, void* dk, void* dv, float* stats) {
  if (static_cast<long long>(sh.Sq) * sh.G >= (1LL << 26))  // div_g
    return cudaErrorInvalidValue;
  if (sh.hd <= 64)
    return launch_bf16<4, 4, 1, 3>(sh, stream, q, k, v, dout, dq, dk, dv,
                                   stats);
  if (sh.hd <= 128)
    return launch_bf16<8, 8, 1, 2>(sh, stream, q, k, v, dout, dq, dk, dv,
                                   stats);
  if (sh.hd <= 192 && sh.vd <= 128)
    return launch_bf16<12, 8, 2, 3>(sh, stream, q, k, v, dout, dq, dk, dv,
                                    stats);
  return launch_bf16<16, 16, 2, 2>(sh, stream, q, k, v, dout, dq, dk, dv,
                                   stats);
}

// the widest copy every row of q, k, v and dout stays aligned to (16, 8 or
// 4 bytes); 0 for none. bf16 rows may be 2-byte aligned only (hd 37): then
// 2, one element a load
template <typename T>
int row_copy_bytes(const void* q, const void* k, const void* v,
                   const void* dout, int hd, int vd) {
  int vec = copy_bytes(q, sizeof(T) * hd);
  const int vecs[3] = {copy_bytes(k, sizeof(T) * hd),
                       copy_bytes(v, sizeof(T) * vd),
                       copy_bytes(dout, sizeof(T) * vd)};
  for (int x : vecs) vec = x < vec ? x : vec;
  if (vec == 0 && sizeof(T) == 2) {
    const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(dout);
    if (any % 2 == 0) vec = 2;
  }
  return vec;
}

template <typename T>
cudaError_t dispatch(const Shape& sh, cudaStream_t stream, const void* q,
                     const void* k, const void* v, const void* dout,
                     void* dq, void* dk, void* dv, float* stats) {
  if (sh.hd <= 64)
    return launch<T, 8>(sh, stream, q, k, v, dout, dq, dk, dv, stats);
  if (sh.hd <= 128)
    return launch<T, 16>(sh, stream, q, k, v, dout, dq, dk, dv, stats);
  return launch<T, 32>(sh, stream, q, k, v, dout, dq, dk, dv, stats);
}

}  // namespace

// q, dq [B,Sq,H,hd]; k, dk [B,Sk,KV,hd]; v, dv [B,Sk,KV,vd]; dout
// [B,Sq,H,vd]: all of one type (bf16 != 0: bfloat16, else fp32); stats a
// fp32 scratch of 3 * B * Sq * H floats. Contiguous, on the device;
// H % KV == 0, H / KV <= 64, hd <= 256, vd <= hd. window 0 means
// unbounded. Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout, void* dq,
                                   void* dk, void* dv, float* stats, int bf16,
                                   int B, int Sq, int Sk, int H, int KV,
                                   int hd, int vd, int causal, int window,
                                   float scale, cudaStream_t stream) {
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
  sh.vec = bf16 ? row_copy_bytes<__nv_bfloat16>(q, k, v, dout, hd, vd)
                : row_copy_bytes<float>(q, k, v, dout, hd, vd);
  if (sh.vec == 0) return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaError_t err =
      bf16 ? dispatch_bf16(sh, stream, q, k, v, dout, dq, dk, dv, stats)
           : dispatch<float>(sh, stream, q, k, v, dout, dq, dk, dv, stats);
  return static_cast<int>(err);
}
