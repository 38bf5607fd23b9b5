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
// kernel's own S and dP; masks, uniform rows, longest first, no atomics)
// in the design of the bf16 forward (flash_attention.cu): warpgroup MMAs
// fed by TMA from a producer warp.
//  * A block is 3 warpgroups of 128 threads: warpgroups 0 and 1 consume,
//    each the 64-row M of its wgmma products; warpgroup 2 produces, its one
//    thread keeping a ring of stages full by TMA (cp.async.bulk.tensor on
//    4-D tensor maps over the [B, S, heads, width] tensors, encoded on the
//    host each call) with full (TMA bytes) and empty (8 consumer warps)
//    mbarriers. setmaxnreg moves registers from the producer (40) to the
//    consumers (232). Tiles live as 128-byte-swizzled panels of 64 columns,
//    what TMA's SWIZZLE_128B writes and the descriptors read.
//  * Rows launch: one block per (batch row, KV head, tile of 128 / G
//    positions), 128 rows position-major (row r: position q0 + r / G, head
//    r % G), so one TMA box {64 columns, G heads, 128 / G positions} fills
//    a panel of Q or dO, loaded once. K/V tiles of KT keys stream through
//    the ring twice (pass 1, pass 2). S = Q.K^T and dP = dO.V^T are
//    wgmma_ss (both operands K-major); dQ += dS.K is wgmma_rs with the K
//    tile as B MN-major (the descriptor's transpose bit: its 64-column
//    panels KT rows apart, 16 keys 2048 bytes apart), as the forward's V.
//  * Keys launch: one block per (batch row, KV head, 128 keys): warpgroup w
//    takes keys 64 w .. + 63 as the M of S^T = K.Q^T and dP^T = V.dO^T
//    (wgmma_ss), and dV += P^T.dO, dK += dS^T.Q (wgmma_rs, the row tile's
//    Q and dO as B MN-major). The S^T and dP^T accumulators are the A
//    fragments as they stand (the m16n8k16 layout a warp), so P and dS
//    never touch shared memory. The walk: the (position, head) rows that
//    can see the block's keys, position-major, in tiles of RT rows = HC
//    heads x PT positions, one TMA box each (HC = min(G, RT); G > RT splits
//    a position's heads over tiles), with the rows' m, 1 / l and D by
//    1-D TMA boxes of the stats. A box must start on a 16-byte boundary (a
//    start off one faulted: cudaErrorIllegalInstruction), so each takes RT
//    + 4 floats from the boundary at or below the tile's first row and the
//    consumers read at that offset. Rows a box leaves unwritten (G not
//    dividing RT) are zeroed once; rows past the walk take P = dS = 0.
//  * Rows TMA cannot describe (not 16-byte aligned: hd 37 / vd 21) are
//    copied by the producer's 128 threads, a row each, element loads into
//    the same swizzled panels with zeros to the panel's end, then
//    fence.proxy.async and one arrival. No copy loop divides.
//  * P and dS are fp32 and go in as bf16 hi + bf16 lo (lo = bf16(x - hi)):
//    two wgmma_rs passes, lo then hi, against the exact bf16 B operand. One
//    rounded pass misses 2^-8 x max of float64: dS cancels (sum_j dS = 0)
//    and a shared key part turns its rounding into dQ error above 2^-7 x
//    max; one pass of P spends over a quarter of 2^-8 on dV before the
//    output's own rounding (tests/test_torch_flash_bwd_bf16_numerics.py).
//  * Every k16 step accumulates in place in fp32 (the tensor cores truncate
//    each sum: ~2^-24 of the running sum on average; the CPU emulation of
//    this order stays within 2^-13 x max before the store's rounding, at a
//    key block that sees 8192 rows too); dQ, dK and dV are rounded to bf16
//    once, at the store. No atomics: bitwise repeatable.
//  * The keys launch splits a keys block's rows over a cluster of up to 4
//    blocks when the blocks would not fill the card's slots twice over
//    (a causal walk's blocks average half the longest; GQA walks G heads'
//    rows, so Qwen2.5-3B's call is 64 blocks of up to 16384 rows). Rank r
//    walks the r-th run of row tiles; after the walk each rank's consumer
//    warpgroups put their fp32 dK and dV in their shared memory, one
//    warpgroup a round, and rank 0 adds them from there (distributed shared
//    memory), in rank order.
//  * Instantiations (rows <HK, VK, KT, stages>, keys <HK, VK, RT, stages,
//    SPLIT>): hd <= 64: <64, 64, 64, 3>, <64, 64, 64, 4, 1>; <= 128: <128,
//    128, 64, 3>, <128, 128, 32, 4, 1>; MLA's 192 / 128: <192, 128, 64, 3>,
//    <192, 128, 16, 4, 1> (dK + dV are 160 floats a thread; with 32-row
//    tiles the keys kernel spills 28 bytes); <= 256: <256, 256, 32, 2>,
//    <256, 256, 32, 3, 2>, where a keys block is 64 keys and warpgroup 0
//    takes dK, warpgroup 1 dV (dK + dV, 256 floats a thread, exceed 232
//    registers), S^T computed by both. A rows consumer holds dQ (HK / 2 floats), S and dP (KT / 2
//    each) and dS hi + lo (KT / 2 words); a keys consumer dK + dV ((HK +
//    VK) / 2), S^T and dP^T (RT / 2 each) and P, dS hi + lo (RT / 2 words
//    each). The launcher refuses hd or vd past its instantiation's panels.
//  * Work: the least autograd needs is 6 hd + 4 vd flops a visible
//    (query, key) pair and head (bwd_cost). The kernels execute 14 hd +
//    10 vd of MMA passes (rows: S and dP twice, dQ two passes; keys: S^T
//    and dP^T once, dV and dK two passes each), 2.4x at hd = vd; 16 hd + 10
//    vd at 256 (S^T twice); plus the causal diagonal's masked part-tiles.
//    What bounds it at the recorded calls (989 TFLOP/s bf16): operations:
//    Qwen1.5-0.5B's (B 4, H = KV = 16, hd 64) and Qwen2.5-3B's (B 2, H 16,
//    KV 2, hd 128) 85.9 GFLOP, 0.0869 ms; DeepSeek-V2's MLA call (B 1, H =
//    KV = 128, hd 192, vd 128) 447 GFLOP, 0.452 ms; their bytes take
//    0.035, 0.018 and 0.18 ms.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py --profile, CUDA
// events): Qwen2.5-3B's training call (B 2, S 2048, H 16 / KV 2, hd 128,
// causal) 0.913 ms (the mma.sync design: 1.634), 226 TFLOP/s of executed
// passes, 10.5x its bound at 989; the train CLI's Qwen1.5-0.5B call (B 4,
// H = KV = 16, hd 64) 1.132 (1.770), 182 TFLOP/s; DeepSeek-V2's MLA call
// 4.301 (10.008), 248 TFLOP/s. SDPA's bf16 backward alone, same run:
// 0.793, 0.461, 1.258. tools/flash_bwd_check.py --variants (same card), by
// launch, rows / keys: 0.357 / 0.536 at Qwen2.5-3B's call, 0.575 / 0.529 at
// Qwen1.5-0.5B's; in turns against the shipped build: the cluster split is
// worth 2x at Qwen2.5-3B's call (0.89-0.90 ms; no split 1.81, at most 2
// blocks 1.12, at most 8 0.89); at MLA's call (4.19-4.31) 32-row keys tiles
// take 3.85 with their spill, dK and dV on a warpgroup each 5.15. ptxas:
// 168 registers at launch (setmaxnreg then 40 / 232), no stack and no
// spills at any bf16 instantiation; SASS: HGMMA only, no HMMA
// (chip_smoke.py checks both).
//
// What is left: the 2.4x executed work (S and dP in both launches and
// twice in the rows launch; P and dS as hi + lo) needs an LSE and D from
// the forward, or dQ by atomics, to come down; within a warpgroup the
// softmax between a tile's products does not overlap them; the keys
// launch's S^T and dP^T at N = 16 or 32 rows read more shared memory a
// flop than the tensor cores use.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <initializer_list>
#include <type_traits>

#include "hopper.cuh"
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

// 0: visible; 1: masked (NEG_INF, no gradient); 2: past Sk (no part).
// Sh: Shape or BwdBf16
template <typename Sh>
__device__ __forceinline__ int key_state(const Sh& sh, int pos, int key) {
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
template <int kT = kTile, typename Sh = Shape>
__device__ __forceinline__ void key_range(const Sh& sh, int q0,
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

// ---- bf16: wgmma on the bf16 tensor cores, fed by TMA from a producer warp

constexpr int kBRows = 128;      // rows launch: rows a block (2 warpgroups x 64)
constexpr int kBThreads = 384;   // 2 consumer warpgroups + 1 producer
constexpr int kMaxCluster = 4;   // keys launch: blocks sharing a block of keys

struct BwdBf16 {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* stats;
  int B, Sq, Sk, H, KV, G, hd, vd, causal, window;
  float scale;
  int BQ;          // rows launch: positions a block, 128 / G
  int HC, PT, NC;  // keys launch: a row tile is HC heads x PT positions; NC
                   // tiles a position (G > the tile's rows)
  unsigned hmul;   // r / HC as a multiply-high by ceil(2^32 / HC); 0: HC 1
  int tma;      // 1: tiles by TMA; 0: element loads (rows not 16-byte aligned)
  int out_vec;  // 1: output pairs as 4-byte stores
};

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// descriptor offset (16-byte units) of k16 step kk of a K-major operand
// whose 64-column panels hold `rows` rows
__device__ __forceinline__ uint64_t kstep(int kk, int rows) {
  return static_cast<uint64_t>(kk >> 2) * (rows * kPanelRow >> 4) +
         (kk & 3) * 2;
}
constexpr uint64_t kRowStep = 16 * kPanelRow >> 4;  // 16 rows, MN-major

// one or two adjacent bf16 outputs: a 4-byte store where every row allows
// it (pairs: rows 4-byte aligned, the width even)
__device__ __forceinline__ void store2(bf16* row, int col, int w, int pairs,
                                       float x0, float x1) {
  if (col + 1 < w && pairs) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) =
        __floats2bfloat162_rn(x0, x1);
  } else {
    if (col < w) row[col] = __float2bfloat16(x0);
    if (col + 1 < w) row[col + 1] = __float2bfloat16(x1);
  }
}

// shared memory of flash_bwd_rows_bf16<HK, VK, KT, NS> (bytes): Q (HK / 64
// panels of 128 rows), dO (VK / 64), NS stages of K (HK / 64 panels of KT
// rows) and V (VK / 64), the mbarriers, and 1024 bytes to align the start
// to the swizzle atom
template <int HK, int VK, int KT, int NS>
struct RowsLayout {
  static constexpr int kQBytes = HK / kPanel * kBRows * kPanelRow;
  static constexpr int kDoBytes = VK / kPanel * kBRows * kPanelRow;
  static constexpr int kKBytes = HK / kPanel * KT * kPanelRow;
  static constexpr int kVBytes = VK / kPanel * KT * kPanelRow;
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr int kRingOffset = kQBytes + kDoBytes;
  static constexpr int kBarOffset = kRingOffset + NS * kStageBytes;
  static constexpr int kBytes = kBarOffset + 8 * (1 + 2 * NS) + 1024;
};

// (1) rows, bf16: the stats and dQ. One block per (batch row, KV head, tile
// of BQ = 128 / G positions): 128 rows, row r = position q0 + r / G, head
// kvh G + r % G (idle past G BQ or Sq), as the forward's. Warpgroups 0 and
// 1 consume, 64 rows each; warpgroup 2 produces: Q and dO once, then the
// key tiles [t_lo, t_hi] of KT keys twice (pass 1, pass 2) through an
// NS-stage ring. HK, VK: q/k and v width bounds (panels of 64 columns)
template <int HK, int VK, int KT, int NS>
__global__ void __launch_bounds__(kBThreads, 1)
flash_bwd_rows_bf16(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ BwdBf16 a) {
  using L = RowsLayout<HK, VK, KT, NS>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* qs = smem;                // [HK / 64][128 rows][128 bytes]
  unsigned char* dos = smem + L::kQBytes;  // [VK / 64][128 rows][128 bytes]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* full_q = bars;          // Q and dO arrived
  uint64_t* full = bars + 1;        // [NS]: a K/V stage arrived
  uint64_t* empty = bars + 1 + NS;  // [NS]: 8 consumer warps are done
  auto k_stage = [&](int s) {
    return smem + L::kRingOffset + s * L::kStageBytes;
  };
  auto v_stage = [&](int s) { return k_stage(s) + L::kKBytes; };
  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int G = a.G, BQ = a.BQ, Sq = a.Sq, Sk = a.Sk;
  // block x: position tile x / (B KV) counted from the last (the longest
  // causal walk first), then (b, kvh)
  const int bkv_n = a.B * a.KV, n_qt = (Sq + BQ - 1) / BQ;
  const int tile_r = blockIdx.x / bkv_n, bkv = blockIdx.x - tile_r * bkv_n;
  const int b = bkv / a.KV, kvh = bkv - b * a.KV;
  const int q0 = (n_qt - 1 - tile_r) * BQ;
  const int q_last = min(q0 + BQ, Sq) - 1;
  int t_lo, t_hi;
  key_range<KT>(a, q0, q_last, t_lo, t_hi);
  const int nt = t_hi - t_lo + 1;  // key tiles a pass
  const int pq = (a.hd + kPanel - 1) / kPanel;  // live panels of q / k
  const int pv = (a.vd + kPanel - 1) / kPanel;  // and of v / dout

  if (threadIdx.x >= 2 * 128) {
    // ---------------- producer warpgroup
    regs_dec<kProducerRegs>();
    const int t = threadIdx.x - 2 * 128;
    if (a.tma) {
      if (t != 0) return;
      mbar_expect_tx(full_q, (pq + pv) * G * BQ * kPanelRow);
      for (int p = 0; p < pq; ++p)
        tma_load_4d(qs + p * kBRows * kPanelRow, &tq, full_q, p * kPanel,
                    kvh * G, q0, b);
      for (int p = 0; p < pv; ++p)
        tma_load_4d(dos + p * kBRows * kPanelRow, &tdo, full_q, p * kPanel,
                    kvh * G, q0, b);
      int s = 0, use = 0;
      for (int i = 0; i < 2 * nt; ++i) {
        if (use > 0) mbar_wait(empty + s, (use - 1) & 1);
        mbar_expect_tx(full + s, (pq + pv) * KT * kPanelRow);
        const int k0 = (t_lo + (i < nt ? i : i - nt)) * KT;
        for (int p = 0; p < pq; ++p)
          tma_load_4d(k_stage(s) + p * KT * kPanelRow, &tk, full + s,
                      p * kPanel, kvh, k0, b);
        for (int p = 0; p < pv; ++p)
          tma_load_4d(v_stage(s) + p * KT * kPanelRow, &tv, full + s,
                      p * kPanel, kvh, k0, b);
        if (++s == NS) {
          s = 0;
          ++use;
        }
      }
      return;
    }
    // rows not 16-byte aligned: thread t stages row t of each tile
    const bf16* qrow = nullptr;
    const bf16* dorow = nullptr;
    if (t < G * BQ && q0 + t / G < Sq) {
      const size_t row = (static_cast<size_t>(b) * Sq + q0 + t / G) * a.H +
                         kvh * G + t % G;
      qrow = a.q + row * a.hd;
      dorow = a.dout + row * a.vd;
    }
    stage_row(qs, kBRows, pq, t, qrow, a.hd);
    stage_row(dos, kBRows, pv, t, dorow, a.vd);
    fence_async_smem();
    bar_sync(1, 128);
    if (t == 0) mbar_arrive(full_q);
    const size_t k_row = static_cast<size_t>(a.KV) * a.hd;
    const size_t v_row = static_cast<size_t>(a.KV) * a.vd;
    const bf16* kb = a.k + static_cast<size_t>(b) * Sk * k_row +
                     static_cast<size_t>(kvh) * a.hd;
    const bf16* vb = a.v + static_cast<size_t>(b) * Sk * v_row +
                     static_cast<size_t>(kvh) * a.vd;
    int s = 0, use = 0;
    for (int i = 0; i < 2 * nt; ++i) {
      if (use > 0) mbar_wait(empty + s, (use - 1) & 1);
      const int key = (t_lo + (i < nt ? i : i - nt)) * KT + t;
      if (t < KT) {
        stage_row(k_stage(s), KT, pq, t, key < Sk ? kb + key * k_row : nullptr,
                  a.hd);
        stage_row(v_stage(s), KT, pv, t, key < Sk ? vb + key * v_row : nullptr,
                  a.vd);
      }
      fence_async_smem();
      bar_sync(1, 128);
      if (t == 0) mbar_arrive(full + s);
      if (++s == NS) {
        s = 0;
        ++use;
      }
    }
    return;
  }

  // ---------------- consumer warpgroups
  regs_inc<kConsumerRegs>();
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // this lane's rows (h = 0: row g, h = 1: row g + 8 of the warp): their
  // head and position, and whether they are live; an idle row takes the
  // block's last position and is never stored
  const int row0 = 64 * wg + 16 * warp + g;
  auto row_at = [&](int h, int& head, int& pos) {
    const int r = row0 + 8 * h, pr = r / G;
    head = r - pr * G;
    pos = q0 + pr;
    return r < G * BQ && pos < Sq;
  };
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int head;
    if (!row_at(h, head, pos[h])) pos[h] = q_last;
  }
  const int nks_q = (a.hd + 15) >> 4, nks_v = (a.vd + 15) >> 4;
  const float sc = a.scale * kLog2e;  // scores in log2 units
  // descriptors: Q and dO (this warpgroup's 64 rows), the stage's K and V
  // K-major (S, dP); its K tile again MN-major, dQ's B: 64-column panels
  // KT rows apart, 16 keys 2048 bytes apart (the forward's V)
  const uint64_t q_desc =
      sw128_desc(smem_u32(qs) + wg * 64 * kPanelRow, 16, 1024);
  const uint64_t do_desc =
      sw128_desc(smem_u32(dos) + wg * 64 * kPanelRow, 16, 1024);
  const uint32_t ring = smem_u32(k_stage(0));

  float acc[HK / 2];  // dQ
#pragma unroll
  for (int i = 0; i < HK / 2; ++i) acc[i] = 0.f;
  float s[KT / 2], dp[KT / 2];
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) s[i] = dp[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max, quad-uniform
  float l[2] = {0.f, 0.f};  // pass 1: this lane's part of l; then 1 / l
  float d[2] = {0.f, 0.f};  // pass 1: this lane's part of l D; then D

  mbar_wait(full_q, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < 2 * nt; ++i) {
    const bool pass1 = i < nt;
    const int k0 = (t_lo + (pass1 ? i : i - nt)) * KT;
    // --- S = Q.K^T, dP = dO.V^T: this warpgroup's 64 rows x KT keys, the
    // same instructions on the same values in both passes
    mbar_wait(full + stage, phase);
    const uint32_t ka = ring + stage * L::kStageBytes;  // the stage's K
    wgmma_fence();
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int kk = 0; kk < HK / 16; ++kk)
      if (kk < nks_q)
        wgmma_ss<KT>(s, q_desc + kstep(kk, kBRows),
                     sw128_desc(ka, 16, 1024) + kstep(kk, KT), kk > 0);
#pragma unroll
    for (int kk = 0; kk < VK / 16; ++kk)
      if (kk < nks_v)
        wgmma_ss<KT>(dp, do_desc + kstep(kk, kBRows),
                     sw128_desc(ka + L::kKBytes, 16, 1024) + kstep(kk, KT),
                     kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    if (pass1 && lane == 0) mbar_arrive(empty + stage);  // K and V are read

    // --- masks; s[4j + e] is row g + 8 (e >> 1), key k0 + 8j + 2t +
    // (e & 1). A tile every row of the warp sees whole skips them
    const int k_end = k0 + KT - 1;
    const bool whole = __all_sync(
        kFull, k_end < Sk && (!a.causal || k_end <= min(pos[0], pos[1])) &&
                   (a.window == 0 || max(pos[0], pos[1]) - k0 < a.window));
    uint32_t vis = 0;  // bit 4j + e: s[4j + e] visible
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int st = whole ? 0
                             : key_state(a, pos[e >> 1],
                                         k0 + 8 * j + 2 * t + (e & 1));
        s[4 * j + e] = score2(st, s[4 * j + e], sc);
        vis |= (st == 0 ? 1u : 0u) << (4 * j + e);
      }

    if (pass1) {  // m, l and l D, online
      float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int x = 0; x < KT / 2; ++x)
        mt[(x >> 1) & 1] = fmaxf(mt[(x >> 1) & 1], s[x]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], quad_max(mt[h]));
        const float corr = exp2_sfu(m[h] - m_new);
        m[h] = m_new;
        l[h] *= corr;
        d[h] *= corr;
      }
#pragma unroll
      for (int x = 0; x < KT / 2; ++x) {
        const int h = (x >> 1) & 1;
        const float p = exp2_sfu(s[x] - m[h]);
        l[h] += p;
        d[h] = fmaf(p, dp[x], d[h]);
      }
      if (i == nt - 1) {  // the row's stats, for pass 2 and the keys launch
        const size_t plane = static_cast<size_t>(a.B) * Sq * a.H;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          l[h] = 1.f / quad_sum(l[h]);
          d[h] = quad_sum(d[h]) * l[h];
          int head, p;
          if (row_at(h, head, p) && t == 0) {
            const size_t at =
                ((static_cast<size_t>(b) * a.KV + kvh) * Sq + p) * G + head;
            a.stats[at] = m[h];
            a.stats[plane + at] = l[h];
            a.stats[2 * plane + at] = d[h];
          }
        }
      }
    } else {
      // dS = P (dP - D) as bf16 hi + lo A fragments: the accumulator's 16
      // key columns of a k16 step are the fragment as they stand
      uint32_t dh[KT / 16][4], dl[KT / 16][4];
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        float x[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int at = 8 * kk + e, h = (e >> 1) & 1;
          const float p = exp2_sfu(s[at] - m[h]) * l[h];
          x[e] = (vis >> at) & 1u ? p * (dp[at] - d[h]) : 0.f;
        }
#pragma unroll
        for (int f = 0; f < 4; ++f)
          split_bf16(x[2 * f], x[2 * f + 1], dh[kk][f], dl[kk][f]);
      }
      // --- dQ += dS.K, lo pass then hi a k16 step, in place
      wgmma_fence();
      fence_regs(acc);
      fence_regs(dh);
      fence_regs(dl);
      const uint64_t kt_desc = sw128_desc(ka, KT * kPanelRow, 1024);
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        wgmma_rs<HK>(acc, dl[kk], kt_desc + kk * kRowStep);
        wgmma_rs<HK>(acc, dh[kk], kt_desc + kk * kRowStep);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(dh);
      fence_regs(dl);
      if (lane == 0) mbar_arrive(empty + stage);  // K is read
    }
    if (++stage == NS) {
      stage = 0;
      phase ^= 1u;
    }
  }

  // dq, rounded to bf16 once
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int head, p;
    if (!row_at(h, head, p)) continue;
    bf16* row = a.dq + ((static_cast<size_t>(b) * Sq + p) * a.H + kvh * G +
                        head) * a.hd;
#pragma unroll
    for (int j = 0; j < HK / 8; ++j)
      store2(row, 8 * j + 2 * t, a.hd, a.out_vec, acc[4 * j + 2 * h] * a.scale,
             acc[4 * j + 2 * h + 1] * a.scale);
  }
}

// shared memory of flash_bwd_keys_bf16<HK, VK, RT, NS, SPLIT> (bytes): the
// block's K and V (kKeys rows), NS stages of a row tile (Q: HK / 64 panels
// of RT rows, dO: VK / 64, the rows' m, 1 / l and D: RT + 4 floats each
// from the 16-byte boundary at or below the tile's first row, as TMA
// boxes must start), the mbarriers, and 1024 bytes to align the start.
// After the walk the same space holds a warpgroup's fp32 dK and dV
// partials for the cluster's rank 0
template <int HK, int VK, int RT, int NS, int SPLIT>
struct KeysLayout {
  static constexpr int kKeys = SPLIT == 1 ? 128 : 64;  // keys a block
  static constexpr int kKBytes = HK / kPanel * kKeys * kPanelRow;
  static constexpr int kVBytes = VK / kPanel * kKeys * kPanelRow;
  static constexpr int kQBytes = HK / kPanel * RT * kPanelRow;
  static constexpr int kDoBytes = VK / kPanel * RT * kPanelRow;
  static constexpr int kStatStride = ((RT + 4) * 4 + 127) / 128 * 128;
  static constexpr int kStatBytes = (3 * kStatStride + 1023) / 1024 * 1024;
  static constexpr int kStageBytes = kQBytes + kDoBytes + kStatBytes;
  static constexpr int kRingOffset = kKBytes + kVBytes;
  static constexpr int kBarOffset = kRingOffset + NS * kStageBytes;
  static constexpr int kPartBytes =
      64 * 4 * (SPLIT == 1 ? HK + VK : (HK > VK ? HK : VK));
  static_assert(kPartBytes <= kBarOffset, "partials fit below the barriers");
  static constexpr int kBytes = kBarOffset + 8 * (1 + 2 * NS) + 1024;
};

template <int N>
using Width = std::integral_constant<int, N>;

// (2) keys, bf16: dK and dV. One block per (batch row, KV head, kKeys
// keys), times a cluster of cs blocks that split its walk. The walk: the
// (position, head) rows that can see those keys, in row tiles of RT rows
// (HC heads x PT positions, one TMA box), with their m, 1 / l and D. SPLIT
// 1: warpgroup w takes keys 64 w .. + 63 of the block's 128, all of dK and
// dV; SPLIT 2 (hd > 192): both take the block's 64 keys, warpgroup 0 dK,
// warpgroup 1 dV. Warpgroup 2 produces: K and V once, the row tiles through
// an NS-stage ring. Rank r of the cluster walks the r-th of cs runs of the
// tiles; rank 0 adds the others' dK and dV from their shared memory, in
// rank order, and stores
template <int HK, int VK, int RT, int NS, int SPLIT>
__global__ void __launch_bounds__(kBThreads, 1)
flash_bwd_keys_bf16(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tst,
                    const __grid_constant__ BwdBf16 a) {
  using L = KeysLayout<HK, VK, RT, NS, SPLIT>;
  constexpr int kBlockKeys = L::kKeys;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* ks = smem;                // [HK / 64][kBlockKeys][128 bytes]
  unsigned char* vs = smem + L::kKBytes;   // [VK / 64][kBlockKeys][128 bytes]
  auto q_stage = [&](int s) {
    return smem + L::kRingOffset + s * L::kStageBytes;
  };
  auto do_stage = [&](int s) { return q_stage(s) + L::kQBytes; };
  auto st_stage = [&](int s) {  // [m, 1 / l, D][kStatStride bytes]
    return reinterpret_cast<float*>(do_stage(s) + L::kDoBytes);
  };
  constexpr int kSS = L::kStatStride / 4;  // floats between the stats
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* full_kv = bars;         // K and V arrived
  uint64_t* full = bars + 1;        // [NS]: a row tile arrived
  uint64_t* empty = bars + 1 + NS;  // [NS]: 8 consumer warps are done

  const int G = a.G, HC = a.HC, PT = a.PT, NC = a.NC, Sq = a.Sq, Sk = a.Sk;
  const int box_rows = HC * PT;  // rows a tile's box fills
  const int pq = (a.hd + kPanel - 1) / kPanel;
  const int pv = (a.vd + kPanel - 1) / kPanel;
  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);
    }
    mbar_init_fence();
  }
  if (a.tma && box_rows < RT) {
    // the rows no box writes stay zero: their P and dS are 0, and the
    // products' 0 x (what the rows hold) must be 0
    const int gap = RT - box_rows, panels = pq + pv;
    for (int i = threadIdx.x; i < NS * panels * gap * 8; i += kBThreads) {
      const int c = i & 7, rest = i >> 3, row = box_rows + rest % gap;
      const int sp = rest / gap, s = sp / panels, p = sp - s * panels;
      unsigned char* panel = p < pq ? q_stage(s) + p * RT * kPanelRow
                                    : do_stage(s) + (p - pq) * RT * kPanelRow;
      *reinterpret_cast<uint4*>(panel + row * kPanelRow + c * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    fence_async_smem();
  }
  __syncthreads();

  const cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int cs = cluster.num_blocks(), rank = cluster.block_rank();
  const int blk = blockIdx.x / cs, bkv_n = a.B * a.KV;
  const int b = (blk % bkv_n) / a.KV, kvh = blk % a.KV;
  const int k0 = (blk / bkv_n) * kBlockKeys;  // small k0 sees the most rows
  const int k_last = min(k0 + kBlockKeys, Sk) - 1;
  // the positions that can see these keys; all of them from the first
  // that sees no key at all (it is uniform over every key)
  const int p_lo = a.causal ? k0 : 0;
  int p_hi = a.window > 0 ? min(Sq - 1, k_last + a.window - 1) : Sq - 1;
  if (a.window > 0 && Sk + a.window - 1 <= Sq - 1) p_hi = Sq - 1;
  const int n_pb = p_lo <= p_hi ? (p_hi - p_lo) / PT + 1 : 0;
  const int nsteps = n_pb * NC;
  const int s_lo = rank * nsteps / cs, s_hi = (rank + 1) * nsteps / cs;
  // tile i: positions p_lo + (i / NC) PT .., heads (i % NC) HC .. of the
  // group; its stats start at element (b KV + kvh) Sq G + position G +
  // head of each plane, and land in the stage at that element's offset
  // from its 16-byte boundary
  const size_t plane = static_cast<size_t>(a.B) * Sq * a.H;
  const size_t st_base = (static_cast<size_t>(b) * a.KV + kvh) * Sq * G;
  auto st_at = [&](int i, int c) {  // plane c's first element of tile i
    const int pb = NC == 1 ? i : i / NC;
    return c * plane + st_base + static_cast<size_t>(p_lo + pb * PT) * G +
           (i - pb * NC) * HC;
  };

  if (threadIdx.x >= 2 * 128) {
    // ---------------- producer warpgroup
    regs_dec<kProducerRegs>();
    const int t = threadIdx.x - 2 * 128;
    if (a.tma) {
      if (t == 0) {
        mbar_expect_tx(full_kv, (pq + pv) * kBlockKeys * kPanelRow);
        for (int p = 0; p < pq; ++p)
          tma_load_4d(ks + p * kBlockKeys * kPanelRow, &tk, full_kv,
                      p * kPanel, kvh, k0, b);
        for (int p = 0; p < pv; ++p)
          tma_load_4d(vs + p * kBlockKeys * kPanelRow, &tv, full_kv,
                      p * kPanel, kvh, k0, b);
        int s = 0, use = 0;
        for (int i = s_lo; i < s_hi; ++i) {
          const int pb = NC == 1 ? i : i / NC, ch = i - pb * NC;
          const int p0 = p_lo + pb * PT;
          if (use > 0) mbar_wait(empty + s, (use - 1) & 1);
          mbar_expect_tx(full + s,
                         (pq + pv) * box_rows * kPanelRow + 3 * (RT + 4) * 4);
          for (int p = 0; p < pq; ++p)
            tma_load_4d(q_stage(s) + p * RT * kPanelRow, &tq, full + s,
                        p * kPanel, kvh * G + ch * HC, p0, b);
          for (int p = 0; p < pv; ++p)
            tma_load_4d(do_stage(s) + p * RT * kPanelRow, &tdo, full + s,
                        p * kPanel, kvh * G + ch * HC, p0, b);
          for (int c = 0; c < 3; ++c)
            tma_load_1d(st_stage(s) + c * kSS, &tst, full + s,
                        static_cast<int>(st_at(i, c) & ~size_t(3)));
          if (++s == NS) {
            s = 0;
            ++use;
          }
        }
      }
    } else {
      // rows not 16-byte aligned: thread t stages key t of K and V, then
      // row t (position + t / HC, head + t % HC) of each tile
      if (t < kBlockKeys) {
        const int key = k0 + t;
        const size_t row = (static_cast<size_t>(b) * Sk + key) * a.KV + kvh;
        stage_row(ks, kBlockKeys, pq, t, key < Sk ? a.k + row * a.hd : nullptr,
                  a.hd);
        stage_row(vs, kBlockKeys, pv, t, key < Sk ? a.v + row * a.vd : nullptr,
                  a.vd);
      }
      fence_async_smem();
      bar_sync(1, 128);
      if (t == 0) mbar_arrive(full_kv);
      const int rp = t / HC, rh = t - rp * HC;
      int s = 0, use = 0;
      for (int i = s_lo; i < s_hi; ++i) {
        const int pb = NC == 1 ? i : i / NC, ch = i - pb * NC;
        if (use > 0) mbar_wait(empty + s, (use - 1) & 1);
        if (t < RT) {
          const int pos = p_lo + pb * PT + rp, hh = ch * HC + rh;
          const bool ok = t < box_rows && pos < Sq && hh < G;
          const size_t row =
              (static_cast<size_t>(b) * Sq + pos) * a.H + kvh * G + hh;
          stage_row(q_stage(s), RT, pq, t, ok ? a.q + row * a.hd : nullptr,
                    a.hd);
          stage_row(do_stage(s), RT, pv, t, ok ? a.dout + row * a.vd : nullptr,
                    a.vd);
          float* st = st_stage(s);
          for (int c = 0; c < 3; ++c) {
            const size_t at = st_at(i, c);
            st[c * kSS + (at & 3) + t] =
                ok ? a.stats[at + t + rp * (G - HC)] : 0.f;
          }
        }
        fence_async_smem();
        bar_sync(1, 128);
        if (t == 0) mbar_arrive(full + s);
        if (++s == NS) {
          s = 0;
          ++use;
        }
      }
    }
    if (cs > 1)  // the consumers' two rounds of partials
      for (int r = 0; r < 4; ++r) cluster_sync();
    return;
  }

  // ---------------- consumer warpgroups
  regs_inc<kConsumerRegs>();
  const int wg = threadIdx.x >> 7;
  // NK, NV: the dK and dV columns this warpgroup accumulates (0: none)
  auto consume = [&](auto nk, auto nv) {
    constexpr int NK = decltype(nk)::value, NV = decltype(nv)::value;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int kb0 = SPLIT == 1 ? 64 * wg : 0;  // its keys in the block
    const int kw0 = k0 + kb0 + 16 * warp;      // this warp's kw0 .. + 15
    const int nks_q = (a.hd + 15) >> 4, nks_v = (a.vd + 15) >> 4;
    const float sc = a.scale * kLog2e;
    // descriptors: K and V (this warpgroup's 64 keys) and the stage's Q and
    // dO K-major (S^T, dP^T); its Q and dO again MN-major, dK's and dV's B:
    // 64-column panels RT rows apart, 16 rows 2048 bytes apart
    const uint32_t ka = smem_u32(ks) + kb0 * kPanelRow;
    const uint32_t ring = smem_u32(q_stage(0));
    // where plane c's stats of tile i start in their box: (st_at(i, c) & 3)
    // = (first + i's rows + c plane) & 3, from two small ints
    const int first = static_cast<int>(st_at(0, 0) & 3);
    const int pl1 = static_cast<int>(plane & 3);

    float ak[NK > 0 ? NK / 2 : 1], av[NV > 0 ? NV / 2 : 1];  // dK, dV
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) ak[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) av[i] = 0.f;
    float s[RT / 2], dp[RT / 2];
#pragma unroll
    for (int i = 0; i < RT / 2; ++i) s[i] = dp[i] = 0.f;

    mbar_wait(full_kv, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int i = s_lo; i < s_hi; ++i) {
      const int pb = NC == 1 ? i : i / NC, ch = i - pb * NC;
      const int p0 = p_lo + pb * PT;
      // --- S^T = K.Q^T, dP^T = V.dO^T (dK needs dS): 64 keys x RT rows
      mbar_wait(full + stage, phase);
      const uint32_t qa = ring + stage * L::kStageBytes;  // the stage's Q
      wgmma_fence();
      fence_regs(s);
      if constexpr (NK > 0) fence_regs(dp);
#pragma unroll
      for (int kk = 0; kk < HK / 16; ++kk)
        if (kk < nks_q)
          wgmma_ss<RT>(s, sw128_desc(ka, 16, 1024) + kstep(kk, kBlockKeys),
                       sw128_desc(qa, 16, 1024) + kstep(kk, RT), kk > 0);
      if constexpr (NK > 0) {
#pragma unroll
        for (int kk = 0; kk < VK / 16; ++kk)
          if (kk < nks_v)
            wgmma_ss<RT>(dp,
                         sw128_desc(ka + L::kKBytes, 16, 1024) +
                             kstep(kk, kBlockKeys),
                         sw128_desc(qa + L::kQBytes, 16, 1024) + kstep(kk, RT),
                         kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      if constexpr (NK > 0) fence_regs(dp);

      // --- P^T and dS^T; s[4j + e] is key g + 8 (e >> 1) of the warp,
      // tile row c = 8j + 2t + (e & 1): position p0 + c / HC, head ch HC +
      // c % HC of the group. A tile whose rows are all live and see the
      // warp's 16 keys whole skips the masks
      // the rows' m, 1 / l and D: column c at st[c], st[kSS + o1 + c] and
      // st[2 kSS + o2 + c]
      const int a0 = (first + pb * PT * G + ch * HC) & 3;
      const float* st = st_stage(stage) + a0;
      const int o1 = ((a0 + pl1) & 3) - a0, o2 = ((a0 + 2 * pl1) & 3) - a0;
      const int p_end = min(p0 + PT - 1, p_hi);
      const bool whole =
          box_rows == RT && p0 + PT - 1 <= p_hi && ch * HC + HC <= G &&
          kw0 + 15 < Sk && (!a.causal || kw0 + 15 <= p0) &&
          (a.window == 0 || p_end - kw0 < a.window);
#pragma unroll
      for (int j = 0; j < RT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1), x = 4 * j + e;
          int state = 0;
          if (!whole) {
            const int rp = a.hmul ? static_cast<int>(__umulhi(c, a.hmul)) : c;
            const int pos = p0 + rp, hh = ch * HC + c - rp * HC;
            state = c < box_rows && pos <= p_hi && hh < G
                        ? key_state(a, pos, kw0 + g + 8 * (e >> 1))
                        : 2;
          }
          const float p = state == 2 ? 0.f
                                     : exp2_sfu(score2(state, s[x], sc) -
                                                st[c]) *
                                           st[kSS + o1 + c];
          s[x] = p;
          if constexpr (NK > 0)
            dp[x] = state == 0 ? p * (dp[x] - st[2 * kSS + o2 + c]) : 0.f;
        }
      // as bf16 hi + lo A fragments: the accumulator's 16 row columns of a
      // k16 step are the fragment as they stand
      uint32_t ph[RT / 16][4], pl[RT / 16][4], dh[RT / 16][4], dl[RT / 16][4];
#pragma unroll
      for (int kk = 0; kk < RT / 16; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int x = 8 * kk + 2 * f;
          if constexpr (NV > 0) split_bf16(s[x], s[x + 1], ph[kk][f], pl[kk][f]);
          if constexpr (NK > 0) split_bf16(dp[x], dp[x + 1], dh[kk][f], dl[kk][f]);
        }
      // --- dV += P^T.dO, dK += dS^T.Q, lo pass then hi a k16 step, in place
      wgmma_fence();
      if constexpr (NV > 0) {
        fence_regs(av);
        fence_regs(ph);
        fence_regs(pl);
        const uint64_t dot = sw128_desc(qa + L::kQBytes, RT * kPanelRow, 1024);
#pragma unroll
        for (int kk = 0; kk < RT / 16; ++kk) {
          wgmma_rs<NV>(av, pl[kk], dot + kk * kRowStep);
          wgmma_rs<NV>(av, ph[kk], dot + kk * kRowStep);
        }
      }
      if constexpr (NK > 0) {
        fence_regs(ak);
        fence_regs(dh);
        fence_regs(dl);
        const uint64_t qt = sw128_desc(qa, RT * kPanelRow, 1024);
#pragma unroll
        for (int kk = 0; kk < RT / 16; ++kk) {
          wgmma_rs<NK>(ak, dl[kk], qt + kk * kRowStep);
          wgmma_rs<NK>(ak, dh[kk], qt + kk * kRowStep);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      if constexpr (NV > 0) {
        fence_regs(av);
        fence_regs(ph);
        fence_regs(pl);
      }
      if constexpr (NK > 0) {
        fence_regs(ak);
        fence_regs(dh);
        fence_regs(dl);
      }
      if (lane == 0) mbar_arrive(empty + stage);  // this warp is done with it
      if (++stage == NS) {
        stage = 0;
        phase ^= 1u;
      }
    }

    // --- the cluster's partials to rank 0, one warpgroup a round, added
    // in rank order: [value][128 threads] fp32 over the block's tiles
    if (cs > 1) {
      bar_sync(2, 256);  // every consumer is done with K, V and the ring
      float* part = reinterpret_cast<float*>(smem);
      const int tw = threadIdx.x & 127;
      for (int w = 0; w < 2; ++w) {
        if (rank != 0 && wg == w) {
#pragma unroll
          for (int x = 0; x < NK / 2; ++x) part[x * 128 + tw] = ak[x];
#pragma unroll
          for (int x = 0; x < NV / 2; ++x) part[(NK / 2 + x) * 128 + tw] = av[x];
        }
        cluster_sync();
        if (rank == 0 && wg == w)
          for (int r = 1; r < cs; ++r) {
            const float* from = cluster.map_shared_rank(part, r);
#pragma unroll
            for (int x = 0; x < NK / 2; ++x) ak[x] += from[x * 128 + tw];
#pragma unroll
            for (int x = 0; x < NV / 2; ++x)
              av[x] += from[(NK / 2 + x) * 128 + tw];
          }
        cluster_sync();  // a block's shared memory outlives the reads of it
      }
    }
    if (rank != 0) return;
    // dk, dv, rounded to bf16 once; the rows of [B, Sk, KV] from the block
    // index again
    const int bk = (blockIdx.x / cs) % bkv_n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = kw0 + g + 8 * h;
      if (key >= Sk) continue;
      const size_t row = static_cast<size_t>(bk / a.KV) * Sk * a.KV +
                         static_cast<size_t>(key) * a.KV + bk % a.KV;
#pragma unroll
      for (int j = 0; j < NK / 8; ++j)
        store2(a.dk + row * a.hd, 8 * j + 2 * t, a.hd, a.out_vec,
               ak[4 * j + 2 * h] * a.scale, ak[4 * j + 2 * h + 1] * a.scale);
#pragma unroll
      for (int j = 0; j < NV / 8; ++j)
        store2(a.dv + row * a.vd, 8 * j + 2 * t, a.vd, a.out_vec,
               av[4 * j + 2 * h], av[4 * j + 2 * h + 1]);
    }
  };
  if constexpr (SPLIT == 1)
    consume(Width<HK>{}, Width<VK>{});
  else if (wg == 0)
    consume(Width<HK>{}, Width<0>{});
  else
    consume(Width<0>{}, Width<VK>{});
}

// the rows launch, then the keys launch, of one instantiation: KT keys a
// rows-launch tile in NSR stages; RT rows a keys-launch tile in NSK stages
template <int HK, int VK, int KT, int NSR, int RT, int NSK, int SPLIT>
cudaError_t launch_bf16(BwdBf16 a, cudaStream_t stream) {
  using LR = RowsLayout<HK, VK, KT, NSR>;
  using LK = KeysLayout<HK, VK, RT, NSK, SPLIT>;
  // the widths must fit the instantiation's panels and k16 steps
  if (a.hd > HK || a.vd > VK) return cudaErrorInvalidValue;
  auto* rows = flash_bwd_rows_bf16<HK, VK, KT, NSR>;
  auto* keys = flash_bwd_keys_bf16<HK, VK, RT, NSK, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      rows, cudaFuncAttributeMaxDynamicSharedMemorySize, LR::kBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      keys, cudaFuncAttributeMaxDynamicSharedMemorySize, LK::kBytes);
  if (err != cudaSuccess) return err;
  a.BQ = kBRows / a.G;
  a.HC = a.G < RT ? a.G : RT;
  a.PT = a.G <= RT ? RT / a.G : 1;
  a.NC = (a.G + a.HC - 1) / a.HC;
  a.hmul = a.HC == 1 ? 0u : 0xffffffffu / a.HC + 1u;
  const long long plane = static_cast<long long>(a.B) * a.Sq * a.H;
  CUtensorMap rq, rdo, rk, rv, kq, kdo, kk, kv, kst;
  for (CUtensorMap* m : {&rq, &rdo, &rk, &rv, &kq, &kdo, &kk, &kv, &kst})
    memset(m, 0, sizeof(CUtensorMap));
  if (a.tma) {
    if (tensor_map_encoder() == nullptr) return cudaErrorNotSupported;
    if (3 * plane > 0x7fffffffLL) return cudaErrorInvalidValue;  // the stats
    if (!encode_bf16_4d(&rq, a.q, a.hd, a.H, a.Sq, a.B, a.G, a.BQ) ||
        !encode_bf16_4d(&rdo, a.dout, a.vd, a.H, a.Sq, a.B, a.G, a.BQ) ||
        !encode_bf16_4d(&rk, a.k, a.hd, a.KV, a.Sk, a.B, 1, KT) ||
        !encode_bf16_4d(&rv, a.v, a.vd, a.KV, a.Sk, a.B, 1, KT) ||
        !encode_bf16_4d(&kq, a.q, a.hd, a.H, a.Sq, a.B, a.HC, a.PT) ||
        !encode_bf16_4d(&kdo, a.dout, a.vd, a.H, a.Sq, a.B, a.HC, a.PT) ||
        !encode_bf16_4d(&kk, a.k, a.hd, a.KV, a.Sk, a.B, 1, LK::kKeys) ||
        !encode_bf16_4d(&kv, a.v, a.vd, a.KV, a.Sk, a.B, 1, LK::kKeys) ||
        !encode_f32_1d(&kst, a.stats, 3 * plane, RT + 4))
      return cudaErrorInvalidValue;
  }
  const long long rows_blocks =
      static_cast<long long>(a.B) * a.KV * ((a.Sq + a.BQ - 1) / a.BQ);
  const long long keys_blocks = static_cast<long long>(a.B) * a.KV *
                                ((a.Sk + LK::kKeys - 1) / LK::kKeys);
  if (rows_blocks > 0x7fffffff || keys_blocks * kMaxCluster > 0x7fffffff)
    return cudaErrorInvalidConfiguration;
  flash_bwd_rows_bf16<HK, VK, KT, NSR>
      <<<static_cast<unsigned>(rows_blocks), kBThreads, LR::kBytes, stream>>>(
          rq, rdo, rk, rv, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // each keys block's rows split over a cluster of cs blocks, as many as
  // it takes for the blocks to fill the card's slots: a causal walk's
  // blocks average half the longest one (the first keys see every row),
  // so with fewer blocks than twice the slots the launch is one ragged
  // wave as long as its longest block (GQA: G heads' rows a walk)
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, keys,
                                                      kBThreads, LK::kBytes);
  if (err != cudaSuccess) return err;
  const long long slots = (a.causal ? 2LL : 1LL) * sms * per_sm;
  const int cs = static_cast<int>(
      std::max(1LL, std::min<long long>(kMaxCluster, slots / keys_blocks)));
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(keys_blocks * cs));
  cfg.blockDim = dim3(kBThreads);
  cfg.dynamicSmemBytes = LK::kBytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, keys, kq, kdo, kk, kv, kst, a);
}

// the instantiation whose panels cover hd and vd: <= 64, <= 128, MLA's
// 192 / 128, <= 256 (dK and dV on a warpgroup each)
cudaError_t dispatch_bf16(const BwdBf16& a, cudaStream_t stream) {
  if (a.hd <= 64) return launch_bf16<64, 64, 64, 3, 64, 4, 1>(a, stream);
  if (a.hd <= 128) return launch_bf16<128, 128, 64, 3, 32, 4, 1>(a, stream);
  if (a.hd <= 192 && a.vd <= 128)
    return launch_bf16<192, 128, 64, 3, 16, 4, 1>(a, stream);
  return launch_bf16<256, 256, 32, 2, 32, 3, 2>(a, stream);
}

// the widest copy every fp32 row of q, k, v and dout stays aligned to (16,
// 8 or 4 bytes); 0 for none
int row_copy_bytes(const void* q, const void* k, const void* v,
                   const void* dout, int hd, int vd) {
  int vec = copy_bytes(q, sizeof(float) * hd);
  const int vecs[3] = {copy_bytes(k, sizeof(float) * hd),
                       copy_bytes(v, sizeof(float) * vd),
                       copy_bytes(dout, sizeof(float) * vd)};
  for (int x : vecs) vec = x < vec ? x : vec;
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
  if (bf16) {
    BwdBf16 a = {};
    a.q = static_cast<const __nv_bfloat16*>(q);
    a.k = static_cast<const __nv_bfloat16*>(k);
    a.v = static_cast<const __nv_bfloat16*>(v);
    a.dout = static_cast<const __nv_bfloat16*>(dout);
    a.dq = static_cast<__nv_bfloat16*>(dq);
    a.dk = static_cast<__nv_bfloat16*>(dk);
    a.dv = static_cast<__nv_bfloat16*>(dv);
    a.stats = stats;
    a.B = B;
    a.Sq = Sq;
    a.Sk = Sk;
    a.H = H;
    a.KV = KV;
    a.G = H / KV;
    a.hd = hd;
    a.vd = vd;
    a.causal = causal;
    a.window = window;
    a.scale = scale;
    // TMA where every row and base pointer is 16-byte aligned (every model
    // shape), else element loads into the same swizzled tiles
    a.tma = copy_bytes(q, 2 * hd) == 16 && copy_bytes(k, 2 * hd) == 16 &&
            copy_bytes(v, 2 * vd) == 16 && copy_bytes(dout, 2 * vd) == 16;
    a.out_vec = copy_bytes(dq, 2 * hd) >= 4 && copy_bytes(dk, 2 * hd) >= 4 &&
                copy_bytes(dv, 2 * vd) >= 4;
    const uintptr_t any =
        reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
        reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
        reinterpret_cast<uintptr_t>(dv);
    if (any % 2 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
    return static_cast<int>(dispatch_bf16(a, stream));
  }
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
  sh.vec = row_copy_bytes(q, k, v, dout, hd, vd);
  if (sh.vec == 0) return static_cast<int>(cudaErrorMisalignedAddress);
  return static_cast<int>(
      dispatch<float>(sh, stream, q, k, v, dout, dq, dk, dv, stats));
}
