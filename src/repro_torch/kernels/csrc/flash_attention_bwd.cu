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
// Two launches from this source, in order on one stream, no atomics; fp32
// and bf16 keep the same algorithm, each in kernels of its own:
//  (1) rows: the rows' softmax stats and dQ. A block serves (batch row, KV
//      head, tile of query positions): its rows are the G heads x positions
//      of the group, position-major. Key tiles stream through a ring twice.
//      Pass 1 computes S = Q.K^T and dP = dO.V^T for each row's max m,
//      denominator l (online softmax, log2 units) and l D = sum exp2(s - m)
//      dP, rescaled as l is. Pass 2 computes S and dP again (the same
//      instructions on the same data: bitwise the same), P = exp2(s - m) /
//      l, dS = P (dP - D) and dQ += dS.K. m, 1 / l and D go to the [3, B,
//      Sq, H]-sized scratch, laid out [3][B][KV][Sq][G] so that a tile's
//      (position, head) rows are consecutive floats, for (2).
//  (2) keys: dK and dV. A block serves (batch row, KV head, block of keys):
//      the (position, head) rows that can see those keys stream through a
//      ring in row tiles, with their m, 1 / l and D. With the keys as the M
//      rows it computes S^T = K.Q^T and dP^T = V.dO^T, then P^T and dS^T,
//      and dV += P^T.dO, dK += dS^T.Q; each key is written by one block.
//  Both launches issue the longest row or key range first.
//
// D comes from the kernel's own products. Since sum_j dS[i,j] must be 0, an
// error e in D[i] reaches dQ[i] as e * sum_j P[i,j] k_j, which is large
// where the keys share a large common part (Qwen1.5's k bias). D = sum P dP
// from the same 3xTF32 S and dP that form dS cancels to fp32 rounding; D =
// dO . O with the forward's O (its own S, another sum order) misses 2e-5 x
// max |dQ| (tests/test_torch_flash_bwd_numerics.py).
//
// fp32 (flash_bwd_rows_f32, flash_bwd_keys_f32): warpgroup MMAs on the
// TF32 tensor cores in 3xTF32, fed by TMA from a producer warp.
//  * What bounds it on this card: operations. Autograd of the forward needs
//    S and dP (2 hd + 2 vd flops a visible (query, key) pair and head) and
//    dQ, dK, dV (4 hd + 2 vd): 85.9 GFLOP at both training calls of
//    chip_smoke.py (Qwen1.5-0.5B: B 4, S 2048, H = KV = 16, hd 64, causal;
//    Mixtral: B 1, S 2048, H 32, KV 8, hd 128), 0.521 ms as the 3xTF32
//    floor at the 495 TFLOP/s of the TF32 tensor cores. The kernels
//    execute 5 hd + 4 vd a pair and head (S and dP in both passes, dQ; S^T,
//    dP^T, dK, dV), 6 hd + 4 vd at hd > 64 (S^T on both warpgroups of the
//    split keys launch), three TF32 passes each.
//  * 3xTF32: every operand x is split hi = tf32(x) (nearest), lo = tf32(x -
//    hi) (tensor_core.cuh's rounding); a product is lo.hi + hi.lo + hi.hi,
//    three wgmma a k8 step, small terms first (one TF32 pass misses fp32
//    tolerance). hi and lo are written out as TF32 values, so what wgmma
//    does with an operand's low 13 bits does not matter.
//  * TF32 wgmma takes B only K-major from shared memory (no transpose bit).
//    S, dP, S^T and dP^T have both operands K-major as the tiles land.
//    The accumulations swap sides so that the streamed tile is A, read
//    transposed from shared memory into registers (any order will do), and
//    the fresh P or dS is B: dQ^T = K^T.dS^T, dV^T = dO^T.P, dK^T =
//    Q^T.dS, with P and dS written by their warpgroup as a [64][keys or
//    rows] hi + lo B tile from the S accumulator (no transposed copy of any
//    streamed tile, no permutation: both sides in natural order).
//  * A block is 3 warpgroups of 128 threads: warpgroups 0 and 1 consume;
//    in warpgroup 2, warp 8 issues every TMA copy (4-D tensor maps over the
//    [B, S, heads, width] tensors in boxes of 32 floats = one 128-byte
//    swizzled panel row). Each tile that lands is split, hi in place and lo
//    beside it: in the rows launch (stages of its own, hd <= 192) by the
//    warpgroup that takes it, its 128 threads; elsewhere by warps 9-11,
//    which then arrive on its ready barrier (full -> split -> ready ->
//    consumed -> empty). setmaxnreg moves registers from the producer (40)
//    to the consumers (232).
//  * Rows launch: 64 rows a block (both warpgroups the same rows); key tile
//    i goes to warpgroup i mod 2, which keeps its own online stats; the two
//    merge (warpgroup 0's first, the same operations in both) between the
//    passes, and warpgroup 0 adds 1's dQ^T at the end. Each warpgroup has a
//    ready barrier of its own on each stage, so its parity waits see every
//    phase however the stages alternate.
//  * Keys launch: 64 keys a block. At hd <= 64 the warpgroups take
//    alternate row tiles whole (each holds dK and dV); above, both take
//    every tile's S^T, warpgroup 0 dP^T, dS^T and dK, warpgroup 1 P^T and
//    dV (each holds one gradient); hd > 192 walks the rows twice, half the
//    columns a pass. A keys block's walk splits over a cluster of up to 4
//    blocks when the blocks would not fill the card's slots twice over, as
//    in bf16 (not at the recorded calls: 256 and 2048 blocks).
//  * At hd <= 64 the block's own rows (Q and dO, K and V) are split once
//    into shared memory and are the A operands of S, dP, S^T and dP^T
//    there (wgmma from shared memory, one commit a tile); above, they stay
//    raw and each k step's A fragments are loaded and split in registers,
//    two fragment buffers alternating (a step's written while the previous
//    step's group runs). Every k step count is a constant: a runtime bound
//    made ptxas wait for every wgmma (columns past hd are zeros).
//  * The tensor cores truncate as they accumulate. S and dP are short sums
//    (hd / 8 steps). dQ, dK and dV sum each tile from zero and add it to
//    the running sum in fp32, which rounds to nearest: one accumulator
//    through a key block's walk of 8192 rows drifts past 2e-5 x max
//    (tests/test_torch_flash_bwd_numerics.py).
//  * Rows TMA cannot describe (not 16-byte aligned: hd 37 / vd 21) are
//    loaded by the splitters element by element into the same swizzled
//    tiles; the panels past the live width and the rows no box fills are
//    zeroed once.
//  * Instantiations (rows <HK, VK, KT, stages, SA>, keys <HK, VK, RT,
//    stages, column passes, interleave, SA>) and shared memory: hd <= 64:
//    <64, 64, 32, 4, 1> 224 KB, <64, 64, 32, 2, 1, 1, 1> 194 KB; <= 128:
//    <128, 128, 32, 2, 0> 224 KB, <128, 128, 32, 2, 1, 0, 0> 226 KB; MLA's
//    192 / 128: <192, 128, 16, 2, 0>, <192, 128, 16, 2, 1, 0, 0>; <= 256:
//    <256, 256, 16, 1, 0>, <256, 256, 16, 1, 2, 0, 0>. ptxas (sm_90a): no
//    stack and no spills at hd <= 64; at 128 the rows kernel spills 92
//    bytes and the keys kernel 188 (the consumers use their 232 registers:
//    dQ^T or dK^T 64 floats a thread, a tile's partial 32, S and dP 16
//    each, fragments); more at 192 and 256 (coverage shapes only).
//  * Measured and what is left: PERF.md, section 6, and
//    tools/flash_bwd_check.py.
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

constexpr int kMaxHd = 256;
constexpr int kMaxG = 64;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// 0: visible; 1: masked (NEG_INF, no gradient); 2: past Sk (no part).
// Sh: BwdF32 or BwdBf16
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
template <int kT, typename Sh>
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

// ---- fp32: wgmma on the TF32 tensor cores in 3xTF32, fed by TMA from a
// producer warp, its warpgroup's other three warps splitting each tile

struct BwdF32 {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  float* dq;
  float* dk;
  float* dv;
  float* stats;
  int B, Sq, Sk, H, KV, G, hd, vd, causal, window;
  float scale;
  int BQ;          // rows launch: positions a block, 64 / G
  int HC, PT, NC;  // keys launch: a row tile is HC heads x PT positions; NC
                   // tiles a position (G > the tile's rows)
  unsigned hmul;   // r / HC as a multiply-high by ceil(2^32 / HC); 0: HC 1
  int tma;  // 1: tiles by TMA; 0: element loads (rows not 16-byte aligned)
};

constexpr int kFRows = 64;       // rows launch: rows a block (both warpgroups)
constexpr int kFKeys = 64;       // keys launch: keys a block (both warpgroups)
constexpr int kSplitters = 96;   // producer threads that split tiles (warps 1-3)

// byte offset of element (row, col) of a tile of `rows` rows laid out as
// 128-byte-swizzled panels of 32 fp32 columns (TMA's SWIZZLE_128B; K-major
// as a wgmma operand, the columns its contraction)
__device__ __forceinline__ int f32_at(int rows, int row, int col) {
  return (col >> 5) * rows * kPanelRow + row * kPanelRow +
         ((((col & 31) >> 2) ^ (row & 7)) << 4) + (col & 3) * 4;
}

// p as the compiler must take it anew: a tile loop recomputes the
// addresses and descriptors it derives from p at each step instead of
// holding every k step's in registers across the loop
template <typename T>
__device__ __forceinline__ T opaque(T p) {
  asm volatile("" : "+l"(p));
  return p;
}

// hi = tf32(x) (nearest), lo = tf32(x - hi): 3xTF32's split
__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32(x[i]);
    lo[i] = tf32(x[i] - __uint_as_float(hi[i]));
  }
}

// acc = A.B over KS k8 steps in 3xTF32, from zero: each step A.lo B.hi,
// A.hi B.lo (kBLo: the other way round), then A.hi B.hi, small terms first,
// as one commit group; A's fragments from frag(kk, hi, lo) in registers,
// B's hi and lo K-major tiles of N rows at descriptors bh and bl (128-byte
// panels `rows` rows apart). Two fragment buffers alternate: step kk's are
// written while step kk - 1's group runs, and reused once its group is
// done. The step count is a constant: with one that ptxas cannot see,
// it waits for every wgmma as it issues it (columns past a call's width
// are zeros)
template <int N, int KS, bool kBLo = false, typename Frag>
__device__ __forceinline__ void mma3(float (&acc)[N / 2], Frag&& frag,
                                     uint64_t bh, uint64_t bl, int rows) {
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) ah[x][e] = al[x][e] = 0u;
  fence_regs(acc);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int x = kk & 1;
    frag(kk, ah[x], al[x]);
    const uint64_t o = kstep(kk, rows);
    wgmma_fence();
    if constexpr (kBLo) {
      wgmma_tf32<N>(acc, ah[x], bl + o, kk > 0);
      wgmma_tf32<N>(acc, al[x], bh + o, 1);
    } else {
      wgmma_tf32<N>(acc, al[x], bh + o, kk > 0);
      wgmma_tf32<N>(acc, ah[x], bl + o, 1);
    }
    wgmma_tf32<N>(acc, ah[x], bh + o, 1);
    wgmma_commit();
    wgmma_wait<1>();  // step kk - 1 is done: its buffer is free
    fence_regs(ah[x ^ 1]);
    fence_regs(al[x ^ 1]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(ah);
  fence_regs(al);
}

// acc = A.B over KS k8 steps in 3xTF32 with both operands split in shared
// memory, issued from zero with no commit or wait (the caller's): A hi and
// lo at descriptors ah and al (K-major tiles of 64 rows), B's at bh and bl
// (N rows, 128-byte panels `rows` rows apart); small terms as in mma3
template <int N, int KS, bool kBLo = false>
__device__ __forceinline__ void mma3ss(float (&acc)[N / 2], uint64_t ah,
                                       uint64_t al, uint64_t bh, uint64_t bl,
                                       int rows) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t oa = kstep(kk, 64), ob = kstep(kk, rows);
    if constexpr (kBLo) {
      wgmma_tf32_ss<N>(acc, ah + oa, bl + ob, kk > 0);
      wgmma_tf32_ss<N>(acc, al + oa, bh + ob, 1);
    } else {
      wgmma_tf32_ss<N>(acc, al + oa, bh + ob, kk > 0);
      wgmma_tf32_ss<N>(acc, ah + oa, bl + ob, 1);
    }
    wgmma_tf32_ss<N>(acc, ah + oa, bh + ob, 1);
  }
}

// A fragments of k8 step kk from a raw fp32 tile of `rows` rows: rows row0
// and row0 + 8 (row0 & 7 = g), columns 8 kk + t and + 4, split hi / lo
__device__ __forceinline__ void raw_frag(const unsigned char* tile, int rows,
                                         int row0, int t, int kk,
                                         uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const unsigned char* p =
      tile + (kk >> 2) * rows * kPanelRow + row0 * kPanelRow + 4 * t;
  const int g = row0 & 7, c = 2 * (kk & 3);
  float x[4];
  x[0] = *reinterpret_cast<const float*>(p + ((c ^ g) << 4));
  x[1] = *reinterpret_cast<const float*>(p + 8 * kPanelRow + ((c ^ g) << 4));
  x[2] = *reinterpret_cast<const float*>(p + (((c + 1) ^ g) << 4));
  x[3] = *reinterpret_cast<const float*>(p + 8 * kPanelRow +
                                         (((c + 1) ^ g) << 4));
  split4(x, hi, lo);
}

// A fragments of k8 step kk of the transpose of a split tile of `rows`
// rows (hi at h, lo lo_off bytes on): A[m][k] = tile[k][m] at m = m0 (+ 8),
// k = 8 kk + t (+ 4); the tile's columns are A's M, its rows A's K
__device__ __forceinline__ void tr_frag(const unsigned char* h, int lo_off,
                                        int rows, int m0, int t, int kk,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int k = 8 * kk + t;
  const int o[4] = {f32_at(rows, k, m0), f32_at(rows, k, m0 + 8),
                    f32_at(rows, k + 4, m0), f32_at(rows, k + 4, m0 + 8)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = *reinterpret_cast<const uint32_t*>(h + o[i]);
    lo[i] = *reinterpret_cast<const uint32_t*>(h + lo_off + o[i]);
  }
}

// two adjacent values (row n, columns k and k + 1, k even) of a B tile of
// 64 rows, split: hi at h, lo lo_off bytes on
__device__ __forceinline__ void put2(unsigned char* h, int lo_off, int n,
                                     int k, float x0, float x1) {
  const int o = f32_at(64, n, k);
  const uint32_t h0 = tf32(x0), h1 = tf32(x1);
  *reinterpret_cast<uint2*>(h + o) = make_uint2(h0, h1);
  *reinterpret_cast<uint2*>(h + lo_off + o) =
      make_uint2(tf32(x0 - __uint_as_float(h0)),
                 tf32(x1 - __uint_as_float(h1)));
}

// the 4 values at columns col .. col + 3 of row src(r) of a tensor w wide
// (zeros past w, and for a null row)
template <typename Src>
__device__ __forceinline__ void fetch4(Src& src, int r, int col, int w,
                                       float (&x)[4]) {
  const float* s = src(r);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = s != nullptr && col + i < w ? s[col + i] : 0.f;
}

// thread ct's part (of nthr) of a tile of `rows` rows in np live panels at
// h: each 16-byte chunk split, hi in place and lo lo_off bytes on. tma 0:
// a chunk's values come from row src(r) of the tensor (element loads)
// instead of what TMA left there
template <typename Src>
__device__ __forceinline__ void split_tile(unsigned char* h, int lo_off,
                                           int rows, int np, int ct, int tma,
                                           int w, Src src,
                                           int nthr = kSplitters) {
  for (int c = ct; c < np * rows * 8; c += nthr) {
    const int p = c / (rows * 8), rem = c - p * rows * 8;
    const int r = rem >> 3, lc = rem & 7;
    const int o = p * rows * kPanelRow + r * kPanelRow + ((lc ^ (r & 7)) << 4);
    float x[4];
    if (tma) {
      const float4 f = *reinterpret_cast<const float4*>(h + o);
      x[0] = f.x;
      x[1] = f.y;
      x[2] = f.z;
      x[3] = f.w;
    } else {
      fetch4(src, r, 32 * p + 4 * lc, w, x);
    }
    uint32_t hi[4], lo[4];
    split4(x, hi, lo);
    *reinterpret_cast<uint4*>(h + o) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(h + lo_off + o) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// the same for a raw tile the consumers split themselves (element loads of
// the block's own rows, where TMA cannot describe them)
template <typename Src>
__device__ __forceinline__ void stage_raw(unsigned char* h, int rows, int np,
                                          int ct, int w, Src src) {
  for (int c = ct; c < np * rows * 8; c += kSplitters) {
    const int p = c / (rows * 8), rem = c - p * rows * 8;
    const int r = rem >> 3, lc = rem & 7;
    float x[4];
    fetch4(src, r, 32 * p + 4 * lc, w, x);
    *reinterpret_cast<float4*>(h + p * rows * kPanelRow + r * kPanelRow +
                               ((lc ^ (r & 7)) << 4)) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
}

// zero `n` 16-byte chunks at p (a block's threads)
__device__ __forceinline__ void zero_chunks(unsigned char* p, int n) {
  for (int i = threadIdx.x; i < n; i += kBThreads)
    *reinterpret_cast<uint4*>(p + 16 * i) = make_uint4(0u, 0u, 0u, 0u);
}

// shared memory of flash_bwd_rows_f32<HK, VK, KT, NS, SA, CS> (bytes): Q and dO
// raw (HK / 32 and VK / 32 panels of 64 rows; SA: each split, hi then lo,
// the A operands of S and dP in shared memory), NS stages of K and V split hi
// and lo (panels of KT rows: K hi, K lo, V hi, V lo), each consumer
// warpgroup's dS split hi and lo (panels of 64 rows, KP = max(KT, 32) keys
// wide), the mbarriers, and 1024 bytes to align the start
template <int HK, int VK, int KT, int NS, int SA, int CS>
struct RowsF32 {
  static_assert(!CS || NS % 2 == 0, "a warpgroup's own stages");
  // a warpgroup's tiles reach a stage every kUse-th tile, so its waits on
  // the stage's own ready barrier see each phase
  static constexpr int kUse = NS % 2 == 0 ? NS : 2 * NS;
  static constexpr int kKP = KT < 32 ? 32 : KT;
  static constexpr int kQBytes = HK / 32 * kFRows * kPanelRow;  // raw, hi, lo
  static constexpr int kDoBytes = VK / 32 * kFRows * kPanelRow;
  static constexpr int kKBytes = HK / 32 * KT * kPanelRow;  // hi or lo
  static constexpr int kVBytes = VK / 32 * KT * kPanelRow;
  static constexpr int kStageBytes = 2 * (kKBytes + kVBytes);
  static constexpr int kRingOffset = (SA ? 2 : 1) * (kQBytes + kDoBytes);
  static constexpr int kDsBytes = kKP / 32 * kFRows * kPanelRow;  // hi or lo
  static constexpr int kDsOffset = kRingOffset + NS * kStageBytes;
  static constexpr int kBarOffset = kDsOffset + 4 * kDsBytes;
  static constexpr int kBytes = kBarOffset + 8 * (2 + 4 * NS) + 1024;
  static_assert(kBytes <= 232448, "rows launch: the block's shared memory");
  static_assert(NS * kStageBytes >= HK / 2 * 128 * 4,
                "warpgroup 1's dQ^T fits in the ring");
};

// (1) rows, fp32: the stats and dQ. One block per (batch row, KV head, tile
// of BQ = 64 / G positions): 64 rows, row r = position q0 + r / G, head kvh
// G + r % G (idle past G BQ or Sq). Warpgroups 0 and 1 consume the same 64
// rows, key tile i going to warpgroup i % 2, and merge their softmax stats
// between the passes and their dQ at the end; warpgroup 2 produces: warp 8
// issues TMA copies (Q and dO once, then the key tiles [t_lo, t_hi] of KT
// keys twice, pass 1 and pass 2, through an NS-stage ring), warps 9-11
// split each K and V tile into tf32 hi and lo in place. CS 1: the tile's
// own warpgroup splits it as it lands (its 128 threads, which would wait
// for it anyway, instead of the producer's three warps splitting every
// tile of both warpgroups in turn); it needs stages of its own (NS even)
template <int HK, int VK, int KT, int NS, int SA, int CS>
__global__ void __launch_bounds__(kBThreads, 1)
flash_bwd_rows_f32(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ BwdF32 a) {
  using L = RowsF32<HK, VK, KT, NS, SA, CS>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  // [HK / 32][64 rows][128 bytes] each: Q (SA: Q hi, then Q lo), dO
  unsigned char* qs = smem;
  unsigned char* dos = smem + (SA ? 2 : 1) * L::kQBytes;
  auto stage = [&](int s) {  // K hi, K lo, V hi, V lo
    return smem + L::kRingOffset + s * L::kStageBytes;
  };
  auto ds_tile = [&](int w) {  // warpgroup w's dS hi, then lo
    return smem + L::kDsOffset + w * 2 * L::kDsBytes;
  };
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* full_q = bars;              // Q and dO arrived
  uint64_t* full = bars + 1;            // [NS]: a K/V stage arrived
  uint64_t* empty = bars + 1 + NS;      // [NS]: its warpgroup is done
  uint64_t* ready = bars + 1 + 2 * NS;  // [NS][2]: split, for warpgroup w
  uint64_t* split_q = bars + 1 + 4 * NS;  // SA: Q and dO are split

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
  const int nt = t_hi - t_lo + 1;           // key tiles a pass
  const int pq = (a.hd + 31) >> 5;          // live panels of q / k
  const int pv = (a.vd + 31) >> 5;          // and of v / dout
  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(split_q, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4);
      mbar_init(ready + 2 * s, 1);
      mbar_init(ready + 2 * s + 1, 1);
    }
    mbar_init_fence();
  }
  // what no copy writes and a product reads stays zero: the Q and dO rows
  // past the G BQ a box fills, and the panels past the live ones (the
  // products run every k step of the instantiation's widths)
  const int used = G * BQ;
  if (used < kFRows) {
    for (int p = 0; p < HK / 32; ++p)
      zero_chunks(qs + p * kFRows * kPanelRow + used * kPanelRow,
                  (kFRows - used) * 8);
    for (int p = 0; p < VK / 32; ++p)
      zero_chunks(dos + p * kFRows * kPanelRow + used * kPanelRow,
                  (kFRows - used) * 8);
  }
  for (int x = 0; x < (SA ? 2 : 1); ++x) {
    zero_chunks(qs + x * L::kQBytes + pq * kFRows * kPanelRow,
                (HK / 32 - pq) * kFRows * 8);
    zero_chunks(dos + x * L::kDoBytes + pv * kFRows * kPanelRow,
                (VK / 32 - pv) * kFRows * 8);
  }
  for (int s = 0; s < NS; ++s)
    for (int x = 0; x < 2; ++x) {
      zero_chunks(stage(s) + x * L::kKBytes + pq * KT * kPanelRow,
                  (HK / 32 - pq) * KT * 8);
      zero_chunks(stage(s) + 2 * L::kKBytes + x * L::kVBytes +
                      pv * KT * kPanelRow,
                  (VK / 32 - pv) * KT * 8);
    }
  fence_async_smem();
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {
    // ---------------- producer warpgroup
    regs_dec<kProducerRegs>();
    const int pt = threadIdx.x - 2 * 128;
    auto key0 = [&](int i) { return (t_lo + (i < nt ? i : i - nt)) * KT; };
    if (pt < 32) {  // the TMA warp: one thread issues every copy
      if (!a.tma || pt != 0) return;
      mbar_expect_tx(full_q, (pq + pv) * used * kPanelRow);
      for (int p = 0; p < pq; ++p)
        tma_load_4d(qs + p * kFRows * kPanelRow, &tq, full_q, p * 32, kvh * G,
                    q0, b);
      for (int p = 0; p < pv; ++p)
        tma_load_4d(dos + p * kFRows * kPanelRow, &tdo, full_q, p * 32,
                    kvh * G, q0, b);
      for (int i = 0; i < 2 * nt; ++i) {
        const int s = i % NS;
        if (i >= NS) mbar_wait(empty + s, ((i / NS) - 1) & 1);
        mbar_expect_tx(full + s, (pq + pv) * KT * kPanelRow);
        for (int p = 0; p < pq; ++p)
          tma_load_4d(stage(s) + p * KT * kPanelRow, &tk, full + s, p * 32,
                      kvh, key0(i), b);
        for (int p = 0; p < pv; ++p)
          tma_load_4d(stage(s) + 2 * L::kKBytes + p * KT * kPanelRow, &tv,
                      full + s, p * 32, kvh, key0(i), b);
      }
      return;
    }
    // the splitters (and, where TMA cannot describe the rows, the loaders)
    const int ct = pt - 32;
    const size_t k_row = static_cast<size_t>(a.KV) * a.hd;
    const size_t v_row = static_cast<size_t>(a.KV) * a.vd;
    const float* kb = a.k + static_cast<size_t>(b) * Sk * k_row +
                      static_cast<size_t>(kvh) * a.hd;
    const float* vb = a.v + static_cast<size_t>(b) * Sk * v_row +
                      static_cast<size_t>(kvh) * a.vd;
    auto row = [&](const float* base, int w, int r) -> const float* {
      const int pr = r / G, pos = q0 + pr;
      return r < used && pos < Sq
                 ? base + ((static_cast<size_t>(b) * Sq + pos) * a.H +
                           kvh * G + r - pr * G) * w
                 : nullptr;
    };
    if constexpr (SA) {  // Q and dO split once, as the stages are
      if (a.tma) mbar_wait(full_q, 0);
      split_tile(qs, L::kQBytes, kFRows, pq, ct, a.tma, a.hd,
                 [&](int r) { return row(a.q, a.hd, r); });
      split_tile(dos, L::kDoBytes, kFRows, pv, ct, a.tma, a.vd,
                 [&](int r) { return row(a.dout, a.vd, r); });
      fence_async_smem();
      bar_sync(1, kSplitters);
      if (ct == 0) mbar_arrive(split_q);
    } else if (!a.tma) {
      stage_raw(qs, kFRows, pq, ct, a.hd,
                [&](int r) { return row(a.q, a.hd, r); });
      stage_raw(dos, kFRows, pv, ct, a.vd,
                [&](int r) { return row(a.dout, a.vd, r); });
      fence_async_smem();
      bar_sync(1, kSplitters);
      if (ct == 0) mbar_arrive(full_q);
    }
    for (int i = 0; i < (CS ? 0 : 2 * nt); ++i) {
      const int s = i % NS, k0 = key0(i);
      if (a.tma)
        mbar_wait(full + s, (i / NS) & 1);
      else if (i >= NS)
        mbar_wait(empty + s, ((i / NS) - 1) & 1);
      unsigned char* st = stage(s);
      split_tile(st, L::kKBytes, KT, pq, ct, a.tma, a.hd,
                 [&](int r) -> const float* {
                   return k0 + r < Sk ? kb + (k0 + r) * k_row : nullptr;
                 });
      split_tile(st + 2 * L::kKBytes, L::kVBytes, KT, pv, ct, a.tma, a.vd,
                 [&](int r) -> const float* {
                   return k0 + r < Sk ? vb + (k0 + r) * v_row : nullptr;
                 });
      fence_async_smem();
      bar_sync(1, kSplitters);
      if (ct == 0) mbar_arrive(ready + 2 * s + (i & 1));
    }
    return;
  }

  // ---------------- consumer warpgroups
  regs_inc<kConsumerRegs>();
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int tw = threadIdx.x & 127;
  // this lane's rows (h = 0: row g, h = 1: row g + 8 of the warp), the same
  // in both warpgroups; an idle row takes the block's last position and is
  // never stored
  const int row0 = 16 * warp + g;
  auto row_at = [&](int r, int& head, int& pos) {
    const int pr = r / G;
    head = r - pr * G;
    pos = q0 + pr;
    return r < used && pos < Sq;
  };
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int head;
    if (!row_at(row0 + 8 * h, head, pos[h])) pos[h] = q_last;
  }
  const float sc = a.scale * kLog2e;  // scores in log2 units
  unsigned char* dsh = ds_tile(wg);
  const uint64_t ds_hi = sw128_desc(smem_u32(dsh), 16, 1024);
  const uint64_t ds_lo = sw128_desc(smem_u32(dsh + L::kDsBytes), 16, 1024);

  float acc[HK / 2];  // dQ^T, M tile mt at acc[32 mt ..]
#pragma unroll
  for (int i = 0; i < HK / 2; ++i) acc[i] = 0.f;
  float part[32];  // one M tile's sum over a key tile
#pragma unroll
  for (int i = 0; i < 32; ++i) part[i] = 0.f;
  float s[KT / 2], dp[KT / 2];
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) s[i] = dp[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max, quad-uniform
  float l[2] = {0.f, 0.f};  // this lane's part of l over its tiles; then 1 / l
  float d[2] = {0.f, 0.f};  // this lane's part of l D; then D
  bool merged = false;
  // both warpgroups' (m, l, l D) of the same lane merged, warpgroup 0's
  // first (the same operations in both: the same values), then the rows'
  // 1 / l and D; warpgroup 0 stores them
  auto merge = [&]() {
    float* mine = reinterpret_cast<float*>(ds_tile(wg));
    const float* other = reinterpret_cast<const float*>(ds_tile(wg ^ 1));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mine[(3 * h) * 128 + tw] = m[h];
      mine[(3 * h + 1) * 128 + tw] = l[h];
      mine[(3 * h + 2) * 128 + tw] = d[h];
    }
    bar_sync(2, 256);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mo = other[(3 * h) * 128 + tw];
      const float lo = other[(3 * h + 1) * 128 + tw];
      const float dO = other[(3 * h + 2) * 128 + tw];
      const float m0 = wg == 0 ? m[h] : mo, m1 = wg == 0 ? mo : m[h];
      const float l0 = wg == 0 ? l[h] : lo, l1 = wg == 0 ? lo : l[h];
      const float d0 = wg == 0 ? d[h] : dO, d1 = wg == 0 ? dO : d[h];
      const float mn = fmaxf(m0, m1);
      const float c0 = exp2_sfu(m0 - mn), c1 = exp2_sfu(m1 - mn);
      m[h] = mn;
      l[h] = fmaf(l1, c1, l0 * c0);
      d[h] = fmaf(d1, c1, d0 * c0);
    }
    bar_sync(2, 256);  // both have read: the dS tiles are free again
    const size_t plane = static_cast<size_t>(a.B) * Sq * a.H;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = 1.f / quad_sum(l[h]);
      d[h] = quad_sum(d[h]) * l[h];
      int head, p;
      if (wg == 0 && row_at(row0 + 8 * h, head, p) && t == 0) {
        const size_t at =
            ((static_cast<size_t>(b) * a.KV + kvh) * Sq + p) * G + head;
        a.stats[at] = m[h];
        a.stats[plane + at] = l[h];
        a.stats[2 * plane + at] = d[h];
      }
    }
    merged = true;
  };

  mbar_wait(SA ? split_q : full_q, 0);
  for (int i = wg; i < 2 * nt; i += 2) {
    const bool pass1 = i < nt;
    if (!pass1 && !merged) merge();
    const int stg = i % NS;
    const int k0 = (t_lo + (pass1 ? i : i - nt)) * KT;
    // --- S = Q.K^T, dP = dO.V^T: the block's 64 rows x KT keys, the same
    // instructions on the same values in both passes
    unsigned char* kh = stage(stg);
    unsigned char* vh = kh + 2 * L::kKBytes;
    if constexpr (CS) {  // stage stg is this warpgroup's: no other user
      if (a.tma) mbar_wait(full + stg, (i / NS) & 1);
      const size_t k_row = static_cast<size_t>(a.KV) * a.hd;
      const size_t v_row = static_cast<size_t>(a.KV) * a.vd;
      const float* kb = a.k + static_cast<size_t>(b) * Sk * k_row +
                        static_cast<size_t>(kvh) * a.hd;
      const float* vb = a.v + static_cast<size_t>(b) * Sk * v_row +
                        static_cast<size_t>(kvh) * a.vd;
      split_tile(
          kh, L::kKBytes, KT, pq, tw, a.tma, a.hd,
          [&](int r) -> const float* {
            return k0 + r < Sk ? kb + (k0 + r) * k_row : nullptr;
          },
          128);
      split_tile(
          vh, L::kVBytes, KT, pv, tw, a.tma, a.vd,
          [&](int r) -> const float* {
            return k0 + r < Sk ? vb + (k0 + r) * v_row : nullptr;
          },
          128);
      fence_async_smem();
      bar_sync(3 + wg, 128);
    } else {
      mbar_wait(ready + 2 * stg + wg, (i / L::kUse) & 1);
    }
    const unsigned char* qt = opaque(qs);
    const unsigned char* dot = opaque(dos);
    if constexpr (SA) {
      wgmma_fence();
      fence_regs(s);
      fence_regs(dp);
      mma3ss<KT, HK / 8>(s, sw128_desc(smem_u32(qt), 16, 1024),
                         sw128_desc(smem_u32(qt + L::kQBytes), 16, 1024),
                         sw128_desc(smem_u32(kh), 16, 1024),
                         sw128_desc(smem_u32(kh + L::kKBytes), 16, 1024), KT);
      mma3ss<KT, VK / 8>(dp, sw128_desc(smem_u32(dot), 16, 1024),
                         sw128_desc(smem_u32(dot + L::kDoBytes), 16, 1024),
                         sw128_desc(smem_u32(vh), 16, 1024),
                         sw128_desc(smem_u32(vh + L::kVBytes), 16, 1024), KT);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
    } else {
      mma3<KT, HK / 8>(
          s,
          [&](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
            raw_frag(qt, kFRows, row0, t, kk, hi, lo);
          },
          sw128_desc(smem_u32(kh), 16, 1024),
          sw128_desc(smem_u32(kh + L::kKBytes), 16, 1024), KT);
      mma3<KT, VK / 8>(
          dp,
          [&](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
            raw_frag(dot, kFRows, row0, t, kk, hi, lo);
          },
          sw128_desc(smem_u32(vh), 16, 1024),
          sw128_desc(smem_u32(vh + L::kVBytes), 16, 1024), KT);
    }
    if (pass1 && lane == 0) mbar_arrive(empty + stg);  // K and V are read

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
    } else {
      // dS = P (dP - D), split, into this warpgroup's B tile [64 rows][keys]
      unsigned char* dst = opaque(dsh);
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float x[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int at = 4 * j + 2 * h + e;
            const float p = exp2_sfu(s[at] - m[h]) * l[h];
            x[e] = (vis >> at) & 1u ? p * (dp[at] - d[h]) : 0.f;
          }
          put2(dst, L::kDsBytes, row0 + 8 * h, 8 * j + 2 * t, x[0], x[1]);
        }
      fence_async_smem();
      bar_sync(3 + wg, 128);
      // --- dQ^T += K^T.dS^T, an M tile of 64 columns at a time: the tile's
      // sum from zero, then added to the running sum in fp32 (the tensor
      // cores truncate as they accumulate)
#pragma unroll
      for (int mt = 0; mt < HK / 64; ++mt) {
        mma3<64, KT / 8>(
            part,
            [&](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
              tr_frag(kh, L::kKBytes, KT, 64 * mt + 16 * warp + g, t, kk, hi,
                      lo);
            },
            opaque(ds_hi), opaque(ds_lo), kFRows);
#pragma unroll
        for (int x = 0; x < 32; ++x) acc[32 * mt + x] += part[x];
      }
      if (lane == 0) mbar_arrive(empty + stg);  // K is read
    }
  }
  if (!merged) merge();

  // warpgroup 1's dQ^T through the ring (every tile consumed: no copy is
  // in flight) to warpgroup 0, which adds it (a fixed order) and stores
  bar_sync(2, 256);
  float* xch = reinterpret_cast<float*>(stage(0));
  if (wg == 1)
#pragma unroll
    for (int x = 0; x < HK / 2; ++x) xch[x * 128 + tw] = acc[x];
  bar_sync(2, 256);
  if (wg == 1) return;
  // acc[32 mt + 4 j + e] is column 64 mt + 16 warp + g + 8 (e >> 1) of row
  // 8j + 2t + (e & 1)
#pragma unroll
  for (int mt = 0; mt < HK / 64; ++mt) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 32 * mt + 4 * j + e;
        const int col = 64 * mt + 16 * warp + g + 8 * (e >> 1);
        int head, p;
        if (col < a.hd && row_at(8 * j + 2 * t + (e & 1), head, p))
          a.dq[((static_cast<size_t>(b) * Sq + p) * a.H + kvh * G + head) *
                   a.hd +
               col] = (acc[x] + xch[x * 128 + tw]) * a.scale;
      }
  }
}

// shared memory of flash_bwd_keys_f32<HK, VK, RT, NS, CP, KI, SA> (bytes):
// the block's K and V raw (64 keys; SA: each split, hi then lo, the A
// operands of S^T and dP^T in shared memory), NS stages of a row tile split hi and lo (Q
// hi, Q lo, dO hi, dO lo: panels of RT rows), the warpgroups' B tiles split
// hi and lo (panels of 64 keys, RP = max(RT, 32) rows wide: warpgroup 0's
// dS and 1's P, or with KI each one's P and dS), the stages' row stats (m,
// 1 / l, D: RT + 4 floats each from the 16-byte boundary at or below the
// tile's first row, as TMA boxes must start), the mbarriers, and 1024
// bytes to align the start. After the walk K's and V's space holds the
// block's dK^T and dV^T for the cluster's rank 0
template <int HK, int VK, int RT, int NS, int KI, int SA>
struct KeysF32 {
  static constexpr int kRP = RT < 32 ? 32 : RT;
  static constexpr int kKBytes = HK / 32 * kFKeys * kPanelRow;
  static constexpr int kVBytes = VK / 32 * kFKeys * kPanelRow;
  static constexpr int kQBytes = HK / 32 * RT * kPanelRow;  // hi or lo
  static constexpr int kDoBytes = VK / 32 * RT * kPanelRow;
  static constexpr int kStageBytes = 2 * (kQBytes + kDoBytes);
  static constexpr int kRingOffset = (SA ? 2 : 1) * (kKBytes + kVBytes);
  static constexpr int kPBytes = kRP / 32 * kFKeys * kPanelRow;  // hi or lo
  static constexpr int kPOffset = kRingOffset + NS * kStageBytes;
  static constexpr int kStatStride = ((RT + 4) * 4 + 127) / 128 * 128;
  static constexpr int kStatOffset = kPOffset + (KI ? 8 : 4) * kPBytes;
  static constexpr int kBarOffset = kStatOffset + NS * 3 * kStatStride;
  static constexpr int kBytes = kBarOffset + 8 * (2 + 4 * NS) + 1024;
  // KI: a warpgroup's tiles reach a stage every kUse-th tile
  static constexpr int kUse = NS % 2 == 0 ? NS : 2 * NS;
  static_assert(kBytes <= 232448, "keys launch: the block's shared memory");
  static_assert(!KI || NS * kStageBytes >= (HK + VK) / 2 * 128 * 4,
                "warpgroup 1's dK^T and dV^T fit in the ring");
};

// (2) keys, fp32: dK and dV. One block per (batch row, KV head, 64 keys),
// times a cluster of cs blocks that split its walk. The walk: the
// (position, head) rows that can see those keys, in row tiles of RT rows
// (HC heads x PT positions, one TMA box), with their m, 1 / l and D. The
// block's 64 keys are the M of S^T = K.Q^T and dP^T = V.dO^T. KI (hd <= 64,
// where a warpgroup holds dK and dV): warpgroup w takes row tiles j = w
// mod 2 whole (S^T, dP^T, P^T, dS^T, dV^T += dO^T.P, dK^T += Q^T.dS), and
// warpgroup 0 adds 1's sums at the end. Else both take every tile's S^T;
// warpgroup 0 also computes dP^T, dS^T and dK^T, warpgroup 1 P^T and dV^T.
// Warpgroup 2 produces: warp 8 issues
// TMA copies (K and V once, the row tiles through an NS-stage ring), warps
// 9-11 split each Q and dO tile into tf32 hi and lo in place. Rank r of
// the cluster walks the r-th of cs runs of the tiles; rank 0 adds the
// others' dK and dV from their shared memory, in rank order, and stores.
// CP > 1 (hd > 192, where a warpgroup's dK^T or dV^T would not fit its
// registers): the walk runs CP times, each pass for 1 / CP of the columns
// (then cs is 1)
template <int HK, int VK, int RT, int NS, int CP, int KI, int SA>
__global__ void __launch_bounds__(kBThreads, 1)
flash_bwd_keys_f32(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tst,
                   const __grid_constant__ BwdF32 a) {
  using L = KeysF32<HK, VK, RT, NS, KI, SA>;
  static_assert(!KI || CP == 1, "interleaved tiles walk once");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  // [HK / 32][64 keys][128 bytes] each: K (SA: K hi, then K lo), V
  unsigned char* ks = smem;
  unsigned char* vs = smem + (SA ? 2 : 1) * L::kKBytes;
  auto q_stage = [&](int s) {  // Q hi, Q lo, dO hi, dO lo
    return smem + L::kRingOffset + s * L::kStageBytes;
  };
  auto do_stage = [&](int s) { return q_stage(s) + 2 * L::kQBytes; };
  auto st_stage = [&](int s) {  // [m, 1 / l, D][kStatStride bytes]
    return reinterpret_cast<float*>(smem + L::kStatOffset +
                                    s * 3 * L::kStatStride);
  };
  constexpr int kSS = L::kStatStride / 4;  // floats between the stats
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* full_kv = bars;             // K and V arrived
  uint64_t* full = bars + 1;            // [NS]: a row tile arrived
  uint64_t* empty = bars + 1 + NS;      // [NS]: its warps are done
  uint64_t* ready = bars + 1 + 2 * NS;  // [NS][2]: split (KI: for
                                        // warpgroup w; else [s][0] for both)
  uint64_t* split_kv = bars + 1 + 4 * NS;  // SA: K and V are split

  const int G = a.G, HC = a.HC, PT = a.PT, NC = a.NC, Sq = a.Sq, Sk = a.Sk;
  const int box_rows = HC * PT;  // rows a tile's box fills
  const int pq = (a.hd + 31) >> 5, pv = (a.vd + 31) >> 5;  // live panels
  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    mbar_init(split_kv, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, KI ? 4 : 8);
      mbar_init(ready + 2 * s, 1);
      mbar_init(ready + 2 * s + 1, 1);
    }
    mbar_init_fence();
  }
  // what no copy writes and a product reads stays zero: the rows no box
  // fills (their P and dS are 0, and 0 x what the rows hold must be 0) and
  // the panels past the live ones (the products run every k step and M
  // tile of the instantiation's widths), in every stage, hi and lo
  for (int x = 0; x < (SA ? 2 : 1); ++x) {
    zero_chunks(ks + x * L::kKBytes + pq * kFKeys * kPanelRow,
                (HK / 32 - pq) * kFKeys * 8);
    zero_chunks(vs + x * L::kVBytes + pv * kFKeys * kPanelRow,
                (VK / 32 - pv) * kFKeys * 8);
  }
  for (int s = 0; s < NS; ++s)
    for (int x = 0; x < 2; ++x) {
      unsigned char* qx = q_stage(s) + x * L::kQBytes;
      unsigned char* dx = do_stage(s) + x * L::kDoBytes;
      if (a.tma && box_rows < RT) {
        for (int p = 0; p < pq; ++p)
          zero_chunks(qx + p * RT * kPanelRow + box_rows * kPanelRow,
                      (RT - box_rows) * 8);
        for (int p = 0; p < pv; ++p)
          zero_chunks(dx + p * RT * kPanelRow + box_rows * kPanelRow,
                      (RT - box_rows) * 8);
      }
      zero_chunks(qx + pq * RT * kPanelRow, (HK / 32 - pq) * RT * 8);
      zero_chunks(dx + pv * RT * kPanelRow, (VK / 32 - pv) * RT * 8);
    }
  fence_async_smem();
  __syncthreads();

  const cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int cs = cluster.num_blocks(), rank = cluster.block_rank();
  const int blk = blockIdx.x / cs, bkv_n = a.B * a.KV;
  const int b = (blk % bkv_n) / a.KV, kvh = blk % a.KV;
  const int k0 = (blk / bkv_n) * kFKeys;  // small k0 sees the most rows
  const int k_last = min(k0 + kFKeys, Sk) - 1;
  // the positions that can see these keys; all of them from the first
  // that sees no key at all (it is uniform over every key)
  const int p_lo = a.causal ? k0 : 0;
  int p_hi = a.window > 0 ? min(Sq - 1, k_last + a.window - 1) : Sq - 1;
  if (a.window > 0 && Sk + a.window - 1 <= Sq - 1) p_hi = Sq - 1;
  const int n_pb = p_lo <= p_hi ? (p_hi - p_lo) / PT + 1 : 0;
  const int nsteps = n_pb * NC;
  const int s_lo = rank * nsteps / cs, s_hi = (rank + 1) * nsteps / cs;
  const int n_run = s_hi - s_lo;  // tiles a pass; ring step j: tile s_lo +
                                  // j % n_run of pass j / n_run
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
    // ---------------- producer warpgroup (every thread stays for the
    // cluster's barriers)
    regs_dec<kProducerRegs>();
    const int pt = threadIdx.x - 2 * 128;
    if (pt < 32) {  // the TMA warp: one thread issues every copy
      if (a.tma && pt == 0) {
        mbar_expect_tx(full_kv, (pq + pv) * kFKeys * kPanelRow);
        for (int p = 0; p < pq; ++p)
          tma_load_4d(ks + p * kFKeys * kPanelRow, &tk, full_kv, p * 32, kvh,
                      k0, b);
        for (int p = 0; p < pv; ++p)
          tma_load_4d(vs + p * kFKeys * kPanelRow, &tv, full_kv, p * 32, kvh,
                      k0, b);
        for (int j = 0; j < CP * n_run; ++j) {
          const int i = s_lo + j % n_run, s = j % NS;
          const int pb = NC == 1 ? i : i / NC, ch = i - pb * NC;
          const int p0 = p_lo + pb * PT;
          if (j >= NS) mbar_wait(empty + s, ((j / NS) - 1) & 1);
          mbar_expect_tx(full + s,
                         (pq + pv) * box_rows * kPanelRow + 3 * (RT + 4) * 4);
          for (int p = 0; p < pq; ++p)
            tma_load_4d(q_stage(s) + p * RT * kPanelRow, &tq, full + s,
                        p * 32, kvh * G + ch * HC, p0, b);
          for (int p = 0; p < pv; ++p)
            tma_load_4d(do_stage(s) + p * RT * kPanelRow, &tdo, full + s,
                        p * 32, kvh * G + ch * HC, p0, b);
          for (int c = 0; c < 3; ++c)
            tma_load_1d(st_stage(s) + c * kSS, &tst, full + s,
                        static_cast<int>(st_at(i, c) & ~size_t(3)));
        }
      }
    } else {
      // the splitters (and, where TMA cannot describe the rows, the
      // loaders: key r of K and V, row r = (position + r / HC, head + r %
      // HC) of each tile and its stats)
      const int ct = pt - 32;
      auto key_row = [&](const float* base, int w, int r) -> const float* {
        const int key = k0 + r;
        return key < Sk ? base + ((static_cast<size_t>(b) * Sk + key) *
                                      a.KV + kvh) * w
                        : nullptr;
      };
      if constexpr (SA) {  // K and V split once, as the stages are
        if (a.tma) mbar_wait(full_kv, 0);
        split_tile(ks, L::kKBytes, kFKeys, pq, ct, a.tma, a.hd,
                   [&](int r) { return key_row(a.k, a.hd, r); });
        split_tile(vs, L::kVBytes, kFKeys, pv, ct, a.tma, a.vd,
                   [&](int r) { return key_row(a.v, a.vd, r); });
        fence_async_smem();
        bar_sync(1, kSplitters);
        if (ct == 0) mbar_arrive(split_kv);
      } else if (!a.tma) {
        stage_raw(ks, kFKeys, pq, ct, a.hd,
                  [&](int r) { return key_row(a.k, a.hd, r); });
        stage_raw(vs, kFKeys, pv, ct, a.vd,
                  [&](int r) { return key_row(a.v, a.vd, r); });
        fence_async_smem();
        bar_sync(1, kSplitters);
        if (ct == 0) mbar_arrive(full_kv);
      }
      for (int j = 0; j < CP * n_run; ++j) {
        const int i = s_lo + j % n_run, s = j % NS;
        const int pb = NC == 1 ? i : i / NC, ch = i - pb * NC;
        if (a.tma)
          mbar_wait(full + s, (j / NS) & 1);
        else if (j >= NS)
          mbar_wait(empty + s, ((j / NS) - 1) & 1);
        auto row = [&](const float* base, int w, int r) -> const float* {
          const int rp = r / HC, pos = p_lo + pb * PT + rp;
          const int hh = ch * HC + r - rp * HC;
          return r < box_rows && pos < Sq && hh < G
                     ? base + ((static_cast<size_t>(b) * Sq + pos) * a.H +
                               kvh * G + hh) * w
                     : nullptr;
        };
        split_tile(q_stage(s), L::kQBytes, RT, pq, ct, a.tma, a.hd,
                   [&](int r) { return row(a.q, a.hd, r); });
        split_tile(do_stage(s), L::kDoBytes, RT, pv, ct, a.tma, a.vd,
                   [&](int r) { return row(a.dout, a.vd, r); });
        if (!a.tma) {
          float* st = st_stage(s);
          for (int x = ct; x < 3 * RT; x += kSplitters) {
            const int c = x / RT, r = x - c * RT, rp = r / HC;
            const int pos = p_lo + pb * PT + rp, hh = ch * HC + r - rp * HC;
            const bool ok = r < box_rows && pos < Sq && hh < G;
            const size_t at = st_at(i, c);
            st[c * kSS + (at & 3) + r] =
                ok ? a.stats[at + r + rp * (G - HC)] : 0.f;
          }
        }
        fence_async_smem();
        bar_sync(1, kSplitters);
        if (ct == 0) mbar_arrive(ready + 2 * s + (KI ? j & 1 : 0));
      }
    }
    if (cs > 1)  // the consumers' round of partials
      for (int r = 0; r < 2; ++r) cluster_sync();
    return;
  }

  // ---------------- consumer warpgroups
  regs_inc<kConsumerRegs>();
  const int wg = threadIdx.x >> 7;
  // NK, NV: the widths of dK and dV this warpgroup accumulates (0: none),
  // NK / CP and NV / CP of their columns a pass
  auto consume = [&](auto nk, auto nv) {
    constexpr int NK = decltype(nk)::value, NV = decltype(nv)::value;
    constexpr int PK = NK / CP, PV = NV / CP;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3, tw = threadIdx.x & 127;
    const int kw0 = k0 + 16 * warp;  // this warp's keys kw0 .. + 15
    const float sc = a.scale * kLog2e;
    // this warpgroup's B tiles, [64 keys][rows] split hi / lo: P (for dV)
    // and dS (for dK)
    unsigned char* p_tile =
        smem + L::kPOffset + (KI ? 4 * wg : 2 * wg) * L::kPBytes;
    unsigned char* ds_tile = KI ? p_tile + 2 * L::kPBytes : p_tile;
    // where plane c's stats of tile i start in their box: (st_at(i, c) & 3)
    // = (first + i's rows + c plane) & 3, from two small ints
    const int first = static_cast<int>(st_at(0, 0) & 3);
    const int pl1 = static_cast<int>(plane & 3);

    float ak[NK > 0 ? PK / 2 : 1], av[NV > 0 ? PV / 2 : 1];  // dK^T, dV^T
    float part[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) part[x] = 0.f;
    float s[RT / 2], dp[NK > 0 ? RT / 2 : 1];
#pragma unroll
    for (int x = 0; x < RT / 2; ++x) s[x] = 0.f;
#pragma unroll
    for (int x = 0; x < (NK > 0 ? RT / 2 : 1); ++x) dp[x] = 0.f;
    // sum += src^T.B over a pass's M tiles of 64 columns, each the tile's
    // sum from zero, then added to the running sum in fp32 (the tensor
    // cores truncate as they accumulate); src: the stage's Q or dO (hi,
    // lo lo_off bytes on), B: the tile at bt
    auto accumulate = [&](auto width, float* sum, const unsigned char* src,
                          int lo_off, const unsigned char* bt, int cp) {
      constexpr int PW = decltype(width)::value;
#pragma unroll
      for (int mt = 0; mt < PW / 64; ++mt) {
        const int col0 = 64 * (cp * (PW / 64) + mt) + 16 * warp + g;
        mma3<64, RT / 8>(
            part,
            [&](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
              tr_frag(src, lo_off, RT, col0, t, kk, hi, lo);
            },
            opaque(sw128_desc(smem_u32(bt), 16, 1024)),
            opaque(sw128_desc(smem_u32(bt + L::kPBytes), 16, 1024)), kFKeys);
#pragma unroll
        for (int x = 0; x < 32; ++x) sum[32 * mt + x] += part[x];
      }
    };

    mbar_wait(SA ? split_kv : full_kv, 0);
    for (int cp = 0; cp < CP; ++cp) {
#pragma unroll
      for (int x = 0; x < (NK > 0 ? PK / 2 : 1); ++x) ak[x] = 0.f;
#pragma unroll
      for (int x = 0; x < (NV > 0 ? PV / 2 : 1); ++x) av[x] = 0.f;
      for (int i = s_lo + (KI ? wg : 0); i < s_hi; i += KI ? 2 : 1) {
        const int j = cp * n_run + i - s_lo, stg = j % NS;
        const int pb = NC == 1 ? i : i / NC, ch = i - pb * NC;
        const int p0 = p_lo + pb * PT;
        if (KI)
          mbar_wait(ready + 2 * stg + wg, (j / L::kUse) & 1);
        else
          mbar_wait(ready + 2 * stg, (j / NS) & 1);
        unsigned char* qh = q_stage(stg);
        unsigned char* doh = do_stage(stg);
        const unsigned char* kt = opaque(ks);
        const unsigned char* vt = opaque(vs);
        // --- S^T = K.Q^T (and dP^T = V.dO^T): 64 keys x RT rows, the small
        // terms in S's (and dP's) order: S's transpose, value for value
        auto k_frag = [&](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
          raw_frag(kt, kFKeys, 16 * warp + g, t, kk, hi, lo);
        };
        const uint64_t qd_hi = sw128_desc(smem_u32(qh), 16, 1024);
        const uint64_t qd_lo =
            sw128_desc(smem_u32(qh + L::kQBytes), 16, 1024);
        if constexpr (SA) {
          wgmma_fence();
          fence_regs(s);
          if constexpr (NK > 0) fence_regs(dp);
          mma3ss<RT, HK / 8, true>(
              s, sw128_desc(smem_u32(kt), 16, 1024),
              sw128_desc(smem_u32(kt + L::kKBytes), 16, 1024), qd_hi, qd_lo,
              RT);
          if constexpr (NK > 0)
            mma3ss<RT, VK / 8, true>(
                dp, sw128_desc(smem_u32(vt), 16, 1024),
                sw128_desc(smem_u32(vt + L::kVBytes), 16, 1024),
                sw128_desc(smem_u32(doh), 16, 1024),
                sw128_desc(smem_u32(doh + L::kDoBytes), 16, 1024), RT);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(s);
          if constexpr (NK > 0) fence_regs(dp);
        } else {
          mma3<RT, HK / 8, true>(s, k_frag, qd_hi, qd_lo, RT);
          if constexpr (NK > 0)
            mma3<RT, VK / 8, true>(
                dp,
                [&](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
                  raw_frag(vt, kFKeys, 16 * warp + g, t, kk, hi, lo);
                },
                sw128_desc(smem_u32(doh), 16, 1024),
                sw128_desc(smem_u32(doh + L::kDoBytes), 16, 1024), RT);
        }

        // --- P^T and dS^T; s[4j + e] is key g + 8 (e >> 1) of the warp,
        // tile row c = 8j + 2t + (e & 1): position p0 + c / HC, head ch HC
        // + c % HC of the group. A tile whose rows are all live and see the
        // warp's 16 keys whole skips the masks. The rows' m, 1 / l and D:
        // column c at st[c], st[kSS + o1 + c] and st[2 kSS + o2 + c]
        const int a0 = (first + pb * PT * G + ch * HC) & 3;
        const float* st = st_stage(stg) + a0;
        const int o1 = ((a0 + pl1) & 3) - a0, o2 = ((a0 + 2 * pl1) & 3) - a0;
        const int p_end = min(p0 + PT - 1, p_hi);
        const bool whole =
            box_rows == RT && p0 + PT - 1 <= p_hi && ch * HC + HC <= G &&
            kw0 + 15 < Sk && (!a.causal || kw0 + 15 <= p0) &&
            (a.window == 0 || p_end - kw0 < a.window);
        unsigned char* pt_ = opaque(p_tile);
        unsigned char* dt_ = opaque(ds_tile);
#pragma unroll
        for (int jj = 0; jj < RT / 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float yp[2], yd[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * jj + 2 * t + e, x = 4 * jj + 2 * h + e;
              int state = 0;
              if (!whole) {
                const int rp =
                    a.hmul ? static_cast<int>(__umulhi(c, a.hmul)) : c;
                const int pos = p0 + rp, hh = ch * HC + c - rp * HC;
                state = c < box_rows && pos <= p_hi && hh < G
                            ? key_state(a, pos, kw0 + g + 8 * h)
                            : 2;
              }
              const float p =
                  state == 2 ? 0.f
                             : exp2_sfu(score2(state, s[x], sc) - st[c]) *
                                   st[kSS + o1 + c];
              yp[e] = p;
              if constexpr (NK > 0)
                yd[e] = state == 0 ? p * (dp[x] - st[2 * kSS + o2 + c]) : 0.f;
            }
            const int n = 16 * warp + g + 8 * h, k = 8 * jj + 2 * t;
            if constexpr (NV > 0) put2(pt_, L::kPBytes, n, k, yp[0], yp[1]);
            if constexpr (NK > 0) put2(dt_, L::kPBytes, n, k, yd[0], yd[1]);
          }
        fence_async_smem();
        bar_sync(3 + wg, 128);
        // --- dV^T += dO^T.P and dK^T += Q^T.dS
        if constexpr (NV > 0)
          accumulate(Width<PV>{}, av, doh, L::kDoBytes, pt_, cp);
        if constexpr (NK > 0)
          accumulate(Width<PK>{}, ak, qh, L::kQBytes, dt_, cp);
        if (lane == 0) mbar_arrive(empty + stg);  // this warp is done with it
      }

      if constexpr (KI) {
        // warpgroup 1's sums through the ring (every tile consumed: no copy
        // is in flight) to warpgroup 0, which adds them (a fixed order)
        bar_sync(2, 256);
        float* xch = reinterpret_cast<float*>(q_stage(0));
        if (wg == 1) {
#pragma unroll
          for (int x = 0; x < PK / 2; ++x) xch[x * 128 + tw] = ak[x];
#pragma unroll
          for (int x = 0; x < PV / 2; ++x)
            xch[(PK / 2 + x) * 128 + tw] = av[x];
        }
        bar_sync(2, 256);
        if (wg == 0) {
#pragma unroll
          for (int x = 0; x < PK / 2; ++x) ak[x] += xch[x * 128 + tw];
#pragma unroll
          for (int x = 0; x < PV / 2; ++x)
            av[x] += xch[(PK / 2 + x) * 128 + tw];
        }
      }
      // --- the cluster's partials to rank 0, added in rank order:
      // [value][128 threads] fp32 over the block's tiles, dK^T in K's space,
      // dV^T in V's (cs > 1 only where CP is 1)
      const bool holds = !KI || wg == 0;  // this warpgroup stores
      if (cs > 1) {
        bar_sync(2, 256);  // every consumer is done with K and V
        float* kbuf = reinterpret_cast<float*>(ks);
        float* vbuf = reinterpret_cast<float*>(vs);
        if (rank != 0 && holds) {
#pragma unroll
          for (int x = 0; x < (NK > 0 ? PK / 2 : 0); ++x)
            kbuf[x * 128 + tw] = ak[x];
#pragma unroll
          for (int x = 0; x < (NV > 0 ? PV / 2 : 0); ++x)
            vbuf[x * 128 + tw] = av[x];
        }
        cluster_sync();
        if (rank == 0 && holds)
          for (int r = 1; r < cs; ++r) {
            const float* fk = cluster.map_shared_rank(kbuf, r);
            const float* fv = cluster.map_shared_rank(vbuf, r);
#pragma unroll
            for (int x = 0; x < (NK > 0 ? PK / 2 : 0); ++x)
              ak[x] += fk[x * 128 + tw];
#pragma unroll
            for (int x = 0; x < (NV > 0 ? PV / 2 : 0); ++x)
              av[x] += fv[x * 128 + tw];
          }
        cluster_sync();  // a block's shared memory outlives the reads of it
      }
      if (rank != 0 || !holds) return;
      // dk and dv: a sum's [32 mt + 4 jj + e] is column 64 (the pass's
      // first M tile + mt) + 16 warp + g + 8 (e >> 1) of key k0 + 8 jj + 2t
      // + (e & 1); the rows of [B, Sk, KV] from the block index again
      const int bk = (blockIdx.x / cs) % bkv_n;
      auto store = [&](auto width, const float* sum, float* out, int w,
                       float mul) {
        constexpr int PW = decltype(width)::value;
#pragma unroll
        for (int mt = 0; mt < PW / 64; ++mt)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 64 * (cp * (PW / 64) + mt) + 16 * warp + g +
                              8 * (e >> 1);
              const int key = k0 + 8 * jj + 2 * t + (e & 1);
              if (col < w && key < Sk)
                out[(static_cast<size_t>(bk / a.KV) * Sk * a.KV +
                     static_cast<size_t>(key) * a.KV + bk % a.KV) * w + col] =
                    sum[32 * mt + 4 * jj + e] * mul;
            }
      };
      if constexpr (NK > 0) store(Width<PK>{}, ak, a.dk, a.hd, a.scale);
      if constexpr (NV > 0) store(Width<PV>{}, av, a.dv, a.vd, 1.f);
    }  // the pass
  };
  if constexpr (KI)
    consume(Width<HK>{}, Width<VK>{});
  else if (wg == 0)
    consume(Width<HK>{}, Width<0>{});
  else
    consume(Width<0>{}, Width<VK>{});
}

// the rows launch, then the keys launch, of one instantiation: KT keys a
// rows-launch tile in NSR stages; RT rows a keys-launch tile in NSK stages,
// walked in CPK column passes, its warpgroups on alternate tiles (KI 1) or
// on dK and dV (0); SA 1: the block's own rows (Q and dO, K and V) split
// in shared memory as the A operands of S, dP, S^T and dP^T; CS 1: the
// rows launch's warpgroups split their own key tiles
template <int HK, int VK, int KT, int NSR, int RT, int NSK, int CPK, int KI,
          int SA, int CS>
cudaError_t launch_f32(BwdF32 a, cudaStream_t stream) {
  using LR = RowsF32<HK, VK, KT, NSR, SA, CS>;
  using LK = KeysF32<HK, VK, RT, NSK, KI, SA>;
  static_assert(CPK == 1 || (HK % (64 * CPK) == 0 && VK % (64 * CPK) == 0),
                "whole M tiles a column pass");
  // the widths must fit the instantiation's panels and k8 steps
  if (a.hd > HK || a.vd > VK) return cudaErrorInvalidValue;
  auto* rows = flash_bwd_rows_f32<HK, VK, KT, NSR, SA, CS>;
  auto* keys = flash_bwd_keys_f32<HK, VK, RT, NSK, CPK, KI, SA>;
  cudaError_t err = cudaFuncSetAttribute(
      rows, cudaFuncAttributeMaxDynamicSharedMemorySize, LR::kBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      keys, cudaFuncAttributeMaxDynamicSharedMemorySize, LK::kBytes);
  if (err != cudaSuccess) return err;
  a.BQ = kFRows / a.G;
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
    if (!encode_f32_4d(&rq, a.q, a.hd, a.H, a.Sq, a.B, a.G, a.BQ) ||
        !encode_f32_4d(&rdo, a.dout, a.vd, a.H, a.Sq, a.B, a.G, a.BQ) ||
        !encode_f32_4d(&rk, a.k, a.hd, a.KV, a.Sk, a.B, 1, KT) ||
        !encode_f32_4d(&rv, a.v, a.vd, a.KV, a.Sk, a.B, 1, KT) ||
        !encode_f32_4d(&kq, a.q, a.hd, a.H, a.Sq, a.B, a.HC, a.PT) ||
        !encode_f32_4d(&kdo, a.dout, a.vd, a.H, a.Sq, a.B, a.HC, a.PT) ||
        !encode_f32_4d(&kk, a.k, a.hd, a.KV, a.Sk, a.B, 1, kFKeys) ||
        !encode_f32_4d(&kv, a.v, a.vd, a.KV, a.Sk, a.B, 1, kFKeys) ||
        !encode_f32_1d(&kst, a.stats, 3 * plane, RT + 4))
      return cudaErrorInvalidValue;
  }
  const long long rows_blocks =
      static_cast<long long>(a.B) * a.KV * ((a.Sq + a.BQ - 1) / a.BQ);
  const long long keys_blocks = static_cast<long long>(a.B) * a.KV *
                                ((a.Sk + kFKeys - 1) / kFKeys);
  if (rows_blocks > 0x7fffffff || keys_blocks * kMaxCluster > 0x7fffffff)
    return cudaErrorInvalidConfiguration;
  rows<<<static_cast<unsigned>(rows_blocks), kBThreads, LR::kBytes, stream>>>(
      rq, rdo, rk, rv, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // each keys block's rows split over a cluster of cs blocks, as many as
  // it takes for the blocks to fill the card's slots twice over (as the
  // bf16 keys launch)
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, keys,
                                                      kBThreads, LK::kBytes);
  if (err != cudaSuccess) return err;
  const long long slots = (a.causal ? 2LL : 1LL) * sms * per_sm;
  const int cs = CPK > 1 ? 1 : static_cast<int>(std::max(
      1LL, std::min<long long>(kMaxCluster, slots / keys_blocks)));
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
// 192 / 128, <= 256 (the keys launch in two column passes)
cudaError_t dispatch_f32(const BwdF32& a, cudaStream_t stream) {
  if (a.hd <= 64)
    return launch_f32<64, 64, 32, 4, 32, 2, 1, 1, 1, 1>(a, stream);
  if (a.hd <= 128)
    return launch_f32<128, 128, 32, 2, 32, 2, 1, 0, 0, 1>(a, stream);
  if (a.hd <= 192 && a.vd <= 128)
    return launch_f32<192, 128, 16, 2, 16, 2, 1, 0, 0, 1>(a, stream);
  return launch_f32<256, 256, 16, 1, 16, 1, 2, 0, 0, 0>(a, stream);
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
  BwdF32 a = {};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
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
  a.tma = copy_bytes(q, 4 * hd) == 16 && copy_bytes(k, 4 * hd) == 16 &&
          copy_bytes(v, 4 * vd) == 16 && copy_bytes(dout, 4 * vd) == 16;
  const uintptr_t any =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
      reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
      reinterpret_cast<uintptr_t>(dv);
  if (any % 4 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  return static_cast<int>(dispatch_f32(a, stream));
}
