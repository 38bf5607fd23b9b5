// Full-sequence (prefill) attention with an fp32 online softmax on the
// tensor cores of Hopper (sm_90a), plain C interface. Three kernels behind
// one entry: fp32 inputs run flash_attention_kernel (3xTF32 mma.sync);
// bf16 inputs run flash_fwd_bf16 (wgmma fed by TMA); fp32 calls of a few
// query rows a KV head (the engines' one-query decode calls), which the
// launcher sends there with a split length, run flash_fwd_one_query (key
// splits over the card, fp32 FMAs), below.
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
// ---- fp32: flash_attention_kernel<float, VT>
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
//    half-warp) to 8 mod 32 words; V rows (rows 2t and 2t+1 x 8 columns)
//    to 16 mod 32 bytes. The columns past hd (or vd) up to the next
//    multiple of 8 are zeroed once, so a ragged hd takes a partial last
//    k-step.
//  * The block walks only the key tiles its rows can see: tiles wholly
//    above the causal diagonal or wholly outside the window are skipped.
//    If some row of the block sees no key at all (only when Sq > Sk with
//    a window), the block walks every tile, and the row ends up uniform
//    over all keys, as in the reference. A row whose first visited tiles
//    are all masked accumulates exp(0) terms against m = -1e30; the first
//    real score rescales them by exp(-1e30 - m) = 0 exactly.
//  * Occupancy: 16-key tiles keep shared memory at 69 KB at hd = vd = 128
//    (Q 64 x 136, two stages of K 16 x 136 and V 16 x 132 floats), and
//    __launch_bounds__(128, 3) caps registers, so three blocks (12 warps)
//    share an SM; 135 KB and one block at hd = vd = 256. The value width
//    is a template bound (<= 64/128/256) so the O accumulator (vd / 8
//    fragments of 4 floats a lane) stays in registers. ptxas (-Xptxas -v,
//    sm_90a; chip_smoke.py prints it): 122/151/216 registers for vd <=
//    64/128/256; no spills, no stack; the shared memory is all dynamic.
//
// What wgmma + TMA would add here: wgmma's TF32 B operand must be K-major
// in shared memory, which V (key-major for P.V) is not, so V would be
// transposed in shared memory on arrival, and the hi/lo splits made once a
// tile in shared memory instead of once a fragment in every warp.
//
// ---- bf16: flash_fwd_bf16<HK, VN, KT, NS>
//
// What bounds it: operations, at the 989 TFLOP/s of the bf16 tensor cores.
// Qwen2.5-3B's training call (B 2, S 2048, H 16 / KV 2, hd 128, causal) is
// 34.4 GFLOP of least work, 0.0348 ms; its 58.7 MB take 0.018 ms. The
// design executes S in one pass and P.V in two (P as bf16 hi + lo: one
// rounded pass of P spends a quarter to a third of the 2^-8 budget
// against float64 before the output's own rounding,
// tests/test_torch_flash_fwd_bf16_numerics.py), 2 (hd + 2 vd) flops a
// visible pair and head, 1.5x the least work at hd = vd: 51.6 GFLOP,
// 0.052 ms. What is left above that is the softmax between the two
// products of a tile, which this design does not overlap with them inside
// a warpgroup (the two consumer warpgroups of a block overlap each other).
//
// What the design does about it:
//  * One block of 3 warpgroups per (batch row, KV head, tile of 128 / G
//    query positions), 128 rows, row r = position q0 + r / G, head
//    kvh G + r % G: position-major, so one TMA box {64 columns, G heads,
//    128 / G positions} fills a panel of Q. Warpgroups 0 and 1 consume, 64
//    rows each; warpgroup 2 produces. setmaxnreg moves registers from the
//    producer (40) to the consumers (232). Blocks are issued longest causal
//    range first (a 1-D grid of B KV blocks a position tile, the
//    last tile first: no 65535 cap on the tiles).
//  * Both products are wgmma.mma_async bf16 -> fp32 (m64nNk16):
//    S = Q.K^T with A (Q) and B (the K tile) in shared memory, both
//    K-major; O += P.V with A (P) from registers and B (the V tile) in
//    shared memory in its natural key-major order (MN-major, the
//    descriptor's transpose bit): no transposed copy. The S accumulator's
//    16 key columns of a k16 step are the A fragment as they stand (the
//    m16n8k16 fragment layout a warp), so P never touches shared memory.
//  * Tiles live in shared memory as 128-byte-swizzled panels of 64
//    columns (hd 128: 2 panels, 192: 3, 256: 4), the layout TMA's
//    SWIZZLE_128B writes and the wgmma descriptors read: 8-row groups 1024
//    bytes apart, k16 steps 32 bytes apart within a panel, V's panels a
//    tile apart.
//  * Copies: the producer's one thread issues cp.async.bulk.tensor (TMA)
//    on 4-D tensor maps over the [B, S, heads, width] tensors, encoded on
//    the host each call (cuTensorMapEncodeTiled through
//    cudaGetDriverEntryPointByVersion: no -lcuda), passed as __grid_constant__
//    CUtensorMaps. Q once; K and V tiles of KT keys into an NS-stage ring
//    with full (TMA bytes) and empty (8 consumer warps) mbarriers. Keys past
//    Sk and positions past Sq are TMA's zero fill; panels past the width
//    are not copied (their columns are never stored). Rows TMA cannot
//    describe (not 16-byte aligned: bf16 hd 37 / vd 21) are copied by the
//    producer's 128 threads, one row a thread, element loads into the same
//    swizzled panels with zeros to the panel's end, then
//    fence.proxy.async and one arrival. No copy loop divides.
//  * The online softmax stays in registers: the wgmma accumulator gives a
//    lane rows 16 warp + lane / 4 and + 8 at columns 8j + 2 (lane % 4) +
//    {0, 1}, the mma.sync quad layout, so the row max is two
//    xor-shuffles, scores are in log2 units, exp2 is ex2.approx, tiles
//    every row of a warp sees whole skip the masks, and O is rescaled in
//    registers. Rows that see no key come out uniform, as in fp32.
//  * P = 2^(s - m) goes in as bf16 hi + lo, lo pass then hi a 16-key
//    step, both accumulated into O in fp32 (its slices' truncating adds
//    cost ~2^-23 each, far below the output's rounding); O / l is rounded
//    to bf16 once. No atomics: bitwise repeatable.
//  * Instantiations by width bound (HK q/k, VN v; KT keys a tile, NS
//    stages): <64, 64, 128, 3> (hd <= 64), <128, 128, 64, 3> (hd <= 128),
//    <192, 128, 64, 3> (hd <= 192 and vd <= 128: MLA), <256, 256, 64, 2>
//    (the rest); shared memory 112, 128, 168 and 192 KB.
//    A consumer thread holds O (VN / 2 floats), S (KT / 2) and P hi + lo
//    (KT / 2 words). Waiting for P.V before the next tile's S keeps the
//    three model instantiations within 232 registers: issuing S behind
//    P.V spilled at hd 128 and 192 and was slower.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; tools/flash_fwd_check.py,
// CUDA events): Qwen2.5-3B's call 0.155 ms (the TF32 design on
// widened tiles: 0.817), 333 TFLOP/s of executed passes, 4.5x its bound
// at 989; Mixtral's shape in bf16 0.156; DeepSeek-V2's MLA call (B 1, H
// 128, hd 192 / vd 128) 0.672 (from 3.283), 358 TFLOP/s; Qwen1.5-0.5B's
// (B 4, H 16, hd 64) 0.252, 205 TFLOP/s: at hd 64 a tile's softmax costs
// what it does at 128 for half the MMA work. SDPA's bf16 forward takes
// 0.086, 0.328 and 0.117 there. P in one pass instead of hi + lo, in
// turns: 7-12% less time. ptxas: 168 registers at launch (setmaxnreg
// then 40 / 232), no stack and no spills at any instantiation; SASS:
// HGMMA only, no HMMA (chip_smoke.py checks both).
//
// ---- one query: flash_fwd_one_query<EPT> (fp32),
//      flash_fwd_one_query_bf16<EPT> (bf16)
//
// What bounds it: bytes, and the latency of fetching them. At R = Sq G
// query rows a KV head, each K/V row is read once and used for R rows:
// 2 R flops (fp32 FMAs) an element of K or V, ~1 flop a byte in bf16 and
// half that in fp32 at R = 1, below every ridge. The engines' cross calls
// are R = 1: Llama-3.2-Vision's (B 2, 1601 keys, 32 heads of 128) moves
// 104.9 MB in fp32, 0.031 ms at 3.35 TB/s, and 52.5 MB in bf16, 0.0157 ms,
// for 52 MFLOP (< 1 us at 67 TFLOP/s); Whisper-tiny's (1500 keys, 6 heads
// of 64) 9.2 MB in fp32 and 4.6 MB in bf16, which sit in L2 between
// decode steps. The tile kernels (fp32 above, bf16 flash_fwd_bf16) give
// such a call B KV blocks (12 and 64 on 132 SMs), each walking every key
// tile one round trip after another with 1 of its 64 or 128 rows live:
// fp32 0.29 and 0.54 ms, bf16 0.037 and (B 8, 2 heads) 0.045 ms,
// latency, not bytes.
//
// What the design does about it (both types; bf16 differs only in the
// element it moves):
//  * Blocks over (batch row, KV head, key split): block (b, kvh, s) takes
//    keys [s S, s S + S) for every row of its KV head (R = Sq G rows, row
//    r = position r / G, head kvh G + r % G), so a K/V row is fetched once.
//    S (a multiple of 32 up to 256) is the launcher's, a function of the
//    shape and the type alone (flash_attention.py: one_query_plan, from the
//    split's bytes in its type), so the splits and the order of every sum
//    are the same for a row in any batch and under any cut of the heads.
//    Only splits up to the last key a row can see are launched
//    (one_query_splits), a 1-D grid of B KV n blocks.
//  * One round trip: a block issues every 16-byte cp.async of its rows'
//    queries and its split's K and V rows (4 or 8 bytes, or element loads,
//    where a row or pointer is not 16-byte aligned) before it waits on any.
//    K and V stay in their own type in shared memory (bf16: half the
//    bytes a split, 8 elements a 16-byte copy) and are widened to fp32 at
//    each FMA.
//  * Scores and P.V are plain fp32 FMAs on the CUDA cores, in fp32's own
//    accuracy (no 3xTF32 split, no bf16 rounding of P): a thread per (row,
//    key), lanes on neighbouring keys of one row, K rows padded to an odd
//    number of 16-byte units (4 floats or 8 bf16 a unit) so the 16-byte
//    loads of a quarter-warp hit distinct banks; a warp a row for the
//    softmax (scores in log2 units, exp2f); then a thread per (row, value
//    column), EPT of them a pass, keys in order.
//  * Masks follow the tile kernel: masked keys score NEG_INF, keys past
//    Sk take no part (-inf). Where the last row sees no key (Sq > Sk with
//    a window) every split is walked and that row comes out uniform over
//    every key, as in the reference.
//  * One split writes the output. More leave each row's (m, l, o) in fp32
//    scratch the launcher allocates, and the (batch row, KV head)'s last
//    block to finish (an atomic ticket, as paged_attention.cu) combines
//    them in split order: M = max m_s, L = sum l_s 2^(m_s - M), O = sum o_s
//    2^(m_s - M), out = O / max(L, 1e-30). A bf16 output is rounded once,
//    there. The combine reads every (m, l) into shared memory in one round
//    trip, takes M with a warp a row, e_s once a (split, row), and keeps 8
//    of a column's o_s loads in flight (at the engines' calls it takes
//    10-29% of the bf16 kernel's time; one reading the partials split
//    after split took 17-40% of either type's:
//    tools/flash_one_query_check.py); its 8 (n + 1) R bytes of shared
//    memory bound the keys a call (one_query_plan). No other atomics: bitwise
//    repeatable. No host sync or allocation: capturable in a CUDA graph.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"
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
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);  // nearest even
}
// elements p[0], p[1] (p 2-element aligned) as floats
__device__ __forceinline__ void load_pair(const float* p, float& x0,
                                          float& x1) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  x0 = v.x;
  x1 = v.y;
}

// shared-memory row strides (elements) for rows of w elements. Q and K:
// 8 mod 32 words; V: 16 mod 32 bytes
__host__ __device__ __forceinline__ int qk_stride(int w) {
  const int w8 = (w + 7) & ~7;
  return w8 + ((8 - w8) & 31);
}
__host__ __device__ __forceinline__ int v_stride(int w) {
  constexpr int e = 32 / static_cast<int>(sizeof(float));
  return (w + e - 1) / e * e + e / 2;
}

// dynamic shared memory: Q [kRows][sq]; K [kStages][kTile][sq];
// V [kStages][kTile][sv]
size_t smem_bytes(int hd, int vd) {
  return sizeof(float) *
         (static_cast<size_t>(kRows + kStages * kTile) * qk_stride(hd) +
          static_cast<size_t>(kStages * kTile) * v_stride(vd));
}

// Rows [0, nrows) of w elements (fp32 or bf16) into dst (stride ds); row
// r comes from src(r), or is zero where src(r) is null. vec: bytes a copy
// (16, 8, 4; every source row and pointer aligned to it), 0 for element
// loads.
template <typename T, typename Src>
__device__ __forceinline__ void copy_rows(T* dst, int ds, int nrows, int w,
                                          int vec, const T* base, Src src) {
  if (vec == 0) {
    for (int i = threadIdx.x; i < nrows * w; i += kThreads) {
      const int r = i / w, c = i - r * w;
      const T* s = src(r);
      dst[r * ds + c] = s ? s[c] : T{};
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
template <int VT>
__global__ void __launch_bounds__(kThreads, VT <= 16 ? 3 : 1)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int Sq, int Sk, int H, int KV, int G, int BQ, int hd,
                       int vd, int causal, int window, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sq = qk_stride(hd), sv = v_stride(vd);
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kRows][sq]
  float* ks = qs + kRows * sq;                     // [kStages][kTile][sq]
  float* vs = ks + kStages * kTile * sq;           // [kStages][kTile][sv]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma group, lane in the group
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int nq = min(BQ, Sq - q0);  // live positions in this tile
  const size_t q_row = static_cast<size_t>(H) * hd;  // one position
  const size_t k_row = static_cast<size_t>(KV) * hd;
  const size_t v_row = static_cast<size_t>(KV) * vd;
  const float* kb = k + static_cast<size_t>(b) * Sk * k_row +
                    static_cast<size_t>(kvh) * hd;
  const float* vb = v + static_cast<size_t>(b) * Sk * v_row +
                    static_cast<size_t>(kvh) * vd;

  // zero the columns past hd / vd that the last k8 step or n8 tile reads
  const int hd8 = (hd + 7) & ~7, vd8 = (vd + 7) & ~7;
  for (int i = tid; i < (kRows + kStages * kTile) * (hd8 - hd); i += kThreads)
    qs[(i / (hd8 - hd)) * sq + hd + i % (hd8 - hd)] = 0.f;
  for (int i = tid; i < kStages * kTile * (vd8 - vd); i += kThreads)
    vs[(i / (vd8 - vd)) * sv + vd + i % (vd8 - vd)] = 0.f;

  // row r: head kvh * G + r / BQ, position q0 + r % BQ; rows past G * BQ
  // or past Sq are idle (zero q, never stored)
  copy_rows(qs, sq, kRows, hd, vec, q, [&](int r) -> const float* {
    const int hg = r / BQ, s = r - hg * BQ;
    return hg < G && s < nq
               ? q + (static_cast<size_t>(b) * Sq + q0 + s) * q_row +
                     static_cast<size_t>(kvh * G + hg) * hd
               : nullptr;
  });
  auto load_tile = [&](int tile, int stage) {
    const int k0 = tile * kTile;
    copy_rows(ks + stage * kTile * sq, sq, kTile, hd, vec, k,
              [&](int j) -> const float* {
                return k0 + j < Sk ? kb + static_cast<size_t>(k0 + j) * k_row
                                   : nullptr;
              });
    copy_rows(vs + stage * kTile * sv, sv, kTile, vd, vec, v,
              [&](int j) -> const float* {
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
  const float* qw = qs + warp * 16 * sq + 2 * t;
  const float sc = scale * kLog2e;  // scores in log2 units, for exp2f

  for (int tile = tile_lo; tile <= tile_hi; ++tile) {
    const int stage = (tile - tile_lo) & 1;
    if (tile < tile_hi) load_tile(tile + 1, stage ^ 1);
    cp_commit();  // (empty on the last tile: keeps wait_group 1 uniform)
    cp_wait<1>();
    __syncthreads();
    const float* kt = ks + stage * kTile * sq + g * sq + 2 * t;
    const float* vt = vs + stage * kTile * sv;

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
      for (int i = 0; i < 4; ++i) frag<true>(x[i], ah[i], al[i]);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        float y0, y1;
        load_pair(kt + j * 8 * sq + kk * 8, y0, y1);
        uint32_t bh[2], bl[2];
        frag<true>(y0, bh[0], bl[0]);
        frag<true>(y1, bh[1], bl[1]);
        mma3<true, true>(s[j], ah, al, bh, bl);
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
      const float* v0 = vt + (j * 8 + 2 * t) * sv + g;
#pragma unroll
      for (int n = 0; n < VT; ++n) {
        if (n < nvt) {
          uint32_t bh[2], bl[2];
          frag<true>(to_f(v0[n * 8]), bh[0], bl[0]);
          frag<true>(to_f(v0[sv + n * 8]), bh[1], bl[1]);
          mma3<true, true>(o[n], ah, al, bh, bl);
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
    float* O = out + (static_cast<size_t>(b) * Sq + q0 + s) * H * vd +
               static_cast<size_t>(kvh * G + hg) * vd;
#pragma unroll
    for (int n = 0; n < VT; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < vd) store(O + col, o[n][2 * h] / lg);
      if (col + 1 < vd) store(O + col + 1, o[n][2 * h + 1] / lg);
    }
  }
}

template <int VT>
cudaError_t launch(dim3 grid, cudaStream_t stream, const void* q,
                   const void* k, const void* v, void* out, int Sq, int Sk,
                   int H, int KV, int G, int BQ, int hd, int vd, int causal,
                   int window, float scale, int vec) {
  const size_t smem = smem_bytes(hd, vd);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<VT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_attention_kernel<VT><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, H, KV,
      G, BQ, hd, vd, causal, window, scale, vec);
  return cudaGetLastError();
}

cudaError_t dispatch(dim3 grid, cudaStream_t stream, const void* q,
                     const void* k, const void* v, void* out, int Sq, int Sk,
                     int H, int KV, int G, int BQ, int hd, int vd, int causal,
                     int window, float scale) {
  int vec = copy_bytes(q, sizeof(float) * hd);
  const int vec_k = copy_bytes(k, sizeof(float) * hd);
  const int vec_v = copy_bytes(v, sizeof(float) * vd);
  if (vec_k < vec) vec = vec_k;
  if (vec_v < vec) vec = vec_v;
  if (vd <= 64)
    return launch<8>(grid, stream, q, k, v, out, Sq, Sk, H, KV, G, BQ, hd,
                     vd, causal, window, scale, vec);
  if (vd <= 128)
    return launch<16>(grid, stream, q, k, v, out, Sq, Sk, H, KV, G, BQ, hd,
                      vd, causal, window, scale, vec);
  return launch<32>(grid, stream, q, k, v, out, Sq, Sk, H, KV, G, BQ, hd, vd,
                    causal, window, scale, vec);
}

// ---- bf16: flash_fwd_bf16, wgmma on the bf16 tensor cores fed by TMA

constexpr int kBRows = 128;        // rows a block: 2 consumer warpgroups x 64
constexpr int kBThreads = 384;     // 2 consumer warpgroups + 1 producer

struct FwdBf16 {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  int Sq, Sk, H, KV, G, BQ, hd, vd, causal, window;
  float scale;
  int tma;      // 1: tiles by TMA; 0: element loads (rows not 16-byte aligned)
  int out_vec;  // 1: output pairs as 4-byte stores
};

// shared memory of flash_fwd_bf16<HK, VN, KT, NS> (bytes): Q (HK / 64
// panels of 128 rows), NS stages of K (HK / 64 panels of KT rows) and V (VN
// / 64 panels of KT rows), the mbarriers, and 1024 bytes to align the
// start to the swizzle atom
template <int HK, int VN, int KT, int NS>
struct FwdLayout {
  static constexpr int kQBytes = HK / kPanel * kBRows * kPanelRow;
  static constexpr int kKBytes = HK / kPanel * KT * kPanelRow;
  static constexpr int kVBytes = VN / kPanel * KT * kPanelRow;
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr int kBarOffset = kQBytes + NS * kStageBytes;
  static constexpr int kBytes = kBarOffset + 8 * (1 + 2 * NS) + 1024;
};

// One block per (batch row, KV head, tile of BQ = 128 / G positions): 128
// rows, row r = position q0 + r / G, head kvh G + r % G (idle past G BQ or
// Sq). Warpgroups 0 and 1 consume (64 rows each: S = Q.K^T and O += P.V by
// wgmma, the online softmax in registers); warpgroup 2 produces (K and V
// tiles of KT keys into an NS-stage ring, by TMA or element loads). HK: q/k
// width bound (k16 steps of S: ceil(hd / 16) <= HK / 16); VN: the P.V
// product's n (vd <= VN; columns past vd computed and dropped)
template <int HK, int VN, int KT, int NS>
__global__ void __launch_bounds__(kBThreads, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const FwdBf16 a) {
  using L = FwdLayout<HK, VN, KT, NS>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;  // [HK / 64][128 rows][128 bytes]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* full_q = bars;            // Q arrived
  uint64_t* full = bars + 1;          // [NS]: a K/V stage arrived
  uint64_t* empty = bars + 1 + NS;    // [NS]: 8 consumer warps are done
  auto k_stage = [&](int s) { return smem + L::kQBytes + s * L::kStageBytes; };
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
  // a 1-D grid (no 65535 cap on the position tiles): block x is position
  // tile x / (B KV) counted from the last (longest first), then (b, kvh)
  const int n_qt = (Sq + BQ - 1) / BQ, bkv_n = gridDim.x / n_qt;
  const int tile_r = blockIdx.x / bkv_n, bkv = blockIdx.x - tile_r * bkv_n;
  const int b = bkv / a.KV, kvh = bkv - b * a.KV;
  const int q0 = (n_qt - 1 - tile_r) * BQ;
  const int nq = min(BQ, Sq - q0);
  // keys this tile of positions can see (all of them if its last row sees
  // none: that row comes out uniform, as in the reference)
  const int q_last = q0 + nq - 1;
  int lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  int hi = a.causal ? min(Sk - 1, q_last) : Sk - 1;
  const int lo_last = a.window > 0 ? max(0, q_last - a.window + 1) : 0;
  if (lo_last > hi) {
    lo = 0;
    hi = Sk - 1;
  }
  const int tile_lo = lo / KT, n_tiles = hi / KT - tile_lo + 1;
  const int pq = (a.hd + kPanel - 1) / kPanel;  // live panels of q / k
  const int pv = (a.vd + kPanel - 1) / kPanel;  // and of v

  if (threadIdx.x >= 2 * 128) {
    // ---------------- producer warpgroup
    regs_dec<kProducerRegs>();
    if (a.tma) {
      if (threadIdx.x != 2 * 128) return;
      mbar_expect_tx(full_q, pq * kPanel * G * BQ * 2);
      for (int p = 0; p < pq; ++p)
        tma_load_4d(qs + p * kBRows * kPanelRow, &tq, full_q, p * kPanel,
                    kvh * G, q0, b);
      int s = 0, use = 0;
      for (int i = 0; i < n_tiles; ++i) {
        if (use > 0) mbar_wait(empty + s, (use - 1) & 1);
        mbar_expect_tx(full + s, (pq + pv) * KT * kPanelRow);
        const int k0 = (tile_lo + i) * KT;
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
    const int t = threadIdx.x - 2 * 128;
    const bf16* src = nullptr;
    if (t < G * BQ) {
      const int pos = q0 + t / G;
      if (pos < Sq)
        src = a.q + (static_cast<size_t>(b) * Sq + pos) * a.H * a.hd +
              static_cast<size_t>(kvh * G + t % G) * a.hd;
    }
    stage_row(qs, kBRows, pq, t, src, a.hd);
    fence_async_smem();
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    if (t == 0) mbar_arrive(full_q);
    const size_t k_row = static_cast<size_t>(a.KV) * a.hd;
    const size_t v_row = static_cast<size_t>(a.KV) * a.vd;
    const bf16* kb = a.k + static_cast<size_t>(b) * Sk * k_row +
                     static_cast<size_t>(kvh) * a.hd;
    const bf16* vb = a.v + static_cast<size_t>(b) * Sk * v_row +
                     static_cast<size_t>(kvh) * a.vd;
    int s = 0, use = 0;
    for (int i = 0; i < n_tiles; ++i) {
      if (use > 0) mbar_wait(empty + s, (use - 1) & 1);
      const int key = (tile_lo + i) * KT + t;
      if (t < KT) {
        stage_row(k_stage(s), KT, pq, t, key < Sk ? kb + key * k_row : nullptr,
                  a.hd);
        stage_row(v_stage(s), KT, pv, t, key < Sk ? vb + key * v_row : nullptr,
                  a.vd);
      }
      fence_async_smem();
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
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
  // this lane's two rows (h = 0: row g, h = 1: row g + 8 of the warp);
  // an idle row takes the block's last position
  const int row0 = 64 * wg + 16 * warp + g;
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    pos[h] = row0 + 8 * h < G * BQ ? min(q0 + (row0 + 8 * h) / G, q_last)
                                   : q_last;
  const int nks = (a.hd + 15) >> 4;  // k16 steps of S
  const float sc = a.scale * kLog2e;  // scores in log2 units
  // descriptors: Q (this warpgroup's 64 rows) and K K-major, 8-row groups
  // 1024 bytes apart, k16 steps 32 bytes apart within a panel; V MN-major,
  // its 64-column panels KT rows apart, 16 keys 2048 bytes apart
  const uint64_t q_desc = sw128_desc(smem_u32(qs) + wg * 64 * kPanelRow, 16,
                                     1024);
  const uint64_t k_desc0 = sw128_desc(smem_u32(k_stage(0)), 16, 1024);
  const uint64_t v_desc0 =
      sw128_desc(smem_u32(v_stage(0)), KT * kPanelRow, 1024);
  constexpr uint64_t kStageStep = L::kStageBytes >> 4;

  float o[VN / 2];
#pragma unroll
  for (int i = 0; i < VN / 2; ++i) o[i] = 0.f;
  float s[KT / 2];
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) s[i] = 0.f;
  uint32_t ph[KT / 16][4], pl[KT / 16][4];
  float m[2] = {kNegInf, kNegInf};  // running max, quad-uniform
  float l[2] = {0.f, 0.f};          // this lane's part of the denominator

  mbar_wait(full_q, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < n_tiles; ++i) {
    // --- S = Q.K^T: this warpgroup's 64 rows x KT keys, fp32
    mbar_wait(full + stage, phase);
    const uint64_t kd = k_desc0 + stage * kStageStep;
    wgmma_fence();
    fence_regs(s);
#pragma unroll
    for (int kk = 0; kk < HK / 16; ++kk) {
      if (kk < nks) {
        const uint64_t qstep = (kk >> 2) * (kBRows * kPanelRow >> 4) +
                               (kk & 3) * 2;
        const uint64_t kstep = (kk >> 2) * (KT * kPanelRow >> 4) +
                               (kk & 3) * 2;
        wgmma_ss<KT>(s, q_desc + qstep, kd + kstep, kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // --- masks and the online softmax; s[4j + e] is row g + 8 (e >> 1),
    // key k0 + 8j + 2t + (e & 1). A tile every row of the warp sees whole
    // skips the masks
    const int k0 = (tile_lo + i) * KT, k_end = k0 + KT - 1;
    const bool whole = __all_sync(
        0xffffffffu,
        k_end < Sk && (!a.causal || k_end <= min(pos[0], pos[1])) &&
            (a.window == 0 || max(pos[0], pos[1]) - k0 < a.window));
    float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, key = k0 + j * 8 + 2 * t + (e & 1);
        float val;
        if (whole) {
          val = s[4 * j + e] * sc;
        } else if (key >= Sk) {
          val = -CUDART_INF_F;  // past Sk: no part in the softmax
        } else if ((a.causal && key > pos[h]) ||
                   (a.window > 0 && pos[h] - key >= a.window)) {
          val = kNegInf;
        } else {
          val = s[4 * j + e] * sc;
        }
        s[4 * j + e] = val;
        mt[h] = fmaxf(mt[h], val);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
      const float m_new = fmaxf(m[h], mt[h]);
      corr[h] = exp2_sfu(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
    // P = 2^(s - m) as bf16 hi + lo A fragments: the accumulator's 16 key
    // columns of a k16 step are the fragment as they stand
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        p[e] = exp2_sfu(s[8 * kk + e] - m[(e >> 1) & 1]);
        l[(e >> 1) & 1] += p[e];
      }
#pragma unroll
      for (int f = 0; f < 4; ++f)
        split_bf16(p[2 * f], p[2 * f + 1], ph[kk][f], pl[kk][f]);
    }
#pragma unroll
    for (int j = 0; j < VN / 8; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }

    // --- O += P.V, lo pass then hi a k16 step
    wgmma_fence();
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    const uint64_t vd_ = v_desc0 + stage * kStageStep;
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      wgmma_rs<VN>(o, pl[kk], vd_ + kk * (16 * kPanelRow >> 4));
      wgmma_rs<VN>(o, ph[kk], vd_ + kk * (16 * kPanelRow >> 4));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    if (lane == 0) mbar_arrive(empty + stage);  // this warp is done with it
    if (++stage == NS) {
      stage = 0;
      phase ^= 1u;
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h, pr = r / G;
    if (r >= G * BQ || q0 + pr >= Sq) continue;  // idle
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    bf16* row = a.out + (static_cast<size_t>(b) * Sq + q0 + pr) * a.H * a.vd +
                static_cast<size_t>(kvh * G + r - pr * G) * a.vd;
#pragma unroll
    for (int j = 0; j < VN / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float x0 = o[4 * j + 2 * h] * inv, x1 = o[4 * j + 2 * h + 1] * inv;
      if (col + 1 < a.vd && a.out_vec) {
        *reinterpret_cast<__nv_bfloat162*>(row + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < a.vd) row[col] = __float2bfloat16(x0);
        if (col + 1 < a.vd) row[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int HK, int VN, int KT, int NS>
cudaError_t launch_bf16(const FwdBf16& a, int B, cudaStream_t stream) {
  constexpr int smem = FwdLayout<HK, VN, KT, NS>::kBytes;
  // the widths must fit the instantiation's panels and k16 steps
  if (a.hd > HK || a.vd > VN) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_bf16<HK, VN, KT, NS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  memset(&tq, 0, sizeof(tq));
  memset(&tk, 0, sizeof(tk));
  memset(&tv, 0, sizeof(tv));
  if (a.tma) {
    if (tensor_map_encoder() == nullptr) return cudaErrorNotSupported;
    if (!encode_bf16_4d(&tq, a.q, a.hd, a.H, a.Sq, B, a.G, a.BQ) ||
        !encode_bf16_4d(&tk, a.k, a.hd, a.KV, a.Sk, B, 1, KT) ||
        !encode_bf16_4d(&tv, a.v, a.vd, a.KV, a.Sk, B, 1, KT))
      return cudaErrorInvalidValue;
  }
  const long long blocks =
      static_cast<long long>(B) * a.KV * ((a.Sq + a.BQ - 1) / a.BQ);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  flash_fwd_bf16<HK, VN, KT, NS><<<static_cast<unsigned>(blocks), kBThreads,
                                   smem, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

// q, k, v rows of hd / hd / vd bf16 elements: by TMA where every row and
// base pointer is 16-byte aligned (every model shape), else by element
// loads into the same swizzled tiles
cudaError_t dispatch_bf16(int B, cudaStream_t stream, const void* q,
                          const void* k, const void* v, void* out, int Sq,
                          int Sk, int H, int KV, int hd, int vd, int causal,
                          int window, float scale) {
  FwdBf16 a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.out = static_cast<bf16*>(out);
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.KV = KV;
  a.G = H / KV;
  a.BQ = kBRows / a.G;
  a.hd = hd;
  a.vd = vd;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  a.tma = copy_bytes(q, 2 * hd) == 16 && copy_bytes(k, 2 * hd) == 16 &&
          copy_bytes(v, 2 * vd) == 16;
  a.out_vec = copy_bytes(out, 2 * vd) >= 4;
  if (hd <= 64) return launch_bf16<64, 64, 128, 3>(a, B, stream);
  if (hd <= 128) return launch_bf16<128, 128, 64, 3>(a, B, stream);
  if (hd <= 192 && vd <= 128) return launch_bf16<192, 128, 64, 3>(a, B, stream);
  return launch_bf16<256, 256, 64, 2>(a, B, stream);
}

// ---- one query: flash_fwd_one_query<EPT>, flash_fwd_one_query_bf16<EPT>

constexpr int kQMaxRows = kMaxG;  // Sq G rows a block takes
constexpr int kQMaxSplit = 256;   // keys a split: 8 a lane in the softmax

template <typename T>
struct OneQuery {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  float* part_m;  // [B KV][n_all][R]: each split's max (log2 units)
  float* part_l;  // [B KV][n_all][R]: its denominator
  float* part_o;  // [B KV][n_all][R][vd]: its unnormalised output
  int* tickets;   // [B KV], zeros: the splits of a (row, KV head) done
  int Sq, Sk, H, KV, G, R, hd, vd, causal, window;
  int S;         // keys a split
  int n;         // splits walked: keys [0, n S) hold every key a row sees
  int n_all;     // ceil(Sk / S): the partials' stride
  float scale;   // 1 / sqrt(hd) x log2 e: scores in log2 units
  int vec;       // bytes a copy (16, 8, 4), 0: element loads
};

// elements of T in 16 bytes (4 fp32, 8 bf16), as a shift
template <typename T>
constexpr int kShift16 = sizeof(T) == 4 ? 2 : 3;

// w elements of T rounded up to 16 bytes
template <typename T>
__host__ __device__ __forceinline__ int pad16(int w) {
  constexpr int e = 1 << kShift16<T>;
  return (w + e - 1) & ~(e - 1);
}

// K row stride in shared memory: an odd number of 16-byte units holding
// w elements, so the 16-byte loads of 8 lanes (one key each) hit 8
// distinct bank groups
template <typename T>
__host__ __device__ __forceinline__ int odd_units(int w) {
  constexpr int e = 1 << kShift16<T>;
  return e * (((w + e - 1) / e) | 1);
}

// dynamic shared memory (bytes): q [R][pad16(hd)], K [S][odd_units(hd)], V
// [S][pad16(vd)] in T; the softmax weights [R][S], a row's m and l in
// fp32; a flag
template <typename T>
size_t one_query_smem(int R, int S, int hd, int vd) {
  return sizeof(T) * (R * pad16<T>(hd) +
                      S * (odd_units<T>(hd) + pad16<T>(vd))) +
         sizeof(float) * (static_cast<size_t>(R) * S + 2 * R) + sizeof(int);
}

// s0..s3 += x . y over 16 bytes of each: 4 fp32, or 8 bf16 widened to fp32
__device__ __forceinline__ void fma16(const float* x, const float* y,
                                      float& s0, float& s1, float& s2,
                                      float& s3) {
  const float4 a = *reinterpret_cast<const float4*>(x);
  const float4 b = *reinterpret_cast<const float4*>(y);
  s0 = fmaf(a.x, b.x, s0);
  s1 = fmaf(a.y, b.y, s1);
  s2 = fmaf(a.z, b.z, s2);
  s3 = fmaf(a.w, b.w, s3);
}
// the bf16 at the low and at the high half of a 32-bit word, as fp32
// (exact: a bf16 is an fp32's top 16 bits)
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void fma16(const bf16* x, const bf16* y,
                                      float& s0, float& s1, float& s2,
                                      float& s3) {
  const uint4 a = *reinterpret_cast<const uint4*>(x);
  const uint4 b = *reinterpret_cast<const uint4*>(y);
  s0 = fmaf(bf16_lo(a.x), bf16_lo(b.x), s0);
  s1 = fmaf(bf16_hi(a.x), bf16_hi(b.x), s1);
  s2 = fmaf(bf16_lo(a.y), bf16_lo(b.y), s2);
  s3 = fmaf(bf16_hi(a.y), bf16_hi(b.y), s3);
  s0 = fmaf(bf16_lo(a.z), bf16_lo(b.z), s0);
  s1 = fmaf(bf16_hi(a.z), bf16_hi(b.z), s1);
  s2 = fmaf(bf16_lo(a.w), bf16_lo(b.w), s2);
  s3 = fmaf(bf16_hi(a.w), bf16_hi(b.w), s3);
}

// One block per (batch row, KV head, key split): its R = Sq G rows (row r
// = position r / G, head kvh G + r % G) against keys [k0, k0 + S) of the
// split. T: the inputs' and output's type (fp32 or bf16; kept as T in
// shared memory, widened to fp32 at each FMA). EPT: outputs a thread
// keeps in registers per pass of P.V.
template <typename T, int EPT>
__device__ __forceinline__ void one_query_block(const OneQuery<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int R = a.R, S = a.S, hdp = pad16<T>(a.hd), vdp = pad16<T>(a.vd);
  const int kp = odd_units<T>(a.hd);
  T* qs = reinterpret_cast<T*>(smem_raw);                 // [R][hdp]
  T* ks = qs + R * hdp;                                   // [S][kp]
  T* vs = ks + S * kp;                                    // [S][vdp]
  float* ps = reinterpret_cast<float*>(vs + S * vdp);     // [R][S]
  float* rm = ps + R * S;                                 // [R]
  float* rl = rm + R;                                     // [R]
  int* flag = reinterpret_cast<int*>(rl + R);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pair = blockIdx.x / a.n, split = blockIdx.x - pair * a.n;
  const int b = pair / a.KV, kvh = pair - b * a.KV;
  const int k0 = split * S, nk = min(S, a.Sk - k0);  // keys here, >= 1
  const size_t q_row = static_cast<size_t>(a.H) * a.hd;
  const size_t k_row = static_cast<size_t>(a.KV) * a.hd;
  const size_t v_row = static_cast<size_t>(a.KV) * a.vd;
  const T* kb = a.k + (static_cast<size_t>(b) * a.Sk + k0) * k_row +
                static_cast<size_t>(kvh) * a.hd;
  const T* vb = a.v + (static_cast<size_t>(b) * a.Sk + k0) * v_row +
                static_cast<size_t>(kvh) * a.vd;
  auto out_at = [&](int r) {  // row r's output
    const int s = r / a.G, g = r - s * a.G;
    return a.out + (static_cast<size_t>(b) * a.Sq + s) * a.H * a.vd +
           static_cast<size_t>(kvh * a.G + g) * a.vd;
  };

  // --- one round trip: the rows' queries, the split's K and V rows, every
  // copy issued before any is waited on
  copy_rows(qs, hdp, R, a.hd, a.vec, a.q, [&](int r) -> const T* {
    const int s = r / a.G, g = r - s * a.G;
    return a.q + (static_cast<size_t>(b) * a.Sq + s) * q_row +
           static_cast<size_t>(kvh * a.G + g) * a.hd;
  });
  copy_rows(ks, kp, nk, a.hd, a.vec, a.k,
            [&](int j) -> const T* { return kb + j * k_row; });
  copy_rows(vs, vdp, nk, a.vd, a.vec, a.v,
            [&](int j) -> const T* { return vb + j * v_row; });
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  // --- scores in log2 units, fp32 FMAs: a thread per (row, key), lanes on
  // neighbouring keys of one row (S is a multiple of 32); masked keys score
  // NEG_INF, keys past the split's take no part (-inf)
  const int nc = a.hd >> kShift16<T>;  // whole 16-byte chunks a row
  for (int i = tid; i < R * S; i += kThreads) {
    const int r = i / S, j = i - r * S;
    const int key = k0 + j, pos = r / a.G;
    const bool live = j < nk;
    float val = -CUDART_INF_F;
    if (live && ((a.causal && key > pos) ||
                 (a.window > 0 && pos - key >= a.window))) {
      val = kNegInf;
    } else if (live) {
      const T* qr = qs + r * hdp;
      const T* kr = ks + j * kp;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 8
      for (int c = 0; c < nc; ++c)
        fma16(qr + (c << kShift16<T>), kr + (c << kShift16<T>), s0, s1, s2,
              s3);
      for (int d = nc << kShift16<T>; d < a.hd; ++d)
        s0 = fmaf(to_f(qr[d]), to_f(kr[d]), s0);
      val = ((s0 + s1) + (s2 + s3)) * a.scale;
    }
    ps[i] = val;
  }
  __syncthreads();

  // --- the split's softmax, a warp a row: m, P = 2^(s - m), l
  for (int r = warp; r < R; r += kWarps) {
    float* pr = ps + r * S;
    float m = -CUDART_INF_F;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, pr[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float p = exp2f(pr[j] - m);
      pr[j] = p;
      l += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) {
      rm[r] = m;
      rl[r] = l;
    }
  }
  __syncthreads();

  // --- O = P.V: a thread per (row, value column), EPT of them a pass,
  // keys in order; one split writes the output (rounded to T once), more
  // leave fp32 partials
  const int E = R * a.vd;
  const bool one = a.n == 1;
  const size_t base = (static_cast<size_t>(pair) * a.n_all + split) * R;
  for (int e0 = tid; e0 < E; e0 += kThreads * EPT) {
    float acc[EPT];
    int po[EPT], vo[EPT];
#pragma unroll
    for (int u = 0; u < EPT; ++u) {
      const int e = min(e0 + u * kThreads, E - 1);  // past E: not stored
      const int r = e / a.vd;
      po[u] = r * S;
      vo[u] = e - r * a.vd;
      acc[u] = 0.f;
    }
#pragma unroll 4
    for (int j = 0; j < nk; ++j)
#pragma unroll
      for (int u = 0; u < EPT; ++u)
        acc[u] = fmaf(ps[po[u] + j], to_f(vs[j * vdp + vo[u]]), acc[u]);
#pragma unroll
    for (int u = 0; u < EPT; ++u) {
      const int e = e0 + u * kThreads;
      if (e >= E) continue;
      const int r = e / a.vd, d = e - r * a.vd;
      if (one)
        store(out_at(r) + d, acc[u] / fmaxf(rl[r], 1e-30f));
      else
        a.part_o[(base + r) * a.vd + d] = acc[u];
    }
  }
  if (one) return;
  if (tid < R) {
    a.part_m[base + tid] = rm[tid];
    a.part_l[base + tid] = rl[tid];
  }

  // --- the (row, KV head)'s last split to finish combines them all, in
  // split order: M = max m_s, e_s = 2^(m_s - M), L = sum l_s e_s, O = sum
  // o_s e_s, out = O / max(L, 1e-30), rounded to T once
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(a.tickets + pair, 1) == a.n - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const size_t p0 = static_cast<size_t>(pair) * a.n_all * R;
  // every split's (m, l) read in one round trip into shared memory (the
  // block's tiles are done with), e_s computed once a (split, row), each
  // output's o_s loads 8 in flight
  __syncthreads();  // every thread has read the flag
  float* cm = reinterpret_cast<float*>(smem_raw);  // [R]: M
  float* cl = cm + R;                              // [R]: max(L, 1e-30)
  float* we = cl + R;                              // [n][R]: m_s, then e_s
  float* wl = we + a.n * R;                        // [n][R]: l_s
  const int nR = a.n * R;
  for (int i = tid; i < nR; i += kThreads) {
    we[i] = __ldcg(a.part_m + p0 + i);
    wl[i] = __ldcg(a.part_l + p0 + i);
  }
  __syncthreads();
  for (int r = warp; r < R; r += kWarps) {  // a warp a row: max is exact
    float M = -CUDART_INF_F;
    for (int s = lane; s < a.n; s += 32) M = fmaxf(M, we[s * R + r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    if (lane == 0) cm[r] = M;
  }
  __syncthreads();
  for (int i = tid; i < nR; i += kThreads) {
    const int r = i % R;
    we[i] = exp2f(we[i] - cm[r]);
  }
  __syncthreads();
  if (tid < R) {
    float L = 0.f;
    for (int s = 0; s < a.n; ++s) L = fmaf(wl[s * R + tid], we[s * R + tid], L);
    cl[tid] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  for (int e = tid; e < E; e += kThreads) {
    const int r = e / a.vd, d = e - r * a.vd;
    float O = 0.f;
#pragma unroll 8
    for (int s = 0; s < a.n; ++s)
      O = fmaf(__ldcg(a.part_o + (p0 + s * R + r) * a.vd + d), we[s * R + r],
               O);
    store(out_at(r) + d, O / cl[r]);
  }
}

template <int EPT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_one_query(const OneQuery<float> a) {
  one_query_block<float, EPT>(a);
}

template <int EPT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_one_query_bf16(const OneQuery<bf16> a) {
  one_query_block<bf16, EPT>(a);
}

template <int EPT>
auto one_query_kernel(const OneQuery<float>&) {
  return flash_fwd_one_query<EPT>;
}
template <int EPT>
auto one_query_kernel(const OneQuery<bf16>&) {
  return flash_fwd_one_query_bf16<EPT>;
}

template <int EPT, typename T>
cudaError_t launch_one_query(const OneQuery<T>& a, unsigned blocks,
                             size_t smem, cudaStream_t stream) {
  const auto kernel = one_query_kernel<EPT>(a);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// T (fp32 or bf16) q, k, v at Sq G <= 64 rows a KV head, S keys a split (a
// multiple of 32 up to 256). part: scratch of B KV ceil(Sk / S) Sq G (vd +
// 2) floats and tickets B KV int32 zeros, where more than one split is
// walked (else they may be null)
template <typename T>
cudaError_t dispatch_one_query(int B, cudaStream_t stream, const void* q,
                               const void* k, const void* v, void* out,
                               float* part, int* tickets, int Sq, int Sk,
                               int H, int KV, int hd, int vd, int causal,
                               int window, int S, float scale) {
  OneQuery<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.out = static_cast<T*>(out);
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.KV = KV;
  a.G = H / KV;
  a.R = Sq * a.G;
  a.hd = hd;
  a.vd = vd;
  a.causal = causal;
  a.window = window;
  a.S = S;
  a.scale = scale * kLog2e;
  if (a.R > kQMaxRows || S <= 0 || S % 32 != 0 || S > kQMaxSplit)
    return cudaErrorInvalidValue;
  // every key a row sees lies in [0, hi]; if the last row sees none (Sq >
  // Sk with a window), it is uniform over every key, so all are walked
  int hi = causal && Sq < Sk ? Sq - 1 : Sk - 1;
  if (window > 0 && Sq - window > hi) hi = Sk - 1;
  a.n = hi / S + 1;
  a.n_all = (Sk + S - 1) / S;
  if (a.n > 1 && (part == nullptr || tickets == nullptr))
    return cudaErrorInvalidValue;
  const size_t P = static_cast<size_t>(B) * KV * a.n_all * a.R;
  a.part_m = part;
  a.part_l = part == nullptr ? nullptr : part + P;
  a.part_o = part == nullptr ? nullptr : part + 2 * P;
  a.tickets = tickets;
  a.vec = copy_bytes(q, sizeof(T) * hd);
  const int vec_k = copy_bytes(k, sizeof(T) * hd);
  const int vec_v = copy_bytes(v, sizeof(T) * vd);
  if (vec_k < a.vec) a.vec = vec_k;
  if (vec_v < a.vec) a.vec = vec_v;
  size_t smem = one_query_smem<T>(a.R, S, hd, vd);
  const size_t combine = sizeof(float) * 2 * (a.n + 1) * a.R;
  if (a.n > 1 && combine > smem) smem = combine;  // the combine's M, L, (m, l)s
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(B) * KV * a.n;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const unsigned nb = static_cast<unsigned>(blocks);
  const int per = (a.R * vd + kThreads - 1) / kThreads;  // outputs a thread
  if (per <= 1) return launch_one_query<1>(a, nb, smem, stream);
  if (per <= 2) return launch_one_query<2>(a, nb, smem, stream);
  // more passes of 4 past 512 outputs a block: an EPT 8 build spilled 12
  // bytes beside the combine's loads in flight
  return launch_one_query<4>(a, nb, smem, stream);
}

}  // namespace

// q [B,Sq,H,hd]; k [B,Sk,KV,hd]; v [B,Sk,KV,vd]; out [B,Sq,H,vd]. All of one
// type (bf16 != 0: bfloat16, else fp32), contiguous, on the device;
// H % KV == 0, H / KV <= 64, hd <= 256, vd <= hd. window 0 means unbounded.
// keys_per_split > 0 takes the one-query route of the input's type with
// splits of that many keys (part and tickets: its scratch,
// dispatch_one_query); 0 the tile kernel of the input's type. Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, float* part,
                                   int* tickets, int bf16, int B, int Sq,
                                   int Sk, int H, int KV, int hd, int vd,
                                   int causal, int window, int keys_per_split,
                                   float scale, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || vd <= 0) return 0;
  if (Sk <= 0 || KV <= 0 || H % KV != 0 || H / KV > kMaxG || hd <= 0 ||
      hd > kMaxHd || vd > hd || window < 0 || keys_per_split < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (keys_per_split > 0)
    return static_cast<int>(
        (bf16 ? dispatch_one_query<__nv_bfloat16> : dispatch_one_query<float>)(
            B, stream, q, k, v, out, part, tickets, Sq, Sk, H, KV, hd, vd,
            causal, window, keys_per_split, scale));
  if (bf16)
    return static_cast<int>(dispatch_bf16(B, stream, q, k, v, out, Sq, Sk, H,
                                          KV, hd, vd, causal, window, scale));
  const int G = H / KV;
  const int BQ = kRows / G;  // query positions per block
  const dim3 grid((Sq + BQ - 1) / BQ, B * KV);
  return static_cast<int>(dispatch(grid, stream, q, k, v, out, Sq, Sk, H, KV,
                                   G, BQ, hd, vd, causal, window, scale));
}
