"""Full-sequence (prefill) attention: the CUDA kernel's launcher and its
plain PyTorch version.

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas``.
The kernels (``csrc/flash_attention.cu``, whose header says what bounds
them on an H100 and how the design answers) run one block per (batch
row, KV head, tile of query positions) that serves the KV head's G
query heads, read K/V in place from ``[B, S, KV, hd]``, keep the online
softmax in registers, skip the key tiles their rows cannot see, and mask
the ragged edges themselves: two consumer warpgroups running ``wgmma``,
fed by a producer warp's TMA copies into a ring of 128-byte-swizzled
tiles. fp32 inputs: ``flash_fwd_f32``, both products on the TF32 tensor
cores in 3xTF32 (each fp32 operand split hi + lo, fp32 accuracy; the
producer's other warps split each K/V tile once as it lands), each key
tile's P.V summed from zero and added to O in fp32. bf16 inputs:
``flash_fwd_bf16``, on the bf16 tensor cores (S in one pass, P.V with P
as bf16 hi + lo), the output rounded to bf16 once.
``FORWARD_NO_SPILL``: the instantiations of both that must compile with
no spill. The plain version repeats K/V per
query head and runs ``ref.flash_attention_ref`` (exact softmax), as the
JAX wrapper does. ``ops.flash_attention`` is the public wrapper that
checks the arguments and picks between the two.

fp32 calls of at most ``ONE_QUERY_ROWS`` query rows a KV head (Sq·G: the
engines' cross-attention decode calls, one query over the encoder's
frames), and bf16 calls of at most ``ONE_QUERY_ROWS_BF16``, take the
one-query route instead, ``flash_fwd_one_query`` (fp32) or
``flash_fwd_one_query_bf16``: one block per (batch row, KV head, split of
``one_query_plan``'s keys) that fetches its split's K/V rows in one round
trip, scores them with fp32 FMAs on the CUDA cores (bf16 widened at each
FMA), and leaves (max, sum, output) partials that the row's last block
combines in split order (``one_query_splits``: the splits a call walks),
a bf16 output rounded once. The split length is a function of the shape
and the dtype alone, never of B or H, so a row's output is bitwise the
same in any batch and under any cut of its heads.

The backward (``csrc/flash_attention_bwd.cu``, ``BACKWARD``; fp32 sums)
has no Pallas counterpart: the JAX package trains through XLA blockwise
attention. Both dtypes run two consumer warpgroups on ``wgmma`` fed by a
producer warp's TMA ring of 128-byte-swizzled tiles (``setmaxnreg`` 40 /
232). fp32: ``flash_bwd_rows_f32`` and ``flash_bwd_keys_f32``, every
product 3xTF32 on the TF32 tensor cores (each tile split into tf32 hi + lo
as it lands, by the rows launch's warpgroups or the producer's other
warps), the accumulations with the
streamed tile as A (dQ^T = K^T.dS^T, dV^T = dO^T.P, dK^T = Q^T.dS), each
tile's partial added to the running sum in fp32. bf16:
``flash_bwd_rows_bf16`` and ``flash_bwd_keys_bf16``, every product on the
bf16 tensor cores summed in place in fp32, P and dS as bf16 hi + lo, the
gradients rounded to bf16 once. ``BACKWARD.NO_SPILL``: the instantiations
that must compile with no spill. ``launch_bwd`` runs its two launches,
``plain_bwd`` (autograd of ``plain``) is what it is held against.
"""
from __future__ import annotations

import ctypes
import math
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.kernels.ref import flash_attention_ref

SOURCE = "flash_attention.cu"
SYMBOL = "flash_attention_fwd"
ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_float,
                                                          ctypes.c_void_p]
MAX_GROUP = 64       # query heads per KV head (the C entry's limit)
MAX_HEAD_DIM = 256   # q/k width; v may be narrower
# the one-query route: fp32 calls of at most ONE_QUERY_ROWS rows (Sq·G) a
# KV head take it; a split holds the most keys, 32 to 256 in powers of
# two, whose K and V rows fit ONE_QUERY_SPLIT_BYTES. Both from
# chip_smoke.py's one_query_sweep on an H100: at 256 (batch row, KV head)
# pairs the route is 1.7x faster than the tile kernel at 8 rows, ties it
# at 16 and loses past (at 16 pairs it wins up to 64); 32 KB splits (64
# keys at hd 64, 32 at 128) timed at or under 64 KB ones at the engines'
# calls
ONE_QUERY_ROWS = 8
ONE_QUERY_SPLIT_BYTES = 32 * 1024
# the same two for bf16 calls (their bf16 bytes against the budget), from
# the same sweeps run against the bf16 tile kernel (flash_fwd_bf16), which
# is 6-12x faster per call than the fp32 one: at 256 pairs the route ties
# it at 1 row (0.092-0.099 vs 0.094-0.097 ms) and loses from 2 (at 16 pairs
# it wins up to 8); the budget is the engines' calls' own: 16 KB splits (64
# keys at hd 64, 32 at 128) are 9-10% faster than 32 KB ones at Whisper's
# (0.0103-0.0113 vs 0.0114-0.0125 ms) and 1-3% at Vision's
ONE_QUERY_ROWS_BF16 = 1
ONE_QUERY_SPLIT_BYTES_BF16 = 16 * 1024
# the combine's shared memory: 8 bytes a (split, row) and a row (the
# block's dynamic limit on an H100)
ONE_QUERY_COMBINE_BYTES = 227 * 1024
# its instantiations (outputs a thread a pass; more passes of 4 past 512
# outputs a block), which ptxas must compile with no stack and no spills
ONE_QUERY_NO_SPILL = tuple(f"flash_fwd_one_query{t}<{n}>"
                           for t in ("", "_bf16") for n in (1, 2, 4))
# the tile forward's instantiations <HK, VN, keys a tile, stages> that
# ptxas must compile with no stack and no spills: bf16 for hd <= 64, <= 128
# and MLA's 192 / 128; fp32 for hd <= 64 and <= 128 (at MLA's widths the
# fp32 kernel spills a little: csrc/flash_attention.cu)
FORWARD_NO_SPILL = ("flash_fwd_bf16<64,64,128,3>",
                    "flash_fwd_bf16<128,128,64,3>",
                    "flash_fwd_bf16<192,128,64,3>",
                    "flash_fwd_f32<64,64,64,3>",
                    "flash_fwd_f32<128,128,32,2>")
# the backward's build record (``ops.build_kernels``); the same limits.
# NO_SPILL: the instantiations ptxas must compile with no stack and no
# spills: bf16 for hd <= 64, <= 128 and MLA's 192 / 128 (rows <HK, VK, keys
# a tile, stages>; keys <HK, VK, rows a tile, stages, warpgroups a key>),
# fp32 for hd <= 64 (rows <HK, VK, keys a tile, stages, Q and dO split in
# shared memory, key tiles split by their warpgroup>; keys <HK, VK, rows a
# tile, stages, column passes,
# warpgroups on alternate tiles, K and V split in shared memory>; at hd
# 128 the fp32 kernels spill a little: csrc/flash_attention_bwd.cu)
BACKWARD = SimpleNamespace(
    SOURCE="flash_attention_bwd.cu", SYMBOL="flash_attention_bwd",
    ARGTYPES=[ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_float,
                                                             ctypes.c_void_p],
    NO_SPILL=("flash_bwd_rows_bf16<64,64,64,3>",
              "flash_bwd_rows_bf16<128,128,64,3>",
              "flash_bwd_rows_bf16<192,128,64,3>",
              "flash_bwd_keys_bf16<64,64,64,4,1>",
              "flash_bwd_keys_bf16<128,128,32,4,1>",
              "flash_bwd_keys_bf16<192,128,16,4,1>",
              "flash_bwd_rows_f32<64,64,32,4,1,1>",
              "flash_bwd_keys_f32<64,64,32,2,1,1,1>"))


def plain(q, k, v, *, causal: bool, window: int):
    """q [B,Sq,H,hd]; k [B,Sk,KV,hd]; v [B,Sk,KV,vd] -> [B,Sq,H,vd]."""
    B, Sq, H, hd = q.shape
    Sk, KV, vd = k.shape[1], k.shape[2], v.shape[-1]
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    qf = q.transpose(1, 2).reshape(B * H, Sq, hd)
    kf = k.transpose(1, 2).reshape(B * H, Sk, hd)
    vf = v.transpose(1, 2).reshape(B * H, Sk, vd)
    out = flash_attention_ref(qf, kf, vf, causal=causal, window=window)
    return out.reshape(B, H, Sq, vd).transpose(1, 2)


def one_query_plan(Sq: int, Sk: int, H: int, KV: int, hd: int, vd: int,
                   dtype) -> int | None:
    """Keys a split of the one-query route for a call of this shape, or
    None where the call takes the tile kernel of its dtype (more than
    ONE_QUERY_ROWS rows a KV head in fp32, ONE_QUERY_ROWS_BF16 in bf16).
    Never a function of B or H; the split length depends on (Sk, hd, vd)
    and the dtype alone: the most keys whose K and V rows, in the dtype's
    bytes, fit its split budget. A call with more splits than the
    combine's shared memory holds takes the tile kernel."""
    rows, budget = {torch.float32: (ONE_QUERY_ROWS, ONE_QUERY_SPLIT_BYTES),
                    torch.bfloat16: (ONE_QUERY_ROWS_BF16,
                                     ONE_QUERY_SPLIT_BYTES_BF16)}.get(
                                         dtype, (0, 0))
    if Sq * (H // KV) > rows:
        return None
    S = 256
    while S > 32 and dtype.itemsize * S * (hd + vd) > budget:
        S //= 2
    S = min(S, 32 * -(-Sk // 32))   # no wider than the keys
    if 8 * (-(-Sk // S) + 1) * Sq * (H // KV) > ONE_QUERY_COMBINE_BYTES:
        return None
    return S


def one_query_splits(Sq: int, Sk: int, causal: bool, window: int,
                     S: int) -> list:
    """The key ranges [k0, k1) the one-query route walks at split length
    S: the splits [s·S, (s+1)·S) ∩ [0, Sk) up to the last key a row can
    see, or every split where the last row sees none (Sq > Sk with a
    window: it is uniform over every key), as the kernel walks them."""
    hi = min(Sk - 1, Sq - 1) if causal else Sk - 1
    if window > 0 and Sq - window > hi:
        hi = Sk - 1
    return [(k0, min(k0 + S, Sk)) for k0 in range(0, hi + 1, S)]


def plan_of(q, k, v):
    """``one_query_plan`` of a call's tensors."""
    return one_query_plan(q.shape[1], k.shape[1], q.shape[2], k.shape[2],
                          q.shape[3], v.shape[3], q.dtype)


def visible_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs a call scores unmasked."""
    q = np.arange(Sq)
    hi = np.minimum(q, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros(Sq, int)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def cost(q, k, v, *, causal: bool, window: int):
    """(flops, bytes) of one call: both products, 2·(hd + vd) a visible
    (query, key) pair and query head; q, k and v read once, the output
    written once."""
    B, Sq, H, hd = q.shape
    Sk, KV, vd = k.shape[1], k.shape[2], v.shape[3]
    return (2 * B * H * visible_pairs(Sq, Sk, causal, window) * (hd + vd),
            q.element_size() * (B * Sq * H * hd + B * Sk * KV * (hd + vd)
                                + B * Sq * H * vd))


def bwd_cost(q, k, v, *, causal: bool, window: int):
    """(flops, bytes) of one backward call: the least autograd of the
    forward does per visible (query, key) pair and query head, S again
    (2·hd), dP (2·vd), dV (2·vd), dQ and dK (2·hd each); q, k, v and the
    output's gradient read once, dq, dk and dv written once."""
    B, Sq, H, hd = q.shape
    Sk, KV, vd = k.shape[1], k.shape[2], v.shape[3]
    return (2 * B * H * visible_pairs(Sq, Sk, causal, window)
            * (3 * hd + 2 * vd),
            q.element_size() * (B * Sq * H * (2 * hd + vd)
                                + 2 * B * Sk * KV * (hd + vd)))


def launch(fn, q, k, v, *, causal: bool, window: int,
           keys_per_split: int | None = None):
    """Launch on the current stream. Arguments are checked by the
    caller: one dtype (fp32 or bf16), contiguous, on one CUDA device.
    ``keys_per_split``: the one-query route's split length (default
    ``one_query_plan``'s; 0 takes the tile kernel). Where the route walks
    more than one split, its partials' scratch and the rows' tickets are
    allocated here. Returns [B, Sq, H, vd] in q's dtype; raises if the
    launch was refused."""
    B, Sq, H, hd = q.shape
    Sk, KV, vd = k.shape[1], k.shape[2], v.shape[-1]
    S = plan_of(q, k, v) if keys_per_split is None else keys_per_split
    out = torch.empty((B, Sq, H, vd), dtype=q.dtype, device=q.device)
    part = tickets = 0     # null pointers: one split, or the tile kernel
    if S and len(one_query_splits(Sq, Sk, causal, window, S)) > 1:
        rows = B * KV * -(-Sk // S) * Sq * (H // KV)
        scratch = torch.empty((rows * (vd + 2),), dtype=torch.float32,
                              device=q.device)
        counts = torch.zeros((B * KV,), dtype=torch.int32, device=q.device)
        part, tickets = scratch.data_ptr(), counts.data_ptr()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), part,
             tickets, int(q.dtype == torch.bfloat16), B, Sq, Sk, H, KV, hd,
             vd, int(causal), window, S or 0, 1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: cudaError {err}")
    return out


def plain_bwd(q, k, v, dout, *, causal: bool, window: int):
    """(dq, dk, dv) of ``plain`` at (q, k, v) for the output gradient
    ``dout``, by autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = plain(*leaves, causal=causal, window=window)
        return torch.autograd.grad(out, leaves, dout)


def launch_bwd(fn, q, k, v, dout, *, causal: bool, window: int):
    """Launch the backward on the current stream: its rows launch (the
    rows' softmax stats, recomputed from q, k and v, into a scratch, and
    dq), then its keys launch (dk, dv). Arguments are checked by the
    caller: one dtype (fp32 or bf16, dout's too), contiguous, on one
    CUDA device. Returns (dq, dk, dv) in q's dtype; raises if a launch
    was refused."""
    B, Sq, H, hd = q.shape
    Sk, KV, vd = k.shape[1], k.shape[2], v.shape[-1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty((3, B, Sq, H), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
             int(q.dtype == torch.bfloat16), B, Sq, Sk, H, KV, hd, vd,
             int(causal), window,
             1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention_bwd kernel launch failed: cudaError {err}")
    return dq, dk, dv
