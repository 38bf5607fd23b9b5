"""Single-token paged decode attention: the CUDA kernel's launcher and
its plain PyTorch version.

Replaces ``repro/kernels/paged_attention.py::paged_attention_pallas``.
The kernel (``csrc/paged_attention.cu``, whose header says what bounds
it on an H100 and how the design answers) splits each row's keys
``0..pos`` into splits of ``KEYS_PER_SPLIT`` keys, one block per (split,
KV head, batch row); each block reads its row's position and block table
slice itself (the TPU kernel's scalar prefetch), brings its K/V tiles in
through a two-stage ``cp.async`` ring and runs an fp32 online softmax. A
row of one split writes its output directly; longer rows leave each
split's partials in scratch allocated here, combined in split order.
The plain version is ``ref.paged_attention_ref`` (gather, mask,
softmax). ``ops.paged_attention`` is the public wrapper that checks the
arguments and picks between them.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.ref import paged_attention_ref as plain  # noqa: F401

SOURCE = "paged_attention.cu"
SYMBOL = "paged_attention_f32"
ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_void_p])
MAX_GROUP = 16      # query heads per KV head the kernel holds in registers
MAX_HEAD_DIM = 256
# keys a block takes: fixed, so a row's splits and the order of its sums
# depend on its own position and keys alone, never on B or the other rows.
# No length won every shape chip_smoke.py sweeps (its paged_split_sweep
# line); 128 tied the best at the main call (rows of up to 128 keys stay
# in one block and skip the combine) and won on 4096-key rows
KEYS_PER_SPLIT = 128


def cost(q, k_pool, block_tables):
    """(flops, bytes) of one call, from the shapes. The positions are
    data, so the keys are every slot the tables name, B·T·bs (the most
    a call can see): 4·hd a (key, query head); q read, the output
    written, those keys' K and V rows read once, the tables and
    positions (int32) read once."""
    B, H, hd = q.shape
    bs, KV = k_pool.shape[1], k_pool.shape[2]
    T = block_tables.shape[1]
    keys = B * T * bs
    return (4 * keys * H * hd,
            q.element_size() * (2 * B * H * hd + 2 * keys * KV * hd)
            + 4 * (B * T + B))


def launch(fn, q, k_pool, v_pool, block_tables, pos, *,
           keys_per_split: int = KEYS_PER_SPLIT):
    """Launch on the current stream. Arguments are checked by the
    caller: fp32 q/pools, int32 tables/pos, contiguous, on one CUDA
    device. Returns [B, H, hd]; raises if the launch was refused."""
    B, H, hd = q.shape
    N, bs, KV, _ = k_pool.shape
    T = block_tables.shape[1]
    G = H // KV
    out = torch.empty_like(q)
    splits = -(-T * bs // keys_per_split)
    part = [0, 0, 0, 0]     # null pointers: every row has one split
    if splits > 1:
        n = B * KV * splits * G
        ml = torch.empty((2, n), dtype=torch.float32, device=q.device)
        po = torch.empty((n * hd,), dtype=torch.float32, device=q.device)
        tickets = torch.zeros((B * KV,), dtype=torch.int32, device=q.device)
        part = [ml[0].data_ptr(), ml[1].data_ptr(), po.data_ptr(),
                tickets.data_ptr()]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(), *part,
             B, N, KV, G, hd, bs, T, keys_per_split, 1.0 / math.sqrt(hd),
             stream)
    if err != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed: cudaError {err}")
    return out
