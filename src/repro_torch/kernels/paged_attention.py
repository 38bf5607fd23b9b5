"""Single-token paged decode attention: the CUDA kernel's launcher and
its plain PyTorch version.

Replaces ``repro/kernels/paged_attention.py::paged_attention_pallas``.
The kernel (``csrc/paged_attention.cu``, whose header says what bounds
it on an H100 and how the design answers) runs one block per
(batch row, KV head), reads the row's block table and position from
device memory itself (the TPU kernel's scalar prefetch) and walks the
row's keys ``0..pos`` with an fp32 online softmax. The plain version is
``ref.paged_attention_ref`` (gather, mask, softmax). ``ops.paged_attention``
is the public wrapper that checks the arguments and picks between them.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.ref import paged_attention_ref as plain  # noqa: F401

SOURCE = "paged_attention.cu"
SYMBOL = "paged_attention_f32"
ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_void_p])
MAX_GROUP = 16      # query heads per KV head the kernel holds in registers
MAX_HEAD_DIM = 256


def launch(fn, q, k_pool, v_pool, block_tables, pos):
    """Launch on the current stream. Arguments are checked by the
    caller: fp32 q/pools, int32 tables/pos, contiguous, on one CUDA
    device. Returns [B, H, hd]; raises if the launch was refused."""
    B, H, hd = q.shape
    N, bs, KV, _ = k_pool.shape
    T = block_tables.shape[1]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
             B, N, KV, H // KV, hd, bs, T, 1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed: cudaError {err}")
    return out
