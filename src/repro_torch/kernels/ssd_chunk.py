"""Mamba2 SSD intra-chunk step: the CUDA kernel's launcher and its plain
PyTorch version.

Replaces ``repro/kernels/ssd_chunk.py::ssd_chunk_pallas``. The kernel
(``csrc/ssd_chunk.cu``, whose header says what bounds it on an H100 and
how the design answers) runs its three products on the TF32 tensor
cores with a 3xTF32 split (fp32 accuracy): a first launch writes each
chunk's score matrix ``C·Bᵀ`` to a scratch buffer, a second applies the
decay in registers and computes ``Y_intra`` and ``S_chunk`` for every
chunk of every sequence, so the decay matrix never reaches device
memory. The plain version is ``ref.ssd_chunk_ref``, which materialises
``[G, Q, Q, H]``. ``ops.ssd_chunk`` is the public wrapper that checks
the arguments and picks between the two.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import ssd_chunk_ref as plain  # noqa: F401

SOURCE = "ssd_chunk.cu"
SYMBOL = "ssd_chunk_f32"
ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
MAX_CHUNK = 4096     # Q: the block keeps the chunk's cumsum in shared memory


def launch(fn, dA, xw, Bm, Cm):
    """Launch on the current stream. Arguments are checked by the
    caller: fp32, contiguous, on one CUDA device. Returns (Y [G,Q,H,P],
    S [G,H,P,N]); raises if a launch was refused."""
    G, Q, H = dA.shape
    P, N = xw.shape[-1], Bm.shape[-1]
    y = torch.empty((G, Q, H, P), dtype=torch.float32, device=dA.device)
    s = torch.empty((G, H, P, N), dtype=torch.float32, device=dA.device)
    # the score matrices C·Bᵀ, rows padded to a multiple of 4 floats
    cb = torch.empty((G, Q, (Q + 3) // 4 * 4), dtype=torch.float32,
                     device=dA.device)
    stream = torch.cuda.current_stream(dA.device).cuda_stream
    err = fn(dA.data_ptr(), xw.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             y.data_ptr(), s.data_ptr(), cb.data_ptr(), G, Q, H, P, N,
             stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed: cudaError {err}")
    return y, s
