"""Grouped-expert SwiGLU FFN: the CUDA kernel's launcher and its plain
PyTorch version.

Replaces ``repro/kernels/moe_gemm.py::moe_gemm_pallas``. The kernel
(``csrc/moe_gemm.cu``, whose header says what bounds it on an H100 and
how the design answers) computes, for every group e of rows,
``y[e] = (silu(x[e] @ w1[s]) * (x[e] @ w3[s])) @ w2[s]`` with
``s = slots[e]``: the weights are read in place from the expert cache's
slot buffers. The plain version gathers the slots with ``index_select``
and runs ``ref.moe_gemm_ref``. ``ops.moe_ffn`` is the public wrapper
that checks the arguments and picks between the two.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import moe_gemm_ref

SOURCE = "moe_gemm.cu"
SYMBOL = "moe_ffn_f32"
ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
SLICE_ROWS = 1024   # contraction rows per block at most (kSliceMax)


def cost(x_e, w1):
    """(flops, bytes) of one call, from the shapes: three products of
    2·C·d·F a group; x_e read and y written once, each group's three
    weight matrices read once, and its slot index (int32)."""
    E, C, d = x_e.shape
    F = w1.shape[-1]
    return (6 * E * C * d * F,
            x_e.element_size() * (2 * E * C * d + 3 * E * d * F) + 4 * E)


def plain(x_e, w1, w3, w2, slots):
    """x_e [E,C,d]; w1/w3 [S,d,F]; w2 [S,F,d]; slots [E] int64 -> [E,C,d]."""
    return moe_gemm_ref(x_e, w1.index_select(0, slots),
                        w3.index_select(0, slots), w2.index_select(0, slots))


def launch(fn, x_e, w1, w3, w2, slots):
    """Launch the kernel chain on the current stream. Arguments are
    checked by the caller: fp32, contiguous, on one CUDA device, slots
    int32. Allocates the split-contraction partial sums and the SwiGLU
    activations as scratch. Returns y [E,C,d]; raises if the launch was
    refused."""
    E, C, d = x_e.shape
    F = w1.shape[-1]
    ks_up, ks_down = -(-d // SLICE_ROWS), -(-F // SLICE_ROWS)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=x_e.device)

    hp, gp, a = empty(ks_up, E, C, F), empty(ks_up, E, C, F), empty(E, C, F)
    yp, y = empty(ks_down, E, C, d), empty(E, C, d)
    stream = torch.cuda.current_stream(x_e.device).cuda_stream
    err = fn(x_e.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
             slots.data_ptr(), hp.data_ptr(), gp.data_ptr(), a.data_ptr(),
             yp.data_ptr(), y.data_ptr(), E, C, d, F, ks_up, ks_down, stream)
    if err != 0:
        raise RuntimeError(f"moe_ffn kernel launch failed: cudaError {err}")
    return y
