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

The backward (``csrc/ssd_chunk_bwd.cu``, ``BACKWARD``) has no Pallas
counterpart: the JAX package trains through the XLA version of the step.
It runs every product on the TF32 tensor cores in 3xTF32, as the forward
does, from ``cp.async``-fed tiles, each 32-deep stage of a contraction
summed from zero and added in fp32 (the tensor cores truncate as they
accumulate); it is bound by issue slots under the tensor cores' rate, and
``wgmma`` + TMA would take the operand splits off them. Seven launches,
no atomics, bitwise repeatable. ``launch_bwd`` runs it and allocates its
scratch, ``plain_bwd`` (autograd of ``plain``) is what it is held against.
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch

from repro_torch.kernels.ref import ssd_chunk_ref as plain

SOURCE = "ssd_chunk.cu"
SYMBOL = "ssd_chunk_f32"
ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
MAX_CHUNK = 4096     # Q: the block keeps the chunk's cumsum in shared memory
# the backward's build record (``ops.build_kernels``); the same chunk limit
BACKWARD = SimpleNamespace(
    SOURCE="ssd_chunk_bwd.cu", SYMBOL="ssd_chunk_bwd_f32",
    ARGTYPES=[ctypes.c_void_p] * 16 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
BWD_TILE = 64        # the backward's tiles: positions and N columns
BWD_PART = 132       # floats of d dA sums a (tile pair, head)
BWD_BLOCKS = 512     # blocks the head groups and head splits aim for


def cost(dA, xw, Bm):
    """(flops, bytes) of one call: a chunk's scores C·Bᵀ (2·N a pair of
    its lower triangle), the decay (one a pair and head), Y (2·P a pair
    and head), the end-of-chunk decay on xw (one a position, head and
    P) and S (2·P·N a position and head); every input read once, both
    outputs written once (fp32)."""
    G, Q, H = dA.shape
    P, N = xw.shape[3], Bm.shape[2]
    tri = Q * (Q + 1) // 2
    return (G * (2 * tri * N + tri * H + 2 * tri * H * P + Q * H * P
                 + 2 * Q * H * P * N),
            4 * (G * Q * H + 2 * G * Q * H * P + 2 * G * Q * N
                 + G * H * P * N))


def bwd_cost(dA, xw, Bm):
    """(flops, bytes) of one backward call: its products, a head's U and
    state term (2·Q·P·N each), dxw and dM (2·P a visible pair each), and
    a chunk's scores, dC and dB (2·N a visible pair each); dA, xw, Bm,
    Cm, dY and dS read once, the four gradients written once (fp32)."""
    G, Q, H = dA.shape
    P, N = xw.shape[3], Bm.shape[2]
    tri = Q * (Q + 1) // 2
    return (G * (H * (4 * Q * P * N + 4 * tri * P) + 6 * tri * N),
            4 * (2 * G * Q * H + 3 * G * Q * H * P + 4 * G * Q * N
                 + G * H * P * N))


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


def plain_bwd(dA, xw, Bm, Cm, dY, dS):
    """(d dA, d xw, d Bm, d Cm) of ``plain`` at (dA, xw, Bm, Cm) for the
    output gradients (dY, dS), by autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (dA, xw, Bm, Cm)]
        return torch.autograd.grad(plain(*leaves), leaves, (dY, dS))


def bwd_split(G, Q, H, N):
    """(head groups of the pairs launch, head splits of the dB launch):
    as many as bring each launch to about BWD_BLOCKS blocks, at most H.
    They fix the order of the sums over heads, so they depend on the
    shape alone."""
    nT = -(-Q // BWD_TILE)
    pairs = nT * (nT + 1) // 2
    n_tiles = nT * -(-N // BWD_TILE)
    return (min(H, max(1, -(-BWD_BLOCKS // (G * pairs)))),
            min(H, max(1, -(-BWD_BLOCKS // (G * n_tiles)))))


def launch_bwd(fn, dA, xw, Bm, Cm, dY, dS):
    """Launch the backward on the current stream. Arguments are checked
    by the caller: fp32, contiguous, on one CUDA device, Q <= MAX_CHUNK.
    Returns (d dA, d xw, d Bm, d Cm); raises if a launch was refused."""
    G, Q, H = dA.shape
    P, N = xw.shape[-1], Bm.shape[-1]
    nT = -(-Q // BWD_TILE)
    Qp, pairs = nT * BWD_TILE, nT * (nT + 1) // 2
    groups, splits = bwd_split(G, Q, H, N)
    f32 = dict(dtype=torch.float32, device=dA.device)
    outs = [torch.empty_like(t) for t in (dA, xw, Bm, Cm)]
    scratch = [torch.empty((2, G, H, Qp), **f32),         # cum, hi and lo
               torch.empty((G, Qp, Qp), **f32),           # C . B^T
               torch.empty((G, groups, Qp, Qp), **f32),   # score gradient
               torch.empty((G, H, Qp), **f32),            # T
               torch.empty((G, H, pairs, BWD_PART), **f32),
               torch.empty((G, splits, Qp, N), **f32)]    # dB partials
    stream = torch.cuda.current_stream(dA.device).cuda_stream
    err = fn(*(t.data_ptr() for t in (dA, xw, Bm, Cm, dY, dS, *outs,
                                      *scratch)),
             G, Q, H, P, N, groups, splits, stream)
    if err != 0:
        raise RuntimeError(
            f"ssd_chunk_bwd kernel launch failed: cudaError {err}")
    return tuple(outs)
