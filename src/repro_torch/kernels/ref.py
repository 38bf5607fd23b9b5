"""Plain PyTorch versions of the ported kernels (semantics of
``repro.kernels.ref``). The CPU path of every kernel wrapper, and the
yardstick the CUDA kernels are held against on the card."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def moe_gemm_ref(x_e, w1, w3, w2):
    """x_e [E,C,d]; w1/w3 [E,d,F]; w2 [E,F,d] -> [E,C,d] fp32."""
    x = x_e.float()
    h = torch.einsum("ecd,edf->ecf", x, w1.float())
    g = torch.einsum("ecd,edf->ecf", x, w3.float())
    a = F.silu(h) * g
    return torch.einsum("ecf,efd->ecd", a, w2.float())


def paged_attention_ref(q, k_pool, v_pool, block_tables, pos):
    """Single-token decode attention through a block table.

    q [B, H, hd]; k/v_pool [N, bs, KV, hd]; block_tables [B, T] int;
    pos [B] int -> [B, H, hd] in q's dtype. Row b attends to the keys
    its table gathers at logical indices <= pos[b]; masked lanes get
    ``NEG_INF`` and underflow to exactly zero weight. Written in the
    grouped ``[B, KV, G, ...]`` form of the dense decode path
    (``attention.gqa_decode_multipos``) so the two layouts share their
    arithmetic."""
    B, H, hd = q.shape
    bs, KV = k_pool.shape[1], k_pool.shape[2]
    T = block_tables.shape[1]
    G = H // KV
    tbl = block_tables.long()
    kg = k_pool[tbl].reshape(B, T * bs, KV, hd)
    vg = v_pool[tbl].reshape(B, T * bs, KV, hd)
    qf = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgh,blkh->bkgl", qf, kg.float()) / math.sqrt(hd)
    idx = torch.arange(T * bs, device=q.device)
    valid = idx[None, :] <= pos.long()[:, None]                 # [B, T*bs]
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgl,blkh->bkgh", w, vg.float())
    return out.reshape(B, H, hd).to(q.dtype)
