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


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale=None):
    """q [BH,Sq,hd]; k [BH,Sk,hd]; v [BH,Sk,vd] -> [BH,Sq,vd] in q's
    dtype (exact softmax in fp32). Masked scores get ``NEG_INF``; a row
    with no visible key is uniform over all keys."""
    Sq, hd = q.shape[1], q.shape[2]
    Sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    s = torch.einsum("bqh,bkh->bqk", q.float(), k.float()) * scale
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window > 0:
        mask = mask & (q_pos - k_pos < window)
    s = torch.where(mask[None], s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkh->bqh", p, v.float()).to(q.dtype)


def ssd_chunk_ref(dA, xw, Bm, Cm):
    """dA [G,Q,H]; xw [G,Q,H,P]; Bm/Cm [G,Q,N] -> (Y_intra [G,Q,H,P],
    S_chunk [G,H,P,N]), both fp32: the SSD intra-chunk step with the
    decay matrix materialised as [G,Q,Q,H].

    The decay masks its exponent (-inf above the diagonal), not its
    value. The values are the same; but where a chunk decays by more
    than e^88, exp(rel) above the diagonal is inf, and autograd of a
    value mask multiplies it by the mask's zero: NaN in d dA. The JAX
    reference masks the value."""
    dA, xw, Bm, Cm = dA.float(), xw.float(), Bm.float(), Cm.float()
    Q = dA.shape[1]
    cum = torch.cumsum(dA, dim=1)
    rel = cum[:, :, None, :] - cum[:, None, :, :]           # [G,Q,Q,H]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=dA.device))
    decay = torch.exp(torch.where(mask[None, :, :, None], rel,
                                  torch.full((), -math.inf,
                                             device=dA.device)))
    scores = torch.einsum("gin,gjn->gij", Cm, Bm)
    y = torch.einsum("gijh,gij,gjhp->gihp", decay, scores, xw)
    decay_end = torch.exp(cum[:, -1:, :] - cum)              # [G,Q,H]
    s = torch.einsum("gjh,gjn,gjhp->ghpn", decay_end, Bm, xw)
    return y, s
