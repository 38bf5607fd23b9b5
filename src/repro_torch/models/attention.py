"""GQA attention: projections, the full-sequence path (prefill), and
decode over dense, ring (sliding-window) and paged KV caches (port of
the GQA half of ``repro.models.attention``; MLA and cross-attention come
with a later slice).

Conventions are the JAX package's: ``x [B, S, d]``; weights
``wq [d,H,hd]``, ``wk/wv [d,KV,hd]``, ``wo [H,hd,d]``; dense cache
``{k,v [B, L, KV, hd]}``; paged pool ``{k,v [N, bs, KV, hd]}``. Head
padding for a sharded model axis (``_head_padding``) is the identity
without a mesh, so it is not ported.

Unlike JAX, the caches are updated IN PLACE (``index_put_``): a decode
step writes its new K/V rows into the tensors it was given and returns
the same dict. That saves copying the whole cache or pool every step.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, dense_init, rope_cos_sin

NEG_INF = -1e30


def init_gqa(gen: torch.Generator, cfg, dtype, *, layers: int,
             device="cuda"):
    """Stacked GQA params for ``layers`` layers (JAX init scales)."""
    d, H, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L = layers
    res_scale = 1.0 / math.sqrt(2 * cfg.num_layers)

    def init(shape, in_dim, scale=1.0):
        return dense_init(gen, shape, in_dim, scale=scale, dtype=dtype,
                          device=device)

    p = {
        "wq": init((L, d, H, hd), d),
        "wk": init((L, d, kv, hd), d),
        "wv": init((L, d, kv, hd), d),
        "wo": init((L, H, hd, d), H * hd, scale=res_scale),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((L, H, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((L, kv, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((L, kv, hd), dtype=dtype, device=device)
    return p


def _proj(x, w):
    """einsum('bsd,dhk->bshk') as one matrix product."""
    B, S, d = x.shape
    return (x.reshape(B * S, d) @ w.reshape(d, -1)).reshape(
        B, S, *w.shape[1:])


def _out_proj(out, wo):
    """einsum('bshk,hkd->bsd') as one matrix product."""
    B, S, H, hd = out.shape
    return (out.reshape(B * S, H * hd) @ wo.reshape(H * hd, -1)).reshape(
        B, S, -1)


def _project_qkv(p, cfg, x, positions, *, rope: bool):
    """x [B,S,d] -> q [B,S,H,hd], k/v [B,S,KV,hd] (roped if requested)."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if rope and cfg.pos_emb == "rope":
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]  # [B,S,1,hd/2]
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


# =====================================================================
# GQA full-sequence (prefill / forward)
# =====================================================================
def _sdpa(q, k, v, *, causal: bool, window: Optional[int]):
    """Full-sequence attention, always through the flash-attention kernel
    wrapper (the JAX package's XLA blockwise alternative is not a kernel
    and is not ported). q [B,S,H,hd], k/v [B,S,KV,hd] -> [B,S,H,hd]."""
    return kops.flash_attention(q, k, v, causal=causal, window=window or 0)


def gqa_full(p, cfg, x, positions, *, window: Optional[int] = None,
             causal: bool = True):
    """x [B,S,d], positions [B,S] -> [B,S,d]."""
    q, k, v = _project_qkv(p, cfg, x, positions, rope=True)
    out = _sdpa(q, k, v, causal=causal, window=window)
    return _out_proj(out, p["wo"])


# =====================================================================
# GQA decode with a dense KV cache (full or ring / sliding window)
# =====================================================================
def gqa_cache_init(cfg, batch: int, cache_len: int, dtype, device="cuda"):
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_decode(p, cfg, x, cache, pos: int, *, window: Optional[int] = None):
    """x [B,1,d]; cache {k,v [B,L,kv,hd]}; pos an int (the same for every
    row). Without a window the cache holds positions 0..L-1 and this is
    ``gqa_decode_multipos``. With a window the cache is a ring of L
    slots: position ``pos`` writes slot ``pos % L`` (in place) and the
    step attends to every slot written so far, the last L positions
    (slot i holds position ``pos - ((pos - i) mod L)``)."""
    B = x.shape[0]
    if window is None:
        return gqa_decode_multipos(
            p, cfg, x, cache,
            torch.full((B,), int(pos), dtype=torch.long, device=x.device))
    pos = int(pos)
    L = cache["k"].shape[1]
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions, rope=True)
    k, v = cache["k"], cache["v"]
    slot = pos % L
    k[:, slot] = k_new[:, 0].to(k.dtype)
    v[:, slot] = v_new[:, 0].to(v.dtype)

    H, KV, hd = q.shape[2], k.shape[2], cfg.head_dim
    G = H // KV
    qf = q.reshape(B, KV, G, hd).to(k.dtype)
    s = torch.einsum("bkgh,blkh->bkgl", qf, k).float() / math.sqrt(hd)
    idx = torch.arange(L, device=x.device)
    valid = pos - torch.remainder(pos - idx, L) >= 0
    s = torch.where(valid[None, None, None, :], s,
                    torch.full((), NEG_INF, device=x.device))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgl,blkh->bkgh", w.to(v.dtype), v).float()
    out = out.reshape(B, 1, H, hd).to(x.dtype)
    return _out_proj(out, p["wo"]), cache


def gqa_decode_multipos(p, cfg, x, cache, pos_vec):
    """Decode with a PER-ROW position vector (continuous batching).

    x [B,1,d]; cache {k,v [B,L,kv,hd]}; pos_vec [B] int — row b writes
    its K/V at slot pos_vec[b] (in place) and attends to slots
    <= pos_vec[b]. Plain PyTorch: the JAX package has no kernel on this
    path either (``OffloadEngine.generate`` runs it)."""
    B = x.shape[0]
    L = cache["k"].shape[1]
    positions = pos_vec.reshape(B, 1).long()
    q, k_new, v_new = _project_qkv(p, cfg, x, positions, rope=True)

    rows = torch.arange(B, device=x.device)
    k, v = cache["k"], cache["v"]
    k.index_put_((rows, positions[:, 0]), k_new[:, 0].to(k.dtype))
    v.index_put_((rows, positions[:, 0]), v_new[:, 0].to(v.dtype))

    H, KV, hd = q.shape[2], k.shape[2], cfg.head_dim
    G = H // KV
    qf = q.reshape(B, KV, G, hd).to(k.dtype)
    s = torch.einsum("bkgh,blkh->bkgl", qf, k).float() / math.sqrt(hd)
    valid = torch.arange(L, device=x.device)[None, :] <= positions  # [B, L]
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), NEG_INF, device=x.device))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgl,blkh->bkgh", w.to(v.dtype), v).float()
    out = out.reshape(B, 1, H, hd).to(x.dtype)
    return _out_proj(out, p["wo"]), cache


# =====================================================================
# GQA paged decode (block-table KV — continuous serving over a pool)
# =====================================================================
def gqa_paged_cache_init(cfg, num_blocks: int, block_size: int, dtype,
                         device="cuda"):
    """One layer's K/V block pool: [N, bs, kv, hd] (vs dense [B, L, kv, hd])."""
    shape = (num_blocks, block_size, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_decode_paged(p, cfg, x, cache, pos_vec, block_tables):
    """``gqa_decode_multipos`` reading K/V through a block table.

    x [B,1,d]; cache {k,v [N,bs,kv,hd]} (the shared pool); pos_vec [B]
    request-LOCAL positions; block_tables [B,T] int — logical block i
    of row b lives at physical block ``block_tables[b, i]``. Row b's new
    K/V is scattered IN PLACE to (table[pos//bs], pos%bs) with
    ``index_put_``; then the paged attention kernel (``ops.paged_attention``)
    reads the row's keys ``0..pos`` through the table.

    Multi-position append (chunked prefill) contract, as in the JAX
    package: several rows MAY share one request's table at DISTINCT
    consecutive positions — their (block, offset) cells are distinct,
    every scatter lands before the kernel reads the pool (one stream,
    in order), and the mask keeps row j blind to positions > pos_vec[j].
    Inactive rows point at the pool's sink block, so their writes never
    touch a live request's block. Two live rows at the SAME cell remain
    undefined.
    """
    B = x.shape[0]
    bs = cache["k"].shape[1]
    positions = pos_vec.reshape(B, 1).long()
    q, k_new, v_new = _project_qkv(p, cfg, x, positions, rope=True)

    rows = torch.arange(B, device=x.device)
    blk = block_tables[rows, positions[:, 0] // bs].long()
    off = positions[:, 0] % bs
    k, v = cache["k"], cache["v"]
    k.index_put_((blk, off), k_new[:, 0].to(k.dtype))
    v.index_put_((blk, off), v_new[:, 0].to(v.dtype))

    # pos_vec as given (the engines pass int32, the kernel's type, so the
    # wrapper launches no conversion)
    out = kops.paged_attention(q[:, 0], k, v, block_tables,
                               pos_vec.reshape(B))
    out = out[:, None].to(x.dtype)
    return _out_proj(out, p["wo"]), cache
