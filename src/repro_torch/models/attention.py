"""Attention: GQA (projections, the full-sequence path, and decode over
dense, ring (sliding-window) and paged KV caches) and MLA (DeepSeek-V2:
the full-sequence path over K/V materialised from the latent, and the
absorbed decode over a compressed latent cache, dense, ring or paged)
and cross-attention (enc-dec, VLM: MHA over precomputed K/V of the
frontend states). Port of ``repro.models.attention``.

Conventions are the JAX package's: ``x [B, S, d]``; GQA weights
``wq [d,H,hd]``, ``wk/wv [d,KV,hd]``, ``wo [H,hd,d]``; dense cache
``{k,v [B, L, KV, hd]}``; paged pool ``{k,v [N, bs, KV, hd]}``. MLA
weights ``wq [d,H,hd+rd]``, ``w_dkv [d,r]``, ``w_kr [d,rd]``,
``latent_norm [r]``, ``w_kb/w_vb [r,H,hd]``, ``wo [H,hd,d]``; its cache
holds the latent and the one rope key shared by every head,
``{latent [B, L, r], k_rope [B, L, rd]}``, its pool ``{latent [N, bs,
r], k_rope [N, bs, rd]}``.

Under a device mesh (``repro_torch.models.sharding``) the params are
``shard_params``' output, the rank's slice of every weight, and ``x``
the rank's batch rows (the paged decodes scatter every row's new K/V,
gathered over the batch axes, into a pool that holds every row's
blocks); the projections,
``gqa_full``, ``mla_full``, ``gqa_decode`` and ``mla_decode`` then run on
the rank's heads and sum ``wo``'s partial products over the model axis
(one all-reduce). GQA head counts are zero-padded up to a multiple of
the model axis as the JAX package pads them (``_head_padding``): exact,
because the padded rows of ``wo`` are zero. Where the KV heads do not
split, a rank takes the KV heads its query heads group with. The decode
caches are split as ``launch.specs.decode_state_pspecs`` says: KV heads
where they divide, else (GQA, and always for MLA's latent) the
sequence, and then every rank scores its own keys and the softmax is
combined across the model ranks (max, then sums of the exponentials and
of the context). The per-row decodes (``*_multipos``) are the same core
with a position a row. A paged GQA pool holds the rank's KV heads (those
its query heads group with), so ``paged_attention`` runs on the rank's
heads as it is and one block table serves every rank; MLA's latent pool
has no head dim and is whole on every rank. ``cross_attend`` runs the rank's block of the
cross-attention heads, unpadded, where the model axis divides them, over
the rank's rows of the frontend states. Without a mesh all of this is
the identity.

Unlike JAX, the caches are updated IN PLACE (``index_put_``): a decode
step writes its new rows into the tensors it was given and returns the
same dict. That saves copying the whole cache or pool every step.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import sharding as shd
from repro_torch.models.layers import (apply_rope, dense_init, rms_norm,
                                       rope_cos_sin)

NEG_INF = -1e30


# =====================================================================
# head padding and the rank's heads under a mesh
# =====================================================================
def _head_padding(H: int, KV: int):
    """Padded (Hp, KVp) for even model-axis sharding (see
    sharding.padded_count). KV pads to Hp when grouping breaks (MHA)."""
    Hp = shd.padded_count(H)
    KVp = KV if Hp % KV == 0 and (Hp // KV) * KV == Hp else Hp
    if Hp % KVp != 0:
        KVp = Hp
    return Hp, KVp


def _pad_heads(w, target: int, axis: int):
    """Zero heads appended along ``axis`` up to ``target``."""
    if w.shape[axis] == target:
        return w
    shape = list(w.shape)
    shape[axis] = target - w.shape[axis]
    return torch.cat([w, w.new_zeros(shape)], dim=axis)


def _axis_size() -> int:
    m = shd.model_axis()
    return shd.axis_size(m) if m else 1


def _split_heads(n: int):
    """(this rank's heads of ``n``, split): a contiguous block of
    ``n / model`` when the model axis divides ``n``, else every head
    (the spec is sanitized to replicated)."""
    m = shd.model_axis()
    if m is None or n % _axis_size():
        return list(range(n)), False
    size = n // _axis_size()
    lo = shd.axis_index(m) * size
    return list(range(lo, lo + size)), True


def _gqa_heads(H: int, KV: int):
    """(Hp, KVp, q heads, kv heads, split) of this rank: its block of the
    padded query heads, and the padded KV heads they group with — their
    block when the grouping divides it evenly, else one KV head per
    query head."""
    Hp, KVp = _head_padding(H, KV)
    q, split = _split_heads(Hp)
    G = Hp // KVp
    of = [h // G for h in q]
    uniq = sorted(set(of))
    per = len(q) // len(uniq)
    if len(q) % len(uniq) == 0 and of == [uniq[j // per]
                                          for j in range(len(q))]:
        return Hp, KVp, q, uniq, split
    return Hp, KVp, q, of, split


def _rank_heads(w, axis: int, n_pad: int, idx, cut: bool):
    """The heads ``idx`` (of ``n_pad``) of ``shard_params``' slice ``w``
    along ``axis``: ``w`` itself where its spec split the heads (``cut``:
    it is the rank's block), else every head, zero-padded to ``n_pad``
    and narrowed to ``idx``."""
    if cut or list(idx) == list(range(w.shape[axis])):
        return w
    w = _pad_heads(w, n_pad, axis)
    return w.index_select(axis, torch.as_tensor(idx, device=w.device))


def _out_heads(out, wo, split: bool):
    """The rank's heads through its rows of ``wo``, summed over the model
    axis when the heads are split."""
    y = _out_proj(out, wo)
    return shd.psum(y, shd.model_axis()) if split else y


def init_gqa(gen: torch.Generator, cfg, dtype, *, layers: int,
             kv_heads: Optional[int] = None, device="cuda"):
    """Stacked GQA params for ``layers`` layers (JAX init scales);
    ``kv_heads`` defaults to ``cfg.num_kv_heads``."""
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    kv = cfg.num_kv_heads if kv_heads is None else kv_heads
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


def init_mla(gen: torch.Generator, cfg, dtype, *, layers: int,
             device="cuda"):
    """Stacked MLA params for ``layers`` layers (JAX init scales)."""
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    r, rd = cfg.kv_lora_rank, cfg.qk_rope_dim
    L = layers
    res_scale = 1.0 / math.sqrt(2 * cfg.num_layers)

    def init(shape, in_dim, scale=1.0):
        return dense_init(gen, shape, in_dim, scale=scale, dtype=dtype,
                          device=device)

    return {
        "wq": init((L, d, H, hd + rd), d),
        "w_dkv": init((L, d, r), d),
        "w_kr": init((L, d, rd), d),
        "latent_norm": torch.ones((L, r), dtype=dtype, device=device),
        "w_kb": init((L, r, H, hd), r),
        "w_vb": init((L, r, H, hd), r),
        "wo": init((L, H, hd, d), H * hd, scale=res_scale),
    }


def init_cross_attention(gen: torch.Generator, cfg, dtype, *, layers: int,
                         device="cuda"):
    """Cross-attention is MHA (KV heads == query heads) over the frontend
    states."""
    return init_gqa(gen, cfg, dtype, layers=layers, kv_heads=cfg.num_heads,
                    device=device)


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


def _rank_qkv(p, cfg, kv_idx=None):
    """(the rank's q/k/v/o weights and biases under a mesh, split):
    ``_gqa_heads``'s heads, ``kv_idx`` overriding its KV heads; ``p`` as
    is without a mesh."""
    if shd.model_axis() is None:
        return p, False
    H, KV = cfg.num_heads, cfg.num_kv_heads
    Hp, KVp, q, kv, split = _gqa_heads(H, KV)
    kv = kv if kv_idx is None else kv_idx
    # where param_pspecs' spec survives sanitize_spec
    cut_q = shd.model_split(H)
    cut_kv = shd.active_rules().get("shard_kv", True) and shd.model_split(KV)
    out = dict(p)
    for name, ax in (("wq", 1), ("bq", 0)):
        if name in p:
            out[name] = _rank_heads(p[name], ax, Hp, q, cut_q)
    for name, ax in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
        if name in p:
            out[name] = _rank_heads(p[name], ax, KVp, kv, cut_kv)
    out["wo"] = _rank_heads(p["wo"], 0, Hp, q, cut_q)
    return out, split


def _project_qkv(p, cfg, x, positions, *, rope: bool):
    """x [B,S,d] -> q [B,S,H,hd], k/v [B,S,KV,hd] (roped if requested).
    Under a mesh, pass ``_rank_qkv``'s weights: the rank's heads."""
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
    """x [B,S,d], positions [B,S] -> [B,S,d]. Under a mesh: the rank's
    (padded) heads, then one all-reduce after ``wo``."""
    p, split = _rank_qkv(p, cfg)
    q, k, v = _project_qkv(p, cfg, x, positions, rope=True)
    out = _sdpa(q, k, v, causal=causal, window=window)
    return _out_heads(out, p["wo"], split)


# =====================================================================
# GQA decode with a dense KV cache (full or ring / sliding window)
# =====================================================================
def gqa_cache_init(cfg, batch: int, cache_len: int, dtype, device="cuda"):
    """{k, v [batch, cache_len, KVp, hd]}: KVp the KV heads padded as
    under the active mesh (``_head_padding``; KV without one)."""
    _, kv = _head_padding(cfg.num_heads, cfg.num_kv_heads)
    shape = (batch, cache_len, kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


class _Layout(NamedTuple):
    """How the rank's GQA decode meets its dense cache under the active
    mesh (``launch.specs.decode_state_pspecs``): its query heads ``q``
    and the KV heads ``kv`` they group with (``_gqa_heads``), ``split``
    when the query heads are the rank's block, ``split_seq`` when the
    cache holds the rank's block of the sequence, ``all_kv`` when it
    holds every one of the ``KVp`` (padded) KV heads."""
    q: list
    kv: list
    split: bool
    split_seq: bool
    all_kv: bool
    KVp: int


def _gqa_layout(cfg) -> _Layout:
    """The dense cache holds the rank's KV heads where the padded KV count
    divides the model axis, else (``shard_kv``) its block of the sequence
    with every KV head, else (the rules keep the KV heads whole) every
    KV head. Without a mesh: every head, nothing split."""
    m = shd.model_axis()
    _, KVp, q, kv, split = _gqa_heads(cfg.num_heads, cfg.num_kv_heads)
    shard_kv = m is not None and bool(shd.active_rules().get("shard_kv"))
    split_seq = shard_kv and KVp % _axis_size() != 0
    return _Layout(q, kv, split, split_seq, split_seq or not shard_kv, KVp)


def _cache_keys(L_local: int, split_seq: bool):
    """(global position of the rank's first cache slot, the cache's
    global length): its block of the sequence when ``split_seq``."""
    m = shd.model_axis()
    lo = shd.axis_index(m) * L_local if split_seq else 0
    L = L_local * shd.axis_size(m) if split_seq else L_local
    return lo, L


def _check_slot(pos: int, L: int):
    """Without a ring a ``pos`` past the cache's L slots raises, under a
    mesh as the unsharded ``index_put_`` does."""
    if pos >= L:
        raise IndexError(f"position {pos} is out of bounds for a cache of "
                         f"{L} slots")


def _write_rows(caches, news, pos, lo: int, split_seq: bool):
    """Row b's new entries ``news`` [B, ...] at slot ``pos[b]`` (a [B]
    tensor) of the caches [B, L_local, ...], in place. With the sequence
    split the rank holds slots lo .. lo + L_local: a row whose slot lies
    elsewhere writes back what its clamped slot holds (no host sync)."""
    rows = torch.arange(caches[0].shape[0], device=pos.device)
    if not split_seq:
        for c, n in zip(caches, news):
            c.index_put_((rows, pos), n.to(c.dtype))
        return
    slot = pos - lo
    own = (slot >= 0) & (slot < caches[0].shape[1])
    slot = slot.clamp(0, caches[0].shape[1] - 1)
    for c, n in zip(caches, news):
        keep = own.reshape(-1, *[1] * (n.dim() - 1))
        c.index_put_((rows, slot), torch.where(keep, n.to(c.dtype),
                                               c[rows, slot]))


def _row_keys(pos, lo: int, L_local: int):
    """[B, L_local] mask of the rank's slots that hold a position <=
    row b's ``pos[b]`` (``pos`` [B, 1])."""
    return (lo + torch.arange(L_local, device=pos.device))[None, :] <= pos


def _write_ring(caches, news, pos: int, lo: int, L: int):
    """Write the new rows at ring slot ``pos % L`` where this rank holds
    it (slots lo .. lo + local length)."""
    slot = pos % L
    if lo <= slot < lo + caches[0].shape[1]:
        for c, n in zip(caches, news):
            c[:, slot - lo] = n.to(c.dtype)


def _ring_keys(pos: int, lo: int, L_local: int, L: int, device):
    """[1, L_local] mask of the rank's ring slots written so far (slot i
    holds ``pos - ((pos - i) mod L)``)."""
    idx = lo + torch.arange(L_local, device=device)
    return (pos - torch.remainder(pos - idx, L) >= 0)[None]


def _attend(s, values, split_seq: bool):
    """Softmax over the last dim of the scores ``s`` (fp32, masked) and
    the weighted sum ``values(w)``. With the keys split over the model
    axis, every rank holds a block: the row maxima are combined (max; the
    shift cancels, so it is detached), then the sums of the exponentials
    and the unnormalised context (one sum)."""
    if not split_seq:
        return values(torch.softmax(s, dim=-1))
    m = shd.model_axis()
    mx = shd.pmax(s.amax(dim=-1, keepdim=True).detach(), m)
    e = torch.exp(s - mx)
    ctx = values(e)
    both = shd.psum(torch.cat([ctx, e.sum(dim=-1, keepdim=True)], dim=-1),
                    m)
    return both[..., :-1] / both[..., -1:]


def _gqa_rank(p, cfg, lay: _Layout):
    """The rank's weights for a dense-cache decode: its query heads, and
    the KV heads its cache holds (all ``KVp`` of them where it holds
    every one)."""
    return _rank_qkv(p, cfg, list(range(lay.KVp)) if lay.all_kv
                     else None)[0]


def _gqa_attend(pr, x, q, k, v, valid, lay: _Layout):
    """The rank's queries q [B,1,nq,hd] against its dense cache block k/v
    [B,L_local,nk,hd] for the keys ``valid`` [B or 1, L_local] leaves,
    through its rows of ``wo`` -> [B,1,d]. With the sequence split every
    query head meets the rank's keys (the queries gathered where the
    heads are split) and the softmax is combined across the model ranks;
    a cache of every KV head is narrowed to the rank's."""
    B, hd = x.shape[0], q.shape[-1]
    m = shd.model_axis()
    if lay.split_seq and lay.split:    # every query head meets these keys
        q = shd.all_gather(q, m, dim=2)
    if lay.all_kv and not lay.split_seq and lay.kv != list(range(k.shape[2])):
        sel = torch.as_tensor(lay.kv, device=x.device)   # the rank's KV heads
        k, v = k.index_select(2, sel), v.index_select(2, sel)
    nq, nk = q.shape[2], k.shape[2]
    qf = q.reshape(B, nk, nq // nk, hd).to(k.dtype)
    s = torch.einsum("bkgh,blkh->bkgl", qf, k).float() / math.sqrt(hd)
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), NEG_INF, device=x.device))
    out = _attend(s, lambda w: torch.einsum("bkgl,blkh->bkgh", w.to(v.dtype),
                                            v).float(), lay.split_seq)
    out = out.reshape(B, 1, nq, hd)
    if lay.split_seq and lay.split:    # back to the rank's query heads
        out = out[:, :, lay.q[0]:lay.q[-1] + 1]
    return _out_heads(out.to(x.dtype), pr["wo"], lay.split)


def gqa_decode(p, cfg, x, cache, pos: int, *, window: Optional[int] = None):
    """x [B,1,d]; cache {k,v [B,L,kv,hd]}; pos an int (the same for every
    row). Without a window the cache holds positions 0..L-1 and this is
    ``gqa_decode_multipos`` (the JAX package's one decode core), with or
    without a mesh. With a window the cache is a ring of L slots:
    position ``pos`` writes slot ``pos % L`` (in place) and the step
    attends to every slot written so far, the last L positions (slot i
    holds position ``pos - ((pos - i) mod L)``).

    Under a mesh: the rank's heads and cache block. The cache holds the
    rank's KV heads where the padded KV count divides the model axis,
    else its block of the sequence with every KV head (each rank then
    projects every KV head for its write, scores every query head
    against its own keys, and the softmax is combined across the model
    ranks); the context of the rank's query heads goes through its rows
    of ``wo``, summed over the model axis."""
    B = x.shape[0]
    pos = int(pos)
    lay = _gqa_layout(cfg)
    k, v = cache["k"], cache["v"]
    lo, L = _cache_keys(k.shape[1], lay.split_seq)
    if window is None:
        _check_slot(pos, L)
        return gqa_decode_multipos(
            p, cfg, x, cache,
            torch.full((B,), pos, dtype=torch.long, device=x.device))
    pr = _gqa_rank(p, cfg, lay)
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(pr, cfg, x, positions, rope=True)
    _write_ring((k, v), (k_new[:, 0], v_new[:, 0]), pos, lo, L)
    valid = _ring_keys(pos, lo, k.shape[1], L, x.device)
    return _gqa_attend(pr, x, q, k, v, valid, lay), cache


def gqa_decode_multipos(p, cfg, x, cache, pos_vec):
    """Decode with a PER-ROW position vector (continuous batching).

    x [B,1,d]; cache {k,v [B,L,kv,hd]}; pos_vec [B] int — row b writes
    its K/V at slot pos_vec[b] (in place) and attends to slots
    <= pos_vec[b]. Plain PyTorch: the JAX package has no kernel on this
    path either (``OffloadEngine.generate`` runs it).

    Under a mesh the cache is ``gqa_decode``'s (the rank's KV heads, or
    its block of the sequence): a row writes its slot only on the rank
    that holds it, and its valid keys are the rank's slots up to its
    position. A position past the cache raises unsharded (the
    ``index_put_``); with the sequence split its write is skipped, since
    checking a device vector would sync the host (``gqa_decode`` checks
    its int)."""
    B = x.shape[0]
    lay = _gqa_layout(cfg)
    pr = _gqa_rank(p, cfg, lay)
    positions = pos_vec.reshape(B, 1).long()
    q, k_new, v_new = _project_qkv(pr, cfg, x, positions, rope=True)
    k, v = cache["k"], cache["v"]
    lo, _ = _cache_keys(k.shape[1], lay.split_seq)
    _write_rows((k, v), (k_new[:, 0], v_new[:, 0]), positions[:, 0], lo,
                lay.split_seq)
    valid = _row_keys(positions, lo, k.shape[1])
    return _gqa_attend(pr, x, q, k, v, valid, lay), cache


# =====================================================================
# GQA paged decode (block-table KV — continuous serving over a pool)
# =====================================================================
def gqa_paged_cache_init(cfg, num_blocks: int, block_size: int, dtype,
                         device="cuda"):
    """One layer's K/V block pool: [N, bs, kv, hd] (vs dense [B, L, kv,
    hd]). Under the active mesh it is the rank's pool: ``kv`` the KV
    heads its query heads group with (``_gqa_heads``: its block where the
    padded KV count divides the model axis, else the grouped heads it
    shares with the ranks beside it, else one a query head), so that one
    block table serves every rank. Without a mesh every KV head."""
    kv = len(_gqa_heads(cfg.num_heads, cfg.num_kv_heads)[3])
    shape = (num_blocks, block_size, kv, cfg.head_dim)
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

    Under a mesh the pool is the rank's (``gqa_paged_cache_init`` under
    the same mesh): the rank projects its query heads and the KV heads
    its pool holds, the kernel runs on them as it is, and ``wo``'s
    partial products are summed over the model axis. A pool of another
    count of KV heads (allocated under another mesh, or under none)
    raises. Under a batch rule (``sharding.batch_axis``) ``x`` is the
    rank's rows, while ``pos_vec`` and ``block_tables`` are the whole
    batch's: the pool has no row dim and holds every row's blocks on
    every data rank, so the step's new K/V rows are all-gathered over the
    batch axes and every row is scattered on every rank; the kernel then
    reads the rank's rows.
    """
    b = shd.batch_axis()
    pos_r, tables_r = ((shd.batch_rows(pos_vec), shd.batch_rows(block_tables))
                       if b else (pos_vec, block_tables))
    B = x.shape[0]
    pr, split = _rank_qkv(p, cfg)
    positions = pos_r.reshape(B, 1).long()
    q, k_new, v_new = _project_qkv(pr, cfg, x, positions, rope=True)
    k, v = cache["k"], cache["v"]
    if k.shape[2] != k_new.shape[2]:
        raise ValueError(
            f"gqa_decode_paged: the pool holds {k.shape[2]} KV heads, this "
            f"rank's decode {k_new.shape[2]}; allocate it with "
            f"gqa_paged_cache_init under the same mesh")
    _scatter_rows((k, v), (k_new[:, 0], v_new[:, 0]), pos_vec, block_tables,
                  b)

    # pos_vec as given (the engines pass int32, the kernel's type, so the
    # wrapper launches no conversion)
    out = kops.paged_attention(q[:, 0], k, v, tables_r, pos_r.reshape(B))
    return _out_heads(out[:, None].to(x.dtype), pr["wo"], split), cache


def _scatter_rows(pools, news, pos_vec, block_tables, batch_axis):
    """Row b's new entries ``news`` [B, ...] (the rank's rows where
    ``batch_axis`` splits them: gathered over it first, in one
    all-gather) at ``(block_tables[b, pos // bs], pos % bs)`` of each
    pool [N, bs, ...], in place; ``pos_vec`` [B] and ``block_tables``
    [B, T] are the whole batch's."""
    if batch_axis:
        widths = [n.shape[-1] for n in news]
        whole = shd.all_gather(torch.cat(news, dim=-1), batch_axis, 0)
        news = whole.split(widths, dim=-1)
    bs = pools[0].shape[1]
    pos = pos_vec.long()
    rows = torch.arange(pos.shape[0], device=pos.device)
    blk = block_tables[rows, pos // bs].long()
    off = pos % bs
    for t, n in zip(pools, news):
        t.index_put_((blk, off), n.to(t.dtype))


# =====================================================================
# MLA (DeepSeek-V2)
# =====================================================================
def _mla_q(p, cfg, x, positions):
    """x [B,S,d] -> (q_nope [B,S,H,hd], q_rope [B,S,H,rd] roped)."""
    hd, rd = cfg.head_dim, cfg.qk_rope_dim
    q = _proj(x, p["wq"])
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    cos, sin = rope_cos_sin(positions, rd, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos[:, :, None, :], sin[:, :, None, :])
    return q_nope, q_rope


def _mla_latent(p, cfg, x, positions):
    """x [B,S,d] -> (latent [B,S,r] rms-normed, k_rope [B,S,rd] roped:
    one rope key shared by every head)."""
    latent = rms_norm(x @ p["w_dkv"], p["latent_norm"], cfg.norm_eps)
    k_rope = x @ p["w_kr"]
    cos, sin = rope_cos_sin(positions, cfg.qk_rope_dim, cfg.rope_theta)
    k_rope = apply_rope(k_rope[:, :, None, :], cos[:, :, None, :],
                        sin[:, :, None, :])[:, :, 0, :]
    return latent, k_rope


def mla_full(p, cfg, x, positions, *, window: Optional[int] = None,
             causal: bool = True):
    """Prefill / forward path: K/V materialised per head from the latent,
    the rope key broadcast over the heads, then the flash-attention
    kernel with q/k width hd + rd and v width hd (its default scale
    1/sqrt(q.shape[-1]) IS 1/sqrt(hd + rd)). x [B,S,d] -> [B,S,d]."""
    split = shd.model_split(cfg.num_heads)
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    latent, k_rope = _mla_latent(p, cfg, x, positions)
    k_nope = _proj(latent, p["w_kb"])
    v = _proj(latent, p["w_vb"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        *k_rope.shape[:2], q.shape[2], cfg.qk_rope_dim)], dim=-1)
    out = _sdpa(q, k, v, causal=causal, window=window)
    return _out_heads(out, p["wo"], split)


def mla_cache_init(cfg, batch: int, cache_len: int, dtype, device="cuda"):
    return {
        "latent": torch.zeros((batch, cache_len, cfg.kv_lora_rank),
                              dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, cache_len, cfg.qk_rope_dim),
                              dtype=dtype, device=device),
    }


def _mla_attend(p, cfg, x, q_nope, q_rope, latent, k_rope, valid, *,
                split: bool = False, split_seq: bool = False):
    """The absorbed attention over a latent strip: q_nope [B,H,hd] is
    absorbed through w_kb (q_abs [B,H,r]); scores are q_abs . latent +
    q_rope . k_rope over sqrt(hd + rd) for the keys ``valid`` [B or 1, L]
    leaves; the context is formed in latent space and expanded through
    w_vb. latent [B,L,r], k_rope [B,L,rd] -> [B,1,d].

    Under a mesh ``split`` says the rank holds a block of the heads (its
    ``wo`` rows summed over the model axis) and ``split_seq`` that the
    strip is its block of the sequence: the queries of every head
    (gathered where the heads are split) score the rank's keys, the
    softmax is combined across the model ranks (``_attend``), and the
    rank's heads of the context [B, H, r] go on through ``w_vb``."""
    cdt = latent.dtype
    m = shd.model_axis()
    gather = split and split_seq
    q_abs = torch.einsum("bhk,rhk->bhr", q_nope, p["w_kb"]).float()
    if gather:                         # every head meets these keys
        q_abs = shd.all_gather(q_abs, m, dim=1)
        q_rope = shd.all_gather(q_rope.contiguous(), m, dim=1)
    s = torch.einsum("bhr,blr->bhl", q_abs.to(cdt), latent).float()
    s = s + torch.einsum("bhk,blk->bhl", q_rope.to(cdt), k_rope).float()
    s = s / math.sqrt(cfg.head_dim + cfg.qk_rope_dim)
    s = torch.where(valid[:, None, :], s,
                    torch.full((), NEG_INF, device=x.device))
    ctx = _attend(s, lambda w: torch.einsum("bhl,blr->bhr", w.to(cdt),
                                            latent).float(), split_seq)
    if gather:                         # back to the rank's heads
        h = p["w_vb"].shape[1]
        ctx = ctx.narrow(1, shd.axis_index(m) * h, h)
    out = torch.einsum("bhr,rhk->bhk", ctx.to(p["w_vb"].dtype),
                       p["w_vb"]).float()
    return _out_heads(out[:, None].to(x.dtype), p["wo"], split)


def _mla_split_seq() -> bool:
    """Whether the rank's latent and rope-key caches are its block of the
    sequence (``mla_seq_shard``, the default under a model axis)."""
    return shd.model_axis() is not None and bool(
        shd.active_rules().get("mla_seq_shard", True))


def mla_decode(p, cfg, x, cache, pos: int, *, window: Optional[int] = None):
    """Absorbed decode: x [B,1,d]; cache {latent [B,L,r], k_rope
    [B,L,rd]} — only the compressed latent and the shared rope key are
    cached, the MLA memory win; pos an int (the same for every row).
    Without a window this is ``mla_decode_multipos``, with or without a
    mesh; with one the cache is a ring of L slots, as in ``gqa_decode``.

    Under a mesh: the rank's heads, and the latent and rope-key caches
    hold the rank's block of the sequence (``mla_seq_shard``, the
    default; else the whole cache). Only the rank that holds slot
    ``pos`` writes it, and ``_mla_attend`` combines the softmax across
    the model ranks."""
    B = x.shape[0]
    pos = int(pos)
    split_seq = _mla_split_seq()
    latent, k_rope = cache["latent"], cache["k_rope"]
    lo, L = _cache_keys(latent.shape[1], split_seq)
    if window is None:
        _check_slot(pos, L)
        return mla_decode_multipos(
            p, cfg, x, cache,
            torch.full((B,), pos, dtype=torch.long, device=x.device))
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    latent_new, k_rope_new = _mla_latent(p, cfg, x, positions)
    _write_ring((latent, k_rope), (latent_new[:, 0], k_rope_new[:, 0]),
                pos, lo, L)
    valid = _ring_keys(pos, lo, latent.shape[1], L, x.device)
    y = _mla_attend(p, cfg, x, q_nope[:, 0], q_rope[:, 0], latent, k_rope,
                    valid, split=shd.model_split(cfg.num_heads),
                    split_seq=split_seq)
    return y, cache


def mla_decode_multipos(p, cfg, x, cache, pos_vec):
    """Absorbed MLA decode with a per-row position vector [B] (the
    contract of ``gqa_decode_multipos``; windows stay on the scalar-pos
    ring path). Row b writes its latent and rope key at slot pos_vec[b]
    (in place) and attends to slots <= pos_vec[b]. Under a mesh the
    caches are ``mla_decode``'s: a row writes its slot only on the rank
    that holds it, and the softmax is combined across the model ranks
    where the sequence is split."""
    B = x.shape[0]
    split_seq = _mla_split_seq()
    positions = pos_vec.reshape(B, 1).long()
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    latent_new, k_rope_new = _mla_latent(p, cfg, x, positions)
    latent, k_rope = cache["latent"], cache["k_rope"]
    lo, _ = _cache_keys(latent.shape[1], split_seq)
    _write_rows((latent, k_rope), (latent_new[:, 0], k_rope_new[:, 0]),
                positions[:, 0], lo, split_seq)
    valid = _row_keys(positions, lo, latent.shape[1])
    y = _mla_attend(p, cfg, x, q_nope[:, 0], q_rope[:, 0], latent, k_rope,
                    valid, split=shd.model_split(cfg.num_heads),
                    split_seq=split_seq)
    return y, cache


# =====================================================================
# MLA paged decode (block-table latent pool)
# =====================================================================
def mla_paged_cache_init(cfg, num_blocks: int, block_size: int, dtype,
                         device="cuda"):
    """One layer's latent block pool: [N, bs, r] + [N, bs, rd]."""
    return {
        "latent": torch.zeros((num_blocks, block_size, cfg.kv_lora_rank),
                              dtype=dtype, device=device),
        "k_rope": torch.zeros((num_blocks, block_size, cfg.qk_rope_dim),
                              dtype=dtype, device=device),
    }


def mla_decode_paged(p, cfg, x, cache, pos_vec, block_tables):
    """Absorbed MLA decode through a block table: the layout, sink-block
    and multi-position append contracts of ``gqa_decode_paged``, with
    the row's gathered [T*bs] strip standing in for the dense [L] latent
    cache. Row b's latent and rope key are scattered IN PLACE to
    (table[pos//bs], pos%bs), then the strip is gathered through the
    table and attended as in ``mla_decode_multipos`` — with plain
    PyTorch ops, as the JAX package runs it (it has no paged MLA
    kernel). With T*bs equal to the dense cache's L, paged and dense
    decode are the same arithmetic on the same values.

    Under a mesh the pool has no head dim and stays whole on every rank:
    every rank writes the same rows, and the rank's heads attend over the
    whole strip (no softmax combine), summed after ``wo``. Under a batch
    rule, the contract of ``gqa_decode_paged``: ``x``
    the rank's rows, ``pos_vec`` and ``block_tables`` the whole batch's,
    the new rows gathered over the batch axes and scattered on every
    rank, the rank's rows attended."""
    b = shd.batch_axis()
    pos_r, tables_r = ((shd.batch_rows(pos_vec), shd.batch_rows(block_tables))
                       if b else (pos_vec, block_tables))
    B = x.shape[0]
    positions = pos_r.reshape(B, 1).long()
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    latent_new, k_rope_new = _mla_latent(p, cfg, x, positions)
    latent, k_rope = cache["latent"], cache["k_rope"]
    _scatter_rows((latent, k_rope), (latent_new[:, 0], k_rope_new[:, 0]),
                  pos_vec, block_tables, b)

    bs, T = latent.shape[1], tables_r.shape[1]
    tables = tables_r.long()
    lg = latent[tables].reshape(B, T * bs, latent.shape[-1])
    rg = k_rope[tables].reshape(B, T * bs, k_rope.shape[-1])
    valid = torch.arange(T * bs, device=x.device)[None, :] <= positions
    y = _mla_attend(p, cfg, x, q_nope[:, 0], q_rope[:, 0], lg, rg, valid,
                    split=shd.model_split(cfg.num_heads))
    return y, cache


# =====================================================================
# Cross-attention (enc-dec, VLM)
# =====================================================================
def cross_rank(p, cfg):
    """The rank's cross-attention weights: ``p`` (``shard_params``'
    slice) with ``wk``/``wv``/``bk``/``bv``, where the rules keep them
    whole while the model axis divides the H heads, narrowed to the
    rank's block, so that ``cross_kv`` computes K/V for those heads
    alone. ``p`` as is without a mesh."""
    idx, split = _split_heads(cfg.num_heads)
    if not split or p["wk"].shape[1] == len(idx):
        return p
    out = dict(p)
    for name, ax in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
        if name in p:
            out[name] = p[name].narrow(ax, idx[0], len(idx))
    return out


def cross_kv(p, enc):
    """Precompute K/V over frontend states enc [B,T,d], over whatever
    heads ``p`` holds (under a mesh, ``cross_rank``'s: the rank's heads
    where the model axis divides them)."""
    k, v = _proj(enc, p["wk"]), _proj(enc, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return {"k": k, "v": v}


def cross_attend(p, cfg, x, kv):
    """x [B,S,d] queries attend over precomputed kv (no mask). Cross-
    attention is MHA and, as in the JAX package, its heads are never
    padded: under a mesh whose model axis divides H the rank runs its
    block of the heads (``cross_rank``'s weights, ``kv`` over the same
    block) and sums ``wo``'s partial products over the model axis (one
    all-reduce); else every rank runs every head and nothing is summed."""
    split = shd.model_split(cfg.num_heads)
    q = _proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    out = _sdpa(q, kv["k"], kv["v"], causal=False, window=None)
    return _out_heads(out, p["wo"], split)
