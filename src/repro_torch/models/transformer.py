"""Model params, the full-sequence forward / prefill and the decode step
of the ``dense``, ``moe`` and ``ssm`` families (port of
``repro.models.transformer``).

Params are a plain dict with the JAX package's tree and layouts, layers
stacked on a leading ``[L]`` axis::

    {"embed" [V,d], "final_norm" [d], "unembed" [d,V] (untied only),
     "layers": {"ln1" [L,d],
                "attn": {wq [L,d,H,hd], wk/wv [L,d,KV,hd], wo [L,H,hd,d],
                         bq/bk/bv (QKV bias only)},      # dense, moe
                        # or, with use_mla (DeepSeek-V2):
                        {wq [L,d,H,hd+rd], w_dkv [L,d,r], w_kr [L,d,rd],
                         latent_norm [L,r], w_kb/w_vb [L,r,H,hd],
                         wo [L,H,hd,d]},
                "ln2" [L,d],                              # dense, moe
                "mlp": {w1/w3 [L,d,ff], w2 [L,ff,d]},     # dense
                "moe": {"router" [L,d,E],                 # moe
                        "experts": {w1/w3 [L,E,d,ff], w2 [L,E,ff,d]},
                        "shared": {w1/w3 [L,d,sff], w2 [L,sff,d]}},
                                          # (num_shared_experts > 0:
                                          # one SwiGLU, sff = n * ff)
                "ssm": {in_z, in_xbc, in_dt, conv_w, conv_b, A_log,
                        D, dt_bias, norm, out_proj}}}      # ssm

``from_jax_params`` / ``to_jax_params`` move such a tree between numpy
(the JAX package's params via ``np.asarray``) and torch, bit for bit.
The JAX package scans over the stacked layers; the port loops over
them in Python and runs eagerly. Attention is GQA or, with
``cfg.use_mla``, MLA (dispatched here as in the JAX package). The
hybrid, encdec and vlm families come with later slices (ROADMAP.md).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (embed_init, init_swiglu, rms_norm,
                                       sinusoidal_positions, swiglu)

FAMILIES = ("dense", "moe", "ssm")


def _param_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_supported(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; the "
            f"port runs {FAMILIES} (ROADMAP.md open items: hybrid, "
            f"cross-attention for encdec/vlm)")


def init_params(cfg, gen: torch.Generator, dtype=None, device="cuda"):
    """Random params for a dense, MoE or SSM decoder, drawn from ``gen``
    (a generator on ``device``) with the JAX package's init scales. The
    draws differ from JAX's: tests that compare the two bridge JAX's
    params with ``from_jax_params`` instead."""
    _check_supported(cfg)
    dtype = dtype or _param_dtype(cfg)
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    params: Dict[str, Any] = {
        "embed": embed_init(gen, (V, d), dtype, device=device),
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, (d, V), dtype, device=device)
    layers: Dict[str, Any] = {
        "ln1": torch.ones((L, d), dtype=dtype, device=device)}
    if cfg.family == "ssm":
        layers["ssm"] = ssm_lib.init_ssm(gen, cfg, dtype, layers=L,
                                         device=device)
    else:
        init_attn = attn.init_mla if cfg.use_mla else attn.init_gqa
        layers["attn"] = init_attn(gen, cfg, dtype, layers=L, device=device)
        layers["ln2"] = torch.ones((L, d), dtype=dtype, device=device)
        if cfg.is_moe:
            layers["moe"] = moe_lib.init_moe(gen, cfg, dtype, layers=L,
                                             device=device)
        else:
            layers["mlp"] = init_swiglu(gen, d, cfg.d_ff, L, dtype,
                                        layers=L, device=device)
    params["layers"] = layers
    return params


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _np_to_torch(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bf16: same 16 bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_jax_params(np_tree, device="cuda"):
    """The JAX package's param tree (leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as torch tensors on
    ``device``, same tree, same layouts ([L,...] stacked layers,
    [L,E,d,ff] experts), same bits."""
    return _tree_map(lambda a: _np_to_torch(a, device), np_tree)


def to_jax_params(tree):
    """Inverse of ``from_jax_params``: torch tensors -> numpy arrays
    (float32 and the other dtypes numpy shares with torch)."""
    return _tree_map(lambda t: t.detach().cpu().numpy(), tree)


def unembed_matrix(params):
    return params["unembed"] if "unembed" in params else params["embed"].T


def logits_from_hidden(params, cfg, h):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return (h @ unembed_matrix(params)).float()


def _layer(stacked, i: int):
    """Layer i's params: a view of every stacked [L, ...] leaf."""
    return _tree_map(lambda t: t[i], stacked)


# =====================================================================
# full-sequence blocks
# =====================================================================
def _attn_full(p, cfg, h, positions, window):
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    full = attn.mla_full if cfg.use_mla else attn.gqa_full
    return h + full(p["attn"], cfg, x, positions, window=window)


def _ffn_full(p, cfg, h, moe_path):
    """The block's FFN half: (h, aux). SSM blocks have none."""
    if cfg.family == "ssm":
        return h, 0.0
    x = rms_norm(h, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        y, aux = moe_lib.moe_apply(p["moe"], cfg, x, path=moe_path)
        return h + y, aux
    return h + swiglu(p["mlp"], x), 0.0


def _block_full(p, cfg, h, positions, *, window, moe_path):
    if cfg.family == "ssm":
        h = h + ssm_lib.ssd_full(p["ssm"], cfg,
                                 rms_norm(h, p["ln1"], cfg.norm_eps))
    else:
        h = _attn_full(p, cfg, h, positions, window)
    return _ffn_full(p, cfg, h, moe_path)


def _embed(params, cfg, tokens, positions):
    h = params["embed"][tokens]
    if cfg.pos_emb == "sinusoidal":
        h = h + sinusoidal_positions(positions, cfg.d_model).to(h.dtype)
    return h


def forward(params, cfg, tokens, *, window: Optional[int] = None,
            moe_path: str = "auto"):
    """tokens [B,S] -> (hidden [B,S,d] before the final norm, aux_loss
    fp32 scalar)."""
    _check_supported(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    h = _embed(params, cfg, tokens, positions)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.num_layers):
        h, a = _block_full(_layer(params["layers"], i), cfg, h, positions,
                           window=window, moe_path=moe_path)
        aux = aux + a
    return h, aux


def prefill(params, cfg, tokens, *, moe_path: str = "auto"):
    """Full forward returning last-position logits [B, V] (no [B,S,V])."""
    h, _ = forward(params, cfg, tokens, moe_path=moe_path)
    return logits_from_hidden(params, cfg, h[:, -1:, :])[:, 0]


# =====================================================================
# decode state and blocks
# =====================================================================
def init_decode_state(params, cfg, batch: int, cache_len: int, *,
                      dtype=None, device="cuda"):
    """Decode state, one entry per layer: ``{"layers": [cache] * L}`` with
    a dense KV cache ``{k,v [B,cache_len,KV,hd]}`` per attention layer
    (MLA: ``{latent [B,cache_len,r], k_rope [B,cache_len,rd]}``) or an
    SSM state ``{ssd [B,H,P,N] fp32, conv [B,W-1,di+2N]}`` per SSM
    layer (the JAX package stacks them on [L]; the port keeps one entry
    per layer, since decode updates KV caches in place)."""
    _check_supported(cfg)
    dtype = dtype or _param_dtype(cfg)
    if cfg.family == "ssm":
        layers = [ssm_lib.ssm_state_init(cfg, batch, dtype, device=device)
                  for _ in range(cfg.num_layers)]
    else:
        init = attn.mla_cache_init if cfg.use_mla else attn.gqa_cache_init
        layers = [init(cfg, batch, cache_len, dtype, device=device)
                  for _ in range(cfg.num_layers)]
    return {"layers": layers}


def _attn_decode(p, cfg, h, cache, pos, window):
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    decode = attn.mla_decode if cfg.use_mla else attn.gqa_decode
    y, cache = decode(p["attn"], cfg, x, cache, pos, window=window)
    return h + y, cache


def _block_decode(p, cfg, h, cache, pos, *, window, moe_path):
    if cfg.family == "ssm":
        y, cache = ssm_lib.ssd_decode(p["ssm"], cfg,
                                      rms_norm(h, p["ln1"], cfg.norm_eps),
                                      cache)
        h = h + y
    else:
        h, cache = _attn_decode(p, cfg, h, cache, pos, window)
    h, _ = _ffn_full(p, cfg, h, moe_path)
    return h, cache


def decode_step(params, cfg, state, token, pos: int, *,
                window: Optional[int] = None, moe_path: str = "auto"):
    """token [B,1] int, pos an int (the same for every row) -> (logits
    [B,V], new state). KV caches are updated in place; SSM states are
    replaced in the returned state's list."""
    B = token.shape[0]
    positions = torch.full((B, 1), int(pos), dtype=torch.long,
                           device=token.device)
    h = _embed(params, cfg, token, positions)
    caches = []
    for i, cache in enumerate(state["layers"]):
        h, cache = _block_decode(_layer(params["layers"], i), cfg, h, cache,
                                 pos, window=window, moe_path=moe_path)
        caches.append(cache)
    new_state = dict(state)
    new_state["layers"] = caches
    return logits_from_hidden(params, cfg, h)[:, 0], new_state


def _attn_decode_multipos(p, cfg, h, cache, pos_vec):
    """Per-row-position decode (continuous batching): pos_vec [B]."""
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    decode = (attn.mla_decode_multipos if cfg.use_mla
              else attn.gqa_decode_multipos)
    y, cache = decode(p["attn"], cfg, x, cache, pos_vec)
    return h + y, cache


def _attn_decode_paged(p, cfg, h, cache, pos_vec, block_tables):
    """Per-row-position decode over a paged KV pool: ``cache`` is one
    layer's block pool and ``block_tables [B, T]`` maps each row's
    logical blocks to physical ones (see ``repro_torch.core.paged_kv``).
    Rows may share a table at distinct positions (chunked prefill's
    virtual rows) — see ``attention.gqa_decode_paged``."""
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    decode = attn.mla_decode_paged if cfg.use_mla else attn.gqa_decode_paged
    y, cache = decode(p["attn"], cfg, x, cache, pos_vec, block_tables)
    return h + y, cache
