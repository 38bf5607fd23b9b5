"""Model params and the decode-side blocks of the ``moe`` family (port of
the decode half of ``repro.models.transformer``).

Params are a plain dict with the JAX package's tree and layouts, layers
stacked on a leading ``[L]`` axis::

    {"embed" [V,d], "final_norm" [d], "unembed" [d,V],
     "layers": {"ln1" [L,d], "attn": {wq [L,d,H,hd], wk/wv [L,d,KV,hd],
                                      wo [L,H,hd,d]},
                "ln2" [L,d], "moe": {"router" [L,d,E],
                                     "experts": {w1/w3 [L,E,d,ff],
                                                 w2 [L,E,ff,d]}}}}

``from_jax_params`` / ``to_jax_params`` move such a tree between numpy
(the JAX package's params via ``np.asarray``) and torch, bit for bit.
Full-sequence forward, prefill and the other families come with later
slices (ROADMAP.md).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import embed_init, rms_norm


def _param_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_supported(cfg) -> None:
    if cfg.family != "moe" or cfg.use_mla:
        raise NotImplementedError(
            f"{cfg.name}: the port serves the GQA 'moe' family so far "
            f"(ROADMAP.md queue A: MLA, full-sequence and SSM families)")


def init_params(cfg, gen: torch.Generator, dtype=None, device="cuda"):
    """Random params for an MoE decoder, drawn from ``gen`` (a generator
    on ``device``) with the JAX package's init scales. The draws differ
    from JAX's: tests that compare the two bridge JAX's params with
    ``from_jax_params`` instead."""
    _check_supported(cfg)
    dtype = dtype or _param_dtype(cfg)
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    params: Dict[str, Any] = {
        "embed": embed_init(gen, (V, d), dtype, device=device),
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, (d, V), dtype, device=device)
    params["layers"] = {
        "ln1": torch.ones((L, d), dtype=dtype, device=device),
        "attn": attn.init_gqa(gen, cfg, dtype, layers=L, device=device),
        "ln2": torch.ones((L, d), dtype=dtype, device=device),
        "moe": moe_lib.init_moe(gen, cfg, dtype, layers=L, device=device),
    }
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


# =====================================================================
# decode state and blocks
# =====================================================================
def init_decode_state(params, cfg, batch: int, cache_len: int, *,
                      dtype=None, device="cuda"):
    """Dense decode caches, one per layer: ``{"layers": [{k,v
    [B,cache_len,KV,hd]}] * L}`` (the JAX package stacks them on [L]
    and the engine unstacks; the port keeps the engine's form, since
    decode updates each layer's cache in place)."""
    _check_supported(cfg)
    dtype = dtype or _param_dtype(cfg)
    return {"layers": [attn.gqa_cache_init(cfg, batch, cache_len, dtype,
                                           device=device)
                       for _ in range(cfg.num_layers)]}


def _attn_decode_multipos(p, cfg, h, cache, pos_vec):
    """Per-row-position decode (continuous batching): pos_vec [B]."""
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    y, cache = attn.gqa_decode_multipos(p["attn"], cfg, x, cache, pos_vec)
    return h + y, cache


def _attn_decode_paged(p, cfg, h, cache, pos_vec, block_tables):
    """Per-row-position decode over a paged KV pool: ``cache`` is one
    layer's block pool and ``block_tables [B, T]`` maps each row's
    logical blocks to physical ones (see ``repro_torch.core.paged_kv``).
    Rows may share a table at distinct positions (chunked prefill's
    virtual rows) — see ``attention.gqa_decode_paged``."""
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    y, cache = attn.gqa_decode_paged(p["attn"], cfg, x, cache, pos_vec,
                                     block_tables)
    return h + y, cache
