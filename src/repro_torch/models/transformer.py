"""Model params, the full-sequence forward / prefill and the decode step
of every architecture family (port of ``repro.models.transformer``).

Params are a plain dict with the JAX package's tree and layouts. Layers
are stacked on leading axes, in homogeneous groups::

  dense/moe/ssm : "layers" [L]
  hybrid        : periods of ``attn_every``: "attn_layers" [P] and
                  "ssm_layers", a tuple of ``attn_every - 1`` stacks [P]
                  (position j of a period has MoE iff ``cfg.has_moe(j)``)
  vlm           : periods of ``cross_attn_every``: "layers" [P, per]
                  and "cross_layers" [P] (self-attention, then
                  ``ln_c`` / ``cross``, then the FFN)
  encdec        : "enc_layers" [Le], "enc_norm", and the decoder's
                  "layers" [L] with cross-attention

A block's leaves, each with the group's leading axes::

    {"ln1" [d],
     "attn": {wq [d,H,hd], wk/wv [d,KV,hd], wo [H,hd,d],
              bq/bk/bv (QKV bias only)},           # kind "attn"
             # or, with use_mla (DeepSeek-V2):
             {wq [d,H,hd+rd], w_dkv [d,r], w_kr [d,rd], latent_norm [r],
              w_kb/w_vb [r,H,hd], wo [H,hd,d]},
     "ssm": {in_z, in_xbc, in_dt, conv_w, conv_b, A_log,
             D, dt_bias, norm, out_proj},           # kind "ssm"
     "ln_c" [d], "cross": {wq, wk/wv [d,H,hd], wo, biases},  # cross blocks
     "ln2" [d],                                     # all but family ssm
     "mlp": {w1/w3 [d,ff], w2 [ff,d]},              # dense SwiGLU
            # or, encdec: GELU {w1 [d,ff], b1 [ff], w2 [ff,d], b2 [d]}
     "moe": {"router" [d,E], "experts": {w1/w3 [E,d,ff], w2 [E,ff,d]},
             "shared": {w1/w3 [d,sff], w2 [sff,d]}}}  # (shared: sff =
                                                      # n * ff)

plus "embed" [V,d], "final_norm" [d] and "unembed" [d,V] (untied only).
``from_jax_params`` / ``to_jax_params`` move such a tree between numpy
(the JAX package's params via ``np.asarray``) and torch, bit for bit.
The JAX package scans over the stacked layers; the port loops over
them in Python and runs eagerly. ``forward(remat=True)`` recomputes
each block (hybrid, vlm: each period) in the backward pass, through
``torch.utils.checkpoint``, where JAX wraps the scan body in
``jax.checkpoint``; ``loss_fn`` is the training loss. A block dispatches on its mixer kind
(attention or SSM) and on the params it holds (cross-attention, MoE);
attention is GQA or, with ``cfg.use_mla``, MLA.

Under a device mesh (``sharding.sharding_ctx``; the params cut by
``sharding.shard_params``, the decode state by
``launch.specs.shard_decode_state``) ``forward``, ``prefill`` and
``decode_step`` run the dense, moe, ssm and hybrid families
tensor-parallel: they take the whole batch, each rank computes its batch
rows (the "batch" rule), gathers the embedding's d blocks, runs its
heads, ff blocks and experts (see ``attention``, ``moe`` and ``ssm``:
the SSD mixer by head, its ``ssd`` state the rank's heads, the conv
state whole), and the vocab-split logits and the rows are gathered back,
so every rank returns what the call returns without a mesh. The encdec
and vlm families run so too: ``encoder_forward`` runs the rank's rows of
the frames (its heads of the non-causal self-attention, its ff block of
the GELU MLP, ``b2`` added once after the all-reduce) and gathers the
rows back; ``forward`` and ``prefill`` cut the encoder states or patch
embeddings to the rank's rows with the tokens; and cross-attention runs
the rank's heads over them (``attention.cross_attend``; the decode
state's ``cross_kv`` holds the rank's rows and heads). ``loss_fn``
runs each rank's rows and its vocab block of the cross entropy, and
returns the whole batch's loss on every rank; its gradients are the
rank's part, which ``training.train_loop`` sums over the ranks (onto the
rank's data block of the moments, for a ZeRO-1 config). The per-row
and paged decodes (``_attn_decode_multipos`` / ``_attn_decode_paged``,
the offload engine's) take the rank's params as they are and run the
rank's heads over its dense cache block or its pool of KV heads (see
``attention``); their rows are whole.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import sharding as shd
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (chunked_softmax_xent, embed_init,
                                       gelu_tp, init_gelu_mlp, init_swiglu,
                                       rms_norm, sinusoidal_positions,
                                       swiglu_tp)

AUX_WEIGHT = 0.01


def _param_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _init_block(gen, cfg, dtype, *, kind: str, cross: bool, layers: int,
                use_moe: Optional[bool] = None, device="cuda"):
    """``layers`` stacked blocks: a ``kind`` mixer ("attn" or "ssm"),
    cross-attention if ``cross``, and (all but the ssm family) an FFN:
    GELU for encdec, else MoE if ``use_moe`` (default ``cfg.is_moe``),
    else SwiGLU."""
    if use_moe is None:
        use_moe = cfg.is_moe
    d, L = cfg.d_model, layers
    kw = dict(layers=L, device=device)
    p: Dict[str, Any] = {"ln1": torch.ones((L, d), dtype=dtype,
                                           device=device)}
    if kind == "attn":
        init_attn = attn.init_mla if cfg.use_mla else attn.init_gqa
        p["attn"] = init_attn(gen, cfg, dtype, **kw)
    else:
        p["ssm"] = ssm_lib.init_ssm(gen, cfg, dtype, **kw)
    if cross:
        p["ln_c"] = torch.ones((L, d), dtype=dtype, device=device)
        p["cross"] = attn.init_cross_attention(gen, cfg, dtype, **kw)
    if cfg.family != "ssm":
        p["ln2"] = torch.ones((L, d), dtype=dtype, device=device)
        if cfg.family == "encdec":
            p["mlp"] = init_gelu_mlp(gen, d, cfg.d_ff, cfg.num_layers, dtype,
                                     **kw)
        elif use_moe:
            p["moe"] = moe_lib.init_moe(gen, cfg, dtype, **kw)
        else:
            p["mlp"] = init_swiglu(gen, d, cfg.d_ff, cfg.num_layers, dtype,
                                   **kw)
    return p


def init_params(cfg, gen: torch.Generator, dtype=None, device="cuda"):
    """Random params of any family, drawn from ``gen`` (a generator on
    ``device``) with the JAX package's tree and init scales. The draws
    differ from JAX's: tests that compare the two bridge JAX's params
    with ``from_jax_params`` instead."""
    dtype = dtype or _param_dtype(cfg)
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    params: Dict[str, Any] = {
        "embed": embed_init(gen, (V, d), dtype, device=device),
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, (d, V), dtype, device=device)

    fam = cfg.family
    if fam != "hybrid" and cfg.is_moe:
        assert cfg.moe_every == 1, "moe_every>1 only supported for hybrid"
    kw = dict(dtype=dtype, device=device)
    if fam in ("dense", "moe", "ssm"):
        params["layers"] = _init_block(
            gen, cfg, kind="ssm" if fam == "ssm" else "attn", cross=False,
            layers=L, **kw)
    elif fam == "hybrid":
        P, per = L // cfg.attn_every, cfg.attn_every - 1
        # the FFN rhythm (dense vs MoE) must repeat with the period
        assert cfg.attn_every % max(cfg.moe_every, 1) == 0
        params["attn_layers"] = _init_block(
            gen, cfg, kind="attn", cross=False, layers=P,
            use_moe=cfg.has_moe(0), **kw)
        params["ssm_layers"] = tuple(
            _init_block(gen, cfg, kind="ssm", cross=False, layers=P,
                        use_moe=cfg.has_moe(j + 1), **kw)
            for j in range(per))
    elif fam == "vlm":
        P, per = L // cfg.cross_attn_every, cfg.cross_attn_every - 1
        plain = _init_block(gen, cfg, kind="attn", cross=False,
                            layers=P * per, **kw)
        params["layers"] = _tree_map(
            lambda t: t.reshape(P, per, *t.shape[1:]), plain)
        params["cross_layers"] = _init_block(gen, cfg, kind="attn",
                                             cross=True, layers=P, **kw)
    elif fam == "encdec":
        params["enc_layers"] = _init_block(
            gen, cfg, kind="attn", cross=False, layers=cfg.encoder_layers,
            **kw)
        params["enc_norm"] = torch.ones((d,), dtype=dtype, device=device)
        params["layers"] = _init_block(gen, cfg, kind="attn", cross=True,
                                       layers=L, **kw)
    else:
        raise ValueError(f"unknown family {fam}")
    return params


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
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
    """Final norm and unembedding -> fp32 logits. Under a mesh: the
    vocab-split ``unembed``'s logits gathered over the model axis, or,
    tied, the rank's d block of the embedding against its block of
    ``h``, summed over it."""
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    m = shd.model_axis()
    if "unembed" in params and shd.model_split(cfg.vocab_size):
        return shd.all_gather((h @ params["unembed"]).float(), m, -1)
    if "unembed" not in params and shd.model_split(cfg.d_model):
        emb = params["embed"]
        lo = shd.axis_index(m) * emb.shape[1]
        return shd.psum((h[..., lo:lo + emb.shape[1]] @ emb.T).float(), m)
    return (h @ unembed_matrix(params)).float()


def _layer(stacked, i: int):
    """Layer i's params: a view of every stacked [L, ...] leaf (of a
    [P, per] stack: period i's [per, ...] stack)."""
    return _tree_map(lambda t: t[i], stacked)


def _stack_len(stacked) -> int:
    """The leading (layer) axis of a stack of blocks."""
    return stacked["ln1"].shape[0]


# =====================================================================
# full-sequence blocks
# =====================================================================
def _attn_full(p, cfg, h, positions, window):
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    full = attn.mla_full if cfg.use_mla else attn.gqa_full
    return h + full(p["attn"], cfg, x, positions, window=window)


def _enc_attn_full(p, cfg, h, positions):
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    return h + attn.gqa_full(p["attn"], cfg, x, positions, window=None,
                             causal=False)


def _cross_full(p, cfg, h, enc):
    x = rms_norm(h, p["ln_c"], cfg.norm_eps)
    c = attn.cross_rank(p["cross"], cfg)
    return h + attn.cross_attend(c, cfg, x, attn.cross_kv(c, enc))


def _ffn_full(p, cfg, h, moe_path):
    """The block's FFN half: (h, aux). The ssm family's blocks have none
    (a hybrid's SSM blocks do)."""
    if cfg.family == "ssm":
        return h, 0.0
    x = rms_norm(h, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        y, aux = moe_lib.moe_apply(p["moe"], cfg, x, path=moe_path)
        return h + y, aux
    if cfg.family == "encdec":
        return h + gelu_tp(p["mlp"], x, cfg.d_ff), 0.0
    return h + swiglu_tp(p["mlp"], x, cfg.d_ff), 0.0


def _block_full(p, cfg, h, positions, *, kind, window, enc, moe_path):
    if kind == "attn":
        h = _attn_full(p, cfg, h, positions, window)
    else:
        h = h + ssm_lib.ssd_full(p["ssm"], cfg,
                                 rms_norm(h, p["ln1"], cfg.norm_eps))
    if "cross" in p:
        h = _cross_full(p, cfg, h, enc)
    return _ffn_full(p, cfg, h, moe_path)


def _embed(params, cfg, tokens, positions):
    """Token embeddings (+ sinusoidal positions). Under a mesh the
    embedding's d blocks are gathered over the model axis."""
    if shd.model_split(cfg.d_model):
        h = shd.all_gather(params["embed"][tokens], shd.model_axis(), -1)
    else:
        h = params["embed"][tokens]
    if cfg.pos_emb == "sinusoidal":
        h = h + sinusoidal_positions(positions, cfg.d_model).to(h.dtype)
    return h


def _blocks(params, cfg):
    """The decoder's blocks in order, as (path, kind): ``path`` is
    (group, index, ...) into the params, the same into the decode state
    (hybrid ``ssm_layers``: (position, period); vlm ``layers``: (period,
    position)), and ``kind`` the block's mixer."""
    fam = cfg.family
    if fam in ("dense", "moe", "ssm", "encdec"):
        kind = "ssm" if fam == "ssm" else "attn"
        for i in range(_stack_len(params["layers"])):
            yield ("layers", i), kind
    elif fam == "hybrid":
        for i in range(_stack_len(params["attn_layers"])):
            yield ("attn_layers", i), "attn"
            for j in range(len(params["ssm_layers"])):
                yield ("ssm_layers", j, i), "ssm"
    elif fam == "vlm":
        per = params["layers"]["ln1"].shape[1]
        for i in range(_stack_len(params["cross_layers"])):
            for j in range(per):
                yield ("layers", i, j), "attn"
            yield ("cross_layers", i), "attn"
    else:
        raise ValueError(f"unknown family {fam}")


def _block_params(params, path):
    """The params of the block at ``path`` (see ``_blocks``)."""
    p = params[path[0]]
    for i in path[1:]:
        p = p[i] if isinstance(p, tuple) else _layer(p, i)
    return p


# =====================================================================
# full forward (train / prefill)
# =====================================================================
def encoder_forward(params, cfg, frames):
    """frames [B, T, d] (stub frontend output) -> encoder states. Under a
    mesh each rank runs its rows and the states are gathered back."""
    return shd.gather_rows(_encode(params, cfg, shd.batch_rows(frames)))


def _encode(params, cfg, frames):
    """``encoder_forward`` of the rank's rows (all of them without a
    mesh)."""
    B, T, _ = frames.shape
    pos = torch.arange(T, device=frames.device)[None, :].expand(B, T)
    h = frames + sinusoidal_positions(pos, cfg.d_model).to(frames.dtype)
    for i in range(_stack_len(params["enc_layers"])):
        p = _layer(params["enc_layers"], i)
        h = _enc_attn_full(p, cfg, h, pos)
        h, _ = _ffn_full(p, cfg, h, "dense")
    return rms_norm(h, params["enc_norm"], cfg.norm_eps)


def _period(path) -> int:
    """The block's layer (dense, moe, ssm, encdec) or period (hybrid,
    vlm) index: the unit ``forward(remat=True)`` recomputes."""
    return path[2] if path[0] == "ssm_layers" else path[1]


def _run_blocks(params, cfg, blocks, positions, window, enc, moe_path, h,
                aux):
    for path, kind in blocks:
        h, a = _block_full(_block_params(params, path), cfg, h, positions,
                           kind=kind, window=window, enc=enc,
                           moe_path=moe_path)
        aux = aux + a
    return h, aux


def forward(params, cfg, tokens, *, enc=None, window: Optional[int] = None,
            moe_path: str = "auto", remat: bool = False):
    """tokens [B,S] (and, for encdec / vlm, ``enc`` [B,T,d]: encoder
    states / patch embeddings) -> (hidden [B,S,d] before the final norm,
    aux_loss fp32 scalar). ``remat``: keep only each block's (hybrid,
    vlm: each period's) input for the backward pass and recompute the
    rest there, as JAX's ``jax.checkpoint`` over the scan body does; the
    values are bitwise those of ``remat=False``. Under a mesh each rank
    runs its batch rows (of ``enc`` too) and the hidden states are
    gathered back."""
    h, aux = _forward(params, cfg, shd.batch_rows(tokens), _rows(enc),
                      window, moe_path, remat)
    return shd.gather_rows(h), aux


def _rows(enc):
    """The rank's rows of the frontend states ``enc`` (or None)."""
    return None if enc is None else shd.batch_rows(enc)


def _forward(params, cfg, tokens, enc, window, moe_path, remat):
    """``forward`` of the rank's rows (all of them without a mesh)."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    h = _embed(params, cfg, tokens, positions)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for _, blocks in itertools.groupby(_blocks(params, cfg),
                                       key=lambda b: _period(b[0])):
        args = (params, cfg, list(blocks), positions, window, enc, moe_path)
        if remat:
            h, aux = checkpoint(_run_blocks, *args, h, aux,
                                use_reentrant=False)
        else:
            h, aux = _run_blocks(*args, h, aux)
    return h, aux


def loss_fn(params, cfg, batch, *, moe_path: str = "auto",
            remat: bool = True):
    """The training loss: mean next-token xent (fp32) of ``batch``
    ({"tokens", "labels"} [B,S] int; encdec also "frames" [B,T,d] for the
    encoder, vlm "patches" [B,T,d]) plus AUX_WEIGHT times the MoE layers'
    load-balance loss. Under a mesh each rank runs its batch rows (of the
    frames or patches too) and its vocab block of the cross entropy
    (``_vocab_block``), and every rank returns the whole batch's loss."""
    rows = {k: shd.batch_rows(v) for k, v in batch.items()}
    enc = None
    if cfg.family == "encdec":
        enc = _encode(params, cfg, rows["frames"])
    elif cfg.family == "vlm":
        enc = rows["patches"]
    h, aux = _forward(params, cfg, rows["tokens"], enc, None, moe_path,
                      remat)
    unembed, vocab_axis = _vocab_block(params, cfg)
    xent = chunked_softmax_xent(h, unembed, rows["labels"],
                                norm_w=params["final_norm"],
                                eps=cfg.norm_eps, vocab_axis=vocab_axis,
                                batch_axis=shd.batch_axis())
    return xent + AUX_WEIGHT * aux


def _vocab_block(params, cfg):
    """(the unembedding the rank's cross entropy takes, the mesh axis its
    vocab is split over or None). Without a mesh: the whole [d, V] one.
    Under a mesh: the rank's block of a vocab-split ``unembed``; tied, the
    embedding's d blocks turned into vocab blocks by one all-to-all over
    the model axis (rank j gets the rows of vocab block j from every
    rank; where V does not split, the d blocks are gathered whole);
    else whole."""
    m = shd.model_axis()
    if "unembed" in params:
        split = shd.model_split(cfg.vocab_size)
        return params["unembed"], m if split else None
    emb = params["embed"]
    if not shd.model_split(cfg.d_model):
        return emb.T, None
    if not shd.model_split(cfg.vocab_size):
        return shd.all_gather(emb, m, -1).T, None
    n, Vl = shd.axis_size(m), cfg.vocab_size // shd.axis_size(m)
    got = shd.all_to_all(emb, m)           # [n * Vl, d / n], by source rank
    return got.reshape(n, Vl, -1).transpose(0, 1).reshape(Vl, -1).T, m


def prefill(params, cfg, tokens, *, enc=None, moe_path: str = "auto"):
    """Full forward returning last-position logits [B, V] (no [B,S,V]).
    Under a mesh each rank runs its rows (of ``enc`` too); the logits are
    gathered."""
    h, _ = _forward(params, cfg, shd.batch_rows(tokens), _rows(enc), None,
                    moe_path, False)
    return shd.gather_rows(
        logits_from_hidden(params, cfg, h[:, -1:, :])[:, 0])


# =====================================================================
# decode state and blocks
# =====================================================================
def init_decode_state(params, cfg, batch: int, cache_len: int, *,
                      dtype=None, enc=None, device="cuda"):
    """Decode state, one entry per layer, grouped as the params are:
    ``{"layers": [cache] * L}`` (dense, moe, ssm, encdec); hybrid
    ``{"attn_layers": [cache] * P, "ssm_layers": ([state] * P,) * per}``;
    vlm ``{"layers": [[cache] * per] * P, "cross_layers": [cache] * P}``.
    A cache is a dense KV cache ``{k,v [B,cache_len,KV,hd]}`` (MLA:
    ``{latent [B,cache_len,r], k_rope [B,cache_len,rd]}``), a state the
    SSM's ``{ssd [B,H,P,N] fp32, conv [B,W-1,di+2N]}``. encdec and vlm
    also get ``"cross_kv"``, each cross layer's K/V over ``enc``,
    computed once here. (The JAX package stacks the entries on their
    layer axes; the port keeps one entry per layer, since decode updates
    KV caches in place.) Under a mesh the state is built whole, from the
    whole params and ``enc`` under the sharding context (its KV heads pad
    as the mesh says), and cut by ``launch.specs.shard_decode_state``."""
    dtype = dtype or _param_dtype(cfg)
    fam = cfg.family

    def kv():
        init = attn.mla_cache_init if cfg.use_mla else attn.gqa_cache_init
        return init(cfg, batch, cache_len, dtype, device=device)

    def ssm():
        return ssm_lib.ssm_state_init(cfg, batch, dtype, device=device)

    state: Dict[str, Any] = {}
    if fam in ("dense", "moe", "encdec"):
        state["layers"] = [kv() for _ in range(cfg.num_layers)]
    elif fam == "ssm":
        state["layers"] = [ssm() for _ in range(cfg.num_layers)]
    elif fam == "hybrid":
        P, per = cfg.num_layers // cfg.attn_every, cfg.attn_every - 1
        state["attn_layers"] = [kv() for _ in range(P)]
        state["ssm_layers"] = tuple([ssm() for _ in range(P)]
                                    for _ in range(per))
    elif fam == "vlm":
        P = cfg.num_layers // cfg.cross_attn_every
        per = cfg.cross_attn_every - 1
        state["layers"] = [[kv() for _ in range(per)] for _ in range(P)]
        state["cross_layers"] = [kv() for _ in range(P)]
    else:
        raise ValueError(f"unknown family {fam}")
    # precomputed cross K/V over frontend states
    if fam in ("encdec", "vlm"):
        assert enc is not None, f"{fam} decode needs the frontend states"
        stack = params["layers" if fam == "encdec" else "cross_layers"]
        state["cross_kv"] = [attn.cross_kv(_layer(stack, i)["cross"], enc)
                             for i in range(_stack_len(stack))]
    return state


def _attn_decode(p, cfg, h, cache, pos, window):
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    decode = attn.mla_decode if cfg.use_mla else attn.gqa_decode
    y, cache = decode(p["attn"], cfg, x, cache, pos, window=window)
    return h + y, cache


def _block_decode(p, cfg, h, cache, pos, *, kind, window, cross_kv,
                  moe_path):
    if kind == "attn":
        h, cache = _attn_decode(p, cfg, h, cache, pos, window)
    else:
        y, cache = ssm_lib.ssd_decode(p["ssm"], cfg,
                                      rms_norm(h, p["ln1"], cfg.norm_eps),
                                      cache)
        h = h + y
    if "cross" in p and cross_kv is not None:
        x = rms_norm(h, p["ln_c"], cfg.norm_eps)
        h = h + attn.cross_attend(p["cross"], cfg, x, cross_kv)
    h, _ = _ffn_full(p, cfg, h, moe_path)
    return h, cache


def decode_step(params, cfg, state, token, pos: int, *,
                window: Optional[int] = None, moe_path: str = "auto"):
    """token [B,1] int, pos an int (the same for every row) -> (logits
    [B,V], new state). KV caches are updated in place; SSM states are
    replaced in the returned state's lists. Under a mesh ``state`` is
    the rank's (``launch.specs.shard_decode_state``): each rank decodes
    its rows, and the logits are gathered."""
    token = shd.batch_rows(token)
    B = token.shape[0]
    positions = torch.full((B, 1), int(pos), dtype=torch.long,
                           device=token.device)
    h = _embed(params, cfg, token, positions)
    # new lists (the caller's state keeps its SSM states), the same caches
    new_state = _tree_map(lambda t: t, state)
    cross = iter(state.get("cross_kv", ()))
    for path, kind in _blocks(params, cfg):
        p = _block_params(params, path)
        caches = new_state[path[0]]
        for i in path[1:-1]:
            caches = caches[i]
        at = path[-1]
        h, caches[at] = _block_decode(
            p, cfg, h, caches[at], pos, kind=kind, window=window,
            cross_kv=next(cross) if "cross" in p else None,
            moe_path=moe_path)
    return shd.gather_rows(logits_from_hidden(params, cfg, h)[:, 0]), \
        new_state


def _attn_decode_multipos(p, cfg, h, cache, pos_vec):
    """Per-row-position decode (continuous batching): pos_vec [B]. Under
    a mesh ``p`` is the rank's and ``cache`` the rank's block
    (``launch.specs.shard_decode_state``)."""
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
    virtual rows) — see ``attention.gqa_decode_paged``. Under a mesh
    ``p`` is the rank's and ``cache`` the rank's pool (its KV heads, or
    MLA's whole latent pool); under a batch rule that splits the rows,
    ``h`` is the rank's rows and ``pos_vec`` / ``block_tables`` the whole
    batch's, passed through as they are (the pool holds every row)."""
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    decode = attn.mla_decode_paged if cfg.use_mla else attn.gqa_decode_paged
    y, cache = decode(p["attn"], cfg, x, cache, pos_vec, block_tables)
    return h + y, cache
