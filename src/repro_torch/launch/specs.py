"""Abstract inputs and partition specs of every (architecture x input
shape), with no device allocation (port of ``repro.launch.specs``).

Where the JAX package returns ``ShapeDtypeStruct``s, the port returns
``meta`` tensors: they have shapes, dtypes and strides and no storage,
and the model code runs on them. ``input_specs(cfg, shape_name)`` gives
the dry run's inputs:

  train:   {tokens, labels [B,S] i32, (+frames/patches)}
  prefill: {tokens [B,S] i32, (+frames/patches)}
  decode:  {token [B,1] i32, pos scalar i32, state <decode cache>}

Specs are tuples as in ``repro_torch.models.sharding``. The decode state
is the port's tree (``transformer.init_decode_state``: one cache per
layer, in lists, where the JAX package stacks them on a layer axis), so
a leaf's spec here is the JAX package's without the leading layer
entries; ``shard_decode_state`` cuts a whole state to a rank's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import INPUT_SHAPES
from repro_torch.models import transformer as tf
from repro_torch.models.sharding import (axis_sizes, map_with_path,
                                         shard_tree, sharding_ctx, zip_map)


def sds(shape, dtype) -> torch.Tensor:
    """An abstract input: a meta tensor of ``shape`` and ``dtype``."""
    return torch.empty(shape, dtype=dtype, device="meta")


def decode_geometry(cfg, shape) -> Tuple[int, Optional[int]]:
    """(cache_len, window) for a decode shape.

    long_500k uses the sliding-window carve-out for attention layers
    (the config's ``long_context_window``); SSM state is length-free
    anyway.
    """
    if shape.seq_len > 32_768 and cfg.long_context_window:
        w = cfg.long_context_window
        return w, w
    return shape.seq_len, None


def frontend_specs(cfg, batch: int) -> Dict:
    dt = getattr(torch, cfg.dtype)
    if cfg.family == "encdec":
        return {"frames": sds((batch, cfg.encoder_frames, cfg.d_model), dt)}
    if cfg.family == "vlm":
        return {"patches": sds((batch, cfg.num_image_tokens, cfg.d_model),
                               dt)}
    return {}


def params_spec(cfg):
    """The whole params on ``meta`` (``transformer.init_params``)."""
    return tf.init_params(cfg, torch.Generator(), device="meta")


def decode_state_spec(cfg, batch: int, cache_len: int):
    """The whole decode state on ``meta``, built under the active
    sharding context (its KV heads pad as the mesh says); encdec runs
    ``encoder_forward`` over meta frames for its cross K/V, with the
    whole params over the whole batch, so outside the mesh."""
    p_spec = params_spec(cfg)
    fe = frontend_specs(cfg, batch)
    enc = None
    if cfg.family == "encdec":
        with sharding_ctx(None, {}):
            enc = tf.encoder_forward(p_spec, cfg, fe["frames"])
    elif cfg.family == "vlm":
        enc = fe["patches"]
    return tf.init_decode_state(p_spec, cfg, batch, cache_len, enc=enc,
                                device="meta")


def input_specs(cfg, shape_name: str) -> Dict:
    shape = INPUT_SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        out = {"tokens": sds((B, S), torch.int32),
               "labels": sds((B, S), torch.int32)}
        out.update(frontend_specs(cfg, B))
        return out
    if shape.kind == "prefill":
        out = {"tokens": sds((B, S), torch.int32)}
        out.update(frontend_specs(cfg, B))
        return out
    cache_len, _window = decode_geometry(cfg, shape)
    return {
        "token": sds((B, 1), torch.int32),
        "pos": sds((), torch.int32),
        "state": decode_state_spec(cfg, B, cache_len),
    }


# ---------------------------------------------------------------------
# Partition specs
# ---------------------------------------------------------------------


def batch_pspecs(specs: Dict, rules) -> Dict:
    """Each input (anything with ``.shape``) split on its leading batch
    dim by the "batch" rule."""
    b = rules.get("batch")
    return {k: (b, *([None] * (len(v.shape) - 1))) for k, v in specs.items()}


def _decode_leaf_spec(path: str, ndim: int, rules, shape=(),
                      model_size: int = 1) -> tuple:
    m = rules.get("model")
    b = rules.get("batch")
    kv = m if rules.get("shard_kv") else None
    name = path.split("/")[-1]
    cross = "cross_kv" in path
    if name in ("k", "v"):
        # [.., B, S, KV, hd]: shard KV heads when they divide (they are
        # head-padded); otherwise shard the SEQUENCE dim — a 2-kv-head
        # GQA cache left replicated costs 16x the reads AND the sharded
        # q-heads then induce cache gathers (§Perf pair 3 follow-up).
        # Cross K/V (MHA, never padded) split on their heads where the
        # model axis divides them, and are whole on every rank else, as
        # cross-attention's weights are.
        kv_heads = shape[-2] if len(shape) >= 2 else 0
        even = kv_heads % max(model_size, 1) == 0
        if not cross and kv is not None and not even:
            base = (b, m, None, None)
        else:
            base = (b, None, (m if even else None) if cross else kv, None)
    elif name in ("latent", "k_rope"):
        # MLA latent has no head dim to shard — shard the SEQUENCE dim
        # over "model" instead of replicating the cache on every chip
        # (sequence-parallel decode: the softmax is combined across the
        # model ranks).
        seq = m if rules.get("mla_seq_shard", True) else None
        base = (b, seq, None)                         # [B, S, r]
    elif name == "ssd":
        base = (b, m, None, None)                     # [B, H, P, N]
    elif name == "conv":
        base = (b, None, None)                        # [B, W-1, C]
    else:
        base = tuple([None] * ndim)
    lead = ndim - len(base)
    return tuple([None] * lead + list(base))


def decode_state_pspecs(state, rules, mesh=None):
    """Spec tree mirroring a decode state (leaves need only ``.shape``)."""
    msize = 1
    m = rules.get("model")
    if mesh is not None and m:
        msize = axis_sizes(mesh)[m]

    def f(path, leaf):
        return _decode_leaf_spec(path, len(leaf.shape), rules,
                                 shape=tuple(leaf.shape), model_size=msize)
    return map_with_path(f, state)


def shard_decode_state(state, mesh, rules):
    """This rank's block of every leaf of a whole decode state (as
    ``transformer.init_decode_state`` builds it under the same mesh, so
    that its KV heads are padded, from the whole params and the whole
    frontend states), by ``decode_state_pspecs``. A dim that does not
    split raises (``sharding.local_slice``): the decode step takes the
    split from the rules alone."""
    return shard_tree(state, decode_state_pspecs(state, rules, mesh), mesh)


def opt_state_pspecs(param_pspecs_tree, params_spec_tree, cfg, rules,
                     *, data_axis: str = "data"):
    """m/v mirror the param specs; with ``cfg.zero1`` each leaf
    additionally shards its largest not-yet-sharded dim over the data
    axis (ZeRO-1-style optimizer-state partitioning)."""
    n_data = rules.get("_data_size", 16)

    def zshard(leaf, spec):
        if not cfg.zero1 or len(leaf.shape) < 2:
            return spec
        parts = list(spec) + [None] * (len(leaf.shape) - len(spec))
        cands = [(leaf.shape[i], i) for i in range(len(parts))
                 if parts[i] is None and leaf.shape[i] % n_data == 0
                 and leaf.shape[i] >= n_data]
        if cands:
            _, i = max(cands)
            parts[i] = data_axis
        return tuple(parts)

    mv = zip_map(zshard, params_spec_tree, param_pspecs_tree)
    return {"m": mv, "v": mv, "count": ()}
