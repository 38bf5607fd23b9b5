"""Partition specs of the inputs and the decode state (the spec half of
``repro.launch.specs``).

Specs are tuples as in ``repro_torch.models.sharding``. The decode state
is the port's tree (``transformer.init_decode_state``: one cache per
layer, in lists, where the JAX package stacks them on a layer axis), so
a leaf's spec here is the JAX package's without the leading layer
entries; ``shard_decode_state`` cuts a whole state to a rank's. The
abstract input shapes (``input_specs``, ``params_spec``,
``decode_state_spec``) and the optimizer-state specs belong to the dry
run and are not ported here.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.models.sharding import axis_sizes, map_with_path, shard_tree


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
        kv_heads = shape[-2] if len(shape) >= 2 else 0
        if not cross and kv is not None and kv_heads % max(model_size, 1):
            base = (b, m, None, None)
        else:
            base = (b, None, m if cross else kv, None)
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
    that its KV heads are padded), by ``decode_state_pspecs``. A dim
    that does not split raises (``sharding.local_slice``): the decode
    step takes the split from the rules alone."""
    return shard_tree(state, decode_state_pspecs(state, rules, mesh), mesh)
