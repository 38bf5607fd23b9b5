"""Param trees (nested dicts, tuples and lists of tensors) flattened in
the JAX package's order: dict keys sorted, sequences by index, each leaf
keyed by its path joined with "/" (``"layers/attn/wq"``,
``"ssm_layers/0/ssm/A_log"``), the keys of JAX's
``tree_flatten_with_path`` and of its checkpoints."""
from __future__ import annotations

from typing import Any, Iterable, Iterator, Tuple


def flatten(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs of ``tree``, in JAX's order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten(tree[k], prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from flatten(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(like, new_leaves: Iterable):
    """A tree shaped like ``like`` holding ``new_leaves`` in ``flatten``'s
    order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}   # the caller's key order
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)

    tree = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return tree
