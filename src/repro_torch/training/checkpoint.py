"""Checkpoints: a flat ``.npz`` of any param or optimizer tree, restored
into the structure of a like-shaped tree (port of
``repro.training.checkpoint``).

The file is the JAX package's: one array a leaf under its flat key
(``"layers/attn/wq"``, tuple and list indices as numbers, the key order
of ``training.tree``) and ``__meta__``, JSON of the step, ``extra`` and
each leaf's dtype. A checkpoint written by either package loads in the
other. bf16 leaves are written as float32 (exact; numpy has no bf16) and
cast back on load.
"""
from __future__ import annotations

import json
import os
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.training.tree import flatten, unflatten


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def save_checkpoint(path: str, tree, *, step: int = 0, extra: dict = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    items = list(flatten(tree))
    flat = {k: _to_numpy(v) for k, v in items}
    dtypes = {k: str(v.dtype).removeprefix("torch.") for k, v in items}
    meta = {"step": step, "extra": extra or {}, "dtypes": dtypes}
    np.savez(path, __meta__=json.dumps(meta), **flat)


def _to_torch(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype.itemsize == 2 and arr.dtype.kind == "V" or \
            arr.dtype.name == "bfloat16":   # JAX's bf16: the same 16 bits
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(dtype=like.dtype, device=like.device)


def load_checkpoint(path: str, like) -> Tuple[Any, int]:
    """Restore into the structure, dtypes and devices of ``like``.
    Returns (tree, step). A leaf missing from the file raises KeyError, a
    shape that differs ValueError."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    out = []
    for key, leaf in flatten(like):
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        out.append(_to_torch(arr, leaf))
    return unflatten(like, out), meta["step"]
