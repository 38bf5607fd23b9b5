"""AdamW and the cosine learning-rate schedule (port of
``repro.training.optimizer``).

The optimizer state is ``{"m", "v", "count"}``: fp32 moments shaped like
the params (under a mesh, like the rank's blocks of them that
``launch.specs.opt_state_pspecs`` gives: ZeRO-1 cuts them on the data
axis too) and an int32 step count. The math is JAX's, in fp32; params
keep their dtype. Unlike JAX's pure update, ``adamw_update`` writes the
new params and moments IN PLACE, under ``torch.no_grad()``, leaf by leaf
in slices of at most ``CHUNK`` elements, so an update takes no second
copy of the params or of the state (at Mixtral widths one expert stack
is 3.8 GB).
"""
from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Any, Callable, Tuple

import torch

from repro_torch.models import sharding as shd
from repro_torch.training.tree import leaves, unflatten

CHUNK = 1 << 26   # elements of a leaf updated at once


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params, shapes=None):
    """Zero moments shaped like the params' leaves, or (``shapes``, in
    ``leaves`` order) like the blocks of them a rank keeps."""
    ps = leaves(params)
    shapes = shapes or [p.shape for p in ps]

    def zeros():
        return unflatten(params, [torch.zeros(s, dtype=torch.float32,
                                              device=p.device)
                                  for s, p in zip(shapes, ps)])
    return {"m": zeros(), "v": zeros(),
            "count": torch.zeros((), dtype=torch.int32, device=ps[0].device)}


def leaf_specs(tree, specs) -> list:
    """The specs of ``specs`` (a tree mirroring ``tree``, each spec a
    tuple) in the order of ``leaves(tree)``."""
    return [b.spec for b in leaves(shd.zip_map(
        lambda _, spec: SimpleNamespace(spec=spec), tree, specs))]


def global_norm(tree, specs=None) -> torch.Tensor:
    """The L2 norm of every leaf of ``tree``. Under a mesh, with
    ``specs`` (the leaves' specs, ``tree`` holding the rank's block of
    each): the whole tree's norm, each leaf's sum of squares summed over
    the mesh axes its spec splits (one all-reduce for the leaves split
    alike), a leaf kept whole counted once. The leaves' sums are added in
    the same order either way, so one rank gives the unsplit norm's bits."""
    sq = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    if specs is not None and shd.active_mesh() is not None:
        axes = [sum((shd.entry_axes(e) for e in s), ())
                for s in leaf_specs(tree, specs)]
        for ax in sorted(set(axes) - {()}):
            idx = [i for i, a in enumerate(axes) if a == ax]
            summed = shd.psum(torch.stack([sq[i] for i in idx]), ax)
            for i, v in zip(idx, summed):
                sq[i] = v
    return torch.sqrt(sum(sq))


def adamw_update(grads, opt_state, params, *, cfg: AdamWConfig,
                 lr_scale=1.0, specs=None, moment_specs=None
                 ) -> Tuple[Any, Any]:
    """Returns (params, opt_state), both updated in place. Grads may be
    any dtype; the global norm of the whole gradient is clipped to
    ``cfg.grad_clip`` first. Under a mesh every rank updates its blocks:
    ``specs`` are the params' specs and ``moment_specs`` the moments'
    (the params' where omitted), and the gradients are cut like the
    moments. A leaf whose moment spec adds an axis on a dim (ZeRO-1)
    updates the rank's block of that dim of the param (a contiguous copy
    where the block is strided) with its gradient and moment blocks, then
    all-gathers the blocks over the axis back into the param."""
    b1, b2 = cfg.b1, cfg.b2
    moment_specs = specs if moment_specs is None else moment_specs
    sharded = specs is not None and shd.active_mesh() is not None
    with torch.no_grad():
        count = opt_state["count"] + 1
        gnorm = global_norm(grads, moment_specs)
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        c = count.float()
        bc1 = 1 - b1 ** c
        bc2 = 1 - b2 ** c
        lr = cfg.lr * lr_scale

        def update(g, m, v, p):
            g, m, v, p = g.reshape(-1), m.view(-1), v.view(-1), p.view(-1)
            for a in range(0, p.numel(), CHUNK):
                gs = g[a:a + CHUNK].float() * scale
                ms, vs, ps = m[a:a + CHUNK], v[a:a + CHUNK], p[a:a + CHUNK]
                ms.mul_(b1).add_((1 - b1) * gs)
                vs.mul_(b2).add_((1 - b2) * gs * gs)
                step = (ms / bc1) / (torch.sqrt(vs / bc2) + cfg.eps)
                step = step + cfg.weight_decay * ps.float()
                ps.copy_(ps.float() - lr * step)

        ps = leaves(params)
        added = ([shd.added_axis(s, m) for s, m in zip(
            leaf_specs(params, specs), leaf_specs(params, moment_specs))]
            if sharded else [None] * len(ps))
        for g, m, v, p, zero in zip(leaves(grads), leaves(opt_state["m"]),
                                    leaves(opt_state["v"]), ps, added):
            if zero is None:
                update(g, m, v, p)
            elif p.numel():
                dim, axis = zero
                n = m.shape[dim]
                block = p.narrow(dim, shd.axis_index(axis) * n, n)
                block = block.contiguous()
                update(g, m, v, block)
                shd.all_gather_into(p, block, axis, dim)
        opt_state["count"] = count
    return params, opt_state


def cosine_schedule(base_lr_scale: float = 1.0, *, warmup: int = 100,
                    total: int = 10_000, floor: float = 0.1
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    def f(step):
        step = torch.as_tensor(step).float()
        warm = torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr_scale * warm * cos
    return f
