"""Training loop: the step factory and a small loop over batches (port of
``repro.training.train_loop``). The port runs eagerly: a step is the
loss, ``torch.autograd.grad`` over the param leaves, then AdamW in place
with the schedule read at the optimizer's step count, as JAX's jitted
step does. Under a device mesh the step runs on each rank's blocks of
the params and of the moments, ZeRO-1 included (``make_train_step``)."""
from __future__ import annotations

import functools
import math
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.launch.specs import opt_state_pspecs, params_spec
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as tf
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, cosine_schedule,
                                            leaf_specs)
from repro_torch.training.tree import flatten, leaves, unflatten


def make_train_step(cfg, *, opt_cfg: Optional[AdamWConfig] = None,
                    schedule: Optional[Callable] = None,
                    moe_path: str = "auto", remat: bool = True):
    """step(params, opt_state, batch) -> (params, opt_state, loss): params
    and state are updated in place (and returned), loss is the step's
    fp32 scalar before the update. ``batch`` holds tensors on the
    params' device.

    Under a mesh (``sharding.sharding_ctx``) ``params`` are the rank's
    blocks (``shard_params``), the moments its blocks under
    ``opt_specs(cfg)`` (``init_opt_state``), ``batch`` is the whole
    batch, and the loss is the whole batch's on every rank; each rank
    ends with its blocks of the params the unsharded step would give
    (``loss_and_grads``, then AdamW with the global norm of the whole
    gradient). Where a config's moments are cut on the data axis too
    (ZeRO-1), each such leaf's gradient is reduce-scattered onto the
    rank's block, AdamW updates that block, and the blocks are gathered
    back into the param. A moment of another shape than its spec gives
    raises ``ValueError`` before the loss runs."""
    opt_cfg = opt_cfg or AdamWConfig()
    schedule = schedule or (lambda s: 1.0)

    def step(params, opt_state, batch):
        sharded = shd.active_mesh() is not None
        specs = param_specs(cfg) if sharded else None
        moments = opt_specs(cfg)["m"] if sharded else None
        _check_moments(params, opt_state, cfg)
        loss, grads = loss_and_grads(params, cfg, batch, moe_path=moe_path,
                                     remat=remat, specs=specs,
                                     moment_specs=moments)
        lr_scale = schedule(opt_state["count"])
        params, opt_state = adamw_update(grads, opt_state, params,
                                         cfg=opt_cfg, lr_scale=lr_scale,
                                         specs=specs, moment_specs=moments)
        return params, opt_state, loss

    return step


@functools.lru_cache(maxsize=16)
def _whole_params(cfg):
    return params_spec(cfg)


def param_specs(cfg):
    """The spec tree of ``cfg``'s params under the active mesh and rules
    (``param_pspecs`` of the whole params on ``meta``, sanitized)."""
    return shd.param_pspecs(_whole_params(cfg), mesh=shd.active_mesh())


def opt_specs(cfg):
    """The optimizer state's specs under the active mesh and rules
    (``opt_state_pspecs``: the params' specs, and for a ``zero1`` config
    the data axis added on each leaf's largest dim that it divides, by
    the rules' ``_data_size``)."""
    return opt_state_pspecs(param_specs(cfg), _whole_params(cfg), cfg,
                            shd.active_rules())


def _moment_shapes(params, cfg):
    """The shape of each moment leaf, in ``leaves`` order: the params'
    without a mesh, else the rank's block of the whole leaf under its
    moment spec."""
    mesh = shd.active_mesh()
    if mesh is None:
        return [tuple(p.shape) for p in leaves(params)]
    whole = _whole_params(cfg)
    return [tuple(n // shd.axis_size(a, mesh) for n, a in zip(t.shape, spec))
            for t, spec in zip(leaves(whole),
                               leaf_specs(whole, opt_specs(cfg)["m"]))]


def init_opt_state(params, cfg):
    """AdamW's zero state for ``params`` (the rank's blocks under a mesh):
    ``adamw_init`` of the params, each moment cut to the block its spec
    gives (``opt_specs``: for ZeRO-1, the rank's block of the data axis
    too)."""
    return adamw_init(params, _moment_shapes(params, cfg))


def _check_moments(params, opt_state, cfg) -> None:
    """Raises ``ValueError`` naming the first moment leaf whose shape is
    not the one ``init_opt_state`` gives."""
    names = [k for k, _ in flatten(params)]
    shapes = _moment_shapes(params, cfg)
    for key in ("m", "v"):
        got = leaves(opt_state[key])
        if len(got) != len(names):
            raise ValueError(f"optimizer state {key} has {len(got)} leaves; "
                             f"the params {len(names)}")
        for name, m, want in zip(names, got, shapes):
            if tuple(m.shape) != want:
                raise ValueError(
                    f"optimizer state {key}[{name!r}] has shape "
                    f"{tuple(m.shape)}; its spec gives {want}")


def loss_and_grads(params, cfg, batch, *, moe_path: str = "auto",
                   remat: bool = True, specs=None, moment_specs=None):
    """(loss, grads): ``loss_fn`` detached and its gradients, a tree like
    ``params`` (zeros where a leaf is unused). Under a mesh each rank
    differentiates loss / world size (the collectives' backwards are
    their transposes, so that is its part of the gradient of the sum of
    the ranks' losses, each the global loss), then sums each gradient
    over the mesh axes its leaf is not split on (``psum_unsplit`` with
    ``specs``, the params' specs, and ``moment_specs``, the moments':
    ``param_specs(cfg)`` and ``opt_specs(cfg)["m"]`` by default): its
    block of the gradient of the global loss, cut like its moments (a
    ZeRO-1 leaf's gradient reduce-scattered onto the rank's data block;
    the whole gradient is freed as its block is made)."""
    # fresh leaves that share the params' storage: the graph is built on
    # them, and the caller's tensors keep requires_grad False
    flat = [p.detach().requires_grad_() for _, p in flatten(params)]
    mesh = shd.active_mesh()
    with torch.enable_grad():
        loss = tf.loss_fn(unflatten(params, flat), cfg, batch,
                          moe_path=moe_path, remat=remat)
        cot = None
        if mesh is not None:
            world = math.prod(shd.axis_sizes(mesh).values())
            cot = torch.full_like(loss, 1.0 / world)
        grads = torch.autograd.grad(loss, flat, cot, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, flat)]
    if mesh is not None:
        specs = leaf_specs(params, specs or param_specs(cfg))
        moments = leaf_specs(params, moment_specs or opt_specs(cfg)["m"])
        for i, (spec, moment) in enumerate(zip(specs, moments)):
            grads[i] = shd.psum_unsplit(grads[i], spec, moment, mesh)
    return loss.detach(), unflatten(params, grads)


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device`` (integer arrays as int64)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if not torch.is_floating_point(t):
            t = t.long()
        out[k] = t.to(device)
    return out


def train(cfg, batches: Iterator[Dict], *, steps: int, params=None,
          seed: int = 0, opt_cfg: Optional[AdamWConfig] = None,
          log_every: int = 20, moe_path: str = "auto",
          callback: Optional[Callable] = None, device="cuda"):
    """Single-device training loop: ``steps`` steps over numpy
    ``batches``. Params are drawn with ``init_params`` from a generator
    on ``device`` seeded with ``seed`` unless given (given params are
    updated in place). Returns (params, losses)."""
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = tf.init_params(cfg, gen, device=device)
    opt_state = adamw_init(params)
    opt_cfg = opt_cfg or AdamWConfig()
    sched = cosine_schedule(warmup=max(min(100, steps // 10), 1), total=steps)
    step_fn = make_train_step(cfg, opt_cfg=opt_cfg, schedule=sched,
                              moe_path=moe_path)
    losses = []
    t0 = time.time()
    for i, batch in enumerate(batches):
        if i >= steps:
            break
        params, opt_state, loss = step_fn(params, opt_state,
                                          to_device(batch, device))
        losses.append(float(loss))
        if log_every and (i % log_every == 0 or i == steps - 1):
            dt = time.time() - t0
            print(f"step {i:5d}  loss {losses[-1]:.4f}  ({dt:.1f}s)")
        if callback is not None:
            callback(i, params, losses[-1])
    return params, losses
