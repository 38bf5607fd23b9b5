"""Training loop: the step factory and a small loop over batches (port of
``repro.training.train_loop``). The port runs eagerly: a step is the
loss, ``torch.autograd.grad`` over the param leaves, then AdamW in place
with the schedule read at the optimizer's step count, as JAX's jitted
step does."""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.models import transformer as tf
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, cosine_schedule)
from repro_torch.training.tree import flatten, unflatten


def make_train_step(cfg, *, opt_cfg: Optional[AdamWConfig] = None,
                    schedule: Optional[Callable] = None,
                    moe_path: str = "auto", remat: bool = True):
    """step(params, opt_state, batch) -> (params, opt_state, loss): params
    and state are updated in place (and returned), loss is the step's
    fp32 scalar before the update. ``batch`` holds tensors on the
    params' device."""
    opt_cfg = opt_cfg or AdamWConfig()
    schedule = schedule or (lambda s: 1.0)

    def step(params, opt_state, batch):
        # fresh leaves that share the params' storage: the graph is built
        # on them, and the caller's tensors keep requires_grad False
        leaves = [p.detach().requires_grad_() for _, p in flatten(params)]
        with torch.enable_grad():
            loss = tf.loss_fn(unflatten(params, leaves), cfg, batch,
                              moe_path=moe_path, remat=remat)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        lr_scale = schedule(opt_state["count"])
        params, opt_state = adamw_update(unflatten(params, grads), opt_state,
                                         params, cfg=opt_cfg,
                                         lr_scale=lr_scale)
        return params, opt_state, loss.detach()

    return step


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
