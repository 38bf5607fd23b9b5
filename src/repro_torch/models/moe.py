"""Mixture-of-Experts parameters (port of ``repro.models.moe.init_moe``).

The offload path that computes with these weights lives in
``repro_torch.core.offload_engine``; the full-sequence MoE paths
(``moe_dense`` / ``moe_capacity``) come with a later slice.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import dense_init


def init_moe(gen: torch.Generator, cfg, dtype, *, layers: int,
             device="cuda"):
    """Stacked MoE params for ``layers`` layers: router ``[L,d,E]``
    (fp32), experts ``w1/w3 [L,E,d,ff]`` and ``w2 [L,E,ff,d]`` — the
    JAX package's layout and init scales."""
    d, ff, E = cfg.d_model, cfg.expert_d_ff, cfg.num_experts
    L = layers
    res_scale = 1.0 / math.sqrt(2 * cfg.num_layers)

    def init(shape, in_dim, scale=1.0, dt=dtype):
        return dense_init(gen, shape, in_dim, scale=scale, dtype=dt,
                          device=device)

    p = {
        "router": init((L, d, E), d, dt=torch.float32),
        "experts": {
            "w1": init((L, E, d, ff), d),
            "w3": init((L, E, d, ff), d),
            "w2": init((L, E, ff, d), ff, scale=res_scale),
        },
    }
    if cfg.num_shared_experts:
        sff = ff * cfg.num_shared_experts
        p["shared"] = {
            "w1": init((L, d, sff), d),
            "w3": init((L, d, sff), d),
            "w2": init((L, sff, d), sff, scale=res_scale),
        }
    return p
