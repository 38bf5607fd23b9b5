"""Mixture-of-Experts layer (port of ``repro.models.moe``).

Compute paths over one parameter layout:

* ``moe_dense``    — every expert on every token, gate-weighted. Exact;
  the oracle, and the path ``auto`` takes for small token counts.
* ``moe_capacity`` — capacity-bounded scatter dispatch (tokens above an
  expert's capacity drop), the path ``auto`` takes for a prefill.
* ``moe_gather``   — gathers only the selected experts' weights, for a
  handful of tokens.
* the offload path lives in ``repro_torch.core.offload_engine``.

The products stay ``torch.einsum`` / matrix products: the JAX package
computes them outside any Pallas kernel too. The expert-parallel path
(``moe_ep_shardmap``) needs a device mesh and is not ported yet
(``path="ep"`` raises); ``auto`` never picks it without a mesh.

Routing is softmax top-k with renormalisation (Mixtral convention) plus
the load-balance auxiliary loss. The top-k runs on the device with
``torch.topk``, where JAX uses ``jax.lax.top_k``: the two may order TIED
logits differently, so the port equals the reference only where the gap
between the k-th and (k+1)-th router logit is above float noise. The
tests assert the smallest such margin they saw.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, swiglu


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


def router_probs(p, cfg, x):
    """x [..., d] -> (gate_logits [..., E] fp32, top-k probs [..., k],
    ids [..., k] int64). Ids come from ``torch.topk`` (see the module
    docstring on ties)."""
    logits = (x.float() @ p["router"]).float()
    top_vals, top_ids = torch.topk(logits, cfg.num_experts_per_tok, dim=-1)
    top_probs = torch.softmax(top_vals, dim=-1)  # renormalised over top-k
    return logits, top_probs, top_ids


def load_balance_loss(logits, top_ids, num_experts: int):
    """GShard aux loss: E * mean_e(frac_tokens_e * mean_prob_e)."""
    probs = torch.softmax(logits, dim=-1).reshape(-1, num_experts)
    ids = top_ids.reshape(-1, top_ids.shape[-1])
    sel = F.one_hot(ids[:, 0], num_experts).float()
    return num_experts * torch.sum(sel.mean(dim=0) * probs.mean(dim=0))


def _swiglu_experts(experts, x_e):
    """x_e [E, C, d] through stacked expert SwiGLU -> [E, C, d]."""
    h = torch.einsum("ecd,edf->ecf", x_e, experts["w1"])
    g = torch.einsum("ecd,edf->ecf", x_e, experts["w3"])
    return torch.einsum("ecf,efd->ecd", F.silu(h) * g, experts["w2"])


def _shared_out(p, x):
    return swiglu(p["shared"], x) if "shared" in p else 0.0


def moe_dense(p, cfg, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact all-experts path. x [B,S,d] -> (y, aux_loss)."""
    logits, top_probs, top_ids = router_probs(p, cfg, x)
    ex = p["experts"]
    h = torch.einsum("bsd,edf->bsef", x, ex["w1"])
    g = torch.einsum("bsd,edf->bsef", x, ex["w3"])
    out_e = torch.einsum("bsef,efd->bsed", F.silu(h) * g, ex["w2"])
    gates = torch.zeros(logits.shape, dtype=torch.float32, device=x.device)
    gates.scatter_(-1, top_ids, top_probs)
    y = torch.einsum("bsed,bse->bsd", out_e.float(), gates)
    y = y.to(x.dtype) + _shared_out(p, x)
    return y, load_balance_loss(logits, top_ids, cfg.num_experts)


def moe_capacity(p, cfg, x, *, capacity_factor: Optional[float] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-bounded scatter dispatch. x [B,S,d] -> (y, aux_loss).

    Position-in-expert by a one-hot cumsum; rows scatter into an
    [E, C, d] buffer (overflow goes to a dump row and is dropped); the
    stacked expert FFN runs; the outputs gather back gate-weighted."""
    B, S, d = x.shape
    T = B * S
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    cf = capacity_factor if capacity_factor is not None else \
        cfg.capacity_factor
    C = max(int(math.ceil(T * k * cf / E)), 8)
    C = -(-C // 8) * 8

    logits, top_probs, top_ids = router_probs(p, cfg, x)
    aux = load_balance_loss(logits, top_ids, E)

    xf = x.reshape(T, d)
    fid = top_ids.reshape(T * k)                       # flat expert ids
    fp = top_probs.reshape(T * k)
    oh = F.one_hot(fid, E)                             # [T*k, E]
    pos = torch.sum(torch.cumsum(oh, dim=0) * oh, dim=-1) - 1
    keep = pos < C
    slot = torch.where(keep, fid * C + pos, torch.full_like(fid, E * C))

    x_rep = xf.repeat_interleave(k, dim=0)             # [T*k, d]
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, slot, x_rep)   # one row per kept slot: exact
    x_e = buf[:E * C].reshape(E, C, d)

    out_flat = _swiglu_experts(p["experts"], x_e).reshape(E * C, d)
    gathered = torch.where(keep[:, None],
                           out_flat[torch.clamp(slot, max=E * C - 1)],
                           torch.zeros((), dtype=out_flat.dtype,
                                       device=x.device))
    y = (gathered.float() * fp[:, None]).reshape(T, k, d).sum(dim=1)
    y = y.to(x.dtype).reshape(B, S, d) + _shared_out(p, x)
    return y, aux


def moe_gather(p, cfg, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weight-gather path for tiny token counts: gathers only the
    selected experts' weights ([T,k,d,ff] slices)."""
    B, S, d = x.shape
    T = B * S
    logits, top_probs, top_ids = router_probs(p, cfg, x)
    aux = load_balance_loss(logits, top_ids, cfg.num_experts)
    xf = x.reshape(T, d)
    ids = top_ids.reshape(T, -1)                       # [T, k]
    ex = p["experts"]
    w1, w3, w2 = ex["w1"][ids], ex["w3"][ids], ex["w2"][ids]
    h = torch.einsum("td,tkdf->tkf", xf, w1)
    g = torch.einsum("td,tkdf->tkf", xf, w3)
    out = torch.einsum("tkf,tkfd->tkd", F.silu(h) * g, w2)
    y = torch.einsum("tkd,tk->td", out.float(), top_probs.reshape(T, -1))
    return y.to(x.dtype).reshape(B, S, d) + _shared_out(p, x), aux


def moe_apply(p, cfg, x, *, path: str = "auto"):
    """path: 'dense' | 'capacity' | 'gather' | 'auto' ('ep' is not
    ported yet)."""
    if path == "dense":
        return moe_dense(p, cfg, x)
    if path == "capacity":
        return moe_capacity(p, cfg, x)
    if path == "gather":
        return moe_gather(p, cfg, x)
    if path == "ep":
        raise NotImplementedError(
            "moe_path='ep' (expert parallelism over a device mesh) is not "
            "ported yet (ROADMAP.md A12)")
    if path != "auto":
        raise ValueError(f"unknown moe path {path!r}")
    T = x.shape[0] * x.shape[1]
    if T <= 256 and cfg.num_experts <= 8:
        return moe_dense(p, cfg, x)
    if T * cfg.num_experts_per_tok <= cfg.num_experts:
        return moe_gather(p, cfg, x)
    # without a device mesh the JAX package's 'auto' never takes 'ep'
    return moe_capacity(p, cfg, x)
