"""Mixture-of-Experts layer (port of ``repro.models.moe``).

Compute paths over one parameter layout:

* ``moe_dense``    — every expert on every token, gate-weighted. Exact;
  the oracle, and the path ``auto`` takes for small token counts.
* ``moe_capacity`` — capacity-bounded scatter dispatch (tokens above an
  expert's capacity drop), the path ``auto`` takes for a prefill.
* ``moe_gather``   — gathers only the selected experts' weights, for a
  handful of tokens.
* the offload path lives in ``repro_torch.core.offload_engine``.

* ``moe_ep_shardmap`` — expert parallelism over a device mesh: every
  rank dispatches its own tokens (its batch rows, and its block of the
  sequence on the model axis) into a local [E, C, d] buffer, two
  ``all_to_all_single`` exchanges on the model axis carry the buffers
  to the ranks that own the experts and back, and the outputs are
  gathered back along the sequence. ``auto`` takes it under a mesh
  whose rules say ``experts_mode="ep"``, for 4096 tokens or more.

The products stay ``torch.einsum`` / matrix products: the JAX package
computes them outside any Pallas kernel too.

Under a mesh (``repro_torch.models.sharding``) ``x`` is the rank's batch
rows and ``p`` is ``shard_params``' output: every path holds only the
rank's slice of the expert weights:
its experts (``experts_mode="ep"``) or its block of their ff dim
(``"tp"``: one all-reduce after ``w2``), and the shared expert's ff
block; ``moe_capacity`` gathers the batch first, so that its capacity and
its drops are those of the whole batch. The load-balance loss is the
whole batch's, except on the EP path, which takes the mean of the ranks'
losses as the JAX package's does.

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

from repro_torch.models import sharding as shd
from repro_torch.models.layers import dense_init, swiglu_tp


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


def _one_hot(ids, n: int):
    """``F.one_hot(ids, n)`` (int64), as a comparison: ``F.one_hot``
    checks its ids' range on the host (a device sync on the card) and
    runs other ops on meta tensors, which would give the dry run's op
    count another program. ``ids`` come from ``torch.topk``: in range."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).long()


def load_balance_loss(logits, top_ids, num_experts: int, batch_axis=None):
    """GShard aux loss: E * mean_e(frac_tokens_e * mean_prob_e). With a
    ``batch_axis`` of the active mesh that splits the rows, the means are
    the whole batch's (sums over its ranks)."""
    probs = torch.softmax(logits, dim=-1).reshape(-1, num_experts)
    ids = top_ids.reshape(-1, top_ids.shape[-1])
    sel = _one_hot(ids[:, 0], num_experts).float()
    n = shd.axis_size(batch_axis)
    if n == 1:
        return num_experts * torch.sum(sel.mean(dim=0) * probs.mean(dim=0))
    sums = shd.psum(torch.stack([sel.sum(dim=0), probs.sum(dim=0)]),
                    batch_axis)
    frac, mean_prob = sums / (probs.shape[0] * n)
    return num_experts * torch.sum(frac * mean_prob)


def _swiglu_experts(experts, x_e):
    """x_e [E, C, d] through stacked expert SwiGLU -> [E, C, d]."""
    h = torch.einsum("ecd,edf->ecf", x_e, experts["w1"])
    g = torch.einsum("ecd,edf->ecf", x_e, experts["w3"])
    return torch.einsum("ecf,efd->ecd", F.silu(h) * g, experts["w2"])


def _shared_out(p, x, cfg):
    if "shared" not in p:
        return 0.0
    return swiglu_tp(p["shared"], x,
                     cfg.expert_d_ff * cfg.num_shared_experts)


def _expert_split(cfg):
    """How the expert weights split over the model axis of the active
    mesh: "ep" (each rank its block of the experts), "tp" (each rank its
    block of their ff dim) or None (whole; no mesh, or the dim does not
    divide)."""
    if shd.model_axis() is None:
        return None
    if shd.active_rules().get("experts_mode", "ep") == "ep":
        return "ep" if shd.model_split(cfg.num_experts) else None
    return "tp" if shd.model_split(cfg.expert_d_ff) else None


def _first_expert(ex) -> int:
    """The first expert id of the rank's block (EP)."""
    return shd.axis_index(shd.model_axis()) * ex["w1"].shape[0]


def moe_dense(p, cfg, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact all-experts path. x [B,S,d] -> (y, aux_loss). Under a mesh
    each rank runs its experts (or its ff block of all of them) on its
    rows, and the gate-weighted sum is summed over the model axis."""
    logits, top_probs, top_ids = router_probs(p, cfg, x)
    split = _expert_split(cfg)
    ex = p["experts"]
    h = torch.einsum("bsd,edf->bsef", x, ex["w1"])
    g = torch.einsum("bsd,edf->bsef", x, ex["w3"])
    out_e = torch.einsum("bsef,efd->bsed", F.silu(h) * g, ex["w2"])
    gates = torch.zeros(logits.shape, dtype=torch.float32, device=x.device)
    gates.scatter_(-1, top_ids, top_probs)
    if split == "ep":
        gates = gates.narrow(-1, _first_expert(ex), ex["w1"].shape[0])
    y = torch.einsum("bsed,bse->bsd", out_e.float(), gates)
    if split is not None:
        y = shd.psum(y, shd.model_axis())
    y = y.to(x.dtype) + _shared_out(p, x, cfg)
    return y, load_balance_loss(logits, top_ids, cfg.num_experts,
                             shd.batch_axis())


def _dispatch_local(cfg, xf, top_probs, top_ids, capacity: int):
    """Capacity dispatch of one rank's tokens. xf [T,d] -> buf [E,C,d]
    plus the (slot, keep, probs) needed to gather back: position in
    expert by a one-hot cumsum, rows scattered into the buffer, overflow
    sent to a dump row and dropped."""
    T, d = xf.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C = capacity
    fid = top_ids.reshape(T * k)                       # flat expert ids
    fp = top_probs.reshape(T * k)
    oh = _one_hot(fid, E)                              # [T*k, E]
    pos = torch.sum(torch.cumsum(oh, dim=0) * oh, dim=-1) - 1
    keep = pos < C
    slot = torch.where(keep, fid * C + pos, torch.full_like(fid, E * C))
    x_rep = xf.repeat_interleave(k, dim=0)             # [T*k, d]
    buf = torch.zeros((E * C + 1, d), dtype=xf.dtype, device=xf.device)
    buf.index_add_(0, slot, x_rep)   # one row per kept slot: exact
    return buf[:E * C].reshape(E, C, d), slot, keep, fp


def _combine(out_e, slot, keep, fp, k: int, dtype):
    """The experts' rows [E, C, d] gathered back to their tokens and
    gate-weighted: [T, d]."""
    E, C, d = out_e.shape
    out_flat = out_e.reshape(E * C, d)
    gathered = torch.where(keep[:, None],
                           out_flat[torch.clamp(slot, max=E * C - 1)],
                           torch.zeros((), dtype=out_flat.dtype,
                                       device=out_flat.device))
    y = (gathered.float() * fp[:, None]).reshape(-1, k, d).sum(dim=1)
    return y.to(dtype)


def _capacity(T: int, cfg, capacity_factor: Optional[float]) -> int:
    """Slots an expert for T tokens: ceil(T k cf / E), at least 8, a
    multiple of 8."""
    cf = capacity_factor if capacity_factor is not None else \
        cfg.capacity_factor
    C = max(int(math.ceil(T * cfg.num_experts_per_tok * cf
                          / cfg.num_experts)), 8)
    return -(-C // 8) * 8


def moe_capacity(p, cfg, x, *, capacity_factor: Optional[float] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-bounded scatter dispatch. x [B,S,d] -> (y, aux_loss).

    Position-in-expert by a one-hot cumsum; rows scatter into an
    [E, C, d] buffer (overflow goes to a dump row and is dropped); the
    stacked expert FFN runs; the outputs gather back gate-weighted.
    Under a mesh the rank's rows are gathered into the whole batch first
    (the capacity and the drops are the whole batch's); each rank runs
    its experts on their slots, gathered over the model axis ("ep"), or
    its ff block of every expert, summed over it ("tp"); then it keeps
    its rows."""
    rows = x
    # one autograd node between the rank's rows and the batch's, with a
    # batch axis or without: the router's and the dispatch's gradients
    # are summed there before the shared experts' is added to them, in
    # the same order either way (bitwise at one rank)
    x = shd.gather_rows(x) if shd.batch_axis() is not None else x.view_as(x)
    B, S, d = x.shape
    C = _capacity(B * S, cfg, capacity_factor)
    logits, top_probs, top_ids = router_probs(p, cfg, x)
    aux = load_balance_loss(logits, top_ids, cfg.num_experts)
    x_e, slot, keep, fp = _dispatch_local(cfg, x.reshape(B * S, d),
                                          top_probs, top_ids, C)
    split = _expert_split(cfg)
    ex = p["experts"]
    m = shd.model_axis()
    if split == "ep":
        out_e = _swiglu_experts(ex, x_e.narrow(0, _first_expert(ex),
                                               ex["w1"].shape[0]))
        out_e = shd.all_gather(out_e, m, 0)
    else:
        out_e = _swiglu_experts(ex, x_e)
        if split == "tp":
            out_e = shd.psum(out_e, m)
    y = _combine(out_e, slot, keep, fp, cfg.num_experts_per_tok, x.dtype)
    y = shd.batch_rows(y.reshape(B, S, d))
    return y + _shared_out(p, rows, cfg), aux


def moe_gather(p, cfg, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weight-gather path for tiny token counts: gathers only the
    selected experts' weights ([T,k,d,ff] slices). Under a mesh a rank
    gathers from its slice: its experts' picks ("ep": the others weigh
    zero) or its ff block ("tp"), summed over the model axis."""
    B, S, d = x.shape
    T = B * S
    logits, top_probs, top_ids = router_probs(p, cfg, x)
    aux = load_balance_loss(logits, top_ids, cfg.num_experts,
                             shd.batch_axis())
    xf = x.reshape(T, d)
    ids = top_ids.reshape(T, -1)                       # [T, k]
    probs = top_probs.reshape(T, -1)
    split = _expert_split(cfg)
    ex = p["experts"]
    if split == "ep":
        lo, n = _first_expert(ex), ex["w1"].shape[0]
        mine = (ids >= lo) & (ids < lo + n)
        ids = torch.where(mine, ids - lo, torch.zeros_like(ids))
        probs = probs * mine
    w1, w3, w2 = ex["w1"][ids], ex["w3"][ids], ex["w2"][ids]
    h = torch.einsum("td,tkdf->tkf", xf, w1)
    g = torch.einsum("td,tkdf->tkf", xf, w3)
    out = torch.einsum("tkf,tkfd->tkd", F.silu(h) * g, w2)
    y = torch.einsum("tkd,tk->td", out.float(), probs)
    if split is not None:
        y = shd.psum(y, shd.model_axis())
    return y.to(x.dtype).reshape(B, S, d) + _shared_out(p, x, cfg), aux


def _exchange(t, axis):
    """One all-to-all on ``axis``: block i of ``t``'s leading dim goes to
    rank i; returns the blocks received, block j from rank j. Its
    backward is the same exchange of the cotangents, reversed."""
    return shd.all_to_all(t, axis)


def moe_ep_shardmap(p, cfg, x, *, capacity_factor: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE with explicit all-to-alls over the model axis
    (the JAX package's ``shard_map`` path). x [B,S,d] is the rank's batch
    rows, whole along the sequence.

    Every rank dispatches a disjoint token slice — its rows, and its
    block of S / ep positions — into a local [E, C, d] buffer, C from the
    rank's T = B * S / ep tokens. The first ``all_to_all_single`` sends
    block j of E / ep experts to rank j, which runs its experts on the
    [E / ep, ep * C, d] slots of all ranks; the second sends each rank's
    slots back. The gate-weighted outputs are gathered along the
    sequence, and the shared expert (ff-split, summed over the model
    axis) runs on the rows. Aux is the mean of the ranks' losses over
    the batch and model axes. Requires an active mesh, E % ep == 0 and
    S % ep == 0."""
    mesh = shd.active_mesh()
    if mesh is None or shd.model_axis() is None:
        raise ValueError("moe_ep_shardmap needs an active mesh with a "
                         "model rule (sharding.sharding_ctx)")
    m = shd.model_axis()
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    ep = shd.axis_size(m)
    if E % ep or S % ep:
        raise ValueError(f"EP needs the {E} experts and the {S} positions "
                         f"to split over the model axis ({ep} ranks)")
    Sl = S // ep
    C = _capacity(B * Sl, cfg, capacity_factor)
    xl = x.narrow(1, shd.axis_index(m) * Sl, Sl)
    logits, top_probs, top_ids = router_probs(p, cfg, xl)
    buf, slot, keep, fp = _dispatch_local(cfg, xl.reshape(B * Sl, d),
                                          top_probs, top_ids, C)
    ex = p["experts"]
    El = E // ep
    # [E, C, d] -> each owner's [E/ep, ep*C, d], slots in source order
    buf = _exchange(buf.reshape(ep, El, C, d), m)
    buf = buf.transpose(0, 1).reshape(El, ep * C, d)
    out = _swiglu_experts(ex, buf)
    out = out.reshape(El, ep, C, d).transpose(0, 1)
    out = _exchange(out, m).reshape(E, C, d)      # back to [E, C, d]
    y = _combine(out, slot, keep, fp, k, x.dtype).reshape(B, Sl, d)
    aux = load_balance_loss(logits, top_ids, E)    # the rank's own
    axes = shd.entry_axes(shd.batch_axis()) + (m,)
    aux = shd.psum(aux, axes) / shd.axis_size(axes)
    y = shd.all_gather(y, m, 1)
    return y + _shared_out(p, x, cfg), aux


def moe_apply(p, cfg, x, *, path: str = "auto"):
    """path: 'dense' | 'capacity' | 'gather' | 'ep' | 'auto'. ``auto``
    chooses as the JAX package does, from the whole batch's token count
    (under a mesh ``x`` is the rank's rows of it)."""
    if path == "dense":
        return moe_dense(p, cfg, x)
    if path == "capacity":
        return moe_capacity(p, cfg, x)
    if path == "gather":
        return moe_gather(p, cfg, x)
    if path == "ep":
        return moe_ep_shardmap(p, cfg, x)
    if path != "auto":
        raise ValueError(f"unknown moe path {path!r}")
    T = x.shape[0] * x.shape[1] * shd.axis_size(shd.batch_axis())
    if T <= 256 and cfg.num_experts <= 8:
        return moe_dense(p, cfg, x)
    if T * cfg.num_experts_per_tok <= cfg.num_experts:
        return moe_gather(p, cfg, x)
    rules = shd.active_rules()
    if (shd.model_axis() is not None and rules.get("experts_mode") == "ep"
            and rules.get("moe_shardmap", True)):
        ep = shd.axis_size(shd.model_axis())
        if T >= 4096 and x.shape[1] % ep == 0:
            return moe_ep_shardmap(p, cfg, x)
    return moe_capacity(p, cfg, x)
