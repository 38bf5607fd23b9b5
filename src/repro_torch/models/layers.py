"""Shared low-level layers: init, norms, positions, the SwiGLU and GELU
MLPs and the chunked cross entropy (port of ``repro.models.layers``; same
formulas, same fp32 internals)."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models import sharding as shd


# ---------------------------------------------------------------- init
def dense_init(gen: torch.Generator, shape, in_dim: Optional[int] = None,
               scale: float = 1.0, dtype=torch.float32, device="cuda"):
    """Truncated-normal fan-in init (stddev = scale / sqrt(in_dim)),
    drawn on ``device`` from ``gen`` (a generator of that device)."""
    if in_dim is None:
        in_dim = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / math.sqrt(max(in_dim, 1))
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32,
               device="cuda"):
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------- norms
def rms_norm(x, weight, eps: float = 1e-5, axis=None):
    """RMSNorm over the last dim. ``axis``: that dim is split in equal
    blocks over this mesh axis, ``x`` and ``weight`` are the rank's
    block, and the mean of squares is the mean of the ranks' block means
    (one all-reduce; at one rank exactly the unsplit mean)."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    if axis is not None:
        var = shd.psum(var / shd.axis_size(axis), axis)
    out = x * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dt)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) * (x - mu), dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(dt)


# ------------------------------------------------------------ positions
def sinusoidal_positions(positions, dim: int, max_timescale: float = 10_000.0):
    """positions [...,] int -> [..., dim] float32 sinusoidal embedding."""
    half = dim // 2
    freq = torch.exp(-math.log(max_timescale)
                     * torch.arange(half, dtype=torch.float32,
                                    device=positions.device)
                     / max(half - 1, 1))
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions [...] -> cos,sin of shape [..., head_dim//2]."""
    half = head_dim // 2
    exps = -torch.arange(half, dtype=torch.float32,
                         device=positions.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=positions.device), exps)
    ang = positions[..., None].float() * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x [..., H, head_dim]; cos/sin broadcastable to [..., 1, head_dim//2].

    Uses the 'split-half' (rotate_half) convention.
    """
    half = x.shape[-1] // 2
    cos, sin = cos.float(), sin.float()
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- MLPs
def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int, n_layers: int,
                dtype, *, layers: int, device="cuda"):
    """Stacked SwiGLU params for ``layers`` layers: ``w1/w3 [L,d,ff]``,
    ``w2 [L,ff,d]`` (JAX init scales; ``n_layers`` sets the residual
    scale)."""
    res_scale = 1.0 / math.sqrt(2 * max(n_layers, 1))
    L = layers
    return {
        "w1": dense_init(gen, (L, d_model, d_ff), d_model, dtype=dtype,
                         device=device),
        "w3": dense_init(gen, (L, d_model, d_ff), d_model, dtype=dtype,
                         device=device),
        "w2": dense_init(gen, (L, d_ff, d_model), d_ff, scale=res_scale,
                         dtype=dtype, device=device),
    }


def swiglu(params, x):
    h = torch.nn.functional.silu(x @ params["w1"]) * (x @ params["w3"])
    return h @ params["w2"]


def swiglu_tp(params, x, d_ff: int):
    """``swiglu`` under the active mesh: column-parallel ``w1``/``w3``
    and row-parallel ``w2`` over the model axis where it divides
    ``d_ff`` (``params`` from ``shard_params``: the rank's ff block; one
    all-reduce after ``w2``), else whole. ``swiglu`` itself without a
    mesh."""
    if not shd.model_split(d_ff):
        return swiglu(params, x)
    return shd.psum(swiglu(params, x), shd.model_axis())


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int,
                  n_layers: int, dtype, *, layers: int, device="cuda"):
    """Stacked GELU MLP params for ``layers`` layers: ``w1 [L,d,ff]``,
    ``b1 [L,ff]``, ``w2 [L,ff,d]``, ``b2 [L,d]`` (JAX init scales, zero
    biases; ``n_layers`` sets the residual scale)."""
    res_scale = 1.0 / math.sqrt(2 * max(n_layers, 1))
    L = layers
    return {
        "w1": dense_init(gen, (L, d_model, d_ff), d_model, dtype=dtype,
                         device=device),
        "b1": torch.zeros((L, d_ff), dtype=dtype, device=device),
        "w2": dense_init(gen, (L, d_ff, d_model), d_ff, scale=res_scale,
                         dtype=dtype, device=device),
        "b2": torch.zeros((L, d_model), dtype=dtype, device=device),
    }


def _gelu_hidden(params, x):
    return torch.nn.functional.gelu(x @ params["w1"] + params["b1"],
                                    approximate="tanh")


def gelu_mlp(params, x):
    return _gelu_hidden(params, x) @ params["w2"] + params["b2"]


def gelu_tp(params, x, d_ff: int):
    """``gelu_mlp`` under the active mesh: column-parallel ``w1``/``b1``
    and row-parallel ``w2`` over the model axis where it divides
    ``d_ff`` (``params`` from ``shard_params``: the rank's ff block), one
    all-reduce after ``w2``, and ``b2``, whole on every rank, added once
    after it. ``gelu_mlp`` itself without a mesh."""
    if not shd.model_split(d_ff):
        return gelu_mlp(params, x)
    y = shd.psum(_gelu_hidden(params, x) @ params["w2"], shd.model_axis())
    return y + params["b2"]


# ------------------------------------------------------------- the loss
def chunked_softmax_xent(hidden, unembed, labels, *, chunk: int = 512,
                         norm_w=None, eps: float = 1e-5, vocab_axis=None,
                         batch_axis=None):
    """Cross entropy over the vocab without building [B,S,V].

    hidden: [B, S, d]  (before the final norm if ``norm_w`` is given)
    unembed: [d, V]
    labels: [B, S] int
    Loops over ``S // chunk`` sequence chunks (one chunk if S < chunk;
    S must split evenly, as the JAX package's reshape requires); returns
    the mean xent, an fp32 scalar. Each row's log-sum-exp is taken about
    its detached maximum (the shift cancels in the value and in the
    gradient).

    Under a mesh: ``unembed`` is the rank's block [d, V/n] of a vocab
    split in equal blocks over ``vocab_axis`` (``labels`` hold global
    ids), so each rank computes its block of a chunk's logits; the row
    maxima are combined (max), then the sums of the exponentials and the
    label logits, each taken on the rank that owns the label (one sum).
    ``hidden`` and ``labels`` are the rank's rows of a batch split over
    ``batch_axis``: the ranks' sums are summed over it and the mean is
    the whole batch's. With one rank on each axis the collectives leave
    the values as they are: the same bits as with no axis."""
    B, S, d = hidden.shape
    n_chunks = max(S // chunk, 1)
    chunk = S // n_chunks
    if n_chunks * chunk != S:
        raise ValueError(f"chunked_softmax_xent: {S} positions do not split "
                         f"into {n_chunks} chunks of {chunk}")
    V = unembed.shape[1]
    lo = shd.axis_index(vocab_axis) * V if vocab_axis is not None else 0
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        h = hidden[:, c * chunk:(c + 1) * chunk]
        lab = labels[:, c * chunk:(c + 1) * chunk].long() - lo
        if norm_w is not None:
            h = rms_norm(h, norm_w, eps)
        logits = (h @ unembed).float()
        mx = logits.detach().amax(dim=-1, keepdim=True)
        if vocab_axis is not None:
            mx = shd.pmax(mx, vocab_axis)
        sumexp = torch.sum(torch.exp(logits - mx), dim=-1)
        picked = torch.gather(logits, -1, lab.clamp(0, V - 1)[..., None])
        picked = picked[..., 0]
        if vocab_axis is not None:
            own = (lab >= 0) & (lab < V)
            both = shd.psum(torch.stack([sumexp, torch.where(
                own, picked, torch.zeros((), device=picked.device))]),
                vocab_axis)
            sumexp, picked = both[0], both[1]
        lse = torch.log(sumexp) + mx[..., 0]
        total = total + torch.sum(lse - picked)
    n = 1
    if batch_axis is not None:
        total, n = shd.psum(total, batch_axis), shd.axis_size(batch_axis)
    return total / (B * S * n)
