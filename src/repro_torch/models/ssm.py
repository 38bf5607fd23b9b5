"""Mamba2 / SSD (state-space duality) mixer (port of ``repro.models.ssm``).
[arXiv:2405.21060]

The full-sequence path is the chunked SSD algorithm: quadratic within a
chunk (``ops.ssd_chunk``, one kernel launch per layer over every chunk
of every sequence, since the intra-chunk outputs do not depend on the
carried state), then a linear recurrence across chunks in torch ops.
Decode is the O(1)-per-token state recurrence. Single B/C group.

State layout:
  ssd  [B, H, P, N]   (H = heads, P = headdim, N = ssm_state), fp32
  conv [B, W-1, di + 2N]
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import dense_init, rms_norm


def init_ssm(gen: torch.Generator, cfg, dtype, *, layers: int,
             device="cuda"):
    """Stacked Mamba2 mixer params for ``layers`` layers (JAX init
    scales; ``A_log``, ``D`` and ``dt_bias`` fp32)."""
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H, W = cfg.ssm_nheads, cfg.ssm_conv_width
    conv_dim = di + 2 * N
    L = layers
    res_scale = 1.0 / math.sqrt(2 * cfg.num_layers)
    f32 = dict(dtype=torch.float32, device=device)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, **f32) * (hi - lo) + lo

    # inverse softplus of dt drawn log-uniformly in [1e-3, 1e-1]
    dt = torch.exp(uniform((L, H), math.log(1e-3), math.log(1e-1)))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    conv_w = torch.randn((L, W, conv_dim), generator=gen, **f32)
    return {
        "in_z": dense_init(gen, (L, d, di), d, dtype=dtype, device=device),
        "in_xbc": dense_init(gen, (L, d, conv_dim), d, dtype=dtype,
                             device=device),
        "in_dt": dense_init(gen, (L, d, H), d, dtype=dtype, device=device),
        "conv_w": (conv_w * (1.0 / math.sqrt(W))).to(dtype),
        "conv_b": torch.zeros((L, conv_dim), dtype=dtype, device=device),
        "A_log": torch.log(uniform((L, H), 1.0, 16.0)),
        "D": torch.ones((L, H), **f32),
        "dt_bias": dt_bias,
        "norm": torch.ones((L, di), dtype=dtype, device=device),
        "out_proj": dense_init(gen, (L, di, d), di, scale=res_scale,
                               dtype=dtype, device=device),
    }


def _split_proj(p, cfg, x):
    return x @ p["in_z"], x @ p["in_xbc"], x @ p["in_dt"]


def _conv_full(p, xBC):
    """Causal depthwise conv over [B, L, C]: the shifted multiply-add of
    the reference (no ``conv1d``, so no cuDNN TF32 on the card)."""
    W = p["conv_w"].shape[0]
    L = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + L, :] * p["conv_w"][i] for i in range(W))
    return F.silu(out + p["conv_b"])


def ssd_full(p, cfg, x):
    """x [B, L, d] -> y [B, L, d]; L must be a multiple of the chunk
    ``min(cfg.ssm_chunk, L)`` (callers pad)."""
    B, L, d = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    Q = min(cfg.ssm_chunk, L)
    if L % Q:
        raise ValueError(f"ssd_full: length {L} is not a multiple of the "
                         f"chunk {Q}")
    nC = L // Q

    z, xBC, dt = _split_proj(p, cfg, x)
    xBC = _conv_full(p, xBC)
    xs = xBC[..., :di].reshape(B, L, H, P)
    Bm = xBC[..., di:di + N].float()
    Cm = xBC[..., di + N:].float()

    dt = F.softplus(dt.float() + p["dt_bias"])                   # [B,L,H]
    A = -torch.exp(p["A_log"])                                    # [H]
    dA = dt * A                                                   # [B,L,H]
    xw = xs.float() * dt[..., None]                               # [B,L,H,P]

    # every chunk of every sequence in one launch: G = B * nC
    y_intra, s_chunk = kops.ssd_chunk(
        dA.reshape(B * nC, Q, H), xw.reshape(B * nC, Q, H, P),
        Bm.reshape(B * nC, Q, N).contiguous(),
        Cm.reshape(B * nC, Q, N).contiguous())
    y_intra = y_intra.reshape(B, nC, Q, H, P)
    s_chunk = s_chunk.reshape(B, nC, H, P, N)
    cum = torch.cumsum(dA.reshape(B, nC, Q, H), dim=2)            # [B,nC,Q,H]
    C_c = Cm.reshape(B, nC, Q, N)

    # inter-chunk: the carried state's contribution, then the state update
    S = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nC):
        y_inter = torch.einsum("bin,bhpn,bih->bihp", C_c[:, c], S,
                               torch.exp(cum[:, c]))
        ys.append(y_intra[:, c] + y_inter)
        S = torch.exp(cum[:, c, -1])[:, :, None, None] * S + s_chunk[:, c]
    y = torch.stack(ys, dim=1).reshape(B, L, H, P)
    y = y + p["D"][None, None, :, None] * xs.float()
    y = y.reshape(B, L, di).to(x.dtype)

    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"]


def ssm_state_init(cfg, batch: int, dtype, device="cuda"):
    di, N = cfg.d_inner, cfg.ssm_state
    H, P, W = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_conv_width
    return {
        "ssd": torch.zeros((batch, H, P, N), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, W - 1, di + 2 * N), dtype=dtype,
                            device=device),
    }


def ssd_decode(p, cfg, x, state):
    """x [B,1,d]; O(1) recurrent step. Returns (y [B,1,d], new_state)."""
    B = x.shape[0]
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    z, xBC, dt = _split_proj(p, cfg, x[:, 0, :])

    # conv ring: window = [conv_state ; xBC]
    win = torch.cat([state["conv"], xBC[:, None, :].to(state["conv"].dtype)],
                    dim=1)                                        # [B, W, C]
    conv_out = torch.einsum("bwc,wc->bc", win.float(), p["conv_w"].float())
    xBC = F.silu(conv_out + p["conv_b"].float())
    new_conv = win[:, 1:, :]

    xs = xBC[..., :di].reshape(B, H, P)
    Bm = xBC[..., di:di + N]
    Cm = xBC[..., di + N:]

    dt = F.softplus(dt.float() + p["dt_bias"])                    # [B,H]
    a = torch.exp(dt * -torch.exp(p["A_log"]))                    # [B,H]
    xw = xs * dt[..., None]                                       # [B,H,P]

    S = state["ssd"] * a[:, :, None, None] + torch.einsum(
        "bhp,bn->bhpn", xw, Bm)
    y = torch.einsum("bhpn,bn->bhp", S, Cm) + p["D"][None, :, None] * xs
    y = y.reshape(B, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    y = (y @ p["out_proj"])[:, None, :]
    return y, {"ssd": S, "conv": new_conv}
