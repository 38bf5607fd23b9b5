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

Under a device mesh (``sharding.sharding_ctx``, the params cut by
``sharding.shard_params``) the mixer is split by head over the model
axis, as the JAX package's rules lay it out: ``in_z`` / ``in_xbc`` /
``in_dt`` and the conv are column-parallel, ``out_proj`` row-parallel
(one all-reduce after it), ``norm``, ``A_log``, ``D`` and ``dt_bias``
whole, so each rank takes its heads' part of them. A rank's columns of
``xBC`` do not line up with its heads (B and C sit at the end, on the
last ranks), so after the per-channel conv one ``all_to_all_single``
hands each rank its heads' x channels and the whole B and C
(``_redistribute``); ``ops.ssd_chunk`` then runs on the rank's heads. The
gated RMSNorm's mean of squares is over all of di: one all-reduce of the
ranks' block means. Decode gathers the new ``xBC`` row (the conv state
is whole on the model axis), convolves the rank's columns and
redistributes them the same way; the ``ssd`` state is the rank's heads.
A head count that does not split over the model axis raises.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models import sharding as shd
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


def _heads(cfg):
    """(first head, heads, model axis) of this rank: its block of the
    heads over the active mesh's model axis, or (0, H, None) without
    one. A head count that does not split raises (the JAX package's
    partitioner would run it; the port cuts the heads evenly)."""
    H = cfg.ssm_nheads
    m = shd.model_axis()
    if m is None:
        return 0, H, None
    n = shd.axis_size(m)
    if H % n:
        raise ValueError(f"the SSM's {H} heads do not split over {m!r} "
                         f"({n} ranks)")
    return shd.axis_index(m) * (H // n), H // n, m


def _redistribute(t, cfg, axis):
    """``t [..., c]``, this rank's block of the post-conv ``xBC`` columns
    (c = (di + 2N) / n), -> ``[..., di/n + 2N]``: its heads' x channels,
    then the whole B and C, by one ``all_to_all_single`` over ``axis``.
    Rank s takes columns [s·di/n, (s+1)·di/n) and [di, di + 2N); each
    rank sends what of its block falls there, and the blocks received in
    rank order are those columns in order. The backward sends the
    cotangents back the same way, reversed."""
    n, r = shd.axis_size(axis), shd.axis_index(axis)
    di, N = cfg.d_inner, cfg.ssm_state
    c, e = t.shape[-1], di // n

    def cols(src, dst):
        """(start, stop) within src's block of the columns dst takes."""
        out = []
        for a, b in ((dst * e, (dst + 1) * e), (di, di + 2 * N)):
            a, b = max(a, src * c), min(b, (src + 1) * c)
            if a < b:
                out.append((a - src * c, b - src * c))
        return out

    rows = t.reshape(-1, t.shape[-1])
    R = rows.shape[0]
    # per destination its columns [R, k], row-major, one after another
    send = [torch.cat([rows[:, a:b] for a, b in cols(r, s)], dim=-1)
            .reshape(-1) for s in range(n) if cols(r, s)]
    widths = [sum(b - a for a, b in cols(q, r)) for q in range(n)]
    out = shd.all_to_all(
        torch.cat(send), axis, out_rows=[R * w for w in widths],
        in_rows=[R * sum(b - a for a, b in cols(r, s)) for s in range(n)])
    got = [blk.view(R, w) for blk, w in zip(out.split([R * w for w in widths]),
                                            widths) if w]
    return torch.cat(got, dim=-1).reshape(*t.shape[:-1], e + 2 * N)


def _rank_xbc(xBC, cfg, lo: int, H: int, axis):
    """(x [..., H·P], B, C [..., N]) of the rank's heads ``lo``..``lo+H``
    from the post-conv ``xBC``: the rank's column block under a split
    (redistributed), else all of it."""
    N, P = cfg.ssm_state, cfg.ssm_headdim
    if _xbc_split(cfg, axis):
        xBC, lo = _redistribute(xBC, cfg, axis), 0
    return xBC[..., lo * P:(lo + H) * P], xBC[..., -2 * N:-N], xBC[..., -N:]


def _xbc_split(cfg, axis) -> bool:
    """Whether ``in_xbc`` and the conv are split over ``axis`` (their
    di + 2N columns divide; else ``shard_params`` left them whole)."""
    return axis is not None and shd.model_split(cfg.d_inner
                                                + 2 * cfg.ssm_state)


def _gated_out(p, cfg, y, z, lo: int, H: int, axis):
    """``rms_norm(y * silu(z)) @ out_proj`` for the rank's heads: the
    norm's mean of squares over all of di (one all-reduce under a split)
    and the row-parallel ``out_proj`` summed over ``axis``."""
    P = cfg.ssm_headdim
    w = p["norm"].narrow(-1, lo * P, H * P)
    y = rms_norm(y * F.silu(z), w, cfg.norm_eps, axis=axis) @ p["out_proj"]
    return y if axis is None else shd.psum(y, axis)


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
    ``min(cfg.ssm_chunk, L)`` (callers pad). Under a mesh: the rank's
    heads (see the module's docstring), y summed over the model axis."""
    B, L, d = x.shape
    N, P = cfg.ssm_state, cfg.ssm_headdim
    Q = min(cfg.ssm_chunk, L)
    if L % Q:
        raise ValueError(f"ssd_full: length {L} is not a multiple of the "
                         f"chunk {Q}")
    nC = L // Q
    lo, H, axis = _heads(cfg)

    z, xBC, dt = _split_proj(p, cfg, x)
    xs, Bm, Cm = _rank_xbc(_conv_full(p, xBC), cfg, lo, H, axis)
    xs = xs.reshape(B, L, H, P)
    Bm, Cm = Bm.float(), Cm.float()

    dt = F.softplus(dt.float() + p["dt_bias"].narrow(-1, lo, H))  # [B,L,H]
    A = -torch.exp(p["A_log"].narrow(-1, lo, H))                  # [H]
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
    y = y + p["D"].narrow(-1, lo, H)[None, None, :, None] * xs.float()
    y = y.reshape(B, L, H * P).to(x.dtype)
    return _gated_out(p, cfg, y, z, lo, H, axis)


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
    """x [B,1,d]; O(1) recurrent step. Returns (y [B,1,d], new_state).
    Under a mesh ``state`` is the rank's: ``ssd`` its heads, ``conv``
    whole, so the new ``xBC`` row is gathered over the model axis."""
    B = x.shape[0]
    N, P = cfg.ssm_state, cfg.ssm_headdim
    lo, H, axis = _heads(cfg)
    z, xBC, dt = _split_proj(p, cfg, x[:, 0, :])
    split = _xbc_split(cfg, axis)
    row = shd.all_gather(xBC, axis, -1) if split else xBC

    # conv ring: window = [conv_state ; xBC], the rank's columns convolved
    win = torch.cat([state["conv"], row[:, None, :].to(state["conv"].dtype)],
                    dim=1)                                        # [B, W, C]
    own = win.narrow(-1, shd.axis_index(axis) * xBC.shape[-1],
                     xBC.shape[-1]) if split else win
    conv_out = torch.einsum("bwc,wc->bc", own.float(), p["conv_w"].float())
    xs, Bm, Cm = _rank_xbc(F.silu(conv_out + p["conv_b"].float()), cfg,
                           lo, H, axis)
    new_conv = win[:, 1:, :]
    xs = xs.reshape(B, H, P)

    dt = F.softplus(dt.float() + p["dt_bias"].narrow(-1, lo, H))  # [B,H]
    a = torch.exp(dt * -torch.exp(p["A_log"].narrow(-1, lo, H)))  # [B,H]
    xw = xs * dt[..., None]                                       # [B,H,P]

    S = state["ssd"] * a[:, :, None, None] + torch.einsum(
        "bhp,bn->bhpn", xw, Bm)
    y = torch.einsum("bhpn,bn->bhp", S, Cm) + \
        p["D"].narrow(-1, lo, H)[None, :, None] * xs
    y = y.reshape(B, H * P).to(x.dtype)
    y = _gated_out(p, cfg, y, z, lo, H, axis)[:, None, :]
    return y, {"ssd": S, "conv": new_conv}
