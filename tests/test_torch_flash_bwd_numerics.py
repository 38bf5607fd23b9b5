"""The precision argument for the flash-attention backward kernel's
tensor-core design (``csrc/flash_attention_bwd.cu``), on the CPU.

The kernel runs all seven of its products (rows launch: S = Q.K^T,
dP = dO.V^T, dQ += dS.K; keys launch: S^T = K.Q^T, dP^T = V.dO^T,
dV += P^T.dO, dK += dS^T.Q) on TF32 operands, split 3xTF32, and forms
D = sum_j P dP in its first pass over the keys from the same S and dP
that later form dS, rescaled online as the softmax denominator is. This
test repeats that arithmetic in torch at S = 256 with keys that share a
common part ten times their random part (as Qwen1.5's k bias makes them)
and holds dq, dk and dv against float64 autograd of attention at the
backward's fp32 tolerance, 2e-5 x max |float64| (``chip_smoke.py``).

One TF32 pass misses it. So does D = dO . O with O as the forward kernel
makes it (its own 3xTF32 S, summed in another order, then 3xTF32 P.V):
an error e in D[i] reaches dq[i] as e * sum_j P[i,j] k_j, which the
common key part makes large against dq. That is why the kernel takes D
from its own products and never reads the forward's O.

The kernels issue those products as ``wgmma`` k8 steps on the TF32
tensor cores: three MMAs a step (lo.hi, hi.lo, then hi.hi), each summed
into the fp32 accumulator with the sum truncated toward zero.
``_wgmma_grads`` repeats that order (``_mm3``), the rows launch's two
warpgroups taking alternate 32-key tiles and merging their softmax stats,
and the keys launch's walk of 64-key blocks in 32-row tiles split over a
cluster; dQ, dK and dV sum each tile from zero and add it to their
running sum in fp32, which rounds to nearest. That holds 2e-5 x max of
float64. One accumulator through a key block's whole walk does not: at
Mixtral's call (G 4) the first keys see 8192 rows, 3072 truncating adds,
and their dV drifts past 2e-5 x max."""
import math

import numpy as np
import pytest
import torch

from test_torch_kernels import _mm_tf32, _tf32

TOL = 2e-5          # chip_smoke.py's TOL["flash_attention_bwd"], x max
S, KV, TILE = 256, 2, 16   # TILE: the kernel's keys a ring stage
LOG2E = 1.4426950408889634
# (hd, G): Qwen1.5-0.5B's head width, MHA; Mixtral's, 4 heads a KV head.
# Over seeds 0-11 the forward-O D's dq error spans 1.6e-5 .. 5.2e-5 at
# hd 64 / G 1 (10 of 12 miss TOL) and 1.9e-5 .. 1.1e-4 at hd 128 / G 4
# (11 of 12), at least 3.5x the kernel D's; seed 22: 3.9e-5 and 4.3e-5
SHAPES = [(64, 1), (128, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(hd, G, seed=22):
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    q = normal(G * KV, S, hd)
    k = normal(KV, S, hd) + 10.0 * normal(KV, 1, hd)   # a common part
    v, dout = normal(KV, S, hd), normal(G * KV, S, hd)
    return q, k, v, dout


def _float64_grads(q, k, v, dout, G):
    """(dq, dk, dv) by float64 autograd of causal attention, masked
    scores set to -1e30 as the kernels set them."""
    q, k, v = (t.double().requires_grad_() for t in (q, k, v))
    kr, vr = (t.repeat_interleave(G, 0) for t in (k, v))
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    s = q @ kr.transpose(1, 2) / math.sqrt(q.shape[-1])
    s = torch.where(keep, s, torch.tensor(-1e30, dtype=torch.float64))
    out = torch.softmax(s, dim=-1) @ vr
    return torch.autograd.grad(out, (q, k, v), dout.double())


def _kernel_grads(q, k, v, dout, G, passes, d_from="kernel"):
    """(dq, dk, dv) with every product on TF32 operands (``passes`` 1 or
    3) and the kernel's elementwise steps in fp32: scores in log2 units,
    the online max / denominator over 16-key tiles, P = exp2(s - m) / l.
    ``d_from``: "kernel" takes D = sum P dP from pass 1's online sums;
    "forward_o" takes D = dO . O from the forward's own S."""
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    sc = scale * LOG2E
    kr, vr = (t.repeat_interleave(G, 0) for t in (k, v))
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    neg = torch.tensor(-1e30)

    # rows launch
    s2 = torch.where(keep, _mm_tf32(q, kr.transpose(1, 2), passes) * sc,
                     neg)
    dp = _mm_tf32(dout, vr.transpose(1, 2), passes)
    H = q.shape[0]
    m, l, ld = (torch.full((H, S), -1e30), torch.zeros(H, S),
                torch.zeros(H, S))
    for k0 in range(0, S, TILE):            # pass 1
        tile = s2[:, :, k0:k0 + TILE]
        m_new = torch.maximum(m, tile.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(tile - m_new[..., None])
        l = l * corr + p.sum(-1)
        ld = ld * corr + (p * dp[:, :, k0:k0 + TILE]).sum(-1)
        m = m_new
    il = 1.0 / l
    p = torch.exp2(s2 - m[..., None]) * il[..., None]
    if d_from == "kernel":
        d = ld * il
    else:
        # the forward kernel's O: S summed in its own order (its pair
        # loads take dims 2t, 2t + 1), its softmax, then P.V, 3xTF32
        perm = torch.cat([torch.arange(0, hd, 2), torch.arange(1, hd, 2)])
        s_fwd = _mm_tf32(q[..., perm], kr[..., perm].transpose(1, 2), 3)
        p_fwd = torch.softmax(torch.where(keep, s_fwd * scale, neg), -1)
        d = (dout * _mm_tf32(p_fwd, vr, 3)).sum(-1)
    ds = torch.where(keep, p * (dp - d[..., None]), torch.tensor(0.0))
    dq = _mm_tf32(ds, kr, passes) * scale

    # keys launch: the keys as M rows, the rows' m, 1 / l and D read back
    keep_t = keep.T
    s2_t = torch.where(keep_t, _mm_tf32(kr, q.transpose(1, 2), passes) * sc,
                       neg)
    p_t = torch.exp2(s2_t - m[:, None, :]) * il[:, None, :]
    dp_t = _mm_tf32(vr, dout.transpose(1, 2), passes)
    ds_t = torch.where(keep_t, p_t * (dp_t - d[:, None, :]),
                       torch.tensor(0.0))
    dv = _mm_tf32(p_t, dout, passes).reshape(KV, G, S, hd).sum(1)
    dk = (_mm_tf32(ds_t, q, passes) * scale).reshape(KV, G, S, hd).sum(1)
    return dq, dk, dv


KEY_TILE = 32     # the rows launch's keys a tile (hd <= 128)
ROW_TILE = 32     # the keys launch's rows a tile (hd <= 128)
BLOCK_KEYS = 64   # the keys launch's keys a block
SLOTS = 2 * 132   # a causal keys launch's slots: 2 x the H100's SMs


def _trunc32(x):
    """float64 values to fp32, rounded toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def _mm3(a, b, acc=None):
    """a @ b as the kernels' wgmma k8 steps compute it in 3xTF32: a (A)
    and b (B) split hi = tf32(x), lo = tf32(x - hi); each 8-deep slice of
    the contraction three MMAs, A.lo B.hi, A.hi B.lo, A.hi B.hi, each
    summed exactly (TF32 products are exact in fp32) and added to the fp32
    accumulator, the sum truncated toward zero. ``acc``: an accumulator
    to go on from (None: from zero)."""
    pad = (-a.shape[-1]) % 8
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    passes = [(al.double(), bh.double()), (ah.double(), bl.double()),
              (ah.double(), bh.double())]
    out = (torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float64)
           if acc is None else acc.double())
    for c in range(0, a.shape[-1], 8):
        for x, y in passes:
            out = _trunc32(out + x[..., c:c + 8] @ y[..., c:c + 8, :]).double()
    return out.float()


def _tiles_sum(a, b, rows, in_place=False):
    """a [.., M, L] @ b [.., L, N] over L in tiles of ``rows``: each
    tile's ``_mm3`` from zero, added to the running sum in fp32 (to
    nearest); ``in_place``: one accumulator through every tile instead."""
    total = None
    for lo in range(0, a.shape[-1], rows):
        part = _mm3(a[..., lo:lo + rows], b[..., lo:lo + rows, :],
                    total if in_place else None)
        total = part if in_place or total is None else total + part
    return total


def _walk(x, G):
    """[G KV, S, w] per head -> [KV, S G, w]: the keys launch's rows."""
    h, s, w = x.shape
    return x.reshape(h // G, G, s, w).transpose(1, 2).reshape(h // G, s * G, w)


def _keys_sum(a_t, b, G, interleave):
    """dK^T or dV^T as the keys launch sums it: a_t [KV, S, S G] (dS^T or
    P^T: keys x the walk's rows, position-major, the G heads inner), b
    [KV, S G, w] (Q or dO). A block of BLOCK_KEYS keys walks the rows from
    its first key's position on (causal) in tiles of ROW_TILE, split over
    a cluster of cs blocks as the launcher sizes it; each rank sums its run
    of tiles (``_tiles_sum``, A = b^T, B = a_t^T) and rank 0 adds the
    others' in rank order, in fp32. ``interleave`` (hd <= 64): a rank's
    warpgroup w sums its tiles j = w mod 2, and warpgroup 0 adds 1's.
    Returns [KV, S, w]."""
    kv, s = a_t.shape[0], a_t.shape[1]
    blocks = -(-s // BLOCK_KEYS)
    cs = max(1, min(4, SLOTS // (kv * blocks)))
    out = []
    for k0 in range(0, s, BLOCK_KEYS):
        walk = a_t[:, k0:k0 + BLOCK_KEYS, k0 * G:]
        nsteps = -(-walk.shape[-1] // ROW_TILE)
        total = None
        for r in range(cs):
            lo = r * nsteps // cs * ROW_TILE
            hi = (r + 1) * nsteps // cs * ROW_TILE
            bt = b[:, k0 * G + lo:k0 * G + hi].transpose(1, 2)
            wt = walk[..., lo:hi].transpose(1, 2)
            if interleave:               # two warpgroups, alternate tiles
                t = ROW_TILE
                sums = [_tiles_sum(torch.cat([bt[..., x:x + t] for x in
                                              range(w * t, bt.shape[-1],
                                                    2 * t)], -1),
                                   torch.cat([wt[:, x:x + t] for x in
                                              range(w * t, wt.shape[1],
                                                    2 * t)], 1), t)
                        if bt.shape[-1] > w * t else None for w in (0, 1)]
                part = (sums[0] if sums[1] is None
                        else sums[0] + sums[1]) if sums[0] is not None \
                    else None
            else:
                part = _tiles_sum(bt, wt, ROW_TILE)
            if part is not None:         # a rank with no tile adds 0
                total = part if total is None else total + part
        out.append(total.transpose(1, 2))
    return torch.cat(out, 1)


def _wgmma_grads(q, k, v, dout, G):
    """(dq, dk, dv) in the wgmma kernels' order (``_mm3``): S = Q.K^T
    and dP = dO.V^T (the keys launch's S^T and dP^T sum the same terms in
    the same order: their transposes, value for value); the rows launch's
    warpgroup w walks the key tiles t = w mod 2 for its online (m, l, l D),
    the two merged (warpgroup 0's first) into m, 1 / l and D, then dQ^T
    = K^T.dS^T tile by tile, each warpgroup's partials summed in fp32 and
    warpgroup 0's added to 1's; the keys launch's dK^T = Q^T.dS and dV^T
    = dO^T.P by ``_keys_sum`` (warpgroups on alternate row tiles at
    hd <= 64)."""
    hd, s = q.shape[-1], q.shape[1]
    scale = 1.0 / math.sqrt(hd)
    sc = scale * LOG2E
    kr, vr = (t.repeat_interleave(G, 0) for t in (k, v))
    keep = torch.ones(s, s, dtype=torch.bool).tril()
    neg = torch.tensor(-1e30)
    s2 = torch.where(keep, _mm3(q, kr.transpose(1, 2)) * sc, neg)
    dp = _mm3(dout, vr.transpose(1, 2))
    H = q.shape[0]
    stats = []
    for w in (0, 1):                     # pass 1, a warpgroup's tiles
        m, l, ld = (torch.full((H, s), -1e30), torch.zeros(H, s),
                    torch.zeros(H, s))
        for k0 in range(w * KEY_TILE, s, 2 * KEY_TILE):
            tile = s2[:, :, k0:k0 + KEY_TILE]
            m_new = torch.maximum(m, tile.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(tile - m_new[..., None])
            l = l * corr + p.sum(-1)
            ld = ld * corr + (p * dp[:, :, k0:k0 + KEY_TILE]).sum(-1)
            m = m_new
        stats.append((m, l, ld))
    (m0, l0, d0), (m1, l1, d1) = stats
    m = torch.maximum(m0, m1)
    c0, c1 = torch.exp2(m0 - m), torch.exp2(m1 - m)
    il = 1.0 / (l0 * c0 + l1 * c1)
    d = (d0 * c0 + d1 * c1) * il
    p = torch.exp2(s2 - m[..., None]) * il[..., None]
    ds = torch.where(keep, p * (dp - d[..., None]), torch.tensor(0.0))
    kt, dst = kr.transpose(1, 2), ds.transpose(1, 2)
    dqt = [None, None]
    for w in (0, 1):                     # pass 2: dQ^T, tile partials
        for k0 in range(w * KEY_TILE, s, 2 * KEY_TILE):
            part = _mm3(kt[:, :, k0:k0 + KEY_TILE], dst[:, k0:k0 + KEY_TILE])
            dqt[w] = part if dqt[w] is None else dqt[w] + part
    dq = ((dqt[0] + dqt[1]) * scale).transpose(1, 2)
    del s2, dp
    p_t, ds_t = (_walk(x, G).transpose(1, 2) for x in (p, ds))
    interleave = hd <= 64
    dv = _keys_sum(p_t, _walk(dout, G), G, interleave)
    dk = _keys_sum(ds_t, _walk(q, G), G, interleave) * scale
    return dq, dk, dv


def _errors(got, want):
    return [float((g.double() - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]


@pytest.mark.parametrize("hd,G", SHAPES)
def test_flash_bwd_3xtf32_with_kernel_d_holds_fp32_tolerance(hd, G):
    q, k, v, dout = _inputs(hd, G)
    want = _float64_grads(q, k, v, dout, G)
    three = _errors(_kernel_grads(q, k, v, dout, G, 3), want)
    assert max(three) <= TOL / 4, three     # dq, dk, dv
    one = _errors(_kernel_grads(q, k, v, dout, G, 1), want)
    assert min(one) > 10 * TOL, one         # one TF32 pass misses, each


@pytest.mark.parametrize("hd,G", SHAPES)
def test_flash_bwd_d_from_forward_output_misses_on_dq(hd, G):
    q, k, v, dout = _inputs(hd, G)
    want = _float64_grads(q, k, v, dout, G)
    own = _errors(_kernel_grads(q, k, v, dout, G, 3), want)
    fwd_o = _errors(_kernel_grads(q, k, v, dout, G, 3, "forward_o"), want)
    assert fwd_o[0] > TOL, (fwd_o, own)        # dq
    assert fwd_o[0] > 4 * own[0], (fwd_o, own)
    # dk and dv barely move: the leak is along sum_j P k_j, into dq
    assert max(fwd_o[1:]) <= TOL / 4, fwd_o


@pytest.mark.parametrize("hd,G", SHAPES)
def test_flash_bwd_wgmma_order_with_tile_partials_holds_fp32_tolerance(hd, G):
    q, k, v, dout = _inputs(hd, G)
    want = _float64_grads(q, k, v, dout, G)
    got = _errors(_wgmma_grads(q, k, v, dout, G), want)
    assert max(got) <= TOL / 2, got          # dq, dk, dv


@pytest.mark.parametrize("in_place", [False, True])
def test_flash_bwd_key_block_of_8192_rows(in_place):
    """dV of the first 64 keys at Mixtral's call (S 2048 causal, G 4, vd
    128): they see all 8192 (position, head) rows. Tile partials of 32
    rows added in fp32 hold 2e-5 x max of float64; one truncating
    accumulator through the walk (1024 k8 steps, 3072 adds) does not."""
    rng = np.random.default_rng(22)
    s, g, w = 2048, 4, 128
    q = torch.from_numpy(rng.normal(size=(g, s, w)))
    k = torch.from_numpy(rng.normal(size=(1, s, w)))
    dout = torch.from_numpy(rng.normal(size=(g, s, w)).astype(np.float32))
    keep = torch.ones(s, s, dtype=torch.bool).tril()
    scores = torch.where(keep, q @ k.transpose(1, 2) / math.sqrt(w),
                         torch.tensor(-1e30, dtype=torch.float64))
    p = torch.softmax(scores, -1)[..., :BLOCK_KEYS].float()   # [g, s, 64]
    p_t, do_walk = _walk(p, g).transpose(1, 2), _walk(dout, g)
    want = (p_t.double() @ do_walk.double())[0]              # [64, w]
    got = _tiles_sum(do_walk.transpose(1, 2), p_t.transpose(1, 2), ROW_TILE,
                     in_place)[0].T
    err = float((got.double() - want).abs().max() / want.abs().max())
    assert (err > TOL) if in_place else (err <= TOL / 4), err
