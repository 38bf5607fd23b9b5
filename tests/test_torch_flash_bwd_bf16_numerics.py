"""The precision argument for the flash-attention backward's bf16 design
(``csrc/flash_attention_bwd.cu``, ``flash_bwd_rows_bf16`` and
``flash_bwd_keys_bf16``), on the CPU.

The kernels keep q, k, v and dout in bf16 and run every product as
``wgmma`` k16 steps on the bf16 tensor cores: S = Q.K^T and dP = dO.V^T
(and S^T, dP^T) in one pass, exact products; dQ += dS.K, dV += P^T.dO and
dK += dS^T.Q with P and dS, which are fp32, split into a bf16 hi and a
bf16 lo part (two passes, lo first). Every k16 step adds its products to
the fp32 accumulator in place, and the tensor cores truncate that sum
toward zero. The rows launch's online softmax walks 64-key tiles; the
keys launch sums dK and dV over the walk of a block of 128 keys, the
(position, head) rows position-major, split over a cluster of up to 4
blocks whose partials rank 0 adds in rank order; dq, dk and dv are
rounded to bf16 once. ``_kernel_grads`` repeats that arithmetic in torch
(``_mm_bf16``, ``_keys_sum``) on the common-key inputs of
``test_torch_flash_bwd_numerics`` (keys sharing a part ten times their
random part, as Qwen's k bias makes them), rounded to bf16, and holds the
gradients against float64 autograd of attention on the same values at
``chip_smoke.py``'s BF16_F64_TOL, 2^-8 x max.

The hi + lo split holds it: before the output rounding the arithmetic
stays within 2^-13 x max, at a key block that sees 8192 rows too (1024
positions x 8 heads: half of Qwen2.5-3B's longest walk, which the CPU's
memory does not afford at full length; the truncating adds cost 2^-24 x
the running sum each, on average). One rounded pass does not: dS cancels
(its row sums are 0) and the shared key part turns its rounding into dq
error above 2^-7 x max; one pass of P spends over a quarter of 2^-8 on dv
before the output's own rounding."""
import functools
import math

import numpy as np
import pytest
import torch

from test_torch_flash_bwd_numerics import KV, LOG2E, S

BF16_F64_TOL = 2.0 ** -8   # chip_smoke.py's, x max |float64|
KEY_TILE = 64              # the rows launch's keys a tile (hd <= 192)
ROW_TILE = {64: 64, 128: 32, 192: 16}   # the keys launch's rows a tile
BLOCK_KEYS = 128           # the keys launch's keys a block
SLOTS = 2 * 132            # a causal keys launch's slots: 2 x the H100's SMs
# (hd, vd, G, S, KV): Qwen1.5-0.5B's head width, MHA; Qwen2.5-3B's, 8
# heads a KV head; DeepSeek-V2's MLA widths; Qwen2.5-3B's again with a
# walk of 8192 rows at the first keys
SHAPES = [(64, 64, 1, S, KV), (128, 128, 8, S, KV), (192, 128, 1, S, KV),
          (128, 128, 8, 1024, 1)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _trunc32(x):
    """float64 values to fp32, rounded toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def _mm_bf16(a, b, passes):
    """a @ b as the kernel's wgmma k16 steps compute it: b holds bf16
    values; a is rounded to bf16 (``passes`` 1) or split into hi = bf16(a)
    and lo = bf16(a - hi) (2, lo first); each 16-deep slice of the
    contraction, a pass at a time, summed exactly (the products of bf16
    values are exact in fp32) and added to the fp32 accumulator, the sum
    truncated toward zero."""
    pad = (-a.shape[-1]) % 16
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad)).double()
    hi = _bf16(a)
    parts = [hi] if passes == 1 else [_bf16(a - hi), hi]
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for c in range(0, a.shape[-1], 16):
        for p in parts:
            out = _trunc32(out.double()
                           + p[..., c:c + 16].double() @ b[..., c:c + 16, :])
    return out


def _keys_sum(a_t, b, passes, G, rows):
    """dK or dV as the keys launch sums it: a_t [KV, S, S G] (keys x the
    walk's rows, position-major, the G heads inner), b [KV, S G, w]. A
    block of BLOCK_KEYS keys walks the rows from its first key's position
    on (causal) in tiles of ``rows``, split over a cluster of cs blocks as
    the launcher sizes it; each rank sums its run of tiles in place
    (``_mm_bf16``) and rank 0 adds the others' partials in rank order, in
    fp32."""
    kv, s = a_t.shape[0], a_t.shape[1]
    blocks = -(-s // BLOCK_KEYS)
    cs = max(1, min(4, SLOTS // (kv * blocks)))
    out = []
    for k0 in range(0, s, BLOCK_KEYS):
        walk = a_t[:, k0:k0 + BLOCK_KEYS, k0 * G:]
        nsteps = -(-walk.shape[-1] // rows)
        total = None
        for r in range(cs):
            lo, hi = r * nsteps // cs * rows, (r + 1) * nsteps // cs * rows
            part = _mm_bf16(walk[..., lo:hi], b[:, k0 * G + lo:k0 * G + hi],
                            passes)
            total = part if total is None else total + part
        out.append(total)
    return torch.cat(out, 1)


def _walk(x, G):
    """[G KV, S, w] per head -> [KV, S G, w]: the keys launch's rows."""
    h, s, w = x.shape
    return x.reshape(h // G, G, s, w).transpose(1, 2).reshape(h // G, s * G, w)


def _inputs(hd, vd, G, S, KV, seed=22):
    """``test_torch_flash_bwd_numerics``' common-key inputs with v and
    dout vd wide, rounded to bf16 (the kernel's inputs)."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    q = normal(G * KV, S, hd)
    k = normal(KV, S, hd) + 10.0 * normal(KV, 1, hd)   # a common part
    v, dout = normal(KV, S, vd), normal(G * KV, S, vd)
    return tuple(_bf16(t) for t in (q, k, v, dout))


def _float64_grads(q, k, v, dout, G):
    """(dq, dk, dv) by float64 autograd of causal attention, masked
    scores set to -1e30 as the kernels set them."""
    S = q.shape[1]
    q, k, v = (t.double().requires_grad_() for t in (q, k, v))
    kr, vr = (t.repeat_interleave(G, 0) for t in (k, v))
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    s = q @ kr.transpose(1, 2) / math.sqrt(q.shape[-1])
    s = torch.where(keep, s, torch.tensor(-1e30, dtype=torch.float64))
    out = torch.softmax(s, dim=-1) @ vr
    return torch.autograd.grad(out, (q, k, v), dout.double())


def _kernel_grads(q, k, v, dout, G, p_passes=2, ds_passes=2):
    """(dq, dk, dv) with the bf16 kernels' arithmetic before the one
    rounding at the store: S and dP one pass, P (dV) and dS (dQ, dK) in
    ``p_passes`` / ``ds_passes`` bf16 passes, the elementwise steps in fp32
    (scores in log2 units, the online max and denominator over 64-key
    tiles, D from pass 1's own sums). The keys launch's S^T and dP^T sum
    the same slices in the same order as S and dP: the transposes, value
    for value."""
    hd, S = q.shape[-1], q.shape[1]
    scale = 1.0 / math.sqrt(hd)
    sc = scale * LOG2E
    kr, vr = (t.repeat_interleave(G, 0) for t in (k, v))
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    neg = torch.tensor(-1e30)

    # rows launch
    s2 = torch.where(keep, _mm_bf16(q, kr.transpose(1, 2), 1) * sc, neg)
    dp = _mm_bf16(dout, vr.transpose(1, 2), 1)
    H = q.shape[0]
    m, l, ld = (torch.full((H, S), -1e30), torch.zeros(H, S),
                torch.zeros(H, S))
    for k0 in range(0, S, KEY_TILE):            # pass 1
        tile = s2[:, :, k0:k0 + KEY_TILE]
        m_new = torch.maximum(m, tile.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(tile - m_new[..., None])
        l = l * corr + p.sum(-1)
        ld = ld * corr + (p * dp[:, :, k0:k0 + KEY_TILE]).sum(-1)
        m = m_new
    il = 1.0 / l
    d = ld * il
    p = torch.exp2(s2 - m[..., None]) * il[..., None]
    ds = torch.where(keep, p * (dp - d[..., None]), torch.tensor(0.0))
    dq = _mm_bf16(ds, kr, ds_passes) * scale

    # keys launch: the keys as M rows, the rows' m, 1 / l and D read back,
    # P^T and dS^T as the walk's [KV, keys, positions x G]
    del s2, dp
    rows = ROW_TILE[hd]
    p_t, ds_t = (_walk(x, G).transpose(1, 2) for x in (p, ds))
    del p, ds
    dv = _keys_sum(p_t, _walk(dout, G), p_passes, G, rows)
    dk = _keys_sum(ds_t, _walk(q, G), ds_passes, G, rows) * scale
    return dq, dk, dv


@functools.lru_cache(maxsize=None)
def _case(shape, p_passes=2, ds_passes=2):
    """(the kernel arithmetic's unrounded gradients, float64's) at one of
    SHAPES, on its seeded inputs; shared by the two tests."""
    hd, vd, G, S, KV = shape
    q, k, v, dout = _inputs(hd, vd, G, S, KV)
    return (_kernel_grads(q, k, v, dout, G, p_passes, ds_passes),
            _float64_grads(q, k, v, dout, G))


def _errors(got, want):
    return [float((g.double() - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]


@pytest.mark.parametrize("shape", SHAPES)
def test_flash_bwd_bf16_hi_lo_holds_float64_tolerance(shape):
    exact, want = _case(shape)
    shipped = _errors([_bf16(g) for g in exact], want)
    assert max(shipped) <= BF16_F64_TOL, shipped      # dq, dk, dv
    # the arithmetic alone, before the one rounding at the store
    exact = _errors(exact, want)
    assert max(exact) <= BF16_F64_TOL / 32, exact


@pytest.mark.parametrize("shape", SHAPES)
def test_flash_bwd_bf16_one_pass_for_p_or_ds_misses(shape):
    exact, want = _case(shape)
    one_ds, _ = _case(shape, ds_passes=1)
    one_ds = _errors([_bf16(g) for g in one_ds], want)
    assert one_ds[0] > 2 * BF16_F64_TOL, one_ds      # dq, by the key part
    exact = _errors(exact, want)
    one_p = _errors(_case(shape, p_passes=1)[0], want)
    # one pass of P spends a quarter of the tolerance on dv before the
    # output's rounding (up to 2^-8 x a value) is added
    assert one_p[2] > BF16_F64_TOL / 4, one_p
    assert one_p[2] > 100 * exact[2], (one_p, exact)
