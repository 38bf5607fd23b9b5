"""The precision argument for the flash-attention backward's bf16 design
(``csrc/flash_attention_bwd.cu``, ``flash_bwd_rows_bf16`` and
``flash_bwd_keys_bf16``), on the CPU.

The kernels keep q, k, v and dout in bf16 and run every product as
``mma.sync`` m16n8k16 on the bf16 tensor cores: S = Q.K^T and dP = dO.V^T
(and S^T, dP^T) in one pass, exact products; dQ += dS.K, dV += P^T.dO and
dK += dS^T.Q with P and dS, which are fp32, split into a bf16 hi and a
bf16 lo part (two passes). Each 16-deep product is summed from zero and
added to the running fp32 sum; the rows launch's online softmax walks
32-key tiles; dq, dk and dv are rounded to bf16 once. ``_kernel_grads``
repeats that arithmetic in torch (``_mm_bf16``) on the common-key inputs
of ``test_torch_flash_bwd_numerics`` (keys sharing a part ten times their
random part, as Qwen's k bias makes them), rounded to bf16, and holds the
gradients against float64 autograd of attention on the same values at
``chip_smoke.py``'s BF16_F64_TOL, 2^-8 x max.

The hi + lo split holds it: before the output rounding the arithmetic is
within 5e-5 x max. One rounded pass does not: dS cancels (its row sums
are 0) and the shared key part turns its rounding into dq error, 1e-2 to
3e-2 x max; one pass of P leaves dv 1.1e-3 to 2.0e-3 x max off before the
output's own rounding of up to 2^-8, and at hd 128 / G 8 the rounded dv
misses (3.94e-3)."""
import math

import numpy as np
import pytest
import torch

from test_torch_flash_bwd_numerics import KV, LOG2E, S, _float64_grads

BF16_F64_TOL = 2.0 ** -8   # chip_smoke.py's, x max |float64|
KEY_TILE = 32              # the rows launch's keys a ring stage
# (hd, vd, G): Qwen1.5-0.5B's head width, MHA; Qwen2.5-3B's, 8 heads a KV
# head; DeepSeek-V2's MLA widths
SHAPES = [(64, 64, 1), (128, 128, 8), (192, 128, 1)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _mm_bf16(a, b, passes):
    """a @ b as the kernel's m16n8k16 MMAs compute it: b holds bf16
    values; a is rounded to bf16 (``passes`` 1) or split into hi = bf16(a)
    and lo = bf16(a - hi) (2); each 16-deep slice of the contraction
    summed exactly (the products of bf16 values are exact in fp32),
    rounded to fp32 and added to the running fp32 sum in order."""
    pad = (-a.shape[-1]) % 16
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad)).double()
    hi = _bf16(a)
    parts = [hi] if passes == 1 else [hi, _bf16(a - hi)]
    out = 0.0
    for c in range(0, a.shape[-1], 16):
        out = out + sum(p[..., c:c + 16].double() @ b[..., c:c + 16, :]
                        for p in parts).float()
    return out


def _inputs(hd, vd, G, seed=22):
    """``test_torch_flash_bwd_numerics``' common-key inputs with v and
    dout vd wide, rounded to bf16 (the kernel's inputs)."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    q = normal(G * KV, S, hd)
    k = normal(KV, S, hd) + 10.0 * normal(KV, 1, hd)   # a common part
    v, dout = normal(KV, S, vd), normal(G * KV, S, vd)
    return tuple(_bf16(t) for t in (q, k, v, dout))


def _kernel_grads(q, k, v, dout, G, p_passes=2, ds_passes=2, rounded=True):
    """(dq, dk, dv) with the bf16 kernels' arithmetic: S and dP one pass,
    P (dV) and dS (dQ, dK) in ``p_passes`` / ``ds_passes`` bf16 passes,
    the elementwise steps in fp32 (scores in log2 units, the online max and
    denominator over 32-key tiles, D from pass 1's own sums), and each
    gradient rounded to bf16 once when ``rounded``."""
    hd = q.shape[-1]
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

    # keys launch: the keys as M rows, the rows' m, 1 / l and D read back
    keep_t = keep.T
    s2_t = torch.where(keep_t, _mm_bf16(kr, q.transpose(1, 2), 1) * sc, neg)
    p_t = torch.exp2(s2_t - m[:, None, :]) * il[:, None, :]
    dp_t = _mm_bf16(vr, dout.transpose(1, 2), 1)
    ds_t = torch.where(keep_t, p_t * (dp_t - d[:, None, :]),
                       torch.tensor(0.0))
    vd = v.shape[-1]
    dv = _mm_bf16(p_t, dout, p_passes).reshape(KV, G, S, vd).sum(1)
    dk = (_mm_bf16(ds_t, q, ds_passes) * scale).reshape(KV, G, S, hd).sum(1)
    grads = (dq, dk, dv)
    return tuple(_bf16(g) for g in grads) if rounded else grads


def _errors(got, want):
    return [float((g.double() - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]


@pytest.mark.parametrize("hd,vd,G", SHAPES)
def test_flash_bwd_bf16_hi_lo_holds_float64_tolerance(hd, vd, G):
    q, k, v, dout = _inputs(hd, vd, G)
    want = _float64_grads(q, k, v, dout, G)
    shipped = _errors(_kernel_grads(q, k, v, dout, G), want)
    assert max(shipped) <= BF16_F64_TOL, shipped      # dq, dk, dv
    # the arithmetic alone, before the one rounding at the store
    exact = _errors(_kernel_grads(q, k, v, dout, G, rounded=False), want)
    assert max(exact) <= BF16_F64_TOL / 32, exact


@pytest.mark.parametrize("hd,vd,G", SHAPES)
def test_flash_bwd_bf16_one_pass_for_p_or_ds_misses(hd, vd, G):
    q, k, v, dout = _inputs(hd, vd, G)
    want = _float64_grads(q, k, v, dout, G)
    one_ds = _errors(_kernel_grads(q, k, v, dout, G, ds_passes=1), want)
    assert one_ds[0] > 2 * BF16_F64_TOL, one_ds      # dq, by the key part
    exact = _errors(_kernel_grads(q, k, v, dout, G, rounded=False), want)
    one_p = _errors(_kernel_grads(q, k, v, dout, G, p_passes=1,
                                  rounded=False), want)
    # one pass of P spends a quarter of the tolerance on dv before the
    # output's rounding (up to 2^-8 x a value) is added
    assert one_p[2] > BF16_F64_TOL / 4, one_p
    assert one_p[2] > 100 * exact[2], (one_p, exact)
