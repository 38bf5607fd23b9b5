"""The precision argument for the flash-attention forward's bf16 design
(``csrc/flash_attention.cu``, ``flash_fwd_bf16``), on the CPU.

The kernel keeps q, k and v in bf16 and runs both products as ``wgmma``
on the bf16 tensor cores with fp32 accumulators: S = Q.K^T in one pass
(the products of bf16 values are exact in fp32), then the online softmax
in fp32 over key tiles (scores in log2 units, masked scores at
-1e30), then O += P.V with P, which is fp32, split into a bf16 hi and a
bf16 lo part (lo = bf16(p - hi)): two passes a 16-key step, lo then hi,
each added to the running fp32 O. The output is rounded to bf16 once.
``_kernel_out`` repeats that arithmetic in torch on the common-key
inputs of ``test_torch_flash_bwd_numerics`` (keys sharing a part ten
times their random part, as Qwen's k bias makes them) and holds it
against float64 attention on the same bf16 values at ``chip_smoke.py``'s
BF16_F64_TOL, 2^-8 x max, and against the JAX package's Pallas kernel in
interpret mode on the same bf16 inputs at the 2e-2 of
``test_torch_flash_attention_plain_bf16_matches_pallas``.

The hi + lo split keeps P at fp32 accuracy: before the output rounding
the arithmetic is within 1.2e-6 to 2.0e-6 x max of float64 at these
shapes, and the shipped output within 1.4e-3 to 2.6e-3 x max. One pass
of P (P rounded to bf16 once, as JAX rounds it before P.V) leaves 8.7e-4
to 1.3e-3 x max before the output rounding, a quarter to a third of the
tolerance and over 600 times the split's error; rounded, 1.8e-3 to
3.0e-3 x max. The kernel pays 1.5x the least
P.V work at hd = vd for the split (PERF.md, section 6, times both)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from test_torch_flash_bwd_numerics import KV, LOG2E, S

BF16_F64_TOL = 2.0 ** -8   # chip_smoke.py's, x max |float64|
# the kernel's keys a K/V tile, by its q/k width bound (64, 128, 192)
KEY_TILE = {64: 128, 128: 64, 192: 64}
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


def _inputs(hd, vd, G, seed=22):
    """``test_torch_flash_bwd_numerics``' common-key inputs with v vd
    wide, rounded to bf16 (the kernel's inputs): q [G KV, S, hd], k
    [KV, S, hd], v [KV, S, vd]; query head h reads KV head h // G."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    q = normal(G * KV, S, hd)
    k = normal(KV, S, hd) + 10.0 * normal(KV, 1, hd)   # a common part
    v = normal(KV, S, vd)
    return tuple(_bf16(t) for t in (q, k, v))


def _steps16(a, b):
    """The 16-deep slices of a @ b, each summed exactly (the products of
    bf16 values are exact) and rounded to fp32, in order."""
    pad = (-a.shape[-1]) % 16
    a = torch.nn.functional.pad(a, (0, pad)).double()
    b = torch.nn.functional.pad(b, (0, 0, 0, pad)).double()
    return [(a[..., c:c + 16] @ b[..., c:c + 16, :]).float()
            for c in range(0, a.shape[-1], 16)]


def _kernel_out(q, k, v, G, p_passes=2, rounded=True):
    """Causal attention with the bf16 kernel's arithmetic: S as the fp32
    sum of its 16-deep slices; per key tile the online max and
    denominator in log2 units and O rescaled; O += P.V a 16-key step at a
    time, P as bf16 hi + lo (``p_passes`` 2: lo then hi, each added) or
    rounded once (1); O / l rounded to bf16 once when ``rounded``."""
    hd = q.shape[-1]
    sc = LOG2E / math.sqrt(hd)
    kr, vr = (t.repeat_interleave(G, 0) for t in (k, v))
    s = torch.zeros(q.shape[0], S, S)
    for part in _steps16(q, kr.transpose(1, 2)):
        s = s + part
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    s2 = torch.where(keep, s * sc, torch.tensor(-1e30))
    H, vd = q.shape[0], v.shape[-1]
    m, l = torch.full((H, S), -1e30), torch.zeros(H, S)
    o = torch.zeros(H, S, vd)
    kt = KEY_TILE[hd]
    for k0 in range(0, S, kt):
        tile = s2[:, :, k0:k0 + kt]
        m_new = torch.maximum(m, tile.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(tile - m_new[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None]
        hi = _bf16(p)
        parts = [_bf16(p - hi), hi] if p_passes == 2 else [hi]
        vt = vr[:, k0:k0 + kt]
        for c in range(0, p.shape[-1], 16):
            for part in parts:
                o = o + _steps16(part[..., c:c + 16], vt[:, c:c + 16])[0]
        m = m_new
    out = o / l[..., None]
    return _bf16(out) if rounded else out


def _float64_out(q, k, v, G):
    q, k, v = (t.double() for t in (q, k, v))
    kr, vr = (t.repeat_interleave(G, 0) for t in (k, v))
    s = q @ kr.transpose(1, 2) / math.sqrt(q.shape[-1])
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    s = torch.where(keep, s, torch.tensor(-1e30, dtype=torch.float64))
    return torch.softmax(s, dim=-1) @ vr


def _error(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("hd,vd,G", SHAPES)
def test_flash_fwd_bf16_hi_lo_holds_float64_tolerance(hd, vd, G):
    q, k, v = _inputs(hd, vd, G)
    want = _float64_out(q, k, v, G)
    assert _error(_kernel_out(q, k, v, G), want) <= BF16_F64_TOL
    # the arithmetic alone, before the one rounding at the store
    exact = _error(_kernel_out(q, k, v, G, rounded=False), want)
    assert exact <= BF16_F64_TOL / 128, exact


@pytest.mark.parametrize("hd,vd,G", SHAPES)
def test_flash_fwd_bf16_one_pass_of_p_spends_the_budget(hd, vd, G):
    q, k, v = _inputs(hd, vd, G)
    want = _float64_out(q, k, v, G)
    exact = _error(_kernel_out(q, k, v, G, rounded=False), want)
    one = _error(_kernel_out(q, k, v, G, p_passes=1, rounded=False), want)
    assert one > BF16_F64_TOL / 8, one
    assert one > 100 * exact, (one, exact)


@pytest.mark.parametrize("hd,vd,G", SHAPES)
def test_flash_fwd_bf16_emulation_matches_pallas(hd, vd, G):
    """The emulated kernel against the JAX package's Pallas kernel in
    interpret mode on the same bf16 inputs ([1, S, H, hd], causal), at
    the bf16 output's 2e-2 (rtol = atol)."""
    q, k, v = _inputs(hd, vd, G)
    got = _kernel_out(q, k, v, G)

    def bshd(t):   # [heads, S, w] -> [1, S, heads, w], bf16 for JAX
        return jnp.asarray(t.transpose(0, 1).unsqueeze(0).numpy(),
                           jnp.bfloat16)

    want = jops.flash_attention(bshd(q), bshd(k), bshd(v), causal=True,
                                impl="pallas_interpret", block_q=128,
                                block_k=128)
    want = torch.from_numpy(np.asarray(want, np.float32))[0].transpose(0, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-2,
                               atol=2e-2)
