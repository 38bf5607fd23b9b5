"""The precision argument for the flash-attention forward's fp32 design
(``csrc/flash_attention.cu``, ``flash_fwd_f32``), on the CPU.

The kernel runs both products as ``wgmma`` k8 steps on the TF32 tensor
cores in 3xTF32: every operand x split hi = tf32(x), lo = tf32(x - hi),
three MMAs a step (lo.hi, hi.lo, then hi.hi), each summed into the fp32
accumulator with the sum truncated toward zero (``_mm``). S = Q.K^T
runs from zero over the head width; the online softmax runs in fp32 over
key tiles of ``KEY_TILE`` keys (scores in log2 units, masked scores at
-1e30); each tile's P.V (P split like any operand, from the S
accumulator) is summed from zero and added to the running O in fp32, O =
O corr + P.V with one rounding to nearest (an FMA); the output is O / l.
``_kernel_out`` repeats that arithmetic in torch on the common-key inputs
of ``test_torch_flash_bwd_numerics`` (keys sharing a part ten times their
random part, as Qwen1.5's k bias makes them) and holds it against float64
attention at ``chip_smoke.py``'s ``TOL["flash_attention"]``, 2e-4 x max
of float64, and against the JAX package's Pallas kernel in interpret
mode at 2e-4 (rtol = atol, ``chip_smoke.py``'s against the plain
version).

At these shapes the arithmetic is within 1.4e-6 to 2.0e-6 x max of
float64. One TF32 pass (hi.hi, both products) misses the tolerance
(1.7e-3 to 1.9e-3 x max). The running O in one accumulator, each tile's
P.V added in place with truncation, holds it too but drifts with the
walk: at the 4096-key causal row of ``chip_smoke.py``'s
``FLASH_SHAPES`` (128 tiles of 32 keys, 1536 truncating adds on each
output) it is 4.5e-5 x max against the tile partials' 4.0e-6, eleven
times further; the partials keep the drift to one rounded add a tile,
so their error does not grow with the keys a row sees."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from test_torch_flash_bwd_numerics import KV, LOG2E, S, _tf32, _trunc32

TOL = 2e-4   # chip_smoke.py's TOL["flash_attention"], x max |float64|
# the kernel's keys a K/V tile, by its q/k width bound (64, 128, 192)
KEY_TILE = {64: 64, 128: 32, 192: 16}
# (hd, vd, G): Qwen1.5-0.5B's head width, MHA; Mixtral's, 4 heads a KV
# head; DeepSeek-V2's MLA widths
SHAPES = [(64, 64, 1), (128, 128, 4), (192, 128, 1)]
LONG = 4096   # the longest causal row of FLASH_SHAPES (hd 128, G 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(hd, vd, G, s=S, seed=22):
    """``test_torch_flash_bwd_numerics``' common-key inputs with v vd
    wide: q [G KV, s, hd], k [KV, s, hd], v [KV, s, vd]; query head h
    reads KV head h // G."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    q = normal(G * KV, s, hd)
    k = normal(KV, s, hd) + 10.0 * normal(KV, 1, hd)   # a common part
    v = normal(KV, s, vd)
    return q, k, v


def _mm(a, b, passes=3, acc=None):
    """a @ b as the kernel's wgmma k8 steps compute it: each 8-deep slice
    of the contraction three MMAs in 3xTF32 (A.lo B.hi, A.hi B.lo, A.hi
    B.hi; ``passes`` 1: A.hi B.hi alone), each summed exactly (TF32
    products are exact in fp32) and added to the fp32 accumulator with the
    sum truncated toward zero. ``acc``: an accumulator to go on from
    (None: from zero)."""
    pad = (-a.shape[-1]) % 8
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    ah, bh = _tf32(a), _tf32(b)
    pairs = [(ah, bh)]
    if passes == 3:
        pairs = [(_tf32(a - ah), bh), (ah, _tf32(b - bh)), (ah, bh)]
    pairs = [(x.double(), y.double()) for x, y in pairs]
    out = (torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float64)
           if acc is None else acc.double())
    for c in range(0, a.shape[-1], 8):
        for x, y in pairs:
            out = _trunc32(out + x[..., c:c + 8] @ y[..., c:c + 8, :]).double()
    return out.float()


def _kernel_out(q, k, v, G, passes=3, in_place=False, rows=None):
    """Causal attention with the fp32 kernel's arithmetic (``_mm``): S
    from zero; per key tile the online max and denominator in log2 units;
    the tile's P.V from zero and O = O corr + P.V rounded once
    (``in_place``: O rescaled, then the tile's P.V summed into it with
    truncation); out = O / l. ``rows``: only the last ``rows`` query
    positions (each against every key it sees)."""
    hd, s = q.shape[-1], k.shape[1]
    q0 = 0 if rows is None else s - rows
    q = q[:, q0:]
    sc = LOG2E / math.sqrt(hd)
    kr, vr = (t.repeat_interleave(G, 0) for t in (k, v))
    keep = (torch.arange(s)[None, :] <= torch.arange(q0, s)[:, None])
    s2 = torch.where(keep, _mm(q, kr.transpose(1, 2), passes) * sc,
                     torch.tensor(-1e30))
    H, n, vd = q.shape[0], q.shape[1], v.shape[-1]
    m, l = torch.full((H, n), -1e30), torch.zeros(H, n)
    o = torch.zeros(H, n, vd)
    kt = KEY_TILE[hd]
    for k0 in range(0, s, kt):
        tile = s2[:, :, k0:k0 + kt]
        m_new = torch.maximum(m, tile.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(tile - m_new[..., None])
        l = l * corr + p.sum(-1)
        vt = vr[:, k0:k0 + kt]
        if in_place:
            o = _mm(p, vt, passes, o * corr[..., None])
        else:
            part = _mm(p, vt, passes).double()
            o = (o.double() * corr[..., None].double() + part).float()
        m = m_new
    return o / l[..., None]


def _float64_out(q, k, v, G, rows=None):
    s = k.shape[1]
    q0 = 0 if rows is None else s - rows
    q, k, v = (t.double() for t in (q[:, q0:], k, v))
    kr, vr = (t.repeat_interleave(G, 0) for t in (k, v))
    scores = q @ kr.transpose(1, 2) / math.sqrt(q.shape[-1])
    keep = (torch.arange(s)[None, :] <= torch.arange(q0, s)[:, None])
    scores = torch.where(keep, scores,
                         torch.tensor(-1e30, dtype=torch.float64))
    return torch.softmax(scores, dim=-1) @ vr


def _error(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("hd,vd,G", SHAPES)
def test_flash_fwd_3xtf32_tile_partials_hold_fp32_tolerance(hd, vd, G):
    q, k, v = _inputs(hd, vd, G)
    err = _error(_kernel_out(q, k, v, G), _float64_out(q, k, v, G))
    assert err <= TOL / 20, err


def test_flash_fwd_one_tf32_pass_misses_fp32_tolerance():
    q, k, v = _inputs(128, 128, 4)
    want = _float64_out(q, k, v, 4)
    one = _error(_kernel_out(q, k, v, 4, passes=1), want)
    three = _error(_kernel_out(q, k, v, 4), want)
    assert one > TOL, one
    assert one > 100 * three, (one, three)


@pytest.mark.parametrize("in_place", [False, True])
def test_flash_fwd_4096_key_causal_row(in_place):
    """The last 4 positions of a 4096-key causal walk at hd 128, G 4 (16
    query rows, every key each): 128 tiles of 32 keys. Tile partials
    added in fp32 hold TOL / 20; one accumulator summed in place holds
    TOL but drifts over 8x further (4.0e-6 vs 4.5e-5 x max; seed 23:
    2.7e-6 vs 3.2e-5)."""
    q, k, v = _inputs(128, 128, 4, s=LONG)
    want = _float64_out(q, k, v, 4, rows=4)
    got = _error(_kernel_out(q, k, v, 4, in_place=in_place, rows=4), want)
    partial = got if not in_place else _error(
        _kernel_out(q, k, v, 4, rows=4), want)
    if in_place:
        assert TOL / 20 < got <= TOL and got > 8 * partial, (got, partial)
    else:
        assert got <= TOL / 20, got


@pytest.mark.parametrize("hd,vd,G", SHAPES)
def test_flash_fwd_emulation_matches_pallas(hd, vd, G):
    """The emulated kernel against the JAX package's Pallas kernel in
    interpret mode on the same fp32 inputs ([1, S, H, hd], causal), at
    2e-4 (rtol = atol), the tolerance ``chip_smoke.py`` holds the kernel
    to against its plain version."""
    q, k, v = _inputs(hd, vd, G)
    got = _kernel_out(q, k, v, G)

    def bshd(t):   # [heads, S, w] -> [1, S, heads, w]
        return jnp.asarray(t.transpose(0, 1).unsqueeze(0).numpy())

    want = jops.flash_attention(bshd(q), bshd(k), bshd(v), causal=True,
                                impl="pallas_interpret", block_q=128,
                                block_k=128)
    want = torch.from_numpy(np.array(want, np.float32))[0].transpose(0, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)
