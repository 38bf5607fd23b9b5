"""The precision argument for the SSD chunk backward kernel's tensor-core
design (``csrc/ssd_chunk_bwd.cu``), on the CPU.

The kernel runs all its products (the scores C.B^T; U = dS.B and M^T dY
for dxw; dM = dY.xw^T; dC = dScr.B; dB = dScr^T.C then the state term
sum_(h, p) (e_j xw_j[h, p]) dS[h, p, :]) as mma.sync on TF32 operands,
split 3xTF32 (lo.hi + hi.lo + hi.hi), summing each 32-deep stage of a
contraction from zero and adding it to the running sum in fp32. This test
repeats that arithmetic in torch at Mamba2-2.7B's widths (a chunk of 256,
P 64, N 128) for one chunk of 20 heads, so that dB's state term runs over
20 x 64 = 1280, the depth of one head split at Mamba2's training call
(``ssd_chunk.bwd_split``), and holds the four gradients against float64
autograd of the step at the kernel's tolerance, 2e-5 x max |float64|
(``chip_smoke.py``), with room.

The tensor cores truncate as they accumulate. The model here: each MMA's
exact sum (products of TF32 values, summed in float64) is added to its
accumulator and rounded toward zero to fp32. It is the mildest model that
truncates, and it shows the drift ``flash_attention_bwd.cu`` measured on
the card (one accumulator over thousands of rows drifting toward zero).
Under it, one TF32 pass misses the tolerance on every gradient, and one
accumulator over the state term, without the stages, leaves no room at
Mamba2's depth and misses at Jamba-1.5-Large's (64 heads of a split, 4096
deep).

What is not emulated: the d dA sums (R = dM o M reduced over the pairs
that straddle each position; the kernel reduces a tile's R in fp32 and the
tiles in double, here all in float64 from the emulated dM) and the
elementwise steps, which run in fp32 as in the kernel."""
import functools
import math

import numpy as np
import pytest
import torch

from test_torch_kernels import _mm_tf32, _tf32

TOL = 2e-5            # chip_smoke.py's TOL["ssd_chunk_bwd"], x max
STAGE = 32            # the kernel's contraction a ring stage
Q, P, N = 256, 64, 128
H = 20                # one head split at Mamba2's call: 1280 deep
NAMES = ("d_dA", "d_xw", "d_Bm", "d_Cm")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(heads=H, seed=25):
    """One chunk (G 1): dA < 0 as the model makes it, the rest N(0, 1),
    and the output gradients dY [1,Q,H,P], dS [1,H,P,N]."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    return (-normal(1, Q, heads).abs() * 0.1, normal(1, Q, heads, P),
            normal(1, Q, N), normal(1, Q, N), normal(1, Q, heads, P),
            normal(1, heads, P, N))


def _rz(x):
    """float64 -> fp32, rounded toward zero."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _mma(a, b, passes=3, stage=STAGE, init=None):
    """a @ b (a [..., M, K], b [..., K, N], fp32) as the kernel's mma.sync
    chain: per k8 step the MMAs lo.hi, hi.lo, hi.hi (``passes`` 3) or
    hi.hi (1) of TF32 operands, each MMA's exact sum added to its
    accumulator and rounded toward zero; each ``stage``-deep stage summed
    from zero and added to the running sum (``init``, else zero) in fp32;
    ``stage`` None: one accumulator over the whole contraction."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    terms = [(x.double(), y.double()) for x, y in
             ([(al, bh), (ah, bl)] if passes == 3 else []) + [(ah, bh)]]
    K = a.shape[-1]
    shape = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]) + (
        a.shape[-2], b.shape[-1])
    acc = torch.zeros(shape) if init is None else init
    step = stage or K
    for s0 in range(0, K, step):
        part = acc if stage is None else torch.zeros(shape)
        for k in range(s0, min(K, s0 + step), 8):
            for x, y in terms:
                part = _rz(part.double()
                           + x[..., k:k + 8] @ y[..., k:k + 8, :])
        acc = part if stage is None else acc + part
    return acc


def _float64_grads(dA, xw, Bm, Cm, dY, dS):
    """(d dA, d xw, d Bm, d Cm) by float64 autograd of the step (the
    exponent masked above the diagonal, as the plain version masks it)."""
    leaves = [t.double().requires_grad_() for t in (dA, xw, Bm, Cm)]
    a, x, b, c = (t[0] for t in leaves)
    cum = torch.cumsum(a, 0)                                     # [Q,H]
    keep = torch.ones(Q, Q, dtype=torch.bool).tril()[..., None]
    L = torch.exp(torch.where(keep, cum[:, None] - cum[None], -math.inf))
    y = torch.einsum("ijh,ij,jhp->ihp", L, c @ b.T, x)
    s = torch.einsum("jh,jn,jhp->hpn", torch.exp(cum[-1:] - cum), b, x)
    return torch.autograd.grad((y, s), leaves,
                               (dY.double()[0], dS.double()[0]))


def _kernel_grads(dA, xw, Bm, Cm, dY, dS, passes=3, state_stage=STAGE):
    """The four gradients with every product as ``_mma`` and the
    elementwise steps in fp32 as the kernel takes them; ``state_stage``
    None runs dB's chain (the chunk term, then the state term) in one
    accumulator."""
    a, x, b, c, dy, ds = (t[0] for t in (dA, xw, Bm, Cm, dY, dS))
    heads = a.shape[1]
    cum = torch.cumsum(a.double(), 0)
    hi = cum.float()
    lo = (cum - hi.double()).float()                             # [Q,H]
    keep = torch.ones(Q, Q, dtype=torch.bool).tril()
    rel = (hi[:, None] - hi[None]) + (lo[:, None] - lo[None])    # [i,j,H]
    L = torch.exp2(torch.where(keep[..., None], rel * math.log2(math.e),
                               -math.inf)).permute(2, 0, 1)      # [H,i,j]
    e = torch.exp2(((hi[-1:] - hi) + (lo[-1:] - lo))
                   * math.log2(math.e))                          # [Q,H]
    xh, yh = x.permute(1, 0, 2), dy.permute(1, 0, 2)             # [H,Q,P]

    cb = _mma(c, b.T, passes)                                    # [i,j]
    M = L * cb                                                   # [H,i,j]
    U = _mma(b, ds.transpose(1, 2), passes)                      # [H,j,P]
    T = e.T * (xh * U).sum(-1)                                   # [H,j]
    dxw = _mma(M.transpose(1, 2), yh, passes, init=e.T[..., None] * U)
    dM = _mma(yh, xh.transpose(1, 2), passes)                    # [H,i,j]
    dl = dM * L
    dscr = dl[0]
    for h in range(1, heads):                                    # head order
        dscr = dscr + dl[h]
    dC = _mma(dscr, b, passes)
    state_a = (e[:, :, None] * x).reshape(Q, heads * P)
    dB = _mma(torch.cat([dscr.T, state_a], 1),
              torch.cat([c, ds.reshape(heads * P, N)], 0), passes,
              stage=state_stage)
    # d dA_m: the pairs of R = dM o M that straddle m (i >= m > j), from
    # each row's exclusive prefix over j, then the prefix of T
    R = (dl * cb).double()                                       # [H,i,j]
    before = torch.cumsum(R, 2) - R                              # [H,i,m]
    ddA = ((before * keep).sum(1) + torch.cumsum(T.double(), 1)
           - T.double())                                         # [H,m]
    return ddA.T[None], dxw.permute(1, 0, 2)[None], dB[None], dC[None]


@functools.lru_cache(maxsize=None)
def _errors(passes=3, state_stage=STAGE):
    """Each gradient's max |emulated - float64| / max |float64|."""
    args = _inputs()
    got = _kernel_grads(*args, passes=passes, state_stage=state_stage)
    return {n: float((g.double() - w).abs().max() / w.abs().max())
            for n, g, w in zip(NAMES, got, _float64_grads(*args))}


def test_ssd_bwd_3xtf32_staged_holds_fp32_tolerance():
    three = _errors()
    assert max(three.values()) <= TOL / 10, three
    one = _errors(passes=1)
    assert min(one.values()) > 5 * TOL, one        # each gradient misses


def test_ssd_bwd_state_term_needs_staged_sums_at_mamba2_depth():
    """dB's state term over 1280 in one accumulator: more than a quarter
    of the tolerance (no room), and more than 10 times the staged error."""
    staged = _errors()["d_Bm"]
    long = _errors(state_stage=None)["d_Bm"]
    assert long > TOL / 4 and long > 10 * staged, (long, staged)


def test_ssd_bwd_state_term_long_accumulator_misses_at_jamba_depth():
    """The state term alone at Jamba-1.5-Large's split depth (64 heads of
    64: 4096). The 3xTF32 split with fp32 sums rounded to nearest
    (``_mm_tf32``) holds it: the split is not what loses. With the
    tensor cores' truncating accumulation, the kernel's stages hold it
    with room; one accumulator misses."""
    heads = 64
    a, xw, _, _, _, dS = (t[0] for t in _inputs(heads, seed=26))
    cum = torch.cumsum(a.double(), 0)
    e = torch.exp(cum[-1:] - cum).float()
    lhs = (e[:, :, None] * xw).reshape(Q, heads * P)
    rhs = dS.reshape(heads * P, N)
    want = lhs.double() @ rhs.double()
    top = float(want.abs().max())

    def err(out):
        return float((out.double() - want).abs().max()) / top

    split = err(_mm_tf32(lhs, rhs, 3))
    staged, long = err(_mma(lhs, rhs)), err(_mma(lhs, rhs, stage=None))
    assert split <= TOL / 10 and staged <= TOL / 10, (split, staged)
    assert long > TOL, long
