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
from its own products and never reads the forward's O."""
import math

import numpy as np
import pytest
import torch

from test_torch_kernels import _mm_tf32

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
