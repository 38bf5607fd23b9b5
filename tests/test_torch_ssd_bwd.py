"""The SSD chunk step's backward on the CPU: the port's plain backward
(``ssd_chunk.plain_bwd``, autograd of the plain version) against
``jax.vjp`` of the JAX reference (the XLA path JAX trains through); the
formulas the CUDA kernel ``csrc/ssd_chunk_bwd.cu`` computes, written here
as float64 einsums, against both; the CUDA route's autograd wiring
(``ops._SsdChunk``) with its launches running the plain versions; tiny
Mamba2 and hybrid training steps through that route against JAX's
``loss_fn`` with exact launch counts; and one chunk, where ``S_chunk``'s
gradient is unused.

Tolerances: each gradient within 1e-5 x its largest |value| (fp32 sums
in other orders; the kernel on the card is held at 2e-5 x max). The
model steps use ``test_torch_training.py``'s tolerances.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import transformer as jtf
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ssd_chunk as ssd_mod
from repro_torch.training.train_loop import to_device
from test_torch_prefill import _bridge, _one_torch_thread  # noqa: F401
from test_torch_training import (GRAD_ATOL_FRAC, GRAD_RTOL, _batch, _cfg,
                                 _cuda_route_on_cpu, _jax_flat,
                                 _port_value_and_grad)

TOL = 1e-5
NAMES = ("d_dA", "d_xw", "d_Bm", "d_Cm")
# (G, Q, H, P, N): ragged Q (37, 70, 100, 130), H 1 to 6, N != P, one
# chunk of one tile and one of three tiles
SHAPES = [(2, 37, 3, 5, 7), (1, 70, 1, 8, 12), (2, 100, 2, 6, 4),
          (1, 64, 6, 16, 8), (3, 16, 4, 4, 10), (1, 130, 5, 3, 9)]


def _inputs(shape, seed, scale=0.1):
    """Seeded numpy inputs: dA < 0 as the model makes it, the rest N(0, 1),
    and the output gradients dY [G,Q,H,P], dS [G,H,P,N]."""
    G, Q, H, P, N = shape
    rng = np.random.default_rng(seed)

    def r(*s):
        return rng.normal(size=s).astype(np.float32)

    return [-np.abs(r(G, Q, H)) * np.float32(scale), r(G, Q, H, P),
            r(G, Q, N), r(G, Q, N), r(G, Q, H, P), r(G, H, P, N)]


def _torch(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _close(got, want, what):
    for name, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        top = np.abs(w).max()
        assert np.abs(g - w).max() <= TOL * top, (what, name)


def kernel_formulas(dA, xw, Bm, Cm, dY, dS):
    """The kernel's sums in float64, as einsums: U_j = dS . B_j; dxw_j =
    sum_{i>=j} M_ij dY_i + e_j U_j; dM_ij = dY_i . xw_j; the score
    gradient sum_h dM o L; dC, dB; R = dM o M, T_j = e_j (xw_j . U_j); and
    d dA_m = sum_{i>=m} sum_{j<m} R_ij + sum_{j<m} T_j, the pairs that
    straddle m. Also returns d dA from the difference form (dcum_i = row
    sum - column sum of R - T_i + [i = Q-1] sum T, reverse cumsum)."""
    dA, xw, Bm, Cm, dY, dS = (t.double() for t in (dA, xw, Bm, Cm, dY, dS))
    Q = dA.shape[1]
    pos = torch.arange(Q)
    keep = (pos[:, None] >= pos[None, :])[None, :, :, None]      # i >= j
    cum = torch.cumsum(dA, dim=1)
    L = torch.exp(torch.where(keep, cum[:, :, None] - cum[:, None], -math.inf))
    M = L * torch.einsum("gin,gjn->gij", Cm, Bm)[..., None]      # [G,i,j,H]
    e = torch.exp(cum[:, -1:] - cum)                             # [G,Q,H]
    U = torch.einsum("ghpn,gjn->gjhp", dS, Bm)
    dxw = torch.einsum("gijh,gihp->gjhp", M, dY) + e[..., None] * U
    dM = torch.einsum("gihp,gjhp->gijh", dY, xw) * keep
    dscr = (dM * L).sum(-1)
    dC = torch.einsum("gij,gjn->gin", dscr, Bm)
    dB = (torch.einsum("gij,gin->gjn", dscr, Cm)
          + torch.einsum("gjh,gjhp,ghpn->gjn", e, xw, dS))
    R = dM * M
    T = e * (xw * U).sum(-1)                                     # [G,Q,H]
    i, j, m = pos[:, None, None], pos[None, :, None], pos[None, None, :]
    straddle = ((i >= m) & (j < m)).double()                     # [i,j,m]
    before = (pos[:, None] < pos[None, :]).double()              # [j,m]
    ddA = (torch.einsum("gijh,ijm->gmh", R, straddle)
           + torch.einsum("gjh,jm->gmh", T, before))
    dcum = (R.sum(2) - R.sum(1) - T)
    dcum[:, -1] += T.sum(1)
    ddA_diff = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
    return (ddA, dxw, dB, dC), ddA_diff


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_plain_bwd_matches_jax_vjp(shape):
    arrs = _inputs(shape, sum(shape))
    _, vjp = jax.vjp(jref.ssd_chunk_ref, *(jnp.asarray(a) for a in arrs[:4]))
    want = vjp((jnp.asarray(arrs[4]), jnp.asarray(arrs[5])))
    got = ssd_mod.plain_bwd(*_torch(arrs))
    _close([g.numpy() for g in got], want, shape)


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_kernel_formulas_match_plain_bwd(shape):
    arrs = _torch(_inputs(shape, 7 * sum(shape)))
    got, ddA_diff = kernel_formulas(*arrs)
    _close(got, ssd_mod.plain_bwd(*arrs), shape)
    # the straddle form is the difference form's reverse cumsum, exactly
    top = float(ddA_diff.abs().max())
    assert float((got[0] - ddA_diff).abs().max()) <= 1e-12 * top
    assert float(got[0][:, 0].abs().max()) == 0.0   # d dA_0 = 0 exactly


def test_plain_bwd_is_finite_where_the_decay_overflows():
    """A chunk that decays by more than e^88 (dA ~ -|N(0, 2)|, Q 100):
    above the diagonal exp(rel) is inf in fp32. The plain version masks
    the exponent, so its d dA stays finite and equals the formulas; the
    JAX reference masks the value, and its d dA is NaN there (a standing
    difference); the other three gradients agree."""
    arrs = _inputs((2, 100, 3, 5, 7), 3, scale=2.0)
    got = ssd_mod.plain_bwd(*_torch(arrs))
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _close(got, kernel_formulas(*_torch(arrs))[0], "formulas")
    _, vjp = jax.vjp(jref.ssd_chunk_ref, *(jnp.asarray(a) for a in arrs[:4]))
    want = vjp((jnp.asarray(arrs[4]), jnp.asarray(arrs[5])))
    assert not np.isfinite(np.asarray(want[0])).all()
    _close([g.numpy() for g in got[1:]], want[1:], "jax")


def _ssd_route_on_cpu(monkeypatch, seen=None):
    """The wrappers' CUDA route on CPU tensors, every launch running its
    plain version (``_cuda_route_on_cpu``, flash included); the SSD
    backward's launch records its output gradients in ``seen``."""
    _cuda_route_on_cpu(monkeypatch)
    monkeypatch.setattr(ssd_mod, "launch",
                        lambda fn, *args: ssd_mod.plain(*args))

    def launch_bwd(fn, *args):
        if seen is not None:
            seen.append(args[4:])
        return ssd_mod.plain_bwd(*args)
    monkeypatch.setattr(ssd_mod, "launch_bwd", launch_bwd)


def test_cuda_route_differentiates(monkeypatch):
    arrs = _torch(_inputs(SHAPES[0], 21))
    want = ssd_mod.plain_bwd(*arrs)
    seen = []
    _ssd_route_on_cpu(monkeypatch, seen)
    kops.reset_launch_counts()
    leaves = [t.clone().requires_grad_() for t in arrs[:4]]
    y, s = kops.ssd_chunk(*leaves)
    # dY arrives as a transposed view: the route makes it contiguous
    dY = arrs[4].transpose(0, 1).contiguous().transpose(0, 1)
    assert not dY.is_contiguous()
    got = torch.autograd.grad((y, s), leaves, (dY, arrs[5]))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert all(t.is_contiguous() for t in seen[0])
    counts = kops.launch_counts()
    assert counts["ssd_chunk"] == 1 and counts["ssd_chunk_bwd"] == 1
    with torch.no_grad():
        kops.ssd_chunk(*leaves)
    assert kops.launch_counts()["ssd_chunk"] == 2


def test_cuda_route_unused_state_gradient_is_zeros(monkeypatch):
    """Only Y is used (one chunk): the backward still launches, with dS
    materialised as zeros, and equals autograd of the plain version."""
    arrs = _torch(_inputs(SHAPES[1], 22))
    leaves = [t.clone().requires_grad_() for t in arrs[:4]]
    want = torch.autograd.grad(
        (ssd_mod.plain(*leaves)[0] * arrs[4]).sum(), leaves)
    seen = []
    _ssd_route_on_cpu(monkeypatch, seen)
    kops.reset_launch_counts()
    got = torch.autograd.grad((kops.ssd_chunk(*leaves)[0] * arrs[4]).sum(),
                              leaves)
    assert not seen[0][1].any() and seen[0][1].shape == arrs[5].shape
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)
    assert kops.launch_counts()["ssd_chunk_bwd"] == 1


def _case(case):
    if case == "one_chunk":      # S = 16 tokens in one chunk: S_chunk unused
        cfg, path = _cfg("ssm")
        return dataclasses.replace(cfg, ssm_chunk=16), path
    return _cfg(case)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("case", ["ssm", "hybrid", "one_chunk"])
def test_train_step_through_cuda_route_matches_jax(case, remat, monkeypatch):
    """A tiny Mamba2 (chunks of 4), a tiny Jamba (attention every second
    layer) and Mamba2 in one chunk through the CUDA routes (launches
    running the plain versions): loss and gradients equal JAX's
    ``loss_fn``; ``ssd_chunk`` launches once a SSM layer, twice under
    remat, and its backward once; flash attention likewise a attention
    layer; nothing else launches. In one chunk the state's gradient
    reaches the backward as zeros."""
    cfg, path = _case(case)
    jp = jtf.init_params(cfg, jax.random.PRNGKey(3))
    nb = _batch(cfg, seed=4)
    jl, jg = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, cfg, {k: jnp.asarray(v) for k, v in
                                       nb.items()}, moe_path=path))(jp)
    seen = []
    _ssd_route_on_cpu(monkeypatch, seen)
    kops.reset_launch_counts()
    loss, grads = _port_value_and_grad(_bridge(jp), cfg,
                                       to_device(nb, "cpu"), moe_path=path,
                                       remat=remat)
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    n_ssm, n_attn = kinds.count("ssm"), kinds.count("attn")
    fwd = 2 if remat else 1
    assert kops.launch_counts() == {
        "moe_ffn": 0, "paged_attention": 0,
        "flash_attention": fwd * n_attn, "flash_attention_bwd": n_attn,
        "ssd_chunk": fwd * n_ssm, "ssd_chunk_bwd": n_ssm}
    assert n_ssm > 0 and (n_attn > 0) == (case == "hybrid")
    if case == "one_chunk":
        assert all(not ds.any() for _, ds in seen)
    np.testing.assert_allclose(float(loss), float(jl), rtol=GRAD_RTOL)
    want = _jax_flat(jg)
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_FRAC * top, err_msg=k)


def test_launch_bwd_raises_on_a_refused_launch(monkeypatch):
    """A launch the C entry point refuses (its error code) raises."""
    arrs = _torch(_inputs(SHAPES[0], 5))

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    with pytest.raises(RuntimeError, match="cudaError 1"):
        ssd_mod.launch_bwd(lambda *a: 1, *arrs)


def test_bwd_split_depends_on_the_shape_alone():
    assert ssd_mod.bwd_split(16, 256, 80, 128) == (4, 4)
    assert ssd_mod.bwd_split(32, 128, 256, 128) == (6, 4)
    assert ssd_mod.bwd_split(1, 4096, 2, 128) == (1, 2)
    for G, Q, H, N in [(1, 37, 1, 7), (3, 100, 5, 130), (64, 4096, 3, 16)]:
        groups, splits = ssd_mod.bwd_split(G, Q, H, N)
        assert 1 <= groups <= H and 1 <= splits <= H
