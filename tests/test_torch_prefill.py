"""The port's full-sequence path against the JAX package's, on shared
weights (JAX init, bridged with ``from_jax_params``) and shared inputs
made with numpy: ``gqa_full`` (JAX under its XLA blockwise attention
and under the Pallas flash kernel in interpret mode), ``ssd_full``
(JAX's XLA oracle and its Pallas chunk kernel; the port runs every
chunk in one launch), the three MoE paths, ``prefill`` for a tiny
Mixtral, Qwen2.5 and Mamba2, and the port's own decode loop against its
prefill. Where routing decides the result, each test asserts that the
smallest router top-k margin it saw is far above fp32 noise, so a
failure would be a real fault and not a tie ordered differently by
``torch.topk`` and ``jax.lax.top_k``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch.models import attention as pattn
from repro_torch.models import moe as pmoe
from repro_torch.models import ssm as pssm
from repro_torch.models import transformer as ptf


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is faster than a pool, and keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=2e-4, atol=2e-4)   # fp32; attention/scan summation order
MIN_MARGIN = 1e-4
TOKENS = [3, 17, 42, 5, 99, 7, 23, 56]


def _bridge(tree):
    return ptf.from_jax_params(jax.tree.map(np.asarray, tree), device="cpu")


def track_margins(monkeypatch):
    """Record the smallest gap between the k-th and (k+1)-th router logit
    of every ``router_probs`` call the port makes."""
    seen = []
    orig = pmoe.router_probs

    def wrapped(p, cfg, x):
        out = orig(p, cfg, x)
        k = cfg.num_experts_per_tok
        srt = torch.sort(out[0], dim=-1, descending=True).values
        seen.append(float((srt[..., k - 1] - srt[..., k]).min()))
        return out

    monkeypatch.setattr(pmoe, "router_probs", wrapped)
    return seen


def _ssm_cfg(arch="mamba2-2.7b", **kw):
    return dataclasses.replace(tiny(arch, **kw), ssm_chunk=4)


# -------------------------------------------------------------- attention
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mixtral-8x7b"])
@pytest.mark.parametrize("impl", ["xla_blockwise", "pallas_interpret"])
def test_gqa_full_matches_reference(arch, impl, monkeypatch):
    """Qwen2.5 carries QKV biases (random here, so they count); S=40 is
    off every block size. Windowed too."""
    cfg = tiny(arch, layers=1)
    jp = jattn.init_gqa(jax.random.PRNGKey(0), cfg, jnp.float32)
    rng = np.random.default_rng(0)
    if "bq" in jp:
        jp = {**jp, **{n: jnp.asarray(rng.normal(size=jp[n].shape) * 0.1,
                                      jnp.float32)
                       for n in ("bq", "bk", "bv")}}
    tp = _bridge(jp)
    B, S = 2, 40
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    monkeypatch.setattr(jattn, "ATTN_IMPL", impl)
    for window in (None, 9):
        want = jattn.gqa_full(jp, cfg, jnp.asarray(x), jnp.asarray(pos),
                              window=window)
        got = pattn.gqa_full(tp, cfg, torch.from_numpy(x),
                             torch.from_numpy(pos.copy()), window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -------------------------------------------------------------------- SSD
@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_ssd_full_matches_reference(impl, monkeypatch):
    """Four chunks of 4 positions, two sequences: the port's single
    ``ssd_chunk`` call over all 8 chunks plus its inter-chunk loop equal
    JAX's per-chunk scan."""
    cfg = _ssm_cfg(layers=1)
    jp = jssm.init_ssm(jax.random.PRNGKey(5), cfg, jnp.float32)
    tp = _bridge(jp)
    x = (np.random.default_rng(1).normal(size=(2, 16, cfg.d_model)) *
         0.3).astype(np.float32)
    monkeypatch.setattr(jssm, "SSD_CHUNK_IMPL", impl)
    want = jssm.ssd_full(jp, cfg, jnp.asarray(x))
    calls = []
    orig = pssm.kops.ssd_chunk
    monkeypatch.setattr(pssm.kops, "ssd_chunk",
                        lambda *a: calls.append(a[0].shape) or orig(*a))
    got = pssm.ssd_full(tp, cfg, torch.from_numpy(x))
    assert calls == [(8, 4, cfg.ssm_nheads)]     # one call, G = 2 x 4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ssd_decode_matches_reference_and_own_scan():
    cfg = _ssm_cfg(layers=1)
    jp = jssm.init_ssm(jax.random.PRNGKey(6), cfg, jnp.float32)
    tp = _bridge(jp)
    x = (np.random.default_rng(2).normal(size=(2, 8, cfg.d_model)) *
         0.3).astype(np.float32)
    js = jssm.ssm_state_init(cfg, 2, jnp.float32)
    ps = pssm.ssm_state_init(cfg, 2, torch.float32, device="cpu")
    ys = []
    for t in range(x.shape[1]):
        jy, js = jssm.ssd_decode(jp, cfg, jnp.asarray(x[:, t:t + 1]), js)
        py, ps = pssm.ssd_decode(tp, cfg, torch.from_numpy(x[:, t:t + 1]),
                                 ps)
        np.testing.assert_allclose(py.numpy(), np.asarray(jy), **TOL)
        ys.append(py)
    for n in ("ssd", "conv"):
        np.testing.assert_allclose(ps[n].numpy(), np.asarray(js[n]), **TOL)
    full = pssm.ssd_full(tp, cfg, torch.from_numpy(x))
    torch.testing.assert_close(torch.cat(ys, dim=1), full, rtol=1e-3,
                               atol=1e-3)


# -------------------------------------------------------------------- MoE
def _moe_setup(seed, shape):
    cfg = tiny("mixtral-8x7b")
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), cfg, jnp.float32)
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return cfg, jp, _bridge(jp), x


@pytest.mark.parametrize("path,kw", [
    ("moe_dense", {}),
    ("moe_capacity", {}),
    ("moe_capacity", dict(capacity_factor=0.3)),   # overflow drops
    ("moe_gather", {}),
])
def test_moe_paths_match_reference(path, kw, monkeypatch):
    cfg, jp, tp, x = _moe_setup(3, (2, 16, 64))
    margins = track_margins(monkeypatch)
    jy, jaux = getattr(jmoe, path)(jp, cfg, jnp.asarray(x), **kw)
    py, paux = getattr(pmoe, path)(tp, cfg, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(paux), float(jaux), rtol=1e-5)
    assert min(margins) > MIN_MARGIN, min(margins)
    if kw:   # the small capacity really dropped rows
        full, _ = pmoe.moe_dense(tp, cfg, torch.from_numpy(x))
        assert not torch.allclose(py, full, rtol=1e-3, atol=1e-3)


def test_moe_apply_auto_and_ep():
    cfg, jp, tp, x = _moe_setup(4, (1, 300, 64))     # T > 256: capacity
    got, _ = pmoe.moe_apply(tp, cfg, torch.from_numpy(x))
    want, _ = pmoe.moe_capacity(tp, cfg, torch.from_numpy(x))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # expert parallelism needs a device mesh (tests/test_torch_sharding.py
    # and tests/test_torch_distributed.py run it under one)
    with pytest.raises(ValueError, match="active mesh"):
        pmoe.moe_apply(tp, cfg, torch.from_numpy(x), path="ep")


def test_router_and_load_balance_loss_match_reference(monkeypatch):
    cfg, jp, tp, x = _moe_setup(5, (3, 7, 64))
    jl, jprob, jids = jmoe.router_probs(jp, cfg, jnp.asarray(x))
    margins = track_margins(monkeypatch)
    pl, pprob, pids = pmoe.router_probs(tp, cfg, torch.from_numpy(x))
    assert min(margins) > MIN_MARGIN, min(margins)
    np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(pprob.numpy(), np.asarray(jprob), **TOL)
    np.testing.assert_allclose(
        float(pmoe.load_balance_loss(pl, pids, cfg.num_experts)),
        float(jmoe.load_balance_loss(jl, jids, cfg.num_experts)), rtol=1e-5)
    uniform = pmoe.load_balance_loss(
        torch.zeros(64, 8), torch.arange(8).repeat(8)[:, None], 8)
    assert float(uniform) == pytest.approx(1.0, rel=1e-5)


# ------------------------------------------------------------ entry points
ARCHS = ["mixtral-8x7b", "qwen2.5-3b", "mamba2-2.7b"]


def _model(arch, seed=1):
    cfg = _ssm_cfg(arch) if arch.startswith("mamba") else tiny(arch)
    jp = jtf.init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, jp, _bridge(jp)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, monkeypatch):
    cfg, jp, tp = _model(arch)
    margins = track_margins(monkeypatch)
    toks = np.array([TOKENS, TOKENS[::-1]], np.int32)
    for path in ("dense", "capacity"):
        want = jtf.prefill(jp, cfg, jnp.asarray(toks), moe_path=path)
        got = ptf.prefill(tp, cfg, torch.from_numpy(toks).long(),
                          moe_path=path)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if cfg.is_moe:
        assert min(margins) > MIN_MARGIN, min(margins)
    h, aux = ptf.forward(tp, cfg, torch.from_numpy(toks).long())
    jh, jaux = jtf.forward(jp, cfg, jnp.asarray(toks))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_loop_matches_own_prefill(arch):
    """Token-by-token ``decode_step`` reproduces ``prefill``'s
    last-position logits (KV caches and SSM states agree with the
    full-sequence path), as ``test_models_math.py`` checks for JAX."""
    cfg, _, tp = _model(arch)
    toks = torch.tensor([TOKENS], dtype=torch.long)
    want = ptf.prefill(tp, cfg, toks, moe_path="dense")
    state = ptf.init_decode_state(tp, cfg, 1, len(TOKENS), device="cpu")
    for i in range(len(TOKENS)):
        got, state = ptf.decode_step(tp, cfg, state, toks[:, i:i + 1], i,
                                     moe_path="dense")
    torch.testing.assert_close(got, want, rtol=3e-3, atol=3e-3)


def test_window_ring_decode_matches_windowed_forward():
    """Decode through a ring of W slots == the full forward with the
    same window (flash attention's window mask), Qwen2.5."""
    cfg, _, tp = _model("qwen2.5-3b", seed=2)
    W, toks = 4, torch.arange(1, 11)[None]
    h, _ = ptf.forward(tp, cfg, toks, window=W)
    want = ptf.logits_from_hidden(tp, cfg, h[:, -1:, :])[:, 0]
    state = ptf.init_decode_state(tp, cfg, 1, W, device="cpu")
    for i in range(toks.shape[1]):
        got, state = ptf.decode_step(tp, cfg, state, toks[:, i:i + 1], i,
                                     window=W)
    torch.testing.assert_close(got, want, rtol=3e-3, atol=3e-3)


def test_unknown_family_raises():
    """Every family of the JAX package is ported; an unknown one raises
    ``ValueError``, as JAX's ``init_params`` does."""
    cfg = dataclasses.replace(tiny("qwen2.5-3b"), family="diffusion")
    with pytest.raises(ValueError):
        ptf.init_params(cfg, torch.Generator(), device="cpu")
    _, _, tp = _model("qwen2.5-3b")
    for run in (lambda: ptf.forward(tp, cfg, torch.zeros((1, 4),
                                                         dtype=torch.long)),
                lambda: ptf.init_decode_state(tp, cfg, 1, 4, device="cpu")):
        with pytest.raises(ValueError):
            run()
