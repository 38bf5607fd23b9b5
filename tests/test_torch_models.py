"""The port's decode-path model functions against the JAX package's, on
shared weights (JAX init, bridged with ``from_jax_params``) and shared
inputs made with numpy: layers, GQA decode over a dense cache and over
a paged pool (JAX's jnp gather path and its Pallas kernel in interpret
mode), and the logits head."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch.models import attention as pattn
from repro_torch.models import layers as players
from repro_torch.models import transformer as ptf


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is faster than a pool, and keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=2e-5, atol=2e-5)   # fp32, different summation order


def _cfg():
    return tiny("mixtral-8x7b", layers=1, d_model=64)


def _pcfg(cfg):
    import repro_torch.configs as pc
    return dataclasses.replace(
        pc.reduced(pc.get_config("mixtral-8x7b"), layers=1, d_model=64,
                   experts=4, vocab=128), dtype="float32")


def _attn_params(cfg):
    jp = jattn.init_gqa(jax.random.PRNGKey(0), cfg, jnp.float32)
    return jp, ptf.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 2, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(
        players.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w))), **TOL)
    pos = np.array([[0, 5, 17, 300]], np.int32)
    for th in (1e4, 1e6):
        jc, js = jlayers.rope_cos_sin(jnp.asarray(pos), 16, th)
        pcos, psin = players.rope_cos_sin(torch.from_numpy(pos), 16, th)
        np.testing.assert_allclose(pcos.numpy(), np.asarray(jc), **TOL)
        np.testing.assert_allclose(psin.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(
        players.sinusoidal_positions(torch.from_numpy(pos), 32).numpy(),
        np.asarray(jlayers.sinusoidal_positions(jnp.asarray(pos), 32)),
        **TOL)


def test_gqa_decode_multipos_matches_reference():
    cfg = _cfg()
    jp, tp = _attn_params(cfg)
    rng = np.random.default_rng(1)
    B, L = 3, 12
    k = rng.normal(size=(B, L, cfg.num_kv_heads, cfg.head_dim)).astype(
        np.float32)
    v = rng.normal(size=k.shape).astype(np.float32)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([0, 5, 11], np.int32)
    jy, jc = jattn.gqa_decode_multipos(
        jp, cfg, jnp.asarray(x), {"k": jnp.asarray(k), "v": jnp.asarray(v)},
        jnp.asarray(pos))
    cache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    py, pc = pattn.gqa_decode_multipos(tp, _pcfg(cfg), torch.from_numpy(x),
                                       cache, torch.from_numpy(pos))
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), **TOL)
    assert pc is cache                       # updated in place
    np.testing.assert_allclose(pc["k"].numpy(), np.asarray(jc["k"]), **TOL)
    np.testing.assert_allclose(pc["v"].numpy(), np.asarray(jc["v"]), **TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_gqa_decode_paged_matches_reference(impl, monkeypatch):
    """Rows 0 and 1 are live requests; rows 2 and 3 are two virtual
    rows of one chunk (same table, consecutive positions) and row 3
    must see row 2's freshly scattered K/V."""
    cfg = _cfg()
    jp, tp = _attn_params(cfg)
    rng = np.random.default_rng(2)
    N, bs = 9, 4
    pool = {n: rng.normal(size=(N, bs, cfg.num_kv_heads,
                                cfg.head_dim)).astype(np.float32)
            for n in ("k", "v")}
    tables = np.array([[3, 1, 8], [5, 0, 8], [2, 6, 7], [2, 6, 7]], np.int32)
    pos = np.array([9, 2, 6, 7], np.int32)
    x = rng.normal(size=(4, 1, cfg.d_model)).astype(np.float32)
    monkeypatch.setattr(jattn, "PAGED_ATTN_IMPL", impl)
    jy, jc = jattn.gqa_decode_paged(
        jp, cfg, jnp.asarray(x), {n: jnp.asarray(a) for n, a in pool.items()},
        jnp.asarray(pos), jnp.asarray(tables))
    cache = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    py, pc = pattn.gqa_decode_paged(tp, _pcfg(cfg), torch.from_numpy(x),
                                    cache, torch.from_numpy(pos),
                                    torch.from_numpy(tables))
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=2e-4,
                               atol=2e-4)
    for n in ("k", "v"):
        np.testing.assert_allclose(pc[n].numpy(), np.asarray(jc[n]), **TOL)


def test_paged_equals_dense_decode_in_the_port():
    """The same rows through a dense cache and through a shuffled block
    table give the same attention output."""
    cfg = _cfg()
    _, tp = _attn_params(cfg)
    pcfg = _pcfg(cfg)
    rng = np.random.default_rng(3)
    B, bs, T = 2, 4, 3
    L = bs * T
    dense = {n: torch.from_numpy(rng.normal(
        size=(B, L, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32))
        for n in ("k", "v")}
    tables = torch.tensor([[4, 0, 2], [1, 5, 3]], dtype=torch.int32)
    pool = {n: torch.zeros(6, bs, cfg.num_kv_heads, cfg.head_dim)
            for n in ("k", "v")}
    for b in range(B):
        for j in range(T):
            for n in ("k", "v"):
                pool[n][tables[b, j]] = dense[n][b, j * bs:(j + 1) * bs]
    x = torch.from_numpy(rng.normal(size=(B, 1, cfg.d_model)).astype(
        np.float32))
    pos = torch.tensor([5, 10], dtype=torch.int32)
    yd, _ = pattn.gqa_decode_multipos(tp, pcfg, x, dense, pos)
    yp, _ = pattn.gqa_decode_paged(tp, pcfg, x, pool, pos, tables)
    torch.testing.assert_close(yp, yd, rtol=1e-5, atol=1e-5)


def test_logits_and_decode_state_match_reference():
    cfg = tiny("mixtral-8x7b")
    jp = jtf.init_params(cfg, jax.random.PRNGKey(1))
    tp = ptf.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    h = np.random.default_rng(4).normal(size=(2, 1, cfg.d_model)).astype(
        np.float32)
    np.testing.assert_allclose(
        ptf.logits_from_hidden(tp, cfg, torch.from_numpy(h)).numpy(),
        np.asarray(jtf.logits_from_hidden(jp, cfg, jnp.asarray(h))), **TOL)
    js = jtf.init_decode_state(jp, cfg, 3, 7, dtype=jnp.float32)
    ps = ptf.init_decode_state(tp, cfg, 3, 7, dtype=torch.float32,
                               device="cpu")
    assert len(ps["layers"]) == cfg.num_layers
    for n in ("k", "v"):
        for layer in ps["layers"]:          # JAX stacks them on [L]
            assert tuple(layer[n].shape) == js["layers"][n].shape[1:]
            assert not layer[n].any()
