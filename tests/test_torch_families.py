"""The port's hybrid (Jamba), encdec (Whisper) and vlm (Llama-3.2-Vision)
families against the JAX package's, on shared weights (JAX init,
bridged with ``from_jax_params``) and shared inputs made with numpy:
``layer_norm`` and the GELU MLP, ``encoder_forward``, ``cross_kv`` and
``cross_attend`` (JAX under its XLA blockwise attention and under the
Pallas flash kernel in interpret mode), ``forward`` / ``prefill`` with
``enc=``, the ``decode_step`` loop, and ``ServingEngine`` greedy tokens.

Tolerances: ``MODULE_TOL`` (rtol = atol = 2e-5) for module functions,
``LOGIT_TOL`` (rtol = atol = 3e-3, as ``test_models_math.py``) for
hidden states and logits of whole models. The hybrid runs 8 layers in
periods of 4 (P 2, per 3): an attention layer with a dense FFN, then SSM
layers with MoE, dense and MoE FFNs. Its tests assert that the smallest
router top-k margin they saw is far above fp32 noise, so a token
mismatch would be a real fault and not a tie ordered differently by
``torch.topk`` and ``jax.lax.top_k``."""
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
from repro.serving import ServingEngine as JEngine
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as pattn
from repro_torch.models import layers as players
from repro_torch.models import transformer as ptf
from repro_torch.serving.engine import ServingEngine
from test_torch_prefill import (MIN_MARGIN, TOKENS,  # noqa: F401
                                _bridge, _one_torch_thread, track_margins)

MODULE_TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_TOL = dict(rtol=3e-3, atol=3e-3)
FRAMES, PATCHES = 37, 33        # neither fills a whole tile of keys
PROMPTS = [[3, 17, 42, 5, 99, 7], [9, 8, 7]]


def _with_random_biases(tree, rng):
    """QKV and MLP biases init to zero: draw them, so that they count."""
    def walk(t):
        if isinstance(t, dict):
            return {k: (jnp.asarray(rng.normal(size=v.shape) * 0.1,
                                    v.dtype)
                        if k in ("bq", "bk", "bv", "b1", "b2") else walk(v))
                    for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(walk(v) for v in t)
        return t
    return walk(tree)


def _cfg(family):
    if family == "hybrid":
        return dataclasses.replace(
            tiny("jamba-1.5-large-398b", layers=8), attn_every=4,
            ssm_chunk=4)
    if family == "encdec":
        return tiny("whisper-tiny")
    return tiny("llama-3.2-vision-11b", layers=4)


def _model(family, seed=1):
    """(cfg, JAX params, port params, JAX enc, port enc): ``enc`` is the
    encoder's states over FRAMES seeded frames (encdec), PATCHES seeded
    patch embeddings (vlm) or None (hybrid), batch 2."""
    cfg = _cfg(family)
    rng = np.random.default_rng(seed)
    jp = _with_random_biases(jtf.init_params(cfg, jax.random.PRNGKey(seed)),
                             rng)
    tp = _bridge(jp)
    jenc = penc = None
    if family == "encdec":
        frames = rng.normal(size=(2, FRAMES, cfg.d_model)).astype(np.float32)
        jenc = jtf.encoder_forward(jp, cfg, jnp.asarray(frames))
        penc = ptf.encoder_forward(tp, cfg, torch.from_numpy(frames))
    elif family == "vlm":
        patches = rng.normal(size=(2, PATCHES, cfg.d_model)).astype(
            np.float32)
        jenc, penc = jnp.asarray(patches), torch.from_numpy(patches)
    return cfg, jp, tp, jenc, penc


FAMILIES = ["hybrid", "encdec", "vlm"]


# ------------------------------------------------------------- layouts
def test_hybrid_and_vlm_layouts():
    """Jamba's period: attention (dense FFN), then SSM layers with MoE,
    dense, MoE (``moe_every=2``); the vlm's plain layers stack [P, per]
    and its cross layers [P]; the port's own init draws the same tree."""
    cfg, jp, tp, _, _ = _model("hybrid")
    assert isinstance(tp["ssm_layers"], tuple) and len(tp["ssm_layers"]) == 3
    assert "mlp" in tp["attn_layers"]
    assert ["moe" in s for s in tp["ssm_layers"]] == [True, False, True]
    assert tp["ssm_layers"][0]["ssm"]["in_z"].shape[0] == 2
    own = ptf.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    assert ["moe" in s for s in own["ssm_layers"]] == [True, False, True]
    vcfg, _, vp, _, _ = _model("vlm")
    assert tuple(vp["layers"]["attn"]["wq"].shape[:2]) == (2, 1)
    assert tuple(vp["cross_layers"]["cross"]["wk"].shape) == (
        2, vcfg.d_model, vcfg.num_heads, vcfg.head_dim)


# ------------------------------------------------------ module functions
def test_layer_norm_and_gelu_mlp_match_reference():
    cfg = tiny("whisper-tiny")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    w, b = (rng.normal(size=(cfg.d_model,)).astype(np.float32)
            for _ in range(2))
    want = jlayers.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = players.layer_norm(*(torch.from_numpy(a) for a in (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)
    jm = _with_random_biases(jlayers.init_gelu_mlp(
        jax.random.PRNGKey(2), cfg.d_model, cfg.d_ff, cfg.num_layers,
        jnp.float32), rng)
    got = players.gelu_mlp(_bridge(jm), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jlayers.gelu_mlp(jm,
                                                           jnp.asarray(x))),
                               **MODULE_TOL)
    own = players.init_gelu_mlp(torch.Generator().manual_seed(0),
                                cfg.d_model, cfg.d_ff, cfg.num_layers,
                                torch.float32, layers=3, device="cpu")
    assert {k: tuple(v.shape[1:]) for k, v in own.items()} == {
        k: v.shape for k, v in jm.items()}
    assert all(v.shape[0] == 3 for v in own.values())


@pytest.mark.parametrize("impl", ["xla_blockwise", "pallas_interpret"])
def test_encoder_forward_matches_reference(impl, monkeypatch):
    """Non-causal self-attention over 37 frames, QKV and MLP biases."""
    cfg, jp, tp, _, _ = _model("encdec")
    frames = np.random.default_rng(4).normal(
        size=(2, FRAMES, cfg.d_model)).astype(np.float32)
    monkeypatch.setattr(jattn, "ATTN_IMPL", impl)
    want = jtf.encoder_forward(jp, cfg, jnp.asarray(frames))
    got = ptf.encoder_forward(tp, cfg, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)


@pytest.mark.parametrize("family", ["encdec", "vlm"])
@pytest.mark.parametrize("impl", ["xla_blockwise", "pallas_interpret"])
def test_cross_kv_and_cross_attend_match_reference(family, impl,
                                                   monkeypatch):
    """MHA over 37 encoder frames (Whisper: biased) or 33 patches, with
    5 queries and with one (a decode step's)."""
    cfg, jp, tp, jenc, penc = _model(family)
    stack = "layers" if family == "encdec" else "cross_layers"
    jc = jax.tree.map(lambda a: a[1], jp[stack]["cross"])
    pc = ptf._layer(tp[stack], 1)["cross"]
    assert ("bq" in pc) == (family == "encdec")
    monkeypatch.setattr(jattn, "ATTN_IMPL", impl)
    jkv = jattn.cross_kv(jc, jenc)
    pkv = pattn.cross_kv(pc, penc)
    for n in ("k", "v"):
        assert tuple(pkv[n].shape) == (2, penc.shape[1], cfg.num_heads,
                                       cfg.head_dim)
        np.testing.assert_allclose(pkv[n].numpy(), np.asarray(jkv[n]),
                                   **MODULE_TOL)
    x = np.random.default_rng(5).normal(size=(2, 5, cfg.d_model)).astype(
        np.float32)
    for S in (5, 1):
        want = jattn.cross_attend(jc, cfg, jnp.asarray(x[:, :S]), jkv)
        got = pattn.cross_attend(pc, cfg, torch.from_numpy(x[:, :S]), pkv)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MODULE_TOL)


# ------------------------------------------------------------ whole models
@pytest.mark.parametrize("family", FAMILIES)
def test_forward_and_prefill_match_reference(family, monkeypatch):
    cfg, jp, tp, jenc, penc = _model(family)
    margins = track_margins(monkeypatch)
    toks = np.array([TOKENS, TOKENS[::-1]], np.int32)
    paths = ("dense", "capacity") if cfg.is_moe else ("auto",)
    for path in paths:
        want = jtf.prefill(jp, cfg, jnp.asarray(toks), enc=jenc,
                           moe_path=path)
        got = ptf.prefill(tp, cfg, torch.from_numpy(toks).long(), enc=penc,
                          moe_path=path)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)
    h, aux = ptf.forward(tp, cfg, torch.from_numpy(toks).long(), enc=penc)
    jh, jaux = jtf.forward(jp, cfg, jnp.asarray(toks), enc=jenc)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5,
                               atol=1e-7)
    if cfg.is_moe:
        assert float(aux) > 0.0
        assert min(margins) > MIN_MARGIN, min(margins)


@pytest.mark.parametrize("family", FAMILIES)
def test_decode_loop_matches_reference_and_own_prefill(family,
                                                       monkeypatch):
    """Each ``decode_step`` against JAX's, the state's shape against
    JAX's stacked one, and the last step against the port's prefill."""
    cfg, jp, tp, jenc, penc = _model(family)
    margins = track_margins(monkeypatch)
    toks = np.array([TOKENS, TOKENS[::-1]], np.int32)
    S = toks.shape[1]
    js = jtf.init_decode_state(jp, cfg, 2, S, enc=jenc)
    ps = ptf.init_decode_state(tp, cfg, 2, S, enc=penc, device="cpu")
    assert ps.keys() == js.keys()
    for i in range(S):
        jl, js = jtf.decode_step(jp, cfg, js, jnp.asarray(toks[:, i:i + 1]),
                                 jnp.int32(i), moe_path="dense")
        pl, ps = ptf.decode_step(tp, cfg, ps,
                                 torch.from_numpy(toks[:, i:i + 1]).long(),
                                 i, moe_path="dense")
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGIT_TOL)
    if family == "hybrid":
        assert len(ps["attn_layers"]) == 2 and len(ps["ssm_layers"]) == 3
        np.testing.assert_allclose(ps["ssm_layers"][2][1]["ssd"].numpy(),
                                   np.asarray(js["ssm_layers"][2]["ssd"][1]),
                                   **LOGIT_TOL)
    elif family == "vlm":
        np.testing.assert_allclose(ps["layers"][1][0]["k"].numpy(),
                                   np.asarray(js["layers"]["k"][1, 0]),
                                   **LOGIT_TOL)
    for i, kv in enumerate(ps.get("cross_kv", ())):
        np.testing.assert_allclose(kv["v"].numpy(),
                                   np.asarray(js["cross_kv"]["v"][i]),
                                   **MODULE_TOL)
    want = ptf.prefill(tp, cfg, torch.from_numpy(toks).long(), enc=penc,
                       moe_path="dense")
    torch.testing.assert_close(pl, want, **LOGIT_TOL)
    if cfg.is_moe:
        assert min(margins) > MIN_MARGIN, min(margins)


def test_hybrid_ring_window_decode_matches_windowed_forward():
    """Jamba-style decode through a ring KV buffer smaller than the
    sequence == the full forward with the same window mask (the SSM
    state is window-free), as ``test_models_math.py`` checks for JAX."""
    cfg = dataclasses.replace(_cfg("hybrid"), ssm_chunk=2)
    tp = _bridge(jtf.init_params(cfg, jax.random.PRNGKey(3)))
    W, toks = 4, torch.arange(1, 11)[None]
    h, _ = ptf.forward(tp, cfg, toks, window=W, moe_path="dense")
    want = ptf.logits_from_hidden(tp, cfg, h[:, -1:, :])[:, 0]
    state = ptf.init_decode_state(tp, cfg, 1, W, device="cpu")
    for i in range(toks.shape[1]):
        got, state = ptf.decode_step(tp, cfg, state, toks[:, i:i + 1], i,
                                     window=W, moe_path="dense")
    torch.testing.assert_close(got, want, **LOGIT_TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_greedy_tokens_equal_reference(family, monkeypatch):
    cfg, jp, tp, jenc, penc = _model(family)
    margins = track_margins(monkeypatch)
    want = JEngine(jp, cfg, cache_len=16).generate_batch(
        PROMPTS, max_new=6, enc=jenc)
    got = ServingEngine(tp, cfg, cache_len=16, device="cpu").generate_batch(
        PROMPTS, max_new=6, enc=penc)
    assert got == want
    if cfg.is_moe:
        assert min(margins) > MIN_MARGIN, min(margins)


# ------------------------------------------------- kernel calls per family
@pytest.mark.parametrize("family", FAMILIES)
def test_kernel_calls_follow_the_layer_kinds(family, monkeypatch):
    """The calls ``chip_smoke.py`` counts on the card: a prefill calls
    flash attention once per attention layer and once per cross layer
    (non-causal), SSD chunk once per SSM layer; the encoder calls flash
    once a layer, non-causal; a decode step calls flash once per cross
    layer (Sq = 1), SSD chunk never."""
    cfg, _, tp, _, penc = _model(family)
    calls = []
    for name in ("flash_attention", "ssd_chunk"):
        orig = getattr(kops, name)
        monkeypatch.setattr(
            kops, name, lambda *a, _n=name, _f=orig, **kw:
            calls.append((_n, a[0].shape[1], kw.get("causal"))) or
            _f(*a, **kw))
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    cross = sum(cfg.has_cross_attn(i) for i in range(cfg.num_layers))
    toks = torch.tensor([TOKENS, TOKENS[::-1]], dtype=torch.long)
    ptf.prefill(tp, cfg, toks, enc=penc)
    names = [c[0] for c in calls]
    assert names.count("flash_attention") == kinds.count("attn") + cross
    assert names.count("ssd_chunk") == kinds.count("ssm")
    assert sum(c[2] is False for c in calls) == cross
    if family == "encdec":
        calls.clear()
        ptf.encoder_forward(tp, cfg, torch.zeros((2, FRAMES, cfg.d_model)))
        assert calls == [("flash_attention", FRAMES, False)] * \
            cfg.encoder_layers
    state = ptf.init_decode_state(tp, cfg, 2, 4, enc=penc, device="cpu")
    calls.clear()
    ptf.decode_step(tp, cfg, state, toks[:, :1], 0)
    assert calls == [("flash_attention", 1, False)] * cross
