"""DeepSeek-V2 through the port: MLA attention, one shared (always
resident) expert and routed experts, on the fixture of
``tests/test_offload_deepseek.py`` (2 layers, d_model 64, 4 heads of hd
16, ``kv_lora_rank`` 64, ``qk_rope_dim`` 32, top-4 of 4 experts, fp32).

The four tests of that file run here on the port, and each also holds
the port against the JAX package on shared weights (JAX init, bridged):
greedy tokens, the functional trace rows, ``stats()`` and the simulated
clock must be EQUAL, logits within 3e-4. Then the continuous server
(paged latent KV, 4-token prefill chunks, staggered requests) across
policy lru/lfu x prefetch None/spec x overlap, int8 masters, a tiered
server whose MLA request is parked and resumed, and the full-sequence
path (``prefill``, ``forward``, ``decode_step``, ``ServingEngine``).

With top-4 of 4 experts every token takes every expert, so no routing
decision can flip between the packages; what can is the ORDER of the
engine's batch union (experts by summed gate weight, which decides the
streamed chunks and the trace's ``activated``). Each engine test
asserts that the smallest gap between two union weights it saw is far
above fp32 noise, so a failure would be a real fault, not a near-tie.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core import OffloadEngine as JEngine
from repro.models import transformer as jtf
from repro.serving import ContinuousOffloadServer as JServer
from repro.serving import ServingEngine as JServingEngine
import repro_torch.configs as pcfg
from repro_torch.core.offload_engine import OffloadEngine, _batch_union
from repro_torch.models import transformer as ptf
from repro_torch.models.layers import rms_norm
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.offload_serving import ContinuousOffloadServer
from test_torch_engine import MIN_MARGIN, _rows
from test_torch_tiers import _parks, _tier_rows, _tiered_server


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is faster than a pool, and keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ENGINE_TOL = dict(rtol=3e-4, atol=3e-4)   # the JAX test's tolerance
TOL = dict(rtol=2e-4, atol=2e-4)          # full-sequence path, fp32
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [3, 1, 4, 1, 5, 9]]


@pytest.fixture(scope="module")
def dsv2():
    kw = dict(layers=2, d_model=64, experts=4)
    cfg = dataclasses.replace(reduced(get_config("deepseek-v2-236b"), **kw),
                              dtype="float32")
    pc = dataclasses.replace(
        pcfg.reduced(pcfg.get_config("deepseek-v2-236b"), **kw),
        dtype="float32")
    assert dataclasses.asdict(pc) == dataclasses.asdict(cfg)
    jp = jtf.init_params(cfg, jax.random.PRNGKey(0))
    tp = ptf.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, pc, tp


def _track_union_margins(engine):
    """Record, per MoE call, the smallest gap between two summed gate
    weights of the active rows' batch union (the order the engine
    streams and traces), and between the k-th and (k+1)-th router logit
    where k < E."""
    seen = []
    orig = engine._moe_offloaded
    cfg = engine.cfg

    def wrapped(p_l, layer, h, *rest):
        active = rest[-1]
        x = rms_norm(h, p_l["ln2"], cfg.norm_eps)
        ids, probs = engine._route(p_l, x)
        union, w = _batch_union(ids, probs, active, cfg.num_experts)
        gaps = -np.diff(w[union])
        k = cfg.num_experts_per_tok
        if k < cfg.num_experts:
            logits = (x.float() @ p_l["moe"]["router"])[:, 0].numpy()
            srt = -np.sort(-logits, axis=-1)[np.asarray(active, bool)]
            gaps = np.concatenate([gaps, srt[:, k - 1] - srt[:, k]])
        if gaps.size:
            seen.append(float(gaps.min()))
        return orig(p_l, layer, h, *rest)

    engine._moe_offloaded = wrapped
    return seen


def _assert_same_run(jeng, peng, margins):
    assert _rows(peng.trace) == _rows(jeng.trace)
    assert peng.stats() == jeng.stats()
    assert peng.sim_time == jeng.sim_time
    assert min(margins) > MIN_MARGIN, min(margins)


def _engines(dsv2, **kw):
    cfg, jp, pc, tp = dsv2
    jeng = JEngine(jp, cfg, **kw)
    peng = OffloadEngine(tp, pc, device="cpu", **kw)
    return jeng, peng, _track_union_margins(peng)


# ------------------------------- tests/test_offload_deepseek.py, ported
def test_offloaded_mla_moe_matches_on_device(dsv2):
    """One offloaded decode step == the on-device ``decode_step``
    (dense MoE path, absorbed MLA decode), and == JAX's offloaded step."""
    cfg, jp, pc, tp = dsv2
    assert pc.use_mla and pc.num_shared_experts == 1
    jeng, peng, margins = _engines(dsv2, cache_slots=3, policy="lfu")
    jgot, _ = jeng.decode_token(jeng.init_state(1, 8),
                                jnp.asarray([[7]], jnp.int32), 0, 0)
    got, _ = peng.decode_token(peng.init_state(1, 8), [[7]], 0, 0)
    state = ptf.init_decode_state(tp, pc, 1, 8, device="cpu")
    want, _ = ptf.decode_step(tp, pc, state, torch.tensor([[7]]), 0,
                              moe_path="dense")
    np.testing.assert_allclose(got.numpy(), want.numpy(), **ENGINE_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), **ENGINE_TOL)
    _assert_same_run(jeng, peng, margins)


def test_shared_experts_never_in_cache(dsv2):
    """Shared experts stay on the device: only routed experts are keyed
    into the store and the caches."""
    cfg = dsv2[0]
    jeng, peng, margins = _engines(dsv2, cache_slots=3, policy="lru")
    assert peng.generate([1, 2, 3], 8) == jeng.generate([1, 2, 3], 8)
    keys = peng.store.keys()
    assert len(keys) == cfg.num_layers * cfg.num_experts
    assert sorted(keys) == sorted(jeng.store.keys())
    assert "shared" in peng._layers[0]["moe"]
    _assert_same_run(jeng, peng, margins)


def test_offload_with_spec_prefetch_on_mla(dsv2):
    jeng, peng, margins = _engines(dsv2, cache_slots=3, policy="lru",
                                   prefetch="spec")
    assert peng.generate([1, 2, 3], 10) == jeng.generate([1, 2, 3], 10)
    s = peng.stats()
    assert s["spec_precision"] == pytest.approx(s["spec_recall"])
    assert s["hits"] + s["misses"] > 0
    _assert_same_run(jeng, peng, margins)


def test_working_set_larger_than_cache_streams(dsv2):
    """top-4 can exceed tiny caches: the engine streams the union in
    chunks and stays exact, here and in JAX."""
    outs = []
    for slots in (1, 4):
        jeng, peng, margins = _engines(dsv2, cache_slots=slots,
                                       policy="lru")
        out = peng.generate([4, 5], 8)
        assert out == jeng.generate([4, 5], 8)
        _assert_same_run(jeng, peng, margins)
        outs.append(out)
    assert outs[0] == outs[1]


# ------------------------------------------------------------- servers
GRID = [dict(policy=p, prefetch=f, overlap=o)
        for p in ("lru", "lfu")
        for f in (None, "spec")
        for o in (False, True)]
SERVER_KW = dict(cache_slots=3, max_batch=2, cache_len=32, kv_block_size=4,
                 prefill_chunk=4)


def _serve_both(dsv2, **kw):
    """Three requests through two slots of a ``ContinuousOffloadServer``
    in each package; the port's server, run, must equal JAX's."""
    cfg, jp, pc, tp = dsv2
    jsrv = JServer(jp, cfg, **kw)
    psrv = ContinuousOffloadServer(tp, pc, device="cpu", **kw)
    margins = _track_union_margins(psrv.engine)
    for srv in (jsrv, psrv):
        for p in PROMPTS:
            srv.submit(p, max_new=4)
    assert psrv.run() == jsrv.run()
    assert psrv.stats() == jsrv.stats()
    _assert_same_run(jsrv.engine, psrv.engine, margins)
    return psrv


@pytest.mark.parametrize("kw", GRID, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_continuous_server_matches_reference(dsv2, kw):
    """Paged latent KV (``{latent, k_rope}`` block pools), chunked
    prefill (4-token chunks as virtual rows), three requests through two
    slots."""
    psrv = _serve_both(dsv2, **SERVER_KW, **kw)
    pool = psrv.paged.state["layers"][0]
    cfg = dsv2[0]
    assert {k: tuple(v.shape[2:]) for k, v in pool.items()} == {
        "latent": (cfg.kv_lora_rank,), "k_rope": (cfg.qk_rope_dim,)}


def test_int8_masters_match_reference(dsv2):
    """int8 expert masters (the same stored bytes moved) under the
    server, with speculative prefetch."""
    psrv = _serve_both(dsv2, **SERVER_KW, policy="lfu", prefetch="spec",
                       quant="int8")
    assert psrv.engine.store.quant == "int8"


def test_tiered_server_parks_and_resumes_mla(dsv2):
    """One HBM budget split into 2 slots a layer and 2 latent blocks of
    8 positions for two 16-token requests: the pool overcommits, the
    younger request's latent and rope-key blocks are parked in host
    memory and resumed. Right after each resume its blocks hold, bit
    for bit, the snapshot its park took; tokens, trace rows with
    ``miss_tiers``, tier events, ``stats()`` and the clock equal JAX's,
    and the parked arrays are allclose to JAX's."""
    cfg, jp, pc, tp = dsv2
    P0, P1 = [1, 2, 3, 4], [9, 8, 7, 6]
    kw = dict(slots=2, blocks=2, prefill_chunk=4)
    jsrv = _tiered_server(jp, cfg, jax_=True, **kw)
    psrv = _tiered_server(tp, pc, **kw)
    margins = _track_union_margins(psrv.engine)
    jparks = _parks(jsrv)
    parked, checked, pparks = {}, [], []
    park, restore = psrv.tiers.park_kv, psrv._restore_kv

    def on_park(rid, arrays, *args, **kwargs):
        parked[rid] = [{k: v.clone() for k, v in layer.items()}
                       for layer in arrays]
        pparks.append([{k: v.numpy().copy() for k, v in layer.items()}
                       for layer in arrays])
        return park(rid, arrays, *args, **kwargs)

    def on_restore(req):
        restore(req)
        snap = parked.pop(req.rid)
        blocks = psrv.paged.tables[req.rid][:len(snap[0]["latent"])]
        for layer, saved in zip(psrv.state["layers"], snap):
            assert layer.keys() == saved.keys() == {"latent", "k_rope"}
            for k, v in saved.items():
                assert torch.equal(layer[k][blocks], v)
        checked.append(req.rid)

    psrv.tiers.park_kv, psrv._restore_kv = on_park, on_restore
    for srv in (jsrv, psrv):
        for p in (P0, P1):
            srv.submit(p, max_new=12)
    assert psrv.run() == jsrv.run()
    s = psrv.stats()
    assert psrv.kv_preemptions >= 1, "pool did not overcommit"
    assert checked and not parked
    assert len(checked) == s["tier_kv_resumes"] == s["tier_kv_parks"] >= 1
    assert _tier_rows(psrv.trace) == _tier_rows(jsrv.trace)
    assert [dataclasses.astuple(e) for e in psrv.trace.tier_events] == \
        [dataclasses.astuple(e) for e in jsrv.trace.tier_events]
    assert s == jsrv.stats()
    assert psrv.engine.sim_time == jsrv.engine.sim_time
    assert min(margins) > MIN_MARGIN, min(margins)
    assert len(pparks) == len(jparks)
    for jpark, ppark in zip(jparks, pparks):
        for jl, pl in zip(jpark, ppark):
            assert jl.keys() == pl.keys()
            for k in jl:
                assert pl[k].shape == jl[k].shape
                np.testing.assert_allclose(pl[k], jl[k], rtol=1e-5,
                                           atol=1e-5)


# ------------------------------------------------ full-sequence path
def test_prefill_forward_and_decode_step_match_reference(dsv2):
    """``prefill`` (dense and capacity MoE paths, MLA through the flash
    wrapper), ``forward``'s hidden states and aux loss, and a
    token-by-token ``decode_step`` loop (absorbed MLA decode) against
    JAX's, and the port's decode loop against its own prefill."""
    cfg, jp, pc, tp = dsv2
    toks = np.array([[3, 17, 42, 5, 99, 7, 23, 56],
                     [56, 23, 7, 99, 5, 42, 17, 3]], np.int32)
    tt = torch.from_numpy(toks).long()
    for path in ("dense", "capacity"):
        want = jtf.prefill(jp, cfg, jnp.asarray(toks), moe_path=path)
        got = ptf.prefill(tp, pc, tt, moe_path=path)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    h, aux = ptf.forward(tp, pc, tt)
    jh, jaux = jtf.forward(jp, cfg, jnp.asarray(toks))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5,
                               atol=1e-7)
    B, S = toks.shape
    js = jtf.init_decode_state(jp, cfg, B, S, dtype=jnp.float32)
    ps = ptf.init_decode_state(tp, pc, B, S, device="cpu")
    for layer in ps["layers"]:
        assert {k: tuple(v.shape) for k, v in layer.items()} == {
            "latent": (B, S, cfg.kv_lora_rank),
            "k_rope": (B, S, cfg.qk_rope_dim)}
    for i in range(S):
        jl, js = jtf.decode_step(jp, cfg, js, jnp.asarray(toks[:, i:i + 1]),
                                 jnp.int32(i), moe_path="dense")
        pl, ps = ptf.decode_step(tp, pc, ps, tt[:, i:i + 1], i,
                                 moe_path="dense")
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    own = ptf.prefill(tp, pc, tt, moe_path="dense")
    torch.testing.assert_close(pl, own, rtol=3e-3, atol=3e-3)


def test_serving_engine_greedy_tokens_equal_reference(dsv2):
    cfg, jp, pc, tp = dsv2
    want = JServingEngine(jp, cfg, cache_len=16).generate_batch(
        PROMPTS, max_new=6)
    got = ServingEngine(tp, pc, cache_len=16, device="cpu").generate_batch(
        PROMPTS, max_new=6)
    assert got == want
