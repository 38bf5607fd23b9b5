"""The port's offload engine against the JAX package's, end to end on
the CPU: the same params (JAX init, bridged), the same prompts, across
the policy x prefetch x overlap grid (the learned policy and predictor
with the model each package trains from one trace). Greedy tokens,
the functional trace rows, ``stats()`` and the simulated clock must be
EQUAL — the control plane is the reference's numpy, so any difference
is a routing flip, and each test asserts that the smallest router top-k margin it
saw is far above fp32 noise (so a failure would be a real fault, not a
near-tie). Then the engine's own invariants: a null fault plan equals
no injector; the memory-tier knobs raise the reference's errors. The servers are in
``test_torch_serving.py``, the learned module's own cases in
``test_torch_learned.py``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import tiny
from repro.core import OffloadEngine as JEngine
from repro.core.faults import FaultPlan as JFaultPlan
from repro.core.learned import synthetic_trace as jsynthetic_trace
from repro.core.learned import train_from_trace as jtrain_from_trace
from repro.data import drifting_workload
from repro.models import transformer as jtf
from repro.serving import ContinuousOffloadServer as JServer
import repro_torch.configs as pcfg
from repro_torch.core.faults import FaultPlan
from repro_torch.core.learned import synthetic_trace, train_from_trace
from repro_torch.core.offload_engine import OffloadEngine
from repro_torch.models import transformer as ptf
from repro_torch.models.layers import rms_norm
from repro_torch.serving.offload_serving import ContinuousOffloadServer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is faster than a pool, and keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [3, 1, 4, 1, 5, 9]]
FUNCTIONAL = ("activated", "hits", "misses", "evicted", "spec_guess",
              "prefetched")
MIN_MARGIN = 1e-4


@pytest.fixture(scope="module")
def setup():
    kw = dict(layers=2, d_model=64, experts=8, vocab=128)
    cfg = dataclasses.replace(tiny("mixtral-8x7b", **kw),
                              num_experts_per_tok=2)
    pc = dataclasses.replace(
        pcfg.reduced(pcfg.get_config("mixtral-8x7b"), **kw),
        dtype="float32", num_experts_per_tok=2)
    jp = jtf.init_params(cfg, jax.random.PRNGKey(0))
    tp = ptf.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, pc, tp


def _track_margins(engine):
    """Record, per MoE call, the smallest gap between the k-th and
    (k+1)-th router logit over the active rows."""
    seen = []
    orig = engine._moe_offloaded
    k = engine.cfg.num_experts_per_tok

    def wrapped(p_l, layer, h, *rest):
        x = rms_norm(h, p_l["ln2"], engine.cfg.norm_eps)
        logits = (x.float() @ p_l["moe"]["router"])[:, 0, :].numpy()
        srt = -np.sort(-logits, axis=-1)
        gap = (srt[:, k - 1] - srt[:, k])[np.asarray(rest[-1], bool)]
        seen.append(float(gap.min()))
        return orig(p_l, layer, h, *rest)

    engine._moe_offloaded = wrapped
    return seen


def _rows(trace):
    return [tuple(getattr(s, f) for f in FUNCTIONAL) for s in trace.steps]


def _assert_same_run(jeng, peng, margins):
    assert _rows(peng.trace) == _rows(jeng.trace)
    assert peng.stats() == jeng.stats()
    assert peng.sim_time == jeng.sim_time
    assert min(margins) > MIN_MARGIN, min(margins)


GRID = [dict(policy=p, prefetch=f, overlap=o)
        for p in ("lru", "lfu", "learned")
        for f in (None, "spec", "markov", "learned")
        for o in (False, True)]


@pytest.fixture(scope="module")
def learned_models():
    """(JAX model, port model), each trained by its own package from one
    drifting 2-layer, 8-expert trace: bitwise the same weights."""
    wl = drifting_workload(num_layers=2, num_experts=8, top_k=2,
                           n_tokens=48, seed=5)
    jm = jtrain_from_trace(jsynthetic_trace(wl.acts), 8)
    pm = train_from_trace(synthetic_trace(wl.acts), 8)
    assert (pm.w == jm.w).all() and pm.confidence == jm.confidence
    return jm, pm


def with_models(kw, learned_models):
    """(JAX kwargs, port kwargs): a grid case's kwargs plus each
    package's own model where the case uses the learned policy or
    predictor."""
    if "learned" not in (kw["policy"], kw["prefetch"]):
        return kw, kw
    jm, pm = learned_models
    return dict(kw, learned_model=jm), dict(kw, learned_model=pm)


@pytest.mark.parametrize("kw", GRID, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_generate_matches_reference(setup, learned_models, kw):
    cfg, jp, pc, tp = setup
    jkw, pkw = with_models(kw, learned_models)
    jeng = JEngine(jp, cfg, cache_slots=3, **jkw)
    peng = OffloadEngine(tp, pc, cache_slots=3, device="cpu", **pkw)
    margins = _track_margins(peng)
    assert peng.generate(PROMPTS[0], 6) == jeng.generate(PROMPTS[0], 6)
    _assert_same_run(jeng, peng, margins)


FAULTY = dict(seed=3, dma_failure_rate=0.3, corruption_rate=0.2,
              max_retries=1)


@pytest.mark.parametrize("quant,faults", [
    ("int8", None),
    ("none", FAULTY),
    ("int8", FAULTY),
])
def test_quantized_store_and_fault_injection_match_reference(setup, quant,
                                                             faults):
    """int8 masters (same bytes moved) and a non-null fault plan (real
    corrupted payloads caught by the CRC, abandoned fetches degrading
    decode) follow the reference event for event."""
    cfg, jp, pc, tp = setup
    kw = dict(cache_slots=2, policy="lru", prefetch="spec", quant=quant)
    jeng = JEngine(jp, cfg, faults=faults and JFaultPlan(**faults), **kw)
    peng = OffloadEngine(tp, pc, faults=faults and FaultPlan(**faults),
                         device="cpu", **kw)
    margins = _track_margins(peng)
    assert peng.generate(PROMPTS[2], 6) == jeng.generate(PROMPTS[2], 6)
    _assert_same_run(jeng, peng, margins)
    if faults:
        assert [dataclasses.astuple(e) for e in peng.trace.fault_events] == \
            [dataclasses.astuple(e) for e in jeng.trace.fault_events]
        s = peng.stats()
        assert s["fault_corruptions"] > 0 and s["corrupt_refetches"] > 0


# ------------------------------------------------ the port's invariants
@pytest.mark.parametrize("kw", [dict(), dict(prefetch="spec"),
                                dict(prefetch="markov", overlap=True)])
def test_null_fault_plan_is_bit_identical(setup, kw):
    _, _, pc, tp = setup
    outs = []
    for faults in (None, FaultPlan.null()):
        eng = OffloadEngine(tp, pc, cache_slots=3, faults=faults,
                            device="cpu", **kw)
        toks = eng.generate([1, 2, 3, 4], 6)
        outs.append((toks, eng.sim_time, eng.stats(), eng.trace.to_json()))
    a, b = outs
    assert a[0] == b[0] and a[1] == b[1] and a[3] == b[3]
    assert {k: v for k, v in b[2].items() if k in a[2]} == a[2]
    assert all(b[2][k] == 0 for k in set(b[2]) - set(a[2]))


TIER_KNOB_ERRORS = {
    "frac_above_1": dict(cache_slots=None, hbm_budget_bytes=1 << 30,
                         tier_expert_frac=1.5),
    "frac_below_0": dict(cache_slots=2, tier_expert_frac=-0.1),
    "zero_hbm_budget": dict(cache_slots=None, hbm_budget_bytes=0),
    "negative_host_budget": dict(cache_slots=2, host_budget_bytes=-1),
    "dense_kv_with_budget": dict(cache_slots=None, hbm_budget_bytes=1 << 30,
                                 kv_layout="dense"),
    "budget_and_cache_slots": dict(cache_slots=2, hbm_budget_bytes=1 << 30),
    "budget_and_kv_blocks": dict(cache_slots=None, hbm_budget_bytes=1 << 30,
                                 kv_num_blocks=8),
    "no_slots_no_budget": dict(cache_slots=None),
}


@pytest.mark.parametrize("name", list(TIER_KNOB_ERRORS))
def test_tier_knobs_raise_like_reference(setup, name):
    """The memory-tier knobs are validated as the JAX server validates
    them: the same ValueError, with the same message."""
    cfg, jp, pc, tp = setup
    kw = TIER_KNOB_ERRORS[name]
    with pytest.raises(ValueError) as want:
        JServer(jp, cfg, **kw)
    with pytest.raises(ValueError) as got:
        ContinuousOffloadServer(tp, pc, device="cpu", **kw)
    assert str(got.value) == str(want.value)
