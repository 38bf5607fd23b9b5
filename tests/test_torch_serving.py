"""The port's servers against the JAX package's on the CPU, and their
own invariants: ``ContinuousOffloadServer`` (paged KV, chunked prefill,
staggered joins) across the policy x prefetch x overlap grid and the
``OffloadServer`` facade must give EQUAL tokens, functional trace rows,
``stats()`` and simulated clocks (see ``test_torch_engine.py`` for the
shared setup and the router-margin guard); then paged == dense, chunked
prefill == per-token feeding, a null fault plan == no injector, and
sampling as a function of (seed, token index)."""
import pytest

from repro.serving import ContinuousOffloadServer as JServer
from repro.serving import OffloadServer as JOffloadServer
from repro_torch.core.faults import FaultPlan
from repro_torch.core.offload_engine import OffloadEngine
from repro_torch.serving.offload_serving import (ContinuousOffloadServer,
                                                 OffloadServer)
from test_torch_engine import (GRID, PROMPTS, _assert_same_run,  # noqa: F401
                               _one_torch_thread, _track_margins,
                               learned_models, setup, with_models)


@pytest.mark.parametrize("kw", GRID, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_continuous_server_matches_reference(setup, learned_models, kw):
    """Paged KV, chunked prefill (4-token chunks as virtual rows), three
    requests through two slots."""
    cfg, jp, pc, tp = setup
    jkw, pkw = with_models(kw, learned_models)
    skw = dict(cache_slots=3, max_batch=2, cache_len=32, kv_block_size=4,
               prefill_chunk=4)
    jsrv = JServer(jp, cfg, **skw, **jkw)
    psrv = ContinuousOffloadServer(tp, pc, device="cpu", **skw, **pkw)
    margins = _track_margins(psrv.engine)
    for srv in (jsrv, psrv):
        for p in PROMPTS:
            srv.submit(p, max_new=4)
    assert psrv.run() == jsrv.run()
    assert psrv.stats() == jsrv.stats()
    _assert_same_run(jsrv.engine, psrv.engine, margins)


def test_offload_server_facade_matches_reference(setup):
    cfg, jp, pc, tp = setup
    jsrv = JOffloadServer(jp, cfg, cache_slots=3, policy="lfu")
    psrv = OffloadServer(tp, pc, cache_slots=3, policy="lfu", device="cpu")
    margins = _track_margins(psrv.engine)
    for p in PROMPTS:
        assert psrv.complete(p, max_new=4) == jsrv.complete(p, max_new=4)
    assert psrv.stats() == jsrv.stats()
    _assert_same_run(jsrv.engine, psrv.engine, margins)


# ------------------------------------------------ the port's invariants
@pytest.mark.parametrize("max_batch", [1, 2, 3])
def test_paged_matches_dense(setup, max_batch):
    _, _, pc, tp = setup
    outs, stats = {}, {}
    for layout in ("dense", "paged"):
        srv = ContinuousOffloadServer(tp, pc, cache_slots=3, policy="lru",
                                      max_batch=max_batch, cache_len=32,
                                      kv_layout=layout, kv_block_size=8,
                                      device="cpu")
        rids = [srv.submit(p, max_new=6) for p in PROMPTS]
        srv.run()
        outs[layout] = [srv.result(r) for r in rids]
        stats[layout] = srv.engine.stats()
    assert outs["paged"] == outs["dense"]
    assert stats["paged"] == stats["dense"]


def test_chunked_prefill_matches_per_token_feeding(setup):
    _, _, pc, tp = setup
    outs = {}
    for chunk in (1, 4):
        srv = ContinuousOffloadServer(tp, pc, cache_slots=3, policy="lfu",
                                      prefetch="spec", max_batch=2,
                                      cache_len=32, kv_block_size=4,
                                      prefill_chunk=chunk, device="cpu")
        rids = [srv.submit(p, max_new=5) for p in PROMPTS]
        srv.run()
        outs[chunk] = [srv.result(r) for r in rids]
        assert srv.stats()["kv_blocks_in_use"] == 0
    assert outs[4] == outs[1]


def test_null_fault_plan_server_is_bit_identical(setup):
    _, _, pc, tp = setup
    outs = []
    for faults in (None, FaultPlan.null()):
        srv = ContinuousOffloadServer(tp, pc, cache_slots=3, max_batch=2,
                                      cache_len=32, faults=faults,
                                      device="cpu")
        r0 = srv.submit([1, 2, 3], max_new=5)
        r1 = srv.submit([4, 5], max_new=4)
        srv.run()
        outs.append((srv.result(r0), srv.result(r1), srv.engine.sim_time,
                     srv.trace.to_json()))
    assert outs[0] == outs[1]


def test_sampling_is_a_function_of_seed_and_token(setup):
    """At T > 0 a request's draws depend only on (seed, token index):
    co-scheduled strangers change nothing, and ``generate`` makes the
    same draws as a server."""
    _, _, pc, tp = setup
    outs = []
    for companions in ([], [PROMPTS[2]]):
        srv = ContinuousOffloadServer(tp, pc, cache_slots=3, max_batch=2,
                                      cache_len=32, temperature=0.8,
                                      device="cpu")
        rid = srv.submit(PROMPTS[0], max_new=6, seed=3)
        for c in companions:
            srv.submit(c, max_new=6, seed=11)
        srv.run()
        outs.append(srv.result(rid))
    assert outs[0] == outs[1]
    eng = OffloadEngine(tp, pc, cache_slots=3, device="cpu")
    assert eng.generate(PROMPTS[0], 6, temperature=0.8, seed=3) == outs[0]
