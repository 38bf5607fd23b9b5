"""The port's memory tiers (``repro_torch.core.memory_tiers`` and its
wiring through the cache, the engine and the continuous server) against
the JAX package's on the CPU, on shared weights (JAX init, bridged).

The manager's unit cases run one call sequence through both packages'
classes and must return equal results. The serving cases are the port's
copies of ``tests/test_memory_tiers.py`` (bytes conserved, the HBM
split within its budget, resume-from-host == replay == solo, the tier
stall on the clock, the trace plumbing), a grid of tiered servers held
against the JAX server (tokens, functional trace rows with
``miss_tiers``, ``TierEvent``s, ``stats()`` — every ``tier_*`` key —
and the simulated clock; the float64 gate sums are left out), and the
port's own parking: the resumed blocks are bitwise the parked snapshot,
and the parked KV is allclose to JAX's parked arrays."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.configs as pcfg
import repro_torch.core as P
from repro.configs import get_config, reduced
from repro.core.faults import FaultPlan as JFaultPlan
from repro.models import transformer as jtf
from repro.serving import ContinuousOffloadServer as JServer
from repro_torch.core.faults import FaultPlan
from repro_torch.models import transformer as ptf
from repro_torch.serving.offload_serving import ContinuousOffloadServer
from test_torch_engine import (FUNCTIONAL, MIN_MARGIN,  # noqa: F401
                               _one_torch_thread, _track_margins)

# parked K/V, port vs JAX: both packages' fp32 attention and MoE blocks
# on the same weights, summed in different orders over 3 layers
KV_TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    """The fixture of ``tests/test_memory_tiers.py``: reduced Mixtral, 3
    layers, d_model 96, 8 experts, top-2, fp32."""
    kw = dict(layers=3, d_model=96, experts=8)
    cfg = dataclasses.replace(reduced(get_config("mixtral-8x7b"), **kw),
                              dtype="float32", num_experts_per_tok=2)
    pc = dataclasses.replace(pcfg.reduced(pcfg.get_config("mixtral-8x7b"),
                                          **kw),
                             dtype="float32", num_experts_per_tok=2)
    jp = jtf.init_params(cfg, jax.random.PRNGKey(0))
    tp = ptf.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, pc, tp


# ------------------------------------------------------ the manager, unit
EB = 1000  # expert master bytes in the unit-level manager cases


def _cost(pkg):
    mb = pkg.ModelBytes(num_layers=2, d_model=8, expert_d_ff=16,
                        num_experts=4, top_k=2, expert_bytes=1000,
                        attn_bytes_per_layer=100, vocab_bytes=100,
                        kv_bytes_per_token=8)
    return pkg.CostModel(pkg.HardwareProfile.a6000_pcie4(), mb)


def _plan_respects_budget(pkg):
    slots, blocks = pkg.plan_hbm_split(
        100_000, num_layers=4, num_experts=8,
        expert_bytes=2_000, kv_block_bytes=500, expert_frac=0.5)
    assert slots * 4 * 2_000 + blocks * 500 <= 100_000
    # the fractional-slot remainder funds KV, it is not stranded
    assert blocks == (100_000 - slots * 4 * 2_000) // 500
    assert 1 <= slots <= 8
    return slots, blocks


def _plan_floors_bind(pkg):
    got = pkg.plan_hbm_split(10, num_layers=4, num_experts=8,
                             expert_bytes=2_000, kv_block_bytes=500)
    assert got == (1, 1)  # runnable, intentionally overcommitted
    return got


def _plan_caps_slots(pkg):
    slots, blocks = pkg.plan_hbm_split(
        10**9, num_layers=2, num_experts=4,
        expert_bytes=1_000, kv_block_bytes=500, expert_frac=0.9)
    assert slots == 4
    return slots, blocks


def _queue_double_buffering(pkg):
    q = pkg.SwapQueue(lanes=2)
    done = [q.submit(0.0, 1.0) for _ in range(3)]
    # both lanes busy: the third transfer waits for the earliest lane
    assert done == [1.0, 1.0, 2.0]
    pend = len(q.pending(0.5))
    drained = len(q.drain(1.0))
    assert (pend, drained, len(q.pending(1.0))) == (3, 2, 1)
    assert (q.submitted, q.completed) == (3, 2)
    return done, pend, drained, q.stats()


def _queue_single_lane(pkg):
    q = pkg.SwapQueue(lanes=1)
    done = [q.submit(0.0, 2.0) for _ in range(3)]
    assert done == [2.0, 4.0, 6.0]
    return done


def _bytes_conserved(pkg):
    tm = pkg.TieredMemoryManager(_cost(pkg), hbm_bytes=10_000,
                                 host_bytes=3 * EB)
    for i in range(5):            # 5 masters, host holds 3 -> 2 spill
        tm.register_expert((0, i), EB)
    assert tm.host_used + tm.disk_used == 5 * EB
    assert tm.expert_bytes_by_tier() == {"host": 3 * EB, "disk": 2 * EB}
    # parking KV squeezes experts out of host; totals stay conserved
    tm.park_kv(7, arrays=[], nbytes=2 * EB, n_blocks=4, pos=9)
    assert tm.host_used + tm.disk_used == 7 * EB
    assert tm.host_used <= 3 * EB
    assert tm.parked_kv_bytes() == 2 * EB and tm.is_parked(7)
    parked = tm.stats()
    arrays, pos = tm.resume_kv(7)
    assert (arrays, pos) == ([], 9)
    assert tm.host_used + tm.disk_used == 5 * EB and not tm.is_parked(7)
    s = tm.stats()
    assert s["tier_host_used_bytes"] == tm.host_used
    assert s["tier_disk_used_bytes"] == tm.disk_used
    assert s["tier_host_used_bytes"] <= s["tier_host_budget_bytes"]
    assert s["tier_kv_parks"] == 1 and s["tier_kv_resumes"] == 1
    return parked, s, tm.drain_stall()


def _drop_kv(pkg):
    tm = pkg.TieredMemoryManager(_cost(pkg), hbm_bytes=10_000)
    tm.park_kv(1, arrays=[], nbytes=500, n_blocks=1, pos=3)
    tm.drop_kv(1)
    assert tm.host_used == 0 and not tm.is_parked(1)
    return tm.stats()


def _disk_demand_vs_prefetch(pkg):
    tm = pkg.TieredMemoryManager(_cost(pkg), hbm_bytes=10_000, host_bytes=EB)
    tm.register_expert((0, 0), EB)            # host
    tm.register_expert((0, 1), EB)            # overflow -> disk
    assert tm.expert_tier((0, 1)) == "disk"
    assert tm.fetch_expert((0, 0), demand=True) == "host"
    assert tm.drain_stall() == 0.0            # host fetch: no extra stall
    assert tm.fetch_expert((0, 1), demand=True) == "disk"
    stall = tm.drain_stall()
    assert stall == pytest.approx(tm.cost.expert_fetch_extra_time("disk"))
    assert stall > 0
    # the host is full, so a new master overflows to disk; PREFETCHING
    # it rides the swap queue instead of stalling
    tm.register_expert((1, 0), EB)
    assert tm.expert_tier((1, 0)) == "disk"
    before = tm.queue.submitted
    tm.fetch_expert((1, 0), demand=False)
    assert tm.drain_stall() == 0.0
    assert tm.queue.submitted >= before + 1
    return stall, tm.stats()


def _inflight_gate(pkg):
    tm = pkg.TieredMemoryManager(_cost(pkg), hbm_bytes=10_000)
    tm.park_kv(1, arrays=[], nbytes=800, n_blocks=5, pos=4)
    assert tm.kv_inflight_blocks(0.0) == 5
    # plenty of other free blocks: the step never waits on the demote
    assert tm.note_block_claims(free_blocks_now=10, now=0.0) == 0.0
    # claiming into the in-flight region waits until the demote lands
    wait = tm.note_block_claims(free_blocks_now=2, now=0.0)
    assert wait > 0
    tm.advance(wait)
    assert tm.kv_inflight_blocks() == 0
    assert tm.note_block_claims(free_blocks_now=0) == 0.0
    return wait, tm.stats()


@pytest.mark.parametrize("case", [
    _plan_respects_budget, _plan_floors_bind, _plan_caps_slots,
    _queue_double_buffering, _queue_single_lane, _bytes_conserved,
    _drop_kv, _disk_demand_vs_prefetch, _inflight_gate,
], ids=lambda f: f.__name__.lstrip("_"))
def test_manager_matches_reference(case):
    """The reference test's call sequence and assertions, run through
    each package's classes: equal results (times, stats, byte counts)."""
    assert case(P) == case(J)


# --------------------------------------------------------- tiered servers
def _plan(cfg, *, slots, blocks, block_size):
    """(budget, tier_expert_frac) whose plan lands exactly on (slots,
    blocks): the budget is built from the planner's own prices."""
    eb = 3 * cfg.d_model * cfg.expert_d_ff * 4
    kvb = block_size * P.ModelBytes.from_config(cfg).kv_bytes_per_token \
        * cfg.num_layers
    budget = slots * cfg.num_layers * eb + blocks * kvb
    frac = slots * cfg.num_layers * eb / budget
    return budget, min(frac + 1e-9, 1 - 1e-9)


def _tiered_server(params, cfg, *, slots, blocks, block_size=8, jax_=False,
                   **kw):
    budget, frac = _plan(cfg, slots=slots, blocks=blocks,
                         block_size=block_size)
    cls, dev = (JServer, {}) if jax_ else (ContinuousOffloadServer,
                                           dict(device="cpu"))
    srv = cls(params, cfg, max_batch=2, cache_len=64, policy="lru",
              kv_block_size=block_size, hbm_budget_bytes=budget,
              tier_expert_frac=frac, **dev, **kw)
    assert srv.engine.caches[0].n_slots == slots
    assert srv.paged.num_blocks == blocks
    return srv


def _parks(srv):
    """Collect every park's per-layer snapshot (numpy) as it is filed."""
    seen = []
    park = srv.tiers.park_kv

    def wrapped(rid, arrays, *args, **kw):
        seen.append([{k: np.asarray(v) for k, v in layer.items()}
                     for layer in arrays])
        return park(rid, arrays, *args, **kw)

    srv.tiers.park_kv = wrapped
    return seen


def _tier_rows(trace):
    return [tuple(getattr(s, f) for f in FUNCTIONAL + ("miss_tiers",))
            for s in trace.steps]


P0, P1 = [1, 2, 3, 4], [9, 8, 7, 6]

GRID = {
    "resume-chunk4": dict(prefill_chunk=4),
    "replay-chunk4": dict(prefill_chunk=4, resume_from_host=False),
    "resume-chunk1-overlap": dict(overlap=True),
    "resume-tight_host-overlap": dict(prefill_chunk=4, overlap=True,
                                      host_budget="half"),
    "resume-tight_host-disk_faults": dict(
        prefill_chunk=4, host_budget="half",
        faults=dict(seed=4, disk_error_rate=0.3, dma_failure_rate=0.1,
                    max_retries=2)),
}


@pytest.mark.parametrize("name", list(GRID))
def test_tiered_server_matches_reference(setup, name):
    """An overcommitted pool (2 blocks of 8 for two 16-token requests)
    on one HBM budget in both packages. With ``host_budget="half"`` half
    the expert masters live on the simulated disk; with ``faults`` disk
    reads fail on top of that (``fetch_plan(tier=)``)."""
    cfg, jp, pc, tp = setup
    kw = dict(GRID[name])
    eb = 3 * cfg.d_model * cfg.expert_d_ff * 4
    if kw.pop("host_budget", None) == "half":
        kw["host_budget_bytes"] = 4 * cfg.num_layers * eb
    faults = kw.pop("faults", None)
    jkw = dict(kw, faults=faults and JFaultPlan(**faults))
    pkw = dict(kw, faults=faults and FaultPlan(**faults))
    jsrv = _tiered_server(jp, cfg, slots=4, blocks=2, jax_=True, **jkw)
    psrv = _tiered_server(tp, pc, slots=4, blocks=2, **pkw)
    margins = _track_margins(psrv.engine)
    parks = [_parks(jsrv), _parks(psrv)]
    for srv in (jsrv, psrv):
        for p in (P0, P1):
            srv.submit(p, max_new=12)
    assert psrv.run() == jsrv.run()
    assert psrv.kv_preemptions >= 1, "pool did not overcommit"
    assert _tier_rows(psrv.trace) == _tier_rows(jsrv.trace)
    assert [dataclasses.astuple(e) for e in psrv.trace.tier_events] == \
        [dataclasses.astuple(e) for e in jsrv.trace.tier_events]
    assert psrv.stats() == jsrv.stats()
    assert psrv.engine.sim_time == jsrv.engine.sim_time
    assert min(margins) > MIN_MARGIN, min(margins)
    s = psrv.stats()
    resume = kw.get("resume_from_host", True)
    assert (s["tier_kv_parks"] >= 1) == resume
    if "host_budget_bytes" in kw:
        assert s["tier_expert_disk_fetches"] > 0
    if faults:
        assert [dataclasses.astuple(e) for e in psrv.trace.fault_events] == \
            [dataclasses.astuple(e) for e in jsrv.trace.fault_events]
        assert s["fault_disk_errors"] > 0, s
    # the parked KV itself, park by park, layer by layer
    assert len(parks[1]) == len(parks[0]) == s["tier_kv_parks"]
    for jpark, ppark in zip(*parks):
        for jl, pl in zip(jpark, ppark):
            assert jl.keys() == pl.keys()
            for k in jl:
                assert pl[k].shape == jl[k].shape
                assert pl[k].nbytes == jl[k].nbytes
                np.testing.assert_allclose(pl[k], jl[k], rtol=KV_TOL,
                                           atol=KV_TOL)


def test_engine_with_tiers_matches_reference(setup):
    """``OffloadEngine(tiers=...)`` (no server): half the masters on the
    simulated disk, ``generate`` in both packages — tokens, trace rows
    with ``miss_tiers``, tier events, stats() and the clock."""
    cfg, jp, pc, tp = setup
    eb = 3 * cfg.d_model * cfg.expert_d_ff * 4
    engines = []
    for pkg, params, c in ((J, jp, cfg), (P, tp, pc)):
        dev = {} if pkg is J else dict(device="cpu")
        cost = pkg.OffloadEngine(params, c, cache_slots=2, **dev).cost
        tm = pkg.TieredMemoryManager(cost, hbm_bytes=1 << 30,
                                     host_bytes=4 * c.num_layers * eb)
        eng = pkg.OffloadEngine(params, c, cache_slots=2, policy="lru",
                                prefetch="spec", tiers=tm, **dev)
        engines.append((eng, eng.generate([1, 2, 3, 4, 5], 8)))
    (jeng, jtoks), (peng, ptoks) = engines
    assert ptoks == jtoks
    assert _tier_rows(peng.trace) == _tier_rows(jeng.trace)
    assert [dataclasses.astuple(e) for e in peng.trace.tier_events] == \
        [dataclasses.astuple(e) for e in jeng.trace.tier_events]
    assert peng.stats() == jeng.stats()
    assert peng.sim_time == jeng.sim_time
    assert peng.stats()["tier_expert_disk_fetches"] > 0


# ---------------------------------------- the reference's tests, port side
def test_hbm_occupancy_sums_to_budget(setup):
    _, _, pc, tp = setup
    srv = _tiered_server(tp, pc, slots=4, blocks=8)
    s = srv.stats()
    assert s["tier_hbm_expert_bytes"] == \
        sum(c.device_nbytes() for c in srv.engine.caches)
    assert s["tier_hbm_kv_bytes"] == \
        srv.engine.cost.kv_block_bytes(srv.kv_block_size) \
        * srv.paged.num_blocks
    assert s["tier_hbm_expert_bytes"] + s["tier_hbm_kv_bytes"] \
        <= s["tier_hbm_budget_bytes"]


def test_resume_from_host_bit_exact_with_replay_and_solo(setup):
    """Overcommitted pool, two requests: the preempted one resumes from
    host-tier KV. Tokens must equal BOTH the replay-as-prefill run and
    the uncontended solo runs, and resuming must drain in fewer steps
    than replaying."""
    _, _, pc, tp = setup
    solo = [P.OffloadEngine(tp, pc, cache_slots=4, policy="lru",
                            device="cpu").generate(p, 12) for p in (P0, P1)]
    outs, steps, parks = {}, {}, {}
    for mode in (True, False):
        srv = _tiered_server(tp, pc, slots=4, blocks=2,
                             resume_from_host=mode, prefill_chunk=4)
        r0 = srv.submit(P0, max_new=12)
        r1 = srv.submit(P1, max_new=12)
        outs[mode] = [srv.run()[r] for r in (r0, r1)]
        steps[mode] = srv.step_count
        parks[mode] = srv.stats()["tier_kv_parks"]
        assert srv.kv_preemptions >= 1, "pool did not overcommit"
    assert outs[True] == outs[False] == solo
    assert parks[True] >= 1 and parks[False] == 0
    assert steps[True] < steps[False], \
        "resume-from-host must beat replay-as-prefill on steps-to-drain"


def test_parked_resume_is_bit_exact_with_uncontended_run(setup):
    _, _, pc, tp = setup
    big = _tiered_server(tp, pc, slots=4, blocks=16)
    rids = [big.submit(p, max_new=12) for p in (P0, P1)]
    ref = [big.run()[r] for r in rids]
    assert big.kv_preemptions == 0
    small = _tiered_server(tp, pc, slots=4, blocks=2, prefill_chunk=4)
    rids = [small.submit(p, max_new=12) for p in (P0, P1)]
    out = [small.run()[r] for r in rids]
    assert small.stats()["tier_kv_resumes"] >= 1
    assert out == ref


def test_resumed_blocks_are_the_parked_snapshot(setup):
    """Right after each resume the request's new blocks hold, bit for
    bit, the snapshot its park took (the pool's rows are copied, not
    recomputed), and the snapshot's bytes are what the tier counted."""
    _, _, pc, tp = setup
    srv = _tiered_server(tp, pc, slots=4, blocks=2, prefill_chunk=4)
    parked = {}
    checked = []
    park, restore = srv.tiers.park_kv, srv._restore_kv

    def on_park(rid, arrays, nbytes, *args, **kw):
        parked[rid] = [{k: v.clone() for k, v in layer.items()}
                       for layer in arrays]
        assert nbytes == sum(v.numel() * v.element_size()
                             for layer in arrays for v in layer.values())
        return park(rid, arrays, nbytes, *args, **kw)

    def on_restore(req):
        restore(req)
        snap = parked.pop(req.rid)
        blocks = srv.paged.tables[req.rid][:len(snap[0]["k"])]
        for layer, saved in zip(srv.state["layers"], snap):
            for k, v in saved.items():
                assert torch.equal(layer[k][blocks], v)
        checked.append(req.rid)

    srv.tiers.park_kv, srv._restore_kv = on_park, on_restore
    for p in (P0, P1):
        srv.submit(p, max_new=12)
    srv.run()
    s = srv.stats()
    assert checked and not parked
    assert len(checked) == s["tier_kv_resumes"] == s["tier_kv_parks"]


def test_tier_stall_advances_engine_clock(setup):
    """Disk demand fetches are not free: the tiered run's clock exceeds
    an identically-shaped run that never leaves the host tier by
    exactly the tier stall."""
    _, _, pc, tp = setup
    eb = 3 * pc.d_model * pc.expert_d_ff * 4

    def run(host_budget):
        srv = _tiered_server(tp, pc, slots=2, blocks=8,
                             host_budget_bytes=host_budget)
        srv.submit([1, 2, 3, 4, 5], max_new=10)
        srv.run()
        return srv.stats()

    tight = run(host_budget=4 * pc.num_layers * eb)   # half the masters
    roomy = run(host_budget=None)
    assert roomy["tier_expert_disk_fetches"] == 0
    assert tight["tier_expert_disk_fetches"] > 0
    assert tight["tier_stall_s"] > 0
    assert tight["sim_time_s"] > roomy["sim_time_s"]
    assert tight["sim_time_s"] == pytest.approx(
        roomy["sim_time_s"] + tight["tier_stall_s"])


def test_tiered_run_matches_untiered_tokens(setup):
    _, _, pc, tp = setup
    tiered = _tiered_server(tp, pc, slots=4, blocks=8)
    plain = ContinuousOffloadServer(
        tp, pc, max_batch=2, cache_len=64, policy="lru", kv_block_size=8,
        cache_slots=4, kv_num_blocks=8, device="cpu")
    outs = []
    for srv in (tiered, plain):
        rids = [srv.submit(p, max_new=8) for p in ([1, 2, 3], [7, 6, 5, 4])]
        out = srv.run()
        outs.append([out[r] for r in rids])
    assert outs[0] == outs[1]


def test_trace_json_roundtrip_with_tier_events(setup):
    _, _, pc, tp = setup
    srv = _tiered_server(tp, pc, slots=4, blocks=2, prefill_chunk=4)
    for p in (P0, P1):
        srv.submit(p, max_new=10)
    srv.run()
    assert srv.trace.tier_events, "overcommit must emit tier events"
    blob = srv.trace.to_json()
    assert isinstance(json.loads(blob), dict)       # the two-part shape
    back = P.TraceRecorder.from_json(blob)
    assert back.tier_events == srv.trace.tier_events
    assert len(back.steps) == len(srv.trace.steps)
    assert back.tier_transfer_stats() == srv.trace.tier_transfer_stats()
    assert any(k.startswith("kv:hbm->") for k in back.tier_transfer_stats())


def test_trace_json_stays_legacy_without_tiers(setup):
    _, _, pc, tp = setup
    srv = ContinuousOffloadServer(tp, pc, cache_slots=4, policy="lru",
                                  max_batch=1, cache_len=32, device="cpu")
    srv.submit([1, 2, 3], max_new=4)
    srv.run()
    data = json.loads(srv.trace.to_json())
    assert isinstance(data, list)                   # the legacy shape
    assert all(s.miss_tiers == () for s in srv.trace.steps)
    assert P.TraceRecorder.from_json(srv.trace.to_json()).steps == \
        srv.trace.steps


def test_miss_tier_counts_sees_disk(setup):
    _, _, pc, tp = setup
    eb = 3 * pc.d_model * pc.expert_d_ff * 4
    srv = _tiered_server(tp, pc, slots=2, blocks=8,
                         host_budget_bytes=4 * pc.num_layers * eb)
    srv.submit([1, 2, 3, 4, 5], max_new=10)
    srv.run()
    counts = srv.trace.miss_tier_counts()
    assert counts.get("disk", 0) > 0 and counts.get("host", 0) > 0
    assert sum(counts.values()) == sum(len(s.misses) for s in srv.trace.steps)


def test_terminated_parked_request_drops_its_kv(setup):
    """A parked request that times out in the queue releases its host
    snapshot (``drop_kv``), and the server still drains."""
    _, _, pc, tp = setup
    srv = _tiered_server(tp, pc, slots=4, blocks=2, prefill_chunk=4)
    srv.submit(P0, max_new=12)
    r1 = srv.submit(P1, max_new=12, deadline_steps=14)
    while srv.pending and not srv.tiers.is_parked(r1):
        srv.step()
    assert srv.tiers.is_parked(r1), "the second request was never parked"
    srv.run()
    s = srv.stats()
    assert srv.finished[r1].status == "timeout"
    assert s["tier_parked_requests"] == 0 and s["tier_parked_kv_bytes"] == 0
    assert s["tier_host_used_bytes"] == s["tier_host_expert_bytes"]


def test_admission_subtracts_inflight_blocks(setup):
    """Blocks whose park-demotion is still in flight on the simulated
    clock are not free to a joining request while others run: the same
    deferral in both packages."""
    cfg, jp, pc, tp = setup
    got = []
    for params, c, jax_ in ((jp, cfg, True), (tp, pc, False)):
        srv = _tiered_server(params, c, slots=4, blocks=4, jax_=jax_)
        srv.submit(P0, max_new=4)
        srv.step()                        # one request, one block
        # a 2-block demotion that has not landed yet
        srv.tiers.park_kv(99, [], 1 << 20, n_blocks=2, pos=16)
        srv.submit(list(range(1, 13)), max_new=1)   # needs 2 blocks
        srv._admit()
        got.append((srv.num_active, srv.kv_deferred_admissions,
                    srv.tiers.kv_inflight_blocks(srv.engine.sim_time)))
    assert got[1] == got[0] == (1, 1, 2)
