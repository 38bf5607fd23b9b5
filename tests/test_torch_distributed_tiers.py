"""The offload server on every mesh the JAX package's engine takes: memory
tiers under a mesh and the decode rows split over a data axis, on 8 CPU
processes under gloo, against the JAX package's unsharded runs on the
same weights.

* The tiered server grid of ``tests/test_torch_tiers.py`` (``GRID``: an
  overcommitted pool of 2 blocks of 8 for two 16-token requests on one
  HBM budget; resume and replay, overlap, half the expert masters on the
  simulated disk, disk and DMA faults) on a (1, 8) mesh and on a (2, 4)
  mesh whose batch rule splits the rows over "data": tokens, trace rows
  with ``miss_tiers``, tier and fault events, ``stats()`` (the HBM plan's
  ``tier_hbm_*`` bytes too), the clock and the arbiter's bytes of each
  park equal the JAX server's, and each rank's parked snapshot holds the
  JAX park's K/V for the rank's KV heads within ``KV_TOL``.
* The servers of ``tests/test_torch_distributed_serving.py`` on the (2, 4)
  mesh with the batch rule on "data" (dense, paged with preemption and
  replay, chunked prefill with overlap, reduced DeepSeek-V2 with MLA and
  shared experts): equal to JAX's, the smallest router margin above
  1e-4. Steps whose rows divide over "data" split them (the paged and
  dense per-token servers, 8-row chunked steps); steps whose rows do not
  run whole on every rank (``generate``'s one row, a chunked server's
  5-row steps).
* Every rank equals rank 0 (the last logits bitwise).
* JAX alone: the reference's tiered server under a (2, 4) mesh of 8 host
  devices with ``AxisType.Auto`` axes equals its unsharded run (tokens,
  ``stats()``), in a subprocess of its own.

One set of 8 ranks runs every case.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core.faults import FaultPlan as JFaultPlan
from repro.serving import ContinuousOffloadServer as JServer
from test_torch_distributed import (MIN_MARGIN, ROOT, RULES, collect_ranks,
                                    start_ranks)
from test_torch_distributed_serving import (  # noqa: F401
    DEEPSEEK, ENGINES, MIXTRAL, NEW, PROMPTS, SERVER, Model,
    _one_torch_thread, jax_engine)
from test_torch_tiers import GRID, KV_TOL, P0, P1, _plan

# (1, 8): one data rank (the batch rule names an axis of one rank); (2,
# 4): the rows split over "data", the heads over "model"
MESHES = {"1x8": dict(mesh=[1, 8], rules=dict(RULES, _data_size=1)),
          "2x4": dict(rules=RULES)}
TIER_NEW = 12
# the servers of the serving file, and a chunked server whose 5-row steps
# do not divide over the 2 data ranks
SERVERS = dict(ENGINES, mixtral_chunked_whole=(
    "mixtral", dict(server=dict(SERVER, prefill_chunk=4, step_tokens=5,
                                overlap=True))))
# the servers whose steps split their rows over "data" (the others run
# every step whole: one row, or 5)
SPLIT = {"mixtral_paged", "mixtral_dense", "mixtral_chunked",
         "deepseek_paged"}


def _server_kw(cfg, kw):
    """The grid case ``kw`` as the server's kwargs (the budget whose plan
    lands on 4 slots and 2 blocks of 8) and its ``FaultPlan`` fields."""
    kw = dict(kw)
    eb = 3 * cfg.d_model * cfg.expert_d_ff * 4
    if kw.pop("host_budget", None) == "half":
        kw["host_budget_bytes"] = 4 * cfg.num_layers * eb
    faults = kw.pop("faults", None)
    budget, frac = _plan(cfg, slots=4, blocks=2, block_size=8)
    return dict(max_batch=2, cache_len=64, policy="lru", kv_block_size=8,
                hbm_budget_bytes=budget, tier_expert_frac=frac, **kw), faults


def jax_tiered(m, name):
    """JAX's unsharded tiered server on the grid case: tokens, rows, tier
    and fault events, stats, clock, each park's bytes and arrays."""
    kw, faults = _server_kw(m.cfg, GRID[name])
    srv = JServer(m.jp, m.jcfg, faults=faults and JFaultPlan(**faults),
                  **kw)
    assert srv.engine.caches[0].n_slots == 4 and srv.paged.num_blocks == 2
    parks = []
    park = srv.tiers.park_kv

    def parked(rid, arrays, nbytes, *args, **kw):
        parks.append((nbytes, [{k: np.asarray(v) for k, v in layer.items()}
                               for layer in arrays]))
        return park(rid, arrays, nbytes, *args, **kw)

    srv.tiers.park_kv = parked
    for p in (P0, P1):
        srv.submit(p, max_new=TIER_NEW)
    tokens = srv.run()
    trace = srv.trace
    return {"tokens": tokens,
            "rows": [tuple(tuple(int(e) for e in getattr(s, f)) for f in
                           ("activated", "hits", "misses", "evicted",
                            "spec_guess", "prefetched"))
                     + (tuple(s.miss_tiers),) for s in trace.steps],
            "tier_events": [dataclasses.astuple(e)
                            for e in trace.tier_events],
            "fault_events": [dataclasses.astuple(e)
                             for e in trace.fault_events],
            "stats": srv.stats(), "sim_time": srv.engine.sim_time,
            "park_bytes": [n for n, _ in parks],
            "snapshots": [layers for _, layers in parks]}


JAX_ON_A_MESH = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax
    from repro.configs import get_config, reduced
    from repro.models import transformer as jtf
    from repro.models.sharding import sharding_ctx
    from repro.serving import ContinuousOffloadServer
    arch, reduce, replace, kw, rules, prompts, new = json.loads(sys.argv[1])
    rules = {k: tuple(v) if isinstance(v, list) else v
             for k, v in rules.items()}
    cfg = dataclasses.replace(reduced(get_config(arch), **reduce), **replace)
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)

    def run():
        srv = ContinuousOffloadServer(params, cfg, **kw)
        for p in prompts:
            srv.submit(p, max_new=new)
        return srv.run(), srv.stats()

    plain = run()
    with sharding_ctx(mesh, rules):
        sharded = run()
    print(json.dumps({"devices": len(jax.devices()),
                      "tokens": [plain[0] == sharded[0],
                                 {str(k): v for k, v in plain[0].items()}],
                      "stats": plain[1] == sharded[1],
                      "kv_parks": plain[1]["tier_kv_parks"],
                      "differ": sorted(k for k in plain[1]
                                       if plain[1][k] != sharded[1][k])}))
""")


def _jax_on_a_mesh(m):
    """Start the JAX-only subprocess: the grid's first case, unsharded and
    under the (2, 4) Auto mesh."""
    kw, _ = _server_kw(m.cfg, GRID["resume-chunk4"])
    arg = json.dumps([m.arch, m.reduce, m.replace, kw, RULES, [P0, P1],
                      TIER_NEW])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, "-c", JAX_ON_A_MESH, arg],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Every case's ranks' outputs (one set of 8 ranks, started before the
    JAX references are computed here), the references and the JAX mesh
    subprocess's report."""
    models = {"mixtral": Model(*MIXTRAL, 50), "deepseek": Model(*DEEPSEEK,
                                                                51)}
    m = models["mixtral"]
    parts, inputs = {}, {}
    for name in GRID:
        kw, faults = _server_kw(m.cfg, GRID[name])
        for mesh, mkw in MESHES.items():
            parts[f"{name}/{mesh}"] = m.part(
                "tiers", server=kw, faults=faults, prompts=[P0, P1],
                new=TIER_NEW, **mkw)
            inputs[f"{name}/{mesh}"] = {"params": m.tp}
    for name, (model, kw) in SERVERS.items():
        mm = models[model]
        kw = dict(kw, new=NEW + 2) if "prompt" in kw else \
            dict(kw, prompts=PROMPTS, new=NEW)
        parts[name] = mm.part("engine", rules=RULES, **kw)
        inputs[name] = {"params": mm.tp}
    started = start_ranks(tmp_path_factory.mktemp("tiers"),
                          dict(kind="parts", parts=parts), inputs)
    jax_mesh = _jax_on_a_mesh(m)
    tiered = {name: jax_tiered(m, name) for name in GRID}
    engines = {name: jax_engine(models[model], kw)
               for name, (model, kw) in SERVERS.items()}
    outs = collect_ranks(started)
    out, err = jax_mesh.communicate(timeout=240)
    assert jax_mesh.returncode == 0, err[-3000:]
    return models, outs, tiered, engines, json.loads(out.splitlines()[-1])


def _agree(outs, name, own=()):
    """Every rank's outputs of part ``name`` equal rank 0's (tensors
    bitwise), but the keys ``own`` (each rank's own); returns rank 0's."""
    def same(a, b):
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(map(same, a, b))
        return a == b
    for r, o in enumerate(outs[1:], 1):
        for k in o[name]:
            if k not in own:
                assert same(o[name][k], outs[0][name][k]), (r, name, k)
    return outs[0][name]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", list(GRID))
def test_tiered_server_under_the_mesh_matches_jax(served, name, mesh):
    """The tiered server built and run inside the mesh == JAX's unsharded
    one: tokens, trace rows with ``miss_tiers``, tier and fault events,
    ``stats()``, the clock and each park's bytes exactly; each rank's
    parked snapshot within KV_TOL of the JAX park's K/V for the rank's KV
    heads; the rows split over "data" on (2, 4) at every MoE call."""
    models, outs, tiered, _, _ = served
    o = _agree(outs, f"{name}/{mesh}", own=("snapshots", "kv_heads"))
    want = tiered[name]
    assert o["tokens"] == want["tokens"]
    assert o["rows"] == want["rows"]
    assert o["tier_events"] == want["tier_events"]
    assert o["fault_events"] == want["fault_events"]
    assert o["stats"] == want["stats"]
    assert o["sim_time"] == want["sim_time"]
    assert o["park_bytes"] == want["park_bytes"]
    assert o["margin"] > MIN_MARGIN, o["margin"]
    assert set(o["splits"]) == {mesh == "2x4"}
    s = o["stats"]
    assert s["kv_preemptions"] >= 1, "pool did not overcommit"
    assert (s["tier_kv_parks"] >= 1) == GRID[name].get("resume_from_host",
                                                       True)
    if "faults" in GRID[name]:
        assert s["fault_disk_errors"] > 0, s
    cfg = models["mixtral"].cfg
    for r, rank in enumerate(outs):
        got = rank[f"{name}/{mesh}"]
        heads = got["kv_heads"]
        assert heads == [(r % 8 if mesh == "1x8" else 2 * (r % 4))
                         * cfg.num_kv_heads // cfg.num_heads]
        assert len(got["snapshots"]) == len(want["snapshots"])
        for ppark, jpark in zip(got["snapshots"], want["snapshots"]):
            for pl, jl in zip(ppark, jpark):
                assert pl.keys() == jl.keys()
                for k in jl:
                    np.testing.assert_allclose(
                        pl[k].numpy(), jl[k][:, :, heads], rtol=KV_TOL,
                        atol=KV_TOL)


@pytest.mark.parametrize("name", list(SERVERS))
def test_server_with_a_data_axis_matches_jax(served, name):
    """The servers of the (1, 8) serving cases on the (2, 4) mesh with the
    batch rule on "data" == JAX's: tokens, functional trace rows,
    ``stats()`` and ``sim_time`` exactly, every rank equal (the last
    logits bitwise), the smallest router margin above 1e-4; the rows
    split over "data" at every MoE call where the step's rows divide
    over it, and whole where they do not; ``paged_attention`` once a
    layer a step on the paged GQA servers, on the rank's rows and its
    pool of one KV head."""
    models, outs, _, engines, _ = served
    o = _agree(outs, name)
    toks, rows, stats, sim_time, srv_stats = engines[name]
    model, kw = SERVERS[name]
    c = models[model].cfg
    assert o["tokens"] == toks
    assert o["rows"] == rows
    assert o["stats"] == stats
    assert o["sim_time"] == sim_time
    if srv_stats is not None:
        assert o["server_stats"] == srv_stats
    assert o["margin"] > MIN_MARGIN, o["margin"]
    assert set(o["splits"]) == {name in SPLIT}
    assert o["expert_shape"] == (c.num_layers, c.num_experts, c.d_model,
                                 c.expert_d_ff)
    assert o["attn_shape"][2] == 2       # 8 heads, 2 a model rank
    steps, L = stats["decode_steps"], c.num_layers
    assert o["launches"]["moe_ffn"] >= steps * L
    paged = "server" in kw and kw["server"].get("kv_layout") != "dense"
    assert o["launches"]["paged_attention"] == (
        steps * L if paged and not c.use_mla else 0)
    if paged and not c.use_mla:
        assert o["pool_shape"][2] == 1
    if name == "mixtral_paged":
        assert srv_stats["kv_preemptions"] > 0


def test_jax_tiered_server_on_an_auto_mesh(served):
    """The reference itself: its tiered server under a (2, 4) mesh of 8
    host devices with Auto axes (the rows constrained over "data", the
    heads over "model") gives its unsharded run's tokens and
    ``stats()``, with a KV park."""
    report = served[-1]
    assert report["devices"] == 8
    assert report["tokens"][0], report
    assert report["stats"], report["differ"]
    assert report["kv_parks"] >= 1
