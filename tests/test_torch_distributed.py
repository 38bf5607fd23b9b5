"""The port's distributed paths on a (data 2, model 4) mesh of 8 CPU
processes under gloo, against the unsharded functions.

The checks of ``tests/test_distributed.py`` (the JAX package's), at its
limits:

* expert-parallel MoE (``moe_ep_shardmap``: two ``all_to_all_single``
  exchanges on the model axis) == ``moe_dense`` at capacity factor 8;
* head-padded tensor-parallel prefill (6 heads and 6 KV heads of
  head_dim 20, padded to 8) == the unsharded ``prefill``;
* sequence-sharded MLA decode == the unsharded ``decode_step``.

Each is held against the port's unsharded function, and that function
against the JAX package's on the same weights (JAX ``init_params``,
bridged). Besides: EP with drops (capacity factor 1) against the JAX
package's own ``moe_ep_shardmap`` on 8 forced host devices (kept and
dropped slots equal, ``y`` and aux within 2e-4), the other MoE paths
with the experts split over the model axis and over their ff dim, and a
GQA model whose 2 KV heads do not split over 4 (sequence-sharded ring
cache, tied embeddings), and the rules of ``sharding_rules(...,
baseline=True)`` (unpadded heads, whole MLA latent cache, no EP for
``moe_apply``'s ``auto``).

Each check starts 8 ranks (``tests/_torch_dist_ranks.py``) through a
``file://`` store in ``tmp_path``, each rank with its own time limit;
the model checks also cut the whole params with ``shard_params`` and
gather every leaf back over the ranks (``gather_tree``): bitwise the
whole tree.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import moe as jmoe
from repro.models import transformer as jtf
import repro_torch.configs as pcfg
from repro_torch.launch import mesh as pmesh
from repro_torch.models import moe as pmoe
from repro_torch.models import transformer as ptf

ROOT = Path(__file__).resolve().parents[1]
MESH = (2, 4)
WORLD = MESH[0] * MESH[1]
RANK_TIMEOUT_S = 240
MIN_MARGIN = 1e-4
# the rules of tests/test_distributed.py
RULES = {"batch": ["data"], "model": "model", "heads": "model",
         "vocab": "model", "experts": "model", "capacity": "data",
         "shard_kv": True, "experts_mode": "ep", "_data_size": 2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, reduce, replace):
    """The same config in both packages."""
    j = dataclasses.replace(reduced(get_config(arch), **reduce), **replace)
    p = dataclasses.replace(pcfg.reduced(pcfg.get_config(arch), **reduce),
                            **replace)
    assert dataclasses.asdict(j) == dataclasses.asdict(p)
    return j, p


def _bridge(tree):
    return ptf.from_jax_params(jax.tree.map(np.asarray, tree), device="cpu")


def start_ranks(tmp_path, case, inputs, mesh=MESH):
    """Start the ranks of ``mesh`` (WORLD of MESH by default) on ``case``
    and return at once; ``collect_ranks`` waits for them."""
    world = int(np.prod(mesh))
    torch.save(inputs, tmp_path / "inputs.pt")
    case = dict(case, mesh=list(mesh), store=f"file://{tmp_path}/store",
                inputs=str(tmp_path / "inputs.pt"))
    (tmp_path / "case.json").write_text(json.dumps(case))
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_dist_ranks.py"),
         str(tmp_path / "case.json"), str(r), str(world)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    return tmp_path, case, procs


def collect_ranks(started):
    """Every rank's outputs of ``start_ranks``' run, after checking that
    every rank returned the same whole outputs."""
    tmp_path, case, procs = started
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    bad = [(r, p.returncode, log[-3000:])
           for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    assert not bad, bad
    outs = [torch.load(tmp_path / f"out-{r}.pt", weights_only=True)
            for r in range(len(procs))]
    for part in case.get("parts") or [None]:
        _same_on_every_rank([o if part is None else o[part] for o in outs])
    return outs


def run_ranks(tmp_path, case, inputs, mesh=MESH):
    """Start the ranks on ``case`` and wait for them: every rank's
    outputs, checked to agree."""
    return collect_ranks(start_ranks(tmp_path, case, inputs, mesh))


def _same_on_every_rank(outs):
    """Every rank's whole outputs equal rank 0's; ``shard_params`` then
    ``gather_tree`` gave back the whole tree, which rules with a model
    axis split and rules without one (pure data parallel) left whole."""
    for o in outs:
        if "roundtrip" in o:
            assert (o["split_leaves"] > 0) == (o.get("model_axis", "model")
                                               is not None)
            assert [p for p, same in o["roundtrip"] if not same] == []
    whole = ("prefill", "forward", "decode", "encoder")
    for r, o in enumerate(outs[1:], 1):
        for k in whole + ("ep/ep", "auto"):
            if k in o:
                a, b = (o[k], outs[0][k]) if k in whole else \
                    (o[k][0], outs[0][k][0])
                assert torch.equal(a, b), (r, k)


def held(name, got, want, tol):
    """assert_allclose at ``tol`` (rtol = atol), printing the max
    difference."""
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.max(np.abs(got - want)))
    print(f"{name}: max |diff| {err:.3e} (limit {tol:g} + {tol:g} x |want|)")
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def min_margin(x, router, k):
    logits = np.sort(x.reshape(-1, x.shape[-1]) @ router, axis=-1)[:, ::-1]
    return float((logits[:, k - 1] - logits[:, k]).min())


def _moe_case(cf, S):
    jcfg, pc = _cfgs("mixtral-8x7b", dict(layers=2, d_model=64, experts=8),
                     dict(dtype="float32", num_experts_per_tok=2,
                          capacity_factor=cf))
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
    x = np.random.default_rng(1).normal(size=(4, S, 64)).astype(np.float32)
    margin = min_margin(x, np.asarray(jp["router"]), 2)
    assert margin > MIN_MARGIN, margin
    case = dict(kind="moe", arch="mixtral-8x7b", cf=cf, rules=RULES,
                reduce=dict(layers=2, d_model=64, experts=8),
                replace=dict(dtype="float32", num_experts_per_tok=2,
                             capacity_factor=cf))
    return jcfg, pc, jp, x, case


# ------------------------------------------------- 1. EP MoE == dense
def test_ep_moe_matches_dense(tmp_path):
    """EP at capacity factor 8 (nothing drops) == ``moe_dense``; the
    other paths, with the experts split over the model axis ("ep") and
    over their ff dim ("tp"), == their unsharded selves."""
    jcfg, pc, jp, x, case = _moe_case(8.0, 16)
    want_j, aux_j = jmoe.moe_dense(jp, jcfg, jnp.asarray(x))
    tp, tx = _bridge(jp), torch.from_numpy(x)
    want, aux = pmoe.moe_dense(tp, pc, tx)
    held("port moe_dense vs JAX", want, want_j, 2e-4)
    held("port moe_dense aux vs JAX", aux, aux_j, 2e-4)
    out = run_ranks(tmp_path, case, {"params": tp, "x": tx})[0]
    held("EP (2x4) vs moe_dense", out["ep/ep"][0], want, 2e-4)
    unsharded = {"capacity": pmoe.moe_capacity(tp, pc, tx,
                                               capacity_factor=8.0),
                 "dense": (want, aux), "gather": pmoe.moe_gather(tp, pc, tx)}
    for mode in ("ep", "tp"):
        for name, (y, a) in unsharded.items():
            held(f"{mode}-split {name} (2x4) vs unsharded",
                 out[f"{mode}/{name}"][0], y, 2e-4)
            held(f"{mode}-split {name} aux", out[f"{mode}/{name}"][1], a,
                 2e-4)


# -------------------------------------- 1b. EP with drops == JAX's EP
JAX_EP = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.configs import get_config, reduced
    from repro.models import moe
    from repro.models.sharding import sharding_ctx

    inp = np.load(sys.argv[1])
    cfg = dataclasses.replace(
        reduced(get_config("mixtral-8x7b"), layers=2, d_model=64,
                experts=8),
        dtype="float32", num_experts_per_tok=2, capacity_factor=1.0)
    p = {"router": jnp.asarray(inp["router"]),
         "experts": {n: jnp.asarray(inp[n]) for n in ("w1", "w3", "w2")}}
    x = jnp.asarray(inp["x"])
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    rules = {"batch": ("data",), "model": "model", "heads": "model",
             "vocab": "model", "experts": "model", "capacity": "data",
             "shard_kv": True, "experts_mode": "ep", "_data_size": 2}
    with sharding_ctx(mesh, rules):
        y, aux = jax.jit(lambda p_, x_: moe.moe_ep_shardmap(
            p_, cfg, x_, capacity_factor=1.0))(p, x)
    # each (data, model) shard's own dispatch, by the JAX package's
    # _dispatch_local, in the mesh's row-major rank order
    B, S, d = x.shape
    Bl, Sl = B // 2, S // 4
    C = max(int(np.ceil(Bl * Sl * 2 * 1.0 / 8)), 8)
    C = -(-C // 8) * 8
    keeps, slots = [], []
    for i in range(2):
        for j in range(4):
            xf = x[i * Bl:(i + 1) * Bl, j * Sl:(j + 1) * Sl].reshape(-1, d)
            _, probs, ids = moe.router_probs(p, cfg, xf)
            _, slot, keep, _ = moe._dispatch_local(cfg, xf, probs, ids, C)
            keeps.append(np.asarray(keep))
            slots.append(np.asarray(slot))
    np.savez(sys.argv[2], y=np.asarray(y), aux=np.asarray(aux),
             keep=np.stack(keeps), slot=np.stack(slots))
""")


def test_ep_moe_with_drops_matches_jax_shardmap(tmp_path):
    """Capacity factor 1 on 32 tokens a rank: slots drop. The port's
    ranks keep and drop the slots that JAX's ``moe_ep_shardmap`` shards
    do, and ``y`` and aux agree within 2e-4."""
    jcfg, pc, jp, x, case = _moe_case(1.0, 64)
    np.savez(tmp_path / "ep_in.npz", x=x, router=np.asarray(jp["router"]),
             **{n: np.asarray(w) for n, w in jp["experts"].items()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", JAX_EP,
                        str(tmp_path / "ep_in.npz"),
                        str(tmp_path / "ep_out.npz")],
                       env=env, capture_output=True, text=True,
                       timeout=RANK_TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-3000:]
    want = np.load(tmp_path / "ep_out.npz")
    assert not want["keep"].all()          # the check needs drops
    outs = run_ranks(tmp_path, case, {"params": _bridge(jp),
                                      "x": torch.from_numpy(x)})
    keep = np.stack([o["keep"].numpy() for o in outs])
    slot = np.stack([o["slot"].numpy() for o in outs])
    print(f"dropped slots: {int((~keep).sum())} of {keep.size}")
    np.testing.assert_array_equal(keep, want["keep"])
    np.testing.assert_array_equal(slot, want["slot"])
    held("EP with drops vs JAX moe_ep_shardmap", outs[0]["ep/ep"][0],
         want["y"], 2e-4)
    held("EP aux vs JAX", outs[0]["ep/ep"][1], want["aux"], 2e-4)


# -------------------------- 2. head-padded tensor-parallel prefill
def test_head_padded_prefill_matches_unsharded(tmp_path):
    """6 heads and 6 KV heads of head_dim 20 on a model axis of 4: padded
    to 8, 2 a rank; prefill and forward == unsharded; then decode over
    head-split (padded) caches == the unsharded decode."""
    reduce = dict(layers=2, d_model=120, vocab=128)
    replace = dict(dtype="float32", num_heads=6, num_kv_heads=6,
                   head_dim=20)
    jcfg, pc = _cfgs("qwen1.5-32b", reduce, replace)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(2))
    toks = np.random.default_rng(3).integers(0, 128, (4, 16))
    steps = np.random.default_rng(4).integers(0, 128, (4, 6))
    tp, tt = _bridge(jp), torch.from_numpy(toks)
    want = ptf.prefill(tp, pc, tt)
    held("port prefill vs JAX", want,
         jtf.prefill(jp, jcfg, jnp.asarray(toks)), 2e-4)
    dec = _decode(tp, pc, steps, cache_len=8)
    out = run_ranks(tmp_path, dict(kind="model", arch="qwen1.5-32b",
                                   reduce=reduce, replace=replace,
                                   rules=RULES, cache_len=8),
                    {"params": tp, "tokens": tt,
                     "steps": torch.from_numpy(steps)})[0]
    held("padded TP prefill (2x4) vs unsharded", out["prefill"], want, 2e-3)
    held("padded TP forward", out["forward"], ptf.forward(tp, pc, tt)[0],
         2e-3)
    # [B/2, L, 8 padded KV heads / 4, hd]
    assert out["state_shapes"] == [(2, 8, 2, 20)] * 2
    held("head-split decode (2x4) vs unsharded", out["decode"], dec, 2e-3)


def _decode(params, cfg, steps, cache_len, window=None):
    state = ptf.init_decode_state(params, cfg, steps.shape[0], cache_len,
                                  device="cpu")
    out = []
    for pos in range(steps.shape[1]):
        lg, state = ptf.decode_step(params, cfg, state,
                                    torch.from_numpy(steps[:, pos:pos + 1]),
                                    pos, window=window)
        out.append(lg)
    return torch.stack(out)


# --------------------------- 3. sequence-sharded MLA decode
def test_seq_sharded_mla_decode_matches_unsharded(tmp_path):
    """DeepSeek-V2 reduced (4 heads, latent 64, rope key 32, 4 experts):
    the latent and rope-key caches split over the model axis, 2 slots a
    rank; 8 decode steps fill the cache. == the unsharded decode, which
    == the JAX package's."""
    reduce = dict(layers=2, d_model=64)
    jcfg, pc = _cfgs("deepseek-v2-236b", reduce, dict(dtype="float32"))
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(4))
    steps = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 8))
    tp = _bridge(jp)
    dec = _decode(tp, pc, steps, cache_len=8)
    state = jtf.init_decode_state(jp, jcfg, 2, 8)
    for pos in range(steps.shape[1]):
        lg, state = jtf.decode_step(jp, jcfg, state,
                                    jnp.asarray(steps[:, pos:pos + 1]),
                                    jnp.int32(pos))
        held(f"port decode step {pos} vs JAX", dec[pos], lg, 2e-4)
    out = run_ranks(tmp_path, dict(kind="model", arch="deepseek-v2-236b",
                                   reduce=reduce,
                                   replace=dict(dtype="float32"),
                                   rules=RULES, cache_len=8),
                    {"params": tp, "steps": torch.from_numpy(steps)})[0]
    assert out["state_shapes"] == [(1, 2, 64), (1, 2, 32)]
    held("seq-sharded MLA decode (2x4) vs unsharded", out["decode"], dec,
         2e-3)


# ------------- GQA whose KV heads do not split: sequence-sharded ring
def test_gqa_ring_decode_with_unsplit_kv_heads(tmp_path):
    """Qwen2.5-3B reduced: 4 query heads over 2 KV heads (QKV biases,
    tied embeddings) on a model axis of 4. Each rank takes the KV head
    its query head groups with; the decode cache splits on the sequence,
    a ring of 4 slots (window 4) over 8 steps, so it wraps. Prefill,
    forward and decode == unsharded."""
    reduce = dict(layers=2, d_model=64, vocab=128)
    jcfg, pc = _cfgs("qwen2.5-3b", reduce, dict(dtype="float32"))
    assert (pc.num_heads, pc.num_kv_heads, pc.tie_embeddings) == (4, 2, True)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(6))
    rng = np.random.default_rng(7)
    for name in ("bq", "bk", "bv"):            # random biases, so they count
        jp["layers"]["attn"][name] = jnp.asarray(
            rng.normal(size=jp["layers"]["attn"][name].shape), jnp.float32)
    toks = rng.integers(0, 128, (4, 12))
    steps = rng.integers(0, 128, (4, 8))
    tp, tt = _bridge(jp), torch.from_numpy(toks)
    want = ptf.prefill(tp, pc, tt)
    held("port prefill vs JAX", want,
         jtf.prefill(jp, jcfg, jnp.asarray(toks)), 2e-4)
    dec = _decode(tp, pc, steps, cache_len=4, window=4)
    out = run_ranks(tmp_path, dict(kind="model", arch="qwen2.5-3b",
                                   reduce=reduce,
                                   replace=dict(dtype="float32"),
                                   rules=RULES, cache_len=4, window=4),
                    {"params": tp, "tokens": tt,
                     "steps": torch.from_numpy(steps)})[0]
    held("GQA TP prefill (2x4) vs unsharded", out["prefill"], want, 2e-3)
    held("GQA TP forward", out["forward"], ptf.forward(tp, pc, tt)[0], 2e-3)
    assert out["state_shapes"] == [(2, 1, 2, 16)] * 2
    held("seq-sharded GQA ring decode (2x4) vs unsharded", out["decode"],
         dec, 2e-3)


# ------------------------ the rules of sharding_rules(..., baseline=True)
class _StandInMesh:
    """What ``sharding_rules`` reads of a mesh: MESH's names and sizes."""
    mesh_dim_names = ("data", "model")

    def size(self, i):
        return MESH[i]


def _baseline_rules(arch, **replace):
    """RULES with what ``sharding_rules(..., baseline=True)`` sets for the
    published ``arch`` (with ``replace``) on MESH: no head padding, no
    EP for ``auto``, a whole MLA latent cache, KV heads split only where
    they divide."""
    cfg = dataclasses.replace(pcfg.get_config(arch), **replace)
    base = pmesh.sharding_rules(cfg, _StandInMesh(), baseline=True)
    keys = ("pad_heads", "moe_shardmap", "mla_seq_shard", "shard_kv")
    assert set(base) - set(pmesh.sharding_rules(cfg, _StandInMesh())) == \
        set(keys) - {"shard_kv"}
    return dict(RULES, **{k: base[k] for k in keys})


def test_baseline_rules_match_unsharded(tmp_path):
    """One set of 8 ranks, three parts under the baseline rules: the 6
    heads of test 2 left unpadded (attention replicated over the model
    axis, KV caches whole) — prefill, forward and decode == unsharded;
    DeepSeek-V2 decode over a whole latent cache (heads split, no softmax
    combine) == unsharded; ``moe_apply``'s ``auto`` on 4096 tokens takes
    ``moe_capacity`` (no EP) and == unsharded, while under RULES it
    takes EP and == the same."""
    heads = dict(reduce=dict(layers=2, d_model=120, vocab=128),
                 replace=dict(dtype="float32", num_heads=6, num_kv_heads=6,
                              head_dim=20))
    _, hc = _cfgs("qwen1.5-32b", heads["reduce"], heads["replace"])
    hp = _bridge(jtf.init_params(_cfgs("qwen1.5-32b", heads["reduce"],
                                       heads["replace"])[0],
                                 jax.random.PRNGKey(8)))
    rng = np.random.default_rng(9)
    h_toks, h_steps = rng.integers(0, 128, (4, 16)), rng.integers(0, 128,
                                                                   (4, 6))
    mla = dict(reduce=dict(layers=2, d_model=64),
               replace=dict(dtype="float32"))
    jmc, mc = _cfgs("deepseek-v2-236b", mla["reduce"], mla["replace"])
    mp = _bridge(jtf.init_params(jmc, jax.random.PRNGKey(10)))
    m_steps = rng.integers(0, jmc.vocab_size, (2, 8))
    moe = dict(reduce=dict(layers=2, d_model=64, experts=8),
               replace=dict(dtype="float32", num_experts_per_tok=2,
                            capacity_factor=8.0))
    jec, ec = _cfgs("mixtral-8x7b", moe["reduce"], moe["replace"])
    ep_ = _bridge(jmoe.init_moe(jax.random.PRNGKey(11), jec, jnp.float32))
    # 4096 tokens: a draw whose top-2 router margins stay above the guard
    x = np.random.default_rng(19).normal(size=(4, 1024, 64)).astype(
        np.float32)
    margin = min_margin(x, ep_["router"].numpy(), 2)
    assert margin > MIN_MARGIN, margin
    tx = torch.from_numpy(x)

    parts = {
        "heads": dict(kind="model", arch="qwen1.5-32b", cache_len=8,
                      rules=_baseline_rules("qwen1.5-32b", num_heads=6,
                                            num_kv_heads=6), **heads),
        "mla": dict(kind="model", arch="deepseek-v2-236b", cache_len=8,
                    rules=_baseline_rules("deepseek-v2-236b"), **mla),
        "moe_baseline": dict(kind="moe_auto", arch="mixtral-8x7b",
                             rules=_baseline_rules("mixtral-8x7b"), **moe),
        "moe_rules": dict(kind="moe_auto", arch="mixtral-8x7b", rules=RULES,
                          **moe)}
    assert parts["heads"]["rules"]["shard_kv"] is False
    inputs = {"heads": {"params": hp, "tokens": torch.from_numpy(h_toks),
                        "steps": torch.from_numpy(h_steps)},
              "mla": {"params": mp, "steps": torch.from_numpy(m_steps)},
              "moe_baseline": {"params": ep_, "x": tx},
              "moe_rules": {"params": ep_, "x": tx}}
    out = run_ranks(tmp_path, dict(kind="parts", parts=parts), inputs)[0]

    h_toks = torch.from_numpy(h_toks)
    o = out["heads"]
    held("unpadded prefill (2x4, baseline) vs unsharded", o["prefill"],
         ptf.prefill(hp, hc, h_toks), 2e-3)
    held("unpadded forward", o["forward"], ptf.forward(hp, hc, h_toks)[0],
         2e-3)
    assert o["state_shapes"] == [(2, 8, 6, 20)] * 2     # whole KV heads
    held("unpadded decode (2x4, baseline) vs unsharded", o["decode"],
         _decode(hp, hc, h_steps, cache_len=8), 2e-3)
    o = out["mla"]
    assert o["state_shapes"] == [(1, 8, 64), (1, 8, 32)]  # whole sequence
    held("whole-cache MLA decode (2x4, baseline) vs unsharded", o["decode"],
         _decode(mp, mc, m_steps, cache_len=8), 2e-3)
    want, aux = pmoe.moe_apply(ep_, ec, tx)
    # EP's aux is the mean of the (data, model) shards' own losses
    Bl, Sl = 4 // MESH[0], 1024 // MESH[1]
    ep_aux = np.mean([pmoe.load_balance_loss(*pmoe.router_probs(
        ep_, ec, tx[i * Bl:(i + 1) * Bl, j * Sl:(j + 1) * Sl])[::2], 8)
        for i in range(MESH[0]) for j in range(MESH[1])])
    for name, ep_calls, want_aux in (("moe_baseline", 0, aux),
                                     ("moe_rules", 1, ep_aux)):
        o = out[name]
        assert o["ep_calls"] == ep_calls, name
        held(f"auto MoE ({name}, 2x4) vs unsharded", o["auto"][0], want,
             2e-4)
        held(f"auto MoE aux ({name})", o["auto"][1], want_aux, 2e-4)
