"""The offload server under a device mesh, on 8 CPU processes under gloo,
against the unsharded port and the JAX package.

The per-row decodes (``gqa_decode_multipos``, ``mla_decode_multipos``)
run the rank's heads over its block of the dense cache as
``shard_decode_state`` cuts it; the paged GQA decode runs
``paged_attention`` on the rank's query heads against a pool of the KV
heads they group with; MLA's latent pool is whole on every rank. Each
case runs on a (1, 8) mesh and on a (2, 4) one whose rules have no batch
rule, so that each half of it is a (1, 4) mesh running the whole batch:

* KV heads that split (16 heads over 8 KV heads);
* KV heads fewer than the model axis (8 over 2: the grouped pool, one KV
  head a rank, shared by the ranks beside it);
* padded MHA heads (6 heads and 6 KV heads, padded to 8);
* ``shard_kv=False`` (the K/V weights whole; the rank narrows them to
  its pool's heads, its dense cache holds every KV head);
* MLA with the dense cache split by sequence and the paged latent pool
  whole (8 heads).

Every case: layer 0's per-row and paged decode over 5 calls of 3
staggered rows within 1e-5 x max of the port unsharded and within 2e-4
of the JAX package, and 8 greedy steps of the whole model through
``decode_step`` (the per-row core) and through the paged decode with
tokens equal to both packages' unsharded runs (each step's top-two logit
gap above 1e-4). A GQA pool made without a mesh is refused where its
head count differs.

Then ``OffloadEngine.generate`` and ``ContinuousOffloadServer`` (paged
with preemption and replay, dense, chunked prefill with overlap) on a
reduced Mixtral (8 heads over 2 KV heads, 8 experts, top-2) and a
reduced DeepSeek-V2 (MLA, 8 heads, shared experts), built and run inside
the (1, 8) mesh from the whole params: tokens, functional trace rows,
``stats()`` and ``sim_time`` equal the JAX package's on the same
weights, the smallest router margin of the mesh run above 1e-4, every
rank equal to rank 0 (the logits bitwise), the experts whole and the
attention weights the rank's. An engine stepped under another mesh than
the one it was built under raises. One set of 8 ranks runs every case
(the data axis and memory tiers under a mesh:
``tests/test_torch_distributed_tiers.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import OffloadEngine as JEngine
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.serving import ContinuousOffloadServer as JServer
from repro_torch.models import transformer as ptf

from _torch_dist_ranks import (BLOCK, FUNCTIONAL, paged_greedy,
                               per_row_decodes)
from test_torch_distributed import (MIN_MARGIN, RULES, _cfgs, collect_ranks,
                                    held, start_ranks)
from test_torch_distributed_ssm import JAX_TOL, PORT_TOL, _greedy, within

MESH = (1, 8)
# a (1, 8) mesh; and (2, 4), two (1, 4) meshes side by side: no batch rule
MESHES = {"1x8": dict(rules=dict(RULES, _data_size=1)),
          "1x4": dict(mesh=[2, 4], rules=dict(RULES, batch=None))}
GREEDY = 8
JAX_DECODE = jax.jit(jtf.decode_step, static_argnums=(1,),
                     static_argnames=("window",))
REDUCE = dict(layers=2, d_model=64, vocab=128)
DECODES = {   # name: (arch, config fields, rules fields)
    "split": ("qwen1.5-32b", dict(num_heads=16, num_kv_heads=8,
                                  head_dim=8), {}),
    "grouped": ("qwen2.5-3b", dict(num_heads=8, num_kv_heads=2,
                                   head_dim=8), {}),
    "padded": ("qwen1.5-32b", dict(num_heads=6, num_kv_heads=6,
                                   head_dim=8), {}),
    "no_shard_kv": ("qwen2.5-3b", dict(num_heads=8, num_kv_heads=2,
                                       head_dim=8), dict(shard_kv=False)),
    "mla": ("deepseek-v2-236b", dict(num_heads=8), {}),
}
# KV heads of the rank's pool (GQA) on each mesh, and its dense cache's
# layer-0 shapes [B, slots, KV, hd] for GREEDY slots
POOL_HEADS = {("split", "1x8"): 1, ("split", "1x4"): 2,
              ("grouped", "1x8"): 1, ("grouped", "1x4"): 1,
              ("padded", "1x8"): 1, ("padded", "1x4"): 2,
              ("no_shard_kv", "1x8"): 1, ("no_shard_kv", "1x4"): 1}
CACHE_SHAPES = {("split", "1x8"): (3, 8, 1, 8), ("split", "1x4"): (3, 8, 2, 8),
                ("grouped", "1x8"): (3, 1, 2, 8),
                ("grouped", "1x4"): (3, 2, 2, 8),
                ("padded", "1x8"): (3, 8, 1, 8),
                ("padded", "1x4"): (3, 8, 2, 8),
                ("no_shard_kv", "1x8"): (3, 8, 2, 8),
                ("no_shard_kv", "1x4"): (3, 8, 2, 8),
                ("mla", "1x8"): (3, 1, 64), ("mla", "1x4"): (3, 2, 64)}
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [3, 1, 4, 1, 5, 9]]
MIXTRAL = ("mixtral-8x7b", dict(layers=2, d_model=64, experts=8, vocab=128),
           dict(dtype="float32", num_experts_per_tok=2, num_heads=8,
                num_kv_heads=2, head_dim=8))
DEEPSEEK = ("deepseek-v2-236b", dict(layers=2, d_model=64, experts=4),
            dict(dtype="float32", num_heads=8))
POLICY = dict(cache_slots=3, policy="lfu", prefetch="spec")
SERVER = dict(POLICY, max_batch=2, cache_len=32, kv_block_size=4)
ENGINES = {   # name: (model, kwargs; "prompt" for generate)
    "mixtral_generate": ("mixtral", dict(engine=POLICY, prompt=PROMPTS[0])),
    "mixtral_paged": ("mixtral", dict(server=dict(SERVER, kv_num_blocks=4))),
    "mixtral_dense": ("mixtral", dict(server=dict(SERVER,
                                                  kv_layout="dense"))),
    "mixtral_chunked": ("mixtral", dict(server=dict(SERVER, prefill_chunk=4,
                                                    overlap=True))),
    "deepseek_generate": ("deepseek", dict(engine=POLICY,
                                           prompt=PROMPTS[0])),
    "deepseek_paged": ("deepseek", dict(server=dict(SERVER,
                                                    prefill_chunk=4))),
}
NEW = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Model:
    """One config in both packages and the same weights (the port's
    ``init_params`` from a seeded generator, bridged to JAX; every
    attention bias redrawn non-zero: zero biases would hide a bias
    narrowed to the wrong heads)."""

    def __init__(self, arch, reduce, replace, seed):
        self.arch, self.reduce, self.replace = arch, reduce, replace
        self.jcfg, self.cfg = _cfgs(arch, reduce, replace)
        tree = ptf.to_jax_params(ptf.init_params(
            self.cfg, torch.Generator().manual_seed(seed), device="cpu"))
        rng = np.random.default_rng(seed + 100)
        attn = tree["layers"]["attn"]
        for name in ("bq", "bk", "bv"):
            if name in attn:
                attn[name] = rng.normal(0.0, 0.5, attn[name].shape).astype(
                    np.float32)
        self.jp = jax.tree.map(jnp.asarray, tree)
        self.tp = ptf.from_jax_params(tree, device="cpu")

    def part(self, kind, **extra):
        return dict(kind=kind, arch=self.arch, reduce=self.reduce,
                    replace=self.replace, **extra)


def decode_inputs(m, seed):
    """Layer 0's inputs (5 calls of 3 rows at staggered positions, their
    block tables) and the greedy decodes' first tokens and tables."""
    rng = np.random.default_rng(seed)
    return {"params": m.tp,
            "x": torch.from_numpy(rng.normal(size=(5, 3, 1, 64)).astype(
                np.float32)),
            "pos": torch.tensor([0, 3, 9]),
            "tables": torch.from_numpy(rng.permutation(12).reshape(
                3, 4).astype(np.int32)),
            "first": torch.from_numpy(rng.integers(0, 128, (3, 1))),
            "greedy_tables": torch.from_numpy(rng.permutation(6).reshape(
                3, 2).astype(np.int32))}


def jax_layer_decodes(m, inp, paged):
    """JAX's per-row / paged decode of layer 0 over the same calls."""
    p = jax.tree.map(lambda t: t[0], m.jp["layers"]["attn"])
    x, pos, tables = (np.asarray(inp[k]) for k in ("x", "pos", "tables"))
    mla = m.jcfg.use_mla
    if paged:
        init = jattn.mla_paged_cache_init if mla else \
            jattn.gqa_paged_cache_init
        cache = init(m.jcfg, int(tables.max()) + 1, BLOCK, jnp.float32)
        decode = jattn.mla_decode_paged if mla else jattn.gqa_decode_paged
    else:
        init = jattn.mla_cache_init if mla else jattn.gqa_cache_init
        cache = init(m.jcfg, x.shape[1], tables.shape[1] * BLOCK,
                     jnp.float32)
        decode = jattn.mla_decode_multipos if mla else \
            jattn.gqa_decode_multipos
    out = []
    for i in range(x.shape[0]):
        args = (jnp.asarray(tables),) if paged else ()
        y, cache = decode(p, m.jcfg, jnp.asarray(x[i]), cache,
                          jnp.asarray(pos + i, jnp.int32), *args)
        out.append(np.asarray(y))
    return np.stack(out)


def references(m, inp):
    """The unsharded runs of a decode case: the port's and JAX's layer
    calls, and the greedy decodes (the port's dense and paged, JAX's
    dense), tokens equal."""
    layer = ptf._layer(m.tp["layers"], 0)["attn"]
    ref = {}
    for paged in (False, True):
        ref[paged] = (per_row_decodes(layer, m.cfg, inp["x"], inp["pos"],
                                      inp["tables"], paged=paged),
                      jax_layer_decodes(m, inp, paged))
        held(f"port {'paged' if paged else 'per-row'} decode vs JAX",
             ref[paged][0], ref[paged][1], JAX_TOL)
    first = inp["first"].numpy()
    state = ptf.init_decode_state(m.tp, m.cfg, 3, GREEDY, device="cpu")
    jstate = jtf.init_decode_state(m.jp, m.jcfg, 3, GREEDY)

    def step(tok, pos):
        nonlocal state
        lg, state = ptf.decode_step(m.tp, m.cfg, state,
                                    torch.from_numpy(tok).long(), pos)
        return lg

    def jstep(tok, pos):
        nonlocal jstate
        lg, jstate = JAX_DECODE(m.jp, m.jcfg, jstate,
                                jnp.asarray(tok, jnp.int32), jnp.int32(pos))
        return lg

    ref["greedy"] = _greedy(step, first, GREEDY)
    j_toks, ref["jax_greedy"] = _greedy(jstep, first, GREEDY)
    np.testing.assert_array_equal(ref["greedy"][0], j_toks)
    toks, logits = paged_greedy(m.tp, m.cfg, inp["first"], GREEDY,
                                inp["greedy_tables"])
    np.testing.assert_array_equal(toks.numpy(), j_toks)
    ref["paged_greedy"] = (toks.numpy(), logits.numpy())
    return ref


def jax_engine(m, kw):
    """JAX's engine or server on the case's kwargs: (tokens, rows,
    engine stats, sim_time, server stats)."""
    if "prompt" in kw:
        eng = JEngine(m.jp, m.jcfg, **kw["engine"])
        toks, srv_stats = eng.generate(kw["prompt"], NEW + 2), None
    else:
        srv = JServer(m.jp, m.jcfg, **kw["server"])
        for p in PROMPTS:
            srv.submit(p, max_new=NEW)
        toks, eng, srv_stats = srv.run(), srv.engine, srv.stats()
    rows = [tuple(tuple(int(e) for e in getattr(s, f)) for f in FUNCTIONAL)
            for s in eng.trace.steps]
    return toks, rows, eng.stats(), eng.sim_time, srv_stats


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Every case's ranks' outputs (one set of 8 ranks, started before
    the references are computed here) and the references."""
    dec_models = {name: Model(arch, dict(REDUCE, experts=8)
                              if arch.startswith("deepseek") else REDUCE,
                              dict(dtype="float32", **replace), 40 + i)
                  for i, (name, (arch, replace, _)) in
                  enumerate(DECODES.items())}
    models = {"mixtral": Model(*MIXTRAL, 50), "deepseek": Model(*DEEPSEEK,
                                                                51)}
    parts, inputs = {}, {}
    for i, (name, (_, _, extra)) in enumerate(DECODES.items()):
        m = dec_models[name]
        inp = decode_inputs(m, 60 + i)
        for mesh, mkw in MESHES.items():
            key = f"{name}/{mesh}"
            parts[key] = m.part("decodes", greedy=GREEDY,
                                **dict(mkw, rules=dict(mkw["rules"],
                                                       **extra)))
            inputs[key] = inp
    for name, (model, kw) in ENGINES.items():
        m = models[model]
        kw = dict(kw, new=NEW + 2) if "prompt" in kw else \
            dict(kw, prompts=PROMPTS, new=NEW)
        parts[name] = m.part("engine", rules=MESHES["1x8"]["rules"], **kw)
        inputs[name] = {"params": m.tp}
    m = models["mixtral"]
    parts["refuse_other_mesh"] = m.part(
        "engine", rules=MESHES["1x8"]["rules"], refuse=POLICY,
        step_mesh=[2, 4])
    inputs["refuse_other_mesh"] = {"params": m.tp}
    started = start_ranks(tmp_path_factory.mktemp("serving"),
                          dict(kind="parts", parts=parts), inputs, MESH)
    refs = {name: references(dec_models[name], inputs[f"{name}/1x8"])
            for name in DECODES}
    jax_runs = {name: jax_engine(models[model], kw)
                for name, (model, kw) in ENGINES.items()}
    outs = collect_ranks(started)
    return dec_models, models, outs, refs, jax_runs


def _agree(outs, name):
    """Every rank's outputs of part ``name`` equal rank 0's (tensors
    bitwise); returns rank 0's."""
    def same(a, b):
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(map(same, a, b))
        return a == b
    for r, o in enumerate(outs[1:], 1):
        assert same(o[name], outs[0][name]), (r, name)
    return outs[0][name]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", list(DECODES))
def test_decodes_under_the_mesh(served, case, mesh):
    """Layer 0's per-row and paged decodes, and the whole model's greedy
    decodes through both, against both packages unsharded; the rank's
    pool holds its KV heads and its dense cache its block."""
    dec_models, _, outs, refs, _ = served
    o, ref = _agree(outs, f"{case}/{mesh}"), refs[case]
    for paged, what in ((False, "multipos"), (True, "paged")):
        within(f"{case} {what} ({mesh}) vs port unsharded", o[what],
               ref[paged][0], PORT_TOL)
        held(f"{case} {what} ({mesh}) vs JAX", o[what], ref[paged][1],
             JAX_TOL)
    m = dec_models[case]
    assert o["state_shapes"][0] == CACHE_SHAPES[case, mesh]
    if m.cfg.use_mla:
        assert o["pool_shape"] == (1, BLOCK, m.cfg.kv_lora_rank)
    else:
        assert o["pool_shape"] == (1, BLOCK, POOL_HEADS[case, mesh], 8)
        if POOL_HEADS[case, mesh] != m.cfg.num_kv_heads:
            assert "allocate it with gqa_paged_cache_init" in \
                o["plain_pool"]
    for what in ("greedy", "paged_greedy"):
        toks, logits = (t.numpy() for t in o[what])
        np.testing.assert_array_equal(toks, ref[what][0])
        within(f"{case} {what} ({mesh}) vs port unsharded", logits,
               ref[what][1], PORT_TOL)
        held(f"{case} {what} ({mesh}) vs JAX", logits, ref["jax_greedy"],
             JAX_TOL)


@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_under_the_mesh_matches_jax(served, name):
    """The engine or server built and run inside the (1, 8) mesh ==
    JAX's: tokens, functional trace rows, ``stats()`` and ``sim_time``
    exactly, every rank equal (last logits bitwise), with the smallest
    router margin of the mesh run above 1e-4. The experts stay whole,
    the attention weights are the rank's heads; ``paged_attention`` runs
    once a layer a step on the paged GQA servers and never elsewhere."""
    _, models, outs, _, jax_runs = served
    o = _agree(outs, name)
    toks, rows, stats, sim_time, srv_stats = jax_runs[name]
    m = models[ENGINES[name][0]]
    assert o["tokens"] == toks
    assert o["rows"] == rows
    assert o["stats"] == stats
    assert o["sim_time"] == sim_time
    if srv_stats is not None:
        assert o["server_stats"] == srv_stats
    assert o["margin"] > MIN_MARGIN, o["margin"]
    c = m.cfg
    assert o["expert_shape"] == (c.num_layers, c.num_experts, c.d_model,
                                 c.expert_d_ff)
    assert o["attn_shape"][2] == 1       # 8 heads, 1 a rank
    steps, L = stats["decode_steps"], c.num_layers
    assert o["launches"]["moe_ffn"] >= steps * L
    paged = "server" in ENGINES[name][1] and \
        ENGINES[name][1]["server"].get("kv_layout") != "dense"
    want = steps * L if paged and not c.use_mla else 0
    assert o["launches"]["paged_attention"] == want
    if paged and not c.use_mla:
        assert o["pool_shape"][2] == 1   # KV head r // 4 of 2
    if name == "mixtral_paged":
        assert srv_stats["kv_preemptions"] > 0


def test_refusals_under_the_mesh(served):
    """An engine built under the (1, 8) mesh and stepped under another
    mesh, or under none, raises: its params are cut for its own."""
    _, _, outs, _, _ = served
    errors = _agree(outs, "refuse_other_mesh")["errors"]
    assert len(errors) == 2
    for e in errors:
        assert e is not None and "another mesh" in e, e
