"""The port's dry run (``repro_torch.launch.dryrun``) and its op counter
(``repro_torch.launch.op_cost.OpCost``) against the JAX package.

* Specs: ``input_specs``, ``params_spec`` and ``decode_state_spec`` (the
  port's per-layer lists stacked on their layer axes) equal the JAX
  package's ``eval_shape`` trees for every assigned arch x input shape,
  shape and dtype exactly; ``opt_state_pspecs`` and
  ``decode_state_pspecs`` equal JAX's under a stand-in production mesh.
* FLOPs: the counted matmul FLOPs of ``prefill`` and ``decode_step``
  (reduced dense and Mixtral, no mesh) equal the closed form, and for
  the dense decode step JAX's optimized HLO's dot FLOPs.
* Meta equals CPU: one call's whole report on ``meta`` equals the report
  on the CPU (the kernels' plain versions), for every family.
* Collectives: rank 0's under a 4-rank gloo group (real data) equal the
  fake group's on meta, for an expert-parallel MoE prefill and a dense
  decode step.
* The CLI: one case ok.
* Training: Qwen1.5-0.5B's train_4k step on the (16, 16) mesh, its
  kernel calls and collectives in closed form; the ZeRO-1 configs' step
  (reduced) on a fake (2, 4) mesh, its moment bytes and its added
  reduce-scatters and all-gathers in closed form; a meta call under grad
  of each differentiable kernel counts its backward once at
  ``bwd_cost``, and the decode-only kernels refuse grad.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES, get_config as jget_config
from repro.configs import reduced as jreduced
from repro.launch import mesh as jmesh
from repro.launch import specs as jspecs
from repro.launch.hlo_cost import HloCost, _dot_flops
from repro.models import sharding as jshd
from repro.models import transformer as jtf
import repro_torch.configs as pcfg
from repro_torch.configs.all_configs import ASSIGNED
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import specs as pspecs
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import sharding as pshd
from repro_torch.models import transformer as ptf
from repro_torch.training.tree import flatten as ptf_flatten

import _torch_dist_ranks as ranks

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 240
GLOO_MESH = (2, 2)
# the rules of tests/test_distributed.py at data 2 (sharding_rules leaves
# a depth-cut config's weights whole)
RULES = {"batch": ["data"], "model": "model", "heads": "model",
         "vocab": "model", "experts": "model", "capacity": "data",
         "shard_kv": True, "experts_mode": "ep", "_data_size": 2}
# the same at data 1
RULES_1 = dict(RULES, _data_size=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StandInMesh:
    """What both packages' rules read of a mesh (JAX's ``shape`` mapping,
    the port's ``mesh_dim_names`` and ``size(i)``)."""

    def __init__(self, shape, names):
        self.axis_names = self.mesh_dim_names = tuple(names)
        self.shape = dict(zip(names, shape))

    def size(self, i):
        return self.shape[self.mesh_dim_names[i]]


def _spec(p):
    """A spec as a tuple, a one-name tuple entry written as the name."""
    return tuple(a[0] if isinstance(a, (tuple, list)) and len(a) == 1
                 else a for a in p)


def _jax_leaves(tree):
    """{path: leaf} of a JAX tree (PartitionSpecs are leaves)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", "")))
                     for k in path): v for path, v in flat}


class _Tagged:
    """A port leaf with its spec (a spec is itself a tuple)."""

    def __init__(self, t, spec=None):
        self.t, self.spec = t, spec


def _port_leaves(tree, path="", lead=()):
    """(JAX path, list lengths stacked, leaf) of a port tree: its lists
    are the JAX package's stacked layer axes, its dicts and tuples the
    same nodes."""
    if isinstance(tree, list):
        for t in tree:
            yield from _port_leaves(t, path, lead + (len(tree),))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, f"{path}/{k}" if path else k, lead)
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, f"{path}/{i}" if path else str(i),
                                    lead)
    else:
        yield path, lead, tree


def _stacked(tree):
    """{JAX path: (shape, dtype)} of a port tree, its lists stacked on
    their layer axes (every entry of a list has one shape)."""
    out = {}
    for path, lead, t in _port_leaves(tree):
        t = t.t if isinstance(t, _Tagged) else t
        got = (lead + tuple(t.shape), str(t.dtype).replace("torch.", ""))
        assert out.setdefault(path, got) == got, path
    return out


def _jax_shapes(tree):
    return {k: (tuple(v.shape), str(v.dtype))
            for k, v in _jax_leaves(tree).items()}


# --------------------------------------------------------------- specs
@pytest.mark.parametrize("arch", ASSIGNED)
def test_params_spec_matches_jax(arch):
    """Leaf paths, shapes and dtypes of the whole params, on meta."""
    got = pspecs.params_spec(pcfg.get_config(arch))
    assert {t.device.type for _, _, t in _port_leaves(got)} == {"meta"}
    assert _stacked(got) == _jax_shapes(jspecs.params_spec(
        jget_config(arch)))


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_input_specs_match_jax(arch, shape):
    """Every input of the case, the decode state stacked on its layer
    axes, shape and dtype exactly (no mesh: unpadded heads)."""
    want = _jax_shapes(jspecs.input_specs(jget_config(arch), shape))
    got = pspecs.input_specs(pcfg.get_config(arch), shape)
    assert {t.device.type for _, _, t in _port_leaves(got)} == {"meta"}
    assert _stacked(got) == want
    assert pspecs.decode_geometry(pcfg.get_config(arch),
                                  INPUT_SHAPES[shape]) == \
        jspecs.decode_geometry(jget_config(arch), INPUT_SHAPES[shape])


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "jamba-1.5-large-398b",
                                  "qwen1.5-32b"])
def test_opt_state_pspecs_match_jax(arch, multi_pod):
    """m / v / count specs over the sanitized param specs: ZeRO-1's data
    split of the largest free dim for DeepSeek-V2 and Jamba, the param
    specs as they are for Qwen1.5-32B."""
    shape, names = ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
        else ((16, 16), ("data", "model"))
    mesh = StandInMesh(shape, names)
    jcfg, cfg = jget_config(arch), pcfg.get_config(arch)
    rules = jmesh.sharding_rules(jcfg, mesh, global_batch=256)
    assert pmesh.sharding_rules(cfg, mesh, global_batch=256) == rules
    jp = jspecs.params_spec(jcfg)
    want = _jax_leaves(jspecs.opt_state_pspecs(
        jshd.param_pspecs(jp, rules, mesh=mesh), jp, jcfg, rules))
    pp = pspecs.params_spec(cfg)
    specs = pspecs.opt_state_pspecs(pshd.param_pspecs(pp, rules, mesh=mesh),
                                    pp, cfg, rules)
    tree = {"m": pshd.zip_map(_Tagged, pp, specs["m"]),
            "v": pshd.zip_map(_Tagged, pp, specs["v"]),
            "count": _Tagged(None, specs["count"])}
    got = {path: _spec(t.spec) for path, _, t in _port_leaves(tree)}
    assert got == {k: _spec(v) for k, v in want.items()}
    if cfg.zero1:
        assert sum("data" in s for s in got.values()) > 10


DECODE_ARCHS = list(ASSIGNED)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_state_pspecs_match_jax(arch):
    """The decode state's specs at decode_32k on the (16, 16) mesh, each
    state built under its package's sharding context (KV heads pad):
    every per-layer leaf of the port has the JAX stacked leaf's spec
    without its layer entries, and the stacked shapes are equal.
    Whisper-tiny's JAX state is built outside the context: its encoder
    constrains the weights to a ``NamedSharding``, which needs a real JAX
    mesh, and its rules have no model axis, so nothing pads."""
    mesh = StandInMesh((16, 16), ("data", "model"))
    shape = INPUT_SHAPES["decode_32k"]
    jcfg, cfg = jget_config(arch), pcfg.get_config(arch)
    rules = jmesh.sharding_rules(jcfg, mesh, global_batch=shape.global_batch)
    cache_len, _ = jspecs.decode_geometry(jcfg, shape)
    encdec = jcfg.family == "encdec"
    assert not encdec or rules["model"] is None
    with jshd.sharding_ctx(None if encdec else mesh, {} if encdec else rules):
        jstate = jspecs.decode_state_spec(jcfg, shape.global_batch,
                                          cache_len)
    want = _jax_leaves(jspecs.decode_state_pspecs(jstate, rules, mesh))
    with pshd.sharding_ctx(mesh, rules):
        state = pspecs.decode_state_spec(cfg, shape.global_batch, cache_len)
    tagged = pshd.zip_map(_Tagged, state,
                          pspecs.decode_state_pspecs(state, rules, mesh))
    assert _stacked(tagged) == _jax_shapes(jstate)
    n = 0
    for path, lead, t in _port_leaves(tagged):
        assert _spec(t.spec) == _spec(want[path])[len(lead):], path
        n += 1
    assert n >= cfg.num_layers


# ---------------------------------------------------------------- flops
def _cfgs(arch, **kw):
    kw = dict(dict(layers=2, d_model=64, experts=4, vocab=128), **kw)
    j = dataclasses.replace(jreduced(jget_config(arch), **kw),
                            dtype="float32")
    p = dataclasses.replace(pcfg.reduced(pcfg.get_config(arch), **kw),
                            dtype="float32")
    assert dataclasses.asdict(j) == dataclasses.asdict(p)
    return j, p


def _closed_form(cfg, B, S, L=None):
    """Matmul FLOPs of prefill (S positions, last-position logits) or of
    one decode step (``L`` cache slots, S = 1), kernel calls included:
    the q/k/v/o projections, the attention's two products (causal pairs
    in prefill, every cache slot in decode), the FFN (SwiGLU; MoE:
    router, then every expert on every token under ``moe_dense`` (T <=
    256) or the [E, C] slot buffers under ``moe_capacity``, with its
    gate-weighted combine for the dense path), and the logits."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    T = B * S
    proj = 2 * T * d * (H + 2 * KV) * hd + 2 * T * H * hd * d
    if L is None:
        attn = 2 * B * H * (S * (S + 1) // 2) * 2 * hd
    else:
        attn = 2 * 2 * B * H * L * hd
    if cfg.is_moe:
        E, ff = cfg.num_experts, cfg.expert_d_ff
        if T <= 256:
            ffn = 2 * T * d * E + 6 * T * d * E * ff + 2 * T * E * d
        else:
            C = -(-max(int(np.ceil(T * cfg.num_experts_per_tok
                                   * cfg.capacity_factor / E)), 8) // 8) * 8
            ffn = 2 * T * d * E + 6 * E * C * d * ff
    else:
        ffn = 6 * T * d * cfg.d_ff
    return cfg.num_layers * (proj + attn + ffn) + 2 * B * d * cfg.vocab_size


def _counted(cfg, params, fn, **kw):
    with torch.no_grad(), OpCost() as c:
        fn(params, cfg, **kw)
    return c.to_dict()


@pytest.mark.parametrize("arch,S", [("qwen1.5-0.5b", 64),
                                    ("mixtral-8x7b", 64),
                                    ("mixtral-8x7b", 256)])
def test_matmul_flops_equal_closed_form(arch, S):
    """No mesh, meta tensors: prefill of 2 x S (Mixtral at 64 positions
    takes ``moe_dense``, at 256 ``moe_capacity``) and one decode step
    over 2 rows and S cache slots; the attention of prefill is the
    flash-attention kernel's call."""
    _, cfg = _cfgs(arch)
    p = ptf.init_params(cfg, torch.Generator(), device="meta")
    tok = torch.zeros((2, S), dtype=torch.long, device="meta")
    rep = _counted(cfg, p, ptf.prefill, tokens=tok)
    flash = rep["kernel_calls"]["flash_attention"]
    assert flash["calls"] == cfg.num_layers
    assert flash["flops"] == cfg.num_layers * 2 * 2 * cfg.num_heads * (
        S * (S + 1) // 2) * 2 * cfg.head_dim
    assert rep["matmul_flops"] + flash["flops"] == _closed_form(cfg, 2, S)
    state = ptf.init_decode_state(p, cfg, 2, S, device="meta")
    rep = _counted(cfg, p, ptf.decode_step, state=state, token=tok[:, :1],
                   pos=S - 1)
    assert rep["kernel_calls"] == {}
    assert rep["matmul_flops"] == _closed_form(cfg, 2, 1, L=S)


class DotFlops(HloCost):
    """The JAX package's HLO walk (trip counts and fusions as it does
    them), counting the FLOPs of ``dot`` instructions only."""

    def _leaf(self, inst, shapes, mult, rep, *, bytes_too=True):
        if inst.opcode == "dot":
            rep.flops += mult * _dot_flops(inst, shapes)


def test_decode_matmul_flops_equal_xla_dots():
    """The reduced dense decode step's counted matmul FLOPs equal the dot
    FLOPs of JAX's optimized HLO of the same jitted step (MoE is left
    out: JAX's dispatch einsums are dots the port does not run)."""
    jcfg, cfg = _cfgs("qwen1.5-0.5b")
    B, L = 2, 64
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    js = jtf.init_decode_state(jp, jcfg, B, L)
    step = jax.jit(lambda p, s, t, pos: jtf.decode_step(p, jcfg, s, t, pos))
    text = step.lower(jp, js, np.zeros((B, 1), np.int32),
                      np.int32(L - 1)).compile().as_text()
    want = DotFlops(text).analyze().flops
    p = ptf.init_params(cfg, torch.Generator(), device="meta")
    rep = _counted(cfg, p, ptf.decode_step,
                   state=ptf.init_decode_state(p, cfg, B, L, device="meta"),
                   token=torch.zeros((B, 1), dtype=torch.long,
                                     device="meta"), pos=L - 1)
    assert want > 0 and rep["matmul_flops"] == want


def test_ssm_decode_matmul_flops_equal_xla_dots():
    """The same for the reduced Mamba2 decode step (8 SSM heads of 16,
    state 16): the projections, the conv ring's product over its window,
    the state update's outer product, its read-out and the logits."""
    jcfg, cfg = _cfgs("mamba2-2.7b")
    jcfg, cfg = (dataclasses.replace(c, ssm_headdim=16, ssm_state=16)
                 for c in (jcfg, cfg))
    B, L = 2, 64
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    js = jtf.init_decode_state(jp, jcfg, B, L)
    step = jax.jit(lambda p, s, t, pos: jtf.decode_step(p, jcfg, s, t, pos))
    text = step.lower(jp, js, np.zeros((B, 1), np.int32),
                      np.int32(L - 1)).compile().as_text()
    want = DotFlops(text).analyze().flops
    p = ptf.init_params(cfg, torch.Generator(), device="meta")
    rep = _counted(cfg, p, ptf.decode_step,
                   state=ptf.init_decode_state(p, cfg, B, L, device="meta"),
                   token=torch.zeros((B, 1), dtype=torch.long,
                                     device="meta"), pos=L - 1)
    assert want > 0 and rep["matmul_flops"] == want


# ------------------------------------------- the SSM split over 4 ranks
SSM_MESH = (1, 4)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_sharded_ssm_work_sums_to_unsharded(kind):
    """Reduced Mamba2 (8 SSM heads of 16, state 16: d_inner 128, xBC 160
    columns) as rank 0 of a fake group of 4 on a (1, 4) mesh, on meta:
    every model rank runs the same shapes, so the ranks' matmul FLOPs
    plus ``ssd_chunk``'s sum to 4 x rank 0's. That sum is the unsharded
    count plus 3 x the part every rank repeats: the chunk scores C·Bᵀ
    inside the kernel's cost (2·N a pair of a chunk's lower triangle,
    G chunks a layer); the projections, the conv (per channel: each rank
    convolves its own columns), the inter-chunk products, the decode's
    state update and read-out, ``out_proj`` and the vocab-split logits
    are split, and the embedding (a gather) and the norms are no
    products. The collective bytes by kind are what the design moves:
    all-gather: the embedding's d blocks, the logits' vocab blocks and
    the rows over the data axis, and in decode each layer's new xBC row;
    all-to-all: each layer's xBC columns to the heads' x channels plus
    B and C; all-reduce: each layer's norm sums and ``out_proj``."""
    _, cfg = _cfgs("mamba2-2.7b")
    cfg = dataclasses.replace(cfg, ssm_headdim=16, ssm_state=16)
    Lyr, d, V, N = cfg.num_layers, cfg.d_model, cfg.vocab_size, cfg.ssm_state
    di, C = cfg.d_inner, cfg.d_inner + 2 * cfg.ssm_state
    m = SSM_MESH[1]
    B, S = 2, (256 if kind == "prefill" else 1)
    p = ptf.init_params(cfg, torch.Generator(), device="meta")
    tok = torch.zeros((B, S), dtype=torch.long, device="meta")

    def run(params):
        if kind == "prefill":
            return _counted(cfg, params, ptf.prefill, tokens=tok)
        state = ptf.init_decode_state(params, cfg, B, 64, device="meta")
        if pshd.active_mesh() is not None:
            state = pspecs.shard_decode_state(state, pshd.active_mesh(),
                                              RULES_1)
        return _counted(cfg, params, ptf.decode_step, state=state,
                        token=tok, pos=63)

    whole = run(p)
    dryrun.open_fake_group(m)
    try:
        mesh = pmesh.make_mesh(SSM_MESH, ("data", "model"), "cpu")
        with pshd.sharding_ctx(mesh, RULES_1):
            rank = run(pshd.shard_params(p, mesh, RULES_1))
    finally:
        torch.distributed.destroy_process_group()

    def work(rep):
        return rep["matmul_flops"] + sum(k["flops"] for k in
                                         rep["kernel_calls"].values())
    Q = min(cfg.ssm_chunk, S)
    repeated = 0
    if kind == "prefill":
        assert rank["kernel_calls"]["ssd_chunk"]["calls"] == Lyr
        repeated = Lyr * (B * S // Q) * 2 * (Q * (Q + 1) // 2) * N
    assert m * work(rank) == work(whole) + (m - 1) * repeated
    assert m * rank["matmul_flops"] == whole["matmul_flops"]
    T, f = B * S, 4                           # tokens a rank, fp32 bytes
    want = {"all-gather": f * (T * d + 2 * B * V), "all-to-all":
            Lyr * f * T * (di // m + 2 * N), "all-reduce":
            Lyr * f * (T + T * d)}
    if kind == "decode":
        want["all-gather"] += Lyr * f * B * C
    assert rank["collectives"] == want
    assert rank["collective_calls"] == {
        "all-gather": 3 + (Lyr if kind == "decode" else 0),
        "all-to-all": Lyr, "all-reduce": 2 * Lyr}


# ------------------------------------------------------- meta == cpu
FAMILIES = ["qwen2.5-3b", "mixtral-8x7b", "deepseek-v2-236b", "mamba2-2.7b",
            "jamba-1.5-large-398b", "whisper-tiny", "llama-3.2-vision-11b"]


def _report(cfg, device, kind):
    """One prefill (2 x 64; encdec's encoder first) or one decode step
    (2 rows, 64 slots) of ``cfg`` on ``device``, counted."""
    p = ptf.init_params(cfg, torch.Generator(device=device).manual_seed(0)
                        if device != "meta" else torch.Generator(),
                        device=device)
    tok = torch.ones((2, 64), dtype=torch.long, device=device)
    enc = None
    if cfg.family in ("encdec", "vlm"):
        n = cfg.encoder_frames if cfg.family == "encdec" \
            else cfg.num_image_tokens
        enc = torch.ones((2, n, cfg.d_model), device=device)
    if kind == "decode":
        if cfg.family == "encdec":
            enc = ptf.encoder_forward(p, cfg, enc)
        state = ptf.init_decode_state(p, cfg, 2, 64, enc=enc, device=device)
    with torch.no_grad(), OpCost() as c:
        if kind == "prefill":
            if cfg.family == "encdec":
                enc = ptf.encoder_forward(p, cfg, enc)
            ptf.prefill(p, cfg, tok, enc=enc)
        else:
            ptf.decode_step(p, cfg, state, tok[:, :1], 63)
    return c.to_dict()


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_report_equals_cpu(arch, kind):
    """Field for field (devices aside): FLOPs, bytes, collectives, the
    kernel calls and the live bytes' peak; the kernels' plain versions
    on the CPU are one opaque call each, as the meta outputs are."""
    _, cfg = _cfgs(arch)
    meta, cpu = _report(cfg, "meta", kind), _report(cfg, "cpu", kind)
    assert meta.pop("devices") == ["meta"] and cpu.pop("devices") == ["cpu"]
    assert meta == cpu
    assert meta["flops"] > meta["matmul_flops"] > 0
    assert meta["bytes_accessed"] > 0 and meta["temp_bytes"] > 0
    kernels = set(meta["kernel_calls"])
    if kind == "prefill":
        assert kernels == ({"ssd_chunk"} if cfg.family == "ssm" else
                           {"flash_attention", "ssd_chunk"}
                           if cfg.family == "hybrid" else
                           {"flash_attention"})


# ------------------------------------------------- collectives: gloo
def _gloo_case():
    """A reduced MoE prefill that takes expert parallelism (2 x 2048
    tokens, 4 experts over the model axis of 2) and a reduced dense
    decode step (2 rows, 32 slots), as parts of one spawn."""
    moe = {"kind": "cost", "arch": "mixtral-8x7b",
           "reduce": dict(layers=2, d_model=64, experts=4, vocab=128),
           "replace": {"dtype": "float32"}, "rules": RULES}
    dense = {"kind": "cost", "arch": "qwen1.5-0.5b",
             "reduce": dict(layers=2, d_model=64, vocab=128),
             "replace": {"dtype": "float32"}, "rules": RULES,
             "cache_len": 32}
    return {"kind": "parts", "parts": {"moe_prefill": moe,
                                       "dense_decode": dense}}


def _gloo_inputs(case, device):
    out = {}
    for name, part in case["parts"].items():
        cfg = ranks.case_config(part)
        gen = torch.Generator().manual_seed(0)
        p = ptf.init_params(cfg, gen, device="cpu")
        if device == "meta":
            p = ptf._tree_map(lambda t: t.to("meta"), p)
        S = 2048 if "cache_len" not in part else 1
        tok = torch.randint(0, cfg.vocab_size, (2, S), generator=gen)
        out[name] = {"params": p, "tokens": tok.to(device)}
    return out


def test_collectives_equal_under_gloo_and_fake(tmp_path):
    """Rank 0 of 4 gloo CPU processes on a (2, 2) mesh, real data, and
    rank 0 of a fake group of 4 on meta tensors: the same collective
    calls and bytes by kind, and the same whole report (devices aside),
    for an EP MoE prefill (all-to-all) and a dense decode step."""
    case = _gloo_case()
    torch.save(_gloo_inputs(case, "cpu"), tmp_path / "inputs.pt")
    spawned = dict(case, mesh=list(GLOO_MESH),
                   store=f"file://{tmp_path}/store",
                   inputs=str(tmp_path / "inputs.pt"))
    (tmp_path / "case.json").write_text(json.dumps(spawned))
    world = GLOO_MESH[0] * GLOO_MESH[1]
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_dist_ranks.py"),
         str(tmp_path / "case.json"), str(r), str(world)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    bad = [(r, p.returncode, log[-3000:])
           for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    assert not bad, bad
    gloo = torch.load(tmp_path / "out-0.pt", weights_only=True)

    dryrun.open_fake_group(world)
    try:
        mesh = pmesh.make_mesh(GLOO_MESH, ("data", "model"), "cpu")
        fake = ranks.run_case(case, mesh, _gloo_inputs(case, "meta"))
    finally:
        torch.distributed.destroy_process_group()
    for part in case["parts"]:
        g, f = gloo[part], fake[part]
        assert g.pop("devices") == ["cpu"] and f.pop("devices") == ["meta"]
        assert g["collective_calls"] == f["collective_calls"], part
        assert g["collectives"] == f["collectives"], part
        assert g == f, part
    assert "all-to-all" in fake["moe_prefill"]["collective_calls"]
    assert "all-gather" in fake["dense_decode"]["collective_calls"]


# ------------------------------------------------------------------ CLI
def _cli(*argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *argv], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)


def test_dryrun_cli_single_case(tmp_path):
    r = _cli("--arch", "qwen1.5-0.5b", "--shape", "decode_32k", "--out",
             str(tmp_path / "dry.json"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "1 ok, 0 failed" in r.stdout
    assert "[qwen1.5-0.5b × decode_32k × mesh 16x16]" in r.stdout
    out = json.loads((tmp_path / "dry.json").read_text())
    assert out["failures"] == []
    (res,) = out["results"]
    assert set(res) == {
        "arch", "shape", "mesh", "chips", "flops", "matmul_flops",
        "transcendental", "bytes_accessed", "collective_bytes",
        "collective_calls", "collective_total", "kernel_calls", "by_op",
        "params_total", "params_active", "run_s", "memory"}
    assert set(res["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes"}
    assert res["mesh"] == "16x16" and res["chips"] == 256
    assert res["flops"] > res["matmul_flops"] > 0
    assert set(res["collective_bytes"]) == {"all-gather", "all-reduce"}
    assert res["params_total"] == pcfg.get_config(
        "qwen1.5-0.5b").param_counts()[0]
    ops = res["by_op"].values()
    assert sum(o["flops"] for o in ops) == res["flops"]
    assert res["by_op"]["mm"]["flops"] + res["by_op"]["bmm"]["flops"] == \
        res["matmul_flops"]


@pytest.mark.parametrize("arch", ["deepseek-v2-236b",
                                  "jamba-1.5-large-398b"])
def test_dryrun_zero1_train_step(arch):
    """The two ZeRO-1 configs' train step (reduced, 2 layers at d 8192 so
    that ``sharding_rules`` gives a model axis) through
    ``dryrun.build_case`` on a fake group of 8 and a (2, 4) mesh, against
    the same step with ``zero1`` off. In closed form, over the leaves
    whose moment spec adds "data" (the largest dim of 2 or more that 2
    divides and the param spec keeps whole): the moments in
    ``argument_bytes`` are each leaf's param block in fp32, twice, halved
    on those leaves; the step adds one reduce-scatter a leaf, of its
    gradient block halved (on top of the backward's own), and one
    all-gather a leaf, of its updated param block (on top of the
    forward's own)."""
    cfg = pcfg.reduced(pcfg.get_config(arch), layers=2, d_model=8192)
    dryrun.open_fake_group(8)
    try:
        mesh = pmesh.make_mesh((2, 4), ("data", "model"), "cpu")
        runs = {}
        for zero1 in (True, False):
            c = dataclasses.replace(cfg, zero1=zero1)
            fn, args, rules, arg_bytes = dryrun.build_case(c, "train_4k",
                                                           mesh)
            with pshd.sharding_ctx(mesh, rules), torch.enable_grad(), \
                    OpCost() as cost:
                fn(*args)
            runs[zero1] = cost.to_dict(), arg_bytes
    finally:
        torch.distributed.destroy_process_group()
    assert rules["model"] == "model" and rules["_data_size"] == 2
    whole = pspecs.params_spec(cfg)
    specs = pshd.param_pspecs(whole, rules, mesh)
    moments = pspecs.opt_state_pspecs(specs, whole, cfg, rules)["m"]
    sizes = pshd.axis_sizes(mesh)
    blocks, zero = [], []      # (elements, element size); a ZeRO-1 leaf

    def leaf(t, spec):
        n = int(np.prod([sizes[a] for e in spec
                         for a in pshd.entry_axes(e)]))
        blocks.append((t.numel() // n, t.element_size()))
    pshd.zip_map(leaf, whole, specs)
    pshd.zip_map(lambda t, m: zero.append(t.numel() > 0 and "data" in m),
                 whole, moments)
    assert sum(zero) > len(zero) // 2
    B = INPUT_SHAPES["train_4k"]
    batch = 2 * B.global_batch * B.seq_len * 4 // 2      # int32 rows
    params = sum(n * e for n, e in blocks)
    moment_bytes = sum(8 * n // (2 if z else 1)
                       for (n, _), z in zip(blocks, zero))
    (got, got_args), (base, _) = runs[True], runs[False]
    assert got_args == params + moment_bytes + 4 + batch
    more = {k: got["collectives"].get(k, 0) - base["collectives"].get(k, 0)
            for k in ("reduce-scatter", "all-gather")}
    calls = {k: got["collective_calls"].get(k, 0)
             - base["collective_calls"].get(k, 0)
             for k in ("reduce-scatter", "all-gather")}
    assert calls == {"reduce-scatter": sum(zero), "all-gather": sum(zero)}
    assert more == {
        "reduce-scatter": sum(n * e // 2 for (n, e), z in zip(blocks, zero)
                              if z),
        "all-gather": sum(n * e for (n, e), z in zip(blocks, zero) if z)}


def _local_bytes(cfg, rules, mesh):
    """(bytes of the rank's block of every param leaf, leaves split)."""
    whole = pspecs.params_spec(cfg)
    sizes = pshd.axis_sizes(mesh)
    got = []

    def leaf(t, spec):
        n = int(np.prod([sizes[a] for e in spec for a in pshd.entry_axes(e)]))
        got.append((t.numel() * t.element_size() // n, n > 1))
    pshd.zip_map(leaf, whole, pshd.param_pspecs(whole, rules, mesh))
    return sum(b for b, _ in got), sum(s for _, s in got)


def test_dryrun_train_step_on_the_mesh(tmp_path, capsys):
    """Qwen1.5-0.5B x train_4k on (16, 16): a step of 16 rows a rank runs
    the flash forward twice a layer (remat recomputes it) and its
    backward once, each at the module's closed form on the rank's heads;
    the all-reduces are, in closed form: a layer's two [16, 4096, 1024]
    bf16 sums (after ``wo`` and ``w2``) in the forward, the first again
    in the recomputation (which stops at the last tensor the backward
    needs, before the second), both in the backward; per 512-position
    chunk of the cross entropy the row maxima and the stacked sums of
    exponentials and label logits (and the latter's backward); the
    batch's loss sum and its backward; each gradient leaf once, the
    rank's block; and one sum of the split leaves' squares for the global
    norm. The embedding's d blocks are gathered once (their gradient
    reduce-scattered once), and the tied embedding's all-to-all into
    vocab blocks runs once each way."""
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "train_4k",
                        "--out", str(out)]) == 0
    assert "1 ok, 0 failed" in capsys.readouterr().out
    (res,) = json.loads(out.read_text())["results"]
    cfg = pcfg.get_config("qwen1.5-0.5b")
    L, S, d, H = cfg.num_layers, 4096, cfg.d_model, cfg.num_heads // 16
    Br, chunks = 256 // 16, 4096 // 512
    kc = res["kernel_calls"]
    q = torch.empty((Br, S, H, cfg.head_dim), dtype=torch.bfloat16,
                    device="meta")
    fwd = flash_mod.cost(q, q, q, causal=True, window=0)
    bwd = flash_mod.bwd_cost(q, q, q, causal=True, window=0)
    assert kc["flash_attention"] == {"calls": 2 * L, "flops": 2 * L * fwd[0],
                                     "bytes": 2 * L * fwd[1]}
    assert kc["flash_attention_bwd"] == {"calls": L, "flops": L * bwd[0],
                                         "bytes": L * bwd[1]}
    mesh = StandInMesh((16, 16), ("data", "model"))
    rules = pmesh.sharding_rules(cfg, mesh, global_batch=256)
    grad_bytes, split = _local_bytes(cfg, rules, mesh)
    leaves = len(list(ptf_flatten(pspecs.params_spec(cfg))))
    assert res["collective_calls"] == {
        "all-reduce": 5 * L + 3 * chunks + 2 + leaves + 1,
        "all-gather": 1, "reduce-scatter": 1, "all-to-all": 2}
    rows = Br * S * d * 2
    assert res["collective_bytes"]["all-reduce"] == (
        5 * L * rows + chunks * (Br * 512 * 4 + 2 * 2 * Br * 512 * 4)
        + 2 * 4 + grad_bytes + 4 * split)
    emb = cfg.vocab_size * d // 16 * 2
    assert res["collective_bytes"]["all-to-all"] == 2 * emb
    assert res["collective_bytes"]["all-gather"] == rows
    assert res["collective_bytes"]["reduce-scatter"] == rows // 16


@pytest.mark.parametrize("kernel", ["flash_attention", "ssd_chunk"])
def test_meta_backward_counts_one_call(kernel):
    """A meta call under grad of each differentiable kernel: the backward
    gives gradients of the inputs' shapes and dtypes, and an op counter
    sees one call of the forward at ``cost`` and one of the backward
    kernel at ``bwd_cost`` (nothing of what either runs inside)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_chunk as ssd_mod

    def t(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta",
                           requires_grad=True)
    if kernel == "flash_attention":
        args = (t(2, 48, 8, 32, dtype=torch.bfloat16),
                t(2, 64, 2, 32, dtype=torch.bfloat16),
                t(2, 64, 2, 16, dtype=torch.bfloat16))
        kw = dict(causal=True, window=8)
        want = (flash_mod.cost(*args, **kw), flash_mod.bwd_cost(*args, **kw))
        run = lambda: (ops.flash_attention(*args, **kw),)  # noqa: E731
    else:
        args = (t(6, 16, 4), t(6, 16, 4, 8), t(6, 16, 5), t(6, 16, 5))
        want = (ssd_mod.cost(*args[:3]), ssd_mod.bwd_cost(*args[:3]))
        run = lambda: ops.ssd_chunk(*args)  # noqa: E731
    with torch.enable_grad(), OpCost() as cost:
        outs = run()
        grads = torch.autograd.grad(outs, args, [torch.ones_like(o)
                                                 for o in outs])
    for g, a in zip(grads, args):
        assert (g.device.type, g.shape, g.dtype) == ("meta", a.shape,
                                                      a.dtype)
    calls = {k: (v["calls"], v["flops"], v["bytes"])
             for k, v in cost.kernel_calls.items()}
    assert calls == {kernel: (1, *want[0]), f"{kernel}_bwd": (1, *want[1])}


@pytest.mark.parametrize("kernel", ["moe_ffn", "paged_attention"])
def test_decode_only_kernels_refuse_grad_on_meta(kernel):
    """The decode-only kernels have no backward: their meta route raises
    under grad rather than cut the gradient."""
    from repro_torch.kernels import ops

    def t(*shape, grad=True, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta",
                           requires_grad=grad)
    with torch.enable_grad(), pytest.raises(NotImplementedError,
                                            match="no backward"):
        if kernel == "moe_ffn":
            ops.moe_ffn(t(1, 2, 8), t(1, 8, 4), t(1, 8, 4), t(1, 4, 8), [0])
        else:
            ops.paged_attention(t(1, 2, 8), t(2, 4, 1, 8), t(2, 4, 1, 8),
                                t(1, 2, grad=False, dtype=torch.int32),
                                t(1, grad=False, dtype=torch.int32))


def _flash_cost(B, Sq, Sk, H, KV, hd, causal, dtype=torch.bfloat16):
    q = torch.empty((B, Sq, H, hd), dtype=dtype, device="meta")
    k = torch.empty((B, Sk, KV, hd), dtype=dtype, device="meta")
    return flash_mod.cost(q, k, k, causal=causal, window=0)[0]


@pytest.mark.parametrize("arch,shape", [
    ("whisper-tiny", "decode_32k"), ("llama-3.2-vision-11b", "prefill_32k")])
def test_dryrun_cross_families_on_the_mesh(arch, shape, tmp_path, capsys):
    """The encdec and vlm families run on the (16, 16) mesh. Whisper-tiny
    is tiny (its weights whole, data parallel only): a decode step of its
    8 rows a rank launches one cross call a decoder layer, 1 query over
    1500 frames at all 6 heads, and gathers the logits' rows, nothing
    else. Llama-3.2-Vision's prefill of 2 rows a rank: 40 self-attention
    calls (2 query heads over 1 KV head, causal) and 8 cross calls (2
    heads over 1601 patches, non-causal), each at ``flash_attention.cost``
    of the rank's shapes; 88 all-reduces of the rank's [2, 32768, 4096]
    bf16 rows (after ``wo`` in 40 self-attention and 8 cross layers, and
    after ``w2`` in 40 FFNs), and the embedding's, the logits' and the
    rows' gathers."""
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", arch, "--shape", shape, "--out",
                        str(out)]) == 0
    assert "1 ok, 0 failed" in capsys.readouterr().out
    (res,) = json.loads(out.read_text())["results"]
    cfg = pcfg.get_config(arch)
    flash = res["kernel_calls"]["flash_attention"]
    if arch == "whisper-tiny":
        B, V = INPUT_SHAPES[shape].global_batch // 16, cfg.vocab_size
        assert flash["calls"] == cfg.num_layers
        assert flash["flops"] == cfg.num_layers * _flash_cost(
            B, 1, cfg.encoder_frames, 6, 6, 64, False)
        assert res["collective_calls"] == {"all-gather": 1}
        assert res["collective_bytes"] == {"all-gather": 16 * B * V * 4}
        return
    B, S, d = 2, INPUT_SHAPES[shape].seq_len, cfg.d_model
    assert flash["calls"] == 48
    assert flash["flops"] == 40 * _flash_cost(B, S, S, 2, 1, 128, True) \
        + 8 * _flash_cost(B, S, cfg.num_image_tokens, 2, 2, 128, False)
    assert res["collective_calls"] == {"all-reduce": 88, "all-gather": 3}
    assert res["collective_bytes"]["all-reduce"] == 88 * B * S * d * 2 \
        == 47_244_640_256
