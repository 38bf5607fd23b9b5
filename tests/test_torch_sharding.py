"""The port's sharding rules against the JAX package's, and its sharded
entry points in a one-rank gloo group against the unsharded ones.

The rules read a mesh through its axis names and sizes only, so one
stand-in object serves both packages: ``sharding_rules``,
``param_pspecs`` and ``decode_state_pspecs`` equal the JAX package's for
every arch of the registry on the production meshes (16, 16) and
(2, 16, 16) and on (2, 4); ``padded_count`` / ``_head_padding`` agree on
a table of head counts. ``shard_params`` cuts a tree that the blocks of
every rank of a (2, 4) mesh put back together bitwise. In a one-rank
group (a real gloo process group and (1, 1) device mesh) every sharded
entry point equals its unsharded self: bitwise where the arithmetic is
the same (prefill, forward, EP against ``moe_capacity``), and within
fp32 noise where the decode combines its softmax across the model axis.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config, list_archs, reduced
from repro.launch import mesh as jmesh
from repro.launch import specs as jspecs
from repro.models import attention as jattn
from repro.models import sharding as jshd
from repro.models import transformer as jtf
import repro_torch.configs as pcfg
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import specs as pspecs
from repro_torch.models import attention as pattn
from repro_torch.models import moe as pmoe
from repro_torch.models import sharding as pshd
from repro_torch.models import ssm as pssm
from repro_torch.models import transformer as ptf

from _torch_dist_ranks import per_row_decodes

# the rules of tests/test_distributed.py (sharding_rules would leave the
# reduced configs' weights whole: d_model x layers is below its cut)
RULES = {"batch": ("data",), "model": "model", "heads": "model",
         "vocab": "model", "experts": "model", "capacity": "data",
         "shard_kv": True, "experts_mode": "ep", "_data_size": 1}
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model"))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StandInMesh:
    """What both packages' rules read of a mesh: JAX's ``axis_names`` and
    ``shape`` mapping, the port's ``mesh_dim_names`` and ``size(i)``;
    ``get_local_rank`` gives one rank's coordinates for ``shard_params``."""

    def __init__(self, shape, names, coords=None):
        self.axis_names = self.mesh_dim_names = tuple(names)
        self.shape = dict(zip(names, shape))
        self.coords = dict(zip(names, coords or [0] * len(names)))

    def size(self, i):
        return self.shape[self.mesh_dim_names[i]]

    def get_local_rank(self, name):
        return self.coords[name]


def _spec(p):
    """A spec as a tuple with a one-name tuple entry written as the name:
    JAX's PartitionSpec writes ("data",) as "data", the port keeps the
    rule's value; both split the dim over the same axis."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in p)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _spec_leaves(specs, like):
    """The spec tree's leaves at the places of ``like``'s leaves."""
    out = {}

    def walk(s, t, path):
        if isinstance(t, dict):
            for k in t:
                walk(s[k], t[k], f"{path}/{k}")
        elif isinstance(t, (tuple, list)):
            for i, (a, b) in enumerate(zip(s, t)):
                walk(a, b, f"{path}/{i}")
        else:
            out[path] = s
    walk(specs, like, "")
    return out


def _port_cfg(arch, **kw):
    return dataclasses.replace(pcfg.reduced(pcfg.get_config(arch), **kw),
                               dtype="float32")


def _jax_cfg(arch, **kw):
    return dataclasses.replace(reduced(get_config(arch), **kw),
                               dtype="float32")


# --------------------------------------------------------------- rules
@pytest.mark.parametrize("shape,names", MESHES,
                         ids=["16x16", "2x16x16", "2x4"])
@pytest.mark.parametrize("arch", list_archs())
def test_sharding_rules_match_reference(arch, shape, names):
    mesh = StandInMesh(shape, names)
    for kw in ({}, {"global_batch": 1}, {"global_batch": 64},
               {"baseline": True}):
        want = jmesh.sharding_rules(get_config(arch), mesh, **kw)
        got = pmesh.sharding_rules(pcfg.get_config(arch), mesh, **kw)
        assert got == want, kw
        axes = ("batch", None, "heads", "vocab", "experts", "capacity")
        with jshd.sharding_ctx(mesh, want):
            jspec = jshd.logical_to_spec(*axes)
        with pshd.sharding_ctx(mesh, got):
            assert _spec(pshd.logical_to_spec(*axes)) == _spec(jspec)
    assert pmesh.batch_axes(mesh) == jmesh.batch_axes(mesh)


@pytest.mark.parametrize("arch", list_archs())
def test_param_pspecs_match_reference(arch):
    """Leaf for leaf on the arch's reduced params (JAX ``init_params``,
    bridged), unsanitized and sanitized against each mesh."""
    cfg = _jax_cfg(arch)
    jp = jtf.init_params(cfg, jax.random.PRNGKey(0))
    tp = ptf.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    for shape, names in MESHES:
        mesh = StandInMesh(shape, names)
        rules = jmesh.sharding_rules(get_config(arch), mesh)
        for m in (None, mesh):
            want = jshd.param_pspecs(jp, rules, mesh=m)
            got = pshd.param_pspecs(tp, rules, mesh=m)
            flat = jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda s: isinstance(
                    s, jax.sharding.PartitionSpec))[0]
            w = {"/" + "/".join(str(getattr(k, "key", getattr(k, "idx", "")))
                                for k in path): _spec(v) for path, v in flat}
            g = {k: _spec(v) for k, v in _spec_leaves(got, tp).items()}
            assert g == w and len(g) > 0
            shapes = dict(_leaves(tp))
            assert all(len(g[k]) == shapes[k].ndim for k in g)


def _state_specs(arch, mesh, shape):
    """The JAX and port decode-state specs of a reduced ``arch``, each
    state built under its package's context (so GQA KV heads pad)."""
    jcfg, pc = _jax_cfg(arch), _port_cfg(arch)
    rules = jmesh.sharding_rules(get_config(arch), mesh)
    jp = jax.eval_shape(lambda: jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    with jshd.sharding_ctx(mesh, rules):
        jstate = jax.eval_shape(lambda p: jtf.init_decode_state(p, jcfg, 2,
                                                                16), jp)
    want = jspecs.decode_state_pspecs(jstate, rules, mesh)
    tp = ptf.init_params(pc, torch.Generator().manual_seed(0), device="meta")
    with pshd.sharding_ctx(mesh, rules):
        pstate = ptf.init_decode_state(tp, pc, 2, 16, device="meta")
    got = pspecs.decode_state_pspecs(pstate, rules, mesh)
    return jstate, want, pstate, got


@pytest.mark.parametrize("shape,names", MESHES,
                         ids=["16x16", "2x16x16", "2x4"])
@pytest.mark.parametrize("arch", ["qwen1.5-32b", "qwen2.5-3b",
                                  "deepseek-v2-236b", "mixtral-8x7b"])
def test_decode_state_pspecs_match_reference(arch, shape, names):
    """Dense MHA (heads padded), dense GQA with 2 KV heads, the MoE with
    MLA's latent cache and the MoE with GQA: each of the port's per-layer
    leaves has the JAX stacked leaf's spec without its layer entry, and
    the same padded shape."""
    mesh = StandInMesh(shape, names)
    jstate, want, pstate, got = _state_specs(arch, mesh, shape)
    assert set(want) == set(got) == {"layers"}
    for name, js in want["layers"].items():
        jshape = jstate["layers"][name].shape
        for layer in got["layers"]:
            assert _spec(layer[name]) == _spec(js)[1:], name
        for layer in pstate["layers"]:
            assert tuple(layer[name].shape) == tuple(jshape[1:]), name
    rules = jmesh.sharding_rules(get_config(arch), mesh)
    want_b = jspecs.batch_pspecs(
        {"tokens": jax.ShapeDtypeStruct((4, 8), np.int32)}, rules)
    got_b = pspecs.batch_pspecs({"tokens": torch.zeros(4, 8)}, rules)
    assert _spec(got_b["tokens"]) == _spec(want_b["tokens"])


@pytest.mark.parametrize("H,KV,axis,want", [
    (6, 6, 4, (8, 8)), (32, 8, 16, (32, 8)), (40, 40, 16, (48, 48)),
    (40, 8, 16, (48, 8)), (24, 2, 16, (32, 2)), (16, 2, 16, (16, 2)),
    (6, 2, 4, (8, 2)), (128, 128, 16, (128, 128)), (4, 2, 1, (4, 2))])
def test_head_padding_matches_reference(H, KV, axis, want):
    mesh = StandInMesh((1, axis), ("data", "model"))
    rules = {"model": "model"}
    with jshd.sharding_ctx(mesh, rules):
        j = (jshd.padded_count(H), jattn._head_padding(H, KV))
    with pshd.sharding_ctx(mesh, rules):
        p = (pshd.padded_count(H), pattn._head_padding(H, KV))
    assert p == j == (want[0], want)
    with pshd.sharding_ctx(mesh, dict(rules, pad_heads=False)):
        assert pshd.padded_count(H) == H
    assert pshd.padded_count(H) == H        # no mesh


def test_shard_params_blocks_reassemble_bitwise():
    """Every rank's ``shard_params`` blocks of a reduced DeepSeek-V2 (MLA,
    shared expert, 4 experts split over the model axis) on a (2, 4)
    mesh, concatenated along each leaf's split dims in rank order, give
    the whole tree back bit for bit; a leaf that is not split is whole on
    every rank."""
    cfg = _jax_cfg("deepseek-v2-236b", layers=2, d_model=64)
    tp = ptf.from_jax_params(jax.tree.map(
        np.asarray, jtf.init_params(cfg, jax.random.PRNGKey(1))),
        device="cpu")
    shape, names = (2, 4), ("data", "model")
    rules = RULES
    specs = pshd.param_pspecs(tp, rules, StandInMesh(shape, names))
    blocks = {(i, j): pshd.shard_params(
        tp, StandInMesh(shape, names, (i, j)), rules)
        for i in range(2) for j in range(4)}
    whole = dict(_leaves(tp))
    spec = _spec_leaves(specs, tp)
    split = 0
    for path, leaf in whole.items():
        parts = {c: dict(_leaves(b))[path] for c, b in blocks.items()}
        dims = [d for d, a in enumerate(spec[path]) if a is not None]
        assert all(a == "model" for a in spec[path] if a is not None)
        if not dims:
            assert all(torch.equal(p, leaf) for p in parts.values()), path
            continue
        split += 1
        (dim,) = dims
        for i in range(2):
            back = torch.cat([parts[(i, j)] for j in range(4)], dim=dim)
            assert back.dtype == leaf.dtype
            assert torch.equal(back, leaf), path
    assert split >= 8


# --------------------------------------------- one-rank process group
@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A real one-rank gloo group and its (1, 1) ("data", "model") mesh."""
    store = tmp_path_factory.mktemp("gloo") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield pmesh.make_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


def _model(arch, seed, **kw):
    cfg = _jax_cfg(arch, **kw)
    jp = jtf.init_params(cfg, jax.random.PRNGKey(seed))
    return _port_cfg(arch, **kw), ptf.from_jax_params(
        jax.tree.map(np.asarray, jp), device="cpu")


def _first_mixers(params, cfg):
    """{kind: the first block's mixer as a function of (params, x,
    positions)} for each mixer kind ("attn": ``gqa_full`` or
    ``mla_full``, "ssm": ``ssd_full``)."""
    full = pattn.mla_full if cfg.use_mla else pattn.gqa_full
    paths = {}
    for path, kind in ptf._blocks(params, cfg):
        paths.setdefault(kind, path)

    def mixer(kind, path):
        if kind == "attn":
            return lambda p, x, pos: full(
                ptf._block_params(p, path)["attn"], cfg, x, pos)
        return lambda p, x, pos: pssm.ssd_full(
            ptf._block_params(p, path)["ssm"], cfg, x)
    return {kind: mixer(kind, path) for kind, path in paths.items()}


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-236b",
                                  "qwen2.5-3b", "mamba2-2.7b",
                                  "jamba-1.5-large-398b"])
def test_one_rank_entry_points_equal_unsharded(one_rank, arch):
    """``prefill`` and ``forward`` bitwise; the first layer of each mixer
    kind (``gqa_full`` / ``mla_full`` / ``ssd_full``) bitwise; 6
    ``decode_step``s within 1e-6 (the sharded attention decode combines
    its softmax as the sequence-split path does; the SSM's split norm
    takes the mean of one block mean, which is the mean)."""
    cfg, tp = _model(arch, 3, layers=2, d_model=64, vocab=128)
    rules = RULES
    local = pshd.shard_params(tp, one_rank, rules)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 8)))
    want_pre, (want_h, want_aux) = (ptf.prefill(tp, cfg, toks),
                                    ptf.forward(tp, cfg, toks))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 8, 64)).astype(np.float32))
    pos = torch.arange(8)[None].expand(2, 8)
    mixers = _first_mixers(tp, cfg)
    want_mix = {kind: fn(tp, x, pos) for kind, fn in mixers.items()}
    steps = np.random.default_rng(2).integers(0, 128, (2, 6))
    state = ptf.init_decode_state(tp, cfg, 2, 8, device="cpu")
    want_dec = []
    for i in range(6):
        lg, state = ptf.decode_step(tp, cfg, state, torch.from_numpy(
            steps[:, i:i + 1]), i)
        want_dec.append(lg)
    with pshd.sharding_ctx(one_rank, rules):
        assert torch.equal(ptf.prefill(local, cfg, toks), want_pre)
        h, aux = ptf.forward(local, cfg, toks)
        assert torch.equal(h, want_h) and torch.equal(aux, want_aux)
        for kind, fn in mixers.items():
            assert torch.equal(fn(local, x, pos), want_mix[kind]), kind
        state = pspecs.shard_decode_state(
            ptf.init_decode_state(local, cfg, 2, 8, device="cpu"),
            one_rank, rules)
        for i in range(6):
            got, state = ptf.decode_step(local, cfg, state, torch.from_numpy(
                steps[:, i:i + 1]), i)
            np.testing.assert_allclose(got, want_dec[i], rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-236b"])
def test_one_rank_decode_past_the_cache_raises(one_rank, arch):
    """Without a window, a position past the cache's last slot raises
    IndexError under the mesh as it does unsharded (no silent skip of
    the write); with a window the same position wraps into the ring."""
    cfg, tp = _model(arch, 4, layers=1, d_model=64, vocab=128)
    layer = ptf._layer(tp["layers"], 0)["attn"]
    decode = pattn.mla_decode if cfg.use_mla else pattn.gqa_decode
    init = pattn.mla_cache_init if cfg.use_mla else pattn.gqa_cache_init
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 1, 64)).astype(np.float32))
    with pytest.raises(IndexError, match="out of bounds"):
        decode(layer, cfg, x, init(cfg, 2, 4, torch.float32, "cpu"), 4)
    local = pshd.shard_params(layer, one_rank, RULES)
    with pshd.sharding_ctx(one_rank, RULES):
        with pytest.raises(IndexError, match="out of bounds"):
            decode(local, cfg, x, init(cfg, 2, 4, torch.float32, "cpu"), 4)
        y, _ = decode(local, cfg, x, init(cfg, 2, 4, torch.float32, "cpu"),
                      4, window=4)
    assert torch.isfinite(y).all()


def test_one_rank_moe_paths_equal_unsharded(one_rank, monkeypatch):
    """4096 tokens of a reduced Mixtral (8 experts, top-2): ``auto`` takes
    EP under the mesh, and EP is bitwise ``moe_capacity`` (one rank: the
    same dispatch, capacity and products; the exchanges move the buffer
    unchanged); ``moe_apply(path="ep")`` no longer raises; the dense,
    gather and capacity paths under the mesh (experts split "ep" and
    "tp") are bitwise their unsharded selves."""
    cfg, tp = _model("mixtral-8x7b", 5, layers=1, d_model=64, experts=8)
    p = ptf._layer(tp["layers"], 0)["moe"]
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 2048, 64)).astype(np.float32))
    want = pmoe.moe_capacity(p, cfg, x)
    inputs = {"capacity": x, "dense": x[:, :64], "gather": x[:, :64]}
    refs = {path: pmoe.moe_apply(p, cfg, xs, path=path)
            for path, xs in inputs.items()}
    ep_calls = []
    orig = pmoe.moe_ep_shardmap
    monkeypatch.setattr(pmoe, "moe_ep_shardmap",
                        lambda *a, **k: ep_calls.append(1) or orig(*a, **k))
    for mode in ("ep", "tp"):
        rules = dict(RULES, experts_mode=mode)
        local = pshd.shard_params(p, one_rank, rules)
        with pshd.sharding_ctx(one_rank, rules):
            if mode == "ep":
                got = pmoe.moe_apply(local, cfg, x)
                assert ep_calls == [1]
                assert torch.equal(got[0], want[0])
                assert torch.equal(got[1], want[1])
                got = pmoe.moe_apply(local, cfg, x, path="ep")
                assert torch.equal(got[0], want[0])
            for path, xs in inputs.items():
                got = pmoe.moe_apply(local, cfg, xs, path=path)
                assert torch.equal(got[0], refs[path][0]), (mode, path)
                assert torch.equal(got[1], refs[path][1]), (mode, path)


@pytest.mark.parametrize("arch", ["whisper-tiny", "llama-3.2-vision-11b"])
def test_one_rank_cross_families_equal_unsharded(one_rank, arch):
    """The encdec and vlm families at one rank: ``encoder_forward``,
    ``prefill`` and ``forward`` bitwise the unsharded ones (the rank's
    heads are every head, the all-reduces leave one rank's values as
    they are), and 6 ``decode_step``s within 1e-6 with the state built
    whole under the mesh and cut by ``shard_decode_state``."""
    cfg, tp = _model(arch, 4, layers=2, d_model=64, vocab=128)
    rules = RULES
    local = pshd.shard_params(tp, one_rank, rules)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, 128, (2, 8)))
    T = cfg.encoder_frames if cfg.family == "encdec" else \
        cfg.num_image_tokens
    fe = torch.from_numpy(rng.normal(size=(2, T, 64)).astype(np.float32))
    enc = ptf.encoder_forward(tp, cfg, fe) if cfg.family == "encdec" \
        else fe
    want_pre, (want_h, _) = (ptf.prefill(tp, cfg, toks, enc=enc),
                             ptf.forward(tp, cfg, toks, enc=enc))
    steps = rng.integers(0, 128, (2, 6))
    state = ptf.init_decode_state(tp, cfg, 2, 8, enc=enc, device="cpu")
    want_dec = []
    for i in range(6):
        lg, state = ptf.decode_step(tp, cfg, state, torch.from_numpy(
            steps[:, i:i + 1]), i)
        want_dec.append(lg)
    with pshd.sharding_ctx(one_rank, rules):
        if cfg.family == "encdec":
            assert torch.equal(ptf.encoder_forward(local, cfg, fe), enc)
        assert torch.equal(ptf.prefill(local, cfg, toks, enc=enc), want_pre)
        assert torch.equal(ptf.forward(local, cfg, toks, enc=enc)[0], want_h)
        state = pspecs.shard_decode_state(
            ptf.init_decode_state(tp, cfg, 2, 8, enc=enc, device="cpu"),
            one_rank, rules)
        for i in range(6):
            got, state = ptf.decode_step(local, cfg, state, torch.from_numpy(
                steps[:, i:i + 1]), i)
            np.testing.assert_allclose(got, want_dec[i], rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("arch,mla_seq_shard", [
    ("mixtral-8x7b", True), ("deepseek-v2-236b", False),
    ("deepseek-v2-236b", True)])
def test_unported_families_raise_under_a_mesh(one_rank, arch, mla_seq_shard):
    """The per-row and paged decodes (ROADMAP A18, once refused under a
    mesh) at one rank: 5 calls of 3 staggered rows, each bitwise its
    plain run, the cache built under the mesh (the rank's heads are every
    head and the all-reduces leave one rank's values as they are). MLA's
    dense per-row decode over a sequence-split cache combines its softmax
    across the (one) model rank, so there it is held within 1e-6; its
    paged pool is whole and bitwise. The production mesh still needs its
    256 ranks."""
    cfg, tp = _model(arch, 6, layers=1, d_model=64, vocab=128)
    layer = ptf._layer(tp["layers"], 0)["attn"]
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(5, 3, 1, 64)).astype(np.float32))
    pos = np.array([0, 3, 9])
    tables = torch.tensor([[4, 1, 6, 0], [2, 5, 3, 8], [7, 9, 10, 11]],
                          dtype=torch.int32)
    rules = dict(RULES, mla_seq_shard=mla_seq_shard)
    local = pshd.shard_params(layer, one_rank, rules)
    for paged in (False, True):
        want = per_row_decodes(layer, cfg, x, pos, tables, paged=paged)
        with pshd.sharding_ctx(one_rank, rules):
            got = per_row_decodes(local, cfg, x, pos, tables, paged=paged)
        if cfg.use_mla and mla_seq_shard and not paged:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(got, want), (arch, paged)
    with pytest.raises(RuntimeError, match="256 ranks"):
        pmesh.make_production_mesh(device_type="cpu")
