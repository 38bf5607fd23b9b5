"""Training under a (data 2, model 4) mesh of 8 CPU processes under gloo,
against the unsharded training of both packages.

Each rank runs ``train_loop.loss_and_grads`` and one ``make_train_step``
step on ``shard_params``' slices of the whole params, with the whole
batch of 4 distinct rows (2 a rank): its rows, heads, ff blocks,
experts and vocab block, every collective differentiated by its
transpose, the gradients summed over the mesh axes their leaf is not
split on, and AdamW on its blocks with the global norm of the whole
gradient. One spawn runs every case (its parts):

* dense (Qwen2.5 reduced, untied: 8 query heads over 2 KV heads, which
  do not split over 4, so each rank takes the KV heads its query heads
  group with, ``_rank_heads``; the vocab-split unembedding);
* Qwen1.5 reduced (tied embeddings: the embedding's d blocks turned into
  vocab blocks by an all-to-all for the cross entropy);
* Mixtral reduced, 8 experts: ``moe_capacity`` with the experts split
  over the model axis (EP rules), and ``moe_ep_shardmap`` (its two
  exchanges and their reverses); 6 experts, which 4 does not divide,
  with the experts' ff dim split ("tp" rules). Capacity factors E / k:
  nothing drops, on the whole batch or on a rank's tokens. The
  shardmap's aux is the mean of the ranks' losses, which no unsharded
  path computes, so that case weighs the aux 0 in both packages;
* MLA (DeepSeek-V2 reduced, 8 experts with a shared one);
* Mamba2 and Jamba reduced (8 SSM heads of 16, state 16: B and C on the
  last model rank, redistributed after the conv);
* Whisper reduced under ``sharding_rules``' own rules (tiny: data
  parallel, no weight split) and under explicit rules with a model axis;
* Llama-3.2-Vision reduced (a cross layer every 2nd).

DeepSeek-V2 and Jamba are ``zero1`` configs: their moments come from
``init_opt_state``, cut on the data axis too (``opt_state_pspecs`` at the
rules' ``_data_size`` of 2), so each such leaf's gradient is
reduce-scattered over "data", AdamW updates the rank's block and the
blocks are all-gathered back into the param. Those two run again on a
(pod 2, data 2, model 2) mesh, the batch split over ("pod", "data"), where
the pod all-reduce follows the data reduce-scatter.

Every bias leaf is redrawn N(0, 0.5) before bridging (zero biases would
hide a bias added on every rank). Limits, fp32:

* the loss on every rank, bitwise the same, within 1e-5 (relative) of
  the unsharded port's and at ``test_torch_training``'s limit (rtol
  1e-4) of ``jax.value_and_grad``'s;
* the gradients gathered whole: within 1e-5 x max |g| of the unsharded
  port's, and JAX's at GRAD_RTOL / GRAD_ATOL_FRAC; their global norm
  within 1e-5 (relative) of the unsharded one, and above the clip (1.0),
  so the clip is active;
* after one AdamW step, the params gathered whole within what the
  gradients explain of the unsharded step's (``chip_smoke.py``'s
  STEP_TOL rule for fp32: AdamW's first step is g / (|g| + eps), so a
  param moves at most 2 |dg| / |g| of lr more, and at most 2 lr where a
  near-zero gradient's sign differs, plus 1e-6 of |p|); the moments
  gathered whole by the same rule (m = (1 - b1) g s and v = (1 - b2)
  (g s)^2 after a first step, s the clip's scale: each moves by what
  the gradient's difference and the norm's explain, plus 1e-6 of its
  size); and every rank's gathered tree, its whole leaves too, bitwise
  the same.

Besides, on a one-rank gloo group: a train step under the (1, 1) mesh is
bitwise the step without one, for each family, the moments too (for the
two ZeRO-1 configs every leaf of 2 dims or more is then a one-block
ZeRO-1 leaf: the reduce-scatter and all-gather run at one rank).
"""
import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.configs as pcfg
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import transformer as jtf
from repro_torch.launch import mesh as pmesh
from repro_torch.models import moe as pmoe
from repro_torch.models import sharding as pshd
from repro_torch.models import transformer as ptf
from repro_torch.training import (AdamWConfig, adamw_init, init_opt_state,
                                  make_train_step)
from repro_torch.training import train_loop
from repro_torch.training.optimizer import global_norm
from repro_torch.training.tree import flatten

from test_torch_distributed import (MESH, MIN_MARGIN, RANK_TIMEOUT_S, ROOT,
                                    RULES, WORLD)
from test_torch_distributed_cross import VISION, WHISPER, _with_biases
from test_torch_distributed_ssm import JAMBA, SSM
from test_torch_training import GRAD_ATOL_FRAC, GRAD_RTOL

B, S, LR, SEED = 4, 16, 1e-3, 40
POD_MESH = (2, 2, 2)     # ("pod", "data", "model")
POD_RULES = dict(RULES, batch=["pod", "data"])
ZERO1 = ("mla", "hybrid")
JAX_WORKERS = 4
PORT_TOL = 1e-5       # loss relative; gradients x max |g|; the norm
STEP_TOL = (1e-4, 1e-4, 1e-6)   # chip_smoke.py's fp32 row
MOE = dict(reduce=dict(layers=2, d_model=64, experts=8, vocab=128),
           replace=dict(dtype="float32", num_experts_per_tok=2,
                        capacity_factor=4.0))
# name: (arch, spec, rules (None: sharding_rules' own), moe_path, extra)
CASES = {
    "dense": ("qwen2.5-3b", dict(
        reduce=dict(layers=2, d_model=64, vocab=128),
        replace=dict(dtype="float32", num_heads=8, num_kv_heads=2,
                     head_dim=8, tie_embeddings=False)), RULES, "auto", {}),
    "qwen_tied": ("qwen1.5-0.5b", dict(
        reduce=dict(layers=2, d_model=64, vocab=128),
        replace=dict(dtype="float32")), RULES, "auto", {}),
    "moe_ep": ("mixtral-8x7b", MOE, RULES, "capacity", {}),
    "moe_shardmap": ("mixtral-8x7b", MOE, RULES, "ep",
                     {"aux_weight": 0.0}),
    "moe_tp": ("mixtral-8x7b", dict(
        reduce=dict(MOE["reduce"], experts=6),
        replace=dict(MOE["replace"], capacity_factor=3.0)),
        dict(RULES, experts_mode="tp"), "capacity", {}),
    "mla": ("deepseek-v2-236b", dict(
        reduce=dict(layers=2, d_model=64, experts=8, vocab=128),
        replace=dict(dtype="float32")), RULES, "dense", {}),
    "ssm": ("mamba2-2.7b", dict(
        reduce=dict(layers=2, d_model=64, vocab=128), replace=SSM),
        RULES, "auto", {}),
    "hybrid": ("jamba-1.5-large-398b", JAMBA, RULES, "auto", {}),
    "whisper_dp": ("whisper-tiny", WHISPER, None, "auto", {}),
    "whisper_tp": ("whisper-tiny", WHISPER, RULES, "auto", {}),
    "vision": ("llama-3.2-vision-11b", VISION, RULES, "auto", {}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(name):
    arch, spec, *_ = CASES[name]
    return dataclasses.replace(jreduced(jget_config(arch), **spec["reduce"]),
                               **spec["replace"])


def _batch(cfg, rng):
    """A numpy batch of B distinct rows (and the frames or patches)."""
    nb = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
          "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    assert len({tuple(r) for r in nb["tokens"]}) == B
    if cfg.family == "encdec":
        nb["frames"] = rng.normal(size=(B, cfg.encoder_frames, cfg.d_model))
    elif cfg.family == "vlm":
        nb["patches"] = rng.normal(size=(B, cfg.num_image_tokens,
                                         cfg.d_model))
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v
            for k, v in nb.items()}


def _jax_case(name, seed):
    """The JAX side of a case (run in a worker process): (its params,
    JAX ``init_params`` with every bias redrawn, as numpy; the numpy
    batch; ``jax.value_and_grad``'s loss and gradients by key, on
    ``moe_dense`` for the shardmap case, with its aux weight)."""
    _, _, _, path, extra = CASES[name]
    cfg, rng = _jcfg(name), np.random.default_rng(seed)
    tree = _with_biases(jax.tree.map(np.asarray, jtf.init_params(
        cfg, jax.random.PRNGKey(seed))), rng)
    nb = _batch(cfg, rng)
    aux = jtf.AUX_WEIGHT
    jtf.AUX_WEIGHT = extra.get("aux_weight", aux)
    try:
        loss, grads = jax.value_and_grad(lambda p: jtf.loss_fn(
            p, cfg, {k: jnp.asarray(v) for k, v in nb.items()},
            moe_path="dense" if path == "ep" else path))(
                jax.tree.map(jnp.asarray, tree))
    finally:
        jtf.AUX_WEIGHT = aux
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in key): np.asarray(v)
            for key, v in jax.tree_util.tree_flatten_with_path(grads)[0]}
    return tree, nb, float(loss), flat


class Case:
    """One config of the port, its params (a numpy tree: the JAX side's,
    or with ``tree`` None the port's own ``init_params`` with every bias
    redrawn) and its batch."""

    def __init__(self, name, seed, tree=None, nb=None):
        arch, spec, self.rules, self.path, self.extra = CASES[name]
        self.cfg = dataclasses.replace(
            pcfg.reduced(pcfg.get_config(arch), **spec["reduce"]),
            **spec["replace"])
        if tree is None:
            rng = np.random.default_rng(seed)
            tree = _with_biases(ptf.to_jax_params(ptf.init_params(
                self.cfg, torch.Generator().manual_seed(seed),
                device="cpu")), rng)
            nb = _batch(self.cfg, rng)
        self.tp = ptf.from_jax_params(tree, device="cpu")
        self.batch = {k: torch.from_numpy(v) for k, v in nb.items()}
        self.part = dict(kind="train", arch=arch, rules=self.rules,
                         moe_path=self.path, lr=LR, **spec, **self.extra)

    def port(self):
        """The unsharded port: (loss, grads by key, norm, stepped params by
        key and moments {"m", "v"} by key, or None), the shardmap case on
        ``moe_dense``."""
        path = "dense" if self.path == "ep" else self.path
        aux = ptf.AUX_WEIGHT
        ptf.AUX_WEIGHT = self.extra.get("aux_weight", aux)
        try:
            loss, grads = train_loop.loss_and_grads(self.tp, self.cfg,
                                                    self.batch,
                                                    moe_path=path)
            p = ptf._tree_map(torch.clone, self.tp)
            step = make_train_step(self.cfg, opt_cfg=AdamWConfig(lr=LR),
                                   moe_path=path)
            p, st, _ = step(p, adamw_init(p), self.batch)
        finally:
            ptf.AUX_WEIGHT = aux
        return (loss, dict(flatten(grads)), global_norm(grads),
                dict(flatten(p)), {k: dict(flatten(st[k])) for k in "mv"})


def _start_ranks(tmp, parts, inputs, mesh=MESH, axes=("data", "model")):
    torch.save(inputs, tmp / "inputs.pt")
    case = dict(kind="parts", parts=parts, mesh=list(mesh), axes=list(axes),
                store=f"file://{tmp}/store", inputs=str(tmp / "inputs.pt"))
    (tmp / "case.json").write_text(json.dumps(case))
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_dist_ranks.py"),
         str(tmp / "case.json"), str(r), str(WORLD)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]


def _collect(tmp, procs):
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
    return [torch.load(tmp / f"out-{r}.pt", weights_only=True)
            for r in range(WORLD)]


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(cases, the unsharded references, rank 0's outputs): the ranks run
    while the unsharded port computes its references."""
    # the JAX sides in worker processes, the slowest first; Whisper's two
    # cases share one (the same config, params and batch)
    jobs = {"whisper_tp": "whisper_dp"}
    with ProcessPoolExecutor(
            JAX_WORKERS, mp_context=multiprocessing.get_context("spawn")) as ex:
        futs = {n: ex.submit(_jax_case, n, SEED) for n in CASES
                if n not in jobs}
        sides = {n: futs[jobs.get(n, n)].result() for n in CASES}
    cases = {n: Case(n, SEED, tree, nb)
             for n, (tree, nb, _, _) in sides.items()}
    tmp = tmp_path_factory.mktemp("train")
    procs = _start_ranks(tmp, {n: c.part for n, c in cases.items()},
                         {n: {"params": c.tp, "batch": c.batch}
                          for n, c in cases.items()})
    margins = []
    orig = pmoe.router_probs

    def router_probs(p, cfg, x):
        out = orig(p, cfg, x)
        k = cfg.num_experts_per_tok
        srt = torch.sort(out[0], dim=-1, descending=True).values
        margins.append(float((srt[..., k - 1] - srt[..., k]).min().detach()))
        return out

    pmoe.router_probs = router_probs
    try:
        refs = {n: (c.port(), sides[n][2:]) for n, c in cases.items()}
    finally:
        pmoe.router_probs = orig
    outs = _collect(tmp, procs)
    for o in outs[1:]:
        for n in CASES:
            assert _same(o[n], outs[0][n]), n
    assert min(margins) > MIN_MARGIN, min(margins)
    return cases, refs, outs[0]


@pytest.fixture(scope="module")
def trained_pod(trained, tmp_path_factory):
    """Rank 0's outputs of the ZeRO-1 cases on the (2, 2, 2) mesh, from
    the same params and batches (every rank's outputs bitwise the same)."""
    cases = trained[0]
    parts = {n: dict(cases[n].part, rules=POD_RULES) for n in ZERO1}
    tmp = tmp_path_factory.mktemp("train_pod")
    procs = _start_ranks(tmp, parts, {n: {"params": cases[n].tp,
                                          "batch": cases[n].batch}
                                      for n in ZERO1},
                         POD_MESH, ("pod", "data", "model"))
    outs = _collect(tmp, procs)
    for o in outs[1:]:
        for n in ZERO1:
            assert _same(o[n], outs[0][n]), n
    return outs[0]


def check_step(name, c, o, ref, jref):
    """One case's rank outputs ``o`` against the unsharded port ``ref``
    and JAX ``jref`` (the limits of the module's docstring)."""
    loss, grads, norm, params, moments = ref
    jloss, jgrads = jref
    assert o["specs_match"] and o["flash_strided"] == []
    assert (o["zero1_leaves"] > 0) == c.cfg.zero1, o["zero1_leaves"]
    for got in (o["loss"], o["step_loss"]):
        np.testing.assert_allclose(float(got), float(loss), rtol=PORT_TOL)
        np.testing.assert_allclose(float(got), jloss, rtol=GRAD_RTOL)
    got = dict(flatten(o["grads"]))
    assert sorted(got) == sorted(grads) == sorted(jgrads)
    top = max(float(g.abs().max()) for g in grads.values())
    jtop = max(float(np.abs(g).max()) for g in jgrads.values())
    for k, g in got.items():
        assert g.shape == grads[k].shape, k
        err = float((g - grads[k]).abs().max())
        assert err <= PORT_TOL * top, (k, err, top)
        np.testing.assert_allclose(g.numpy(), jgrads[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_FRAC * jtop, err_msg=k)
    print(f"{name}: loss {float(o['loss'])} vs {float(loss)}, "
          f"norm {float(o['norm'])} vs {float(norm)}")
    np.testing.assert_allclose(float(o["norm"]), float(norm), rtol=PORT_TOL)
    opt = AdamWConfig()
    assert float(norm) > opt.grad_clip      # the clip is active
    norm_err = abs(float(o["norm"]) - float(norm)) / float(norm)
    scale = opt.grad_clip / float(norm)
    _, _, p_tol = STEP_TOL
    for k, p in dict(flatten(o["params"])).items():
        want, dg = params[k], (got[k] - grads[k]).abs()
        sens = 2 * (dg / grads[k].abs().clamp_min(1e-30) + norm_err)
        allowed = LR * sens.clamp(max=2.0) + p_tol * (want.abs() + LR)
        d = (p - want).abs()
        assert bool((d <= allowed).all()), (k, float((d - allowed).max()))
    for key, b in (("m", opt.b1), ("v", opt.b2)):
        for k, m in dict(flatten(o["moments"][key])).items():
            want, m = moments[key][k].double(), m.double()
            g = grads[k].double().abs()
            dg = got[k].double() - grads[k].double()
            assert m.shape == want.shape, (key, k)
            # |g' s' - g s|, s the clip's scale
            e = scale * (dg.abs() + 2 * norm_err * g)
            moved = e if key == "m" else e * (2 * scale * g + e)
            allowed = (1 - b) * moved + p_tol * (want.abs() + m.abs())
            d = (m - want).abs()
            assert bool((d <= allowed).all()), (key, k,
                                                float((d - allowed).max()))


@pytest.mark.parametrize("name", list(CASES))
def test_train_under_the_mesh_matches_unsharded(trained, name):
    cases, refs, outs = trained
    check_step(name, cases[name], outs[name], *refs[name])


@pytest.mark.parametrize("name", ZERO1)
def test_zero1_on_the_pod_mesh_matches_unsharded(trained, trained_pod,
                                                  name):
    """The ZeRO-1 configs on (pod 2, data 2, model 2): the same limits."""
    cases, refs, _ = trained
    check_step(name, cases[name], trained_pod[name], *refs[name])


# ---------------------------------------------------- one rank: bitwise
@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo group and its (1, 1) ("data", "model") mesh."""
    store = tmp_path_factory.mktemp("gloo1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield pmesh.make_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


def _one_rank_runs(c, rules, mesh, paths):
    """Two steps of case ``c`` under the one-rank ``mesh`` with ``rules``
    and two without one, each from ``c``'s params and zero moments
    (``init_opt_state``), on the moe path ``paths[where]``: (losses, the
    gradients the optimizer saw, params and moments after each step) of
    each."""
    runs = {}
    for where in ("plain", "mesh"):
        seen = []
        adamw = train_loop.adamw_update

        def keep(grads, *a, **kw):
            seen.append([g.clone() for _, g in flatten(grads)])
            return adamw(grads, *a, **kw)

        train_loop.adamw_update = keep
        try:
            p = ptf._tree_map(torch.clone, c.tp)
            ctx = (mesh, rules) if where == "mesh" else (None, {})
            if where == "mesh":
                p = pshd.shard_params(p, mesh, rules)
            with pshd.sharding_ctx(*ctx):
                st = init_opt_state(p, c.cfg)
            step = make_train_step(c.cfg, opt_cfg=AdamWConfig(lr=LR),
                                   moe_path=paths[where])
            losses, after = [], []
            for _ in range(2):
                with pshd.sharding_ctx(*ctx):
                    p, st, loss = step(p, st, c.batch)
                losses.append(loss)
                after.append([t.clone() for tree in (p, st["m"], st["v"])
                              for _, t in flatten(tree)])
        finally:
            train_loop.adamw_update = adamw
        runs[where] = (losses, seen, after)
    return runs


@pytest.mark.parametrize("name,mesh_path", [
    ("qwen_tied", "auto"), ("dense", "auto"), ("moe_ep", "ep"),
    ("ssm", "auto"), ("hybrid", "auto"), ("whisper_dp", "auto"),
    ("vision", "auto"), ("mla", "dense")])
def test_one_rank_mesh_step_is_bitwise_the_plain_step(one_rank, name,
                                                      mesh_path):
    """Two steps under the (1, 1) mesh (the published rules' kind: a
    model axis, or none for Whisper) from the same params and zero
    moments (``init_opt_state``) as two steps without one: the losses,
    the gradients the optimizer saw and the params and moments after
    each step bitwise equal. Mixtral takes ``moe_ep_shardmap`` under the
    mesh and ``moe_capacity`` without: at one rank the same dispatch, and
    the exchanges (and their reverses) move the buffers as they are.
    Jamba and DeepSeek-V2 take ZeRO-1 under the mesh: a one-block
    reduce-scatter and all-gather a leaf."""
    c = Case(name, 60)    # the port's own params
    rules = pmesh.sharding_rules(c.cfg, one_rank) if c.rules is None \
        else dict(c.rules, _data_size=1)
    runs = _one_rank_runs(c, rules, one_rank,
                          {"plain": c.path, "mesh": mesh_path})
    assert _same(runs["mesh"], runs["plain"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_rank_zero1_capacity_step_is_bitwise(one_rank, dtype):
    """DeepSeek-V2 reduced (8 experts, top 6, a shared expert) through
    ``moe_capacity`` both ways, as the card runs it, in fp32 and in its
    published bf16: two ZeRO-1 steps under the (1, 1) mesh bitwise two
    steps without one. Under the mesh the router's and the dispatch's
    gradients meet at the batch's gather before the shared expert's is
    added; without one they meet at a view in the same place, so the
    three are summed in the same order."""
    c = Case("mla", 60)
    c.cfg = dataclasses.replace(c.cfg, dtype=dtype)
    c.tp = ptf.init_params(c.cfg, torch.Generator().manual_seed(60),
                           device="cpu")
    runs = _one_rank_runs(c, dict(RULES, _data_size=1), one_rank,
                          {"plain": "capacity", "mesh": "capacity"})
    assert _same(runs["mesh"], runs["plain"])


def test_a_moment_of_another_shape_raises(one_rank, monkeypatch):
    """A ZeRO-1 step given a moment whose shape is not the block its spec
    gives raises ``ValueError`` naming the leaf, before the loss runs
    (no whole-leaf update in its place)."""
    c = Case("hybrid", 60)
    rules = dict(c.rules, _data_size=1)
    calls = []
    monkeypatch.setattr(ptf, "loss_fn", lambda *a, **k: calls.append(1))
    p = pshd.shard_params(ptf._tree_map(torch.clone, c.tp), one_rank, rules)
    with pshd.sharding_ctx(one_rank, rules):
        st = init_opt_state(p, c.cfg)
        st["v"]["embed"] = st["v"]["embed"][:c.cfg.vocab_size // 2]
        with pytest.raises(ValueError, match=r"v\['embed'\] has shape"):
            make_train_step(c.cfg)(p, st, c.batch)
    assert calls == []
