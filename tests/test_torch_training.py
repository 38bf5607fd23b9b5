"""The port's training path against the JAX package's, on the CPU, on
shared weights (JAX ``init_params``, bridged with ``from_jax_params``)
and shared inputs made with numpy: ``loss_fn`` and its gradients for
every family (against ``jax.value_and_grad`` of JAX's ``loss_fn``, which
trains through XLA blockwise attention and the XLA SSD chunk), remat ==
no remat bitwise, AdamW with and without the clip, the cosine schedule,
``train``'s losses, checkpoints across the two packages, and the data
pipeline bitwise. Then the flash-attention backward's plain version
against ``jax.grad`` of the JAX reference, the CUDA route's autograd
wiring (its launches run the plain versions here), and the CUDA routes
that have no backward raising under grad (ROADMAP.md C3).

Tolerances: the loss at rtol 1e-4, each gradient within rtol 1e-4 plus
atol 1e-5 x the largest |JAX grad| of the model (fp32; the two
frameworks sum in other orders, and some gradients are zero up to
rounding, e.g. a key bias's, which the softmax cancels). AdamW and the schedule at rtol 1e-6
(the same fp32 formulas), the flash backward at rtol = atol = 2e-5.
MoE cases assert that the smallest router top-k margin they saw is far
above fp32 noise, so a mismatch is a fault, not a tie ordered otherwise.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro import data as jdata
from repro.kernels import ops as jops
from repro.models import transformer as jtf
from repro.training import load_checkpoint as jload
from repro.training import save_checkpoint as jsave
from repro.training import train as jtrain
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.optimizer import adamw_init as jadamw_init
from repro.training.optimizer import adamw_update as jadamw_update
from repro.training.optimizer import cosine_schedule as jcosine
from repro_torch import data as pdata
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops as kops
from repro_torch.models import transformer as ptf
from repro_torch.training import (AdamWConfig, adamw_init, adamw_update,
                                  cosine_schedule, load_checkpoint,
                                  make_train_step, save_checkpoint, train)
from repro_torch.training.train_loop import to_device
from repro_torch.training.tree import flatten, unflatten
from test_torch_prefill import (MIN_MARGIN, _bridge,  # noqa: F401
                                _one_torch_thread, track_margins)

GRAD_RTOL, GRAD_ATOL_FRAC = 1e-4, 1e-5
FLASH_TOL = dict(rtol=2e-5, atol=2e-5)
B, S = 2, 16
FRAMES, PATCHES = 37, 33


def _cfg(case):
    """(config, moe_path) of a family / path case, at test size."""
    if case == "dense":
        return tiny("qwen1.5-0.5b"), "auto"
    if case in ("moe_dense", "moe_capacity"):
        return tiny("mixtral-8x7b"), case.removeprefix("moe_")
    if case == "mla":
        return tiny("deepseek-v2-236b", experts=8, vocab=512), "dense"
    if case == "ssm":
        return dataclasses.replace(tiny("mamba2-2.7b"), ssm_chunk=4), "auto"
    if case == "hybrid":
        return dataclasses.replace(tiny("jamba-1.5-large-398b", layers=4),
                                   attn_every=2, ssm_chunk=4), "auto"
    if case == "encdec":
        return tiny("whisper-tiny"), "auto"
    if case == "vlm":
        return tiny("llama-3.2-vision-11b", layers=4), "auto"
    raise ValueError(case)


CASES = ["dense", "moe_dense", "moe_capacity", "mla", "ssm", "hybrid",
         "encdec", "vlm"]


def _batch(cfg, seed=0):
    """A numpy batch: tokens / labels [B, S], frames or patches."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(B, FRAMES, cfg.d_model)).astype(
            np.float32)
    elif cfg.family == "vlm":
        out["patches"] = rng.normal(size=(B, PATCHES, cfg.d_model)).astype(
            np.float32)
    return out


def _jax_flat(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_value_and_grad(params, cfg, batch, **kw):
    leaves = [p.detach().requires_grad_() for _, p in flatten(params)]
    loss = ptf.loss_fn(unflatten(params, leaves), cfg, batch, **kw)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), {k: g for (k, _), g in zip(flatten(params), grads)}


# ------------------------------------------------------------- the loss
@pytest.mark.parametrize("case", CASES)
def test_loss_and_grads_match_jax(case, monkeypatch):
    cfg, path = _cfg(case)
    margins = track_margins(monkeypatch)
    jp = jtf.init_params(cfg, jax.random.PRNGKey(1))
    nb = _batch(cfg)
    jl, jg = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, cfg, {k: jnp.asarray(v) for k, v in
                                       nb.items()}, moe_path=path))(jp)
    loss, grads = _port_value_and_grad(_bridge(jp), cfg,
                                       to_device(nb, "cpu"), moe_path=path)
    np.testing.assert_allclose(float(loss), float(jl), rtol=GRAD_RTOL)
    want = _jax_flat(jg)
    assert sorted(want) == sorted(grads)
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_FRAC * top, err_msg=k)
    if cfg.is_moe:
        assert min(margins) > MIN_MARGIN


@pytest.mark.parametrize("case", ["dense", "moe_capacity", "hybrid",
                                  "encdec", "vlm"])
def test_remat_equals_no_remat_bitwise(case):
    cfg, path = _cfg(case)
    params = _bridge(jtf.init_params(cfg, jax.random.PRNGKey(2)))
    batch = to_device(_batch(cfg, seed=1), "cpu")
    l0, g0 = _port_value_and_grad(params, cfg, batch, moe_path=path,
                                  remat=False)
    l1, g1 = _port_value_and_grad(params, cfg, batch, moe_path=path,
                                  remat=True)
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_chunked_xent_matches_jax():
    from repro.models.layers import chunked_softmax_xent as jxent
    from repro_torch.models.layers import chunked_softmax_xent as pxent
    rng = np.random.default_rng(3)
    h = rng.normal(size=(2, 1500, 32)).astype(np.float32)
    w = (rng.normal(size=(32, 50)) * 0.3).astype(np.float32)
    lab = rng.integers(0, 50, (2, 1500)).astype(np.int32)
    nw = rng.normal(size=(32,)).astype(np.float32)
    want = jxent(jnp.asarray(h), jnp.asarray(w), jnp.asarray(lab),
                 norm_w=jnp.asarray(nw))
    got = pxent(torch.from_numpy(h), torch.from_numpy(w),
                torch.from_numpy(lab), norm_w=torch.from_numpy(nw))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# ------------------------------------------------------ AdamW, schedule
def _opt_trees(seed, grad_scale):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 70), "b": {"w": (5,), "x": (2, 3, 4)}}

    def draw(scale):
        return {"a": rng.normal(size=shapes["a"]).astype(np.float32) * scale,
                "b": {k: rng.normal(size=s).astype(np.float32) * scale
                      for k, s in shapes["b"].items()}}
    return draw(1.0), [draw(grad_scale) for _ in range(3)]


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0], ids=["no_clip", "clip"])
def test_adamw_update_matches_jax(grad_scale):
    p0, grads = _opt_trees(4, grad_scale)
    jcfg = JAdamWConfig(lr=1e-2, grad_clip=1.0)
    cfg = AdamWConfig(lr=1e-2, grad_clip=1.0)
    jp = jax.tree.map(jnp.asarray, p0)
    jst = jadamw_init(jp)
    pp = ptf.from_jax_params(p0, device="cpu")
    pst = adamw_init(pp)
    sched, jsched = cosine_schedule(warmup=1, total=5), jcosine(warmup=1,
                                                                total=5)
    for g in grads:
        gn = float(np.sqrt(sum(np.sum(x.astype(np.float64) ** 2)
                               for x in jax.tree.leaves(g))))
        assert (gn > 1.0) == (grad_scale > 1.0)   # the clip engages or not
        jp, jst = jadamw_update(jax.tree.map(jnp.asarray, g), jst, jp,
                                cfg=jcfg, lr_scale=jsched(jst["count"]))
        pp, pst = adamw_update(ptf.from_jax_params(g, device="cpu"), pst,
                               pp, cfg=cfg, lr_scale=sched(pst["count"]))
    assert int(pst["count"]) == int(jst["count"]) == 3
    for tree, jtree in ((pp, jp), (pst["m"], jst["m"]), (pst["v"], jst["v"])):
        want = _jax_flat(jtree)
        for k, t in flatten(tree):
            np.testing.assert_allclose(t.numpy(), want[k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)


def test_cosine_schedule_matches_jax():
    for kw in (dict(warmup=10, total=100, floor=0.1),
               dict(base_lr_scale=0.5, warmup=1, total=7, floor=0.0)):
        f, jf = cosine_schedule(**kw), jcosine(**kw)
        for step in (0, 1, 3, 5, 10, 11, 50, 99, 100, 150):
            got = float(f(torch.tensor(step, dtype=torch.int32)))
            want = float(jf(jnp.asarray(step, jnp.int32)))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-7), step


# ---------------------------------------------------------------- train
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mixtral-8x7b"])
def test_train_losses_match_jax(arch):
    cfg = tiny(arch)
    jp = jtf.init_params(cfg, jax.random.PRNGKey(5))
    tp = _bridge(jp)
    opt = dict(lr=3e-3, weight_decay=0.01)
    batches = list(jdata.lm_batches(cfg.vocab_size, 2, 16, 4, seed=5))
    _, jlosses = jtrain(cfg, iter(batches), steps=4, params=jp, log_every=0,
                        opt_cfg=JAdamWConfig(**opt))
    params, losses = train(cfg, iter(batches), steps=4, params=tp,
                           log_every=0, opt_cfg=AdamWConfig(**opt),
                           device="cpu")
    assert params is tp
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]


def test_train_draws_params_from_seed():
    cfg = tiny("qwen1.5-0.5b")
    batches = list(pdata.lm_batches(cfg.vocab_size, 2, 8, 2, seed=1))
    p1, l1 = train(cfg, iter(batches), steps=2, seed=3, log_every=0,
                   device="cpu")
    p2, l2 = train(cfg, iter(batches), steps=2, seed=3, log_every=0,
                   device="cpu")
    assert l1 == l2 and all(np.isfinite(l1))
    for a, b in zip(flatten(p1), flatten(p2)):
        assert torch.equal(a[1], b[1])


# ----------------------------------------------------------- checkpoints
def test_checkpoint_port_save_loads_in_jax(tmp_path):
    cfg = tiny("jamba-1.5-large-398b", layers=4)
    cfg = dataclasses.replace(cfg, attn_every=2)
    jp = jtf.init_params(cfg, jax.random.PRNGKey(6))
    tp = _bridge(jp)
    path = os.path.join(tmp_path, "port.npz")
    save_checkpoint(path, {"params": tp, "opt": adamw_init(tp)}, step=11,
                    extra={"note": "port"})
    like = {"params": jax.tree.map(jnp.zeros_like, jp),
            "opt": jadamw_init(jp)}
    restored, step = jload(path, like)
    assert step == 11
    for k, v in _jax_flat(restored["params"]).items():
        np.testing.assert_array_equal(v, _jax_flat(jp)[k])
    assert int(restored["opt"]["count"]) == 0


def test_checkpoint_jax_save_loads_in_port(tmp_path):
    cfg = tiny("llama-3.2-vision-11b", layers=4)
    jp = jtf.init_params(cfg, jax.random.PRNGKey(7))
    path = os.path.join(tmp_path, "jax.npz")
    jsave(path, {"params": jp, "opt": jadamw_init(jp)}, step=3)
    tp = _bridge(jp)
    like = {"params": _zeros_like(tp), "opt": adamw_init(tp)}
    restored, step = load_checkpoint(path, like)
    assert step == 3
    for (k, a), (_, b) in zip(flatten(restored["params"]), flatten(tp)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert restored["opt"]["count"].dtype == torch.int32


def _zeros_like(tree):
    return unflatten(tree, [torch.zeros_like(t) for _, t in flatten(tree)])


def test_checkpoint_missing_key_and_shape_mismatch_raise(tmp_path):
    path = os.path.join(tmp_path, "ck.npz")
    save_checkpoint(path, {"w": torch.ones((2, 2))})
    with pytest.raises(KeyError):
        load_checkpoint(path, {"w": torch.ones((2, 2)),
                               "u": torch.ones(1)})
    with pytest.raises(ValueError):
        load_checkpoint(path, {"w": torch.ones((3, 2))})


def test_checkpoint_bf16_leaves_roundtrip(tmp_path):
    t = torch.randn(4, 3).to(torch.bfloat16)
    path = os.path.join(tmp_path, "bf16.npz")
    save_checkpoint(path, {"w": t, "tuple": (torch.arange(3),)}, step=1)
    got, _ = load_checkpoint(path, {"w": torch.zeros(4, 3,
                                                     dtype=torch.bfloat16),
                                    "tuple": (torch.zeros(3,
                                                          dtype=torch.long),)})
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], t)
    assert torch.equal(got["tuple"][0], torch.arange(3))


# ------------------------------------------------------------------ data
def test_data_pipeline_is_bitwise_jax():
    for a, b in zip(pdata.markov_lm(300, seed=4), jdata.markov_lm(300,
                                                                  seed=4)):
        np.testing.assert_array_equal(a, b)
    got = list(pdata.lm_batches(500, 3, 40, 3, seed=9))
    want = list(jdata.lm_batches(500, 3, 40, 3, seed=9))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("tokens", "labels"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    kw = dict(num_layers=3, num_experts=8, top_k=2, n_tokens=120, seed=2)
    for port_fn, jax_fn in ((pdata.workload_from_paper_stats,
                             jdata.workload_from_paper_stats),
                            (pdata.drifting_workload,
                             jdata.drifting_workload)):
        g, w = port_fn(**kw), jax_fn(**kw)
        assert isinstance(g, pdata.ExpertWorkload)
        assert (g.num_layers, g.num_experts, g.top_k) == (
            w.num_layers, w.num_experts, w.top_k)
        assert g.acts == w.acts
        assert [g.measured_locality(l) for l in range(3)] == [
            w.measured_locality(l) for l in range(3)]
        assert g.flat_future(1) == w.flat_future(1)


# ---------------- twins of tests/test_training_serving.py (training, data)
def test_train_reduces_loss_quickly():
    cfg = tiny("qwen1.5-0.5b", d_model=128, vocab=64)

    def ident(n):
        rng = np.random.default_rng(0)
        for _ in range(n):
            t = rng.integers(0, 64, size=(8, 32)).astype(np.int32)
            yield {"tokens": t, "labels": t}

    params, losses = train(cfg, ident(60), steps=60, log_every=0,
                           opt_cfg=AdamWConfig(lr=2e-3, weight_decay=0.0),
                           device="cpu")
    assert losses[-1] < losses[0] - 1.0


def test_grad_clip_bounds_update():
    p = {"w": torch.ones((4,))}
    g = {"w": torch.full((4,), 1e6)}
    opt = adamw_init(p)
    w0 = p["w"].clone()
    p2, _ = adamw_update(g, opt, p, cfg=AdamWConfig(lr=0.1, weight_decay=0.0,
                                                    grad_clip=1.0))
    assert float(torch.max(torch.abs(p2["w"] - w0))) < 0.2


def test_cosine_schedule_shape():
    f = cosine_schedule(warmup=10, total=100, floor=0.1)
    assert float(f(torch.tensor(0))) == 0.0
    assert float(f(torch.tensor(10))) == pytest.approx(1.0)
    assert float(f(torch.tensor(100))) == pytest.approx(0.1, abs=1e-6)


def test_checkpoint_roundtrip(tmp_path):
    cfg = tiny("mixtral-8x7b")
    params = _bridge(jtf.init_params(cfg, jax.random.PRNGKey(0)))
    path = os.path.join(tmp_path, "ck.npz")
    save_checkpoint(path, params, step=7)
    restored, step = load_checkpoint(path, _zeros_like(params))
    assert step == 7
    for (_, a), (_, b) in zip(flatten(params), flatten(restored)):
        assert torch.equal(a, b)


def test_checkpoint_shape_mismatch_raises(tmp_path):
    path = os.path.join(tmp_path, "ck.npz")
    save_checkpoint(path, {"w": torch.ones((2, 2))})
    with pytest.raises(ValueError):
        load_checkpoint(path, {"w": torch.ones((3, 2))})


def test_lm_batches_shapes_and_determinism():
    b1 = list(pdata.lm_batches(64, 2, 16, 2, seed=3))
    b2 = list(pdata.lm_batches(64, 2, 16, 2, seed=3))
    assert b1[0]["tokens"].shape == (2, 16)
    np.testing.assert_array_equal(b1[0]["tokens"], b2[0]["tokens"])
    # labels are next-token shifted
    np.testing.assert_array_equal(b1[0]["labels"][:, :-1],
                                  b1[0]["tokens"][:, 1:])


def test_workload_calibration():
    def measured(explicit):
        wl = pdata.workload_from_paper_stats(
            num_layers=4, num_experts=8, top_k=2, n_tokens=2000,
            locality=explicit, zipf_s=1.0, seed=1)
        return np.mean([wl.measured_locality(l) for l in range(4)]), wl
    m0, wl = measured(0.0)
    m3, _ = measured(0.3)
    assert 0.28 < m0 < 0.45
    assert m3 > m0
    hist = np.zeros(8)
    for ids in wl.layer_sequence(0):
        for e in ids:
            hist[e] += 1
    top2 = np.sort(hist)[-2:].sum() / hist.sum()
    assert top2 > 0.45


# ------------------------------------------------ flash attention backward
# (B, Sq, Sk, H, KV, hd, vd, causal, window): GQA, a window, Sq = 1, a
# non-causal Sq != Sk, MLA widths, rows that see no key (Sq > Sk + window)
FLASH_BWD_SHAPES = [(2, 24, 24, 4, 2, 16, 16, True, 0),
                    (1, 40, 40, 4, 1, 16, 16, True, 7),
                    (2, 1, 30, 3, 3, 8, 8, False, 0),
                    (1, 9, 33, 2, 2, 16, 16, False, 0),
                    (1, 20, 20, 2, 1, 24, 16, True, 0),
                    (1, 30, 10, 2, 2, 8, 8, True, 4)]


def _flash_inputs(shape, seed):
    Bq, Sq, Sk, H, KV, hd, vd, causal, window = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((Bq, Sq, H, hd), (Bq, Sk, KV, hd), (Bq, Sk, KV, vd),
                      (Bq, Sq, H, vd))]
    return arrs, dict(causal=causal, window=window)


@pytest.mark.parametrize("shape", FLASH_BWD_SHAPES,
                         ids=[str(s) for s in FLASH_BWD_SHAPES])
def test_flash_attention_plain_bwd_matches_jax_grad(shape):
    (q, k, v, do), kw = _flash_inputs(shape, 11)
    _, vjp = jax.vjp(lambda a, b, c: jops.flash_attention(a, b, c, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = flash_mod.plain_bwd(*(torch.from_numpy(x) for x in (q, k, v, do)),
                              **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FLASH_TOL)
    # the CPU route of the wrapper differentiates the same way
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = kops.flash_attention(*leaves, **kw)
    for g, w in zip(torch.autograd.grad(out, leaves, torch.from_numpy(do)),
                    got):
        assert torch.equal(g, w)


def _cuda_route_on_cpu(monkeypatch):
    """Send CPU tensors down the wrappers' CUDA route, with the flash
    launches running the plain versions (what the kernels are held to on
    the card): the autograd wiring and the launch counts, without a
    card."""
    monkeypatch.setattr(kops, "_one_device",
                        lambda name, *t: torch.device("cuda"))
    monkeypatch.setattr(kops, "_entry", lambda name: None)
    monkeypatch.setattr(flash_mod, "launch",
                        lambda fn, q, k, v, **kw: flash_mod.plain(q, k, v,
                                                                  **kw))
    monkeypatch.setattr(
        flash_mod, "launch_bwd",
        lambda fn, q, k, v, dout, **kw: flash_mod.plain_bwd(q, k, v, dout,
                                                            **kw))


def test_flash_attention_cuda_route_differentiates(monkeypatch):
    (q, k, v, do), kw = _flash_inputs(FLASH_BWD_SHAPES[1], 12)
    want = flash_mod.plain_bwd(*(torch.from_numpy(x) for x in (q, k, v, do)),
                               **kw)
    _cuda_route_on_cpu(monkeypatch)
    kops.reset_launch_counts()
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = kops.flash_attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    counts = kops.launch_counts()
    assert counts["flash_attention"] == 1
    assert counts["flash_attention_bwd"] == 1


@pytest.mark.parametrize("remat", [True, False])
def test_train_step_launches_per_layer(remat, monkeypatch):
    """The prediction chip_smoke.py checks at Qwen1.5-0.5B: a step
    launches the forward once per layer, again per layer under remat
    (the recomputed block), and the backward once per layer."""
    cfg = tiny("qwen1.5-0.5b", layers=3)
    params = _bridge(jtf.init_params(cfg, jax.random.PRNGKey(8)))
    _cuda_route_on_cpu(monkeypatch)
    step = make_train_step(cfg, remat=remat)
    kops.reset_launch_counts()
    step(params, adamw_init(params), to_device(_batch(cfg), "cpu"))
    L = cfg.num_layers
    assert kops.launch_counts() == {
        "moe_ffn": 0, "paged_attention": 0, "ssd_chunk": 0,
        "ssd_chunk_bwd": 0, "flash_attention": 2 * L if remat else L,
        "flash_attention_bwd": L}


def test_cuda_routes_without_backward_raise_under_grad(monkeypatch):
    """C3: on the card, a kernel with no backward refuses inputs that
    require grad (it would cut the gradient silently); under no_grad or
    without requires_grad the same call goes on to the launch.
    ``ssd_chunk`` and ``flash_attention`` have one, the latter in fp32
    and in bf16 (A14): under grad their routes go on to the launch."""
    monkeypatch.setattr(kops, "_one_device",
                        lambda name, *t: torch.device("cuda"))
    monkeypatch.setattr(kops, "_entry", _no_build)
    rng = np.random.default_rng(13)

    def t(*shape, grad=False):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return x.requires_grad_(grad)

    with pytest.raises(_Launched, match="ssd_chunk"):
        kops.ssd_chunk(t(2, 4, 3, grad=True), t(2, 4, 3, 5), t(2, 4, 6),
                       t(2, 4, 6))
    calls = {
        "moe_ffn": lambda g: kops.moe_ffn(t(2, 3, 8), t(2, 8, 16, grad=g),
                                          t(2, 8, 16), t(2, 16, 8), [1, 0]),
        "paged_attention": lambda g: kops.paged_attention(
            t(1, 2, 8, grad=g), t(3, 4, 1, 8), t(3, 4, 1, 8),
            torch.zeros((1, 2), dtype=torch.int32),
            torch.zeros((1,), dtype=torch.int32)),
    }
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match=name):
            call(True)
        # past the check the route goes on to its kernel (_no_build here)
        with torch.no_grad(), pytest.raises(_Launched):
            call(True)
        with pytest.raises(_Launched):
            call(False)
    q = t(1, 4, 2, 8).to(torch.bfloat16).requires_grad_()
    k = t(1, 4, 2, 8).to(torch.bfloat16)
    with pytest.raises(_Launched, match="flash_attention"):
        kops.flash_attention(q, k, k)


class _Launched(Exception):
    pass


def _no_build(name):
    raise _Launched(name)
