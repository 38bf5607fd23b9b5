"""bf16 training (ROADMAP A14): the port's training path against the JAX
package's, on the CPU, for configs reduced with their published dtype
kept (``dtype="bfloat16"``), on shared weights (JAX ``init_params``,
bridged with ``from_jax_params``: the same bf16 bits) and shared numpy
inputs. ``loss_fn`` and its gradients against ``jax.value_and_grad``,
``train`` against JAX's ``train``, the flash-attention plain backward on
bf16 inputs against ``jax.vjp`` of the JAX reference, and a checkpoint
of bf16 params read by JAX's ``load_checkpoint``.

Tolerances. The two packages round to bf16 at other places (JAX's
blockwise attention rounds P to bf16 before P.V, the port keeps it in
fp32; products and norms round their outputs in their own orders), so
the loss is held at 1e-3 relative (``train``'s losses too) and each
gradient leaf within 5e-2 x that leaf's largest |JAX gradient|, in JAX's
dtype (bf16, and fp32 for the SSM's A_log, D and dt_bias); ``train``'s
params keep JAX's dtypes. The flash backward: both sides compute in
fp32 and round dq, dk and dv to bf16 once, so they may round apart by
one bf16 ulp, up to 2^-7 of an element, where fp32's order puts a value
on either side of a rounding boundary: within 2^-7 x each output's
largest |JAX value|.

Routing. In bf16 the two packages' router logits differ by the hidden
state's roundings: 0.007 to 0.24 at these sizes, more than the smallest
top-k margin of most seeds, so a token's expert choice can differ
between them, which is a tie at bf16's precision and not a fault (in
fp32 the logits agree to ~1e-6, and ``test_torch_training.py`` holds
the real top-k there behind its margin guard). So the MoE cases pin the
choice in both packages alike (``_pin_routing``: token n of a router
call goes to experts n .. n + k - 1 mod E): the logits, the renormalised
top-k softmax, the load-balance loss, the dispatch and every gradient
through them stay the packages' own code, and the test asserts that
the pinned choice is what both ran.
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
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.training import load_checkpoint as jload
from repro.training import train as jtrain
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.models import moe as pmoe
from repro_torch.models import transformer as ptf
from repro_torch.training import AdamWConfig, save_checkpoint, train
from repro_torch.training.train_loop import to_device
from repro_torch.training.tree import flatten, unflatten
from test_torch_prefill import _bridge, _one_torch_thread  # noqa: F401

LOSS_RTOL, LEAF_FRAC = 1e-3, 5e-2
FLASH_FRAC = 2.0 ** -7
B, S = 2, 16
ARCHS = ["qwen1.5-0.5b", "qwen2.5-3b", "mixtral-8x7b", "deepseek-v2-236b",
         "mamba2-2.7b", "jamba-1.5-large-398b"]


def _cfg(arch):
    """The reduced config of ``arch`` (2 layers, d 64, vocab 128; Jamba 4
    layers, attention every 2nd; SSD chunks of 4) in bf16."""
    if arch == "deepseek-v2-236b":
        cfg = tiny(arch, experts=8, vocab=512)
    elif arch == "jamba-1.5-large-398b":
        cfg = dataclasses.replace(tiny(arch, layers=4), attn_every=2,
                                  ssm_chunk=4)
    elif arch == "mamba2-2.7b":
        cfg = dataclasses.replace(tiny(arch), ssm_chunk=4)
    else:
        cfg = tiny(arch)
    return dataclasses.replace(cfg, dtype="bfloat16")


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def _pin_routing(monkeypatch, cfg):
    """Replace both packages' ``router_probs`` by the same function with
    a fixed expert choice: token n (row-major over the leading axes of
    the router's input) takes experts n, n + 1, .., n + k - 1 mod E, in
    that order, weighted by the softmax of its logits there. Returns the
    list of (package, ids) of every call, for the test to check."""
    k, E = cfg.num_experts_per_tok, cfg.num_experts
    calls = []

    def ids_of(lead, arange):
        n = arange(int(np.prod(lead))).reshape(lead)
        return (n[..., None] + arange(k)) % E

    def jax_router(p, c, x):
        logits = (x.astype(jnp.float32) @ p["router"]).astype(jnp.float32)
        ids = ids_of(logits.shape[:-1], np.arange)   # a constant
        calls.append(("jax", ids))
        ids = jnp.asarray(ids, jnp.int32)
        vals = jnp.take_along_axis(logits, ids, axis=-1)
        return logits, jax.nn.softmax(vals, axis=-1), ids

    def port_router(p, c, x):
        logits = (x.float() @ p["router"]).float()
        ids = ids_of(tuple(logits.shape[:-1]), torch.arange)
        calls.append(("port", ids))
        vals = torch.gather(logits, -1, ids)
        return logits, torch.softmax(vals, dim=-1), ids

    monkeypatch.setattr(jmoe, "router_probs", jax_router)
    monkeypatch.setattr(pmoe, "router_probs", port_router)
    return calls


def _check_pinned(calls, cfg):
    """Both packages routed, every call through the pinned choice."""
    if not cfg.is_moe:
        return
    assert {who for who, _ in calls} == {"jax", "port"}
    for _, ids in calls:
        ids = np.asarray(ids)
        n = np.arange(ids[..., 0].size).reshape(ids.shape[:-1])
        np.testing.assert_array_equal(
            ids, (n[..., None] + np.arange(ids.shape[-1])) % cfg.num_experts)


def _jax_flat(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_leaves_close(got, want, what):
    """Each port leaf in its JAX leaf's dtype and within LEAF_FRAC x that
    leaf's largest |JAX value|."""
    assert sorted(got) == sorted(want), what
    for k, t in got.items():
        w = want[k]
        assert str(t.dtype).removeprefix("torch.") == str(w.dtype), (what, k)
        w64 = w.astype(np.float64)
        err = np.abs(t.double().numpy() - w64).max()
        assert err <= LEAF_FRAC * np.abs(w64).max(), (what, k, err)


def _port_value_and_grad(params, cfg, batch):
    leaves = [p.detach().requires_grad_() for _, p in flatten(params)]
    loss = ptf.loss_fn(unflatten(params, leaves), cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), {k: g for (k, _), g in zip(flatten(params), grads)}


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_grads_match_jax(arch, monkeypatch):
    cfg = _cfg(arch)
    calls = _pin_routing(monkeypatch, cfg)
    jp = jtf.init_params(cfg, jax.random.PRNGKey(1))
    nb = _batch(cfg)
    jl, jg = jax.value_and_grad(lambda p: jtf.loss_fn(
        p, cfg, {k: jnp.asarray(v) for k, v in nb.items()}))(jp)
    params = _bridge(jp)
    assert {str(p.dtype) for _, p in flatten(params)} >= {"torch.bfloat16"}
    loss, grads = _port_value_and_grad(params, cfg, to_device(nb, "cpu"))
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    _assert_leaves_close(grads, _jax_flat(jg), f"{arch} grads")
    _check_pinned(calls, cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_train_matches_jax(arch, monkeypatch):
    cfg = _cfg(arch)
    calls = _pin_routing(monkeypatch, cfg)
    jp = jtf.init_params(cfg, jax.random.PRNGKey(5))
    tp = _bridge(jp)
    opt = dict(lr=3e-3, weight_decay=0.01)
    batches = list(jdata.lm_batches(cfg.vocab_size, B, S, 3, seed=5))
    jparams, jlosses = jtrain(cfg, iter(batches), steps=3, params=jp,
                              log_every=0, opt_cfg=JAdamWConfig(**opt))
    params, losses = train(cfg, iter(batches), steps=3, params=tp,
                           log_every=0, opt_cfg=AdamWConfig(**opt),
                           device="cpu")
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    assert all(np.isfinite(losses)) and params is tp
    jdtypes = {k: str(v.dtype) for k, v in _jax_flat(jparams).items()}
    assert {k: str(t.dtype).removeprefix("torch.")
            for k, t in flatten(params)} == jdtypes   # params keep dtypes
    _check_pinned(calls, cfg)


# (B, Sq, Sk, H, KV, hd, vd, causal, window): GQA, a window, Sq = 1, a
# non-causal Sq != Sk, MLA widths, rows that see no key (Sq > Sk + window)
FLASH_BWD_SHAPES = [(2, 24, 24, 4, 2, 16, 16, True, 0),
                    (1, 40, 40, 4, 1, 16, 16, True, 7),
                    (2, 1, 30, 3, 3, 8, 8, False, 0),
                    (1, 9, 33, 2, 2, 16, 16, False, 0),
                    (1, 20, 20, 2, 1, 24, 16, True, 0),
                    (1, 30, 10, 2, 2, 8, 8, True, 4)]


@pytest.mark.parametrize("shape", FLASH_BWD_SHAPES,
                         ids=[str(s) for s in FLASH_BWD_SHAPES])
def test_bf16_flash_plain_bwd_matches_jax_grad(shape):
    Bq, Sq, Sk, H, KV, hd, vd, causal, window = shape
    kw = dict(causal=causal, window=window)
    rng = np.random.default_rng(21)
    q, k, v, do = (jnp.asarray(rng.normal(size=s), jnp.bfloat16)
                   for s in ((Bq, Sq, H, hd), (Bq, Sk, KV, hd),
                             (Bq, Sk, KV, vd), (Bq, Sq, H, vd)))
    _, vjp = jax.vjp(lambda a, b, c: jops.flash_attention(a, b, c, **kw),
                     q, k, v)
    want = vjp(do)
    got = flash_mod.plain_bwd(*(torch.from_numpy(
        np.asarray(x).astype(np.float32)).to(torch.bfloat16)
        for x in (q, k, v, do)), **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        w = np.asarray(w).astype(np.float64)
        err = np.abs(g.double().numpy() - w).max()
        assert err <= FLASH_FRAC * np.abs(w).max(), err


def test_bf16_checkpoint_loads_in_jax(tmp_path):
    cfg = _cfg("qwen2.5-3b")
    jp = jtf.init_params(cfg, jax.random.PRNGKey(6))
    batches = list(jdata.lm_batches(cfg.vocab_size, B, S, 2, seed=6))
    params, _ = train(cfg, iter(batches), steps=2, params=_bridge(jp),
                      log_every=0, device="cpu")
    path = os.path.join(tmp_path, "bf16.npz")
    save_checkpoint(path, params, step=2)
    restored, step = jload(path, jax.tree.map(jnp.zeros_like, jp))
    assert step == 2
    got = _jax_flat(restored)
    for k, t in flatten(params):
        assert got[k].dtype == jnp.bfloat16, k
        np.testing.assert_array_equal(got[k].astype(np.float32),
                                      t.float().numpy(), err_msg=k)
