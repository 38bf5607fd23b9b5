"""The paper's pipeline (``repro_torch.examples.offload_paper_pipeline``)
against the JAX package's script on the CPU: a reduced Mixtral (2
layers, d_model 64, 8 experts top-2, vocab 256) trained by JAX's
``repro.training.train`` through the dense MoE path, bridged to the
port; then the port's stages 2-5 must EQUAL the same stages run with
``repro.core.OffloadEngine`` as the JAX script runs them: tokens, the
LRU trace's render, histograms and temporal locality, every policy's
``stats()``, speculative P == R and the overlap run's ``stats()``. Each
port engine's smallest router top-k margin must stay far above fp32
noise, so an unequal result is a fault, not a near-tie. Stage 1,
``train_model``, holds its losses to JAX's ``train`` from the same init
within 1e-4 relative."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import OffloadEngine as JEngine
from repro.core.costmodel import HardwareProfile as JHardwareProfile
from repro.data import lm_batches as jlm_batches
from repro.models import transformer as jtf
from repro.training import train as jtrain
from repro.training.optimizer import AdamWConfig as JAdamWConfig
import repro_torch.configs as pcfg
from repro_torch.core.offload_engine import OffloadEngine
from repro_torch.examples import offload_paper_pipeline as pipe
from repro_torch.models import transformer as ptf
from test_torch_engine import MIN_MARGIN, _track_margins

PROMPTS, NEW, SLOTS = pipe.PROMPTS, pipe.NEW, pipe.SLOTS
STEPS, BATCH, SEQ, LR = 10, 8, 64, 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is faster than a pool, and keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs():
    kw = dict(layers=2, d_model=64, experts=8, vocab=256)
    jcfg = dataclasses.replace(jreduced(jget_config("mixtral-8x7b"), **kw),
                               dtype="float32", num_experts_per_tok=2)
    pc = dataclasses.replace(pcfg.reduced(pcfg.get_config("mixtral-8x7b"),
                                          **kw),
                             dtype="float32", num_experts_per_tok=2)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jcfg)
    return jcfg, pc


@pytest.fixture(scope="module")
def trained():
    """JAX's stage 1 (``train`` with ``moe_path="dense"``, the script's
    batch and learning rate, 10 steps), bridged to the port."""
    jcfg, pc = _configs()
    batches = jlm_batches(jcfg.vocab_size, BATCH, SEQ, STEPS, seed=0)
    jp, losses = jtrain(jcfg, batches, steps=STEPS, log_every=0,
                        opt_cfg=JAdamWConfig(lr=LR), moe_path="dense")
    assert losses[-1] < losses[0]
    tp = ptf.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, pc, tp


@pytest.fixture(scope="module")
def port_margins():
    """Every port engine built in this module records its smallest router
    top-k margin a MoE call."""
    seen = []
    orig = OffloadEngine.__init__

    def tracked(self, *a, **kw):
        orig(self, *a, **kw)
        seen.append(_track_margins(self))
    OffloadEngine.__init__ = tracked
    yield seen
    OffloadEngine.__init__ = orig


def _assert_margins(seen):
    assert seen and all(seen)
    assert min(min(m) for m in seen) > MIN_MARGIN


def _jax_run(jp, jcfg, **kw):
    eng = JEngine(jp, jcfg, cache_slots=SLOTS, **kw)
    return eng, [eng.generate(p, NEW) for p in PROMPTS]


# ------------------------------------------------------------- stage 2
def test_lru_trace_equals_jax(trained, port_margins):
    jcfg, jp, pc, tp = trained
    got = pipe.lru_trace(tp, pc, PROMPTS, NEW, SLOTS, device="cpu")
    eng, tokens = _jax_run(jp, jcfg, policy="lru")
    assert got["tokens"] == tokens
    assert got["render"] == eng.trace.render_layer(1, jcfg.num_experts,
                                                   max_tokens=28)
    assert got["temporal_locality"] == eng.trace.temporal_locality()
    assert got["random_locality"] == 2 / 8
    assert got["stats"] == eng.stats()
    assert got["histograms"] == [eng.trace.expert_histogram(
        l, jcfg.num_experts) for l in range(jcfg.num_layers)]
    assert sum(map(sum, got["histograms"])) == \
        2 * jcfg.num_layers * len(PROMPTS) * (4 + NEW)
    _assert_margins(port_margins)


# ------------------------------------------------------------- stage 3
@pytest.fixture(scope="module")
def policy_table(trained, port_margins):
    jcfg, jp, pc, tp = trained
    return pipe.compare_policies(tp, pc, PROMPTS, NEW, SLOTS, device="cpu")


@pytest.mark.parametrize("policy", pipe.POLICIES)
def test_compare_policies_equals_jax(policy, trained, policy_table,
                                     port_margins):
    jcfg, jp, pc, tp = trained
    assert list(policy_table) == list(pipe.POLICIES)
    eng, tokens = _jax_run(jp, jcfg, policy=policy,
                           hw=JHardwareProfile.a6000_pcie4())
    got = policy_table[policy]
    assert got["tokens"] == tokens
    assert got["stats"] == eng.stats()
    # caching is bit-transparent: every policy greedy-decodes the same
    assert tokens == policy_table["lru"]["tokens"]
    _assert_margins(port_margins)


# ---------------------------------------------------------- stages 4-5
def test_speculative_equals_jax(trained, port_margins):
    jcfg, jp, pc, tp = trained
    got = pipe.speculative(tp, pc, PROMPTS, NEW, SLOTS, device="cpu")
    eng, tokens = _jax_run(jp, jcfg, policy="lru", prefetch="spec")
    s = eng.stats()
    assert got["tokens"] == tokens
    assert got["stats"] == s
    assert abs(s["spec_precision"] - s["spec_recall"]) < 1e-9
    assert s["prefetches"] > 0
    _assert_margins(port_margins)


def test_deployed_overlap_equals_jax(trained, port_margins):
    jcfg, jp, pc, tp = trained
    got = pipe.deployed(tp, pc, PROMPTS, NEW, SLOTS, device="cpu")
    eng, tokens = _jax_run(jp, jcfg, policy="lfu", prefetch="spec",
                           overlap=True, hw=JHardwareProfile.a6000_pcie4())
    assert got["tokens"] == tokens
    assert got["stats"] == eng.stats()
    assert got["stats"]["exposed_transfer_frac"] < 1.0
    _assert_margins(port_margins)


# ------------------------------------------------------------- stage 1
def test_train_model_matches_jax_train():
    """``train_model`` from JAX's init params against JAX's ``train`` on
    the same batches, 3 steps: losses within 1e-4 relative, and the
    stage-1 params (trained in place) move off the init."""
    jcfg, pc = _configs()
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(4))
    tp = ptf.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    embed0 = tp["embed"].clone()
    _, jlosses = jtrain(jcfg, jlm_batches(jcfg.vocab_size, BATCH, SEQ, 3,
                                          seed=0),
                        steps=3, params=jp, log_every=0,
                        opt_cfg=JAdamWConfig(lr=LR), moe_path="dense")
    params, losses = pipe.train_model(pc, steps=3, batch=BATCH, seq=SEQ,
                                      lr=LR, params=tp, device="cpu")
    assert params is tp and not torch.equal(tp["embed"], embed0)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert all(not p.requires_grad for p in (tp["embed"],
                                             tp["layers"]["moe"]["router"]))
