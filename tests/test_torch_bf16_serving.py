"""The port's encdec (Whisper) and vlm (Llama-3.2-Vision) families in
their configs' own bf16 against the JAX package's, on shared bf16 weights
(JAX ``init_params`` at ``dtype="bfloat16"``, bridged with
``from_jax_params``) and shared bf16 encoder inputs made with numpy:
``encoder_forward``, each ``decode_step`` of the loop, and
``ServingEngine`` greedy tokens. On the CPU the port runs its kernels'
plain versions; on the card the same decode steps send every
cross-attention call (one query over the encoder's states) to the
one-query route's bf16 kernel, which ``chip_smoke.py`` holds there.

Tolerance (``BF16_LOGIT_TOL``): max |port - JAX| <= 2^-5 x max |JAX| for
the fp32 logits and the bf16 encoder states. Both packages keep hidden
states in bf16 and round them at different places (JAX rounds P to bf16
before P.V, the port keeps it fp32; matmul sums run in other orders), so
a few bf16 roundings (2^-8 relative each, at most half an ulp) separate
them by the last layer: measured up to 1.7e-2 x max on the logits and
9e-3 x max on the encoder states at these sizes, under the 3.1e-2 here.

Greedy tokens: with the weights ``init_params`` draws (zero biases) the
two engines' tokens are equal. With biases drawn at random, so that they
count, the tiny models' logits sit a few bf16 ulps apart (top-2 gaps
from 0.002), and a tie may order differently: there each row's tokens
must be equal up to a step where the port's token has, in JAX's bf16
logits, at most one bf16 ulp of JAX's top logit less than JAX's token
(``BF16_TIE_ULPS``; the draw here ties exactly, 0 ulps), after which the
row's continuations differ by construction and are not compared."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro.models import transformer as jtf
from repro.serving import ServingEngine as JEngine
from repro_torch.models import transformer as ptf
from repro_torch.serving.engine import ServingEngine
from test_torch_families import FRAMES, PATCHES, PROMPTS, _with_random_biases
from test_torch_prefill import TOKENS, _bridge, _one_torch_thread  # noqa: F401

BF16_LOGIT_TOL = 2.0 ** -5
BF16_TIE_ULPS = 1
FAMILIES = ["encdec", "vlm"]


def _cfg(family):
    cfg = (tiny("whisper-tiny") if family == "encdec"
           else tiny("llama-3.2-vision-11b", layers=4))
    return dataclasses.replace(cfg, dtype="bfloat16")


def _model(family, biases, seed=1):
    """(cfg, JAX params, port params, JAX enc, port enc), all bf16: the
    encoder's states over FRAMES seeded bf16 frames (encdec) or PATCHES
    seeded bf16 patch embeddings (vlm), batch 2. ``biases``: "zero" (as
    ``init_params`` draws them) or "random"."""
    cfg = _cfg(family)
    rng = np.random.default_rng(seed)
    jp = jtf.init_params(cfg, jax.random.PRNGKey(seed))
    if biases == "random":
        jp = _with_random_biases(jp, rng)
    tp = _bridge(jp)
    n = FRAMES if family == "encdec" else PATCHES
    x = rng.normal(size=(2, n, cfg.d_model)).astype(np.float32)
    jx, px = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
        torch.bfloat16)
    if family == "encdec":
        return (cfg, jp, tp, jtf.encoder_forward(jp, cfg, jx),
                ptf.encoder_forward(tp, cfg, px))
    return cfg, jp, tp, jx, px


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.float().numpy() - want).max())
    top = float(np.abs(want).max())
    assert err <= BF16_LOGIT_TOL * top, (what, err, top)


def test_bf16_params_and_encoder_states_match_reference():
    """The bridged tree is bf16 leaf for leaf, and Whisper's encoder over
    bf16 frames gives bf16 states within the tolerance of JAX's."""
    cfg, jp, tp, jenc, penc = _model("encdec", "random")
    assert {str(v.dtype) for v in jax.tree.leaves(jp)} == {"bfloat16"}
    assert {v.dtype for v in jax.tree.leaves(
        tp, is_leaf=lambda t: isinstance(t, torch.Tensor))} == {
            torch.bfloat16}
    assert penc.dtype == torch.bfloat16 and jenc.dtype == jnp.bfloat16
    assert tuple(penc.shape) == (2, FRAMES, cfg.d_model)
    _close(penc, jenc, "encoder states")


@pytest.mark.parametrize("family", FAMILIES)
def test_bf16_decode_steps_match_reference(family):
    """Each ``decode_step`` of a two-row loop over TOKENS: the port's
    fp32 logits within BF16_LOGIT_TOL of JAX's, and the cross K/V its
    state holds in bf16, as JAX's."""
    cfg, jp, tp, jenc, penc = _model(family, "random")
    toks = np.array([TOKENS, TOKENS[::-1]], np.int32)
    S = toks.shape[1]
    js = jtf.init_decode_state(jp, cfg, 2, S, enc=jenc)
    ps = ptf.init_decode_state(tp, cfg, 2, S, enc=penc, device="cpu")
    assert ps["cross_kv"][0]["k"].dtype == torch.bfloat16
    for i in range(S):
        jl, js = jtf.decode_step(jp, cfg, js, jnp.asarray(toks[:, i:i + 1]),
                                 jnp.int32(i), moe_path="dense")
        pl, ps = ptf.decode_step(tp, cfg, ps,
                                 torch.from_numpy(toks[:, i:i + 1]).long(),
                                 i, moe_path="dense")
        assert tuple(pl.shape) == (2, cfg.vocab_size)
        _close(pl, jl, f"{family} step {i}")


@pytest.mark.parametrize("biases", ["zero", "random"])
@pytest.mark.parametrize("family", FAMILIES)
def test_bf16_greedy_tokens_equal_reference(family, biases):
    """``ServingEngine.generate_batch`` greedy tokens against JAX's on
    the prompts of ``test_torch_families``: equal with zero biases; with
    random ones equal up to a tie of JAX's bf16 logits (module
    docstring)."""
    cfg, jp, tp, jenc, penc = _model(family, biases)
    jeng = JEngine(jp, cfg, cache_len=16)
    seen, step = [], jeng._step

    def recording(*args):
        logits, state = step(*args)
        seen.append(np.asarray(logits, np.float32))
        return logits, state

    jeng._step = recording
    want = jeng.generate_batch(PROMPTS, max_new=6, enc=jenc)
    got = ServingEngine(tp, cfg, cache_len=16, device="cpu").generate_batch(
        PROMPTS, max_new=6, enc=penc)
    if biases == "zero":
        assert got == want
        return
    plen = max(len(p) for p in PROMPTS)
    for b, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w) == 6
        for j, (x, y) in enumerate(zip(g, w)):
            if x == y:
                continue
            logits = seen[plen - 1 + j][b]      # what JAX sampled step j from
            ulp = 2.0 ** (np.floor(np.log2(abs(logits[y]))) - 7)
            assert logits[y] - logits[x] <= BF16_TIE_ULPS * ulp, (
                b, j, g, w, logits[y], logits[x])
            break
