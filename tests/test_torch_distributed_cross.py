"""The encdec and vlm families under a (data 2, model 4) mesh of 8 CPU
processes under gloo, against the unsharded functions of both packages.

Each rank runs its batch rows, of the tokens and of the encoder states or
patch embeddings, its heads and its ff blocks. Cross-attention runs the
rank's heads: K/V over its rows of the frontend states, the flash
attention call non-causal at Sq != Sk, one all-reduce after ``wo``.
Whisper's encoder runs its rows (non-causal self-attention on its heads,
the GELU MLP column/row-parallel with ``b2`` added once) and gathers
them back. The decode state is built whole and cut by
``shard_decode_state``: the cross K/V on the rank's rows and heads.

* Whisper reduced (encoder 2 + decoder 2 layers, d 64, 4 heads of 16
  with QKV biases, d_ff 128, 24 frames): under ``sharding_rules``' own
  rules (tiny: data parallel only, no weight split), then under explicit
  rules with the model axis on (1 head and 32 ff columns a rank).
  ``encoder_forward``, ``forward``, ``prefill`` and 6 greedy
  ``decode_step``s each time.
* Llama-3.2-Vision reduced (4 layers, a cross layer every 2nd, d 64, 8
  query heads over 2 KV heads, so the self-attention caches split on the
  sequence; cross 8 heads, 2 a rank; 20 patches): ``forward``,
  ``prefill`` and 6 greedy ``decode_step``s; then a ring decode with
  ``window=4`` over 8 greedy steps; then the same under the rules of
  ``sharding_rules(..., baseline=True)``, which keep the 2 KV heads and
  so every K/V weight whole (``cross_rank`` narrows the cross ``wk`` /
  ``wv`` to the rank's 2 heads, so the cross K/V are computed for those
  alone; the self-attention caches whole).
* A cross-attention of 6 heads on a model axis of 4 (Whisper, MHA, d
  48): its weights stay whole on every rank and nothing is summed, and
  the decode state's cross K/V are whole on every rank too (cut by rows
  only), so ``forward``, ``prefill`` and 6 greedy ``decode_step``s equal
  the unsharded ones.

Every batch has 4 distinct rows (2 a rank), so a rank that took the
whole ``enc`` would attend over another row's states. Every bias leaf
(``b1``, ``b2``, ``bq/bk/bv`` of ``attn`` and ``cross``) is filled with
seeded non-zero values before the weights are bridged: zero biases would
hide a ``b2`` added on every rank. No flash-attention call of any part
takes a q, k or v that is not contiguous, which the CUDA kernel refuses.
One set of 8 ranks runs every case (its parts). Tolerances, fp32, as for
the ssm family:

* within 1e-5 x max |logits| of the port unsharded;
* within 2e-4 (rtol = atol) of the JAX package;
* greedy tokens equal, each step's top-two logit gap of the unsharded
  run above MIN_MARGIN 1e-4;
* ``shard_params`` then ``gather_tree``: bitwise the whole tree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtf
from repro_torch.models import transformer as ptf

from test_torch_distributed import _baseline_rules, _cfgs, held, run_ranks, \
    RULES
from test_torch_distributed_ssm import JAX_TOL, PORT_TOL, _greedy, within

GREEDY = 6
# one compile a config, where the eager step takes ~1 s a step
JAX_DECODE = jax.jit(jtf.decode_step, static_argnums=(1,),
                     static_argnames=("window",))
B = 4
BIASES = ("b1", "b2", "bq", "bk", "bv")
WHISPER = dict(reduce=dict(layers=2, d_model=64, vocab=128),
               replace=dict(dtype="float32", d_ff=128, encoder_frames=24))
VISION = dict(reduce=dict(layers=4, d_model=64, vocab=128),
              replace=dict(dtype="float32", num_heads=8, num_kv_heads=2,
                           head_dim=8, num_image_tokens=20))
# 6 heads of 8 (MHA): the self-attention pads them to 8, the cross keeps 6
SIX = dict(reduce=dict(layers=2, d_model=48, vocab=128),
           replace=dict(dtype="float32", num_heads=6, num_kv_heads=6,
                        head_dim=8, d_ff=128, encoder_frames=24))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_biases(tree, rng):
    """``tree`` (numpy leaves) with every bias leaf redrawn, N(0, 0.5)."""
    if isinstance(tree, dict):
        return {k: (rng.normal(0.0, 0.5, v.shape).astype(v.dtype)
                    if k in BIASES else _with_biases(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_with_biases(v, rng) for v in tree)
    return tree


class Model:
    """One config in both packages, the same weights (JAX ``init_params``,
    every bias non-zero), and seeded inputs of B distinct rows."""

    def __init__(self, arch, spec, seed):
        self.jcfg, self.cfg = _cfgs(arch, spec["reduce"], spec["replace"])
        jp = jtf.init_params(self.jcfg, jax.random.PRNGKey(seed))
        rng = np.random.default_rng(seed + 100)
        tree = _with_biases(jax.tree.map(np.asarray, jp), rng)
        self.biases = sum(1 for _ in _bias_leaves(tree))
        self.jp = jax.tree.map(jnp.asarray, tree)
        self.tp = ptf.from_jax_params(tree, device="cpu")
        c = self.cfg
        T = c.encoder_frames if c.family == "encdec" else c.num_image_tokens
        self.fe = rng.normal(size=(B, T, c.d_model)).astype(np.float32)
        self.toks = rng.integers(0, c.vocab_size, (B, 16))
        self.first = rng.integers(0, c.vocab_size, (B, 1))
        assert len({tuple(r) for r in self.toks}) == B
        self.spec = spec
        if c.family == "encdec":
            self.enc = ptf.encoder_forward(self.tp, c, torch.from_numpy(
                self.fe))
            self.jenc = jtf.encoder_forward(self.jp, self.jcfg,
                                            jnp.asarray(self.fe))
        else:
            self.enc, self.jenc = torch.from_numpy(self.fe), jnp.asarray(
                self.fe)

    def part(self, arch, rules, **extra):
        return dict(kind="model", arch=arch, rules=rules, **self.spec,
                    **extra)

    def inputs(self, tokens=True):
        key = "frames" if self.cfg.family == "encdec" else "patches"
        inp = {"params": self.tp, key: torch.from_numpy(self.fe),
               "steps": torch.from_numpy(self.first)}
        if tokens:
            inp["tokens"] = torch.from_numpy(self.toks)
        return inp

    def greedy(self, n, cache_len, window=None):
        """(tokens, logits) of ``n`` greedy steps, the port's and JAX's,
        tokens equal."""
        state = ptf.init_decode_state(self.tp, self.cfg, B, cache_len,
                                      enc=self.enc, device="cpu")
        jstate = jtf.init_decode_state(self.jp, self.jcfg, B, cache_len,
                                       enc=self.jenc)

        def step(tok, pos):
            nonlocal state
            lg, state = ptf.decode_step(self.tp, self.cfg, state,
                                        torch.from_numpy(tok).long(), pos,
                                        window=window)
            return lg

        def jstep(tok, pos):
            nonlocal jstate
            lg, jstate = JAX_DECODE(self.jp, self.jcfg, jstate,
                                    jnp.asarray(tok, jnp.int32),
                                    jnp.int32(pos), window=window)
            return lg

        toks, logits = _greedy(step, self.first, n)
        jtoks, jlogits = _greedy(jstep, self.first, n)
        np.testing.assert_array_equal(toks, jtoks)
        return toks, logits, jlogits


def _bias_leaves(tree, name=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _bias_leaves(v, k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _bias_leaves(v, name)
    elif name in BIASES:
        yield tree


def check_model(name, m, out, *, cache_len, window=None):
    """The ranks' encoder states, forward, prefill and greedy decode
    against both packages unsharded."""
    c, jc = m.cfg, m.jcfg
    assert out["flash_strided"] == []
    if "encoder" in out:
        held(f"{name}: port encoder vs JAX", m.enc, m.jenc, JAX_TOL)
        within(f"{name}: encoder (2x4) vs port unsharded", out["encoder"],
               m.enc, PORT_TOL)
        held(f"{name}: encoder (2x4) vs JAX", out["encoder"], m.jenc,
             JAX_TOL)
    if "prefill" in out:
        tt, jt = torch.from_numpy(m.toks), jnp.asarray(m.toks)
        want = ptf.prefill(m.tp, c, tt, enc=m.enc)
        want_j = jtf.prefill(m.jp, jc, jt, enc=m.jenc)
        held(f"{name}: port prefill vs JAX", want, want_j, JAX_TOL)
        within(f"{name}: prefill (2x4) vs port unsharded", out["prefill"],
               want, PORT_TOL)
        held(f"{name}: prefill (2x4) vs JAX", out["prefill"], want_j,
             JAX_TOL)
        h = ptf.forward(m.tp, c, tt, enc=m.enc)[0]
        within(f"{name}: forward (2x4) vs port unsharded", out["forward"],
               h, PORT_TOL)
        held(f"{name}: forward (2x4) vs JAX", out["forward"],
             jtf.forward(m.jp, jc, jt, enc=m.jenc)[0], JAX_TOL)
    if "decode" in out:
        got = out["decode"].numpy()
        toks, logits, jlogits = m.greedy(got.shape[0], cache_len, window)
        np.testing.assert_array_equal(got.argmax(-1).T, toks)
        within(f"{name}: greedy decode (2x4) vs port unsharded", got,
               logits, PORT_TOL)
        held(f"{name}: greedy decode (2x4) vs JAX", got, jlogits, JAX_TOL)


# ------------------------------------------- one set of ranks, 6 parts
@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """The models and the ranks' outputs of every part."""
    models = {"whisper": Model("whisper-tiny", WHISPER, 30),
              "vision": Model("llama-3.2-vision-11b", VISION, 31),
              "six": Model("whisper-tiny", SIX, 32)}
    w, v, six = models["whisper"], models["vision"], models["six"]
    parts = {
        "whisper_dp": w.part("whisper-tiny", None, cache_len=8,
                             greedy=GREEDY),
        "whisper_tp": w.part("whisper-tiny", RULES, cache_len=8,
                             greedy=GREEDY),
        "vision": v.part("llama-3.2-vision-11b", RULES, cache_len=8,
                         greedy=GREEDY),
        "vision_ring": v.part("llama-3.2-vision-11b", RULES, cache_len=4,
                              window=4, greedy=8),
        "vision_baseline": v.part(
            "llama-3.2-vision-11b",
            _baseline_rules("llama-3.2-vision-11b", num_kv_heads=2),
            cache_len=8, greedy=GREEDY),
        "six": six.part("whisper-tiny", RULES, cache_len=8, greedy=GREEDY)}
    inputs = {"whisper_dp": w.inputs(), "whisper_tp": w.inputs(),
              "vision": v.inputs(), "vision_ring": v.inputs(tokens=False),
              "vision_baseline": v.inputs(), "six": six.inputs()}
    out = run_ranks(tmp_path_factory.mktemp("cross"),
                    dict(kind="parts", parts=parts), inputs)[0]
    return models, out


def test_biases_are_filled(cross):
    """Whisper holds every bias kind, each leaf redrawn non-zero."""
    models, _ = cross
    w = models["whisper"]
    # per layer stack: enc attn bq/bk/bv + mlp b1/b2; dec attn, cross, mlp
    assert w.biases == 5 + 8
    for leaf in _bias_leaves(jax.tree.map(np.asarray, w.jp)):
        assert np.all(leaf != 0)


def test_whisper_data_parallel_matches_unsharded(cross):
    """``sharding_rules``' own rules for the reduced Whisper: tiny, so no
    model axis and no weight split; each rank runs its 2 rows with all 4
    heads (encoder calls [2, 24, 4, 16], non-causal)."""
    models, out = cross
    o = out["whisper_dp"]
    assert o["model_axis"] is None and o["split_leaves"] == 0
    assert o["flash_calls"][0] == ((2, 24, 4, 16), (2, 24, 4, 16), False)
    check_model("whisper dp", models["whisper"], o, cache_len=8)


def test_whisper_model_axis_matches_unsharded(cross):
    """Explicit rules with the model axis on: 1 head and 32 ff columns a
    rank. The flash calls of ``encoder_forward``, ``prefill`` and
    ``forward``: 2 encoder layers (self, non-causal, 24 frames), then per
    decoder layer its causal self-attention and its cross call (16
    queries over the rank's 2 rows of 24 encoder states, 1 head); the
    cross K/V of the state are the rank's rows and head."""
    models, out = cross
    o = out["whisper_tp"]
    enc = ((2, 24, 1, 16), (2, 24, 1, 16), False)
    dec = [((2, 16, 1, 16), (2, 16, 1, 16), True),
           ((2, 16, 1, 16), (2, 24, 1, 16), False)]
    # decode steps launch one cross call a layer (Sq = 1)
    step = [((2, 1, 1, 16), (2, 24, 1, 16), False)] * 2
    assert o["flash_calls"] == [enc] * 2 + dec * 2 * 2 + step * GREEDY
    check_model("whisper tp", models["whisper"], o, cache_len=8)


def test_vision_matches_unsharded(cross):
    """Two periods of (a self-attention layer, a cross layer): the 8 query
    heads padded to nothing (2 a rank) over 2 KV heads, so the decode's
    self-attention caches split on the sequence (2 of 8 slots a rank);
    the cross layer's calls: 16 queries (decode: 1) over the rank's 2
    rows of 20 patches, its 2 heads."""
    models, out = cross
    o = out["vision"]
    cross_call = ((2, 16, 2, 8), (2, 20, 2, 8), False)
    assert cross_call in o["flash_calls"]
    assert o["flash_calls"].count(cross_call) == 2 * 2   # prefill, forward
    assert o["flash_calls"][-1] == ((2, 1, 2, 8), (2, 20, 2, 8), False)
    assert o["state_shapes"][:2] == [(2, 2, 2, 8)] * 2
    check_model("vision", models["vision"], o, cache_len=8)


def test_vision_ring_window_decode(cross):
    """A ring of 4 slots (``window=4``, one a rank) over 8 greedy steps,
    so it wraps twice, beside the cross layers' K/V."""
    models, out = cross
    o = out["vision_ring"]
    assert o["state_shapes"][:2] == [(2, 1, 2, 8)] * 2
    check_model("vision ring", models["vision"], o, cache_len=4, window=4)


def test_vision_baseline_rules_match_unsharded(cross):
    """Unpadded heads and KV heads split only where they divide (not the
    2 on 4): ``wk`` / ``wv`` stay whole, so ``cross_rank`` narrows them
    and ``cross_kv`` runs the rank's 2 heads over its rows (its calls
    [2, 16, 2, 8] over [2, 20, 2, 8], every one contiguous); the decode
    state's cross K/V are cut by head all the same and its
    self-attention caches are whole."""
    models, out = cross
    o = out["vision_baseline"]
    assert o["model_axis"] == "model" and o["flash_strided"] == []
    assert ((2, 16, 2, 8), (2, 20, 2, 8), False) in o["flash_calls"]
    assert o["state_shapes"][:2] == [(2, 8, 2, 8)] * 2
    check_model("vision baseline", models["vision"], o, cache_len=8)


def test_cross_heads_that_do_not_split(cross):
    """6 cross heads on a model axis of 4: the cross weights stay whole
    (no padding, as in the JAX package) and the cross calls run all 6
    heads on the rank's rows, at prefill and at every decode step (the
    decode state's cross K/V cut by rows only), so ``forward``,
    ``prefill`` and the greedy decode equal the unsharded ones."""
    models, out = cross
    o = out["six"]
    assert ((2, 16, 6, 8), (2, 24, 6, 8), False) in o["flash_calls"]
    assert o["flash_calls"][-1] == ((2, 1, 6, 8), (2, 24, 6, 8), False)
    check_model("six heads", models["six"], o, cache_len=8)
