"""The ssm and hybrid families under a (data 2, model 4) mesh of 8 CPU
processes under gloo, against the unsharded functions of both packages.

Each rank runs its batch rows, and the SSD mixer is split by head over
the model axis: ``in_z`` / ``in_xbc`` / ``in_dt`` and the conv
column-parallel, ``out_proj`` row-parallel, ``ssd_chunk`` on the rank's
heads, the ``ssd`` decode state cut on its heads by
``shard_decode_state`` and the conv state whole. The configs give the
SSM 8 heads of 16 and a state of 16: d_inner 128, xBC 160 columns, 40 a
rank against its 32 x channels, so B and C lie on the last model rank
alone and the redistribution after the conv is exercised.

* Mamba2 reduced: ``forward``, ``prefill`` and 6 greedy
  ``decode_step``s.
* Jamba reduced (attention every 2nd layer, 4 query heads over 2 KV
  heads, so the KV cache splits on the sequence; 4 experts on the 4
  model ranks): ``prefill``, ``forward`` and 6 greedy ``decode_step``s;
  then a ring decode with ``window=4`` over 8 greedy steps beside the
  SSM state.

Each is held against the port unsharded and against the JAX package
unsharded (its XLA SSD step, as its own tests run it), on the same
weights (JAX ``init_params``, bridged). Tolerances, fp32:

* logits within 1e-5 x max |logits| of the port unsharded (the ranks
  sum ``out_proj``'s and ``wo``'s partial products and the norm's block
  means over the model axis: another summation order);
* logits within 2e-4 (rtol = atol) of the JAX package;
* greedy tokens equal, each step's gap between the top two logits and
  every router top-k margin of the unsharded run above MIN_MARGIN 1e-4;
* ``shard_params`` then ``gather_tree``: bitwise the whole tree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtf
from repro_torch.models import moe as pmoe
from repro_torch.models import sharding as pshd
from repro_torch.models import ssm as pssm
from repro_torch.models import transformer as ptf

from test_torch_distributed import MIN_MARGIN, RULES, _bridge, _cfgs, \
    held, run_ranks

PORT_TOL = 1e-5       # x max |logits|, against the port unsharded
JAX_TOL = 2e-4        # rtol = atol, against the JAX package
# 8 SSM heads of 16, state 16; chunks of 4 (4 of them in 16 positions)
SSM = dict(dtype="float32", ssm_headdim=16, ssm_state=16, ssm_chunk=4)
GREEDY = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def router_margins(monkeypatch):
    """The smallest top-k router margin of every port ``router_probs``
    call in this process (the unsharded runs)."""
    seen = []
    orig = pmoe.router_probs

    def wrapped(p, cfg, x):
        out = orig(p, cfg, x)
        k = cfg.num_experts_per_tok
        srt = torch.sort(out[0], dim=-1, descending=True).values
        seen.append(float((srt[..., k - 1] - srt[..., k]).min()))
        return out

    monkeypatch.setattr(pmoe, "router_probs", wrapped)
    return seen


def within(name, got, want, rel):
    """max |got - want| <= rel x max |want|, printing both."""
    got, want = np.asarray(got), np.asarray(want)
    err, scale = float(np.max(np.abs(got - want))), float(np.max(np.abs(
        want)))
    print(f"{name}: max |diff| {err:.3e} (limit {rel:g} x {scale:.3e})")
    assert err <= rel * scale, (name, err, scale)


def _greedy(step, first, n):
    """(tokens [B, n], logits [n, B, V]) of ``n`` greedy steps from the
    tokens ``first`` [B, 1]; ``step(tok, pos)`` -> logits."""
    tok, toks, logits = first, [], []
    for pos in range(n):
        lg = np.asarray(step(tok, pos))
        top2 = np.sort(lg, axis=-1)[:, -2:]
        assert float((top2[:, 1] - top2[:, 0]).min()) > MIN_MARGIN, pos
        tok = lg.argmax(-1)[:, None]
        toks.append(tok)
        logits.append(lg)
    return np.concatenate(toks, 1), np.stack(logits)


def port_greedy(params, cfg, first, n, cache_len, window=None):
    state = ptf.init_decode_state(params, cfg, first.shape[0], cache_len,
                                  device="cpu")

    def step(tok, pos):
        nonlocal state
        lg, state = ptf.decode_step(params, cfg, state, torch.from_numpy(
            np.asarray(tok)).long(), pos, window=window)
        return lg
    return _greedy(step, first, n)


def jax_greedy(params, cfg, first, n, cache_len, window=None):
    state = jtf.init_decode_state(params, cfg, first.shape[0], cache_len)

    def step(tok, pos):
        nonlocal state
        lg, state = jtf.decode_step(params, cfg, state, jnp.asarray(
            tok, jnp.int32), jnp.int32(pos), window=window)
        return lg
    return _greedy(step, first, n)


def _check(name, out, jp, tp, jcfg, pc, toks, first, cache_len,
           window=None):
    """The ranks' outputs against both packages unsharded."""
    if toks is not None:
        tt = torch.from_numpy(toks)
        want, want_j = (ptf.prefill(tp, pc, tt),
                        jtf.prefill(jp, jcfg, jnp.asarray(toks)))
        held(f"{name}: port prefill vs JAX", want, want_j, JAX_TOL)
        within(f"{name}: prefill (2x4) vs port unsharded", out["prefill"],
               want, PORT_TOL)
        held(f"{name}: prefill (2x4) vs JAX", out["prefill"], want_j,
             JAX_TOL)
        h = ptf.forward(tp, pc, tt)[0]
        within(f"{name}: forward (2x4) vs port unsharded", out["forward"],
               h, PORT_TOL)
        held(f"{name}: forward (2x4) vs JAX", out["forward"],
             jtf.forward(jp, jcfg, jnp.asarray(toks))[0], JAX_TOL)
    n = out["decode"].shape[0]
    p_toks, p_logits = port_greedy(tp, pc, first, n, cache_len, window)
    j_toks, j_logits = jax_greedy(jp, jcfg, first, n, cache_len, window)
    np.testing.assert_array_equal(p_toks, j_toks)
    got = out["decode"].numpy()
    np.testing.assert_array_equal(got.argmax(-1).T, p_toks)
    within(f"{name}: greedy decode (2x4) vs port unsharded", got, p_logits,
           PORT_TOL)
    held(f"{name}: greedy decode (2x4) vs JAX", got, j_logits, JAX_TOL)


def _case(arch, reduce, replace, seed, **extra):
    jcfg, pc = _cfgs(arch, reduce, replace)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    case = dict(kind="model", arch=arch, reduce=reduce, replace=replace,
                rules=RULES, **extra)
    return jcfg, pc, jp, _bridge(jp), case


# ------------------------------------------------------------ Mamba2
def test_mamba2_under_the_mesh_matches_unsharded(tmp_path):
    """``prefill``, ``forward`` and 6 greedy decode steps; ``ssd_chunk``
    ran once a layer on the rank's 2 heads; the decode state is the
    rank's rows and heads (``ssd`` [2, 2, 16, 16]) and whole conv rows
    ([2, 3, 160])."""
    jcfg, pc, jp, tp, case = _case(
        "mamba2-2.7b", dict(layers=2, d_model=64, vocab=128), SSM, 20,
        cache_len=8, greedy=GREEDY)
    assert (pc.d_inner, pc.ssm_nheads) == (128, 8)
    rng = np.random.default_rng(21)
    toks = rng.integers(0, 128, (4, 16))
    first = rng.integers(0, 128, (4, 1))
    out = run_ranks(tmp_path, case, {"params": tp,
                                     "tokens": torch.from_numpy(toks),
                                     "steps": torch.from_numpy(first)})[0]
    assert out["state_shapes"] == [(2, 2, 16, 16), (2, 3, 160)]
    # prefill and forward: G = 2 rows x 4 chunks, Q 4, the rank's 2 heads
    assert out["ssd_calls"] == [(8, 4, 2)] * (2 * pc.num_layers)
    _check("mamba2", out, jp, tp, jcfg, pc, toks, first, cache_len=8)


# ------------------------------------------------------------- Jamba
JAMBA = dict(reduce=dict(layers=4, d_model=64, experts=4, vocab=128),
             replace=dict(SSM, num_kv_heads=2))


def test_jamba_under_the_mesh_matches_unsharded(tmp_path, router_margins):
    """Two periods of (attention + dense SwiGLU, SSM + 4-expert MoE):
    ``prefill``, ``forward`` and 6 greedy decode steps. The 2 KV heads do
    not split over 4: the KV cache splits on the sequence."""
    jcfg, pc, jp, tp, case = _case("jamba-1.5-large-398b", seed=22,
                                   cache_len=8, greedy=GREEDY, **JAMBA)
    assert (pc.attn_every, pc.num_heads, pc.num_kv_heads,
            pc.num_experts) == (2, 4, 2, 4)
    rng = np.random.default_rng(23)
    toks = rng.integers(0, 128, (4, 16))
    first = rng.integers(0, 128, (4, 1))
    out = run_ranks(tmp_path, case, {"params": tp,
                                     "tokens": torch.from_numpy(toks),
                                     "steps": torch.from_numpy(first)})[0]
    # k / v [rows, 8 / 4 slots, KV, hd], then ssd and conv
    assert out["state_shapes"] == [(2, 2, 2, 16), (2, 2, 2, 16),
                                   (2, 2, 16, 16), (2, 3, 160)]
    assert out["ssd_calls"] == [(8, 4, 2)] * 4
    _check("jamba", out, jp, tp, jcfg, pc, toks, first, cache_len=8)
    assert min(router_margins) > MIN_MARGIN, min(router_margins)


def test_jamba_ring_window_decode_under_the_mesh(tmp_path, router_margins):
    """A ring of 4 slots (``window=4``, one a rank) over 8 greedy steps,
    so it wraps twice, beside the SSM state."""
    jcfg, pc, jp, tp, case = _case("jamba-1.5-large-398b", seed=24,
                                   cache_len=4, window=4, greedy=8, **JAMBA)
    first = np.random.default_rng(25).integers(0, 128, (4, 1))
    out = run_ranks(tmp_path, case, {"params": tp,
                                     "steps": torch.from_numpy(first)})[0]
    assert out["state_shapes"][:2] == [(2, 1, 2, 16)] * 2
    _check("jamba window", out, jp, tp, jcfg, pc, None, first, cache_len=4,
           window=4)
    assert min(router_margins) > MIN_MARGIN, min(router_margins)


class _StandInMesh:
    """What the rules read of a mesh: the (2, 4) mesh's names and sizes
    (the SSM checks its heads before it asks for a rank)."""
    mesh_dim_names = ("data", "model")

    def size(self, i):
        return (2, 4)[i]


def test_heads_that_do_not_split_raise():
    """6 SSM heads on a model axis of 4: ``ssd_full`` and ``ssd_decode``
    name the heads and the axis, as a batch that does not split does."""
    _, pc = _cfgs("mamba2-2.7b", dict(layers=1, d_model=48, vocab=128),
                  SSM)
    assert pc.ssm_nheads == 6
    p = ptf._layer(ptf.init_params(pc, torch.Generator().manual_seed(0),
                                   device="cpu")["layers"], 0)["ssm"]
    x = torch.zeros((2, 8, 48))
    state = pssm.ssm_state_init(pc, 2, torch.float32, device="cpu")
    with pshd.sharding_ctx(_StandInMesh(), RULES):
        for run in (lambda: pssm.ssd_full(p, pc, x),
                    lambda: pssm.ssd_decode(p, pc, x[:, :1], state)):
            with pytest.raises(ValueError,
                               match=r"6 heads do not split over 'model' "
                                     r"\(4 ranks\)"):
                run()
