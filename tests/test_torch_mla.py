"""The port's MLA attention (DeepSeek-V2) against the JAX package's, on
shared weights (JAX ``init_mla``, bridged with ``from_jax_params``) and
shared inputs made with numpy, at the reduced DeepSeek-V2 widths (4
heads of hd 16, ``kv_lora_rank`` 64, ``qk_rope_dim`` 32): the query and
latent projections, ``mla_full`` (JAX under its XLA blockwise attention
and under the Pallas flash kernel in interpret mode), the absorbed
decode over a dense cache, over a ring (sliding window, wrapped) and
over a paged latent pool, and paged == dense decode bit for bit on the
CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny
from repro.models import attention as jattn
from repro_torch.models import attention as pattn
from repro_torch.models import transformer as ptf


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is faster than a pool, and keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=2e-5, atol=2e-5)   # fp32, different summation order


@pytest.fixture(scope="module")
def mla():
    """The reduced DeepSeek-V2 of ``tests/test_offload_deepseek.py`` and
    one layer's MLA params in both packages."""
    cfg = tiny("deepseek-v2-236b", layers=2, d_model=64, experts=4,
               vocab=512)
    assert cfg.use_mla and cfg.kv_lora_rank == 64 and cfg.qk_rope_dim == 32
    jp = jattn.init_mla(jax.random.PRNGKey(0), cfg, jnp.float32)
    tp = ptf.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _x(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _cache(rng, cfg, lead):
    return {"latent": _x(rng, *lead, cfg.kv_lora_rank),
            "k_rope": _x(rng, *lead, cfg.qk_rope_dim)}


def _jnp(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _same_cache(pc, jc):
    for k in ("latent", "k_rope"):
        np.testing.assert_allclose(pc[k].numpy(), np.asarray(jc[k]), **TOL)


def test_mla_projections_match_reference(mla):
    cfg, jp, tp = mla
    rng = np.random.default_rng(0)
    x = _x(rng, 2, 5, cfg.d_model)
    pos = np.array([[0, 1, 2, 3, 4], [7, 19, 40, 41, 300]], np.int32)
    jq = jattn._mla_q(jp, cfg, jnp.asarray(x), jnp.asarray(pos))
    pq = pattn._mla_q(tp, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    jl = jattn._mla_latent(jp, cfg, jnp.asarray(x), jnp.asarray(pos))
    pl = pattn._mla_latent(tp, cfg, torch.from_numpy(x),
                           torch.from_numpy(pos))
    for got, want in zip(pq + pl, jq + jl):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["xla_blockwise", "pallas_interpret"])
def test_mla_full_matches_reference(mla, impl, monkeypatch):
    """q/k width hd + rd = 48, v width hd = 16, through the port's
    flash-attention wrapper; S = 40 is off every block size. Windowed
    too."""
    cfg, jp, tp = mla
    rng = np.random.default_rng(1)
    B, S = 2, 40
    x = _x(rng, B, S, cfg.d_model)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    monkeypatch.setattr(jattn, "ATTN_IMPL", impl)
    calls = []
    orig = pattn.kops.flash_attention
    monkeypatch.setattr(pattn.kops, "flash_attention", lambda q, k, v, **kw:
                        calls.append((q.shape, v.shape)) or orig(q, k, v,
                                                                 **kw))
    for window in (None, 9):
        want = jattn.mla_full(jp, cfg, jnp.asarray(x), jnp.asarray(pos),
                              window=window)
        got = pattn.mla_full(tp, cfg, torch.from_numpy(x),
                             torch.from_numpy(pos.copy()), window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    hd, rd, H = cfg.head_dim, cfg.qk_rope_dim, cfg.num_heads
    assert calls == [((B, S, H, hd + rd), (B, S, H, hd))] * 2


def test_mla_decode_multipos_matches_reference(mla):
    cfg, jp, tp = mla
    rng = np.random.default_rng(2)
    B, L = 3, 12
    cache = _cache(rng, cfg, (B, L))
    x = _x(rng, B, 1, cfg.d_model)
    pos = np.array([0, 5, 11], np.int32)
    jy, jc = jattn.mla_decode_multipos(jp, cfg, jnp.asarray(x), _jnp(cache),
                                       jnp.asarray(pos))
    pc = _torch(cache)
    py, out = pattn.mla_decode_multipos(tp, cfg, torch.from_numpy(x), pc,
                                        torch.from_numpy(pos))
    assert out is pc                          # updated in place
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), **TOL)
    _same_cache(pc, jc)


@pytest.mark.parametrize("window", [None, 5])
def test_mla_decode_matches_reference(mla, window):
    """Scalar-position decode, 9 steps: without a window over a cache of
    9 positions (the multipos core), with one over a ring of 5 slots,
    which wraps at step 5 (slot i then holds position pos - ((pos - i)
    mod 5))."""
    cfg, jp, tp = mla
    rng = np.random.default_rng(3)
    B, steps = 2, 9
    L = window or steps
    jc = jattn.mla_cache_init(cfg, B, L, jnp.float32)
    pc = pattn.mla_cache_init(cfg, B, L, torch.float32, device="cpu")
    for pos in range(steps):
        x = _x(rng, B, 1, cfg.d_model)
        jy, jc = jattn.mla_decode(jp, cfg, jnp.asarray(x), jc,
                                  jnp.int32(pos), window=window)
        py, pc = pattn.mla_decode(tp, cfg, torch.from_numpy(x), pc, pos,
                                  window=window)
        np.testing.assert_allclose(py.numpy(), np.asarray(jy), **TOL)
        _same_cache(pc, jc)


def _paged_case(cfg, rng):
    """Pool of 8 blocks of 4 plus the sink (block 8). Rows 0 and 1 are
    live requests; rows 2 and 3 are two virtual rows of one chunk (same
    table, consecutive positions: row 3 must see row 2's fresh latent);
    row 4 is an inactive row whose table is all sink."""
    N, bs = 9, 4
    pool = _cache(rng, cfg, (N, bs))
    tables = np.array([[3, 1, 8], [5, 0, 8], [2, 6, 7], [2, 6, 7],
                       [8, 8, 8]], np.int32)
    pos = np.array([6, 2, 9, 10, 0], np.int32)
    x = _x(rng, 5, 1, cfg.d_model)
    return pool, tables, pos, x


def test_mla_decode_paged_matches_reference(mla):
    cfg, jp, tp = mla
    pool, tables, pos, x = _paged_case(cfg, np.random.default_rng(4))
    jy, jc = jattn.mla_decode_paged(jp, cfg, jnp.asarray(x), _jnp(pool),
                                    jnp.asarray(pos), jnp.asarray(tables))
    pc = _torch(pool)
    py, out = pattn.mla_decode_paged(tp, cfg, torch.from_numpy(x), pc,
                                     torch.from_numpy(pos),
                                     torch.from_numpy(tables))
    assert out is pc
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), **TOL)
    _same_cache(pc, jc)
    # row 3 read row 2's scatter: without it the output moves
    alone = _torch(pool)
    y3, _ = pattn.mla_decode_paged(tp, cfg, torch.from_numpy(x[3:4]), alone,
                                   torch.from_numpy(pos[3:4]),
                                   torch.from_numpy(tables[3:4]))
    assert not torch.allclose(y3, py[3:4], rtol=1e-4, atol=1e-4)


def test_mla_paged_equals_multipos_bitwise(mla):
    """The same rows through a dense cache of L = T*bs positions and
    through a shuffled block table (stale values in every other block,
    one row's table ending in the sink block): bit for bit the same
    outputs, and the same rows written."""
    cfg, _, tp = mla
    rng = np.random.default_rng(5)
    B, bs, T = 3, 4, 3
    L = bs * T
    dense = _cache(rng, cfg, (B, L))
    tables = np.array([[4, 0, 2], [1, 6, 3], [7, 5, 8]], np.int32)
    pool = _cache(rng, cfg, (9, bs))             # stale everywhere
    for b in range(B):
        for j in range(T):
            for k in pool:
                pool[k][tables[b, j]] = dense[k][b, j * bs:(j + 1) * bs]
    x = torch.from_numpy(_x(rng, B, 1, cfg.d_model))
    pos = torch.tensor([5, 10, 0], dtype=torch.int32)
    dc, pc = _torch(dense), _torch(pool)
    yd, _ = pattn.mla_decode_multipos(tp, cfg, x, dc, pos)
    yp, _ = pattn.mla_decode_paged(tp, cfg, x, pc, pos,
                                   torch.from_numpy(tables))
    assert torch.equal(yp, yd)
    for b in range(B):
        p = int(pos[b])
        blk = tables[b, p // bs]
        for k in dc:
            assert torch.equal(pc[k][blk, p % bs], dc[k][b, p])
