"""The port's kernel wrappers on the CPU: each plain version (the path a
CPU tensor takes) against the JAX package's Pallas kernel in interpret
mode and its jnp oracle, on the shapes of ``test_kernels.py``. The CUDA
kernels themselves run only on the card: ``chip_smoke.py`` holds each
against its plain version there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is faster than a pool, and keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(a)


# ------------------------------------------------------------ moe_ffn
MOE_SHAPES = [
    (2, 32, 128, 256, dict(block_c=32, block_f=128)),
    (4, 96, 128, 384, dict(block_c=32, block_f=128)),
    (3, 40, 256, 512, dict(block_c=32, block_f=128)),  # padding path
    (1, 8, 128, 128, dict(block_c=32, block_f=128)),
    (2, 12, 130, 96, {}),     # d and F off the (8,128) tile grid
    (1, 5, 64, 500, {}),      # tiny C, ragged F
    (2, 7, 100, 130, {}),     # everything ragged
    (4, 3, 200, 640, {}),     # decode-sized C with auto blocks
]


@pytest.mark.parametrize("E,C,d,F,blocks", MOE_SHAPES)
def test_moe_ffn_plain_matches_pallas_and_oracle(E, C, d, F, blocks):
    rng = np.random.default_rng(E * 1000 + C)
    x = _rand(rng, (E, C, d), 0.5)
    w1, w3 = _rand(rng, (E, d, F), 0.05), _rand(rng, (E, d, F), 0.05)
    w2 = _rand(rng, (E, F, d), 0.05)
    (jx, tx), (j1, t1), (j3, t3), (j2, t2) = map(_both, (x, w1, w3, w2))
    got = ops.moe_ffn(tx, t1, t3, t2, list(range(E))).numpy()
    pallas = jops.moe_ffn(jx, j1, j3, j2, impl="pallas_interpret", **blocks)
    oracle = jref.moe_gemm_ref(jx, j1, j3, j2)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=1e-4, atol=1e-4)


def test_moe_ffn_reads_slots_in_place():
    """Slot indices select weight slots (in any order, a subset of S):
    the result equals running on the gathered experts."""
    rng = np.random.default_rng(1)
    S, E, C, d, F = 5, 3, 4, 32, 48
    x = torch.from_numpy(_rand(rng, (E, C, d)))
    w1, w3 = (torch.from_numpy(_rand(rng, (S, d, F), 0.1)) for _ in range(2))
    w2 = torch.from_numpy(_rand(rng, (S, F, d), 0.1))
    slots = [4, 0, 2]
    got = ops.moe_ffn(x, w1, w3, w2, slots)
    want = ops.moe_ffn(x, w1[slots], w3[slots], w2[slots], [0, 1, 2])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("bad", [
    dict(slots=[0, 5]),                     # slot out of range
    dict(slots=[0]),                        # one index per group
    dict(w2=torch.zeros(2, 16, 8)),         # w2 not [S,F,d]
    dict(x_e=torch.zeros(2, 3, 8)),         # d disagrees with w1
])
def test_moe_ffn_rejects_what_it_cannot_take(bad):
    args = dict(x_e=torch.zeros(2, 3, 16), w1=torch.zeros(2, 16, 8),
                w3=torch.zeros(2, 16, 8), w2=torch.zeros(2, 8, 16),
                slots=[0, 1])
    args.update(bad)
    with pytest.raises(ValueError):
        ops.moe_ffn(**args)


# ---------------------------------------------------- paged attention
PAGED_SHAPES = [
    (2, 4, 2, 64, 8, 8, 3),
    (3, 4, 4, 64, 10, 16, 2),    # MHA (no grouping)
    (1, 8, 1, 128, 6, 8, 4),     # MQA, deeper table
]


@pytest.mark.parametrize("B,H,KV,hd,N,bs,T", PAGED_SHAPES)
def test_paged_attention_plain_matches_pallas(B, H, KV, hd, N, bs, T):
    rng = np.random.default_rng(B * 100 + H)
    q = _rand(rng, (B, H, hd))
    kp, vp = _rand(rng, (N, bs, KV, hd)), _rand(rng, (N, bs, KV, hd))
    bt = rng.integers(0, N, (B, T)).astype(np.int32)
    pos = rng.integers(0, T * bs, (B,)).astype(np.int32)
    (jq, tq), (jk, tk), (jv, tv), (jb, tb), (jp, tpos) = map(
        _both, (q, kp, vp, bt, pos))
    got = ops.paged_attention(tq, tk, tv, tb, tpos).numpy()
    want = jops.paged_attention(jq, jk, jv, jb, jp, impl="pallas_interpret")
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)
    oracle = jops.paged_attention(jq, jk, jv, jb, jp, impl="xla")
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=2e-4, atol=2e-4)


def test_paged_attention_identity_table_is_plain_decode_attention():
    """An identity block table with every key visible is ordinary
    softmax attention over the contiguous K/V."""
    rng = np.random.default_rng(7)
    B, H, KV, hd, bs, T = 2, 4, 2, 64, 8, 4
    q = torch.from_numpy(_rand(rng, (B, H, hd)))
    kp = torch.from_numpy(_rand(rng, (T, bs, KV, hd)))
    vp = torch.from_numpy(_rand(rng, (T, bs, KV, hd)))
    bt = torch.arange(T, dtype=torch.int32)[None].repeat(B, 1)
    pos = torch.full((B,), T * bs - 1, dtype=torch.int32)
    got = ops.paged_attention(q, kp, vp, bt, pos)
    k = kp.reshape(T * bs, KV, hd).repeat_interleave(H // KV, dim=1)
    v = vp.reshape(T * bs, KV, hd).repeat_interleave(H // KV, dim=1)
    w = torch.softmax(torch.einsum("bhd,lhd->bhl", q, k) / hd ** 0.5, -1)
    torch.testing.assert_close(got, torch.einsum("bhl,lhd->bhd", w, v),
                               rtol=2e-4, atol=2e-4)


def test_paged_attention_rejects_mismatched_shapes():
    q = torch.zeros(2, 4, 8)
    pool = torch.zeros(3, 4, 2, 8)
    tbl = torch.zeros(2, 1, dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.paged_attention(q, pool, pool, tbl, torch.zeros(3))
    with pytest.raises(ValueError):
        ops.paged_attention(torch.zeros(2, 3, 8), pool, pool, tbl,
                            torch.zeros(2))


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    ops.reset_launch_counts()
    x = torch.zeros(1, 2, 8)
    ops.moe_ffn(x, torch.zeros(1, 8, 4), torch.zeros(1, 8, 4),
                torch.zeros(1, 4, 8), [0])
    ops.paged_attention(torch.zeros(1, 2, 8), torch.zeros(2, 4, 1, 8),
                        torch.zeros(2, 4, 1, 8),
                        torch.zeros(1, 1, dtype=torch.int32),
                        torch.zeros(1, dtype=torch.int32))
    assert ops.launch_counts() == {"moe_ffn": 0, "paged_attention": 0}


def test_unsupported_device_raises():
    m = torch.zeros(1, 2, 8, device="meta")
    with pytest.raises(ValueError):
        ops.moe_ffn(m, torch.zeros(1, 8, 4, device="meta"),
                    torch.zeros(1, 8, 4, device="meta"),
                    torch.zeros(1, 4, 8, device="meta"), [0])
