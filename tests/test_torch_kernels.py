"""The port's kernel wrappers on the CPU: each plain version (the path a
CPU tensor takes) against the JAX package's Pallas kernel in interpret
mode and its jnp oracle, on the shapes of ``test_kernels.py``, and the
wrappers' argument checks. The CUDA
kernels themselves run only on the card: ``chip_smoke.py`` holds each
against its plain version there."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_chunk as ssd_mod


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


def _split_combine(q, kp, vp, bt, pos, S):
    """The CUDA kernel's arithmetic written out: row b's visible keys
    (0..pos, or all T * bs when pos < 0) in splits of S keys; each split
    keeps (m, l, o) of its own keys, and the splits are combined in split
    order: M = max m_s, out = sum o_s e^(m_s - M) / sum l_s e^(m_s - M)."""
    B, H, hd = q.shape
    bs, KV = kp.shape[1], kp.shape[2]
    T = bt.shape[1]
    G = H // KV
    k = kp[bt.long()].reshape(B, T * bs, KV, hd)
    v = vp[bt.long()].reshape(B, T * bs, KV, hd)
    out = torch.empty(B, KV, G, hd)
    for b in range(B):
        p = int(pos[b])
        n = T * bs if p < 0 else min(p + 1, T * bs)
        qb = q[b].reshape(KV, G, hd)
        parts = []
        for k0 in range(0, n, S):
            kk, vv = k[b, k0:k0 + S][:n - k0], v[b, k0:k0 + S][:n - k0]
            sc = torch.einsum("kgd,lkd->kgl", qb, kk) / math.sqrt(hd)
            if p < 0:
                sc = torch.full_like(sc, -1e30)
            m = sc.max(-1).values
            w = torch.exp(sc - m[..., None])
            parts.append((m, w.sum(-1), torch.einsum("kgl,lkd->kgd", w, vv)))
        M = torch.stack([m for m, _, _ in parts]).max(0).values
        L, O = torch.zeros_like(M), torch.zeros(KV, G, hd)
        for m, l, o in parts:
            e = torch.exp(m - M)
            L, O = L + l * e, O + o * e[..., None]
        out[b] = O / torch.clamp(L, min=1e-30)[..., None]
    return out.reshape(B, H, hd)


@pytest.mark.parametrize("S", [32, 128])
def test_paged_attention_split_combine_matches_pallas(S):
    """Splitting a row's keys over blocks and combining their partials in
    split order gives the Pallas kernel's output, with positions on split
    boundaries (S - 1, S), at 0, at -1 (uniform over every key) and
    full."""
    rng = np.random.default_rng(S)
    B, H, KV, hd, N, bs, T = 5, 8, 2, 64, 24, 16, 16
    q = _rand(rng, (B, H, hd))
    kp, vp = _rand(rng, (N, bs, KV, hd)), _rand(rng, (N, bs, KV, hd))
    bt = rng.integers(0, N, (B, T)).astype(np.int32)
    pos = np.array([S - 1, S, 0, -1, T * bs - 1], np.int32)
    (jq, tq), (jk, tk), (jv, tv), (jb, tb), (jp, tpos) = map(
        _both, (q, kp, vp, bt, pos))
    got = _split_combine(tq, tk, tv, tb, tpos, S).numpy()
    want = jops.paged_attention(jq, jk, jv, jb, jp, impl="pallas_interpret")
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)


def test_paged_attention_rejects_mismatched_shapes():
    q = torch.zeros(2, 4, 8)
    pool = torch.zeros(3, 4, 2, 8)
    tbl = torch.zeros(2, 1, dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.paged_attention(q, pool, pool, tbl, torch.zeros(3))
    with pytest.raises(ValueError):
        ops.paged_attention(torch.zeros(2, 3, 8), pool, pool, tbl,
                            torch.zeros(2))


# ------------------------------------------------------ flash attention
FLASH_SHAPES = [
    (1, 64, 2, 2, 64),
    (2, 160, 4, 2, 64),    # GQA, S off the 64-row block
    (1, 96, 4, 1, 128),    # MQA
]


@pytest.mark.parametrize("B,S,H,KV,hd", FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 37])
def test_flash_attention_plain_matches_pallas(B, S, H, KV, hd, causal,
                                              window):
    """The wrapper on CPU tensors against the Pallas kernel in interpret
    mode (64-row blocks, so the ragged S=160 takes its padding path)
    and the jnp oracle. fp32; tolerance 2e-4 (summation order)."""
    rng = np.random.default_rng(S * 10 + H + window)
    q, k, v = (_rand(rng, (B, S, n, hd)) for n in (H, KV, KV))
    (jq, tq), (jk, tk), (jv, tv) = map(_both, (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal,
                              window=window).numpy()
    for impl, blocks in (("pallas_interpret", dict(block_q=64, block_k=64)),
                         ("xla", {})):
        want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                    impl=impl, **blocks)
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4,
                                   atol=2e-4)


def test_flash_attention_plain_narrow_values_matches_pallas():
    """v narrower than q/k (MLA: qk width hd + rope, v width hd)."""
    rng = np.random.default_rng(11)
    q, k = _rand(rng, (2, 48, 4, 96)), _rand(rng, (2, 48, 2, 96))
    v = _rand(rng, (2, 48, 2, 64))
    (jq, tq), (jk, tk), (jv, tv) = map(_both, (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert tuple(got.shape) == (2, 48, 4, 64)
    want = jops.flash_attention(jq, jk, jv, causal=True,
                                impl="pallas_interpret", block_q=16,
                                block_k=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_flash_attention_plain_bf16_matches_pallas():
    """bf16 inputs, output in bf16: against the Pallas kernel on the same
    bf16 inputs (bf16 rounding of the output: 2e-2) and against fp32
    attention on the widened inputs."""
    rng = np.random.default_rng(12)
    q, k, v = (_rand(rng, (1, 128, 2, 64)) for _ in range(3))
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = ops.flash_attention(*tb)
    assert got.dtype == torch.bfloat16
    want = jops.flash_attention(*jb, impl="pallas_interpret", block_q=64,
                                block_k=64)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)
    exact = ops.flash_attention(*(t.float() for t in tb))
    torch.testing.assert_close(got.float(), exact, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("bad", [
    dict(k=torch.zeros(1, 8, 3, 16)),       # H % KV != 0
    dict(v=torch.zeros(1, 8, 2, 32)),       # v wider than q/k
    dict(k=torch.zeros(1, 8, 2, 8)),        # k width != q width
    dict(q=torch.zeros(8, 4, 16)),          # not [B,S,H,hd]
    dict(window=-1),
])
def test_flash_attention_rejects_what_it_cannot_take(bad):
    args = dict(q=torch.zeros(1, 8, 4, 16), k=torch.zeros(1, 8, 2, 16),
                v=torch.zeros(1, 8, 2, 16), window=0)
    args.update(bad)
    with pytest.raises(ValueError):
        ops.flash_attention(args["q"], args["k"], args["v"],
                            window=args["window"])


def _tf32(x):
    """fp32 -> TF32 (10 mantissa bits), to nearest with ties away from
    zero: ``cvt.rna.tf32.f32``'s rounding, by the bit masking the CUDA
    kernel does, ``(bits + 0x1000) & ~0x1fff``."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm_tf32(a, b, passes):
    """a @ b on TF32 operands, fp32 sums: one pass (hi.hi) or the
    kernel's 3xTF32 split (lo.hi + hi.lo + hi.hi, lo = tf32(x - hi))."""
    if passes == 0:                      # no rounding: the float64 oracle
        return a @ b
    ah, bh = _tf32(a), _tf32(b)
    out = ah @ bh
    if passes == 3:
        out = _tf32(a - ah) @ bh + ah @ _tf32(b - bh) + out
    return out


def test_flash_attention_tf32_split_error():
    """The precision argument for the CUDA kernel's tensor-core design,
    on the CPU: causal attention at hd 128 with both products on TF32
    operands. One TF32 pass misses flash attention's fp32 tolerance
    (2e-4 against the plain version, unchanged); the 3xTF32 split the
    kernel runs holds it with room (~1e-6, the error of fp32 itself)."""
    rng = np.random.default_rng(14)
    B, S, H, KV, hd = 1, 256, 4, 2, 128
    q, k, v = (torch.from_numpy(_rand(rng, (B, S, n, hd)))
               for n in (H, KV, KV))
    want = flash_mod.plain(q, k, v, causal=True, window=0)

    def heads(x):   # [B,S,n,hd] -> [B*H, S, hd], K/V repeated per head
        x = x.repeat_interleave(H // x.shape[2], dim=2)
        return x.transpose(1, 2).reshape(B * H, S, hd)

    def attention(passes, dtype=torch.float32):
        qf, kf, vf = (heads(x).to(dtype) for x in (q, k, v))
        s = _mm_tf32(qf, kf.transpose(1, 2), passes) / math.sqrt(hd)
        keep = torch.ones(S, S, dtype=torch.bool).tril()
        s = torch.where(keep, s, torch.full((), -1e30, dtype=dtype))
        out = _mm_tf32(torch.softmax(s, dim=-1), vf, passes)
        return out.reshape(B, H, S, hd).transpose(1, 2)

    oracle = attention(0, torch.float64)
    one, three = attention(1), attention(3)
    assert torch.allclose(three, want, rtol=2e-4, atol=2e-4)
    assert not torch.allclose(one, want, rtol=2e-4, atol=2e-4)
    err = {name: float((x.double() - oracle).abs().max())
           for name, x in (("fp32", want), ("1xTF32", one),
                           ("3xTF32", three))}
    assert err["1xTF32"] > 5 * 2e-4, err
    assert err["3xTF32"] < 2e-4 / 50 and err["fp32"] < 2e-4 / 50, err


# ------------------------------------------------------------ ssd chunk
SSD_SHAPES = [
    (2, 32, 8, 16, 24, 4),
    (3, 64, 16, 32, 16, 8),
    (1, 16, 6, 8, 8, 3),     # H not a multiple of the Pallas head block
]


@pytest.mark.parametrize("G,Q,H,P,N,bh", SSD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_plain_matches_pallas(G, Q, H, P, N, bh, dtype):
    """The wrapper on CPU tensors against the Pallas kernel in interpret
    mode, on the same inputs in the same dtype (both compute in fp32):
    1e-4 in fp32, 3e-2 in bf16 as ``test_kernels.py`` states."""
    rng = np.random.default_rng(G * 100 + Q)
    arrs = [-np.abs(_rand(rng, (G, Q, H), 0.1)), _rand(rng, (G, Q, H, P)),
            _rand(rng, (G, Q, N)), _rand(rng, (G, Q, N))]
    jd = getattr(jnp, dtype)
    jargs = [jnp.asarray(a, jd) for a in arrs]
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    got_y, got_s = ops.ssd_chunk(*targs)
    assert got_y.dtype == got_s.dtype == torch.float32
    want_y, want_s = jops.ssd_chunk(*jargs, impl="pallas_interpret",
                                    block_h=bh)
    tol = 1e-4 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=tol,
                               atol=tol)


def test_ssd_chunk_tf32_split_error():
    """The precision argument for the CUDA kernel's tensor-core design,
    on the CPU: the SSD step at Mamba2's head width (P 64, N 128) over a
    256-position chunk with its three products (C.B^T, (decay .
    scores).xw, the S contraction) on TF32 operands. One TF32 pass
    misses the kernel's fp32 tolerance (2e-5 x max|plain|, unchanged);
    the 3xTF32 split the kernel runs holds it with room (~1e-6 of the
    largest output, the error of fp32 itself)."""
    rng = np.random.default_rng(15)
    G, Q, H, P, N = 1, 256, 8, 64, 128
    dA = torch.from_numpy(-np.abs(_rand(rng, (G, Q, H), 0.1)))
    xw = torch.from_numpy(_rand(rng, (G, Q, H, P)))
    Bm, Cm = (torch.from_numpy(_rand(rng, (G, Q, N))) for _ in range(2))
    want = ssd_mod.plain(dA, xw, Bm, Cm)

    def ssd(passes, dtype=torch.float32):
        a, x, b, c = (t[0].to(dtype) for t in (dA, xw, Bm, Cm))
        cum = torch.cumsum(a, dim=0)                           # [Q, H]
        scores = _mm_tf32(c, b.T, passes)                      # [Q, Q]
        keep = torch.ones(Q, Q, dtype=torch.bool).tril()
        y, s = [], []
        for h in range(H):
            rel = cum[:, None, h] - cum[None, :, h]
            decay = torch.where(keep, torch.exp(rel),
                                torch.zeros((), dtype=dtype))
            y.append(_mm_tf32(decay * scores, x[:, h], passes))
            w = torch.exp(cum[-1, h] - cum[:, h])
            s.append(_mm_tf32((x[:, h] * w[:, None]).T, b, passes))
        return torch.stack(y, dim=1)[None], torch.stack(s)[None]

    oracle = ssd(0, torch.float64)
    one, three = ssd(1), ssd(3)
    for i, name in enumerate(("y", "s")):
        top = float(want[i].abs().max())
        err = {k: float((v[i].double() - oracle[i]).abs().max()) / top
               for k, v in (("fp32", want), ("1xTF32", one),
                            ("3xTF32", three))}
        gap3 = float((three[i] - want[i]).abs().max())
        gap1 = float((one[i] - want[i]).abs().max())
        assert gap3 <= 2e-5 * top and gap1 > 2e-5 * top, (name, err)
        assert err["1xTF32"] > 5 * 2e-5, (name, err)
        assert err["3xTF32"] < 2e-5 / 10 and err["fp32"] < 2e-5 / 10, (name, err)


def test_ssd_chunk_rejects_mismatched_shapes():
    dA, xw = torch.zeros(2, 8, 3), torch.zeros(2, 8, 3, 4)
    bm = torch.zeros(2, 8, 5)
    with pytest.raises(ValueError):
        ops.ssd_chunk(dA, torch.zeros(2, 8, 4, 4), bm, bm)
    with pytest.raises(ValueError):
        ops.ssd_chunk(dA, xw, bm, torch.zeros(2, 8, 6))


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    ops.reset_launch_counts()
    x = torch.zeros(1, 2, 8)
    ops.moe_ffn(x, torch.zeros(1, 8, 4), torch.zeros(1, 8, 4),
                torch.zeros(1, 4, 8), [0])
    ops.paged_attention(torch.zeros(1, 2, 8), torch.zeros(2, 4, 1, 8),
                        torch.zeros(2, 4, 1, 8),
                        torch.zeros(1, 1, dtype=torch.int32),
                        torch.zeros(1, dtype=torch.int32))
    q = torch.zeros(1, 3, 2, 8, requires_grad=True)
    out = ops.flash_attention(q, torch.zeros(1, 3, 1, 8),
                              torch.zeros(1, 3, 1, 8))
    out.sum().backward()   # the plain version's autograd: no launch either
    ops.ssd_chunk(torch.zeros(1, 4, 2), torch.zeros(1, 4, 2, 3),
                  torch.zeros(1, 4, 5), torch.zeros(1, 4, 5))
    assert ops.launch_counts() == {"moe_ffn": 0, "paged_attention": 0,
                                   "flash_attention": 0,
                                   "flash_attention_bwd": 0, "ssd_chunk": 0,
                                   "ssd_chunk_bwd": 0}


class _Elsewhere(torch.Tensor):
    """A tensor that claims a device no wrapper takes ("mps") and holds
    nothing: any op on it fails the test."""

    @staticmethod
    def __new__(cls, *shape):
        return torch.Tensor._make_wrapper_subclass(
            cls, shape, dtype=torch.float32, device="mps")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise AssertionError(f"{func} ran on an unsupported device")


def test_unsupported_device_raises():
    """A device but cpu, cuda and meta raises before any op runs. (Meta
    tensors take the meta route since the dry run: an empty meta output
    of the kernel's shape and dtype, no launch.)"""
    E = _Elsewhere
    with pytest.raises(ValueError, match="unsupported device mps"):
        ops.moe_ffn(E(1, 2, 8), E(1, 8, 4), E(1, 8, 4), E(1, 4, 8), [0])
    with pytest.raises(ValueError, match="unsupported device mps"):
        ops.flash_attention(E(1, 3, 2, 8), E(1, 3, 2, 8), E(1, 3, 2, 8))
    with pytest.raises(ValueError, match="unsupported device mps"):
        ops.ssd_chunk(E(1, 4, 2), E(1, 4, 2, 3), E(1, 4, 5), E(1, 4, 5))
    with pytest.raises(ValueError, match="unsupported device mps"):
        ops.paged_attention(E(1, 2, 8), E(3, 4, 1, 8), E(3, 4, 1, 8),
                            E(1, 2), E(1))
    ops.reset_launch_counts()
    m = torch.zeros(1, 3, 2, 8, device="meta")
    out = ops.flash_attention(m, m, m[..., :4])
    assert (out.device.type, tuple(out.shape), out.dtype) == (
        "meta", (1, 3, 2, 4), torch.float32)
    y, s = ops.ssd_chunk(torch.zeros(1, 4, 2, device="meta"),
                         torch.zeros(1, 4, 2, 3, device="meta"),
                         torch.zeros(1, 4, 5, device="meta"),
                         torch.zeros(1, 4, 5, device="meta"))
    assert (tuple(y.shape), tuple(s.shape)) == ((1, 4, 2, 3), (1, 2, 3, 5))
    y = ops.moe_ffn(torch.zeros(1, 2, 8, device="meta"),
                    torch.zeros(1, 8, 4, device="meta"),
                    torch.zeros(1, 8, 4, device="meta"),
                    torch.zeros(1, 4, 8, device="meta"), [0])
    assert (y.device.type, tuple(y.shape)) == ("meta", (1, 2, 8))
    assert sum(ops.launch_counts().values()) == 0


# a build's ptxas report as nvcc -Xptxas -v prints it (sm_90a)
PTXAS_REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119flash_bwd_keys_bf16ILi12ELi8ELi2EEEvPK13__nv_bfloat16S3_S3_S3_PKfPS1_S6_NS_5ShapeE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119flash_bwd_keys_bf16ILi12ELi8ELi2EEEvPK13__nv_bfloat16S3_S3_S3_PKfPS1_S6_NS_5ShapeE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 205 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121flash_bwd_keys_kernelIfLi32EEEvPKT_S3_S3_S3_PKfPS1_S6_NS_5ShapeE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121flash_bwd_keys_kernelIfLi32EEEvPKT_S3_S3_S3_PKfPS1_S6_NS_5ShapeE
    312 bytes stack frame, 568 bytes spill stores, 700 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_Z14moe_ffn_kernelPKfS0_' for 'sm_90a'
ptxas info    : Function properties for _Z14moe_ffn_kernelPKfS0_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 368 bytes cmem[0]
"""


def test_ptxas_kernels_reads_each_kernels_registers_and_spills():
    assert ops.ptxas_kernels(PTXAS_REPORT) == [
        {"kernel": "flash_bwd_keys_bf16<12,8,2>", "stack": 0,
         "spill_stores": 0, "spill_loads": 0, "registers": 205},
        {"kernel": "flash_bwd_keys_kernel<float,32>", "stack": 312,
         "spill_stores": 568, "spill_loads": 700, "registers": 255},
        {"kernel": "moe_ffn_kernel", "stack": 0, "spill_stores": 0,
         "spill_loads": 0, "registers": 40}]
    assert ops.ptxas_kernels("nvcc: no kernels\n") == []
