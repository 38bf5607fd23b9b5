"""The one-query route of the flash forward (``flash_fwd_one_query`` and
``flash_fwd_one_query_bf16`` in ``csrc/flash_attention.cu``) on the CPU:
its arithmetic emulated in torch (each split's (m, l, o) over its own
keys in fp32, combined in split order, a bf16 output rounded once, as
the kernel computes them) against the JAX package's Pallas kernel in
interpret mode and its XLA path, in fp32 and on bf16 inputs, and the
route function (``flash_attention.one_query_plan`` / ``one_query_splits``)
that decides which calls take it, with the launcher's arguments and the
route count. The kernel itself runs only on the card: ``chip_smoke.py``
holds it against the plain version, float64 and itself there."""
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops

NEG_INF = -1e30
LOG2E = 1.4426950408889634
_EMPTY, _ZEROS = torch.empty, torch.zeros


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split_combine(q, k, v, *, causal, window, S):
    """The kernel's arithmetic in torch, fp32 (bf16 inputs widened): a
    block per (batch row, KV head, split) scores its split's keys for the
    KV head's Sq·G rows (row r = position r // G, head kvh·G + r % G) in
    log2 units, masked keys at NEG_INF and keys past Sk left out; its (m,
    l, o) with P = 2^(s - m); one split is the output, more are combined
    in split order; the output in q's dtype, rounded once."""
    dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    B, Sq, H, hd = q.shape
    Sk, KV, vd = k.shape[1], k.shape[2], v.shape[3]
    G = H // KV
    splits = flash_mod.one_query_splits(Sq, Sk, causal, window, S)
    pos = torch.arange(Sq).repeat_interleave(G)          # row r's position
    out = torch.empty(B, Sq, H, vd)
    for b in range(B):
        for kvh in range(KV):
            qr = q[b, :, kvh * G:(kvh + 1) * G].reshape(Sq * G, hd)
            parts = []
            for k0, k1 in splits:
                key = torch.arange(k0, k1)
                s = qr @ k[b, k0:k1, kvh].T * (LOG2E / math.sqrt(hd))
                masked = torch.zeros_like(s, dtype=torch.bool)
                if causal:
                    masked |= key[None, :] > pos[:, None]
                if window > 0:
                    masked |= pos[:, None] - key[None, :] >= window
                s = torch.where(masked, torch.tensor(NEG_INF), s)
                m = s.max(-1).values
                p = torch.exp2(s - m[:, None])
                parts.append((m, p.sum(-1), p @ v[b, k0:k1, kvh]))
            if len(parts) == 1:
                m, l, o = parts[0]
                o = o / torch.clamp(l, min=1e-30)[:, None]
            else:
                M = torch.stack([m for m, _, _ in parts]).max(0).values
                L, o = torch.zeros_like(M), torch.zeros(Sq * G, vd)
                for m, l, part in parts:       # split order
                    e = torch.exp2(m - M)
                    L, o = L + l * e, o + part * e[:, None]
                o = o / torch.clamp(L, min=1e-30)[:, None]
            out[b, :, kvh * G:(kvh + 1) * G] = o.reshape(Sq, G, vd)
    return out.to(dtype)


def _rand(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


# (B, Sq, Sk, H, KV, hd, vd, causal, window, S); S None: one_query_plan's.
# Whisper-tiny's and Llama-3.2-Vision's one-query widths (MHA, hd 64 / 128)
# at reduced Sk, with a split ending on the last key (Sk = 2 S) and the
# last key alone in a split (2 S + 1); GQA at Sq·G = 8 (the cut) and 16
# (the arithmetic past it); causal and window 37 at Sq = 4 (G 2 and G 4);
# Sq = 3 > Sk = 2 under window 1 (row 2 sees no key: uniform over both);
# hd 37 / vd 21
CASES = [
    (2, 1, 128, 6, 6, 64, 64, False, 0, None),
    (2, 1, 129, 6, 6, 64, 64, False, 0, None),
    (2, 1, 256, 6, 6, 64, 64, False, 0, 128),
    (2, 1, 257, 6, 6, 64, 64, False, 0, 128),
    (2, 1, 64, 4, 4, 128, 128, False, 0, None),
    (2, 1, 65, 4, 4, 128, 128, False, 0, None),
    (1, 1, 100, 8, 1, 64, 64, False, 0, None),
    (1, 1, 100, 16, 1, 64, 64, False, 0, 64),
    (2, 1, 100, 32, 2, 64, 64, False, 0, 32),
    (2, 4, 100, 8, 4, 64, 64, True, 0, None),
    (2, 4, 100, 8, 4, 64, 64, False, 37, None),
    (2, 4, 100, 8, 4, 64, 64, True, 37, None),
    (2, 4, 100, 16, 4, 64, 64, True, 0, 32),
    (2, 4, 100, 16, 4, 64, 64, False, 37, 32),
    (2, 4, 100, 16, 4, 64, 64, True, 37, 32),
    (2, 3, 2, 4, 2, 64, 64, False, 1, None),
    (2, 3, 2, 4, 2, 64, 64, True, 1, None),
    (2, 1, 129, 6, 3, 37, 21, False, 0, None),
    (2, 1, 129, 6, 3, 37, 21, False, 0, 32),
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,vd,causal,window,S", CASES)
def test_one_query_split_combine_matches_pallas(B, Sq, Sk, H, KV, hd, vd,
                                                causal, window, S):
    """The splits' partials combined in split order give the Pallas
    kernel's output (interpret mode) and the XLA path's, fp32, rtol = atol
    = 2e-4 (summation order)."""
    rng = np.random.default_rng(Sk * 7 + hd + H + window)
    q, k, v = (_rand(rng, s) for s in ((B, Sq, H, hd), (B, Sk, KV, hd),
                                       (B, Sk, KV, vd)))
    if S is None:
        S = flash_mod.one_query_plan(Sq, Sk, H, KV, hd, vd, torch.float32)
    assert S is not None and S % 32 == 0
    got = _split_combine(*(torch.from_numpy(x) for x in (q, k, v)),
                         causal=causal, window=window, S=S).numpy()
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    for impl in ("pallas_interpret", "xla"):
        want = jops.flash_attention(jq, jk, jv, causal=causal,
                                    window=window, impl=impl)
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4,
                                   atol=2e-4)


def test_row_that_sees_no_key_is_uniform_over_every_key():
    """Sq 3 over Sk 2 under window 1: row 2 sees no key, and comes out as
    the mean of both values, as in the reference."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(_rand(rng, s)) for s in
               ((1, 3, 2, 16), (1, 2, 2, 16), (1, 2, 2, 16)))
    got = _split_combine(q, k, v, causal=False, window=1, S=32)
    torch.testing.assert_close(got[0, 2], v[0].mean(0), rtol=1e-6,
                               atol=1e-6)
    assert flash_mod.one_query_splits(3, 2, False, 1, 32) == [(0, 2)]


def test_one_query_plan_takes_fp32_calls_of_few_rows():
    """fp32 calls of at most ONE_QUERY_ROWS rows (Sq·G) a KV head take the
    route; more rows keep the tile kernel, and so does fp16, which has no
    kernel of its own (bf16's cut: the bf16 tests below)."""
    rows = flash_mod.ONE_QUERY_ROWS
    f32, f16 = torch.float32, torch.float16
    assert flash_mod.one_query_plan(1, 1500, 6, 6, 64, 64, f32) == 64
    assert flash_mod.one_query_plan(1, 1601, 32, 32, 128, 128, f32) == 32
    assert flash_mod.one_query_plan(1, 1500, 6, 6, 256, 256, f32) == 32
    assert flash_mod.one_query_plan(1, 1500, 6, 6, 37, 21, f32) == 128
    assert flash_mod.one_query_plan(1, 100, rows, 1, 64, 64, f32) == 64
    assert flash_mod.one_query_plan(rows, 100, 4, 4, 64, 64, f32) == 64
    assert flash_mod.one_query_plan(1, 100, 2 * rows, 1, 64, 64, f32) is None
    assert flash_mod.one_query_plan(rows + 1, 100, 2, 2, 64, 64, f32) is None
    assert flash_mod.one_query_plan(2048, 2048, 32, 8, 128, 128, f32) is None
    assert flash_mod.one_query_plan(1, 1500, 6, 6, 64, 64, f16) is None
    assert flash_mod.one_query_plan(1, 2, 6, 6, 64, 64, f32) == 32


@pytest.mark.parametrize("hd,vd", [(64, 64), (128, 128), (37, 21),
                                   (192, 128), (256, 256)])
def test_one_query_split_length_ignores_batch_and_heads(hd, vd):
    """The split length is a function of (Sk, hd, vd): the same at any
    head count (and B is no argument), a multiple of 32 up to 256 whose
    K and V rows fit ONE_QUERY_SPLIT_BYTES."""
    f32 = torch.float32
    got = {flash_mod.one_query_plan(1, 1601, H, KV, hd, vd, f32)
           for H, KV in ((1, 1), (2, 2), (6, 6), (32, 32), (16, 2), (8, 8))}
    assert len(got) == 1
    S = got.pop()
    assert S % 32 == 0 and 32 <= S <= 256
    assert 4 * S * (hd + vd) <= flash_mod.ONE_QUERY_SPLIT_BYTES or S == 32
    q = [torch.zeros(B, 1, 4, hd) for B in (1, 2, 8)]
    k = [torch.zeros(B, 1601, 4, hd) for B in (1, 2, 8)]
    v = [torch.zeros(B, 1601, 4, vd) for B in (1, 2, 8)]
    assert {flash_mod.plan_of(*t) for t in zip(q, k, v)} == {S}


@pytest.mark.parametrize("Sk", [1, 2, 31, 32, 33, 100, 1500, 1601])
@pytest.mark.parametrize("S", [32, 64, 128, 256])
def test_one_query_splits_cover_the_keys(Sk, S):
    """Without a causal mask the walked splits cover [0, Sk) in order,
    none empty, each of S keys but the last; with one they stop at the
    split holding the last row's last key."""
    splits = flash_mod.one_query_splits(1, Sk, False, 0, S)
    assert splits[0][0] == 0 and splits[-1][1] == Sk
    assert all(k1 > k0 for k0, k1 in splits)
    assert all(a[1] == b[0] for a, b in zip(splits, splits[1:]))
    assert all(k1 - k0 == S for k0, k1 in splits[:-1])
    Sq = min(Sk, 4)
    causal = flash_mod.one_query_splits(Sq, Sk, True, 0, S)
    assert causal == splits[:(Sq - 1) // S + 1]


def _launch_args(monkeypatch, shape, dtype, **kw):
    """The arguments ``flash_mod.launch`` passes the C entry for a call of
    ``shape`` (B, Sq, Sk, H, KV, hd, vd), from a stand-in entry on the
    CPU, and the scratch sizes it allocated."""
    B, Sq, Sk, H, KV, hd, vd = shape
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    seen = {}
    made = []

    def record(maker):
        def make(*a, **k):
            t = maker(*a, **k)
            made.append((tuple(t.shape), t.dtype))
            return t
        return make

    monkeypatch.setattr(torch, "empty", record(_EMPTY))
    monkeypatch.setattr(torch, "zeros", record(_ZEROS))

    def entry(*args):
        seen["args"] = args
        return 0

    q = _ZEROS(B, Sq, H, hd, dtype=dtype)
    k = _ZEROS(B, Sk, KV, hd, dtype=dtype)
    v = _ZEROS(B, Sk, KV, vd, dtype=dtype)
    flash_mod.launch(entry, q, k, v, causal=kw.get("causal", False),
                     window=kw.get("window", 0),
                     **{n: x for n, x in kw.items()
                        if n == "keys_per_split"})
    names = ("q", "k", "v", "out", "part", "tickets", "bf16", "B", "Sq",
             "Sk", "H", "KV", "hd", "vd", "causal", "window", "S", "scale",
             "stream")
    return dict(zip(names, seen["args"])), made[1:]   # made[0]: the output


def test_launcher_passes_the_plan_and_its_scratch(monkeypatch):
    """Vision's engine call: the plan's split length, scratch for B·KV
    rows of ceil(Sk / S) splits of (vd + 2) floats and B·KV int32 zero
    tickets; Whisper's encoder call, a bf16 call past the bf16 cut and a
    call past the row cut: S 0, no scratch (the tile kernels)."""
    args, made = _launch_args(monkeypatch, (2, 1, 1601, 32, 32, 128, 128),
                              torch.float32)
    assert args["S"] == 32 and args["part"] and args["tickets"]
    assert made == [((2 * 32 * 51 * 1 * 130,), torch.float32),
                    ((2 * 32,), torch.int32)]
    assert args["stream"] == 7 and args["bf16"] == 0
    for shape, dtype in (((2, 1500, 1500, 6, 6, 64, 64), torch.float32),
                         ((2, 1, 1500, 6 * (flash_mod.ONE_QUERY_ROWS_BF16
                                             + 1), 6, 64, 64),
                          torch.bfloat16),
                         ((1, 1, 100, 32, 1, 64, 64), torch.float32)):
        args, made = _launch_args(monkeypatch, shape, dtype)
        assert args["S"] == 0 and not args["part"] and not args["tickets"]
        assert made == []
    # one split: the output only; an explicit split length is passed on
    args, made = _launch_args(monkeypatch, (2, 1, 60, 6, 6, 64, 64),
                              torch.float32)
    assert args["S"] == 64 and not args["part"] and made == []
    args, made = _launch_args(monkeypatch, (2, 1, 100, 6, 6, 64, 64),
                              torch.float32, keys_per_split=32)
    assert args["S"] == 32 and made[0] == ((2 * 6 * 4 * 66,), torch.float32)
    args, _ = _launch_args(monkeypatch, (2, 1, 100, 6, 6, 64, 64),
                           torch.float32, keys_per_split=0)
    assert args["S"] == 0


def test_route_count_beside_the_launch_count(monkeypatch):
    """On the CUDA route (CPU tensors, the launch patched to the plain
    version) every call counts one flash_attention launch, and the calls
    the plan sends to the one-query route count in ROUTES too."""
    monkeypatch.setattr(ops, "_one_device",
                        lambda name, *t: torch.device("cuda"))
    monkeypatch.setattr(ops, "_entry", lambda name: None)
    monkeypatch.setattr(flash_mod, "launch",
                        lambda fn, q, k, v, **kw: flash_mod.plain(q, k, v,
                                                                  **kw))
    rng = np.random.default_rng(5)

    def call(B, Sq, Sk, H, KV, hd, causal):
        q, k, v = (torch.from_numpy(_rand(rng, s)) for s in
                   ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
        with torch.no_grad():
            return ops.flash_attention(q, k, v, causal=causal)

    ops.reset_launch_counts()
    call(2, 1, 40, 6, 6, 64, False)       # one query: the route
    call(1, 2, 40, 8, 2, 32, True)        # Sq·G 8: the route
    call(1, 4, 40, 8, 2, 32, True)        # Sq·G 16: the tile kernel
    call(1, 40, 40, 8, 2, 32, True)       # prefill: the tile kernel
    assert ops.launch_counts()["flash_attention"] == 4
    assert ops.route_counts() == {"flash_attention_one_query": 2}
    ops.reset_launch_counts()
    assert ops.route_counts() == {"flash_attention_one_query": 0}


# ----------------------------------------------------------------- bf16
def _bf16(rng, shape):
    """Seeded normal values rounded to bf16 (as numpy fp32 holding them)."""
    return torch.from_numpy(_rand(rng, shape)).to(torch.bfloat16)


# (B, Sq, Sk, H, KV, hd, vd, causal, window, S): the CASES the bf16 route
# takes at any cut (one row a KV head) with the plan's split or a forced
# one, and GQA at 2 and 4 rows with causal and window masks, held at a
# forced split (their arithmetic, whichever kernel the cut sends them to)
BF16_CASES = [c for c in CASES if c[1] * c[3] // c[4] == 1] + [
    (2, 1, 100, 8, 4, 64, 64, False, 0, 32),
    (2, 2, 100, 4, 4, 64, 64, True, 37, 32),
    (2, 4, 100, 4, 4, 64, 64, False, 37, 64),
    (2, 1, 129, 6, 3, 37, 21, False, 0, 32),
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,vd,causal,window,S", BF16_CASES)
def test_one_query_split_combine_bf16_matches_pallas(B, Sq, Sk, H, KV, hd,
                                                     vd, causal, window, S):
    """On bf16 inputs the kernel's arithmetic (fp32 FMAs on the widened
    values, one rounding to bf16 at the output) is within 2^-8 x max of
    float64 attention on the same bf16 values (``chip_smoke.py``'s
    BF16_F64_TOL: half a bf16 ulp at the store over fp32's error), and
    within 2e-2 (rtol = atol) of the Pallas kernel in interpret mode and
    the XLA path on the same bf16 inputs: both round the output to bf16,
    and JAX's bf16 path rounds P to bf16 before P.V, each worth up to 2^-8
    of values up to ~4 (``test_torch_flash_fwd_bf16_numerics``)."""
    rng = np.random.default_rng(Sk * 11 + hd + H + window + Sq)
    q, k, v = (_bf16(rng, s) for s in ((B, Sq, H, hd), (B, Sk, KV, hd),
                                       (B, Sk, KV, vd)))
    if S is None:
        S = flash_mod.one_query_plan(Sq, Sk, H, KV, hd, vd, torch.bfloat16)
    assert S is not None and S % 32 == 0
    got = _split_combine(q, k, v, causal=causal, window=window, S=S)
    assert got.dtype == torch.bfloat16
    got = got.float()
    f64 = flash_mod.plain(q.double(), k.double(), v.double(), causal=causal,
                          window=window)
    assert float((got - f64).abs().max()) <= 2.0 ** -8 * float(
        f64.abs().max())
    jq, jk, jv = (jnp.asarray(x.float().numpy(), jnp.bfloat16)
                  for x in (q, k, v))
    for impl in ("pallas_interpret", "xla"):
        want = jops.flash_attention(jq, jk, jv, causal=causal,
                                    window=window, impl=impl)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=2e-2, atol=2e-2)


def _bf16_split(hd, vd):
    """The split the plan should give bf16 rows of (hd, vd) at many keys:
    the most keys in 32..256 (powers of two) whose bf16 K and V rows fit
    ONE_QUERY_SPLIT_BYTES_BF16, else 32."""
    fits = [S for S in (32, 64, 128, 256)
            if 2 * S * (hd + vd) <= flash_mod.ONE_QUERY_SPLIT_BYTES_BF16]
    return max(fits, default=32)


@pytest.mark.parametrize("Sq,H,KV", [(1, 6, 6), (1, 32, 32), (1, 2, 2),
                                     (2, 4, 4), (1, 8, 4), (1, 8, 2),
                                     (4, 4, 4), (1, 16, 1)])
def test_one_query_plan_takes_bf16_calls_up_to_the_bf16_cut(Sq, H, KV):
    """bf16 calls of at most ONE_QUERY_ROWS_BF16 rows (Sq·G) a KV head
    take the route, with a split sized from bf16 bytes; more rows keep
    the bf16 tile kernel. fp32 calls of the same shape follow fp32's own
    cut and budget (4-byte rows: no longer splits than bf16's at the same
    budget)."""
    rows = Sq * (H // KV)
    got = flash_mod.one_query_plan(Sq, 1601, H, KV, 128, 128, torch.bfloat16)
    if rows <= flash_mod.ONE_QUERY_ROWS_BF16:
        assert got == _bf16_split(128, 128)
    else:
        assert got is None
    f32 = flash_mod.one_query_plan(Sq, 1601, H, KV, 128, 128, torch.float32)
    assert (f32 is None) == (rows > flash_mod.ONE_QUERY_ROWS)


@pytest.mark.parametrize("dtype,Sq,H,KV,last", [
    (torch.float32, 1, 8, 1, 3631 * 32), (torch.float32, 2, 4, 1, 3631 * 32),
    (torch.float32, 1, 1, 1, 29055 * 32), (torch.bfloat16, 1, 1, 1,
                                           29055 * 32)])
def test_one_query_plan_leaves_calls_past_the_combines_memory(dtype, Sq, H,
                                                              KV, last):
    """The combine holds each split's (m, l) a row in shared memory, 8
    (n + 1) R bytes: at hd = vd = 128 (32-key splits in either dtype) the
    route takes a call of ``last`` keys, the most that fit
    ONE_QUERY_COMBINE_BYTES at its rows, and leaves one more key to the
    tile kernel."""
    plan = flash_mod.one_query_plan
    assert plan(Sq, last, H, KV, 128, 128, dtype) == 32
    assert 8 * (last // 32 + 1) * Sq * (H // KV) <= (
        flash_mod.ONE_QUERY_COMBINE_BYTES)
    assert plan(Sq, last + 1, H, KV, 128, 128, dtype) is None


@pytest.mark.parametrize("hd,vd", [(64, 64), (128, 128), (37, 21),
                                   (192, 128), (256, 256)])
def test_one_query_bf16_split_length_ignores_batch_and_heads(hd, vd):
    """The bf16 split length is a function of (Sk, hd, vd): the same at
    any head count within the cut and any B, from bf16 bytes, and no
    wider than the keys (a multiple of 32)."""
    bf16 = torch.bfloat16
    got = {flash_mod.one_query_plan(1, 1601, H, H, hd, vd, bf16)
           for H in (1, 2, 6, 32, 128)}
    assert got == {_bf16_split(hd, vd)}
    assert flash_mod.one_query_plan(1, 40, 6, 6, hd, vd, bf16) == min(
        _bf16_split(hd, vd), 64)
    calls = [tuple(torch.zeros(s, dtype=bf16) for s in
                   ((B, 1, 4, hd), (B, 1601, 4, hd), (B, 1601, 4, vd)))
             for B in (1, 2, 8)]
    assert {flash_mod.plan_of(*t) for t in calls} == got


@pytest.mark.parametrize("shape,S", [
    ((2, 1, 1500, 6, 6, 64, 64), None),
    ((2, 1, 1601, 32, 32, 128, 128), None),
    ((8, 1, 1601, 2, 2, 128, 128), None),
    ((2, 1, 40, 6, 6, 64, 64), None),
    ((2, 1, 100, 6, 6, 64, 64), 32),
])
def test_launcher_passes_the_bf16_flag_plan_and_scratch(monkeypatch, shape,
                                                        S):
    """bf16 calls on the route: the bf16 flag, the plan's split (or the
    one asked for), fp32 scratch for B·KV rows of ceil(Sk / S) splits of
    (vd + 2) floats and B·KV int32 zero tickets where more than one split
    is walked, none for one split."""
    B, Sq, Sk, H, KV, hd, vd = shape
    kw = {} if S is None else {"keys_per_split": S}
    args, made = _launch_args(monkeypatch, shape, torch.bfloat16, **kw)
    want = (flash_mod.one_query_plan(Sq, Sk, H, KV, hd, vd, torch.bfloat16)
            if S is None else S)
    assert args["bf16"] == 1 and args["S"] == want and want % 32 == 0
    assert args["stream"] == 7
    n = -(-Sk // want)
    if n > 1:
        assert args["part"] and args["tickets"]
        assert made == [((B * KV * n * Sq * (H // KV) * (vd + 2),),
                         torch.float32), ((B * KV,), torch.int32)]
    else:
        assert not args["part"] and not args["tickets"] and made == []


def test_bf16_route_count_beside_the_launch_count(monkeypatch):
    """bf16 calls on the CUDA route (CPU tensors, the launch patched to
    the plain version): one flash_attention launch a call, and the calls
    the bf16 plan sends to the route count in ROUTES too; fp32 calls of
    the same shapes follow their own cut."""
    monkeypatch.setattr(ops, "_one_device",
                        lambda name, *t: torch.device("cuda"))
    monkeypatch.setattr(ops, "_entry", lambda name: None)
    monkeypatch.setattr(flash_mod, "launch",
                        lambda fn, q, k, v, **kw: flash_mod.plain(q, k, v,
                                                                  **kw))
    rng = np.random.default_rng(6)
    cut = flash_mod.ONE_QUERY_ROWS_BF16

    def call(B, Sq, Sk, H, KV, hd, causal, dtype=torch.bfloat16):
        q, k, v = (_bf16(rng, s).to(dtype) for s in
                   ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
        with torch.no_grad():
            out = ops.flash_attention(q, k, v, causal=causal)
        assert out.dtype == dtype
        return out

    ops.reset_launch_counts()
    call(2, 1, 40, 6, 6, 64, False)               # one query: the route
    call(1, 1, 40, cut, 1, 32, False)             # Sq·G at the cut: route
    call(1, 1, 40, cut + 1, 1, 32, False)         # past it: tile kernel
    call(1, 40, 40, 8, 2, 32, True)               # prefill: tile kernel
    call(2, 1, 40, 6, 6, 64, False, torch.float32)    # fp32: its route
    assert ops.launch_counts()["flash_attention"] == 5
    assert ops.route_counts() == {"flash_attention_one_query": 3}
    ops.reset_launch_counts()
