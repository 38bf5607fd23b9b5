"""The port's expert-cache install path on the CPU: an install copies the
store's payload as it is stored (int8 and its scale rows under
``quant="int8"``) and dequantizes where the slot lives, so a slot holds
the host dequant's exact bits, ``bytes_transferred`` counts what was
copied, and a fault-free run never builds the host fp32 payload
(``ExpertStore.fetch``). The int8 runs against the JAX package are in
``test_torch_engine.py``."""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.configs as pcfg
from repro_torch.core.cache_policies import make_policy
from repro_torch.core.expert_cache import ExpertCache
from repro_torch.core.expert_store import ExpertStore
from repro_torch.core.faults import FaultInjector, FaultPlan, FetchOutcome
from repro_torch.core.offload_engine import OffloadEngine
from repro_torch.models import transformer as ptf

D, FF, EXPERTS, LAYERS = 24, 40, 5, 2
SHAPES = {"w1": (D, FF), "w3": (D, FF), "w2": (FF, D)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _store(quant):
    """LAYERS x EXPERTS experts from a seeded numpy generator; one column
    of one expert all zero (the quantizer's scale-1 case)."""
    rng = np.random.default_rng(0)
    store = ExpertStore(quant=quant)
    for l in range(LAYERS):
        for e in range(EXPERTS):
            w = {k: (rng.normal(size=s) * 0.1).astype(np.float32)
                 for k, s in SHAPES.items()}
            if (l, e) == (0, 1):
                w["w1"][:, 3] = 0.0
            store.put((l, e), w)
    return store


def _caches(store, slots=3, faults=None):
    staging = {}
    return [ExpertCache(l, slots, make_policy("lru", slots), store, SHAPES,
                        device="cpu", faults=faults, staging=staging)
            for l in range(LAYERS)]


def _counting_fetch(store):
    calls = []
    fetch = store.fetch

    def counted(key):
        calls.append(key)
        return fetch(key)

    store.fetch = counted
    return calls


@pytest.mark.parametrize("quant", ["int8", "none"])
def test_install_is_bitwise_the_host_dequant(quant):
    store = _store(quant)
    calls = _counting_fetch(store)
    caches = _caches(store)
    for c in caches:
        c.access([0, 1, 2])
        c.access([3, 4])            # evicts two of them
        c.prefetch([1])
    assert calls == []              # no install built the host fp32 payload
    for c in caches:
        for eid, slot in c.slot_of.items():
            want = store.fetch((c.layer, eid))
            for k in SHAPES:
                assert torch.equal(c.buffers[k][slot], want[k]), (eid, k)
        # every install moved the stored bytes: int8 + scales, or fp32
        per = sum(int(np.prod(s)) for s in SHAPES.values())
        per = (per + sum(s[1] * 4 for s in SHAPES.values())
               if quant == "int8" else per * 4)
        installs = c.misses + c.prefetches
        assert store.expert_nbytes((c.layer, 0)) == per
        assert c.bytes_transferred == installs * per


def test_int8_staging_is_one_pair_per_matrix_for_all_layers():
    store = _store("int8")
    caches = _caches(store)
    for c in caches:
        c.access([0, 1])
    staging = caches[0].staging
    assert all(c.staging is staging for c in caches)
    assert sorted(staging) == sorted(SHAPES)
    for k, (q, s) in staging.items():
        assert q.dtype == torch.int8 and tuple(q.shape) == SHAPES[k]
        assert s.dtype == torch.float32 and tuple(s.shape) == (1, SHAPES[k][1])
    # fp32 masters are copied straight into the slot: no staging
    fp = _caches(_store("none"))
    fp[0].access([0])
    assert fp[0].staging == {}


def test_int8_payload_is_the_stored_bytes():
    store = _store("int8")
    pay = store.payload((1, 2))
    deq = store.fetch((1, 2))
    for k, (q, s) in pay.items():
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert torch.equal(q.float() * s, deq[k])
    assert store.expert_nbytes((1, 2)) == sum(
        q.nbytes + s.nbytes for q, s in pay.values())


@pytest.mark.parametrize("slips", [False, True])
def test_int8_corrupt_delivery_takes_the_host_path(slips, monkeypatch):
    """A planned corrupt delivery is corrupted, verified and refetched on
    the host, and the slot ends up as the host dequant; a corruption the
    checksum misses (forced here) is installed as delivered."""
    store = _store("int8")
    inj = FaultInjector(FaultPlan(seed=1, corruption_rate=0.5))
    if slips:
        monkeypatch.setattr(store, "verify", lambda key, w: True)
    (cache,) = _caches(store, faults=inj)[:1]
    calls = _counting_fetch(store)
    out = FetchOutcome(key=(0, 2), success=True, fail_kinds=("corrupt",))
    slot, _, tier = cache._install(2, outcome=out)
    assert tier == "host"
    assert calls and cache.corrupt_refetches == (0 if slips else 1)
    want = store.fetch((0, 2))
    same = all(torch.equal(cache.buffers[k][slot], want[k]) for k in SHAPES)
    assert same is not slips


@pytest.mark.parametrize("quant", ["int8", "none"])
def test_generate_without_faults_never_fetches(quant):
    kw = dict(layers=2, d_model=64, experts=8, vocab=128)
    cfg = dataclasses.replace(
        pcfg.reduced(pcfg.get_config("mixtral-8x7b"), **kw),
        dtype="float32", num_experts_per_tok=2)
    params = ptf.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    eng = OffloadEngine(params, cfg, cache_slots=2, policy="lru",
                        prefetch="spec", quant=quant, device="cpu")
    calls = _counting_fetch(eng.store)
    eng.generate([1, 2, 3, 4], 5)
    assert calls == []
    moved = sum(c.misses + c.prefetches for c in eng.caches)
    assert moved > 0
    assert sum(c.bytes_transferred for c in eng.caches) == \
        moved * eng.store.expert_nbytes((0, 0))
    for c in eng.caches:
        for eid, slot in c.slot_of.items():
            want = eng.store.fetch((c.layer, eid))
            assert all(torch.equal(c.buffers[k][slot], want[k]) for k in want)
