"""The order of the offload engine's real expert copies (ROADMAP.md C4).

The engine decides layer l+1's speculative prefetch before layer l's MoE
runs, and the trace, ``stats()`` and the simulated clock record it there.
The copies themselves must queue after layer l's demand installs, so
that on one copy stream layer l's FFN never waits behind a guess (the
reference's clock lets a demand transfer displace queued prefetches).
These tests record every ``_copy_in`` (the copies of one install) with
the call it came from, and check, step by step and layer by layer, that
layer l's demand copies precede layer l+1's prefetch copies, while
tokens, trace rows, ``stats()`` and ``sim_time`` stay equal to JAX's and
to the port's earlier order (prefetch copies issued when decided)."""
import dataclasses

import jax
import numpy as np
import pytest

from conftest import tiny
from repro.core import OffloadEngine as JEngine
from repro.models import transformer as jtf
from repro_torch.core.expert_cache import ExpertCache
from repro_torch.core.offload_engine import OffloadEngine
from test_torch_engine import (PROMPTS, _assert_same_run,  # noqa: F401
                               _one_torch_thread, _rows, _track_margins)
from test_torch_prefill import _bridge


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(tiny("mixtral-8x7b", layers=3, experts=8),
                              num_experts_per_tok=2)
    jp = jtf.init_params(cfg, jax.random.PRNGKey(4))
    return cfg, jp, _bridge(jp)


def _record_copies(monkeypatch):
    """Log ("demand" | "prefetch", layer, expert) for each install's
    copies, and ("step",) at each decode step."""
    log, kind = [], ["?"]
    copy_in, decode = ExpertCache._copy_in, OffloadEngine.decode_tokens

    def logged_copy(self, eid, slot, outcome):
        log.append((kind[0], self.layer, eid))
        return copy_in(self, eid, slot, outcome)

    def tagged(name, fn):
        def call(self, *args, **kw):
            prev, kind[0] = kind[0], name
            try:
                return fn(self, *args, **kw)
            finally:
                kind[0] = prev
        return call

    def step(self, *args, **kw):
        log.append(("step",))
        return decode(self, *args, **kw)

    monkeypatch.setattr(ExpertCache, "_copy_in", logged_copy)
    monkeypatch.setattr(OffloadEngine, "decode_tokens", step)
    for name, k in (("access", "demand"), ("prefetch", "prefetch"),
                    ("issue_prefetches", "prefetch")):
        monkeypatch.setattr(ExpertCache, name,
                            tagged(k, getattr(ExpertCache, name)))
    return log


def _steps(log):
    out = []
    for entry in log:
        if entry == ("step",):
            out.append([])
        else:
            out[-1].append(entry)
    return out


def _wanted(rows, L, demand_first):
    """Each step's copies from its trace rows (one a layer): layer l's
    misses, then layer l+1's prefetches (the other way round for the
    earlier order)."""
    steps = [rows[i:i + L] for i in range(0, len(rows), L)]
    out = []
    for step in steps:
        seq = []
        for l, row in enumerate(step):
            demand = [("demand", l, e) for e in row.misses]
            pre = ([("prefetch", l + 1, e) for e in step[l + 1].prefetched]
                   if l + 1 < L else [])
            seq += demand + pre if demand_first else pre + demand
        out.append(seq)
    return out


@pytest.mark.parametrize("overlap", [False, True], ids=["seq", "overlap"])
@pytest.mark.parametrize("policy", ["lru", "lfu"])
def test_demand_copies_precede_next_layers_prefetch(setup, policy, overlap,
                                                    monkeypatch):
    cfg, jp, tp = setup
    kw = dict(cache_slots=2, policy=policy, prefetch="spec", overlap=overlap)
    jeng = JEngine(jp, cfg, **kw)
    want_tokens = jeng.generate(PROMPTS[2], 6)

    runs = {}
    for order in ("now", "earlier"):
        with monkeypatch.context() as m:
            log = _record_copies(m)
            if order == "earlier":   # copies queued when decided
                prefetch = ExpertCache.prefetch
                m.setattr(ExpertCache, "prefetch",
                          lambda self, eids, defer=False: prefetch(self, eids))
            peng = OffloadEngine(tp, cfg, device="cpu", **kw)
            margins = _track_margins(peng)
            assert peng.generate(PROMPTS[2], 6) == want_tokens
            _assert_same_run(jeng, peng, margins)
            runs[order] = (peng, _steps(log))

    for order, demand_first in (("now", True), ("earlier", False)):
        peng, steps = runs[order]
        assert steps == _wanted(peng.trace.steps, cfg.num_layers,
                                demand_first)
    # the workload exercises both kinds, and the two orders differ
    kinds = {k for s in runs["now"][1] for k, *_ in s}
    assert kinds == {"demand", "prefetch"}
    assert runs["now"][1] != runs["earlier"][1]
    assert _rows(runs["now"][0].trace) == _rows(runs["earlier"][0].trace)
