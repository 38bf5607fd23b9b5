"""Cache eviction policies for expert offloading.

The paper's baseline is LRU (Eliseev & Mazur 2023); its contribution is
LFU; its §6.1 take-away is that pure LFU makes popular experts
unevictable and suggests "some combination of popularity and unused
count" — implemented here as ``AgedLFU`` and ``LRFU`` (beyond-paper).
``Belady`` is the clairvoyant upper bound used by the benchmarks.

All policies share one interface and are exercised by hypothesis
property tests (capacity invariants, hit monotonicity).
"""
from __future__ import annotations

import random
from collections import Counter, OrderedDict
from typing import Hashable, List, Sequence

Key = Hashable


class CachePolicy:
    """Tracks *which* keys are cached and picks eviction victims.

    The engine calls:
      ``contains(k)`` → hit test
      ``on_access(k)`` → record a use of a cached key
      ``choose_victim()`` → key to evict (cache full)
      ``on_insert(k)`` → key was inserted
      ``remove(k)`` → key dropped (explicit invalidation)
    """

    name = "base"

    def __init__(self, capacity: int):
        assert capacity >= 1
        self.capacity = capacity
        self._step = 0

    def tick(self) -> None:
        self._step += 1

    # -- interface ----------------------------------------------------
    def contains(self, key: Key) -> bool:
        raise NotImplementedError

    def keys(self) -> List[Key]:
        raise NotImplementedError

    def on_access(self, key: Key) -> None:
        raise NotImplementedError

    def on_insert(self, key: Key) -> None:
        raise NotImplementedError

    def choose_victim(self, exclude: frozenset = frozenset()) -> Key:
        raise NotImplementedError

    def remove(self, key: Key) -> None:
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self.keys())

    @property
    def full(self) -> bool:
        return len(self) >= self.capacity


class LRU(CachePolicy):
    """Evict the least recently used key (the baseline's policy)."""

    name = "lru"

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self._od: OrderedDict = OrderedDict()

    def contains(self, key):
        return key in self._od

    def keys(self):
        return list(self._od)

    def on_access(self, key):
        self._od.move_to_end(key)

    def on_insert(self, key):
        assert len(self._od) < self.capacity
        self._od[key] = True

    def choose_victim(self, exclude: frozenset = frozenset()):
        for k in self._od:
            if k not in exclude:
                return k
        raise RuntimeError("all cached keys pinned")

    def remove(self, key):
        self._od.pop(key, None)


class FIFO(CachePolicy):
    name = "fifo"

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self._od: OrderedDict = OrderedDict()

    def contains(self, key):
        return key in self._od

    def keys(self):
        return list(self._od)

    def on_access(self, key):
        pass

    def on_insert(self, key):
        self._od[key] = True

    def choose_victim(self, exclude: frozenset = frozenset()):
        for k in self._od:
            if k not in exclude:
                return k
        raise RuntimeError("all cached keys pinned")

    def remove(self, key):
        self._od.pop(key, None)


class RandomPolicy(CachePolicy):
    name = "random"

    def __init__(self, capacity: int, seed: int = 0):
        super().__init__(capacity)
        self._rng = random.Random(seed)
        self._set = OrderedDict()

    def contains(self, key):
        return key in self._set

    def keys(self):
        return list(self._set)

    def on_access(self, key):
        pass

    def on_insert(self, key):
        self._set[key] = True

    def choose_victim(self, exclude: frozenset = frozenset()):
        cand = [k for k in self._set if k not in exclude]
        if not cand:
            raise RuntimeError("all cached keys pinned")
        return self._rng.choice(cand)

    def remove(self, key):
        self._set.pop(key, None)


class LFU(CachePolicy):
    """The paper's proposed policy: evict the least *frequently* used
    key; ties broken by least-recent use. Frequency counts persist
    across evictions (a key's popularity is a property of the workload,
    which is exactly the paper's motivation — expert imbalance)."""

    name = "lfu"

    def __init__(self, capacity: int, *, persistent_counts: bool = True):
        super().__init__(capacity)
        self._freq: Counter = Counter()
        self._last: dict = {}
        self._set: set = set()
        self._persistent = persistent_counts

    def contains(self, key):
        return key in self._set

    def keys(self):
        return list(self._set)

    def _touch(self, key):
        self._freq[key] += 1
        self._last[key] = self._step

    def on_access(self, key):
        self._touch(key)

    def on_insert(self, key):
        self._set.add(key)
        self._touch(key)

    def choose_victim(self, exclude: frozenset = frozenset()):
        cand = [k for k in self._set if k not in exclude]
        if not cand:
            raise RuntimeError("all cached keys pinned")
        return min(cand, key=lambda k: (self._freq[k], self._last.get(k, -1)))

    def remove(self, key):
        self._set.discard(key)
        if not self._persistent:
            self._freq.pop(key, None)
            self._last.pop(key, None)


class AgedLFU(LFU):
    """Beyond-paper (= the paper's own §6.1 suggestion): LFU whose
    counts decay by ``decay`` every ``age_every`` policy ticks, so a
    historically popular expert cannot squat in the cache forever."""

    name = "aged-lfu"

    def __init__(self, capacity: int, *, decay: float = 0.5,
                 age_every: int = 32, persistent_counts: bool = True):
        super().__init__(capacity, persistent_counts=persistent_counts)
        self._decay = decay
        self._age_every = age_every
        self._ffreq: dict = {}

    def tick(self):
        super().tick()
        if self._step % self._age_every == 0:
            for k in list(self._ffreq):
                self._ffreq[k] *= self._decay

    def _touch(self, key):
        self._ffreq[key] = self._ffreq.get(key, 0.0) + 1.0
        self._last[key] = self._step

    def choose_victim(self, exclude: frozenset = frozenset()):
        cand = [k for k in self._set if k not in exclude]
        if not cand:
            raise RuntimeError("all cached keys pinned")
        return min(cand,
                   key=lambda k: (self._ffreq.get(k, 0.0), self._last.get(k, -1)))

    def remove(self, key):
        # the inherited remove cleared only LFU's _freq/_last, leaving
        # _ffreq (the dict this class actually scores from) to grow
        # unboundedly and to ignore persistent_counts=False entirely
        super().remove(key)
        if not self._persistent:
            self._ffreq.pop(key, None)


class LearnedPolicy(AgedLFU):
    """Beyond paper (FlashMoE / MoE-Beyond direction): evict the key
    with the LOWEST predicted next-window reuse probability, scored by
    a ``repro_torch.core.learned.LearnedModel`` trained offline from trace
    histories.

    Falls back to AgedLFU scoring — victim-for-victim identical
    (test-enforced) — whenever no model is attached or the model's
    training-set confidence is below ``min_confidence``; the AgedLFU
    bookkeeping is always maintained so the fallback (and the learned
    ranking's tie-break) is exact, not approximate.

    The per-key feature state mirrors training (``learned.LayerState``):
    multi-timescale decay traces, lifetime counts and last-activation
    step, maintained lazily (O(1) per touch). The transition feature
    has no layer context at eviction time and is NaN — the model
    imputes its training mean. ``persistent_counts=False`` bounds ALL
    of it (traces included) to the resident set, matching the AgedLFU
    contract property tests.
    """

    name = "learned"

    def __init__(self, capacity: int, *, model=None,
                 min_confidence: float = 0.05, decay: float = 0.5,
                 age_every: int = 32, persistent_counts: bool = True):
        super().__init__(capacity, decay=decay, age_every=age_every,
                         persistent_counts=persistent_counts)
        if isinstance(model, str):
            # checkpoint path: a missing/truncated/corrupt file warns
            # and degrades to the exact AgedLFU fallback below instead
            # of crashing mid-serve (robustness contract, test-enforced)
            from repro_torch.core.learned import LearnedModel
            model = LearnedModel.load_or_none(model)
        self.model = model
        self.min_confidence = min_confidence
        self._decays = tuple(getattr(model, "decays", (0.5, 0.9, 0.98)))
        self._gamma = float(getattr(model, "gamma", 0.8))
        self._traces: dict = {}    # key -> [value per decay]
        self._trace_t: dict = {}   # key -> step of last trace update
        self._cnt: dict = {}       # key -> lifetime touch count
        self._last_act: dict = {}  # key -> step of last touch

    # -- learned scoring ----------------------------------------------
    def _model_usable(self) -> bool:
        return self.model is not None and \
            getattr(self.model, "confidence", 1.0) >= self.min_confidence

    def _touch(self, key):
        super()._touch(key)
        t = self._step
        gap = t - self._trace_t.get(key, t)
        vals = self._traces.get(key)
        if vals is None:
            vals = [0.0] * len(self._decays)
        self._traces[key] = [v * d ** gap + 1.0
                             for v, d in zip(vals, self._decays)]
        self._trace_t[key] = t
        self._cnt[key] = self._cnt.get(key, 0) + 1
        self._last_act[key] = t

    def _features(self, key) -> List[float]:
        t = self._step
        gap = t - self._trace_t.get(key, t)
        vals = self._traces.get(key, [0.0] * len(self._decays))
        decayed = [v * d ** gap for v, d in zip(vals, self._decays)]
        freq = self._cnt.get(key, 0) / max(t, 1)
        last = self._last_act.get(key)
        rec = self._gamma ** min(t - last, 512) if last is not None else 0.0
        return [1.0, *decayed, freq, rec, float("nan")]

    def choose_victim(self, exclude: frozenset = frozenset()):
        if not self._model_usable():
            return super().choose_victim(exclude)
        cand = [k for k in self._set if k not in exclude]
        if not cand:
            raise RuntimeError("all cached keys pinned")
        probs = self.model.predict([self._features(k) for k in cand])
        # least predicted reuse first; AgedLFU score breaks float ties
        return min(zip(cand, probs),
                   key=lambda kp: (float(kp[1]), self._ffreq.get(kp[0], 0.0),
                                   self._last.get(kp[0], -1)))[0]

    def remove(self, key):
        super().remove(key)
        if not self._persistent:
            for d in (self._traces, self._trace_t, self._cnt,
                      self._last_act):
                d.pop(key, None)


class LRFU(CachePolicy):
    """Beyond-paper: LRFU (Lee et al. 2001) — each key has a CRF score
    F(k) = Σ (1/2)^(λ·(now-t_i)) over its access times; λ→0 is LFU,
    λ→1 is LRU. Maintained incrementally."""

    name = "lrfu"

    def __init__(self, capacity: int, *, lam: float = 0.1):
        super().__init__(capacity)
        self._lam = lam
        self._crf: dict = {}
        self._t: dict = {}
        self._set: set = set()

    def contains(self, key):
        return key in self._set

    def keys(self):
        return list(self._set)

    def _score_now(self, key) -> float:
        dt = self._step - self._t.get(key, self._step)
        return self._crf.get(key, 0.0) * (0.5 ** (self._lam * dt))

    def _touch(self, key):
        self._crf[key] = 1.0 + self._score_now(key)
        self._t[key] = self._step

    def on_access(self, key):
        self._touch(key)

    def on_insert(self, key):
        self._set.add(key)
        self._touch(key)

    def choose_victim(self, exclude: frozenset = frozenset()):
        cand = [k for k in self._set if k not in exclude]
        if not cand:
            raise RuntimeError("all cached keys pinned")
        return min(cand, key=lambda k: (self._score_now(k), self._t.get(k, -1)))

    def remove(self, key):
        self._set.discard(key)


class Belady(CachePolicy):
    """Clairvoyant optimum (upper bound): evict the key whose next use
    is farthest in the future. Needs the full future access sequence,
    supplied as a list of keys; ``advance()`` is called once per access
    by the driver."""

    name = "belady"

    def __init__(self, capacity: int, future: Sequence[Key]):
        super().__init__(capacity)
        self._future = list(future)
        self._cursor = 0
        self._set: set = set()
        # next-use index precomputation
        self._next_use: dict = {}
        occurrences: dict = {}
        for i, k in enumerate(self._future):
            occurrences.setdefault(k, []).append(i)
        self._occ = occurrences

    def advance(self, n: int = 1):
        self._cursor += n

    def _next(self, key) -> int:
        occ = self._occ.get(key, [])
        # first occurrence >= cursor
        lo, hi = 0, len(occ)
        while lo < hi:
            mid = (lo + hi) // 2
            if occ[mid] < self._cursor:
                lo = mid + 1
            else:
                hi = mid
        return occ[lo] if lo < len(occ) else 1 << 60

    def contains(self, key):
        return key in self._set

    def keys(self):
        return list(self._set)

    def on_access(self, key):
        pass

    def on_insert(self, key):
        self._set.add(key)

    def choose_victim(self, exclude: frozenset = frozenset()):
        cand = [k for k in self._set if k not in exclude]
        if not cand:
            raise RuntimeError("all cached keys pinned")
        return max(cand, key=self._next)

    def remove(self, key):
        self._set.discard(key)


POLICIES = {
    "lru": LRU,
    "lfu": LFU,
    "fifo": FIFO,
    "random": RandomPolicy,
    "aged-lfu": AgedLFU,
    "lrfu": LRFU,
    "learned": LearnedPolicy,
}


def make_policy(name: str, capacity: int, **kw) -> CachePolicy:
    if name == "belady":
        return Belady(capacity, kw.pop("future"))
    if name not in POLICIES:
        raise ValueError(f"unknown cache policy {name!r}: expected one "
                         f"of {sorted(POLICIES) + ['belady']}")
    return POLICIES[name](capacity, **kw)
