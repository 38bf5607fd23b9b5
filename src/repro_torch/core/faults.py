"""Deterministic fault injection for the offloading stack.

Every layer built so far — the two-lane ``TransferEngine``, the
HBM->host->disk arbiter, the continuous server — assumed transfers
always succeed and hardware bandwidth is constant. No edge deployment
of the paper's offloading design can assume that: SSDs drop reads,
DMA engines straggle under thermal throttling, and a bit flip in a
streamed expert payload silently poisons decode. This module makes
those failures FIRST-CLASS and, critically, DETERMINISTIC: a seeded
``FaultPlan`` drives every decision through counter-indexed hashing
(no shared RNG stream), so a chaos run replays bit-for-bit and a
failure found in CI reproduces locally from the seed alone.

Fault classes (all opt-in, all off in ``FaultPlan.null()``):

* transient DMA failures — a host->device copy attempt fails with
  probability ``dma_failure_rate`` and is retried with exponential
  backoff on the simulated clock (``max_retries`` retries, then the
  fetch is ABANDONED and the consumer degrades — see
  ``OffloadEngine``'s drop-missing-expert fallback);
* disk read errors — fetches served from the simulated SSD tier fail
  with an ADDITIONAL ``disk_error_rate`` per attempt (flaky-SSD regime,
  the FlashMoE deployment target);
* expert-payload corruption — with probability ``corruption_rate`` a
  completed copy delivers corrupted bytes. Payloads are CHECKSUMMED on
  fetch (``ExpertStore.verify``), the mismatch is detected, and the
  fetch retries; the corruption is real (a byte actually flips in the
  delivered arrays) so the checksum machinery is exercised, not
  simulated;
* stragglers — per-lane bandwidth-degradation windows
  (``StragglerWindow``): a copy that STARTS inside a window runs at
  ``1/factor`` of nominal bandwidth for its whole duration.

Determinism contract: every decision is a pure function of
``(plan.seed, kind, key, event_index, attempt)`` via blake2b hashing.
``event_index`` is a per-(kind, key) counter, so the N-th fetch of
expert (2, 5) always sees the same fate regardless of what any other
expert did — decisions are order-independent across keys, which lets
the engine PRE-PLAN a layer's fetch outcomes (to know the degraded
set before compute) and hand the same outcomes to the transfer
engine without double-consuming randomness.

With a null plan every consumer takes its pre-fault code path and is
bit-identical to a build with no injector attached (test-enforced).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class StragglerWindow:
    """Bandwidth degradation on one DMA lane (or all: ``lane=None``)
    during ``[t0, t1)`` of the simulated clock. A transfer that starts
    inside the window takes ``factor``x its nominal duration."""
    t0: float
    t1: float
    factor: float
    lane: Optional[int] = None

    def covers(self, lane: int, t: float) -> bool:
        return (self.lane is None or self.lane == lane) and \
            self.t0 <= t < self.t1


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded, declarative fault schedule. All rates are per-attempt
    probabilities in [0, 1]; ``max_retries`` is the number of RETRIES
    after the first attempt (so a fetch makes at most
    ``max_retries + 1`` attempts before being abandoned). Backoff
    between attempt k and k+1 is ``backoff_base_s * backoff_mult**(k-1)``
    seconds of simulated time."""
    seed: int = 0
    dma_failure_rate: float = 0.0
    disk_error_rate: float = 0.0
    corruption_rate: float = 0.0
    straggler_windows: Tuple[StragglerWindow, ...] = ()
    max_retries: int = 3
    backoff_base_s: float = 50e-6
    backoff_mult: float = 2.0

    def __post_init__(self):
        for name in ("dma_failure_rate", "disk_error_rate",
                     "corruption_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, "
                             f"got {self.max_retries}")
        if self.backoff_base_s < 0 or self.backoff_mult < 1.0:
            raise ValueError("backoff_base_s must be >= 0 and "
                             "backoff_mult >= 1.0")

    @classmethod
    def null(cls, seed: int = 0) -> "FaultPlan":
        """The no-fault plan: every consumer must behave bit-identically
        to a build with no injector attached (test-enforced)."""
        return cls(seed=seed)

    @property
    def is_null(self) -> bool:
        return (self.dma_failure_rate == 0.0 and
                self.disk_error_rate == 0.0 and
                self.corruption_rate == 0.0 and
                not self.straggler_windows)


@dataclasses.dataclass
class FetchOutcome:
    """Pre-planned fate of ONE fetch event (a retry chain).

    ``fail_kinds`` holds one entry per FAILED attempt in order
    ("dma" / "disk" / "corrupt"); ``attempts = len(fail_kinds) + 1``
    when the chain succeeds, ``len(fail_kinds)`` when abandoned.
    Timing is kept abstract (counts, not seconds) so the same outcome
    prices both the synchronous analytic path and the transfer-engine
    lane schedule without re-deciding anything.
    """
    key: Tuple
    success: bool = True
    fail_kinds: Tuple[str, ...] = ()

    @property
    def attempts(self) -> int:
        return len(self.fail_kinds) + (1 if self.success else 0)

    @property
    def corrupt_deliveries(self) -> int:
        return sum(1 for k in self.fail_kinds if k == "corrupt")

    def backoff_s(self, plan: FaultPlan) -> float:
        """Total inter-attempt backoff of the chain (simulated s)."""
        n = max(self.attempts - 1, 0)
        return sum(plan.backoff_base_s * plan.backoff_mult ** k
                   for k in range(n))

    def occupancy_s(self, base_s: float, plan: FaultPlan) -> float:
        """Simulated seconds the chain holds its transfer lane: every
        attempt copies for ``base_s`` (failed ones moved bytes too),
        plus the backoff gaps — the lane is HELD across the chain so a
        retrying demand keeps its priority slot (see
        ``TransferEngine``)."""
        return self.attempts * base_s + self.backoff_s(plan)

    def extra_s(self, base_s: float, plan: FaultPlan) -> float:
        """Simulated seconds BEYOND the one transfer the fault-free
        path already prices: retries + backoff for a successful chain,
        the whole chain for an abandoned one (the fault-free path
        prices nothing for a fetch that never lands)."""
        occ = self.occupancy_s(base_s, plan)
        return occ - base_s if self.success else occ


_OK = FetchOutcome(key=None)


class FaultInjector:
    """Runtime companion of a ``FaultPlan``: counters, trace events,
    and the hash-based decision functions. One injector is shared by
    the engine, its per-layer ``ExpertCache``s, the ``TransferEngine``
    and the tier arbiter's ``SwapQueue`` so event indices are globally
    consistent.

    ``now`` is a loosely-maintained simulated timestamp (the engine
    refreshes it at layer boundaries) used only to timestamp
    ``FaultEvent``s — decisions never depend on it.
    """

    def __init__(self, plan: FaultPlan, trace=None):
        if not isinstance(plan, FaultPlan):
            raise ValueError(f"FaultInjector needs a FaultPlan, "
                             f"got {type(plan).__name__}")
        self.plan = plan
        self.trace = trace
        self.now = 0.0
        self._counts: Dict[Tuple, int] = {}   # (kind, key) -> events seen
        # cumulative counters (surfaced via stats())
        self.dma_failures = 0
        self.disk_errors = 0
        self.corruptions = 0
        self.retries = 0
        self.abandoned = 0
        self.straggled = 0
        self.deadline_missed = 0

    # --------------------------------------------------- decision core
    def _u01(self, *fields) -> float:
        """Uniform [0,1) from a blake2b hash of the seed + fields.
        Pure and order-independent: the same fields always map to the
        same draw, on every platform."""
        h = hashlib.blake2b(repr((self.plan.seed,) + fields).encode(),
                            digest_size=8)
        return int.from_bytes(h.digest(), "big") / 2.0 ** 64

    def _next_index(self, kind: str, key) -> int:
        k = (kind, key)
        n = self._counts.get(k, 0)
        self._counts[k] = n + 1
        return n

    def _event(self, kind: str, action: str, key, attempt: int,
               detail: str = "") -> None:
        if self.trace is not None:
            self.trace.record_fault(kind=kind, action=action,
                                    key=tuple(key) if key else (),
                                    attempt=attempt, sim_time=self.now,
                                    detail=detail)

    # ------------------------------------------------------ fetch plans
    def fetch_plan(self, key, *, tier: str = "host") -> FetchOutcome:
        """Decide the full retry chain of one expert-fetch event.

        Per attempt: fail as "dma" with ``dma_failure_rate``, as
        "disk" with an additional ``disk_error_rate`` when the master
        is disk-resident; a copy that lands is then corrupted with
        ``corruption_rate`` (checksum mismatch -> counts as a failed
        attempt). The chain is abandoned after ``max_retries``
        retries; the caller degrades (drops the expert for this step).
        """
        if self.plan.is_null:
            return _OK
        n = self._next_index("fetch", key)
        p_dma = self.plan.dma_failure_rate
        p_disk = self.plan.disk_error_rate if tier == "disk" else 0.0
        fails = []
        success = False
        for attempt in range(self.plan.max_retries + 1):
            u = self._u01("fetch", key, n, attempt)
            if u < p_dma:
                fails.append("dma")
                self.dma_failures += 1
                self._event("dma", "retry", key, attempt)
                continue
            if u < p_dma + p_disk:
                fails.append("disk")
                self.disk_errors += 1
                self._event("disk", "retry", key, attempt)
                continue
            if self._u01("corrupt", key, n, attempt) \
                    < self.plan.corruption_rate:
                fails.append("corrupt")
                self.corruptions += 1
                self._event("corrupt", "retry", key, attempt)
                continue
            success = True
            break
        out = FetchOutcome(key=key, success=success,
                           fail_kinds=tuple(fails))
        self.retries += len(fails) if success else max(len(fails) - 1, 0)
        if not success:
            self.abandoned += 1
            self._event(fails[-1] if fails else "dma", "abandon", key,
                        len(fails), detail="fetch abandoned; degrading")
        return out

    def transfer_plan(self, key, *, kind: str = "xfer",
                      abandonable: bool = False) -> FetchOutcome:
        """Retry chain for a generic copy-engine transfer (KV swaps,
        transfers submitted without a pre-planned outcome). Only
        transient DMA failures apply. ``abandonable=False`` (the KV
        default — a parked request's snapshot is the ONLY copy) forces
        the final attempt to succeed: the chain is bounded either way,
        so nothing ever hangs."""
        if self.plan.is_null or self.plan.dma_failure_rate <= 0.0:
            return _OK
        n = self._next_index(kind, key)
        total = self.plan.max_retries + 1
        fails = []
        success = False
        for attempt in range(total):
            if attempt == total - 1 and not abandonable:
                success = True  # forced final success: data preserved
                break
            if self._u01(kind, key, n, attempt) \
                    < self.plan.dma_failure_rate:
                fails.append("dma")
                self.dma_failures += 1
                self._event("dma", "retry", key, attempt, detail=kind)
                continue
            success = True
            break
        self.retries += len(fails) if success else max(len(fails) - 1, 0)
        if not success:
            self.abandoned += 1
            self._event("dma", "abandon", key, len(fails), detail=kind)
        return FetchOutcome(key=key, success=success,
                            fail_kinds=tuple(fails))

    # ------------------------------------------------------- stragglers
    def bw_factor(self, lane: int, t: float) -> float:
        """Duration multiplier for a copy starting on ``lane`` at
        simulated time ``t`` (worst window wins; 1.0 outside any)."""
        f = 1.0
        for w in self.plan.straggler_windows:
            if w.covers(lane, t):
                f = max(f, w.factor)
        if f > 1.0:
            self.straggled += 1
            self._event("straggler", "slow", (), 0,
                        detail=f"lane={lane} factor={f:g}")
        return f

    # ------------------------------------------------------- corruption
    def corrupt_payload(self, weights: Dict[str, np.ndarray]
                        ) -> Dict[str, np.ndarray]:
        """A REAL corrupted delivery: copy the payload and flip one
        byte of one matrix (deterministic choice). The caller verifies
        the checksum, detects the mismatch, and refetches."""
        n = self._next_index("flip", None)
        names = sorted(weights)
        name = names[int(self._u01("flip-name", n) * len(names))
                     % len(names)]
        out = {k: np.array(v, copy=True) for k, v in weights.items()}
        flat = out[name].view(np.uint8).reshape(-1)
        idx = int(self._u01("flip-idx", n) * flat.size) % flat.size
        flat[idx] ^= 0xFF
        return out

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict[str, float]:
        return {
            "fault_dma_failures": self.dma_failures,
            "fault_disk_errors": self.disk_errors,
            "fault_corruptions": self.corruptions,
            "fault_retries": self.retries,
            "fault_abandoned": self.abandoned,
            "fault_straggled": self.straggled,
            "fault_deadline_missed": self.deadline_missed,
        }


def as_injector(faults, trace=None) -> Optional[FaultInjector]:
    """Normalize the ``faults=`` knob: None stays None, a ``FaultPlan``
    wraps into a fresh ``FaultInjector`` (bound to ``trace``), an
    injector passes through."""
    if faults is None:
        return None
    if isinstance(faults, FaultInjector):
        return faults
    if isinstance(faults, FaultPlan):
        return FaultInjector(faults, trace=trace)
    raise ValueError(
        f"faults= must be a FaultPlan, FaultInjector or None, "
        f"got {type(faults).__name__}")
