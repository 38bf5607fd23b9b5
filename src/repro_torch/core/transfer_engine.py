"""Copy-engine model for host->device expert traffic (simulated clock).

PR 8's ``SwapQueue`` modeled demotion traffic as N transfer lanes over
a simulated clock. This module generalizes that into the repo's single
copy-engine abstraction, shared by the tiered-memory arbiter (which now
subclasses it — see ``memory_tiers.SwapQueue``) and the decode overlap
pipeline in ``OffloadEngine``:

* every transfer is a first-class ``Transfer`` record with its full
  timeline (``issue`` <= ``start`` <= ``done``) and an identity
  ``key`` (e.g. ``(layer, expert_id)``) so the pipeline can ask "when
  is the expert I need actually resident?";
* two priority classes: DEMAND transfers (a layer is blocked on the
  bytes) may displace PREFETCH transfers that are queued on a lane but
  have not started copying — exactly what a GPU copy engine with a
  high-priority stream does — while prefetches always append behind
  the lane tail;
* the clock is simulated and explicit (``now`` is always an argument;
  there is no wall clock anywhere), so schedules are deterministic and
  replayable, matching the repo-wide contract of real trace-level
  behaviour over modeled latency.

The overlap pipeline's one formula lives here too: a layer that needs
keys ``K`` and finishes its FLOPs at ``compute_done`` stalls for
``max(0, dma_done(K) - compute_done)`` — see ``stall_until``. Transfers
that land before the compute does are fully hidden; only the tail that
sticks out past ``compute_done`` is exposed.

With a ``FaultInjector`` attached (``faults=``, see
``repro_torch.core.faults``) the engine becomes fault-aware: a submit may
resolve into a RETRY CHAIN — failed attempts re-copy after exponential
backoff, the lane is HELD across the whole chain (a retrying demand
keeps its priority slot; backoff models device re-arm time), and a
chain that exhausts its retries is ABANDONED (``Transfer.ok=False`` —
the consumer degrades instead of waiting forever). A transfer may also
carry a ``deadline``: a chain that cannot complete by it is cut there
and abandoned. Straggler windows scale a copy's duration by the lane
bandwidth factor at its start time. With no injector (or a null plan)
every schedule is byte-identical to the pre-fault engine
(test-enforced).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class Transfer:
    """One scheduled copy. ``issue`` is when it was submitted,
    ``start`` when a lane began copying, ``done`` when the bytes are
    usable. ``demand`` transfers block a consumer; prefetches do not.
    ``info`` carries caller fields (``SwapQueue`` match keys).
    Under fault injection ``duration`` is the full retry-chain lane
    occupancy, ``attempts`` how many copies it took, and ``ok`` False
    when the chain was abandoned (retries exhausted or ``deadline``
    missed) — the bytes then never become usable."""
    seq: int
    key: Hashable
    kind: str
    nbytes: int
    duration: float
    issue: float
    start: float
    done: float
    lane: int
    demand: bool
    info: dict = dataclasses.field(default_factory=dict)
    attempts: int = 1
    ok: bool = True
    deadline: Optional[float] = None


class TransferEngine:
    """N-lane copy engine over a simulated clock.

    ``submit`` schedules a transfer and returns its ``Transfer`` (with
    ``start``/``done`` already resolved — the schedule is deterministic
    at submit time, and only a later DEMAND submit may revise a
    not-yet-started prefetch's slot). ``advance(now)`` retires
    completed transfers; every submitted transfer retires exactly once
    (conservation, test-enforced).
    """

    def __init__(self, lanes: int = 2, faults=None):
        assert lanes >= 1
        self.n_lanes = lanes
        self._lanes: List[List[Transfer]] = [[] for _ in range(lanes)]
        self.inflight: List[Transfer] = []
        self.retired: List[Transfer] = []
        self.now = 0.0
        self.submitted = 0
        self.completed = 0
        self.busy_s = 0.0          # total copy seconds issued
        self.preempted = 0         # queued prefetches displaced by demand
        self.faults = faults       # Optional[FaultInjector]
        self.retries = 0           # extra copy attempts across all chains
        self.abandoned = 0         # chains that gave up (retries/deadline)
        self.deadline_missed = 0   # transfers cut at their deadline

    # ------------------------------------------------------------ submit
    def submit(self, now: float, duration: float, *,
               key: Hashable = None, kind: str = "xfer", nbytes: int = 0,
               demand: bool = False, outcome=None,
               deadline: Optional[float] = None, **info) -> Transfer:
        """Schedule ``duration`` seconds of copy starting no earlier
        than ``now``. Demand transfers pick the lane whose
        demand-visible tail (started or demand transfers only) frees
        first and push queued prefetches behind them; prefetches pick
        the lane whose full tail frees first.

        Under fault injection the copy may become a retry chain:
        ``outcome`` (a pre-planned ``FetchOutcome``, e.g. from
        ``ExpertCache.plan_fetches``) or the injector's own
        ``transfer_plan`` decides attempts/abandonment, and the lane is
        held for the whole chain. ``deadline`` (absolute sim time) cuts
        a chain that cannot finish by then. Without an injector both
        knobs are inert and the schedule is byte-identical to PR 9."""
        assert duration >= 0.0
        t = Transfer(seq=self.submitted, key=key, kind=kind,
                     nbytes=int(nbytes), duration=float(duration),
                     issue=float(now), start=0.0, done=0.0, lane=-1,
                     demand=bool(demand), info=info, deadline=deadline)
        if demand:
            lane = min(range(self.n_lanes), key=lambda i: self._barrier(i, now))
            t.lane = lane
            t.start = self._barrier(lane, now)
        else:
            lane = min(range(self.n_lanes), key=lambda i: self._tail(i, now))
            t.lane = lane
            t.start = self._tail(lane, now)
        copy_s = self._resolve_chain(t, outcome)
        t.done = t.start + t.duration
        if demand:
            self._place_demand(t, now)
        else:
            self._lanes[lane].append(t)
        self.inflight.append(t)
        self.submitted += 1
        self.busy_s += copy_s
        return t

    def _resolve_chain(self, t: Transfer, outcome) -> float:
        """Resolve ``t``'s effective lane occupancy under fault
        injection. Returns the actual copy seconds issued (excludes
        backoff gaps); sets ``t.duration`` to the full occupancy and
        ``t.attempts``/``t.ok``. Fault-free: ``t`` untouched."""
        copy_s = t.duration
        inj = self.faults
        if inj is not None and not inj.plan.is_null:
            factor = inj.bw_factor(t.lane, t.start)
            if outcome is None:
                outcome = inj.transfer_plan(
                    t.key, kind=t.kind, abandonable=False)
            t.attempts = max(outcome.attempts, 1)
            copy_s = t.attempts * t.duration * factor
            t.duration = copy_s + outcome.backoff_s(inj.plan)
            if not outcome.success:
                t.ok = False
            self.retries += max(t.attempts - 1, 0)
            if not outcome.success:
                self.abandoned += 1
        if t.deadline is not None and t.start + t.duration > t.deadline:
            # the consumer will not wait past the deadline: cut the
            # chain there and abandon — the bytes never land
            cut = max(t.deadline - t.start, 0.0)
            copy_s = min(copy_s, cut)
            t.duration = cut
            if t.ok:
                t.ok = False
                self.abandoned += 1
            self.deadline_missed += 1
            if inj is not None:
                inj.deadline_missed += 1
                inj._event("dma", "timeout", t.key, t.attempts,
                           f"deadline={t.deadline:.6g}")
        return copy_s

    def _tail(self, lane: int, now: float) -> float:
        return max([now] + [x.done for x in self._lanes[lane]])

    def _barrier(self, lane: int, now: float) -> float:
        """Earliest time a DEMAND transfer could start on ``lane``:
        behind everything already copying (started) or itself demand —
        queued prefetches are displaceable and don't count."""
        return max([now] + [x.done for x in self._lanes[lane]
                            if x.demand or x.start <= now])

    def _place_demand(self, t: Transfer, now: float) -> None:
        """Insert an already-scheduled demand transfer into its lane,
        displacing queued-not-started prefetches behind it."""
        q = self._lanes[t.lane]
        keep = [x for x in q if x.demand or x.start <= now]
        bumped = [x for x in q if not (x.demand or x.start <= now)]
        self.preempted += len(bumped)
        # resequence displaced prefetches behind the demand, original order
        cur = t.done
        for x in bumped:
            x.start = cur
            x.done = x.start + x.duration
            cur = x.done
        self._lanes[t.lane] = keep + [t] + bumped

    # ----------------------------------------------------------- queries
    def advance(self, now: float) -> List[Transfer]:
        """Move the clock forward (monotone) and retire every transfer
        complete by then. Returns the newly retired transfers."""
        self.now = max(self.now, float(now))
        done = [t for t in self.inflight if t.done <= self.now]
        if done:
            self.inflight = [t for t in self.inflight if t.done > self.now]
            for lane in range(self.n_lanes):
                self._lanes[lane] = [t for t in self._lanes[lane]
                                     if t.done > self.now]
            self.retired.extend(done)
            self.completed += len(done)
        return done

    def pending(self, now: Optional[float] = None, **match) -> List[Transfer]:
        """In-flight transfers not complete at ``now`` whose ``kind`` or
        ``info`` fields match ``match`` (e.g. ``kind="kv"``)."""
        t0 = self.now if now is None else now
        out = []
        for t in self.inflight:
            if t.done <= t0:
                continue
            ok = True
            for k, v in match.items():
                cur = t.kind if k == "kind" else t.info.get(k)
                if cur != v:
                    ok = False
                    break
            if ok:
                out.append(t)
        return out

    def inflight_for(self, keys: Sequence[Hashable],
                     now: Optional[float] = None) -> List[Transfer]:
        """In-flight transfers (not complete at ``now``) whose identity
        key is in ``keys``."""
        want = set(keys)
        t0 = self.now if now is None else now
        return [t for t in self.inflight if t.key in want and t.done > t0]

    def done_time(self, keys: Sequence[Hashable],
                  now: Optional[float] = None) -> float:
        """Latest completion among in-flight transfers for ``keys``
        (``now`` if nothing for those keys is in flight)."""
        t0 = self.now if now is None else now
        times = [t.done for t in self.inflight_for(keys, t0)]
        return max([t0] + times)

    def stall_until(self, keys: Sequence[Hashable], compute_done: float
                    ) -> Tuple[float, Tuple[Hashable, ...]]:
        """The overlap pipeline's exposure formula. A consumer that
        needs ``keys`` and finishes compute at ``compute_done`` waits
        ``stall = max(0, dma_done - compute_done)`` where ``dma_done``
        is the latest completion among in-flight transfers for those
        keys. Also returns the keys still in flight at ``compute_done``
        (the stall causers), for the trace."""
        blockers = tuple(sorted(
            {t.key for t in self.inflight_for(keys, compute_done)},
            key=repr))
        dma_done = self.done_time(keys, compute_done)
        return max(0.0, dma_done - compute_done), blockers

    # ------------------------------------------------------------- stats
    def stats(self) -> Dict[str, float]:
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "inflight": len(self.inflight),
            "busy_s": self.busy_s,
            "preempted": self.preempted,
            "retries": self.retries,
            "abandoned": self.abandoned,
            "deadline_missed": self.deadline_missed,
        }
