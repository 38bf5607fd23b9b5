"""Pluggable request scheduling for the continuous offload server.

Admission (which queued request joins a free slot next), preemption
victim selection (who loses their KV pages when the paged pool
exhausts), and chunk ordering (who gets the leftover per-step token
budget first) were hardcoded FIFO / youngest-first in the original
server. They are now one ``Scheduler`` object with three decision
points, so SLO policy is swappable without touching the serving loop:

  ``fifo``      arrival order; youngest-joiner preemption. The default —
                preserves the original server's behavior exactly
                (test-enforced).
  ``sjf``       shortest-remaining-job first: short requests overtake
                long prompts in the queue (classic mean-latency
                optimum); preemption evicts the LONGEST remaining job,
                which frees the most pool for the longest time.
  ``priority``  explicit per-request priority levels with per-tenant
                fairness inside a level: among equal-priority requests
                the least-served tenant (fewest tokens served so far,
                scored from the per-request trace slices the server
                accumulates) goes first.

Scheduling never changes generated text — admission order, chunk
budgets, and preemption only reorder WHEN tokens are computed, and the
engine's caches/paging are bit-transparent (test-enforced per
scheduler). Only ordering and latency statistics move.

Candidate ordering is always deterministic: scores tie-break on
arrival order (``Request.rid`` is monotonically assigned at submit).
A blocked head never overtakes: admission stops at the first candidate
the KV pool cannot hold, whatever the scheduler, so big requests are
never starved by a stream of small ones.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.serving.request import Request


def remaining_tokens(req: Request) -> int:
    """Tokens this request still needs a step for: unfed known tokens
    plus the decode tokens not yet sampled. A preempted request's true
    re-entry cost is counted either way — replay-as-prefill resets
    ``pos`` to 0 (full replay charged), while resume-from-host keeps
    ``pos`` at the parked position (only the real remainder) — so SJF
    sees the actual remaining work, not the pre-preemption estimate."""
    unfed = len(req.tokens) - req.pos
    unsampled = req.max_new - len(req.out)
    return unfed + unsampled


class Scheduler:
    """Decision points for the serving loop. Subclasses override the
    scoring; the base class IS the fifo policy."""

    name = "fifo"

    def __init__(self) -> None:
        self._server = None

    def bind(self, server) -> None:
        """Give the scheduler read access to server state (trace,
        tenant service counters). Called once by the server ctor."""
        self._server = server

    # ----------------------------------------------------- decisions
    def admission_order(self, queue: Sequence[Request]) -> List[Request]:
        """Order queued requests by admission preference (first =
        admit next). fifo: arrival order, i.e. the queue as-is."""
        return list(queue)

    def choose_victim(self, active: Sequence[Request]) -> Request:
        """Pick the running request to preempt when the paged pool
        exhausts. fifo: the youngest joiner (the original server's
        hardcoded rule) — oldest-first service order makes an
        overcommitted pool converge to sequential service."""
        return max(active, key=lambda r: r.join_seq)

    def chunk_order(self, active: Sequence[Request]) -> List[Request]:
        """Order active requests for leftover prefill-budget
        distribution (everyone is guaranteed 1 token first; see
        ``ContinuousOffloadServer.step``). fifo: oldest joiner first."""
        return sorted(active, key=lambda r: r.join_seq)

    # ------------------------------------------------------- helpers
    def _tenant_service(self, tenant: Optional[str]) -> int:
        if self._server is None or tenant is None:
            return 0
        return int(self._server.tenant_service.get(tenant, 0))


class SjfScheduler(Scheduler):
    """Shortest remaining job first."""

    name = "sjf"

    def admission_order(self, queue: Sequence[Request]) -> List[Request]:
        return sorted(queue, key=lambda r: (remaining_tokens(r), r.rid))

    def choose_victim(self, active: Sequence[Request]) -> Request:
        # evict the longest remaining job: it frees the most blocks
        # and delays the request that was going to finish last anyway
        return max(active, key=lambda r: (remaining_tokens(r), r.rid))

    def chunk_order(self, active: Sequence[Request]) -> List[Request]:
        return sorted(active, key=lambda r: (remaining_tokens(r), r.rid))


class PriorityScheduler(Scheduler):
    """Strict priority levels (higher ``Request.priority`` first) with
    per-tenant fairness inside a level: the tenant with the fewest
    tokens served so far goes first. Service counts come from the
    server's per-request trace accounting (``tenant_service``, the
    incremental sum of the trace slices' per-request token counts —
    asserted equal to the sliced ``TraceRecorder.request_stats`` sums
    by the scheduler tests)."""

    name = "priority"

    def _key(self, r: Request):
        return (-r.priority, self._tenant_service(r.tenant), r.rid)

    def admission_order(self, queue: Sequence[Request]) -> List[Request]:
        return sorted(queue, key=self._key)

    def choose_victim(self, active: Sequence[Request]) -> Request:
        # mirror-image of admission: lowest priority loses its pages;
        # ties evict the MOST-served tenant, youngest arrival
        return max(active, key=lambda r: (
            -r.priority, self._tenant_service(r.tenant), r.rid))

    def chunk_order(self, active: Sequence[Request]) -> List[Request]:
        return sorted(active, key=self._key)


SCHEDULERS: Dict[str, type] = {
    "fifo": Scheduler,
    "sjf": SjfScheduler,
    "priority": PriorityScheduler,
}


def make_scheduler(name: str, **kw) -> Scheduler:
    """Instantiate a scheduler by registry name (see ``SCHEDULERS``)."""
    if name not in SCHEDULERS:
        raise ValueError(f"unknown scheduler {name!r}: expected one of "
                         f"{sorted(SCHEDULERS)}")
    return SCHEDULERS[name](**kw)
