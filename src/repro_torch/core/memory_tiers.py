"""Unified HBM -> host -> disk memory arbiter (port of
``repro.core.memory_tiers``).

Before this module, the two consumers of device memory — expert-cache
slots (``ExpertCache``) and paged KV blocks (``PagedKVCache``) — were
sized independently, and host memory was treated as infinite. The
``TieredMemoryManager`` makes the hierarchy explicit:

  hbm   one byte budget, SPLIT by ``plan_hbm_split`` between per-layer
        expert slot buffers and the shared KV block pool (the residency
        trade ``CostModel.kv_tokens_per_expert_slot`` prices);
  host  expert master copies (``ExpertStore``) + parked KV of preempted
        requests, capped by an optional byte budget;
  disk  simulated SSD overflow — cold expert masters and parked KV
        spill here under host pressure, and fetching them back pays the
        FlashMoE-style per-tier latency/bandwidth ``CostModel.
        tier_transfer_time`` models. Nothing is written to a disk: the
        masters and the parked tensors stay in host memory, and only
        the clock and the counters see the tier.

Movement between tiers goes through ONE double-buffered ``SwapQueue``:
two transfer lanes over the simulated clock, so at most two swaps are
in flight and a burst serializes. Demotions are asynchronous — a step
only stalls on a demotion when it actually needs the blocks still
being copied out (``note_block_claims``) or the data being moved
(``resume_kv`` of a just-parked request). Promotions ride the existing
machinery: a demand miss on a disk-resident expert stalls the layer
(``fetch_expert``), a prefetch of one hides the disk hop in the queue,
and the HBM->host demotion *target* is whatever victim the cache
policy (``LearnedPolicy``/``AgedLFU``/...) chose — the arbiter never
second-guesses the eviction decision, it only files the bytes.

Expert weights are CLEAN (the host/disk master is the source of
truth), so an HBM eviction is a free drop, not a writeback; the swap
queue carries the dirty traffic: KV demotions (the only copy of a
preempted request's state) and expert master spills host->disk.
Parked KV is what lets ``ContinuousOffloadServer`` resume a preempted
request from host-tier state instead of replaying its tokens as
prefill — see ``park_kv``/``resume_kv``.

The control plane (budgets, the queue, the clock, ``TierEvent``s and
the ``tier_*`` stats) is the reference's, unchanged, so it matches the
JAX package exactly. The parked payload is the port's own: per layer,
host copies of the pool's tensors under their keys (``{"k", "v"}`` for
GQA, ``{"latent", "k_rope"}`` for MLA), pinned when the pool is on a
card; the server's ``PagedKVCache.park_blocks`` / ``restore_blocks``
move them on the engine's copy stream. All byte accounting is real (tensor
bytes of what is actually parked / stored); all timing is simulated
through ``CostModel``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.core.transfer_engine import Transfer, TransferEngine

Key = Tuple[int, int]  # (layer, expert_id)


def plan_hbm_split(hbm_bytes: int, *, num_layers: int, num_experts: int,
                   expert_bytes: int, kv_block_bytes: int,
                   expert_frac: float = 0.5,
                   min_slots: int = 1, min_blocks: int = 1
                   ) -> Tuple[int, int]:
    """Split one HBM byte budget between expert-cache slots and KV
    blocks. Returns ``(slots_per_layer, kv_num_blocks)``.

    ``expert_frac`` of the budget goes to expert slots (one slot costs
    ``num_layers * expert_bytes`` — every layer gets the same count);
    the REMAINDER, not ``1 - expert_frac``, funds the KV pool, so the
    bytes a fractional slot cannot use are not stranded. Floors
    (``min_slots``/``min_blocks``) keep tiny budgets runnable; when
    they bind, the plan intentionally overcommits the budget rather
    than returning an unusable zero-slot configuration.
    """
    assert 0.0 < expert_frac < 1.0
    per_slot = num_layers * expert_bytes
    slots = int((hbm_bytes * expert_frac) // per_slot)
    slots = max(min_slots, min(slots, num_experts))
    kv_budget = max(hbm_bytes - slots * per_slot, 0)
    blocks = max(min_blocks, int(kv_budget // kv_block_bytes))
    return slots, blocks


class SwapQueue(TransferEngine):
    """Double-buffered asynchronous transfer queue (simulated clock).

    ``lanes`` (default 2 — classic double buffering) transfers may be
    in flight at once; submitting a third serializes behind the
    earliest-free lane. ``submit`` returns the completion time; the
    queue never blocks by itself — callers that need a transfer's
    result compare ``ready`` against *now* and account the stall.

    A thin facade over ``TransferEngine`` (the general copy-engine
    model the decode overlap pipeline shares): all demotion traffic
    rides the same-priority prefetch class, so the lane schedule is the
    classic double-buffered queue's — earliest-free lane,
    ``start = max(now, lane_free)``.
    """

    def submit(self, now: float, duration: float, **info) -> float:  # type: ignore[override]
        """Schedule a transfer of ``duration`` seconds starting at the
        earliest free lane (>= now). Returns its completion time."""
        kind = info.pop("kind", "swap")
        key = info.pop("key", None)
        t = TransferEngine.submit(self, now, duration, key=key, kind=kind,
                                  **info)
        return t.done

    def drain(self, now: float) -> List[Transfer]:
        """Retire (and return) every transfer complete by ``now``."""
        return self.advance(now)


class TieredMemoryManager:
    """Owns the tier budgets and every inter-tier byte movement.

    Wiring: construct with the engine's ``CostModel`` (tier timing) and
    optionally its ``TraceRecorder`` (demote/promote events); then
    ``OffloadEngine.attach_tiers`` registers every expert master and
    points the per-layer ``ExpertCache``s here. The serving layer calls
    ``park_kv``/``resume_kv`` around preemption and
    ``note_block_claims`` after growing block tables.

    Simulated-clock contract: the engine calls ``drain_stall()`` once
    per step (adding demand stalls to its clock) and then
    ``advance(sim_time)``; park/resume between steps use the last
    advanced time. Everything is deterministic — no wall clock.
    """

    def __init__(self, cost, *, hbm_bytes: int,
                 host_bytes: Optional[int] = None,
                 disk_bytes: Optional[int] = None,
                 lanes: int = 2, trace=None):
        self.cost = cost
        self.trace = trace
        self.hbm_bytes = int(hbm_bytes)
        self.host_bytes = None if host_bytes is None else int(host_bytes)
        self.disk_bytes = None if disk_bytes is None else int(disk_bytes)
        self.queue = SwapQueue(lanes)
        self.now = 0.0
        self._stall = 0.0
        self.stall_s = 0.0               # cumulative (reported in stats)
        # HBM plan (set by the owner once slots/pool are allocated)
        self.hbm_expert_bytes = 0
        self.hbm_kv_bytes = 0
        # expert masters: tier + bytes + recency (for host->disk aging)
        self._expert_tier: Dict[Key, str] = {}
        self._expert_bytes: Dict[Key, int] = {}
        self._expert_last_use: Dict[Key, int] = {}
        self._use_clock = 0
        self.host_used = 0
        self.disk_used = 0
        # parked KV of preempted requests: rid -> entry
        self._parked: Dict[int, dict] = {}
        # traffic counters: (kind, src, dst) -> [count, bytes]
        self._traffic: Dict[Tuple[str, str, str], List[int]] = {}
        self.kv_parks = 0
        self.kv_resumes = 0
        self.expert_disk_fetches = 0

    # -------------------------------------------------------- plumbing
    def set_hbm_plan(self, expert_bytes: int, kv_bytes: int) -> None:
        """Record how the owner actually split the HBM budget (slot
        buffers + KV pool), for ``stats()`` and the budget-sum tests."""
        self.hbm_expert_bytes = int(expert_bytes)
        self.hbm_kv_bytes = int(kv_bytes)

    def advance(self, now: float) -> None:
        """Move the simulated clock forward; completed transfers retire."""
        self.now = max(self.now, now)
        self.queue.drain(self.now)

    def drain_stall(self) -> float:
        """Demand stalls accrued since the last call (seconds). The
        engine adds this to its simulated clock once per step."""
        s, self._stall = self._stall, 0.0
        return s

    def _add_stall(self, s: float) -> None:
        if s > 0:
            self._stall += s
            self.stall_s += s

    def _count(self, kind: str, src: str, dst: str, nbytes: int) -> None:
        c = self._traffic.setdefault((kind, src, dst), [0, 0])
        c[0] += 1
        c[1] += int(nbytes)

    def _event(self, kind: str, event: str, src: str, dst: str,
               nbytes: int, key=()) -> None:
        if self.trace is not None:
            self.trace.record_tier(kind=kind, event=event, src=src,
                                   dst=dst, nbytes=int(nbytes),
                                   key=tuple(key), sim_time=self.now)

    # ---------------------------------------------------- expert masters
    def register_expert(self, key: Key, nbytes: int) -> None:
        """Place an expert's master copy: host until the host budget is
        exhausted, overflow straight to disk (cold-start placement; use
        recency moves it afterwards)."""
        assert key not in self._expert_tier
        nbytes = int(nbytes)
        self._expert_bytes[key] = nbytes
        if self.host_bytes is not None and \
                self.host_used + nbytes > self.host_bytes:
            self._expert_tier[key] = "disk"
            self.disk_used += nbytes
        else:
            self._expert_tier[key] = "host"
            self.host_used += nbytes

    def expert_tier(self, key: Key) -> str:
        return self._expert_tier[key]

    def fetch_expert(self, key: Key, *, demand: bool = True) -> str:
        """An ``ExpertCache`` install of ``key`` — the promotion path.
        Returns the tier the bytes came from. A demand fetch of a
        disk-resident expert stalls for the disk->host hop (the
        host->hbm hop is already priced per miss by ``token_latency``);
        a prefetch hides that hop in the swap queue instead. Either way
        the master is promoted toward host (if room can be made) so
        repeated use stops paying disk latency.
        """
        self._use_clock += 1
        self._expert_last_use[key] = self._use_clock
        tier = self._expert_tier[key]
        nb = self._expert_bytes[key]
        self._count("expert", tier, "hbm", nb)
        if tier == "disk":
            self.expert_disk_fetches += 1
            extra = self.cost.expert_fetch_extra_time("disk")
            if demand:
                self._add_stall(extra)
            else:
                self.queue.submit(self.now, extra, kind="expert", key=key)
            self._event("expert", "promote", "disk", "hbm", nb, key)
            self._promote_master(key)
        return tier

    def expert_evicted(self, key: Key) -> None:
        """The cache policy's victim left HBM. Weights are clean (the
        master survives below), so this is a free drop — counted, not
        timed."""
        self._count("expert", "hbm", self._expert_tier[key],
                    self._expert_bytes[key])

    def _promote_master(self, key: Key) -> None:
        """Move a disk master to host if room can be made by demoting a
        strictly colder expert; otherwise it stays on disk (no thrash)."""
        nb = self._expert_bytes[key]
        if not self._make_host_room(nb, exclude={key}):
            return
        self._expert_tier[key] = "host"
        self.disk_used -= nb
        self.host_used += nb

    def _make_host_room(self, nbytes: int, exclude=frozenset()) -> bool:
        """Free host bytes by demoting cold expert masters (then, as a
        last resort, the oldest parked KV) to disk through the swap
        queue. Returns False if the budget still cannot fit ``nbytes``
        — the caller then places its payload on disk directly."""
        if self.host_bytes is None:
            return True
        while self.host_used + nbytes > self.host_bytes:
            cands = [k for k, t in self._expert_tier.items()
                     if t == "host" and k not in exclude]
            if cands:
                victim = min(cands,
                             key=lambda k: (self._expert_last_use.get(k, 0),
                                            k))
                vb = self._expert_bytes[victim]
                self._expert_tier[victim] = "disk"
                self.host_used -= vb
                self.disk_used += vb
                self.queue.submit(
                    self.now, self.cost.tier_transfer_time(vb, "host", "disk"),
                    kind="expert", key=victim)
                self._count("expert", "host", "disk", vb)
                self._event("expert", "demote", "host", "disk", vb, victim)
                continue
            parked = [r for r, e in self._parked.items()
                      if e["tier"] == "host"]
            if not parked:
                return False
            rid = min(parked, key=lambda r: self._parked[r]["parked_at"])
            e = self._parked[rid]
            e["tier"] = "disk"
            self.host_used -= e["nbytes"]
            self.disk_used += e["nbytes"]
            e["ready"] = self.queue.submit(
                self.now,
                self.cost.tier_transfer_time(e["nbytes"], "host", "disk"),
                kind="kv", rid=rid, blocks=0)
            self._count("kv", "host", "disk", e["nbytes"])
            self._event("kv", "demote", "host", "disk", e["nbytes"], (rid,))
        return True

    # --------------------------------------------------------- parked KV
    def is_parked(self, rid: int) -> bool:
        return rid in self._parked

    def park_kv(self, rid: int, arrays, nbytes: int, n_blocks: int,
                pos: int, engine_step: int = -1) -> None:
        """Demote a preempted request's KV block contents out of HBM.
        ``arrays`` is the per-layer snapshot (host tensors — the only
        copy); ``n_blocks`` HBM blocks are freed to the pool but remain
        IN FLIGHT until the demote transfer completes
        (``kv_inflight_blocks``/``note_block_claims`` make a step that
        reuses them too early pay the wait)."""
        assert rid not in self._parked
        nbytes = int(nbytes)
        tier = "host" if self._make_host_room(nbytes) else "disk"
        if tier == "host":
            self.host_used += nbytes
        else:
            self.disk_used += nbytes
        ready = self.queue.submit(
            self.now, self.cost.tier_transfer_time(nbytes, "hbm", tier),
            kind="kv", rid=rid, blocks=int(n_blocks))
        self._parked[rid] = {
            "arrays": arrays, "nbytes": nbytes, "blocks": int(n_blocks),
            "pos": int(pos), "tier": tier, "ready": ready,
            "parked_at": self._use_clock,
        }
        self.kv_parks += 1
        self._count("kv", "hbm", tier, nbytes)
        self._event("kv", "demote", "hbm", tier, nbytes, (rid,))

    def resume_kv(self, rid: int):
        """Promote a parked request's KV back into HBM blocks. Returns
        ``(arrays, pos)``; the promote transfer (chained behind the
        still-in-flight demote, if any) stalls the step that needs it —
        accrued here, drained by the engine's next clock update."""
        e = self._parked.pop(rid)
        nbytes, tier = e["nbytes"], e["tier"]
        start = max(self.now, e["ready"])
        ready = self.queue.submit(
            start, self.cost.tier_transfer_time(nbytes, tier, "hbm"),
            kind="kv", rid=rid, blocks=0)
        self._add_stall(ready - self.now)
        if tier == "host":
            self.host_used -= nbytes
        else:
            self.disk_used -= nbytes
        self.kv_resumes += 1
        self._count("kv", tier, "hbm", nbytes)
        self._event("kv", "promote", tier, "hbm", nbytes, (rid,))
        return e["arrays"], e["pos"]

    def drop_kv(self, rid: int) -> None:
        """Discard parked KV (request cancelled/expired while queued)."""
        e = self._parked.pop(rid)
        if e["tier"] == "host":
            self.host_used -= e["nbytes"]
        else:
            self.disk_used -= e["nbytes"]

    def parked_kv_bytes(self) -> int:
        return sum(e["nbytes"] for e in self._parked.values())

    # ------------------------------------------- in-flight demotion gate
    def kv_inflight_blocks(self, now: Optional[float] = None) -> int:
        """HBM blocks whose park demotion has not completed by ``now``
        — freed to the allocator but not yet safe to refill. Admission
        subtracts these from the free count (the watermark check
        consults the arbiter)."""
        t = self.now if now is None else now
        return sum(r.info.get("blocks", 0)
                   for r in self.queue.pending(t, kind="kv"))

    def note_block_claims(self, free_blocks_now: int,
                          now: Optional[float] = None) -> float:
        """Called after block-table growth: if the pool now holds fewer
        free blocks than are still being copied out, the step claimed
        in-flight blocks and must wait for enough demotes to land.
        Returns the stall (also accrued for the engine clock). A step
        that never dips into in-flight blocks pays nothing — it does
        not block on a demotion it doesn't need."""
        t = self.now if now is None else now
        deficit = self.kv_inflight_blocks(t) - max(free_blocks_now, 0)
        if deficit <= 0:
            return 0.0
        until = t
        for r in sorted(self.queue.pending(t, kind="kv"),
                        key=lambda r: r.done):
            if deficit <= 0:
                break
            if r.info.get("blocks", 0) > 0:
                until = max(until, r.done)
                deficit -= r.info["blocks"]
        self._add_stall(until - t)
        return until - t

    # ------------------------------------------------------------ stats
    def expert_bytes_by_tier(self) -> Dict[str, int]:
        out = {"host": 0, "disk": 0}
        for k, t in self._expert_tier.items():
            out[t] += self._expert_bytes[k]
        return out

    def stats(self) -> Dict[str, float]:
        """Per-tier occupancy and traffic, flattened for the serving
        ``stats()`` dict (keys prefixed ``tier_``)."""
        eb = self.expert_bytes_by_tier()
        s = {
            "tier_hbm_budget_bytes": self.hbm_bytes,
            "tier_hbm_expert_bytes": self.hbm_expert_bytes,
            "tier_hbm_kv_bytes": self.hbm_kv_bytes,
            "tier_host_budget_bytes": (-1 if self.host_bytes is None
                                       else self.host_bytes),
            "tier_host_used_bytes": self.host_used,
            "tier_disk_used_bytes": self.disk_used,
            "tier_host_expert_bytes": eb["host"],
            "tier_disk_expert_bytes": eb["disk"],
            "tier_parked_kv_bytes": self.parked_kv_bytes(),
            "tier_parked_requests": len(self._parked),
            "tier_kv_parks": self.kv_parks,
            "tier_kv_resumes": self.kv_resumes,
            "tier_expert_disk_fetches": self.expert_disk_fetches,
            "tier_stall_s": self.stall_s,
            "tier_swaps_submitted": self.queue.submitted,
        }
        for (kind, src, dst), (n, b) in sorted(self._traffic.items()):
            s[f"tier_tx_{kind}_{src}_{dst}_n"] = n
            s[f"tier_tx_{kind}_{src}_{dst}_bytes"] = b
        return s
