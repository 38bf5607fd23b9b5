"""Device-tier expert cache: fixed slot buffers + a pluggable policy
(port of ``repro.core.expert_cache``).

One stacked device buffer per weight matrix (``[n_slots, d, ff]`` etc.),
a host-side slot map, and installs that are a real host->device copy of
the store's pinned masters as they are stored (``ExpertStore.payload``),
where the JAX package updated ``buf.at[slot].set``: fp32 masters are
copied into the slot; int8 masters and their scale rows are copied into
int8 / fp32 staging buffers on the device, and the slot is written there
by one fp32 multiply, ``float(q) * scale`` — the bits of the host
dequant (``ExpertStore.fetch``). So the bytes moved are the bytes
``bytes_transferred`` counts. All decisions (hit/miss/evict) happen on
the host, as in the reference.

Streams. Without a ``copy_stream`` (the CPU, or ``overlap=False``) an
install's copies and multiply are queued on the current stream ahead of
the kernels that read the slot. With one (``overlap=True`` on a card:
the engine's copy stream) every install runs there, beside compute,
under two events a slot: *ready*, recorded after the slot's last write,
which the compute stream waits on before ``ops.moe_ffn`` reads the slot
(``reading``), and *last reader*, recorded after each such read, which
the copy stream waits on before it overwrites the slot. The int8
staging pair is written and read on the copy stream only, so stream
order protects it.

Copy order. ``prefetch(defer=True)`` makes every decision at once (the
slot, the victim, the counters, the tier's promotion) but holds the
copies back until ``issue_prefetches``, so the engine can queue a
layer's speculative copies behind the previous layer's demand copies
(ROADMAP.md C4) without moving any decision the trace records.

The expert FFN reads resident experts IN PLACE through ``slots_of``
(``ops.moe_ffn`` takes the slot buffers plus slot indices); the JAX
package's ``gather`` copy of U experts per chunk is gone.

With a ``TieredMemoryManager`` attached (``tiers``, set by
``OffloadEngine.attach_tiers``) every install is also a promotion the
arbiter prices and files: the victim's eviction, the tier the master
was served from (``last_miss_tiers``), a disk stall for a demand miss.
The bytes still come from the store's pinned masters; the disk tier is
simulated.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.cache_policies import CachePolicy
from repro_torch.core.expert_store import ExpertStore
from repro_torch.core.faults import FetchOutcome


class ExpertCache:
    """Cache for ONE MoE layer's experts.

    Parameters
    ----------
    layer : which MoE layer this cache serves (keys the store).
    n_slots : device slots; must equal ``policy.capacity``.
    policy : eviction policy (see ``repro_torch.core.cache_policies``).
    store : host-tier master copies the misses stream from.
    shapes : per-weight-matrix shapes, e.g. ``{"w1": (d, ff), ...}``.
    dtype, device : slot buffer dtype (fp32) and device.
    staging : dict that holds the int8 installs' device staging buffers,
        one (int8 matrix, fp32 scale row) pair per matrix name, made at
        first use. Pass one dict to every layer's cache to share them.
    copy_stream : CUDA stream the installs run on (see the module
        docstring); None queues them on the current stream.

    Counters (cumulative): ``hits``/``misses`` demand accesses,
    ``prefetches`` speculative installs actually transferred,
    ``bytes_transferred`` real store bytes moved host→device.
    ``last_miss_tiers`` holds the serving tier of each miss of the most
    recent ``access`` call, aligned with its returned miss list (the
    engine copies it into the step trace).
    """

    def __init__(self, layer: int, n_slots: int, policy: CachePolicy,
                 store: ExpertStore, shapes: Dict[str, tuple],
                 dtype=torch.float32, device="cuda", faults=None,
                 staging: Optional[dict] = None, copy_stream=None):
        assert policy.capacity == n_slots
        self.layer = layer
        self.n_slots = n_slots
        self.policy = policy
        self.store = store
        self.tiers = None   # a TieredMemoryManager, set by attach_tiers
        self.faults = faults  # Optional[FaultInjector], shared stack-wide
        self.buffers = {k: torch.zeros((n_slots, *s), dtype=dtype,
                                       device=device)
                        for k, s in shapes.items()}
        self.staging = staging if staging is not None else {}
        self.copy_stream = copy_stream
        if copy_stream is not None:
            # the zero fill above is queued on the current stream; a
            # slot freed while the copy stream may still write it is not
            # reused before that work is done
            copy_stream.wait_stream(torch.cuda.current_stream(device))
            for b in self.buffers.values():
                b.record_stream(copy_stream)
            self._ready = [torch.cuda.Event() for _ in range(n_slots)]
            self._last_read = [torch.cuda.Event() for _ in range(n_slots)]
        self.slot_of: Dict[int, int] = {}
        self._free: List[int] = list(range(n_slots))
        # prefetch copies decided but not yet queued: (eid, slot, outcome)
        self._held: List[Tuple[int, int, Optional[FetchOutcome]]] = []
        # counters
        self.hits = 0
        self.misses = 0
        self.prefetches = 0
        self.bytes_transferred = 0
        self.last_miss_tiers: Tuple[str, ...] = ()
        # fault-injection counters / last-call fault state
        self.fetch_failures = 0       # demand fetches abandoned (degraded)
        self.corrupt_refetches = 0    # checksum-mismatch redeliveries
        self.last_failed: Tuple[int, ...] = ()
        self.last_prefetch_failed: Tuple[int, ...] = ()
        self.last_prefetch_outcomes: Dict[int, FetchOutcome] = {}

    # ------------------------------------------------------------------
    def cached_ids(self) -> Tuple[int, ...]:
        """Resident expert ids, sorted (the trace's cache snapshot)."""
        return tuple(sorted(self.slot_of))

    def expert_tier(self, eid: int) -> str:
        """Tier the master copy of ``eid`` would be served from."""
        if self.tiers is not None:
            return self.tiers.expert_tier((self.layer, eid))
        return "host"

    def plan_fetches(self, eids: Sequence[int]) -> Dict[int, FetchOutcome]:
        """Pre-decide the fate of each would-be demand fetch among
        ``eids`` (cached ids are hits — no fetch event is consumed).
        The caller learns the degraded set BEFORE compute and hands the
        same outcomes back to ``access`` (and to the transfer engine),
        so randomness is consumed exactly once per fetch."""
        if self.faults is None or self.faults.plan.is_null:
            return {}
        out = {}
        for eid in eids:
            if eid not in self.slot_of:
                out[eid] = self.faults.fetch_plan(
                    (self.layer, eid), tier=self.expert_tier(eid))
        return out

    def _install(self, eid: int, pinned: frozenset = frozenset(), *,
                 demand: bool = True,
                 outcome: Optional[FetchOutcome] = None,
                 hold: bool = False) -> Tuple[int, Optional[int], str]:
        """Fetch eid from the store into a slot. Returns
        (slot, evicted, tier served from). A caller-supplied ``outcome``
        with corrupt deliveries exercises the REAL checksum path: the
        payload is actually corrupted, the mismatch detected, and the
        fetch redelivered. ``hold``: decide now, queue the copies at the
        next ``issue_prefetches``."""
        evicted = None
        if self._free:
            slot = self._free.pop()
        else:
            victim = self.policy.choose_victim(pinned)
            slot = self.slot_of.pop(victim)
            self.policy.remove(victim)
            evicted = victim
            if self.tiers is not None:
                self.tiers.expert_evicted((self.layer, victim))
        tier = "host"
        if self.tiers is not None:
            tier = self.tiers.fetch_expert((self.layer, eid), demand=demand)
        if hold:
            self._held.append((eid, slot, outcome))
        else:
            with self._writing(slot):
                self._copy_in(eid, slot, outcome)
        self.slot_of[eid] = slot
        self.policy.on_insert(eid)
        self.bytes_transferred += self.store.expert_nbytes((self.layer, eid))
        return slot, evicted, tier

    @contextlib.contextmanager
    def _writing(self, slot: int):
        """Run the body's writes of ``slot`` on the copy stream, after the
        slot's last reader and before its ready event."""
        if self.copy_stream is None:
            yield
            return
        with torch.cuda.stream(self.copy_stream):
            self.copy_stream.wait_event(self._last_read[slot])
            yield
            self._ready[slot].record(self.copy_stream)

    @contextlib.contextmanager
    def reading(self, slots: Sequence[int]):
        """Wrap a kernel that reads ``slots`` on the current stream: it
        waits until their installs have landed, and later installs into
        them wait until it is done."""
        if self.copy_stream is None:
            yield
            return
        stream = torch.cuda.current_stream(self.copy_stream.device)
        for s in slots:
            stream.wait_event(self._ready[s])
        yield
        for s in slots:
            self._last_read[s].record(stream)

    def _copy_in(self, eid: int, slot: int,
                 outcome: Optional[FetchOutcome]) -> None:
        """Queue the copies (and int8 dequant) of expert ``eid`` into
        ``slot`` on the current stream."""
        key = (self.layer, eid)
        if outcome is not None and outcome.corrupt_deliveries and \
                self.faults is not None:
            # the host path: corrupt the dequantized fp32 payload, verify,
            # refetch; a corruption that slips through (crc collision) is
            # installed as delivered
            w = self.store.fetch(key)
            for _ in range(outcome.corrupt_deliveries):
                bad = self.faults.corrupt_payload(w)
                if self.store.verify(key, bad):
                    w = bad
                    continue
                self.corrupt_refetches += 1
                w = self.store.fetch(key)
            for k, v in w.items():
                src = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                    np.asarray(v))
                self.buffers[k][slot].copy_(src, non_blocking=True)
        else:
            for k, (v, scale) in self.store.payload(key).items():
                dst = self.buffers[k][slot]
                if scale is None:
                    dst.copy_(v, non_blocking=True)
                    continue
                # One staging pair per matrix name serves every install
                # of every layer: this copy, the multiply that reads it
                # and the next install's copy are queued on one stream
                # (the copy stream, where there is one, which then also
                # owns the pair's memory), so none overwrites a buffer
                # still being read.
                if k not in self.staging:
                    self.staging[k] = (
                        torch.empty(v.shape, dtype=v.dtype, device=dst.device),
                        torch.empty(scale.shape, dtype=scale.dtype,
                                    device=dst.device))
                q_dev, s_dev = self.staging[k]
                q_dev.copy_(v, non_blocking=True)
                s_dev.copy_(scale, non_blocking=True)
                torch.mul(q_dev, s_dev, out=dst)   # float(q) * s, in fp32

    def access(self, eids: Sequence[int],
               outcomes: Optional[Dict[int, FetchOutcome]] = None
               ) -> Tuple[List[int], List[int], List[int]]:
        """Demand access for this token: returns (hits, misses, evicted).

        All of ``eids`` are pinned while installing so an expert needed
        by the current token can never evict another one of them; the
        caller chunks to ≤ capacity if the working set exceeds it.
        ``last_miss_tiers`` is left aligned with the returned misses.

        ``outcomes`` (from ``plan_fetches``) carries pre-planned fault
        fates: a miss whose outcome is abandoned is NOT installed — it
        still counts as a miss (the attempts were made) and lands in
        ``last_failed``; the engine degrades around it.
        """
        assert len(set(eids)) <= self.n_slots, "working set exceeds cache"
        pinned = frozenset(eids)
        hits, misses, evicted = [], [], []
        miss_tiers: List[str] = []
        failed: List[int] = []
        for eid in eids:
            if eid in self.slot_of:
                hits.append(eid)
                self.policy.on_access(eid)
            else:
                misses.append(eid)
                out = outcomes.get(eid) if outcomes else None
                if out is not None and not out.success:
                    failed.append(eid)
                    miss_tiers.append(self.expert_tier(eid))
                    continue
                _, ev, tier = self._install(eid, pinned, outcome=out)
                miss_tiers.append(tier)
                if ev is not None:
                    evicted.append(ev)
        self.hits += len(hits)
        self.misses += len(misses)
        self.fetch_failures += len(failed)
        self.last_miss_tiers = tuple(miss_tiers)
        self.last_failed = tuple(failed)
        self.policy.tick()
        return hits, misses, evicted

    def prefetch(self, eids: Sequence[int], *,
                 defer: bool = False) -> List[int]:
        """Speculatively admit eids (no demand stall). Returns the ids
        actually transferred (already-cached ones are free). Under
        fault injection each transfer's fate is planned here
        (``last_prefetch_outcomes`` aligns with the returned list);
        abandoned prefetches are not installed and land in
        ``last_prefetch_failed`` — harmless, the demand path refetches.
        ``defer``: every decision is made here, the copies are queued by
        ``issue_prefetches``, which must run before the slots are read.
        """
        moved = []
        fates: Dict[int, FetchOutcome] = self.plan_fetches(eids)
        failed: List[int] = []
        for eid in eids:
            if eid in self.slot_of:
                self.policy.on_access(eid)
                continue
            out = fates.get(eid)
            if out is not None and not out.success:
                failed.append(eid)
                continue
            self._install(eid, demand=False, outcome=out, hold=defer)
            moved.append(eid)
        self.prefetches += len(moved)
        self.last_prefetch_failed = tuple(failed)
        self.last_prefetch_outcomes = {e: fates[e] for e in moved
                                       if e in fates}
        return moved

    def issue_prefetches(self) -> None:
        """Queue the copies that ``prefetch(defer=True)`` held back, in
        the order they were decided."""
        held, self._held = self._held, []
        for eid, slot, outcome in held:
            with self._writing(slot):
                self._copy_in(eid, slot, outcome)

    def slots_of(self, eids: Sequence[int]) -> List[int]:
        """Slot index of each cached expert in ``eids`` (the rows of
        ``buffers`` the expert FFN reads in place)."""
        return [self.slot_of[e] for e in eids]

    def device_nbytes(self) -> int:
        """Device bytes this cache's slot buffers pin (static — slots
        are allocated up front, not per resident expert)."""
        return sum(v.numel() * v.element_size()
                   for v in self.buffers.values())
