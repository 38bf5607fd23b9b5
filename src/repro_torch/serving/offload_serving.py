"""Offload-mode serving — the paper's deployment scenario as a
first-class server object, now with continuous batching.

``ContinuousOffloadServer`` schedules many requests over ONE
``OffloadEngine`` and its shared per-layer expert caches: a request
queue, slot-based admission at token boundaries (a joining request's
prompt tokens stream through the same batched decode other requests are
mid-generation in), per-request EOS/max_new retirement, and per-request
stats sliced out of the shared ``TraceRecorder``. This is where the
paper's batch-1 analysis changes character: co-scheduled tokens demand
the UNION of their expert sets (misses amortize) while competing for
the same cache slots (per-request hit rates fall) — see
``CostModel.expected_union_experts`` and docs/serving.md.

KV state is PAGED by default (``kv_layout="paged"``): instead of a
dense per-slot ``[max_batch, cache_len]`` block, K/V rows live in a
shared pool of fixed-size blocks (``repro_torch.core.paged_kv.PagedKVCache``)
addressed through per-request block tables, so slot count and max
sequence length decouple — one slot may hold a sequence far longer
than ``cache_len`` while its neighbours hold short ones. Admission is
page-aware: a request joins when the pool can hold its known tokens
(minus a configurable watermark reserved for the decode growth of
already-running requests), and the scheduler may OVERCOMMIT — if the
pool exhausts mid-decode, the youngest request is preempted back to
the queue (its KV blocks freed; its tokens, already sampled, replay as
prefill on re-admission, so generated text is unaffected). Both
layouts — and ``OffloadEngine.generate`` — produce identical tokens,
traces and simulated clocks at temperature 0 (test-enforced on the CPU;
on the card the paged kernel agrees with the dense path within fp32
rounding, and ``chip_smoke.py`` checks the tokens).

With ``hbm_budget_bytes=`` the server sizes itself from ONE device
byte budget instead of separate ``cache_slots``/``kv_num_blocks``
knobs: ``repro_torch.core.memory_tiers.plan_hbm_split`` divides it
between expert slots and the KV pool, and a ``TieredMemoryManager``
arbitrates the HBM/host/disk hierarchy (expert masters spill to a
simulated SSD under host pressure; demand disk misses stall the clock,
prefetches hide the hop). Preemption then PARKS the victim's KV block
contents in host memory and the request RESUMES from them at its parked
position on re-admission — the same tokens as replay-as-prefill in
fewer steps under overcommit (``resume_from_host=False`` restores the
replay behaviour). On a card the park is a gather on the compute stream
and a copy to pinned host memory on the engine's copy stream (the
compute stream without one), the resume a copy back on that stream and
a scatter on the compute stream after it (``PagedKVCache.park_blocks``
/ ``restore_blocks``): no host wait, and the simulated clock keeps
pricing both moves as the reference does.

Long prompts need not stream one token per step: with
``prefill_chunk > 1`` (paged layout only) a catching-up request pushes
a CHUNK of its known tokens per step as *virtual rows* — extra batch
rows at consecutive positions sharing the request's block-table row —
through the same batched paged decode. Every row's K/V is scattered
before the attention kernel reads the pool, and keys are masked to
``idx <= pos``, so a chunk computes what the one-token-per-step replay
computes (token-for-token equal, test-enforced). A per-step token
budget (``step_tokens``) interleaves those chunks with decode rows:
every active request advances at least one token per step, so a long
prefill can no longer starve co-scheduled decodes while it catches up.

WHO advances, joins, and is preempted is delegated to a pluggable
``Scheduler`` (``repro_torch.serving.scheduler``): ``fifo`` (default,
preserves the original hardcoded behavior exactly), ``sjf``
(shortest-remaining-job), and ``priority`` (per-tenant fairness scored
from the per-request trace slices the server accumulates in
``tenant_service``). Scheduling only reorders WHEN tokens are
computed — per-request outputs are byte-identical under every
scheduler at temperature 0 (test-enforced).

``OffloadServer`` keeps the original one-request-at-a-time API and is a
thin wrapper over a ``max_batch=1`` continuous server; batch-of-1
continuous serving reproduces ``OffloadEngine.generate`` token for
token at temperature 0 (test-enforced, stats included). Sampled
decoding (T>0) draws from per-(seed, token) generators
(``sampler.request_generator``), the same draws ``OffloadEngine.generate``
makes: outputs are reproducible across reruns and independent of batch
composition and admission order. They agree with the JAX package only
in distribution (threefry keys cannot be reproduced in torch).
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.costmodel import HardwareProfile, ModelBytes
from repro_torch.core.memory_tiers import TieredMemoryManager, plan_hbm_split
from repro_torch.core.offload_engine import OffloadEngine
from repro_torch.core.paged_kv import PagedKVCache
from repro_torch.core.trace import TraceRecorder
from repro_torch.serving.request import Request
from repro_torch.serving.sampler import request_generator, sample_token
from repro_torch.serving.scheduler import Scheduler, make_scheduler


def _planned_expert_bytes(cfg) -> int:
    """HBM bytes ONE expert-cache slot pins in one layer: the fp32
    device buffers (w1/w3/w2). Independent of host-store quantization —
    int8 masters are dequantized on the card, the slot is always fp32."""
    return 3 * cfg.d_model * cfg.expert_d_ff * 4


class AdmissionRejected(RuntimeError):
    """``submit`` refused a request under load shedding. ``reason`` is
    the typed cause (currently only ``"queue_full"``); the request was
    never assigned an rid and holds no server state."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"admission rejected ({reason}): {detail}"
                         if detail else f"admission rejected ({reason})")
        self.reason = reason


class ContinuousOffloadServer:
    """Continuous-batching scheduler over a shared expert cache."""

    def __init__(self, params, cfg, *, cache_slots=None, max_batch: int = 4,
                 cache_len: int = 256, policy: str = "lru",
                 policy_kw: Optional[dict] = None, learned_model=None,
                 prefetch: Optional[str] = None, quant: str = "none",
                 hw: Optional[HardwareProfile] = None, overlap: bool = False,
                 eos_id: Optional[int] = None, temperature: float = 0.0,
                 top_p: float = 1.0, seed: int = 0,
                 kv_layout: str = "paged", kv_block_size: int = 16,
                 kv_num_blocks: Optional[int] = None,
                 kv_watermark: float = 0.0,
                 scheduler="fifo", prefill_chunk: int = 1,
                 step_tokens: Optional[int] = None,
                 hbm_budget_bytes: Optional[int] = None,
                 tier_expert_frac: float = 0.5,
                 host_budget_bytes: Optional[int] = None,
                 resume_from_host: bool = True,
                 tier_lanes: int = 2,
                 faults=None,  # FaultPlan | FaultInjector | None
                 request_timeout_steps: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 shed_wait_steps: Optional[int] = None,
                 device="cuda"):
        # knob validation up front: a clear ValueError at construction
        # beats a deep stack trace mid-serve
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if cache_len < 1:
            raise ValueError(f"cache_len must be >= 1, got {cache_len}")
        if kv_layout not in ("paged", "dense"):
            raise ValueError(f"unknown kv_layout={kv_layout!r}: "
                             f"expected 'paged' or 'dense'")
        if not 0.0 <= kv_watermark < 1.0:
            raise ValueError(
                f"kv_watermark must be in [0, 1), got {kv_watermark}")
        if prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if not 0.0 <= tier_expert_frac <= 1.0:
            raise ValueError(f"tier_expert_frac must be in [0, 1], "
                             f"got {tier_expert_frac}")
        if hbm_budget_bytes is not None and hbm_budget_bytes <= 0:
            raise ValueError(f"hbm_budget_bytes must be positive, "
                             f"got {hbm_budget_bytes}")
        if host_budget_bytes is not None and host_budget_bytes <= 0:
            raise ValueError(f"host_budget_bytes must be positive, "
                             f"got {host_budget_bytes}")
        for name, v in (("request_timeout_steps", request_timeout_steps),
                        ("max_queue", max_queue),
                        ("shed_wait_steps", shed_wait_steps)):
            if v is not None and v < 1:
                raise ValueError(f"{name} must be >= 1 (or None), got {v}")
        if prefill_chunk > 1 and kv_layout != "paged":
            raise ValueError(
                "chunked prefill needs paged KV (virtual rows share a "
                "block-table row; dense KV is addressed by batch row)")
        self.cfg = cfg
        # ---- tiered-memory arbitration (core/memory_tiers.py) --------
        # ``hbm_budget_bytes`` replaces the independent cache_slots /
        # kv_num_blocks sizing with ONE budget the arbiter splits
        # (``tier_expert_frac`` of it funds expert slots, the rest the
        # KV pool); preempted requests then park their KV in the host
        # tier and RESUME from it instead of replaying tokens as
        # prefill (``resume_from_host=False`` keeps iso-memory replay
        # for comparison).
        self.resume_from_host = resume_from_host
        if hbm_budget_bytes is not None:
            if kv_layout != "paged":
                raise ValueError("the HBM arbiter needs paged KV")
            if cache_slots is not None or kv_num_blocks is not None:
                raise ValueError(
                    "hbm_budget_bytes replaces cache_slots/kv_num_blocks")
            mb = ModelBytes.from_config(cfg)
            cache_slots, kv_num_blocks = plan_hbm_split(
                hbm_budget_bytes, num_layers=cfg.num_layers,
                num_experts=cfg.num_experts,
                expert_bytes=_planned_expert_bytes(cfg),
                kv_block_bytes=kv_block_size * mb.kv_bytes_per_token
                * cfg.num_layers,
                expert_frac=tier_expert_frac)
        if cache_slots is None:
            raise ValueError("pass cache_slots or hbm_budget_bytes")
        self.max_batch = max_batch
        self.prefill_chunk = prefill_chunk
        # per-step token budget: every active request is guaranteed one
        # token; the leftover goes to catching-up rows (scheduler order)
        self.step_tokens = step_tokens if step_tokens is not None \
            else max_batch * prefill_chunk
        if self.step_tokens < max_batch:
            raise ValueError(
                f"step_tokens must cover one token per slot "
                f"(>= max_batch={max_batch}), got {self.step_tokens}")
        # fixed virtual-row batch width (stable shapes step to step)
        self._step_rows = max_batch if prefill_chunk == 1 \
            else self.step_tokens
        self.scheduler: Scheduler = make_scheduler(scheduler) \
            if isinstance(scheduler, str) else scheduler
        self.scheduler.bind(self)
        self.cache_len = cache_len
        self.eos_id = eos_id
        self.temperature = temperature
        self.top_p = top_p
        self.seed = seed
        self.trace = TraceRecorder()
        self.engine = OffloadEngine(
            params, cfg, cache_slots=cache_slots, policy=policy,
            policy_kw=policy_kw, learned_model=learned_model,
            prefetch=prefetch, quant=quant, hw=hw, overlap=overlap,
            trace=self.trace, faults=faults, device=device)
        self.device = self.engine.device
        self.faults = self.engine.faults  # normalized FaultInjector|None
        self.request_timeout_steps = request_timeout_steps
        self.max_queue = max_queue
        self.shed_wait_steps = shed_wait_steps
        self.kv_layout = kv_layout
        self.kv_block_size = kv_block_size
        self.kv_watermark = kv_watermark
        self.paged: Optional[PagedKVCache] = None
        if kv_layout == "paged":
            # default pool = the dense allocation's token capacity, but
            # shared: any request may span many blocks (kv_num_blocks
            # sets the overcommit headroom explicitly)
            n = kv_num_blocks if kv_num_blocks is not None else \
                -(-max_batch * cache_len // kv_block_size)
            self.paged = PagedKVCache(n, kv_block_size, cfg=cfg,
                                      dtype=torch.float32,
                                      device=self.device)
            self.state = self.paged.state
        else:
            self.state = self.engine.init_state(max_batch, cache_len)
        self.tiers: Optional[TieredMemoryManager] = None
        if hbm_budget_bytes is not None:
            self.tiers = TieredMemoryManager(
                self.engine.cost, hbm_bytes=hbm_budget_bytes,
                host_bytes=host_budget_bytes, lanes=tier_lanes,
                trace=self.trace)
            self._set_hbm_plan()
            self.engine.attach_tiers(self.tiers)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.queue: Deque[Request] = deque()
        self.finished: Dict[int, Request] = {}
        self._logits = None  # [B, V] of the last step
        self._join_seq = 0
        self.kv_preemptions = 0
        self.kv_deferred_admissions = 0
        self.step_count = 0            # completed engine steps
        self.tenant_service: Dict[str, int] = {}  # tokens served/tenant
        self.partial_rids: set = set()  # unfinished rids of the last run()
        self.rejected = 0              # AdmissionRejected at submit()
        self._step_times: List[float] = []  # per-step sim seconds

    # ------------------------------------------------------------ admin
    def submit(self, prompt: Sequence[int], *, max_new: int,
               temperature: Optional[float] = None,
               top_p: Optional[float] = None,
               seed: Optional[int] = None,
               priority: int = 0, tenant: Optional[str] = None,
               deadline_steps: Optional[int] = None) -> int:
        """Queue a request; returns its id (the trace prompt_id).

        Rejects (raises ValueError) a request that could NEVER be
        served: longer than the paged pool's total capacity, or than a
        dense slot's ``cache_len``. Requests that fit but find the pool
        busy are NOT rejected — they wait in the queue (and running
        requests may be preempted/requeued to make room) — unless
        ``max_queue`` is configured and full, which raises
        ``AdmissionRejected`` (load shedding at the door).
        ``deadline_steps`` overrides the server's
        ``request_timeout_steps`` for this request."""
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        if max_new < 0:
            raise ValueError(f"max_new must be >= 0, got {max_new}")
        if deadline_steps is not None and deadline_steps < 1:
            raise ValueError(
                f"deadline_steps must be >= 1 (or None), got {deadline_steps}")
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self.rejected += 1
            self.trace.record_fault(
                kind="request", action="shed", key=(),
                sim_time=self.engine.sim_time,
                detail=f"queue_full: {len(self.queue)} >= {self.max_queue}")
            raise AdmissionRejected(
                "queue_full", f"{len(self.queue)} queued >= "
                f"max_queue={self.max_queue}")
        total = len(prompt) + max_new
        if self.kv_layout == "paged":
            if total > self.paged.capacity_tokens:
                raise ValueError(
                    f"request needs {total} KV rows, paged pool holds "
                    f"{self.paged.capacity_tokens} "
                    f"({self.paged.num_blocks} x {self.kv_block_size})")
        elif total > self.cache_len:
            raise ValueError(
                f"request needs {total} KV rows, cache_len={self.cache_len}")
        rid = self.engine.new_prompt(reset_context=False)
        req = Request(prompt=list(prompt), max_new=max_new, rid=rid,
                      temperature=temperature, top_p=top_p, seed=seed,
                      priority=priority, tenant=tenant,
                      submit_step=self.step_count,
                      deadline_steps=deadline_steps)
        self.queue.append(req)
        return rid

    def ensure_cache_len(self, n: int) -> None:
        """Grow the KV allocation so one request of ``n`` rows fits
        (every slot's strip for dense; the shared pool for paged). Only
        legal while no request is admitted (KV contents are per-request
        and masked by position, so an idle reallocation is invisible)."""
        if self.kv_layout == "paged":
            need = self.paged.blocks_for(n)
            if need <= self.paged.num_blocks:
                return
            assert self.num_active == 0, \
                "cannot resize KV with active requests"
            self.cache_len = max(self.cache_len, n)
            self.paged = PagedKVCache(need, self.kv_block_size,
                                      cfg=self.cfg, dtype=torch.float32,
                                      device=self.device)
            self.state = self.paged.state
            if self.tiers is not None:
                self._set_hbm_plan()
            return
        if n <= self.cache_len:
            return
        assert self.num_active == 0, "cannot resize KV with active requests"
        self.cache_len = n
        self.state = self.engine.init_state(self.max_batch, n)

    def _set_hbm_plan(self) -> None:
        """Tell the arbiter how HBM is split: the slot buffers' bytes,
        and the KV pool priced as the plan prices it (the reference's
        accounting: ``ModelBytes`` takes 2 bytes a KV element, the pool
        holds fp32 plus a sink block)."""
        self.tiers.set_hbm_plan(
            sum(c.device_nbytes() for c in self.engine.caches),
            self.engine.cost.kv_block_bytes(self.kv_block_size)
            * self.paged.num_blocks)

    @property
    def num_active(self) -> int:
        return sum(1 for r in self.slots if r is not None)

    @property
    def pending(self) -> int:
        return self.num_active + len(self.queue)

    def _admit(self) -> None:
        """Fill free slots from the queue (a token-boundary join).

        Candidates are tried in ``scheduler.admission_order`` (fifo:
        arrival order). Paged admission is PAGE-AWARE: a candidate
        joins only when the pool can hold its known tokens while
        keeping ``kv_watermark`` of the blocks free for running
        requests' decode growth (an idle server ignores the watermark —
        sole occupancy cannot starve anyone). A blocked candidate
        DEFERS everything behind it (no overtaking past a blocked
        request, whatever the scheduler — big requests cannot be
        starved by a stream of small ones) and is counted in
        ``kv_deferred_admissions``."""
        if not self.queue:
            return
        if self.num_active == 0:
            # idle server: same prefetch state as a fresh generate()
            self.engine.reset_prefetch_context()
        free = [b for b in range(self.max_batch) if self.slots[b] is None]
        for req in self.scheduler.admission_order(self.queue):
            if not free:
                break
            if self.paged is not None and not self._kv_admit(req):
                self.kv_deferred_admissions += 1
                break
            self.queue.remove(req)
            req.slot = free.pop(0)
            req.pos = 0
            req.join_seq = self._join_seq
            self._join_seq += 1
            if req.admit_step < 0:
                req.admit_step = self.step_count
            self.slots[req.slot] = req
            if self.tiers is not None and self.tiers.is_parked(req.rid):
                self._restore_kv(req)

    def _kv_admit(self, req: Request) -> bool:
        """Reserve blocks for a joining request's known tokens.

        With the tier arbiter attached, the watermark check consults
        it: blocks whose park-demotion is still in flight (freed to
        the allocator, bytes still being copied out over the simulated
        clock) do not count as free, so admission cannot claim memory
        that is not actually available yet."""
        need = self.paged.blocks_for(len(req.tokens))
        reserve = int(self.kv_watermark * self.paged.num_blocks)
        free = self.paged.free_blocks
        if self.tiers is not None:
            free -= self.tiers.kv_inflight_blocks(self.engine.sim_time)
        if self.num_active > 0 and need > free - reserve:
            return False
        self.paged.allocate(req.rid)
        if not self.paged.reserve(req.rid, len(req.tokens)):
            self.paged.free_request(req.rid)
            return False
        return True

    def _preempt(self, req: Request) -> None:
        """Evict a running request to the queue front. Without the
        tier arbiter its KV blocks are freed and its tokens (prompt +
        everything already sampled) replay as prefill on re-admission —
        generated text is a pure function of the tokens, so preemption
        costs steps, never output. With the arbiter (and
        ``resume_from_host``), the blocks' CONTENTS are parked in the
        host tier first and the request resumes from them instead of
        replaying — same output (bit-exact KV snapshot), far fewer
        steps."""
        if self.tiers is not None and self.resume_from_host and req.pos > 0:
            self._park_kv(req)
        else:
            req.pos = 0
        self.paged.free_request(req.rid)
        self.slots[req.slot] = None
        req.slot = -1
        req.preemptions += 1
        self.kv_preemptions += 1
        self.queue.appendleft(req)

    def _park_kv(self, req: Request) -> None:
        """Snapshot the blocks covering ``req``'s fed tokens to the
        host tier (``PagedKVCache.park_blocks``, on the engine's copy
        stream). The caller then frees the blocks: they stay accounted
        in flight until the simulated demote transfer completes. The
        park is priced at the unsharded pool's bytes of its blocks
        (``PagedKVCache.block_nbytes``): the snapshot's own bytes without
        a mesh, and under one the same price on every rank, whose
        snapshot holds only its pool's KV heads."""
        blocks = self.paged.tables[req.rid][:self.paged.blocks_for(req.pos)]
        arrays = self.paged.park_blocks(blocks, self.engine.copy_stream)
        nbytes = len(blocks) * self.paged.block_nbytes
        self.tiers.park_kv(req.rid, arrays, nbytes, len(blocks), req.pos,
                           engine_step=self.step_count)

    def _restore_kv(self, req: Request) -> None:
        """Promote a parked request's KV into its freshly reserved
        blocks (possibly different physical ids — contents are
        scattered by the NEW table order) and resume at the parked
        position. The promote stall lands on the engine clock at the
        next step."""
        arrays, pos = self.tiers.resume_kv(req.rid)
        n = len(next(iter(arrays[0].values()))) if arrays else 0
        if n:
            self.paged.restore_blocks(self.paged.tables[req.rid][:n], arrays,
                                      self.engine.copy_stream)
        req.pos = pos

    def _ensure_kv(self, chunks: Optional[Dict[int, int]] = None) -> None:
        """Grow each active request's block table to cover this step's
        chunk (``chunks[rid]`` tokens from ``pos``; default 1); on pool
        exhaustion preempt ``scheduler.choose_victim`` — possibly the
        one asking — and retry. Requests are served in
        ``scheduler.chunk_order`` (fifo: oldest first), so whoever the
        scheduler favors keeps its pages and an overcommitted pool
        converges to sequential service instead of livelocking.
        Preemption frees at least one block per round (every admitted
        request holds blocks for its known tokens), so the retry loop
        terminates."""
        chunks = chunks or {}
        for req in self.scheduler.chunk_order(
                [r for r in self.slots if r is not None]):
            if req.slot < 0:
                continue  # preempted at this boundary already
            while req.slot >= 0 and not self.paged.reserve(
                    req.rid, req.pos + chunks.get(req.rid, 1)):
                active = [r for r in self.slots if r is not None]
                victim = self.scheduler.choose_victim(active)
                # a lone request can always claim the whole pool
                # (submit() rejected anything bigger than it, and a
                # chunk never reaches past the known tokens)
                assert not (victim is req and len(active) == 1), \
                    "single request exceeded pool capacity"
                self._preempt(victim)

    def _retire(self, req: Request) -> None:
        req.done = True
        req.status = "completed"
        req.finish_step = self.step_count
        if self.paged is not None:
            self.paged.free_request(req.rid)
        self.slots[req.slot] = None
        req.slot = -1
        self.finished[req.rid] = req

    def _terminate(self, req: Request, status: str, reason: str) -> None:
        """Terminal exit OTHER than completion: timeout or shed. Frees
        every server resource the request holds (slot, KV blocks,
        parked host snapshot, queue position) so nothing leaks and the
        drain loop always makes progress; the typed reason lands on the
        request and in the trace as a ``FaultEvent``."""
        req.done = True
        req.status = status
        req.shed_reason = reason
        req.finish_step = self.step_count
        if req.slot >= 0:
            if self.paged is not None:
                self.paged.free_request(req.rid)
            self.slots[req.slot] = None
            req.slot = -1
        elif req in self.queue:
            self.queue.remove(req)
        if self.tiers is not None and self.tiers.is_parked(req.rid):
            self.tiers.drop_kv(req.rid)
        self.finished[req.rid] = req
        self.trace.record_fault(kind="request", action=status,
                                key=(req.rid,),
                                sim_time=self.engine.sim_time,
                                detail=reason)

    def _expire_and_shed(self) -> List[int]:
        """Apply per-request deadlines and queue-pressure shedding at
        the step boundary (both off unless configured). Returns the
        rids terminated here."""
        gone: List[int] = []
        if self.request_timeout_steps is None and \
                self.shed_wait_steps is None and \
                not any(r.deadline_steps is not None
                        for r in self.slots if r is not None) and \
                not any(r.deadline_steps is not None for r in self.queue):
            return gone
        live = [r for r in self.slots if r is not None] + list(self.queue)
        for req in live:
            dl = req.deadline_steps if req.deadline_steps is not None \
                else self.request_timeout_steps
            if dl is not None and self.step_count - req.submit_step >= dl:
                self._terminate(req, "timeout", "deadline_steps")
                gone.append(req.rid)
                continue
            if self.shed_wait_steps is not None and req.slot < 0 and \
                    self.step_count - req.submit_step >= self.shed_wait_steps:
                # still queued this long means sustained pool/tier
                # pressure (deferred admission / repeated preemption)
                self._terminate(req, "shed", "queue_pressure")
                gone.append(req.rid)
        return gone

    # ------------------------------------------------------------- step
    def _plan_chunks(self, active: List[Request]) -> Dict[int, int]:
        """Split this step's token budget: every active request gets 1
        (decode rows need exactly one), then the leftover goes to
        catching-up rows in ``scheduler.chunk_order``, each up to
        ``prefill_chunk`` known tokens total."""
        chunks = {r.rid: 1 for r in active}
        left = self.step_tokens - len(active)
        if self.prefill_chunk > 1 and left > 0:
            for r in self.scheduler.chunk_order(active):
                if left <= 0:
                    break
                unfed = len(r.tokens) - r.pos
                extra = min(self.prefill_chunk - 1, unfed - 1, left)
                if extra > 0:
                    chunks[r.rid] += extra
                    left -= extra
        return chunks

    def step(self) -> List[int]:
        """One token-boundary: admit, plan chunk budgets, grow/steal KV
        pages (paged), decode every active slot — ``chunks[rid]``
        virtual rows at consecutive positions when catching up —
        sample/advance, retire. Returns rids retired now (completed,
        timed out, or shed — check ``Request.status``)."""
        expired = self._expire_and_shed()
        self._admit()
        chunks = self._plan_chunks([r for r in self.slots if r is not None])
        if self.paged is not None:
            self._ensure_kv(chunks)
            if self.tiers is not None:
                # growth that claimed blocks whose park-demotion is
                # still copying out must wait for those lanes to land
                self.tiers.note_block_claims(self.paged.free_blocks,
                                             self.engine.sim_time)
        active = [r is not None for r in self.slots]
        if not any(active):
            return expired

        B = self.max_batch
        last_row: Dict[int, int] = {}
        if self.prefill_chunk == 1:
            # original fixed-slot layout: row b IS slot b (required by
            # the dense KV path, which addresses KV by batch row)
            tokens = np.zeros((B, 1), np.int32)
            positions = [0] * B
            prompt_ids = [0] * B
            row_rids: List[Optional[int]] = [None] * B
            row_active = active
            for b, req in enumerate(self.slots):
                if req is None:
                    continue
                tokens[b, 0] = req.tokens[req.pos]
                positions[b] = req.pos
                prompt_ids[b] = req.rid
                row_rids[b] = req.rid
                last_row[req.rid] = b
        else:
            # virtual-row layout: request r contributes chunks[r.rid]
            # rows at consecutive positions sharing its block-table
            # row; pad with inactive sink rows to a fixed width
            toks: List[int] = []
            positions = []
            prompt_ids = []
            row_rids = []
            row_active = []
            for req in self.slots:
                if req is None:
                    continue
                for j in range(chunks[req.rid]):
                    toks.append(req.tokens[req.pos + j])
                    positions.append(req.pos + j)
                    prompt_ids.append(req.rid)
                    row_rids.append(req.rid)
                    row_active.append(True)
                last_row[req.rid] = len(toks) - 1
            while len(toks) < self._step_rows:
                toks.append(0)
                positions.append(0)
                prompt_ids.append(0)
                row_rids.append(None)
                row_active.append(False)
            tokens = np.asarray(toks, np.int32).reshape(-1, 1)

        block_tables = None
        if self.paged is not None:
            block_tables = self.paged.table_array(row_rids)

        t0 = self.engine.sim_time
        logits, self.state = self.engine.decode_tokens(
            self.state, tokens, positions,
            prompt_ids=prompt_ids, active=row_active,
            block_tables=block_tables)
        self._step_times.append(self.engine.sim_time - t0)
        self._logits = logits
        self.step_count += 1

        retired: List[int] = []
        for b in range(B):
            req = self.slots[b]
            if req is None:
                continue
            n = chunks[req.rid]
            req.pos += n
            req.steps_advanced += 1
            if req.tenant is not None:
                self.tenant_service[req.tenant] = \
                    self.tenant_service.get(req.tenant, 0) + n
            if req.pos < len(req.tokens):
                continue  # still streaming known tokens (prefill)
            if req.eos_hit or len(req.out) >= req.max_new:
                # every known token has been fed (matching generate(),
                # which decodes the final sampled token too)
                self._retire(req)
                retired.append(req.rid)
                continue
            req.out.append(self._sample(req, logits[last_row[req.rid]]))
            if self.eos_id is not None and req.out[-1] == self.eos_id:
                req.eos_hit = True
        return expired + retired

    def _sample(self, req: Request, row) -> int:
        temp = self.temperature if req.temperature is None else req.temperature
        if temp <= 0.0:
            return int(torch.argmax(row, dim=-1))
        top_p = self.top_p if req.top_p is None else req.top_p
        seed = self.seed if req.seed is None else req.seed
        gen = request_generator(seed, req.pos, device=row.device)
        return int(sample_token(gen, row[None, :], temperature=temp,
                                top_p=top_p)[0])

    def run(self, *, max_steps: Optional[int] = None) -> Dict[int, List[int]]:
        """Drain the queue; returns {rid: full token sequence}.

        A truncated run (``max_steps``) ALSO returns the partial token
        sequences of in-flight and still-queued requests instead of
        silently dropping them; their rids are flagged in
        ``self.partial_rids`` (empty after a full drain). The server
        keeps their state, so a later ``run()`` resumes exactly where
        the truncation stopped and completes the same sequences."""
        steps = 0
        while self.pending:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        out = {rid: r.tokens for rid, r in self.finished.items()}
        self.partial_rids = set()
        for r in [r for r in self.slots if r is not None] + list(self.queue):
            out[r.rid] = r.tokens
            self.partial_rids.add(r.rid)
        return out

    def result(self, rid: int) -> List[int]:
        return self.finished[rid].tokens

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict[str, float]:
        # serving-mode peak memory prices the KV pool's peak block
        # occupancy alongside the resident experts (the bare engine's
        # kv_tokens=0 default covers only the demo loop)
        kv_tokens = float(self.paged.peak_used * self.kv_block_size) \
            if self.paged is not None else 0.0
        s = self.engine.stats(kv_tokens=kv_tokens)
        s["finished_requests"] = len(self.finished)
        s["queued_requests"] = len(self.queue)
        s["active_requests"] = self.num_active
        s["server_steps"] = self.step_count
        fin = [r for r in self.finished.values()
               if r.status in ("", "completed")]
        s["mean_wait_steps"] = (
            sum(r.wait_steps() for r in fin) / len(fin)) if fin else 0.0
        # --- health / degradation summary (docs/robustness.md) --------
        # every terminal request is completed, timed out, or shed;
        # availability = completed / terminated (1.0 on a healthy server)
        term = list(self.finished.values())
        timeouts = sum(1 for r in term if r.status == "timeout")
        shed = sum(1 for r in term if r.status == "shed")
        s["completed_requests"] = len(fin)
        s["timeout_requests"] = timeouts
        s["shed_requests"] = shed
        s["rejected_requests"] = self.rejected
        denom = max(len(term) + self.rejected, 1)
        s["availability"] = len(fin) / denom
        s["shed_rate"] = (shed + self.rejected) / denom
        s["p99_step_s"] = (float(np.percentile(self._step_times, 99))
                           if self._step_times else 0.0)
        if self.paged is not None:
            blk_bytes = self.engine.cost.kv_block_bytes(self.kv_block_size)
            s["kv_num_blocks"] = self.paged.num_blocks
            s["kv_blocks_in_use"] = self.paged.used_blocks
            s["kv_blocks_peak"] = self.paged.peak_used
            s["kv_preemptions"] = self.kv_preemptions
            s["kv_deferred_admissions"] = self.kv_deferred_admissions
            s["kv_pool_bytes"] = blk_bytes * self.paged.num_blocks
            s["kv_bytes_peak"] = blk_bytes * self.paged.peak_used
        return s

    def request_stats(self, rid: int) -> Dict[str, float]:
        """This request's cache accounting, sliced from the shared trace."""
        return self.trace.request_stats(rid)

    def render_trace(self, layer: int, *, prompt_id: Optional[int] = None,
                     **kw) -> str:
        return self.trace.render_layer(layer, self.cfg.num_experts,
                                       prompt_id=prompt_id, **kw)


class OffloadServer:
    """One-request-at-a-time facade (the paper's setting) over the
    continuous server. API-compatible with the original; greedy output
    is identical, T>0 sampling uses the per-request key scheme (see
    module docstring)."""

    def __init__(self, params, cfg, *, cache_slots: int, policy: str = "lru",
                 policy_kw: Optional[dict] = None, learned_model=None,
                 prefetch: Optional[str] = None, quant: str = "none",
                 hw: Optional[HardwareProfile] = None, overlap: bool = False,
                 cache_len: int = 512, kv_layout: str = "paged",
                 kv_block_size: int = 16, device="cuda"):
        self.cfg = cfg
        self._srv = ContinuousOffloadServer(
            params, cfg, cache_slots=cache_slots, max_batch=1,
            cache_len=cache_len, policy=policy, policy_kw=policy_kw,
            learned_model=learned_model, prefetch=prefetch, quant=quant,
            hw=hw, overlap=overlap, kv_layout=kv_layout, kv_block_size=kv_block_size,
            device=device)
        self.trace = self._srv.trace
        self.engine = self._srv.engine

    def complete(self, prompt: Sequence[int], *, max_new: int,
                 temperature: float = 0.0, seed: int = 0) -> List[int]:
        # requests are sequential here, so the KV allocation (dense
        # strip or paged pool) can grow to fit each one (the pre-rework
        # server sized it per request)
        self._srv.ensure_cache_len(len(prompt) + max_new)
        rid = self._srv.submit(prompt, max_new=max_new,
                               temperature=temperature, seed=seed)
        self._srv.run()
        return self._srv.result(rid)

    def stats(self) -> Dict[str, float]:
        return self._srv.stats()

    def render_trace(self, layer: int, **kw) -> str:
        return self.trace.render_layer(layer, self.cfg.num_experts, **kw)
