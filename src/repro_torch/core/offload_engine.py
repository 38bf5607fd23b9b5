"""MoE offloading engine — the paper's system, end to end (port of
``repro.core.offload_engine``).

Runs decode for an MoE decoder (Mixtral family: GQA attention + MoE
FFN) with experts offloaded to an ``ExpertStore`` (pinned host memory)
and streamed through per-layer ``ExpertCache``s (device slot buffers)
under a pluggable policy, with optional speculative (gate-ahead) or
Markov pre-fetching. Every step is traced; simulated wall time comes
from the ``CostModel`` (trace-level behaviour is real, transfer latency
is modeled), exactly as in the reference.

Control plane = host Python and numpy, copied from the reference so
traces match byte for byte: routing readback and top-k
(``np.argsort``, never ``torch.topk``: the order on ties must match),
``_batch_union``, ``_combine_matrix``, the policies and predictors
(spec, Markov, learned), the clock. Data plane = PyTorch on
``device``: attention (the paged kernel), the grouped expert FFN (the
moe_ffn kernel, reading the slot buffers in place), installs as
host->device copies. With ``overlap=True`` on a card the installs run on
a copy stream of the engine's, beside compute, ordered by per-slot
events (``ExpertCache``); the simulated clock is unchanged by it and
stays the accounting of record. The host syncs (routing readback, the
speculative guess) wait on the compute stream only.

With ``tiers=`` (a ``repro_torch.core.memory_tiers.TieredMemoryManager``,
or ``attach_tiers`` later) every expert master is registered with the
arbiter, each miss's serving tier lands in the trace (``miss_tiers``)
and the arbiter's stalls (disk-resident demand fetches, KV promotes,
in-flight demotions) land on the simulated clock once a step.

Built and stepped inside ``sharding.sharding_ctx(mesh, rules)`` the
engine runs tensor-parallel in attention with the experts whole, and
splits the decode rows over the data (and pod) axes where the rules say
so (``launch.mesh.sharding_rules(cfg, mesh, global_batch=max_batch)``):
it takes the whole params, builds its ``ExpertStore`` from the whole
experts, and keeps ``shard_params``' slices of every other leaf (the
MoE's, router and shared experts included, stay whole), so the
embedding, the attention decodes (the rank's rows and heads, its dense
cache block or its pool of KV heads) and the logits run as the rules lay
them out, each with its collectives. A step's rows split over the batch
axes as ``sharding.batch_rows`` splits them; a step whose row count does
not divide over them (chunked prefill's virtual rows, a batch-1
``generate``) runs whole on every rank, where JAX's ``sanitize_spec``
drops the axis. There is one control plane: the router logits are
gathered over the batch axes before the host readback (and the
speculative guess's input before its own), so the routing, the caches,
the policies, the predictors, the trace and the clock are the same on
every rank; each rank runs the grouped FFN on its rows with its rows of
the combine matrix, and the logits are gathered back whole. At data size
1 none of these gathers runs. Memory tiers run under a mesh as without
one: the arbiter is one numpy copy on every rank, each rank parks and
resumes its own pool's blocks in the same step, and every park is priced
at the unsharded pool's bytes (``PagedKVCache.block_nbytes``).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.cache_policies import CachePolicy, make_policy
from repro_torch.core.costmodel import CostModel, HardwareProfile, ModelBytes
from repro_torch.core.expert_cache import ExpertCache
from repro_torch.core.expert_store import ExpertStore
from repro_torch.core.faults import as_injector
from repro_torch.core.prefetch import (LearnedPredictor, MarkovPredictor,
                                       SpeculativePrefetcher)
from repro_torch.core.trace import TraceRecorder
from repro_torch.core.transfer_engine import TransferEngine
from repro_torch.kernels import ops
from repro_torch.launch.specs import shard_decode_state
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as tf
from repro_torch.models.layers import rms_norm
from repro_torch.serving.sampler import request_generator, sample_token


def _grouped_ffn(xf, cache: ExpertCache, slots: Sequence[int],
                 comb: np.ndarray):
    """xf [B,d]; cache: the layer's cache, whose slot buffers hold w1/w3
    [S,d,ff], w2 [S,ff,d]; slots: the U slots to run; comb [B,U] -> y
    [B,d]. Under a batch rule ``xf`` is the rank's rows and ``comb`` the
    whole batch's, of which the rank takes its rows.

    The resident-expert FFN goes through the grouped SwiGLU kernel
    (``ops.moe_ffn``), which reads the U experts' weights in place, after
    their installs (``ExpertCache.reading``).
    Capacity dispatch is the full decode batch: x broadcasts to [U,B,d]
    (decode batches are a few rows, so every expert computing every row
    is cheaper than a gather), and the combine matrix mixes each row's
    top-k outputs.
    """
    x_e = xf.float().unsqueeze(0).expand(len(slots), *xf.shape).contiguous()
    b = cache.buffers
    with cache.reading(slots):
        out = ops.moe_ffn(x_e, b["w1"], b["w3"], b["w2"], slots)
    comb_t = shd.batch_rows(torch.from_numpy(comb))
    if xf.is_cuda:
        # from pinned memory, so the upload does not wait for the stream
        # (the host goes on to queue the next chunk's installs)
        comb_t = comb_t.pin_memory().to(xf.device, non_blocking=True)
    return torch.einsum("ubd,bu->bd", out, comb_t)


def _batch_union(ids: np.ndarray, probs: np.ndarray,
                 active: Sequence[bool], num_experts: int
                 ) -> Tuple[List[int], np.ndarray]:
    """Union of the ACTIVE rows' experts, most-weighted first.

    Returns ``(union, w)`` where ``w`` [E] float64 holds each expert's
    summed gate weight. Pure-numpy replacement for the PR 1 Python
    loops, bit-identical with them (regression-tested): weights
    accumulate in float64 in row-major (b, j) order — the loop's
    ``weight_by_e[e] += float(probs[b, j])`` — and weight ties break
    by FIRST OCCURRENCE in that scan order, which is exactly the
    stable-sort-over-dict-insertion-order the loop relied on.
    """
    act = np.asarray(active, bool)
    flat = ids[act].ravel()
    w = np.zeros(num_experts, np.float64)
    np.add.at(w, flat, probs[act].ravel().astype(np.float64))
    first = np.full(num_experts, flat.size, np.int64)
    np.minimum.at(first, flat, np.arange(flat.size))
    present = np.flatnonzero(first < flat.size)
    order = np.lexsort((first[present], -w[present]))
    return [int(e) for e in present[order]], w


def _combine_matrix(chunk: Sequence[int], ids: np.ndarray, probs: np.ndarray,
                    active: Sequence[bool], num_experts: int) -> np.ndarray:
    """[B, len(chunk)] float32 combine weights: row b mixes chunk
    column j with the gate prob of that expert if row b routed to it
    (0 otherwise; inactive rows are all-zero). Numpy scatter in the
    same row-major order as the PR 1 loop — bit-identical."""
    B = ids.shape[0]
    act = np.asarray(active, bool)
    col = np.full(num_experts, -1, np.int64)
    col[np.asarray(chunk, np.int64)] = np.arange(len(chunk))
    cols = col[ids]                                   # [B, k]
    m = (cols >= 0) & act[:, None]
    rows = np.broadcast_to(np.arange(B)[:, None], cols.shape)
    comb = np.zeros((B, len(chunk)), np.float32)
    np.add.at(comb, (rows[m], cols[m]), probs[m])
    return comb


class OffloadEngine:
    def __init__(self, params, cfg, *,
                 cache_slots,  # int, or per-layer Sequence[int]
                 policy: str = "lru",
                 policy_kw: Optional[dict] = None,
                 policy_factory: Optional[Callable[[int], CachePolicy]] = None,
                 quant: str = "none",
                 prefetch: Optional[str] = None,  # None|"spec"|"markov"|"learned"
                 learned_model=None,  # repro_torch.core.learned.LearnedModel
                 hw: Optional[HardwareProfile] = None,
                 overlap: bool = False,
                 trace: Optional[TraceRecorder] = None,
                 tiers=None,   # repro_torch.core.memory_tiers.TieredMemoryManager
                 faults=None,  # FaultPlan | FaultInjector | None
                 device="cuda"):
        assert cfg.is_moe, "offloading targets MoE experts"
        if prefetch not in (None, "spec", "markov", "learned"):
            raise ValueError(
                f"unknown prefetch={prefetch!r}: expected one of "
                f"None, 'spec', 'markov', 'learned'")
        self.device = torch.device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"engine device is {self.device}")
        self.cfg = cfg
        self.mesh, self.rules = shd.active_mesh(), shd.active_rules()
        if isinstance(cache_slots, int):
            if cache_slots < 1:
                raise ValueError(
                    f"cache_slots must be >= 1, got {cache_slots}")
            slots = [cache_slots] * cfg.num_layers
        else:
            slots = list(cache_slots)
            assert len(slots) == cfg.num_layers
            if any(s < 1 for s in slots):
                raise ValueError(
                    f"per-layer cache_slots must all be >= 1, got {slots}")
        # per-layer budgets (beyond paper: skewed layers need fewer slots)
        self.slots = [max(1, min(s, cfg.num_experts)) for s in slots]
        self.cache_slots = sum(self.slots) / cfg.num_layers
        self.trace = trace if trace is not None else TraceRecorder()
        # one injector shared by caches and transfer engine, so
        # fault-event indices are globally consistent; None (the
        # default) keeps every path bit-identical to pre-fault
        self.faults = as_injector(faults, trace=self.trace)
        self.store = ExpertStore.from_params(
            params, cfg, quant=quant, pin=self.device.type == "cuda")
        self.params = params if self.mesh is None else self._rank_params(
            params)
        params = self.params
        # per-layer param views, sliced once
        self._layers = [tf._layer(params["layers"], l)
                        for l in range(cfg.num_layers)]

        d, ff = cfg.d_model, cfg.expert_d_ff
        shapes = {"w1": (d, ff), "w3": (d, ff), "w2": (ff, d)}
        pkw = dict(policy_kw or {})
        # overlap=True on a card: every install runs on this copy stream,
        # beside compute (``ExpertCache`` keeps the slots' events)
        self.copy_stream = (torch.cuda.Stream(self.device)
                            if overlap and self.device.type == "cuda"
                            else None)
        if policy == "learned" and learned_model is not None:
            pkw.setdefault("model", learned_model)
        self.caches: List[ExpertCache] = []
        staging: dict = {}   # int8 installs' device staging, one for all
        for l in range(cfg.num_layers):
            pol = (policy_factory(l) if policy_factory is not None
                   else make_policy(policy, self.slots[l], **pkw))
            self.caches.append(ExpertCache(l, self.slots[l], pol,
                                           self.store, shapes,
                                           device=self.device,
                                           faults=self.faults,
                                           staging=staging,
                                           copy_stream=self.copy_stream))

        mb = ModelBytes.from_config(cfg)
        eb = self.store.expert_nbytes((0, 0))
        mb = ModelBytes(**{**mb.__dict__, "expert_bytes": eb})
        self.cost = CostModel(hw or HardwareProfile.a6000_pcie4(), mb,
                              overlap=overlap)
        self.overlap = overlap
        # host->device expert copy engine (the executed overlap
        # pipeline's clock; idle when overlap=False — the synchronous
        # path keeps the analytic step_latency accounting exactly)
        self.xfer = TransferEngine(lanes=2, faults=self.faults)
        self._clock = 0.0                 # per-step pipeline clock
        self.transfer_busy_s = 0.0        # DMA seconds issued
        self.exposed_transfer_s = 0.0     # DMA seconds the clock saw
        self.sim_time = 0.0
        self.tokens_done = 0
        self._steps_done = 0
        self.degraded_tokens = 0          # tokens decoded w/ dropped experts
        self._step_fault_stall_s = 0.0    # sync-path fault extras this step
        self.spec = SpeculativePrefetcher(cfg) if prefetch == "spec" else None
        self.markov = (MarkovPredictor(cfg.num_layers, cfg.num_experts,
                                       cfg.num_experts_per_tok)
                       if prefetch == "markov" else None)
        self.learned = (LearnedPredictor(cfg.num_layers, cfg.num_experts,
                                         cfg.num_experts_per_tok,
                                         model=learned_model)
                        if prefetch == "learned" else None)
        self._prompt_id = 0
        self._prev_acts: Dict[int, Tuple[int, ...]] = {}
        self.tiers = None
        if tiers is not None:
            self.attach_tiers(tiers)

    def _rank_params(self, params):
        """``shard_params``' slices of every leaf but the MoE's (router,
        experts, shared experts), which stay whole."""
        specs = shd.param_pspecs(params, self.rules, self.mesh)
        specs["layers"]["moe"] = shd.map_with_path(
            lambda _, t: (None,) * t.dim(), params["layers"]["moe"])
        return shd.shard_tree(params, specs, self.mesh)

    def _check_mesh(self) -> None:
        if shd.active_mesh() is not self.mesh:
            raise ValueError(
                "OffloadEngine stepped under another mesh than the one it "
                "was built under: its params are cut for that one")

    def _rows_ctx(self, n_rows: int):
        """The sharding context of a step (or a dense state) of ``n_rows``
        rows: the engine's mesh and rules, with the batch rule dropped
        where it does not split the rows over more than one rank (one data
        rank, or a count that does not divide: the step runs whole on every
        rank). No context without a mesh."""
        if self.mesh is None:
            return contextlib.nullcontext()
        b = self.rules.get("batch")
        n = shd.axis_size(b, self.mesh)
        rules = self.rules if n > 1 and n_rows % n == 0 else \
            dict(self.rules, batch=None)
        return shd.sharding_ctx(self.mesh, rules)

    def attach_tiers(self, tiers) -> None:
        """Wire a ``TieredMemoryManager`` in: register every expert's
        master copy (real store bytes) and point the per-layer caches
        at the arbiter. Call once, before any decoding. Under a mesh
        every rank holds the whole experts and its own arbiter, the same
        numpy copy as every other rank's."""
        assert self.tiers is None, "tiers already attached"
        self.tiers = tiers
        if tiers.trace is None:
            tiers.trace = self.trace
        for key in self.store.keys():
            tiers.register_expert(key, self.store.expert_nbytes(key))
        for c in self.caches:
            c.tiers = tiers
        if self.faults is not None and getattr(tiers, "queue", None) is not None:
            # KV parks / disk spills ride the same injector (their
            # chains never abandon — a parked snapshot is the only copy)
            tiers.queue.faults = self.faults

    # ------------------------------------------------------------------
    def init_state(self, batch: int, cache_len: int):
        """The dense per-row decode state; under the mesh the rank's block
        of one built whole under it (``shard_decode_state``: the rank's
        rows where ``batch`` splits over the batch axes), its length
        rounded up to a multiple of the model axis so that a cache split
        by sequence splits evenly (the slots past a row's position are
        masked, so the extra ones change nothing)."""
        self._check_mesh()
        if self.mesh is None:
            return tf.init_decode_state(self.params, self.cfg, batch,
                                        cache_len, dtype=torch.float32,
                                        device=self.device)
        with self._rows_ctx(batch):
            n = shd.axis_size(shd.model_axis())
            state = tf.init_decode_state(self.params, self.cfg, batch,
                                         -(-cache_len // n) * n,
                                         dtype=torch.float32,
                                         device=self.device)
            return shard_decode_state(state, self.mesh, shd.active_rules())

    def new_prompt(self, *, reset_context: bool = True) -> int:
        """Allocate a fresh prompt (request) id.

        ``reset_context=False`` keeps the Markov-prefetch context — the
        continuous server admits requests while others are mid-decode,
        and the layer-to-layer activation stream it predicts from is a
        shared-batch property, not a per-request one.
        """
        self._prompt_id += 1
        if reset_context:
            self.reset_prefetch_context()
        return self._prompt_id

    def reset_prefetch_context(self) -> None:
        """Forget the previous step's activations (Markov predictor
        input). The continuous server calls this when it goes idle so a
        request admitted to an empty batch sees the same prefetch state
        as a fresh ``generate`` call."""
        self._prev_acts = {}

    # ------------------------------------------------------------------
    def _route(self, p_l, x) -> Tuple[np.ndarray, np.ndarray]:
        """x [B,1,d] (the rank's rows) -> (top ids [B,k], top probs [B,k])
        of the whole batch on host: the router logits are gathered over
        the batch axes first."""
        logits = shd.gather_rows(x.float() @ p_l["moe"]["router"])
        logits = logits[:, 0, :].cpu().numpy()
        k = self.cfg.num_experts_per_tok
        ids = np.argsort(-logits, axis=-1)[:, :k]
        top = np.take_along_axis(logits, ids, axis=-1)
        top = np.exp(top - top.max(axis=-1, keepdims=True))
        probs = top / top.sum(axis=-1, keepdims=True)
        return ids, probs

    def _issue_transfers(self, layer: int, eids: Sequence[int], *,
                         demand: bool, outcomes=None) -> None:
        """Submit host->device expert copies to the copy engine at the
        current pipeline clock (overlap mode only). Demand copies may
        displace queued prefetches; prefetches queue behind the lane
        tails. Keyed ``(layer, expert)`` so the consuming layer can ask
        when its working set is actually resident. ``outcomes`` maps
        expert id -> pre-planned ``FetchOutcome`` (fault injection): a
        retrying chain holds its lane longer, an abandoned one ends at
        the give-up time — the consumer discovers the failure then."""
        dur = self.cost.expert_transfer_time()
        nb = self.cost.mb.expert_bytes
        for e in eids:
            t = self.xfer.submit(self._clock, dur, key=(layer, int(e)),
                                 kind="expert", nbytes=nb, demand=demand,
                                 outcome=(outcomes or {}).get(int(e)))
            self.transfer_busy_s += t.duration

    def _moe_offloaded(self, p_l, layer: int, h,
                       pending_guess: Tuple[int, ...],
                       pending_moved: Tuple[int, ...],
                       pending_outcomes: Dict[int, object],
                       prompt_ids: Sequence[int],
                       token_indices: Sequence[int],
                       active: Sequence[bool]):
        """Batch-union MoE FFN over the shared per-layer cache.

        Inactive rows (free serving slots) route but contribute nothing:
        their experts never join the union and their combine weights are
        exactly zero, so active rows' outputs are independent of batch
        composition. The trace records the union access plus per-request
        attribution for each active row.

        With ``overlap=True`` this is one stage of the executed
        software pipeline: demand misses are ISSUED to the copy engine
        at the layer's start, compute proceeds immediately on the
        (functionally already-installed) union, and the clock stalls
        only for transfers still in flight when the FLOPs finish —
        ``stall = max(0, dma_done - compute_done)``, recorded per layer
        in the trace. The synchronous path exposes the full transfer
        time, exactly as ``CostModel.step_latency`` prices it.

        Under fault injection the layer's demand fetches are PRE-PLANNED
        (``ExpertCache.plan_fetches``): a fetch whose retry chain is
        abandoned drops its expert from this step's compute, and every
        affected row's combine weights are RENORMALIZED over the experts
        that did arrive (drop-missing-expert fallback — decode proceeds,
        degraded, never stalls forever). The dropped set and per-row
        degradation flags land in the trace for quality attribution.
        """
        cfg = self.cfg
        x = rms_norm(h, p_l["ln2"], cfg.norm_eps)   # the rank's rows
        ids, probs = self._route(p_l, x)   # [B,k], the whole batch
        B = ids.shape[0]

        # union of needed experts over ACTIVE rows, most-weighted first
        # (deterministic; first-occurrence order breaks weight ties)
        union, weight_of = _batch_union(ids, probs, active, cfg.num_experts)

        cache = self.caches[layer]
        cache_before = cache.cached_ids()

        # fault injection: decide each demand fetch's fate BEFORE
        # compute, so the dropped set (abandoned chains) is known when
        # the combine weights are built ({} without an injector)
        fates = cache.plan_fetches(union)
        failed = {e for e, o in fates.items() if not o.success}
        scale = None
        if failed:
            # drop-missing-expert fallback: renormalize each affected
            # row's gate weights over the experts that did arrive; a
            # row that lost ALL its experts contributes zero MoE output
            avail = ~np.isin(ids, sorted(failed))          # [B,k]
            denom = (probs * avail).sum(axis=-1)           # [B]
            safe = np.where(denom > 0.0, denom, 1.0)
            scale = np.where(denom > 0.0, 1.0 / safe, 0.0)

        # working set may exceed the cache: stream it in chunks ≤ capacity
        hits: List[int] = []
        misses: List[int] = []
        evicted: List[int] = []
        miss_tiers: List[str] = []
        y = torch.zeros((x.shape[0], cfg.d_model), dtype=torch.float32,
                        device=self.device)
        cap = cache.n_slots
        for c0 in range(0, len(union), cap):
            chunk = union[c0:c0 + cap]
            h_, m_, e_ = (cache.access(chunk, outcomes=fates) if fates
                          else cache.access(chunk))
            hits += h_
            misses += m_
            evicted += e_
            miss_tiers += list(cache.last_miss_tiers)
            comp = ([e for e in chunk if e not in failed] if failed
                    else chunk)
            if not comp:
                continue
            comb = _combine_matrix(comp, ids, probs, active,
                                   cfg.num_experts)
            if scale is not None:
                comb = (comb * scale[:, None]).astype(np.float32)
            y = y + _grouped_ffn(x[:, 0, :], cache, cache.slots_of(comp),
                                 comb)
        h = h + y[:, None, :].to(h.dtype)

        # --- simulated pipeline clock for this layer ------------------
        n_active = sum(1 for a in active if a)
        t_comp = self.cost.layer_compute_time(n_active)
        if self.overlap:
            # demand misses hit the copy engine's priority class at the
            # layer's start (routing readback); already-issued
            # prefetches for this layer may still be in flight — both
            # only cost what outlives the layer's compute. Fault chains
            # ride the same lanes: retries hold them longer, an
            # abandoned chain ends at its give-up time.
            self._issue_transfers(layer, misses, demand=True,
                                  outcomes=fates or None)
            compute_done = self._clock + t_comp
            keys = [(layer, e) for e in union]
            stall_s, blockers = self.xfer.stall_until(keys, compute_done)
            self._clock = compute_done + stall_s
            inflight = tuple(sorted(int(k[1]) for k in blockers))
        else:
            # synchronous: every transfer of this layer is exposed on
            # the clock (the analytic step_latency accounting, sliced
            # per layer; the step's sim_time advance stays the exact
            # step_latency formula)
            stall_s = ((len(misses) + len(pending_moved))
                       * self.cost.expert_transfer_time())
            self.transfer_busy_s += stall_s
            inflight = ()
            if fates or pending_outcomes:
                # fault extras BEYOND the one-transfer-per-miss the
                # formula above prices: retries + backoff, plus whole
                # abandoned chains (their misses moved bytes too)
                base = self.cost.expert_transfer_time()
                extra = sum(o.extra_s(base, self.faults.plan)
                            for o in fates.values())
                extra += sum(o.extra_s(base, self.faults.plan)
                             for o in pending_outcomes.values())
                stall_s += extra
                self._step_fault_stall_s += extra
        self.exposed_transfer_s += stall_s
        if "shared" in p_l["moe"]:
            s = p_l["moe"]["shared"]
            h = h + ((F.silu(x @ s["w1"]) * (x @ s["w3"])) @ s["w2"])

        # per-request attribution (slice of the union)
        req_ids = tuple(int(prompt_ids[b]) for b in range(B) if active[b])
        req_tok = tuple(int(token_indices[b]) for b in range(B) if active[b])
        req_act = tuple(tuple(sorted(int(e) for e in ids[b]))
                        for b in range(B) if active[b])
        # per-row degradation flags (aligned with req_ids): a row is
        # degraded at this layer iff one of ITS routed experts dropped
        req_deg = (tuple(bool(not avail[b].all()) for b in range(B)
                         if active[b]) if failed else ())
        # legacy single-stream fields: exact when the step serves one
        # request (or several rows of one), sentinel otherwise
        pid = req_ids[0] if len(set(req_ids)) == 1 else -1
        tok = req_tok[0] if len(set(req_tok)) == 1 else self._steps_done

        acts = tuple(int(e) for e in union)
        self.trace.record(
            prompt_id=pid, token_idx=tok, layer=layer,
            activated=acts,
            gate_weights=tuple(float(weight_of[e]) for e in union),
            cache_before=cache_before, cache_after=cache.cached_ids(),
            hits=tuple(hits), misses=tuple(misses), evicted=tuple(evicted),
            spec_guess=tuple(pending_guess), prefetched=tuple(pending_moved),
            request_ids=req_ids, request_token_idx=req_tok,
            request_activated=req_act, engine_step=self._steps_done,
            # tier attribution only when an arbiter is attached, so
            # traces without one stay byte-identical
            miss_tiers=(tuple(miss_tiers) if self.tiers is not None else ()),
            stall_s=stall_s, inflight=inflight,
            # fault-free steps keep both empty so trace JSON stays
            # byte-identical with pre-fault output
            dropped=tuple(sorted(failed)), request_degraded=req_deg)
        return h, acts, len(misses), req_deg

    # ------------------------------------------------------------------
    def decode_token(self, state, token, pos: int, token_idx: int):
        """token [B,1] int, all rows at the same position (the paper's
        single-stream setting). Returns (logits [B,V], state)."""
        B = len(token)
        return self.decode_tokens(state, token,
                                  positions=[int(pos)] * B,
                                  token_indices=[int(token_idx)] * B)

    def decode_tokens(self, state, tokens, positions: Sequence[int],
                      token_indices: Optional[Sequence[int]] = None, *,
                      prompt_ids: Optional[Sequence[int]] = None,
                      active: Optional[Sequence[bool]] = None,
                      block_tables=None):
        """True B>1 decode over the shared per-layer expert caches.

        tokens [B,1] int (tensor, array or nested list); ``positions[b]``
        is row b's sequence position (rows may be staggered — continuous
        batching), ``token_indices[b]`` its token index within its
        request — defaults to ``positions`` — ``prompt_ids[b]`` its
        request id for trace attribution. ``active[b]=False`` marks a
        free serving slot: the row is decoded (static shapes) but routed
        nowhere, attends only to its own slot's KV rows, and is excluded
        from the union access, the trace, and the simulated clock.

        ``block_tables`` [B, T] int switches the KV path to a PAGED
        pool: ``state["layers"][l]`` must then be a per-layer block pool
        (see ``repro_torch.core.paged_kv.PagedKVCache``) and row b's KV
        lives at the physical blocks ``block_tables[b]``. The KV caches
        are updated in place. Returns (logits [B,V], state).
        """
        self._check_mesh()
        cfg = self.cfg
        params = self.params
        dev = self.device
        tokens = torch.as_tensor(tokens, device=dev).long().reshape(-1, 1)
        B = tokens.shape[0]
        if token_indices is None:
            token_indices = positions
        if prompt_ids is None:
            prompt_ids = [self._prompt_id] * B
        if active is None:
            active = [True] * B
        n_active = sum(1 for a in active if a)
        assert n_active >= 1, "decode step with no active rows"
        pos_vec = torch.as_tensor(list(positions), dtype=torch.int32,
                                  device=dev)
        if block_tables is not None:
            block_tables = torch.as_tensor(block_tables, dtype=torch.int32,
                                           device=dev)

        with self._rows_ctx(B):
            # the rank's rows of the step where the batch rule splits them
            pos_rows = shd.batch_rows(pos_vec)
            h = tf._embed(params, cfg, shd.batch_rows(tokens),
                          pos_rows[:, None])

            # guesses issued at layer l are consumed at layer l+1 of the SAME
            # token pass (the prefetch travels ahead of the compute wavefront);
            # each entry is (guess, moved, fault outcomes of the moved ids)
            pending: Dict[int, Tuple[Tuple[int, ...], Tuple[int, ...], Dict]] = {}
            step_misses = 0
            step_prefetch = 0
            act_rows = torch.as_tensor([b for b in range(B) if active[b]],
                                       dtype=torch.long, device=dev)
            # the executed pipeline clock starts where the last step ended;
            # per-layer stages advance it by compute + exposed stall
            self._clock = self.sim_time
            self._step_fault_stall_s = 0.0
            step_degraded = [False] * n_active
            if self.faults is not None:
                self.faults.now = self.sim_time

            for l in range(cfg.num_layers):
                p_l = self._layers[l]
                if block_tables is None:
                    h, state["layers"][l] = tf._attn_decode_multipos(
                        p_l, cfg, h, state["layers"][l], pos_rows)
                else:
                    h, state["layers"][l] = tf._attn_decode_paged(
                        p_l, cfg, h, state["layers"][l], pos_vec, block_tables)

                # --- speculative guess for layer l+1 (paper §3.2) ---------
                if self.spec is not None and l + 1 < cfg.num_layers:
                    p_next = self._layers[l + 1]
                    # every active row's guess, on every rank
                    guess = self.spec.guess(shd.gather_rows(h)[act_rows],
                                            p_next["ln2"],
                                            p_next["moe"]["router"])
                    # decided now, copied after layer l's demand installs
                    moved = self.caches[l + 1].prefetch(guess, defer=True)
                    step_prefetch += len(moved)
                    pending[l + 1] = (guess, tuple(moved),
                                      dict(self.caches[l + 1]
                                           .last_prefetch_outcomes))
                    if self.overlap:
                        # issued before layer l's MoE computes: the copy
                        # has layer l's compute window to hide under
                        self._issue_transfers(
                            l + 1, moved, demand=False,
                            outcomes=self.caches[l + 1].last_prefetch_outcomes
                            or None)

                pg, pm, po = pending.get(l, ((), (), {}))
                h, acts, misses, req_deg = self._moe_offloaded(
                    p_l, l, h, pg, pm, po, prompt_ids, token_indices, active)
                if l + 1 < cfg.num_layers:
                    # layer l+1's speculative copies queue behind layer l's
                    # demand copies (the reference's clock lets a demand
                    # transfer go ahead of queued prefetches)
                    self.caches[l + 1].issue_prefetches()
                step_misses += misses
                for i, d in enumerate(req_deg):
                    step_degraded[i] |= d
                predictor = self.markov if self.markov is not None else self.learned
                if predictor is not None:
                    if self.learned is not None:
                        # keep the learned feature walk aligned with training
                        self.learned.observe(l, acts)
                    if l > 0:
                        predictor.update(l - 1, self._prev_acts.get(l - 1, ()),
                                         acts)
                    if l + 1 < cfg.num_layers:
                        # predict l+1 from THIS token's layer-l set — the
                        # same-token l -> l+1 transition the table is
                        # trained on
                        guess = predictor.predict(l, acts)
                        moved = self.caches[l + 1].prefetch(guess)
                        step_prefetch += len(moved)
                        pending[l + 1] = (guess, tuple(moved),
                                          dict(self.caches[l + 1]
                                               .last_prefetch_outcomes))
                        if self.overlap:
                            # predicted AFTER layer l's MoE (the clock has
                            # advanced past it): the copy hides under layer
                            # l+1's attention + FFN compute
                            self._issue_transfers(
                                l + 1, moved, demand=False,
                                outcomes=self.caches[l + 1]
                                .last_prefetch_outcomes or None)
                self._prev_acts[l] = acts

            logits = shd.gather_rows(
                tf.logits_from_hidden(params, cfg, h)[:, 0])

            # simulated clock: one step serves n_active tokens; misses are
            # already batch-union counts (amortization is emergent)
            if self.overlap:
                # executed pipeline: per-layer stages already advanced the
                # clock by compute + exposed stall; transfers that finished
                # under compute cost nothing
                self.sim_time = self._clock
                self.xfer.advance(self.sim_time)
            else:
                self.sim_time += self.cost.step_latency(
                    step_misses / cfg.num_layers,
                    prefetch_per_layer=step_prefetch / cfg.num_layers,
                    batch=n_active)
                if self._step_fault_stall_s:
                    # retries/backoff/abandoned chains land ON TOP of the
                    # analytic formula (which prices one transfer per miss)
                    self.sim_time += self._step_fault_stall_s
            if self.faults is not None:
                self.faults.now = self.sim_time
                self.degraded_tokens += sum(1 for d in step_degraded if d)
            if self.tiers is not None:
                # tier stalls (disk-resident demand fetches, in-flight
                # demotion waits) land on top of the host-link pricing
                # above; then the arbiter's clock catches up so background
                # swaps complete
                self.sim_time += self.tiers.drain_stall()
                self.tiers.advance(self.sim_time)
            self.tokens_done += n_active
            self._steps_done += 1
            return logits, state

    # ------------------------------------------------------------------
    def prefill_tokens(self, state, tokens, positions: Sequence[int], *,
                       token_indices: Optional[Sequence[int]] = None,
                       prompt_ids: Optional[Sequence[int]] = None,
                       active: Optional[Sequence[bool]] = None,
                       block_tables=None):
        """Push N KNOWN tokens through ONE engine step (chunked prefill).

        ``tokens`` is a flat [N] (or [N,1]) int vector of *virtual
        rows*: row j is one known token at sequence position
        ``positions[j]``. Rows belonging to the same request (equal
        ``prompt_ids`` entries, consecutive positions, identical
        ``block_tables`` rows) form a chunk. The paged decode path
        scatters EVERY row's new K/V into the pool before the attention
        kernel reads it and masks ``idx <= pos``, so within a step later
        positions of a chunk see earlier ones' K/V and nothing of the
        future. The MoE side is one batched union access per chunk: a
        chunk's misses are paid once, and the simulated clock prices one
        step serving N tokens.

        Requires paged KV (``block_tables`` [N, T]; replicate a
        request's block-table row across its chunk). Returns
        (logits [N, V], state); callers sample from the LAST row of a
        request's final chunk and discard the rest.
        """
        assert block_tables is not None, \
            "chunked prefill requires a paged KV pool (block_tables)"
        return self.decode_tokens(state, tokens, list(positions),
                                  token_indices=token_indices,
                                  prompt_ids=prompt_ids, active=active,
                                  block_tables=block_tables)

    # ------------------------------------------------------------------
    def generate(self, prompt: Sequence[int], n_new: int, *,
                 temperature: float = 0.0, seed: int = 0,
                 cache_len: Optional[int] = None) -> List[int]:
        """Single-sequence generation (the paper's batch-1 setting).

        Greedy at temperature 0. At temperature > 0 token i is drawn
        with ``sampler.request_generator(seed, i)`` — the draw the
        continuous server makes for the same (seed, token index) — not
        JAX's sequential key splits, so the two packages agree only in
        distribution there."""
        self.new_prompt()
        total = len(prompt) + n_new
        cache_len = cache_len or total
        state = self.init_state(1, cache_len)
        out: List[int] = list(prompt)
        logits = None
        for i, t in enumerate(prompt):
            logits, state = self.decode_token(state, [[t]], i, i)
        for _ in range(n_new):
            gen = request_generator(seed, len(out), device=logits.device) \
                if temperature > 0 else None
            nxt = int(sample_token(gen, logits, temperature=temperature)[0])
            out.append(nxt)
            pos = len(out) - 1
            logits, state = self.decode_token(state, [[nxt]], pos, pos)
        return out

    # ------------------------------------------------------------------
    def stats(self, *, kv_tokens: float = 0.0) -> Dict[str, float]:
        """Aggregate counters. ``kv_tokens`` is the peak number of KV
        token-slots resident alongside the experts (a serving layer
        passes its paged pool's peak block occupancy * block_size);
        the bare engine's dense per-call state is transient and priced
        at 0 by default."""
        hits = sum(c.hits for c in self.caches)
        misses = sum(c.misses for c in self.caches)
        pre = sum(c.prefetches for c in self.caches)
        prec, rec = self.trace.cache_precision_recall()
        sp, sr = self.trace.spec_precision_recall()
        s = {
            "hits": hits, "misses": misses, "prefetches": pre,
            "hit_rate": hits / max(hits + misses, 1),
            "cache_precision": prec, "cache_recall": rec,
            "spec_precision": sp, "spec_recall": sr,
            "bytes_transferred": sum(c.bytes_transferred for c in self.caches),
            "decode_steps": self._steps_done,
            # overlap pipeline accounting: DMA seconds issued vs the
            # fraction the simulated clock actually saw (== 1.0 on the
            # synchronous path, < 1.0 once transfers hide under compute)
            "transfer_busy_s": self.transfer_busy_s,
            "exposed_transfer_s": self.exposed_transfer_s,
            "exposed_transfer_frac": (self.exposed_transfer_s
                                      / self.transfer_busy_s
                                      if self.transfer_busy_s else 0.0),
            "dma_preempted": self.xfer.preempted,
            "sim_time_s": self.sim_time,
            "sim_tokens_per_s": self.tokens_done / self.sim_time
            if self.sim_time else 0.0,
            "peak_memory_bytes": self.cost.peak_memory_bytes(
                self.cfg.num_experts - self.cache_slots,
                kv_tokens=kv_tokens),
        }
        if self.tiers is not None:
            s.update(self.tiers.stats())
        if self.faults is not None:
            # health/degradation summary (keys absent without an
            # injector so pre-fault stats stay unchanged)
            s.update(self.faults.stats())
            s["fetch_failures"] = sum(c.fetch_failures for c in self.caches)
            s["corrupt_refetches"] = sum(c.corrupt_refetches
                                         for c in self.caches)
            s["degraded_tokens"] = self.degraded_tokens
            s["degraded_token_frac"] = (self.degraded_tokens
                                        / max(self.tokens_done, 1))
            s["dma_retries"] = self.xfer.retries
            s["dma_abandoned"] = self.xfer.abandoned
        return s
