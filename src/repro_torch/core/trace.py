"""Tracing system — the paper's first contribution.

Records, for every (prompt, token, layer): the activated experts with
their gate weights, the cache contents before/after, hit/miss/eviction
events, and speculative-prefetch guesses. Every figure and table in the
paper is a view over this record; ``render_layer`` reproduces the
Fig 1-6/8-12 trace grids as ASCII, and the stats methods compute the
precision/recall used in Tables 2 and §5.4.

Cache precision/recall follow the paper's definitions (§4.2):
  precision = |cached ∩ activated| / |cached|
  recall    = |cached ∩ activated| / |activated|
computed over the *pre-update* cache contents at every (token, layer),
then averaged.
"""
from __future__ import annotations

import dataclasses
import json
from collections import Counter
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class StepTrace:
    prompt_id: int
    token_idx: int
    layer: int
    activated: Tuple[int, ...]
    gate_weights: Tuple[float, ...]
    cache_before: Tuple[int, ...]
    cache_after: Tuple[int, ...]
    hits: Tuple[int, ...]
    misses: Tuple[int, ...]
    evicted: Tuple[int, ...]
    spec_guess: Tuple[int, ...] = ()        # speculative guesses for THIS layer
    prefetched: Tuple[int, ...] = ()        # experts actually pre-admitted
    # memory tier each miss was served from ("host"/"disk"), aligned
    # with ``misses``; empty when no tier manager is attached (every
    # fetch then comes from the host ExpertStore)
    miss_tiers: Tuple[str, ...] = ()
    # --- overlap pipeline accounting (PR 9) ---------------------------
    # seconds of transfer time this layer EXPOSED on the simulated
    # clock: under the executed overlap pipeline this is
    # max(0, dma_done - compute_done) (only the DMA tail sticking out
    # past the layer's compute), under the synchronous path it is the
    # full demand+prefetch transfer time (nothing hides)
    stall_s: float = 0.0
    # experts of this layer's union whose host->device copy was still
    # in flight when the layer's compute finished — the stall causers;
    # always empty on the synchronous path
    inflight: Tuple[int, ...] = ()
    # --- degraded-mode decode accounting (PR 10) ----------------------
    # experts of this layer's union whose fetch exhausted its fault
    # retries: decode proceeded WITHOUT them, renormalizing each row's
    # gate weights over the resident experts (drop-missing-expert
    # fallback). Empty on every fault-free path.
    dropped: Tuple[int, ...] = ()
    # per-active-row degradation flags aligned with ``request_ids``:
    # True when that request's token routed to a dropped expert this
    # layer (the per-token quality-impact attribution)
    request_degraded: Tuple[bool, ...] = ()
    # global engine step (one per decode_tokens call): aligns the layers
    # of one token pass so the learned predictor's same-token
    # previous-layer transition feature survives batched/interleaved
    # traces, where token_idx alone is ambiguous (-1 sentinel)
    engine_step: int = -1
    # --- batched serving attribution (one entry per active request) ---
    # ``activated``/``hits``/``misses`` above describe the BATCH-UNION
    # access against the shared cache; these slice it back per request.
    request_ids: Tuple[int, ...] = ()
    request_token_idx: Tuple[int, ...] = ()
    request_activated: Tuple[Tuple[int, ...], ...] = ()

    def request_rows(self):
        """Per-request (prompt_id, token_idx, activated) views of this
        step; single-request traces fall back to the legacy fields."""
        if self.request_ids:
            return list(zip(self.request_ids, self.request_token_idx,
                            self.request_activated))
        return [(self.prompt_id, self.token_idx, self.activated)]


@dataclasses.dataclass
class TierEvent:
    """One inter-tier movement (see ``repro_torch.core.memory_tiers``):
    ``kind`` "expert" or "kv", ``event`` "demote"/"promote",
    ``src``/``dst`` in {"hbm","host","disk"}, real payload ``nbytes``,
    ``key`` = (layer, expert_id) or (rid,), and the simulated time the
    transfer was issued. Demand-miss tiers live per-step in
    ``StepTrace.miss_tiers`` instead (one entry per miss, not per
    movement)."""
    kind: str
    event: str
    src: str
    dst: str
    nbytes: int
    key: Tuple[int, ...] = ()
    sim_time: float = 0.0


@dataclasses.dataclass
class FaultEvent:
    """One injected-fault observation (see ``repro_torch.core.faults``):
    ``kind`` in {"dma", "disk", "corrupt", "straggler", "request"},
    ``action`` in {"retry", "abandon", "slow", "timeout", "shed"},
    ``key`` = (layer, expert_id) for fetches / (rid,) for requests,
    ``attempt`` the failed attempt index, ``sim_time`` when the
    injector last saw the simulated clock, and a freeform ``detail``
    (e.g. the shed reason). docs/traces.md documents the schema."""
    kind: str
    action: str
    key: Tuple = ()
    attempt: int = 0
    sim_time: float = 0.0
    detail: str = ""


class TraceRecorder:
    def __init__(self):
        self.steps: List[StepTrace] = []
        self.tier_events: List[TierEvent] = []
        self.fault_events: List[FaultEvent] = []

    def record(self, **kw) -> None:
        self.steps.append(StepTrace(**kw))

    def record_tier(self, **kw) -> None:
        """Append a ``TierEvent`` (called by ``TieredMemoryManager``)."""
        self.tier_events.append(TierEvent(**kw))

    def record_fault(self, **kw) -> None:
        """Append a ``FaultEvent`` (called by ``FaultInjector`` and the
        serving layer's timeout/shed paths)."""
        self.fault_events.append(FaultEvent(**kw))

    # ------------------------------------------------------------ stats
    def cache_precision_recall(self, *, layer: Optional[int] = None
                               ) -> Tuple[float, float]:
        tp = n_cached = n_act = 0
        for s in self.steps:
            if layer is not None and s.layer != layer:
                continue
            inter = set(s.cache_before) & set(s.activated)
            tp += len(inter)
            n_cached += len(s.cache_before)
            n_act += len(s.activated)
        prec = tp / n_cached if n_cached else 0.0
        rec = tp / n_act if n_act else 0.0
        return prec, rec

    def hit_rate(self, *, layer: Optional[int] = None) -> float:
        h = m = 0
        for s in self.steps:
            if layer is not None and s.layer != layer:
                continue
            h += len(s.hits)
            m += len(s.misses)
        return h / (h + m) if (h + m) else 0.0

    def spec_precision_recall(self, *, skip_first_layer: bool = True
                              ) -> Tuple[float, float]:
        """P/R of speculative guesses vs truly activated experts.

        The paper's §5.4 identity (|FP| == |FN| whenever the guess count
        equals the activation count, hence precision == recall) is
        asserted by tests over this computation.
        """
        tp = fp = fn = 0
        for s in self.steps:
            if skip_first_layer and s.layer == 0:
                continue
            if not s.spec_guess:
                continue
            g, a = set(s.spec_guess), set(s.activated)
            tp += len(g & a)
            fp += len(g - a)
            fn += len(a - g)
        prec = tp / (tp + fp) if (tp + fp) else 0.0
        rec = tp / (tp + fn) if (tp + fn) else 0.0
        return prec, rec

    # ----------------------------------------------- per-request slicing
    def request_ids(self) -> List[int]:
        """All request (prompt) ids observed, in first-seen order."""
        seen: List[int] = []
        for s in self.steps:
            for rid, _, _ in s.request_rows():
                if rid not in seen:
                    seen.append(rid)
        return seen

    def request_steps(self, prompt_id: int
                      ) -> List[Tuple[int, int, Tuple[int, ...], "StepTrace"]]:
        """This request's (token_idx, layer, activated, union_step) rows,
        sliced out of the shared-batch trace, in decode order."""
        rows = []
        for s in self.steps:
            for rid, tok, acts in s.request_rows():
                if rid == prompt_id:
                    rows.append((tok, s.layer, tuple(acts), s))
        rows.sort(key=lambda r: (r[0], r[1]))
        return rows

    def request_stats(self, prompt_id: int) -> Dict[str, float]:
        """Per-request cache accounting over the shared cache.

        An expert this request activates counts as a hit if the shared
        batch access found it resident (``s.hits``), a miss otherwise —
        so one demand transfer shared by two co-batched requests counts
        as a hit-equivalent for neither and a miss for both (contention
        view), while precision/recall keep the paper's pre-update-cache
        definitions restricted to this request's activations.
        """
        hits = misses = 0
        tp = n_cached = n_act = 0
        n_tokens = set()
        for tok, _, acts, s in self.request_steps(prompt_id):
            a = set(acts)
            hits += len(a & set(s.hits))
            misses += len(a & set(s.misses))
            tp += len(a & set(s.cache_before))
            n_cached += len(s.cache_before)
            n_act += len(a)
            n_tokens.add(tok)
        return {
            "hits": hits, "misses": misses,
            "hit_rate": hits / max(hits + misses, 1),
            "precision": tp / max(n_cached, 1),
            "recall": tp / max(n_act, 1),
            "tokens": len(n_tokens),
        }

    def expert_histogram(self, layer: int, num_experts: int) -> List[int]:
        c = Counter()
        for s in self.steps:
            if s.layer == layer:
                c.update(s.activated)
        return [c.get(e, 0) for e in range(num_experts)]

    def activation_entropy(self, layer: int, num_experts: int) -> float:
        import math
        h = self.expert_histogram(layer, num_experts)
        tot = sum(h)
        if not tot:
            return 0.0
        return -sum((c / tot) * math.log2(c / tot) for c in h if c)

    def transfers(self) -> int:
        return sum(len(s.misses) + len(s.prefetched) for s in self.steps)

    def exposed_stall_s(self, *, layer: Optional[int] = None) -> float:
        """Total transfer seconds the recorded steps exposed on the
        simulated clock (``StepTrace.stall_s`` summed) — the overlap
        pipeline's headline metric. Synchronous-path traces expose the
        full transfer time; executed-overlap traces only the DMA tails
        that outlived their layer's compute."""
        return sum(s.stall_s for s in self.steps
                   if layer is None or s.layer == layer)

    # ------------------------------------------------------ tier events
    def tier_transfer_stats(self) -> Dict[str, Dict[str, int]]:
        """Aggregate ``tier_events`` into {"kind:src->dst": {count,
        bytes}} — the auditable view of what the memory arbiter moved
        (docs/traces.md documents the schema)."""
        out: Dict[str, Dict[str, int]] = {}
        for e in self.tier_events:
            k = f"{e.kind}:{e.src}->{e.dst}"
            d = out.setdefault(k, {"count": 0, "bytes": 0})
            d["count"] += 1
            d["bytes"] += e.nbytes
        return out

    def miss_tier_counts(self) -> Dict[str, int]:
        """Demand misses by the tier that served them. Steps recorded
        without a tier manager count as "host" (the pre-tiering
        behaviour: every fetch came from the host store)."""
        c: Counter = Counter()
        for s in self.steps:
            if s.miss_tiers:
                c.update(s.miss_tiers)
            else:
                c["host"] += len(s.misses)
        return dict(c)

    def degraded_token_counts(self) -> Tuple[int, int]:
        """(degraded, total) over distinct (request, token) pairs. A
        token counts as degraded when ANY of its layers dropped an
        expert it routed to (``StepTrace.request_degraded`` /
        ``dropped``) — the per-token quality-impact attribution of the
        drop-missing-expert fallback."""
        degraded: set = set()
        total: set = set()
        for s in self.steps:
            if s.request_ids:
                flags = s.request_degraded or (False,) * len(s.request_ids)
                for rid, tok, bad in zip(s.request_ids,
                                         s.request_token_idx, flags):
                    total.add((rid, tok))
                    if bad:
                        degraded.add((rid, tok))
            else:
                total.add((s.prompt_id, s.token_idx))
                if s.dropped:
                    degraded.add((s.prompt_id, s.token_idx))
        return len(degraded), len(total)

    def temporal_locality(self, *, layer: Optional[int] = None) -> float:
        """P(expert of token t also used by token t-1) — the Mixtral-paper
        statistic the baseline's caching exploits."""
        by_tok: Dict[Tuple[int, int, int], set] = {}
        for s in self.steps:
            for rid, tok, acts in s.request_rows():
                by_tok[(rid, s.layer, tok)] = set(acts)
        num = den = 0
        for (pid, lay, tok), acts in by_tok.items():
            if layer is not None and lay != layer:
                continue
            prev = by_tok.get((pid, lay, tok - 1))
            if prev is None:
                continue
            num += len(acts & prev)
            den += len(acts)
        return num / den if den else 0.0

    # ------------------------------------------------------------ views
    def render_layer(self, layer: int, num_experts: int, *,
                     prompt_id: Optional[int] = None,
                     max_tokens: int = 64) -> str:
        """ASCII analogue of the paper's Fig 2-6/8-12: rows = experts,
        cols = tokens; '#'=activated+cached (hit), 'O'=activated only
        (miss), '.'=cached only ("miscached"), ' '=neither."""
        rows = []  # (token_idx, activated, cache_before) for one request
        for s in self.steps:
            if s.layer != layer:
                continue
            for rid, tok, acts in s.request_rows():
                rows.append((rid, tok, acts, s.cache_before))
        if prompt_id is None:
            prompt_id = rows[0][0] if rows else 0
        rows = [(t, a, cb) for rid, t, a, cb in rows if rid == prompt_id]
        toks = sorted({t for t, _, _ in rows})[:max_tokens]
        grid = [[" "] * len(toks) for _ in range(num_experts)]
        for tok, acts, cache_before in rows:
            if tok not in toks:
                continue
            col = toks.index(tok)
            for e in range(num_experts):
                act = e in acts
                cached = e in cache_before
                grid[e][col] = "#" if act and cached else (
                    "O" if act else ("." if cached else " "))
        lines = [f"layer {layer}  ('#'=hit 'O'=miss '.'=miscached)"]
        for e in range(num_experts):
            lines.append(f"e{e:03d} |" + "".join(grid[e]) + "|")
        return "\n".join(lines)

    def to_json(self) -> str:
        """Serialize. Stays the legacy flat step list whenever there
        are no tier or fault events (bit-compatible with every earlier
        reader — the fault-free degradation fields are stripped too);
        otherwise it becomes ``{"steps": [...], "tier_events": [...],
        "fault_events": [...]}`` — ``from_json`` loads both shapes
        (the format docs/traces.md specifies)."""
        steps = [dataclasses.asdict(s) for s in self.steps]
        for d in steps:
            # fault-free steps serialize byte-identically to pre-fault
            # builds: the degradation fields only appear when populated
            if not d["dropped"]:
                del d["dropped"]
            if not d["request_degraded"]:
                del d["request_degraded"]
        if not self.tier_events and not self.fault_events:
            return json.dumps(steps)
        return json.dumps({
            "steps": steps,
            "tier_events": [dataclasses.asdict(e) for e in self.tier_events],
            "fault_events": [dataclasses.asdict(e)
                             for e in self.fault_events],
        })

    @classmethod
    def from_json(cls, s: str) -> "TraceRecorder":
        def detuple(v):
            return tuple(detuple(x) for x in v) if isinstance(v, list) else v

        # restrict to known fields so traces serialized by NEWER versions
        # (extra per-step fields) still load, and let dataclass defaults
        # fill fields OLDER traces predate (e.g. ``engine_step``) — the
        # roundtrip contract the learned-predictor trainer relies on
        known = {f.name for f in dataclasses.fields(StepTrace)}
        tr = cls()
        data = json.loads(s)
        events = []
        faults = []
        if isinstance(data, dict):
            events = data.get("tier_events", [])
            faults = data.get("fault_events", [])
            data = data["steps"]
        for d in data:
            tr.steps.append(StepTrace(**{k: detuple(v) for k, v in d.items()
                                         if k in known}))
        eknown = {f.name for f in dataclasses.fields(TierEvent)}
        for d in events:
            tr.tier_events.append(TierEvent(**{k: detuple(v)
                                               for k, v in d.items()
                                               if k in eknown}))
        fknown = {f.name for f in dataclasses.fields(FaultEvent)}
        for d in faults:
            tr.fault_events.append(FaultEvent(**{k: detuple(v)
                                                 for k, v in d.items()
                                                 if k in fknown}))
        return tr
