"""The paper's experimental pipeline end to end (port of
``examples/offload_paper_pipeline.py``):

  1. train a reduced Mixtral on the synthetic LM (stands in for the
     pretrained model);
  2. trace expert activations + LRU cache behaviour (paper §5.1/5.2);
  3. compare LRU vs LFU vs beyond-paper policies (Table 2);
  4. measure speculative prefetch precision/recall (§5.4), check P==R;
  5. deploy the prefetch with overlap (the paper's §6.1 future work).

Run:  PYTHONPATH=src python -m repro_torch.examples.offload_paper_pipeline
      [--device cpu]

Each stage is a function of ``(params, cfg, <sizes>, device=)`` that
returns what the stage prints, as plain Python numbers, lists and
strings; ``main`` composes them at the reference script's sizes. The
tok/s columns are ``CostModel``'s simulated A6000 clock, not a
measurement.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Sequence

from repro_torch.configs import get_config, reduced
from repro_torch.core import OffloadEngine
from repro_torch.core.costmodel import HardwareProfile
from repro_torch.data import lm_batches
from repro_torch.launch import require_device
from repro_torch.training import train
from repro_torch.training.optimizer import AdamWConfig

PROMPTS = [[5, 17, 42, 7], [88, 3, 101, 55], [9, 9, 23, 60]]
NEW = 24
SLOTS = 4
POLICIES = ("lru", "lfu", "aged-lfu", "lrfu")


def pipeline_config():
    """The reference script's model: Mixtral-8x7B reduced to 4 layers,
    d_model 128, 8 experts top-2, vocab 256, fp32."""
    cfg = reduced(get_config("mixtral-8x7b"), layers=4, d_model=128,
                  experts=8, vocab=256)
    return dataclasses.replace(cfg, dtype="float32", num_experts_per_tok=2)


def plain_values(x):
    """numpy scalars (and containers of them) as Python numbers."""
    if isinstance(x, dict):
        return {k: plain_values(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain_values(v) for v in x]
    return x.item() if hasattr(x, "item") else x


def _generate_all(engine, prompts, new) -> List[List[int]]:
    return [engine.generate(p, new) for p in prompts]


def train_model(cfg, *, steps: int, batch: int, seq: int, lr: float,
                seed: int = 0, log_every: int = 0, params=None,
                device="cuda"):
    """Stage 1: ``steps`` AdamW steps on ``lm_batches`` through the
    dense MoE path (every expert on every token, as the reference
    trains). Params are drawn from ``seed`` unless given (given params
    are trained in place). Returns (params, losses)."""
    batches = lm_batches(cfg.vocab_size, batch, seq, steps, seed=seed)
    return train(cfg, batches, steps=steps, params=params, seed=seed,
                 log_every=log_every, opt_cfg=AdamWConfig(lr=lr),
                 moe_path="dense", device=device)


def lru_trace(params, cfg, prompts: Sequence[Sequence[int]], new: int,
              slots: int, *, device="cuda") -> Dict:
    """Stage 2: generate every prompt through one LRU engine; its trace's
    layer-1 render (the prompt's and new tokens' columns), temporal
    locality beside the random baseline k/E, each layer's activation
    histogram, and the engine's ``stats()``."""
    eng = OffloadEngine(params, cfg, cache_slots=slots, policy="lru",
                        device=device)
    tokens = _generate_all(eng, prompts, new)
    width = max(len(p) for p in prompts) + new
    return {
        "tokens": tokens,
        "render": eng.trace.render_layer(1, cfg.num_experts,
                                         max_tokens=width),
        "temporal_locality": plain_values(eng.trace.temporal_locality()),
        "random_locality": cfg.num_experts_per_tok / cfg.num_experts,
        "histograms": [plain_values(eng.trace.expert_histogram(
            l, cfg.num_experts)) for l in range(cfg.num_layers)],
        "stats": plain_values(eng.stats()),
    }


def compare_policies(params, cfg, prompts: Sequence[Sequence[int]],
                     new: int, slots: int, *, device="cuda") -> Dict:
    """Stage 3: one engine per policy (``POLICIES``), one at a time, on
    the A6000 cost profile: ``{policy: {"tokens", "stats"}}``."""
    out = {}
    for policy in POLICIES:
        eng = OffloadEngine(params, cfg, cache_slots=slots, policy=policy,
                            hw=HardwareProfile.a6000_pcie4(), device=device)
        tokens = _generate_all(eng, prompts, new)
        out[policy] = {"tokens": tokens, "stats": plain_values(eng.stats())}
        del eng   # its slot buffers go before the next engine's
    return out


def speculative(params, cfg, prompts: Sequence[Sequence[int]], new: int,
                slots: int, *, device="cuda") -> Dict:
    """Stage 4: LRU with speculative (gate-ahead) prefetch. Its guess
    always moves exactly the experts it names, so precision equals
    recall; raises if not."""
    eng = OffloadEngine(params, cfg, cache_slots=slots, policy="lru",
                        prefetch="spec", device=device)
    tokens = _generate_all(eng, prompts, new)
    s = plain_values(eng.stats())
    if abs(s["spec_precision"] - s["spec_recall"]) >= 1e-9:
        raise RuntimeError(f"speculative prefetch: precision "
                           f"{s['spec_precision']} != recall "
                           f"{s['spec_recall']}")
    return {"tokens": tokens, "stats": s}


def deployed(params, cfg, prompts: Sequence[Sequence[int]], new: int,
             slots: int, *, device="cuda") -> Dict:
    """Stage 5: LFU + speculative prefetch + overlap on the A6000 cost
    profile (on a card the installs run on the engine's copy stream)."""
    eng = OffloadEngine(params, cfg, cache_slots=slots, policy="lfu",
                        prefetch="spec", overlap=True,
                        hw=HardwareProfile.a6000_pcie4(), device=device)
    tokens = _generate_all(eng, prompts, new)
    return {"tokens": tokens, "stats": plain_values(eng.stats())}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = require_device(ap.parse_args(argv).device)

    # ---- 1. model --------------------------------------------------
    cfg = pipeline_config()
    params, losses = train_model(cfg, steps=100, batch=8, seq=64, lr=2e-3,
                                 log_every=50, device=device)
    sized = (params, cfg, PROMPTS, NEW, SLOTS)

    # ---- 2. trace under LRU (Fig 1-6) -------------------------------
    tr = lru_trace(*sized, device=device)
    print("\n=== LRU trace, layer 1 (paper Fig 2/3 analogue) ===")
    print(tr["render"])
    print(f"temporal locality: {tr['temporal_locality']:.3f} "
          f"(random = {tr['random_locality']:.3f})")
    for l, h in enumerate(tr["histograms"]):
        print(f"layer {l} activation histogram: {h}")

    # ---- 3. policy comparison (Table 2) ------------------------------
    print("\n=== policy comparison (Table 2 analogue) ===")
    print(f"{'policy':10s} {'hit':>6s} {'prec':>6s} {'rec':>6s} "
          f"{'tok/s(A6000)':>12s}")
    table = compare_policies(*sized, device=device)
    for policy, r in table.items():
        s = r["stats"]
        print(f"{policy:10s} {s['hit_rate']:6.3f} "
              f"{s['cache_precision']:6.3f} {s['cache_recall']:6.3f} "
              f"{s['sim_tokens_per_s']:12.2f}")

    # ---- 4. speculative prefetch (§5.4) ------------------------------
    s = speculative(*sized, device=device)["stats"]
    print(f"\nspeculative prefetch: P = R = {s['spec_precision']:.3f} "
          f"(paper: 0.846 on full Mixtral); hit_rate -> {s['hit_rate']:.3f}")

    # ---- 5. deployed with overlap (beyond paper) ----------------------
    s2 = deployed(*sized, device=device)["stats"]
    print(f"LFU + spec prefetch + overlap: modeled "
          f"{s2['sim_tokens_per_s']:.2f} tok/s "
          f"(vs {s['sim_tokens_per_s']:.2f} without overlap)")
    return {"losses": losses, "trace": tr, "policies": table,
            "speculative": s, "deployed": s2}


if __name__ == "__main__":
    main()
