"""Quickstart (port of ``examples/quickstart.py``): train a tiny
Mixtral-family MoE on the synthetic LM, then serve it with offloaded
experts under LRU vs LFU caching.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, Sequence

from repro_torch.examples.offload_paper_pipeline import (
    pipeline_config, plain_values, train_model)
from repro_torch.launch import require_device
from repro_torch.serving.offload_serving import OffloadServer

PROMPT = [5, 17, 42, 7]


def serve_policies(params, cfg, prompt: Sequence[int], new: int,
                   slots: int, *, device="cuda") -> Dict:
    """One ``OffloadServer`` per policy (LRU, then LFU), ``slots``
    experts cached a layer: ``{policy: {"tokens", "stats"}}``, tokens
    being the prompt and its ``new`` greedy tokens."""
    out = {}
    for policy in ("lru", "lfu"):
        srv = OffloadServer(params, cfg, cache_slots=slots, policy=policy,
                            device=device)
        tokens = srv.complete(prompt, max_new=new)
        out[policy] = {"tokens": tokens, "stats": plain_values(srv.stats())}
        del srv   # its slot buffers go before the next server's
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = require_device(ap.parse_args(argv).device)

    # 1. a reduced Mixtral-8x7B (same family, laptop-sized)
    cfg = pipeline_config()

    # 2. train briefly on the synthetic Markov LM
    params, losses = train_model(cfg, steps=80, batch=8, seq=64, lr=2e-3,
                                 log_every=40, device=device)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")

    # 3. serve with offloaded experts: cache 4 of 8 per layer
    served = serve_policies(params, cfg, PROMPT, 24, 4, device=device)
    for policy, r in served.items():
        s = r["stats"]
        print(f"\n[{policy.upper()}] generated: {r['tokens'][len(PROMPT):]}")
        print(f"  hit_rate={s['hit_rate']:.3f} "
              f"precision={s['cache_precision']:.3f} "
              f"recall={s['cache_recall']:.3f} "
              f"modeled_tok/s={s['sim_tokens_per_s']:.2f}")
    print("\n(the generated tokens are identical: caching is "
          "bit-transparent — only speed changes)")
    return {"losses": losses, "served": served}


if __name__ == "__main__":
    main()
