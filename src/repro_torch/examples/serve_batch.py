"""Batched serving comparison (port of ``examples/serve_batch.py``):
on-device engine vs offload server vs continuous-batching offload
serving, on two architectures (dense qwen + MoE mixtral), with sampling.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_batch [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Sequence

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.examples.offload_paper_pipeline import plain_values
from repro_torch.launch import require_device
from repro_torch.models import transformer as tf
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.offload_serving import (ContinuousOffloadServer,
                                                 OffloadServer)

PROMPTS = [[1, 2, 3], [7, 8, 9, 10], [42]]
NEW = 8


def configs():
    """(dense qwen2.5-3b at 2 layers, d_model 128; mixtral-8x7b at 3
    layers, d_model 128, 8 experts top-2), both fp32."""
    cfg_d = dataclasses.replace(
        reduced(get_config("qwen2.5-3b"), layers=2, d_model=128),
        dtype="float32")
    cfg_m = dataclasses.replace(
        reduced(get_config("mixtral-8x7b"), layers=3, d_model=128,
                experts=8),
        dtype="float32", num_experts_per_tok=2)
    return cfg_d, cfg_m


def dense_batch(params, cfg, prompts: Sequence[Sequence[int]], new: int, *,
                device="cuda"):
    """Every weight on the device, one static batch, sampled at T=0.8,
    top-p 0.9, seed 0: the new tokens of each prompt."""
    eng = ServingEngine(params, cfg, cache_len=64, device=device)
    return eng.generate_batch(prompts, max_new=new, temperature=0.8,
                              top_p=0.9, seed=0)


def offload_solo(params, cfg, prompts: Sequence[Sequence[int]], new: int, *,
                 device="cuda") -> Dict:
    """One request at a time through an ``OffloadServer`` (LFU, 4 slots,
    speculative prefetch, overlap), greedy: each prompt's new tokens and
    the server's ``stats()``."""
    srv = OffloadServer(params, cfg, cache_slots=4, policy="lfu",
                        prefetch="spec", overlap=True, device=device)
    outs = [srv.complete(p, max_new=new, temperature=0.0)[len(p):]
            for p in prompts]
    return {"outs": outs, "stats": plain_values(srv.stats())}


def continuous(params, cfg, prompts: Sequence[Sequence[int]], new: int, *,
               device="cuda") -> Dict:
    """The same model, continuous batching: all requests share a batch
    of 2 and the per-layer expert caches (paged KV), joining and retiring
    at token boundaries: each prompt's new tokens and per-request
    ``hit_rate``, and the server's ``stats()``."""
    srv = ContinuousOffloadServer(params, cfg, cache_slots=4, policy="lfu",
                                  prefetch="spec", overlap=True, max_batch=2,
                                  cache_len=32, device=device)
    rids = [srv.submit(p, max_new=new) for p in prompts]
    srv.run()
    return {"rids": rids,
            "outs": [srv.result(r)[len(p):] for p, r in zip(prompts, rids)],
            "request_hit_rate": [plain_values(srv.request_stats(r)["hit_rate"])
                                 for r in rids],
            "stats": plain_values(srv.stats())}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = require_device(ap.parse_args(argv).device)
    cfg_d, cfg_m = configs()

    # dense arch: plain batched on-device decode
    params_d = tf.init_params(
        cfg_d, torch.Generator(device=device).manual_seed(0), device=device)
    dense = dense_batch(params_d, cfg_d, PROMPTS, NEW, device=device)
    print("qwen2.5 (device, batched, T=0.8/top_p=0.9):")
    for p, o in zip(PROMPTS, dense):
        print(f"  {p} -> {o}")

    # MoE arch: offload mode, per-request stats
    params_m = tf.init_params(
        cfg_m, torch.Generator(device=device).manual_seed(1), device=device)
    solo = offload_solo(params_m, cfg_m, PROMPTS, NEW, device=device)
    print("\nmixtral (offloaded experts, LFU + overlapped spec prefetch):")
    for p, o in zip(PROMPTS, solo["outs"]):
        print(f"  {p} -> {o}")
    s = solo["stats"]
    print(f"  hit={s['hit_rate']:.3f} spec_P={s['spec_precision']:.3f} "
          f"modeled tok/s={s['sim_tokens_per_s']:.1f}")

    # same MoE model, continuous batching: all three requests share the
    # batch and the per-layer expert caches; joins/retires happen at
    # token boundaries, outputs are identical to solo decoding
    cont = continuous(params_m, cfg_m, PROMPTS, NEW, device=device)
    print("\nmixtral (continuous batching, 3 requests over 2 slots):")
    for p, rid, o, hit in zip(PROMPTS, cont["rids"], cont["outs"],
                              cont["request_hit_rate"]):
        print(f"  req {rid}: {p} -> {o}  (per-request hit={hit:.3f})")
    cs = cont["stats"]
    print(f"  shared cache: hit={cs['hit_rate']:.3f} "
          f"steps={cs['decode_steps']} "
          f"modeled tok/s={cs['sim_tokens_per_s']:.1f} "
          f"(vs {s['sim_tokens_per_s']:.1f} sequential)")
    return {"dense": dense, "solo": solo, "continuous": cont}


if __name__ == "__main__":
    main()
