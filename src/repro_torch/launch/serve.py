"""Serving launcher (port of ``repro.launch.serve``): offload mode (the
paper's deployment) or plain on-device batched decode, on a reduced
arch, fp32, random weights drawn from ``--seed``.

Example (paper mode, LFU + speculative prefetch):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
      --cache-slots 4 --policy lfu --prefetch spec --tokens 64 \
      [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.launch import require_device
from repro_torch.models import transformer as tf
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.offload_serving import OffloadServer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--mode", choices=["offload", "device"], default="offload")
    ap.add_argument("--policy", default="lru")
    ap.add_argument("--prefetch", default=None,
                    choices=[None, "spec", "markov", "learned"])
    ap.add_argument("--cache-slots", type=int, default=4)
    ap.add_argument("--quant", default="none", choices=["none", "int8"])
    ap.add_argument("--overlap", action="store_true")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced(get_config(args.arch), layers=args.layers,
                  d_model=args.d_model)
    cfg = dataclasses.replace(cfg, dtype="float32")
    if args.mode == "offload" and not cfg.is_moe:
        raise SystemExit(f"{args.arch} has no experts to offload")
    device = require_device(args.device)
    params = tf.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed),
        device=device)
    prompt = [1, 2, 3, 4, 5, 6, 7, 8]

    if args.mode == "offload":
        srv = OffloadServer(params, cfg, cache_slots=args.cache_slots,
                            policy=args.policy, prefetch=args.prefetch,
                            quant=args.quant, overlap=args.overlap,
                            device=device)
        out = srv.complete(prompt, max_new=args.tokens)
        print("tokens:", out)
        for k, v in srv.stats().items():
            print(f"  {k:22s} {v}")
        print(srv.render_trace(layer=min(1, cfg.num_layers - 1)))
    else:
        eng = ServingEngine(params, cfg, cache_len=len(prompt) + args.tokens,
                            device=device)
        outs = eng.generate_batch([prompt, prompt[::-1]], max_new=args.tokens)
        for o in outs:
            print("tokens:", o)


if __name__ == "__main__":
    main()
