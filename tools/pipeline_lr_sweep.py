#!/usr/bin/env python3
"""Stage 1 of the paper's pipeline at Mixtral-8x7B's full widths on one
GPU, at several learning rates.

    python3 tools/pipeline_lr_sweep.py      # from the root of a checkout

Runs ``repro_torch.examples.offload_paper_pipeline.train_model`` (dense
MoE path, batch 8 x 64, ``lm_batches`` from seed 0, fp32 params drawn
on the card from seed 0) on Mixtral-8x7B cut to 2 of 32 layers, once for
each (steps, lr) of ``RUNS``, and prints one JSON line a run: the card,
every loss, the median step time after the first (wall clock after a
synchronize) and the peak device memory. What chose the learning rate
of ``chip_smoke.py``'s pipeline run (``PIPELINE_LR``). Exits non-zero
without a GPU.
"""
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUNS = [(20, 1e-4), (20, 3e-4), (20, 1e-3), (100, 2e-3)]


def main():
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("pipeline_lr_sweep.py: this script needs a CUDA GPU")
    from repro_torch.configs import get_config
    from repro_torch.examples import offload_paper_pipeline as pipe
    from repro_torch.kernels import ops

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    ops.build_kernels()
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=2,
                              dtype="float32")
    train = pipe.train
    for steps, lr in RUNS:
        stamps = []

        def after_step(i, params, loss):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        pipe.train = lambda *a, **kw: train(*a, callback=after_step, **kw)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            params, losses = pipe.train_model(cfg, steps=steps, batch=8,
                                              seq=64, lr=lr, device="cuda")
        finally:
            pipe.train = train
        ms = [(b - a) * 1e3 for a, b in zip([t0] + stamps, stamps)]
        rest = sorted(ms[1:])
        print(json.dumps({
            "card": card, "steps": steps, "lr": lr, "losses": losses,
            "last_below_first": losses[-1] < losses[0],
            "first_step_ms": ms[0], "median_step_ms": rest[len(rest) // 2],
            "peak_device_bytes": torch.cuda.max_memory_allocated()}),
            flush=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
