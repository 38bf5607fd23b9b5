#!/usr/bin/env python3
"""Quick check of the flash forward's one-query route on one GPU.

    python3 tools/flash_one_query_check.py                # from a checkout
    python3 tools/flash_one_query_check.py --turns DIR    # and engine turns

Builds the port's CUDA kernels (``ops.build_kernels``), prints the
``ptxas`` records of the route's kernels (``flash_fwd_one_query<EPT>``)
and fails if one of ``ONE_QUERY_NO_SPILL`` spills, then runs
``chip_smoke.py``'s checks of the route: the engines' one-query cross
calls held against the plain version and float64, launched twice for
bitwise equal outputs, row and head independent, and timed in CUDA
graphs beside the plain version, SDPA and the byte bound
(``one_query_cross``, with the bf16 one-query shapes beside SDPA's bf16
call); every fp32 ``FLASH_SHAPES`` entry that takes the route held the
same way; the 8-row independence check (``one_query_independence``); the
split-length and row-cut sweeps (``one_query_sweep``). One JSON line
each.

``--turns DIR`` then times the engines that launch the route:
``chip_smoke.family_phase`` for Whisper-tiny and Llama-3.2-Vision (each
``ServingEngine``'s decode loop, ``engine_s``), once per turn in a
process of its own, from the checkout DIR (another commit, unpacked with
``git archive``) and from this one in turns (DIR, this, this, DIR), on
the same card. DIR's kernels build into DIR's own ``build/``.

Exits non-zero without a GPU or on a failed check.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ENGINE_ARCHS = ("whisper-tiny", "llama-3.2-vision-11b")


def engine_turn(root: Path) -> dict:
    """``engine_s`` of ENGINE_ARCHS' ``family_phase`` from the checkout
    ``root`` (its ``chip_smoke.py`` and ``src``), in this process; then
    each phase again with the engine's decode loop
    (``ServingEngine.generate_batch``) under ``torch.profiler``: its
    device time by kind, busy and idle share (``device_time_summary``;
    the profiler slows the host, so that run's wall is not engine_s)."""
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch
    import chip_smoke
    from repro_torch.kernels import ops
    check = chip_smoke.check
    check(Path(chip_smoke.__file__).resolve().parent == root.resolve(),
          f"chip_smoke imported from {chip_smoke.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    ops.build_kernels()
    out = {"root": str(root), "build_s": time.perf_counter() - t0}
    for arch in ENGINE_ARCHS:
        rep = chip_smoke.family_phase(arch, ops, "", lambda *a, **k: [],
                                      False)
        out[arch] = {"engine_s": rep["engine"]["engine_s"],
                     "engine_launches": rep["engine"]["engine_launches"],
                     "engine_routes": rep["engine"].get("engine_routes")}
    from repro_torch.serving.engine import ServingEngine
    run, traced = ServingEngine.generate_batch, {}

    def profiled(self, *args, **kw):
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof.start()
        outs = run(self, *args, **kw)
        torch.cuda.synchronize()
        prof.stop()
        traced["engine"] = chip_smoke.device_time_summary(
            prof, (time.perf_counter() - t0) * 1e3)
        return outs

    ServingEngine.generate_batch = profiled
    for arch in ENGINE_ARCHS:
        chip_smoke.family_phase(arch, ops, "", lambda *a, **k: [], False)
        out[arch]["profiled_engine"] = traced.pop("engine")
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--turns", type=Path, default=None,
                        help="a checkout to time the engines against")
    parser.add_argument("--engine-turn", type=Path, default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.engine_turn is not None:
        print(json.dumps({"engine_turn": engine_turn(args.engine_turn)}),
              flush=True)
        return
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_one_query_check.py: this script needs a CUDA GPU")
    from chip_smoke import (FLASH_SHAPES, TOL, agree, card_line, check,
                            device_ms, one_query_checks, one_query_cross,
                            one_query_independence, one_query_sweep)
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    ops.build_kernels()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    recs = [r for r in ops.ptxas_kernels(ops.build_log("flash_attention"))
            if r["kernel"] in flash_mod.ONE_QUERY_NO_SPILL]
    print(json.dumps({"ptxas_kernels": recs}), flush=True)
    check(len(recs) == len(flash_mod.ONE_QUERY_NO_SPILL)
          and not any(r["stack"] or r["spill_stores"] or r["spill_loads"]
                      for r in recs),
          f"one-query kernels spill or are missing: {recs}")

    one = torch.zeros(1, device="cuda")
    floor_ms = device_ms(lambda: one.add_(1), 20, graph=True)
    cross, bf16 = one_query_cross(floor_ms)
    print(json.dumps({"one_query_cross": cross, "bf16_one_query": bf16,
                      "card": card}), flush=True)
    rng = np.random.default_rng(0)
    for B, Sq, Sk, H, KV, hd, vd, causal, window, dt in FLASH_SHAPES:
        if dt != "float32" or flash_mod.one_query_plan(
                Sq, Sk, H, KV, hd, vd, torch.float32) is None:
            continue
        q, k, v = (torch.from_numpy(rng.normal(size=s).astype(
            np.float32)).cuda() for s in ((B, Sq, H, hd), (B, Sk, KV, hd),
                                          (B, Sk, KV, vd)))
        kw = dict(causal=causal, window=window)
        shape = [B, Sq, Sk, H, KV, hd, vd, causal, window]
        got = ops.flash_attention(q, k, v, **kw)
        err, _ = agree("flash_attention", got,
                       flash_mod.plain(q, k, v, **kw), TOL["flash_attention"],
                       f"flash_attention at {shape}")
        print(json.dumps({"shape": shape, "max_abs_err": err,
                          **one_query_checks(ops, q, k, v, got, kw, shape)}),
              flush=True)
    print(json.dumps(one_query_independence()), flush=True)
    print(json.dumps({"one_query_sweep": one_query_sweep(floor_ms),
                      "card": card}), flush=True)

    if args.turns is not None:
        turns = []
        for root in (args.turns, ROOT, ROOT, args.turns):
            run = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()),
                 "--engine-turn", str(root.resolve())],
                capture_output=True, text=True, timeout=900)
            check(run.returncode == 0, f"engine turn at {root} failed:\n"
                                       f"{run.stdout[-2000:]}\n"
                                       f"{run.stderr[-4000:]}")
            line = [x for x in run.stdout.splitlines()
                    if x.startswith('{"engine_turn"')][-1]
            turns.append(json.loads(line)["engine_turn"])
            print(line, flush=True)
        print(json.dumps({"engine_turns": {
            arch: {"engine_s": [t[arch]["engine_s"] for t in turns],
                   "device_busy_ms": [t[arch]["profiled_engine"][
                       "device_busy_ms"] for t in turns]}
            for arch in ENGINE_ARCHS}, "order": [t["root"] for t in turns],
            "card": card}), flush=True)
    print(f"card: {card}", flush=True)


if __name__ == "__main__":
    main()
