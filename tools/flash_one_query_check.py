#!/usr/bin/env python3
"""Quick check of the flash forward's one-query route on one GPU.

    python3 tools/flash_one_query_check.py                # from a checkout
    python3 tools/flash_one_query_check.py --turns DIR    # and engine turns

Builds the port's CUDA kernels (``ops.build_kernels``), prints the
``ptxas`` records of the route's kernels (``flash_fwd_one_query<EPT>``,
``flash_fwd_one_query_bf16<EPT>``) and fails if one of
``ONE_QUERY_NO_SPILL`` spills, then runs ``chip_smoke.py``'s checks of
the route in fp32 and bf16: the engines' one-query cross calls held
against the plain version and float64, launched twice for bitwise equal
outputs, row and head independent, and timed in CUDA graphs beside the
tile kernel of the dtype, the plain version, SDPA and the byte bound
(``one_query_cross`` / ``bf16_one_query``); every ``FLASH_SHAPES`` entry
that takes the route held the same way; the 8-row independence check
(``one_query_independence``); the split-length and row-cut sweeps
(``one_query_sweep``, one a dtype). Then the route's parts at the
engines' calls in both dtypes (``route_parts``): the tickets' memset and
the kernel, each by its device time under ``torch.profiler``, and the
kernel built again from a copy of the source with the combine cut out
(into ``build/``), whose difference is the combine's time. One JSON line
each.

``--turns DIR`` then builds DIR's flash source (another commit, unpacked
with ``git archive``) into DIR's ``build/``, holds this checkout's fp32
route bitwise against DIR's at the fp32 calls above and compares the two
``flash_fwd_one_query<EPT>`` ptxas records (``parent_fp32``), and times
the engines that launch the route: ``chip_smoke.family_phase`` for
Whisper-tiny and Llama-3.2-Vision (fp32: each ``ServingEngine``'s decode
loop, ``engine_s``, and the loop again under ``torch.profiler``), and
this checkout's ``family_phase`` for both in their configs' bf16
(``engine_s`` and its profiled run; on DIR's ``src`` with ``routed``
False where DIR's plan leaves bf16 calls to the tile kernel), once per
turn in a process of its own, from DIR and from this checkout in turns
(DIR, this, this, DIR), on the same card. DIR's kernels build into DIR's
own ``build/``.

Exits non-zero without a GPU or on a failed check.
"""
import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ENGINE_ARCHS = ("whisper-tiny", "llama-3.2-vision-11b")
# the line the combine follows in flash_fwd_one_query's source: the
# (row, KV head)'s last split to finish goes on to combine them all
COMBINE = "  if (!*flag) return;\n"


def this_chip_smoke():
    """This checkout's ``chip_smoke.py`` as a module of its own name, for
    a turn whose ``chip_smoke`` is another checkout's."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def engine_turn(root: Path) -> dict:
    """``engine_s`` of ENGINE_ARCHS' ``family_phase`` (fp32) from the
    checkout ``root`` (its ``chip_smoke.py`` and ``src``), in this
    process, then each engine in its config's bf16 through this
    checkout's ``family_phase`` on ``root``'s ``src``; then each fp32
    phase again with the engine's decode loop
    (``ServingEngine.generate_batch``) under ``torch.profiler``: its
    device time by kind, busy and idle share (``device_time_summary``;
    the profiler slows the host, so that run's wall is not engine_s)."""
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch
    import chip_smoke
    from repro_torch.kernels import ops
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash_mod
    check = chip_smoke.check
    check(Path(chip_smoke.__file__).resolve().parent == root.resolve(),
          f"chip_smoke imported from {chip_smoke.__file__}, not {root}")
    here = this_chip_smoke()
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
    # whether root's plan sends a bf16 one-query call to the route
    routed = flash_mod.one_query_plan(1, 1500, 6, 6, 64, 64,
                                      torch.bfloat16) is not None
    for arch in ENGINE_ARCHS:
        rep = here.family_phase(arch, ops, "", lambda *a, **k: [], False,
                                dtype=get_config(arch).dtype, routed=routed)
        out[arch]["bf16"] = {k: rep["engine"][k] for k in (
            "engine_s", "engine_launches", "engine_routes",
            "profiled_engine")}
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


def built_entry(ops, flash_mod, src: Path, out: Path, name: str):
    """``flash_mod.SYMBOL`` of ``src`` (with the headers beside it in
    ``src``'s directory) compiled by nvcc into ``out``: (the bound C
    entry, the ptxas records of its kernels)."""
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"lib{name}.so"
    run = subprocess.run([ops._nvcc(), *ops.NVCC_FLAGS, "-o", str(lib),
                          str(src)], capture_output=True, text=True)
    if run.returncode != 0:
        sys.exit(f"flash_one_query_check.py: nvcc of {src} failed:\n"
                 f"{run.stdout[-3000:]}{run.stderr[-3000:]}")
    fn = getattr(ctypes.CDLL(str(lib)), flash_mod.SYMBOL)
    fn.argtypes = flash_mod.ARGTYPES
    fn.restype = ctypes.c_int
    return fn, ops.ptxas_kernels(run.stdout + run.stderr)


def route_parts(ops, flash_mod, shapes):
    """The route's parts at each (B, Sk, H, hd, dtype) of ``shapes`` (no
    mask, seeded): 20 launcher calls under ``torch.profiler``, the
    device time a call of the tickets' ``torch.zeros`` (its fill kernel)
    and of the route's kernel; the same for the route built from a copy
    of the source without its combine (the last block returns as the
    others do), whose kernel time less the shipped one's is the
    combine's; and the whole launcher call in a CUDA graph of 20
    (``device_ms``). Returns one record a shape."""
    import numpy as np
    import torch
    from chip_smoke import check, device_ms
    src = (ops.CSRC / flash_mod.SOURCE).read_text()
    check(src.count(COMBINE) == 1, "the combine's branch is not where "
                                   "route_parts looks for it")
    copy = ROOT / "build" / "flash_one_query_no_combine"
    copy.mkdir(parents=True, exist_ok=True)
    for header in ops.CSRC.glob("*.cuh"):
        (copy / header.name).write_text(header.read_text())
    (copy / flash_mod.SOURCE).write_text(src.replace(COMBINE,
                                                     "  return;\n"))
    cut, _ = built_entry(ops, flash_mod, copy / flash_mod.SOURCE, copy,
                         "flash_no_combine")
    fn = ops._entry("flash_attention")
    rng = np.random.default_rng(7)
    out = []
    for B, Sk, H, hd, dt in shapes:
        dtype = getattr(torch, dt)
        q, k, v = (torch.from_numpy(rng.normal(size=s).astype(
            np.float32)).cuda().to(dtype)
            for s in ((B, 1, H, hd), (B, Sk, H, hd), (B, Sk, H, hd)))
        rec = {"shape": [B, 1, Sk, H, H, hd, hd, dt],
               "keys_per_split": flash_mod.plan_of(q, k, v)}
        for which, entry in (("shipped", fn), ("no_combine", cut)):
            def call():
                return flash_mod.launch(entry, q, k, v, causal=False,
                                        window=0)
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            for _ in range(20):
                call()
            torch.cuda.synchronize()
            prof.stop()
            by = {}
            for ev in prof.events():
                if ev.device_type == torch.autograd.DeviceType.CUDA:
                    name = ("route" if "one_query" in ev.name else
                            "memset" if "Fill" in ev.name
                            or "emset" in ev.name else ev.name[:60])
                    by[name] = by.get(name, 0.0) \
                        + ev.time_range.elapsed_us() / 1e3 / 20
            check("route" in by, f"route_parts {rec['shape']}: the "
                                 f"profiler saw no route kernel: {by}")
            rec[which] = {"device_ms_a_call": by,
                          "graph_ms": device_ms(call, 20, graph=True)}
        rec["combine_ms"] = (rec["shipped"]["device_ms_a_call"]["route"]
                             - rec["no_combine"]["device_ms_a_call"]
                             ["route"])
        out.append(rec)
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
    from chip_smoke import (BF16_TOL, FLASH_SHAPES, ONE_QUERY_CROSS, TOL,
                            agree, card_line, check, device_ms,
                            one_query_checks, one_query_cross,
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
    routed = []   # (q, k, v, kw) of every FLASH_SHAPES entry on the route
    for B, Sq, Sk, H, KV, hd, vd, causal, window, dt in FLASH_SHAPES:
        dtype = getattr(torch, dt)
        if flash_mod.one_query_plan(Sq, Sk, H, KV, hd, vd, dtype) is None:
            continue
        q, k, v = (torch.from_numpy(rng.normal(size=s).astype(
            np.float32)).cuda().to(dtype)
            for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, vd)))
        kw = dict(causal=causal, window=window)
        shape = [B, Sq, Sk, H, KV, hd, vd, causal, window, dt]
        got = ops.flash_attention(q, k, v, **kw)
        err, _ = agree("flash_attention", got,
                       flash_mod.plain(q.float(), k.float(), v.float(),
                                       **kw),
                       BF16_TOL if dt == "bfloat16"
                       else TOL["flash_attention"],
                       f"flash_attention at {shape}")
        print(json.dumps({"shape": shape, "max_abs_err": err,
                          **one_query_checks(ops, q, k, v, got, kw, shape)}),
              flush=True)
        routed.append((q, k, v, kw))
    print(json.dumps(one_query_independence()), flush=True)
    for dt in ("float32", "bfloat16"):
        print(json.dumps({"one_query_sweep": one_query_sweep(floor_ms, dt),
                          "card": card}), flush=True)
    print(json.dumps({"route_parts": route_parts(
        ops, flash_mod, [(*s, dt) for dt in ("float32", "bfloat16")
                         for s in ONE_QUERY_CROSS]), "card": card}),
        flush=True)

    if args.turns is not None:
        # the fp32 route against the parent's: bitwise, same ptxas
        parent, parent_ptxas = built_entry(
            ops, flash_mod, args.turns / "src" / "repro_torch" / "kernels" /
            "csrc" / flash_mod.SOURCE, args.turns / "build",
            "flash_parent")
        fn = ops._entry("flash_attention")
        calls = [(q, k, v, kw) for q, k, v, kw in routed
                 if q.dtype == torch.float32]
        for B, Sk, H, hd in ONE_QUERY_CROSS:
            q, k, v = (torch.from_numpy(rng.normal(size=s).astype(
                np.float32)).cuda() for s in ((B, 1, H, hd), (B, Sk, H, hd),
                                              (B, Sk, H, hd)))
            calls.append((q, k, v, dict(causal=False, window=0)))
        same = [torch.equal(flash_mod.launch(fn, q, k, v, **kw),
                            flash_mod.launch(parent, q, k, v, **kw))
                for q, k, v, kw in calls]
        mine = [r for r in ops.ptxas_kernels(ops.build_log("flash_attention"))
                if r["kernel"].startswith("flash_fwd_one_query<")]
        theirs = [r for r in parent_ptxas
                  if r["kernel"].startswith("flash_fwd_one_query<")]
        print(json.dumps({"parent_fp32": {
            "calls": len(same), "bitwise_equal": all(same),
            "ptxas": mine, "parent_ptxas": theirs,
            "ptxas_equal": mine == theirs}, "card": card}), flush=True)
        check(all(same), f"fp32 one-query route differs from {args.turns}'s "
                         f"at {same.count(False)} of {len(same)} calls")
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
                       "device_busy_ms"] for t in turns],
                   "bf16_engine_s": [t[arch]["bf16"]["engine_s"]
                                     for t in turns],
                   "bf16_device_busy_ms": [t[arch]["bf16"][
                       "profiled_engine"]["device_busy_ms"] for t in turns],
                   "bf16_routes": [t[arch]["bf16"]["engine_routes"]
                                   for t in turns]}
            for arch in ENGINE_ARCHS}, "order": [t["root"] for t in turns],
            "card": card}), flush=True)
    print(f"card: {card}", flush=True)


if __name__ == "__main__":
    main()
