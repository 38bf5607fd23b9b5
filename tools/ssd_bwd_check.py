#!/usr/bin/env python3
"""Quick check of the port's SSD chunk backward kernel on one GPU.

    python3 tools/ssd_bwd_check.py        # from the root of a checkout

Builds the port's CUDA kernels (``ops.build_kernels``), prints the
backward's ``ptxas`` report, holds ``ssd_chunk_bwd`` against autograd of
the plain version (``ssd_chunk.plain_bwd``) at Mamba2-2.7B's training
call (G 16 chunks of 256, 80 heads of 64, state 128), at Jamba-1.5-Large's
published SSD shape (G 32 chunks of 128, 256 heads) and at the coverage
shapes of ``chip_smoke.py``, one JSON line a shape (max |kernel - plain|
/ max |plain| for d dA, d xw, d Bm, d Cm; seeded inputs, dA < 0). At the
first two it also holds the kernel and the plain version against a
float64 evaluation, launches the kernel twice for bitwise equal outputs,
times both with CUDA events, and times each of the kernel's launches
(``ssd_bwd_<name>_kernel``) with ``torch.profiler``, each beside its
TFLOP/s: the useful operations of its products at that shape (the
launches without a product print none). The short first call for a change
to the kernel, before ``chip_smoke.py``. Exits non-zero without a GPU, on
a mismatch or on a second launch that differs.
"""
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (G, Q, H, P, N, dA scale); the first two are timed
SHAPES = [(16, 256, 80, 64, 128, 0.1), (32, 128, 256, 64, 128, 0.1),
          (1, 64, 6, 32, 16, 0.1), (2, 100, 6, 32, 64, 0.1),
          (3, 37, 5, 72, 130, 0.1), (2, 1024, 8, 64, 128, 0.1),
          (2, 100, 3, 37, 20, 0.1), (1, 70, 2, 21, 37, 0.1),
          (2, 256, 1, 64, 128, 0.1), (2, 256, 8, 64, 128, 1.0),
          (1, 4096, 2, 64, 128, 0.1)]
TOL = 2e-5   # max |kernel - plain| <= TOL x max |plain|, each gradient


def launch_flops(G, Q, H, P, N):
    """The useful operations of each launch's products (2 a multiply-add;
    the causal ones over the Q (Q + 1) / 2 pairs at or below the
    diagonal): scores C.B^T; dxw U = dS.B and M^T dY; pairs dM = dY.xw^T;
    dbdc dC, dB and dB's state term."""
    tri = Q * (Q + 1) // 2
    return {"scores": 2 * G * tri * N,
            "dxw": 2 * G * H * (Q * P * N + tri * P),
            "pairs": 2 * G * H * tri * P,
            "dbdc": 2 * G * (2 * tri * N + H * Q * P * N)}


def timed_ms(fn, iters=10):
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    if not torch.cuda.is_available():
        sys.exit("ssd_bwd_check.py: this script needs a CUDA GPU")
    from chip_smoke import ssd_bwd_float64
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_chunk as ssd_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    built = ops.build_kernels()
    for line in built.get("ssd_chunk_bwd", {}).get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("ptxas", line.strip())
    fn = ops._entry("ssd_chunk_bwd")
    rng = np.random.default_rng(0)

    def rand(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.normal(size=shape) * scale).astype(np.float32)).cuda()

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()
                     / b.double().abs().max())

    names = ("d_dA", "d_xw", "d_Bm", "d_Cm")
    ok = True
    for i, (G, Q, H, P, N, scale) in enumerate(SHAPES):
        dA = -rand(G, Q, H, scale=scale).abs()
        xw, Bm, Cm = rand(G, Q, H, P), rand(G, Q, N), rand(G, Q, N)
        dY, dS = rand(G, Q, H, P), rand(G, H, P, N)
        args = (dA, xw, Bm, Cm, dY, dS)
        got = ssd_mod.launch_bwd(fn, *args)
        want = ssd_mod.plain_bwd(*args)
        torch.cuda.synchronize()
        rec = {"shape": [G, Q, H, P, N, scale],
               "rel_err": dict(zip(names, (rel(a, b)
                                           for a, b in zip(got, want)))),
               "finite": all(bool(torch.isfinite(g).all()) for g in got)}
        w64 = ssd_bwd_float64(*args)
        rec["vs_float64"] = {n: {"kernel": rel(g, w), "plain": rel(p, w)}
                             for n, g, p, w in zip(names, got, want, w64)}
        del w64
        # a 4096-position chunk: the plain version's fp32 cumsum is off the
        # exact sums (as for the forward), so the kernel is held to float64
        worst = (max(v["kernel"] for v in rec["vs_float64"].values())
                 if Q == 4096 else max(rec["rel_err"].values()))
        rec["ok"] = rec["finite"] and worst <= TOL
        ok &= rec["ok"]
        if i < 2:
            again = ssd_mod.launch_bwd(fn, *args)
            rec["bitwise_repeat"] = all(torch.equal(a, b)
                                        for a, b in zip(got, again))
            ok &= rec["bitwise_repeat"]
            rec["ms"] = timed_ms(lambda: ssd_mod.launch_bwd(fn, *args))
            rec["plain_ms"] = timed_ms(lambda: ssd_mod.plain_bwd(*args),
                                       iters=3)
            act = torch.profiler.ProfilerActivity
            with torch.profiler.profile(activities=[act.CUDA]) as prof:
                for _ in range(3):
                    ssd_mod.launch_bwd(fn, *args)
                torch.cuda.synchronize()
            # each launch's mean over the events the trace kept (a trace
            # may keep fewer than the three calls made)
            seen = {}
            for ev in prof.events():
                if ev.device_type == DeviceType.CUDA and "ssd_bwd" in ev.name:
                    name = re.search(r"ssd_bwd_(\w+?)_kernel",
                                     ev.name).group(1)
                    us, n = seen.get(name, (0.0, 0))
                    seen[name] = (us + ev.time_range.elapsed_us(), n + 1)
            per = {name: us / n / 1e3 for name, (us, n) in seen.items()}
            rec["launch_ms"] = per
            rec["launch_events"] = {name: n for name, (_, n) in seen.items()}
            flops = launch_flops(G, Q, H, P, N)
            rec["launch_tflops"] = {name: flops[name] / ms / 1e9
                                    for name, ms in per.items()
                                    if name in flops}
            rec["tflops"] = sum(flops.values()) / rec["ms"] / 1e9
        print(json.dumps(rec), flush=True)
        del got, want, args
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
