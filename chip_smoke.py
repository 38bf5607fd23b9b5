#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py          # from the root of a checkout

It drives the port's main path end to end and checks it:

1. prints the card (``nvidia-smi`` name and power limit);
2. builds every CUDA kernel of the path from ``src/repro_torch/kernels/csrc``;
3. builds Mixtral-8x7B at its full published widths (d_model 4096,
   32 heads / 8 KV heads, expert d_ff 14336, 8 experts top-2, vocab
   32000) with the depth cut to 2 layers, fp32, random weights drawn on
   the card from a seeded generator; the expert masters go to pinned
   host memory one expert at a time;
4. serves 4 staggered requests (32-token prompts, 16 greedy tokens
   each) through ``ContinuousOffloadServer`` (LFU cache of 4 slots a
   layer, speculative prefetch, max_batch 4, paged KV in 16-token
   blocks), with every kernel's launch count reset just before and read
   just after;
5. checks each request's tokens against ``OffloadEngine.generate`` on
   the card (dense KV, plain attention) and the last logits for finite
   values of the right shape;
6. holds each kernel wrapper (``ops.moe_ffn``, ``ops.paged_attention``)
   against its plain PyTorch version on the card, on the arguments of
   the run's heaviest call (most expert rows; most visible keys), and
   times both (CUDA events after a warm-up) beside the card's bound for
   the same work;
7. holds each wrapper against its plain version on further shapes the
   main path does not give it: ragged C/d/F, C above 8 rows, several
   contraction slices, widths that take the 4-byte loads, other query
   heads per KV head (1 to 16), head dims up to 256 and a row with no
   visible key.

Any failed check raises, so the script exits non-zero. The output ends
with the card line, a ``kernels`` JSON line and the result line
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout (no ``src/repro_torch`` beside the script), it exits non-zero
before printing any result.

    python3 chip_smoke.py --profile

does the same with ``torch.profiler`` tracing the serving loop, and
prints a ``profile`` line: the device time of the loop by kind (expert
copies host-to-device, each kernel, the rest), the device's busy and
idle shares of the loop's wall time, and the copy rate. The profiler
slows the host, so that run's step times are not the ones to quote.
"""
import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

SEED = 0
PROMPT_LEN, NEW_TOKENS = 32, 16
SUBMIT_AT_STEP = (0, 0, 6, 12)      # one entry per request: staggered joins
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12            # H100 SXM, fp32 outside tensor cores
TOL = {"moe_ffn": 1e-4, "paged_attention": 2e-4}   # rtol = atol, fp32
# further shapes for step 7: (E, C, d, F), the CPU tests' moe_ffn shapes
# then C > 8 rows over several ragged contraction slices (4- and 16-byte
# loads); (B, H, KV, hd, N, bs, T), the CPU tests' paged shapes then 3, 5,
# 12 and 16 query heads per KV head and head dims 40, 72, 256
MOE_SHAPES = [(2, 32, 128, 256), (4, 96, 128, 384), (3, 40, 256, 512),
              (1, 8, 128, 128), (2, 12, 130, 96), (1, 5, 64, 500),
              (2, 7, 100, 130), (4, 3, 200, 640), (3, 9, 2500, 1100),
              (2, 17, 1030, 2050)]
PAGED_SHAPES = [(2, 4, 2, 64, 8, 8, 3), (3, 4, 4, 64, 10, 16, 2),
                (1, 8, 1, 128, 6, 8, 4), (2, 6, 2, 40, 20, 8, 9),
                (3, 15, 3, 72, 9, 4, 6), (2, 12, 1, 128, 12, 16, 4),
                (2, 16, 1, 256, 12, 16, 5)]
SOURCES = {  # kernel -> (CUDA source, the TPU kernel it replaces)
    "moe_ffn": ("src/repro_torch/kernels/csrc/moe_gemm.cu",
                "src/repro/kernels/moe_gemm.py:40"),
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:70"),
}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_ms(fn, iters: int, *, graph: bool) -> float:
    """Milliseconds per call of ``fn`` on the device, by CUDA events
    after a warm-up. ``graph=True`` captures the ``iters`` calls in a
    CUDA graph first, so a kernel shorter than its host-side launch is
    timed on the device, not on the host."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def visible_keys(q, kp, vp, bt, pos):
    """Keys a paged_attention call reads: pos + 1 for each row."""
    return int((pos.long() + 1).clamp(max=bt.shape[1] * kp.shape[1]).sum())


def serve(srv, prompts, ops, prof=None):
    """Run the staggered workload; record each kernel wrapper's heaviest
    call (moe_ffn: most expert rows E*C; paged_attention: most visible
    keys), its small arguments copied as they were. Returns (rids,
    launches, per-step ms, per-step H2D bytes, recorded calls, loop ms).
    """
    import torch
    seen = {}

    def recording(name, wrapper, size, keep):
        def call(*args):
            n = size(*args)
            if name not in seen or n >= seen[name][0]:
                seen[name] = (n, keep(*args))
            return wrapper(*args)
        return call

    originals = (ops.moe_ffn, ops.paged_attention)
    ops.moe_ffn = recording(
        "moe_ffn", ops.moe_ffn, lambda x_e, *_: x_e.shape[0] * x_e.shape[1],
        # the slot buffers (GBs) are kept by reference
        lambda x_e, w1, w3, w2, slots: (x_e.clone(), w1, w3, w2,
                                        list(slots)))
    ops.paged_attention = recording(
        "paged_attention", ops.paged_attention, visible_keys,
        lambda *args: tuple(a.clone() for a in args))
    rids, step_ms, step_h2d = [], [], []
    try:
        ops.reset_launch_counts()
        if prof is not None:
            prof.start()
        torch.cuda.synchronize()
        t_loop = time.perf_counter()
        step = 0
        while len(rids) < len(prompts) or srv.pending:
            for i, at in enumerate(SUBMIT_AT_STEP):
                if at == step and len(rids) == i:
                    rids.append(srv.submit(prompts[i], max_new=NEW_TOKENS))
            h2d = sum(c.bytes_transferred for c in srv.engine.caches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv.step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            step_h2d.append(sum(c.bytes_transferred
                                for c in srv.engine.caches) - h2d)
            step += 1
        loop_ms = (time.perf_counter() - t_loop) * 1e3
        if prof is not None:
            prof.stop()
        launches = ops.launch_counts()
    finally:
        ops.moe_ffn, ops.paged_attention = originals
    return (rids, launches, step_ms, step_h2d,
            {k: v[1] for k, v in seen.items()}, loop_ms)


def device_time_summary(prof, loop_ms, h2d_bytes):
    """The profiled loop's device activity: milliseconds by kind, the
    union of all device intervals as the busy time, and the expert
    copies' rate (all host-to-device copy time counted, the few small
    index uploads included)."""
    from torch.autograd import DeviceType
    kinds = {"h2d_copy": 0.0, "other_copy": 0.0, "moe_ffn": 0.0,
             "paged_attention": 0.0, "other_kernels": 0.0}
    top, spans = {}, []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = ev.time_range.elapsed_us() / 1e3
        spans.append((ev.time_range.start, ev.time_range.end))
        name = ev.name
        if name.startswith("Memcpy HtoD"):
            kind = "h2d_copy"
        elif name.startswith(("Memcpy", "Memset")):
            kind = "other_copy"
        elif any(k in name for k in ("skinny_partial", "swiglu_finish",
                                     "sum_partials")):
            kind = "moe_ffn"
        elif "paged_attention_kernel" in name:
            kind = "paged_attention"
        else:
            kind = "other_kernels"
        kinds[kind] += ms
        top[name[:80]] = top.get(name[:80], 0.0) + ms
    check(kinds["h2d_copy"] > 0, "the profiler saw no host-to-device copy")
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy_ms = busy_us / 1e3
    return {"loop_ms": loop_ms, "device_ms_by_kind": kinds,
            "device_busy_ms": busy_ms, "busy_share": busy_ms / loop_ms,
            "idle_share": 1.0 - busy_ms / loop_ms,
            "h2d_expert_bytes": h2d_bytes,
            "h2d_GB_per_s": h2d_bytes / kinds["h2d_copy"] / 1e6,
            "top_device_ms": dict(sorted(top.items(), key=lambda kv: -kv[1])
                                  [:12])}


def kernel_cases(calls):
    """(name, wrapper(), plain(), graph-timed?, bytes, flops, shape) for
    each kernel on the arguments of the run's heaviest call. Bytes count
    each input read once and each output written once; paged
    attention's keys are the ones the call's positions make visible."""
    import torch
    from repro_torch.kernels import moe_gemm, ops
    from repro_torch.kernels import paged_attention as paged_mod

    x_e, w1, w3, w2, slots = calls["moe_ffn"]
    E, C, d = x_e.shape
    F = w1.shape[-1]
    sl = torch.tensor(slots, device="cuda")
    yield ("moe_ffn", lambda: ops.moe_ffn(x_e, w1, w3, w2, slots),
           lambda: moe_gemm.plain(x_e, w1, w3, w2, sl), False,
           4 * (2 * E * C * d + 3 * E * d * F + E), 6 * E * C * d * F,
           {"E": E, "C": C, "d": d, "F": F})

    q, kp, vp, bt, pos = calls["paged_attention"]
    B, H, hd = q.shape
    bs, KV, T = kp.shape[1], kp.shape[2], bt.shape[1]
    keys = visible_keys(q, kp, vp, bt, pos)
    yield ("paged_attention", lambda: ops.paged_attention(q, kp, vp, bt, pos),
           lambda: paged_mod.plain(q, kp, vp, bt, pos), True,
           4 * (2 * B * H * hd + 2 * keys * KV * hd + B * T + B),
           4 * keys * H * hd,
           {"B": B, "H": H, "KV": KV, "hd": hd, "bs": bs, "T": T,
            "visible_keys": keys})


def coverage_checks():
    """Each wrapper against its plain version on the card at MOE_SHAPES
    and PAGED_SHAPES (inputs from a seeded numpy generator, weights in
    E + 1 slots read in reverse order, one paged row with pos -1).
    Raises on the first disagreement; returns one record per shape."""
    import numpy as np
    import torch
    from repro_torch.kernels import moe_gemm, ops
    from repro_torch.kernels import paged_attention as paged_mod

    rng = np.random.default_rng(SEED)

    def rand(shape, scale=1.0):
        return torch.from_numpy(
            (rng.normal(size=shape) * scale).astype(np.float32)).cuda()

    def held(name, shape, got, want):
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=TOL[name], atol=TOL[name]),
              f"{name} at {shape}: max |kernel - plain| = {err:.3e}, "
              f"tol {TOL[name]}")
        return {"name": name, "shape": shape, "max_abs_err": err}

    out = []
    for E, C, d, F in MOE_SHAPES:
        x = rand((E, C, d), 0.5)
        w1, w3 = rand((E + 1, d, F), 0.05), rand((E + 1, d, F), 0.05)
        w2 = rand((E + 1, F, d), 0.05)
        slots = list(range(E, 0, -1))
        out.append(held("moe_ffn", [E, C, d, F],
                        ops.moe_ffn(x, w1, w3, w2, slots),
                        moe_gemm.plain(x, w1, w3, w2,
                                       torch.tensor(slots, device="cuda"))))
    for B, H, KV, hd, N, bs, T in PAGED_SHAPES:
        q = rand((B, H, hd))
        kp, vp = rand((N, bs, KV, hd)), rand((N, bs, KV, hd))
        bt = torch.from_numpy(
            rng.integers(0, N, (B, T)).astype(np.int32)).cuda()
        pos = torch.from_numpy(
            rng.integers(0, T * bs, (B,)).astype(np.int32)).cuda()
        if B > 2:
            pos[-1] = -1   # no visible key: uniform over the row's keys
        out.append(held("paged_attention", [B, H, KV, hd, N, bs, T],
                        ops.paged_attention(q, kp, vp, bt, pos),
                        paged_mod.plain(q, kp, vp, bt, pos)))
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="trace the serving loop with torch.profiler")
    args = parser.parse_args()
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        sys.exit("chip_smoke.py: no src/repro_torch beside this script; "
                 "run it from the root of a checkout")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is False; "
                 "this script needs a CUDA GPU")
    import numpy as np

    import repro_torch
    check(Path(repro_torch.__file__).resolve().is_relative_to(SRC),
          f"repro_torch imported from {repro_torch.__file__}, not {SRC}")
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.offload_serving import ContinuousOffloadServer

    card = card_line()
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    built = ops.build_kernels()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "compiled": sorted(built)}), flush=True)
    for name, rep in built.items():
        for line in rep["ptxas"].splitlines():
            if "registers" in line:
                print(f"ptxas {name}: {line.strip()}")

    # ---- the model at full widths, 2 layers, and the server ---------
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=2,
                              dtype="float32")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                         device="cuda")
    srv = ContinuousOffloadServer(
        params, cfg, cache_slots=4, policy="lfu", prefetch="spec",
        max_batch=4, kv_block_size=16, cache_len=PROMPT_LEN + NEW_TOKENS,
        device="cuda")
    torch.cuda.synchronize()
    store = srv.engine.store
    pinned = all(v.is_pinned() for k in store.keys()
                 for v in store.fetch(k).values())
    check(pinned, "expert masters are not in pinned host memory")
    print(json.dumps({
        "setup_s": time.perf_counter() - t0,
        "expert_master_bytes": store.total_nbytes(),
        "expert_slot_bytes": sum(c.device_nbytes()
                                 for c in srv.engine.caches),
        "device_bytes_allocated": torch.cuda.memory_allocated()}),
        flush=True)

    rng = np.random.default_rng(SEED)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, PROMPT_LEN)]
               for _ in SUBMIT_AT_STEP]

    # ---- serve ------------------------------------------------------
    prof = None
    if args.profile:
        act = torch.profiler.ProfilerActivity
        prof = torch.profiler.profile(activities=[act.CPU, act.CUDA])
    rids, launches, step_ms, step_h2d, calls, loop_ms = serve(
        srv, prompts, ops, prof)
    print(json.dumps({"steps": len(step_ms), "step_ms": step_ms,
                      "h2d_expert_bytes": step_h2d,
                      "launches": launches}), flush=True)
    if prof is not None:
        print(json.dumps({"profile": device_time_summary(
            prof, loop_ms, sum(step_h2d))}), flush=True)
    for name, n in launches.items():
        check(n > 0, f"{name}: the main path never launched its kernel")

    # ---- outputs: finite logits, server tokens == generate tokens ---
    logits = srv._logits
    check(tuple(logits.shape) == (srv.max_batch, cfg.vocab_size),
          f"logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    served = [srv.result(r) for r in rids]
    t0 = time.perf_counter()
    for p, out in zip(prompts, served):
        want = srv.engine.generate(p, NEW_TOKENS)
        check(out == want, f"server {out[PROMPT_LEN:]} != generate "
                           f"{want[PROMPT_LEN:]} for prompt {p}")
    print(json.dumps({"server_equals_generate": True,
                      "generate_s": time.perf_counter() - t0,
                      "new_tokens": [o[PROMPT_LEN:] for o in served]}),
          flush=True)

    # ---- each kernel against its plain version ----------------------
    # (the run's launches were read above: these do not count)
    kernels = []
    for name, kern, plain, graph, nbytes, flops, shape in kernel_cases(
            calls):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(torch.allclose(got, want, rtol=TOL[name], atol=TOL[name]),
              f"{name}: max |kernel - plain| = {err:.3e}, tol {TOL[name]}")
        iters = 20 if graph else 10
        ms = device_ms(kern, iters, graph=graph)
        plain_ms = device_ms(plain, iters, graph=graph)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": launches[name],
            "max_abs_err": err, "tol": TOL[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "bytes": nbytes, "flops": flops,
            "shape": shape})
    print(json.dumps({"coverage": coverage_checks()}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
