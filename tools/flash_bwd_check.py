#!/usr/bin/env python3
"""Quick check of the port's flash-attention backward kernel on one GPU.

    python3 tools/flash_bwd_check.py              # from the root of a checkout
    python3 tools/flash_bwd_check.py --variants   # also the design's variants

Builds the port's CUDA kernels (``ops.build_kernels``), prints the
backward's ``ptxas`` report and the count of ``HGMMA`` and ``HMMA``
instructions in each of its kernels' SASS (``ops.sass_counts``), holds
``flash_attention_bwd`` against
autograd of the plain version at the training shapes of
``chip_smoke.py`` (Qwen1.5-0.5B: 4 x 2048, 16 heads of 64; Mixtral: 1 x
2048, 32 / 8 heads of 128; Qwen2.5-3B: 2 x 2048, 16 / 2 heads of 128)
and DeepSeek-V2's MLA call (1 x 2048, 128 heads, hd 192, vd 128) and at
its coverage shapes, in fp32 and in bf16, one JSON line a shape and
dtype (max |kernel - plain| / max |plain| for dq, dk, dv; bf16 against
the fp32 plain version on the same bf16 values, and against float64). At
the four timed shapes it also launches the kernel twice and checks that
dq, dk and dv are bitwise equal, times the kernel, SDPA's forward +
backward and SDPA's backward alone (``autograd.grad`` over a retained
forward graph) in the same dtype with CUDA events, gives each of the
kernel's two launches its device time from ``torch.profiler``, and puts
the rate of the tensor-core passes the kernel executes beside its time
(``tflops_of_passes``, ``chip_smoke.pass_flops``). The ``ptxas`` line
lists each backward kernel's registers, stack and spills; the bf16
kernels of ``BACKWARD.NO_SPILL`` must have neither stack nor spills. The
short first call for a change to the kernel, before ``chip_smoke.py``.
Exits non-zero without a GPU, on a mismatch, on a second launch that
differs, on a bf16 kernel that spills, or on a bf16 backward kernel
whose SASS holds an ``HMMA`` (``mma.sync``) or no ``HGMMA`` (``wgmma``).

``--variants`` builds copies of the source with one choice of the bf16
design changed (``VARIANTS``: MLA's keys tiles of 32 rows, or dK and dV on
a warpgroup each; the keys launch's cluster split capped at 1, 2 or 8
blocks; ``setmaxnreg`` at 24 / 240) into ``build/``, prints each one's
bf16 ``ptxas`` records, and times it against the shipped build in turns
(shipped, variant, variant, shipped) at the call its choice is for. The
shipped source has no such switch.
"""
import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import pass_flops  # noqa: E402

# (B, Sq, Sk, H, KV, hd, vd, causal, window); the first four are timed
SHAPES = [(4, 2048, 2048, 16, 16, 64, 64, True, 0),
          (1, 2048, 2048, 32, 8, 128, 128, True, 0),
          (2, 2048, 2048, 16, 2, 128, 128, True, 0),
          (1, 2048, 2048, 128, 128, 192, 128, True, 0),
          (2, 160, 160, 4, 2, 64, 64, True, 37),
          (1, 333, 333, 8, 2, 64, 64, True, 0),
          (2, 1, 1500, 6, 6, 64, 64, False, 0),
          (1, 77, 1601, 32, 32, 128, 128, False, 0),
          (1, 300, 300, 16, 16, 192, 128, True, 0),
          (1, 100, 40, 4, 2, 64, 64, True, 16),
          (1, 200, 200, 16, 1, 256, 256, True, 37),
          (1, 70, 70, 6, 3, 37, 21, True, 0),
          (1, 150, 150, 8, 2, 160, 24, True, 0)]
TOL = 2e-5   # max |kernel - plain| <= TOL x max |plain|, each output
# bf16: within BF16_TOL x max of the fp32 plain version on the same bf16
# values, and within BF16_F64_TOL x max of float64 (one bf16 rounding at
# the store, 2^-9 relative, plus the fp32 kernel's 2e-5)
BF16_TOL, BF16_F64_TOL = 2e-2, 2.0 ** -8
TIMED = 4
MLA, QWEN25 = SHAPES[3], SHAPES[2]
# name: (file of csrc/, (shipped text, variant text) pairs, shape to time
# at or None)
KEYS192 = "launch_bf16<192, 128, 64, 3, 16, 4, 1>"
CAP = "constexpr int kMaxCluster = 4;"
VARIANTS = {
    "keys_192_rows32": ("flash_attention_bwd.cu", [(
        KEYS192, "launch_bf16<192, 128, 64, 3, 32, 4, 1>")], MLA),
    "keys_192_split2": ("flash_attention_bwd.cu", [(
        KEYS192, "launch_bf16<192, 128, 64, 3, 32, 4, 2>")], MLA),
    "cluster_cap1": ("flash_attention_bwd.cu", [(
        CAP, "constexpr int kMaxCluster = 1;")], QWEN25),
    "cluster_cap2": ("flash_attention_bwd.cu", [(
        CAP, "constexpr int kMaxCluster = 2;")], QWEN25),
    "cluster_cap8": ("flash_attention_bwd.cu", [(
        CAP, "constexpr int kMaxCluster = 8;")], QWEN25),
    "regs_24_240": ("hopper.cuh", [
        ("kProducerRegs = 40", "kProducerRegs = 24"),
        ("kConsumerRegs = 232", "kConsumerRegs = 240")], None),
}


def timed_ms(fn, iters=5):
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


def launch_ms(fn):
    """{kernel name: device ms} of one call of ``fn``, by torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            name = re.sub(r"^void |\(anonymous namespace\)::|\(.*", "",
                          ev.name)
            out[name] = out.get(name, 0.0) + ev.time_range.elapsed_us() / 1e3
    return out


def variant_entries(ops, flash_mod):
    """{name: (C entry, its bf16 ptxas records)} of each of VARIANTS,
    built in parallel from edited copies of the sources into ``build/``."""
    procs = {}
    for name, (edited, edits, _) in VARIANTS.items():
        out = ROOT / "build" / "flash_bwd_variants" / name
        out.mkdir(parents=True, exist_ok=True)
        for path in list(ops.CSRC.glob("*.cuh")) + [
                ops.CSRC / flash_mod.BACKWARD.SOURCE]:
            text = path.read_text()
            if path.name == edited:
                for old, new in edits:
                    if text.count(old) != 1:
                        sys.exit(f"flash_bwd_check.py: {name}: {old!r} is "
                                 "not where --variants looks for it")
                    text = text.replace(old, new)
            (out / path.name).write_text(text)
        lib = out / "lib.so"
        procs[name] = (subprocess.Popen(
            [ops._nvcc(), *ops.NVCC_FLAGS, "-o", str(lib),
             str(out / flash_mod.BACKWARD.SOURCE)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    entries = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"flash_bwd_check.py: {name} failed to build\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), flash_mod.BACKWARD.SYMBOL)
        fn.argtypes = flash_mod.BACKWARD.ARGTYPES
        fn.restype = ctypes.c_int
        entries[name] = (fn, [r for r in ops.ptxas_kernels(log)
                              if "bf16" in r["kernel"]])
    return entries


def bf16_sass_ok(sass):
    """Every bf16 backward kernel in ``sass`` (``ops.sass_counts``) runs
    warpgroup MMAs and no warp-level one, and there are both of them."""
    bf16 = {k: c for k, c in sass.items()
            if k.startswith(("flash_bwd_rows_bf16", "flash_bwd_keys_bf16"))}
    return ({k.split("<")[0] for k in bf16}
            == {"flash_bwd_rows_bf16", "flash_bwd_keys_bf16"}
            and all(c["HGMMA"] > 0 and c["HMMA"] == 0 for c in bf16.values()))


def grads_float64(q, k, v, dout, *, causal, window):
    """(dq, dk, dv) of the attention ``flash_mod.plain`` computes, by
    autograd in float64 (the plain version itself computes in fp32)."""
    import math
    import torch
    with torch.enable_grad():
        q, k, v = (t.detach().double().requires_grad_() for t in (q, k, v))
        Sq, Sk, hd = q.shape[1], k.shape[1], q.shape[3]
        G = q.shape[2] // k.shape[2]
        kk, vv = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(hd)
        qp = torch.arange(Sq, device=q.device)[:, None]
        kp = torch.arange(Sk, device=q.device)[None, :]
        keep = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
        if causal:
            keep &= kp <= qp
        if window > 0:
            keep &= qp - kp < window
        p = torch.softmax(torch.where(keep, s, -1e30), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", p, vv)
        return torch.autograd.grad(out, (q, k, v), dout.double())


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--variants", action="store_true")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("flash_bwd_check.py: this script needs a CUDA GPU")
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops

    ops.build_kernels()
    ptxas = ops.ptxas_kernels(ops.build_log("flash_attention_bwd"))
    print(json.dumps({"ptxas": ptxas}), flush=True)
    no_spill = flash_mod.BACKWARD.NO_SPILL
    kept = [r for r in ptxas if r["kernel"] in no_spill]
    ok = len(kept) == len(no_spill) and not any(
        r["stack"] or r["spill_stores"] or r["spill_loads"] for r in kept)
    sass = ops.sass_counts("flash_attention_bwd")
    print(json.dumps({"sass": sass}), flush=True)
    ok &= bf16_sass_ok(sass)
    fn = ops._entry("flash_attention_bwd")
    rng = np.random.default_rng(0)

    def rand(*shape):
        return torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).cuda()

    def rel_err(got, want):
        return [float((a.double() - b.double()).abs().max()
                      / b.double().abs().max()) for a, b in zip(got, want)]

    cases = [(s, dt) for dt in (torch.float32, torch.bfloat16)
             for s in SHAPES]
    for (B, Sq, Sk, H, KV, hd, vd, causal, window), dtype in cases:
        q, k = rand(B, Sq, H, hd), rand(B, Sk, KV, hd)
        v, dout = rand(B, Sk, KV, vd), rand(B, Sq, H, vd)
        q, k, v, dout = (t.to(dtype) for t in (q, k, v, dout))
        kw = dict(causal=causal, window=window)
        got = flash_mod.launch_bwd(fn, q, k, v, dout, **kw)
        want = flash_mod.plain_bwd(q.float(), k.float(), v.float(),
                                   dout.float(), **kw)
        rel = rel_err(got, want)
        bf16 = dtype == torch.bfloat16
        rec = {"shape": [B, Sq, Sk, H, KV, hd, vd, causal, window],
               "dtype": str(dtype), "rel_err": rel,
               "ok": (all(g.dtype == dtype for g in got)
                      and max(rel) <= (BF16_TOL if bf16 else TOL))}
        if bf16 and B * Sq * Sk * H <= 2 ** 28:   # float64 fits the card
            rec["rel_err_float64"] = rel_err(got, grads_float64(q, k, v,
                                                                dout, **kw))
            rec["ok"] &= max(rec["rel_err_float64"]) <= BF16_F64_TOL
        ok &= rec["ok"]
        if SHAPES.index(tuple(rec["shape"])) < TIMED:
            again = flash_mod.launch_bwd(fn, q, k, v, dout, **kw)
            rec["bitwise_repeat"] = all(torch.equal(a, b)
                                        for a, b in zip(got, again))
            ok &= rec["bitwise_repeat"]
            rec["ms"] = timed_ms(lambda: flash_mod.launch_bwd(
                fn, q, k, v, dout, **kw))
            rec["launch_ms"] = launch_ms(lambda: flash_mod.launch_bwd(
                fn, q, k, v, dout, **kw))
            visible = flash_mod.visible_pairs(Sq, Sk, causal, window)
            passes, _ = pass_flops("flash_attention_bwd", {
                "dtype": str(dtype), "B": B, "H": H, "hd": hd, "vd": vd,
                "visible_pairs": visible},
                flash_mod.bwd_cost(q, k, v, **kw)[0])
            rec["tflops_of_passes"] = passes / rec["ms"] / 1e9
            lq, lk, lv = (t.transpose(1, 2).requires_grad_()
                          for t in (q, k, v))
            ldo = dout.transpose(1, 2)

            def forward():
                return F.scaled_dot_product_attention(
                    lq, lk, lv, is_causal=causal, enable_gqa=True)

            def sdpa():
                return torch.autograd.grad(forward(), (lq, lk, lv), ldo)
            rec["sdpa_fwd_bwd_ms"] = timed_ms(sdpa)
            o = forward()
            rec["sdpa_bwd_ms"] = timed_ms(lambda: torch.autograd.grad(
                o, (lq, lk, lv), ldo, retain_graph=True))
        print(json.dumps(rec), flush=True)
    if args.variants:
        for name, (vfn, ptxas_v) in variant_entries(ops, flash_mod).items():
            rec = {"variant": name, "ptxas": ptxas_v}
            shape = VARIANTS[name][2]
            if shape is not None:
                B, Sq, Sk, H, KV, hd, vd, causal, window = shape
                q, k = rand(B, Sq, H, hd), rand(B, Sk, KV, hd)
                v, dout = rand(B, Sk, KV, vd), rand(B, Sq, H, vd)
                q, k, v, dout = (t.to(torch.bfloat16) for t in (q, k, v, dout))
                kw = dict(causal=causal, window=window)
                rec["shape"] = list(shape)
                rec["turns_shipped_variant_variant_shipped_ms"] = [
                    timed_ms(lambda f=f: flash_mod.launch_bwd(
                        f, q, k, v, dout, **kw))
                    for f in (fn, vfn, vfn, fn)]
            print(json.dumps(rec), flush=True)
    name = torch.cuda.get_device_name(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip() or name)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
