#!/usr/bin/env python3
"""Quick check of the port's flash-attention backward kernel on one GPU.

    python3 tools/flash_bwd_check.py              # from the root of a checkout
    python3 tools/flash_bwd_check.py --variants   # also the design's variants
    python3 tools/flash_bwd_check.py --turns DIR  # also against DIR's kernel

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
the fp32 plain version on the same bf16 values; both against float64
where it fits the card). At
the four timed shapes it also launches the kernel twice and checks that
dq, dk and dv are bitwise equal, times the kernel, SDPA's forward +
backward and SDPA's backward alone (``autograd.grad`` over a retained
forward graph) in the same dtype with CUDA events, gives each of the
kernel's two launches its device time from ``torch.profiler``, and puts
the rate of the tensor-core passes the kernel executes beside its time
(``tflops_of_passes``, ``chip_smoke.pass_flops``). The ``ptxas`` line
lists each backward kernel's registers, stack and spills; the bf16
kernels of ``BACKWARD.NO_SPILL`` (fp32 and bf16) must have neither stack
nor spills. The short first call for a change to the kernel, before
``chip_smoke.py``. Exits non-zero without a GPU, on a mismatch, on a
second launch that differs, on a listed kernel that spills, or on a
backward kernel whose SASS holds an ``HMMA`` (``mma.sync``) or no
``HGMMA`` (``wgmma``).

``--variants`` builds copies of the source with one choice of the design
changed (``VARIANTS``: bf16: MLA's keys tiles of 32 rows, or dK and dV on
a warpgroup each; the keys launch's cluster split capped at 1, 2 or 8
blocks; ``setmaxnreg`` at 24 / 240; fp32: three fragment buffers with
two k steps in flight, no hi / lo split of the tiles (timing only: wrong
sums), 64-key rows tiles at hd 64, 16-key rows or 16-row keys tiles at
hd 128, A fragments split in registers at hd 64, the rows launch's key
tiles split by the producer's warps, the keys launch split by gradient
at hd 64, its cluster split forced to 2) into ``build/``,
prints each one's ``ptxas``
records of its dtype, and times it against the shipped build in turns
(shipped, variant, variant, shipped) at the calls its choice is for. The
shipped source has no such switch.

``--turns DIR`` builds ``DIR``'s backward (a checkout of another commit,
``git archive`` unpacked into a git-ignored directory) the same way,
says whether its gradients are bitwise this checkout's, and times the two
in turns (other, this, this, other) at the four timed shapes in fp32 and
in bf16. ``--dtype`` limits the checks to one dtype; ``--only`` the
variants built.
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
QWEN05, MIXTRAL, QWEN25, MLA = SHAPES[:4]
# name: (file of csrc/, (shipped text, variant text) pairs, shapes to time
# at, dtype)
KEYS192 = "launch_bf16<192, 128, 64, 3, 16, 4, 1>"
CAP = "constexpr int kMaxCluster = 4;"
BF16, FP32 = "bfloat16", "float32"
F32_64 = "launch_f32<64, 64, 32, 4, 32, 2, 1, 1, 1, 1>"
F32_128 = "launch_f32<128, 128, 32, 2, 32, 2, 1, 0, 0, 1>"
BUFS = ("uint32_t ah[2][4], al[2][4];", "for (int x = 0; x < 2; ++x)",
        "const int x = kk & 1;", "wgmma_wait<1>();  // step kk - 1 is done",
        "fence_regs(ah[x ^ 1]);\n    fence_regs(al[x ^ 1]);")
VARIANTS = {
    "keys_192_rows32": ("flash_attention_bwd.cu", [(
        KEYS192, "launch_bf16<192, 128, 64, 3, 32, 4, 1>")], [MLA], BF16),
    "keys_192_split2": ("flash_attention_bwd.cu", [(
        KEYS192, "launch_bf16<192, 128, 64, 3, 32, 4, 2>")], [MLA], BF16),
    "cluster_cap1": ("flash_attention_bwd.cu", [(
        CAP, "constexpr int kMaxCluster = 1;")], [QWEN25], BF16),
    "cluster_cap2": ("flash_attention_bwd.cu", [(
        CAP, "constexpr int kMaxCluster = 2;")], [QWEN25], BF16),
    "cluster_cap8": ("flash_attention_bwd.cu", [(
        CAP, "constexpr int kMaxCluster = 8;")], [QWEN25], BF16),
    "regs_24_240": ("hopper.cuh", [
        ("kProducerRegs = 40", "kProducerRegs = 24"),
        ("kConsumerRegs = 232", "kConsumerRegs = 240")], [], BF16),
    # fp32: three A-fragment buffers, two k steps' groups in flight
    "f32_three_buffers": ("flash_attention_bwd.cu", [
        (BUFS[0], "uint32_t ah[3][4], al[3][4];"),
        (BUFS[1] + "\n#pragma unroll\n    for (int e = 0; e < 4; ++e) ah",
         "for (int x = 0; x < 3; ++x)\n#pragma unroll\n    for (int e = 0;"
         " e < 4; ++e) ah"),
        (BUFS[2], "const int x = kk % 3;"),
        (BUFS[3], "wgmma_wait<2>();  // step kk - 2 is done"),
        (BUFS[4], "fence_regs(ah[(kk + 1) % 3]);\n    "
                  "fence_regs(al[(kk + 1) % 3]);")], [QWEN05, MIXTRAL], FP32),
    # fp32, timing only (wrong sums): no split of the streamed tiles
    "f32_no_split": ("flash_attention_bwd.cu", [(
        "  for (int c = ct; c < np * rows * 8; c += nthr) {\n"
        "    const int p = c / (rows * 8), rem = c - p * rows * 8;\n"
        "    const int r = rem >> 3, lc = rem & 7;\n"
        "    const int o = p * rows",
        "  for (int c = ct + (tma ? 1 << 30 : 0); c < np * rows * 8; "
        "c += nthr) {\n"
        "    const int p = c / (rows * 8), rem = c - p * rows * 8;\n"
        "    const int r = rem >> 3, lc = rem & 7;\n"
        "    const int o = p * rows")], [QWEN05, MIXTRAL], FP32),
    # fp32 rows launch at hd <= 64: 64-key tiles in two stages
    "f32_rows64_kt64": ("flash_attention_bwd.cu", [(
        F32_64, "launch_f32<64, 64, 64, 2, 32, 2, 1, 1, 0, 0>")], [QWEN05], FP32),
    # fp32 at hd <= 128: 16-key rows tiles in four stages (two a
    # warpgroup), or 16-row keys tiles in four
    "f32_rows128_kt16": ("flash_attention_bwd.cu", [(
        F32_128, "launch_f32<128, 128, 16, 4, 32, 2, 1, 0, 0, 0>")], [MIXTRAL],
        FP32),
    "f32_keys128_rt16": ("flash_attention_bwd.cu", [(
        F32_128, "launch_f32<128, 128, 32, 2, 16, 4, 1, 0, 0, 1>")], [MIXTRAL],
        FP32),
    # fp32 at hd <= 64: the block's Q / dO and K / V raw, A fragments of
    # S, dP, S^T and dP^T split in registers at each k step
    "f32_64_raw_a": ("flash_attention_bwd.cu", [(
        F32_64, "launch_f32<64, 64, 32, 4, 32, 3, 1, 1, 0, 0>")], [QWEN05],
        FP32),
    # fp32 rows launch: its key tiles split by the producer's three warps
    # instead of their own warpgroup
    "f32_rows128_producer_split": ("flash_attention_bwd.cu", [(
        F32_128, "launch_f32<128, 128, 32, 2, 32, 2, 1, 0, 0, 0>")],
        [MIXTRAL, QWEN25], FP32),
    "f32_rows64_producer_split": ("flash_attention_bwd.cu", [(
        F32_64, "launch_f32<64, 64, 32, 4, 32, 2, 1, 1, 1, 0>")], [QWEN05],
        FP32),
    # fp32 keys launch at hd <= 64: dK and dV on a warpgroup each, both
    # warpgroups on every tile (S^T twice), as at hd > 64
    "f32_keys64_split": ("flash_attention_bwd.cu", [(
        F32_64, "launch_f32<64, 64, 32, 4, 32, 4, 1, 0, 0, 0>")], [QWEN05], FP32),
    # fp32 keys launch: every block's walk split over a cluster of 2
    "f32_cluster2": ("flash_attention_bwd.cu", [(
        "CPK > 1 ? 1 : static_cast<int>(std::max(\n      1LL, "
        "std::min<long long>(kMaxCluster, slots / keys_blocks)));",
        "CPK > 1 ? 1 : 2;")], [MIXTRAL, QWEN05], FP32),
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


def build_entries(ops, flash_mod, sources):
    """{name: (C entry, its ptxas records)} of each {name: (directory of
    sources, {file: text})}: the backward built in parallel from the
    directory's sources with the given files' texts instead, into
    ``build/flash_bwd_variants/<name>``."""
    procs = {}
    for name, (src_dir, texts) in sources.items():
        out = ROOT / "build" / "flash_bwd_variants" / name
        out.mkdir(parents=True, exist_ok=True)
        for path in list(src_dir.glob("*.cuh")) + [
                src_dir / flash_mod.BACKWARD.SOURCE]:
            (out / path.name).write_text(texts.get(path.name,
                                                   path.read_text()))
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
        entries[name] = (fn, ops.ptxas_kernels(log))
    return entries


def variant_sources(ops, names):
    """The edited texts of VARIANTS ``names``, for ``build_entries``; an
    edit's text is replaced wherever it stands."""
    sources = {}
    for name in names:
        edited, edits, _, _ = VARIANTS[name]
        text = (ops.CSRC / edited).read_text()
        for old, new in edits:
            if old not in text:
                sys.exit(f"flash_bwd_check.py: {name}: {old!r} is not "
                         "where --variants looks for it")
            text = text.replace(old, new)
        sources[name] = (ops.CSRC, {edited: text})
    return sources


def sass_ok(sass):
    """Every backward kernel in ``sass`` (``ops.sass_counts``), fp32 and
    bf16, runs warpgroup MMAs and no warp-level one, and all four of them
    are there."""
    kernels = {k: c for k, c in sass.items() if k.startswith("flash_bwd_")}
    return ({k.split("<")[0] for k in kernels}
            == {"flash_bwd_rows_f32", "flash_bwd_keys_f32",
                "flash_bwd_rows_bf16", "flash_bwd_keys_bf16"}
            and all(c["HGMMA"] > 0 and c["HMMA"] == 0
                    for c in kernels.values()))


def turns_ms(entries, q, k, v, dout, kw, launch_bwd):
    """ms of each entry of ``entries`` (ordered: its turns, e.g. other,
    this, this, other) on the same inputs."""
    return [timed_ms(lambda f=f: launch_bwd(f, q, k, v, dout, **kw))
            for f in entries]


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
    parser.add_argument("--only", default="",
                        help="comma-separated VARIANTS to build (all)")
    parser.add_argument("--turns", default="",
                        help="a checkout whose backward to time against")
    parser.add_argument("--dtype", default="both",
                        choices=("both", FP32, BF16))
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
    ok &= sass_ok(sass)
    fn = ops._entry("flash_attention_bwd")
    rng = np.random.default_rng(0)

    def rand(*shape):
        return torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).cuda()

    def inputs(shape, dtype):
        B, Sq, Sk, H, KV, hd, vd, causal, window = shape
        q, k = rand(B, Sq, H, hd), rand(B, Sk, KV, hd)
        v, dout = rand(B, Sk, KV, vd), rand(B, Sq, H, vd)
        return ([t.to(dtype) for t in (q, k, v, dout)],
                dict(causal=causal, window=window))

    def rel_err(got, want):
        return [float((a.double() - b.double()).abs().max()
                      / b.double().abs().max()) for a, b in zip(got, want)]

    dtypes = [getattr(torch, d) for d in (FP32, BF16)
              if args.dtype in ("both", d)]
    cases = [(s, dt) for dt in dtypes for s in SHAPES]
    for shape, dtype in cases:
        B, Sq, Sk, H, KV, hd, vd, causal, window = shape
        (q, k, v, dout), kw = inputs(shape, dtype)
        got = flash_mod.launch_bwd(fn, q, k, v, dout, **kw)
        want = flash_mod.plain_bwd(q.float(), k.float(), v.float(),
                                   dout.float(), **kw)
        rel = rel_err(got, want)
        bf16 = dtype == torch.bfloat16
        rec = {"shape": list(shape), "dtype": str(dtype), "rel_err": rel,
               "ok": (all(g.dtype == dtype for g in got)
                      and max(rel) <= (BF16_TOL if bf16 else TOL))}
        if B * Sq * Sk * H <= 2 ** 28:   # float64 fits the card
            rec["rel_err_float64"] = rel_err(got, grads_float64(q, k, v,
                                                                dout, **kw))
            rec["ok"] &= max(rec["rel_err_float64"]) <= (BF16_F64_TOL if bf16
                                                         else TOL)
        ok &= rec["ok"]
        if SHAPES.index(shape) < TIMED:
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
    sources = {}
    if args.variants:
        only = [n for n in args.only.split(",") if n] or list(VARIANTS)
        sources = variant_sources(ops, only)
    if args.turns:
        other = Path(args.turns).resolve() / "src/repro_torch/kernels/csrc"
        sources["turns_other"] = (other, {})
    entries = build_entries(ops, flash_mod, sources) if sources else {}
    for name, (vfn, ptxas_v) in entries.items():
        if name == "turns_other":
            for shape in SHAPES[:TIMED]:
                for dtype in dtypes:
                    (q, k, v, dout), kw = inputs(shape, dtype)
                    theirs = flash_mod.launch_bwd(vfn, q, k, v, dout, **kw)
                    ours = flash_mod.launch_bwd(fn, q, k, v, dout, **kw)
                    print(json.dumps({
                        "turns": args.turns, "shape": list(shape),
                        "dtype": str(dtype),
                        "bitwise_equal_to_other": all(
                            torch.equal(a, b) for a, b in zip(ours, theirs)),
                        "rel_to_other": rel_err(ours, theirs),
                        "other_this_this_other_ms": turns_ms(
                            (vfn, fn, fn, vfn), q, k, v, dout, kw,
                            flash_mod.launch_bwd)}), flush=True)
            continue
        _, _, shapes, dt = VARIANTS[name]
        tag = "f32" if dt == FP32 else "bf16"
        rec = {"variant": name, "ptxas": [r for r in ptxas_v
                                          if tag in r["kernel"]]}
        for shape in shapes:
            (q, k, v, dout), kw = inputs(shape, getattr(torch, dt))
            got = flash_mod.launch_bwd(vfn, q, k, v, dout, **kw)
            want = flash_mod.launch_bwd(fn, q, k, v, dout, **kw)
            rec.setdefault("rel_to_shipped", []).append(rel_err(got, want))
            rec.setdefault("turns_shipped_variant_variant_shipped_ms",
                           []).append([list(shape), turns_ms(
                               (fn, vfn, vfn, fn), q, k, v, dout, kw,
                               flash_mod.launch_bwd)])
        print(json.dumps(rec), flush=True)
    name = torch.cuda.get_device_name(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip() or name)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
