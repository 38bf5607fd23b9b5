#!/usr/bin/env python3
"""Quick check of the port's flash-attention forward kernel on one GPU.

    python3 tools/flash_fwd_check.py              # from the root of a checkout
    python3 tools/flash_fwd_check.py --one-pass   # also time P in one pass

Builds the port's CUDA kernels (``ops.build_kernels``), prints the
forward's ``ptxas`` report (registers, stack, spills of each kernel) and
the count of ``HGMMA`` and ``HMMA`` instructions in each kernel's SASS
(``ops.sass_counts``), then holds ``flash_attention_fwd`` at the shapes
of ``tools/flash_bwd_check.py`` (``SHAPES``), in bf16 and in fp32: against
the plain version (fp32, on the same values; bf16 at ``BF16_TOL``, fp32
at ``TOL``, rtol = atol) and against float64 attention (max |kernel -
float64| over max |float64|: bf16 within ``BF16_F64_TOL``, one rounding
at the store; fp32 within ``TOL``), and launches it twice for bitwise
equal outputs. At the first ``TIMED`` shapes (the training calls of
``chip_smoke.py``: Qwen1.5-0.5B, Mixtral, Qwen2.5-3B, DeepSeek-V2's MLA)
it times the kernel and SDPA's forward in the same dtype with CUDA
events, beside the rate of the tensor-core passes the kernel executes
(``chip_smoke.pass_flops``). One JSON line a shape and dtype.

``--one-pass`` builds a copy of the source into ``build/`` with P.V's lo
pass deleted (P rounded to bf16 once, as JAX rounds it) and times it
against the shipped kernel in turns (shipped, one pass, one pass,
shipped) at the timed shapes, with both errors against float64: what
the hi + lo split costs. The shipped source has no such switch.

Exits non-zero without a GPU, on a mismatch, on a second launch that
differs, on a bf16 forward kernel with ``HMMA`` or without ``HGMMA``
instructions, or on one of ``FORWARD_NO_SPILL`` that spills.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
from chip_smoke import (BF16_F64_TOL, BF16_TOL,  # noqa: E402
                        flash_out_float64, pass_flops)
from chip_smoke import TOL as SMOKE_TOL  # noqa: E402
from flash_bwd_check import SHAPES, TIMED, timed_ms  # noqa: E402

TOL = SMOKE_TOL["flash_attention"]
LO_PASS = "wgmma_rs<VN>(o, pl[kk], vd_ + kk * (16 * kPanelRow >> 4));"


def one_pass_entry(ops, flash_mod):
    """The forward's C entry built from a copy of the source with P.V's
    lo pass deleted, into ``build/``."""
    src = (ops.CSRC / flash_mod.SOURCE).read_text()
    if src.count(LO_PASS) != 1:
        sys.exit("flash_fwd_check.py: the lo pass is not where --one-pass "
                 "looks for it")
    out = ROOT / "build" / "flash_fwd_one_pass"
    out.mkdir(parents=True, exist_ok=True)
    for header in ops.CSRC.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    (out / flash_mod.SOURCE).write_text(src.replace(LO_PASS, ""))
    lib = out / "libflash_one_pass.so"
    subprocess.run([ops._nvcc(), *ops.NVCC_FLAGS, "-o", str(lib),
                    str(out / flash_mod.SOURCE)], check=True,
                   capture_output=True)
    fn = getattr(ctypes.CDLL(str(lib)), flash_mod.SYMBOL)
    fn.argtypes = flash_mod.ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--one-pass", action="store_true")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("flash_fwd_check.py: this script needs a CUDA GPU")
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops

    ops.build_kernels()
    log = ops.build_log("flash_attention")
    ptxas = ops.ptxas_kernels(log)
    print(json.dumps({"ptxas": ptxas}), flush=True)
    warnings = [line.strip() for line in log.splitlines()
                if "warning" in line.lower()]
    if warnings:
        print(json.dumps({"ptxas_warnings": warnings}), flush=True)
    no_spill = flash_mod.FORWARD_NO_SPILL
    kept = [r for r in ptxas if r["kernel"] in no_spill]
    ok = len(kept) == len(no_spill) and not any(
        r["stack"] or r["spill_stores"] or r["spill_loads"] for r in kept)
    sass = ops.sass_counts("flash_attention")
    print(json.dumps({"sass": sass}), flush=True)
    bf16_kernels = {k: c for k, c in sass.items()
                    if k.startswith("flash_fwd_bf16")}
    ok &= bool(bf16_kernels) and all(c["HGMMA"] > 0 and c["HMMA"] == 0
                                     for c in bf16_kernels.values())
    ok &= not any(k.startswith("flash_attention_kernel<bf16")
                  for k in sass)
    fn = ops._entry("flash_attention")
    one = one_pass_entry(ops, flash_mod) if args.one_pass else None
    rng = np.random.default_rng(0)

    def rand(*shape):
        return torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).cuda()

    def rel(got, want):
        return float((got.double() - want).abs().max() / want.abs().max())

    cases = [(s, dt) for dt in (torch.bfloat16, torch.float32)
             for s in SHAPES]
    for (B, Sq, Sk, H, KV, hd, vd, causal, window), dtype in cases:
        q, k, v = rand(B, Sq, H, hd), rand(B, Sk, KV, hd), rand(B, Sk, KV, vd)
        q, k, v = (t.to(dtype) for t in (q, k, v))
        kw = dict(causal=causal, window=window)
        got = flash_mod.launch(fn, q, k, v, **kw)
        want = flash_mod.plain(q.float(), k.float(), v.float(), **kw)
        bf16 = dtype == torch.bfloat16
        tol = BF16_TOL if bf16 else TOL
        torch.cuda.synchronize()
        rec = {"shape": [B, Sq, Sk, H, KV, hd, vd, causal, window],
               "dtype": str(dtype),
               "max_abs_err": float((got.float() - want).abs().max()),
               "ok": got.dtype == dtype and bool(torch.isfinite(got).all())
               and torch.allclose(got.float(), want, rtol=tol, atol=tol)}
        rec["rel_err_float64"] = rel(got, flash_out_float64(q, k, v, **kw))
        rec["ok"] &= rec["rel_err_float64"] <= (BF16_F64_TOL if bf16
                                                else TOL)
        again = flash_mod.launch(fn, q, k, v, **kw)
        rec["bitwise_repeat"] = torch.equal(got, again)
        rec["ok"] &= rec["bitwise_repeat"]
        if SHAPES.index(tuple(rec["shape"])) < TIMED:
            rec["ms"] = timed_ms(lambda: flash_mod.launch(fn, q, k, v, **kw))
            lq, lk, lv = (t.transpose(1, 2) for t in (q, k, v))
            rec["sdpa_ms"] = timed_ms(lambda: F.scaled_dot_product_attention(
                lq, lk, lv, is_causal=causal, enable_gqa=True))
            visible = flash_mod.visible_pairs(Sq, Sk, causal, window)
            passes, _ = pass_flops("flash_attention", {
                "dtype": str(dtype), "B": B, "H": H, "hd": hd, "vd": vd,
                "visible_pairs": visible}, 2 * B * H * visible * (hd + vd))
            rec["tflops_of_passes"] = passes / rec["ms"] / 1e9
            if one is not None and bf16:
                turns = []
                for f in (fn, one, one, fn):
                    turns.append(timed_ms(lambda: flash_mod.launch(
                        f, q, k, v, **kw)))
                rec["turns_hi_lo_one_pass"] = turns
                rec["one_pass_rel_err_float64"] = rel(
                    flash_mod.launch(one, q, k, v, **kw),
                    flash_out_float64(q, k, v, **kw))
        ok &= rec["ok"]
        print(json.dumps(rec), flush=True)
    name = torch.cuda.get_device_name(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip() or name)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
