#!/usr/bin/env python3
"""Quick check of the port's flash-attention forward kernel on one GPU.

    python3 tools/flash_fwd_check.py              # from the root of a checkout
    python3 tools/flash_fwd_check.py --one-pass   # also time P in one pass
    python3 tools/flash_fwd_check.py --turns DIR  # also against DIR's kernel

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
(``chip_smoke.pass_flops``). One JSON line a shape and dtype. Then the
fp32 forward at the recorded fp32 calls (``CALLS``: DeepSeek-V2's MLA
prefill, Llama-3.2-Vision's cross call, Whisper's encoder call,
Mixtral's and Jamba's prefill calls, Qwen1.5-0.5B's training call):
against float64, two launches bitwise equal, its time beside SDPA's fp32
forward (``enable_gqa``), the TFLOP/s of its executed 3xTF32 passes and
their share of the TF32 tensor cores' rate (the 3xTF32 floor over the
time).

``--turns DIR`` builds ``DIR``'s forward (a checkout of another commit,
e.g. ``git archive <parent> | tar -x -C build/parent``) into
``build/flash_fwd_turns`` and times it against this one in turns (other,
this, this, other) at ``CALLS`` in fp32, with SDPA's fp32 forward in the
same process and the two outputs' largest difference over max |this|.

``--one-pass`` builds a copy of the source into ``build/`` with P.V's lo
pass deleted (P rounded to bf16 once, as JAX rounds it) and times it
against the shipped kernel in turns (shipped, one pass, one pass,
shipped) at the timed shapes, with both errors against float64: what
the hi + lo split costs. The shipped source has no such switch.

Exits non-zero without a GPU, on a mismatch, on a second launch that
differs, on a tile forward kernel (``flash_fwd_f32``, ``flash_fwd_bf16``)
with ``HMMA`` or without ``HGMMA`` instructions, on a ``mma.sync``
forward kernel left (``flash_attention_kernel``), or on one of
``FORWARD_NO_SPILL`` that spills.
"""
import argparse
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
from flash_one_query_check import built_entry  # noqa: E402

TOL = SMOKE_TOL["flash_attention"]
# the recorded fp32 calls (B, Sq, Sk, H, KV, hd, vd, causal, window):
# DeepSeek-V2's MLA prefill, Llama-3.2-Vision's cross call, Whisper's
# encoder call, Mixtral's and Jamba's prefill calls, Qwen1.5-0.5B's
# training call
CALLS = {"deepseek-v2": (2, 2048, 2048, 128, 128, 192, 128, True, 0),
         "vision-cross": (2, 2048, 1601, 32, 32, 128, 128, False, 0),
         "whisper-encoder": (2, 1500, 1500, 6, 6, 64, 64, False, 0),
         "mixtral": (2, 2048, 2048, 32, 8, 128, 128, True, 0),
         "jamba": (2, 2048, 2048, 64, 8, 128, 128, True, 0),
         "qwen1.5-0.5b-train": (4, 2048, 2048, 16, 16, 64, 64, True, 0)}
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
    return built_entry(ops, flash_mod, out / flash_mod.SOURCE, out,
                       "flash_one_pass")[0]


def sass_ok(sass):
    """Both tile forward kernels are in ``sass`` (``ops.sass_counts``),
    ``flash_fwd_f32`` and ``flash_fwd_bf16``, every instantiation of each
    runs warpgroup MMAs and no warp-level one, and no ``mma.sync``
    forward kernel (``flash_attention_kernel``) is left."""
    ok = not any(k.startswith("flash_attention_kernel") for k in sass)
    for kind in ("flash_fwd_f32", "flash_fwd_bf16"):
        tile = [c for k, c in sass.items() if k.startswith(kind + "<")]
        ok &= bool(tile) and all(c["HGMMA"] > 0 and c["HMMA"] == 0
                                 for c in tile)
    return ok


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--one-pass", action="store_true")
    parser.add_argument("--turns", default="",
                        help="a checkout whose forward to time in turns")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("flash_fwd_check.py: this script needs a CUDA GPU")
    # fp32 products in full fp32 (no TF32), as chip_smoke.py runs them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    ok &= sass_ok(sass)
    fn = ops._entry("flash_attention")
    one = one_pass_entry(ops, flash_mod) if args.one_pass else None
    other = built_entry(
        ops, flash_mod, Path(args.turns).resolve() / "src" / "repro_torch" /
        "kernels" / "csrc" / flash_mod.SOURCE,
        ROOT / "build" / "flash_fwd_turns", "flash_turns")[0] \
        if args.turns else None
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
    for call, (B, Sq, Sk, H, KV, hd, vd, causal, window) in CALLS.items():
        q, k, v = rand(B, Sq, H, hd), rand(B, Sk, KV, hd), rand(B, Sk, KV, vd)
        kw = dict(causal=causal, window=window)
        got = flash_mod.launch(fn, q, k, v, **kw)
        rec = {"call": call, "shape": [B, Sq, Sk, H, KV, hd, vd, causal,
                                       window],
               "rel_err_float64": rel(got, flash_out_float64(q, k, v, **kw)),
               "bitwise_repeat": torch.equal(
                   got, flash_mod.launch(fn, q, k, v, **kw))}
        rec["ok"] = rec["rel_err_float64"] <= TOL and rec["bitwise_repeat"]
        rec["ms"] = timed_ms(lambda: flash_mod.launch(fn, q, k, v, **kw))
        lq, lk, lv = (t.transpose(1, 2) for t in (q, k, v))
        rec["sdpa_ms"] = timed_ms(lambda: F.scaled_dot_product_attention(
            lq, lk, lv, is_causal=causal, enable_gqa=True))
        visible = flash_mod.visible_pairs(Sq, Sk, causal, window)
        passes, rate = pass_flops("flash_attention", {
            "dtype": "torch.float32", "B": B, "H": H, "hd": hd, "vd": vd,
            "visible_pairs": visible}, 2 * B * H * visible * (hd + vd))
        rec["floor_ms"] = passes / rate * 1e3
        rec["tflops_of_passes"] = passes / rec["ms"] / 1e9
        rec["share_of_floor"] = rec["floor_ms"] / rec["ms"]
        if other is not None:
            theirs = flash_mod.launch(other, q, k, v, **kw)
            rec["rel_to_other"] = float((got - theirs).abs().max()
                                        / got.abs().max())
            rec["other_this_this_other_ms"] = [
                timed_ms(lambda f=f: flash_mod.launch(f, q, k, v, **kw))
                for f in (other, fn, fn, other)]
            rec["sdpa_ms_after"] = timed_ms(
                lambda: F.scaled_dot_product_attention(
                    lq, lk, lv, is_causal=causal, enable_gqa=True))
        ok &= rec["ok"]
        print(json.dumps(rec), flush=True)
        del q, k, v, lq, lk, lv, got
        torch.cuda.empty_cache()
    name = torch.cuda.get_device_name(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip() or name)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
