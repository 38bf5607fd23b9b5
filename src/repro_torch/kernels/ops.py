"""Public kernel wrappers: argument checks, CPU/CUDA dispatch, launch
counters, and the build loader for the CUDA sources in ``csrc/``.

The rule for every wrapper: a tensor on the CPU takes the kernel's
plain PyTorch version; a tensor on a CUDA device launches the
hand-written kernel or raises. There is no fallback between the two and
no switch to choose. Every route returns contiguous outputs, as the
kernels write them. A ``meta`` tensor (the dry run's) gets an empty
meta output of the kernel's shape and dtype, and computes nothing.

An active op counter (``repro_torch.launch.op_cost.OpCost``, a
dispatch mode) is told of each forward wrapper's call as one call of
its kernel, with the kernel's closed-form FLOPs and bytes (each kernel
module's ``cost``), and does not count the ops the wrapper runs inside
it: the plain version's intermediates are not what the card runs. So a
call counts the same on ``meta``, ``cpu`` and ``cuda``. With no counter
active nothing is counted.

Each wrapper keeps a plain integer count in ``LAUNCHES``, incremented
where it launches its kernel and nowhere else, so a run can show that
its main path went through the kernels (``reset_launch_counts`` /
``launch_counts``). ``ROUTES`` counts, beside it, the flash attention
launches that took the one-query route (``route_counts``); a launch
counts once in ``LAUNCHES`` whatever its route.

Gradients. ``flash_attention`` and ``ssd_chunk`` are differentiable on
both routes: on the CPU through autograd of the plain version, on a card
through ``_FlashAttention`` and ``_SsdChunk``, whose backwards launch the
hand-written backward kernels (``flash_attention_bwd`` and
``ssd_chunk_bwd``, each counted on its own; fp32 products 3xTF32 on the
TF32 tensor cores, as their forwards; flash attention in fp32 or bf16,
bf16 on the bf16 tensor cores; SSD chunk in fp32). The decode-only
kernels (``moe_ffn``, ``paged_attention``) write into fresh outputs with
no autograd record, so their CUDA and meta routes raise when grad mode
is on and an input requires grad (``_no_backward``) rather than silently
cut the gradient; their CPU routes differentiate as plain PyTorch does.
On meta tensors the two differentiable kernels' backwards give empty
gradients of the inputs' shapes and tell an active counter of one call
of their backward kernel at its module's ``bwd_cost``, as the card's do.

Kernels are built at first use: one ``nvcc`` per source, all started
together, into ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), each library named by a hash of its source, the shared
headers and the flags, so a rebuilt source never loads a stale library.
They are bound with ``ctypes`` (plain C entry points; no PyTorch
headers, so a build takes seconds) and launch on PyTorch's current
stream.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import moe_gemm, paged_attention as paged_mod
from repro_torch.kernels import ssd_chunk as ssd_mod

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_MODULES = {"moe_ffn": moe_gemm, "paged_attention": paged_mod,
            "flash_attention": flash_mod,
            "flash_attention_bwd": flash_mod.BACKWARD, "ssd_chunk": ssd_mod,
            "ssd_chunk_bwd": ssd_mod.BACKWARD}
_FNS: Dict[str, ctypes._CFuncPtr] = {}
LAUNCHES: Dict[str, int] = {name: 0 for name in _MODULES}
ROUTES: Dict[str, int] = {"flash_attention_one_query": 0}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels are compiled from source at first use")


def _library_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # what the sources include
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_kernels() -> Dict[str, dict]:
    """Compile and bind every kernel not bound yet. Returns
    ``{kernel: {"library", "seconds", "ptxas"}}`` for the sources this
    call compiled (``seconds`` is the wall time of the parallel build;
    ``ptxas`` the compiler's register/shared-memory report)."""
    todo = {name: _library_path(CSRC / mod.SOURCE)
            for name, mod in _MODULES.items() if name not in _FNS}
    report: Dict[str, dict] = {}
    missing = {n: p for n, p in todo.items() if not p.exists()}
    if missing:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        try:
            for name, lib in missing.items():
                tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
                log = lib.with_name(f"{lib.name}.log")
                with open(log, "w") as fh:
                    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                           str(CSRC / _MODULES[name].SOURCE)]
                    procs[name] = (subprocess.Popen(
                        cmd, stdout=fh, stderr=subprocess.STDOUT), tmp, log)
        finally:
            for proc, _, _ in procs.values():
                proc.wait()
        seconds = time.perf_counter() - t0
        failed = []
        for name, (proc, tmp, log) in procs.items():
            text = log.read_text()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{text}")
                continue
            os.replace(tmp, missing[name])
            report[name] = {"library": str(missing[name]),
                            "seconds": seconds, "ptxas": text}
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    for name, lib in todo.items():
        fn = getattr(ctypes.CDLL(str(lib)), _MODULES[name].SYMBOL)
        fn.argtypes = _MODULES[name].ARGTYPES
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return report


def build_log(name: str) -> str:
    """The compiler's output (its ``ptxas`` report) of kernel ``name``'s
    current library, kept beside it when it was built."""
    lib = _library_path(CSRC / _MODULES[name].SOURCE)
    return lib.with_name(f"{lib.name}.log").read_text()


def _kernel_label(mangled: str) -> str:
    """A kernel's Itanium-mangled name as its source writes it, with its
    template arguments (ints, float, bf16): ``flash_bwd_keys_bf16<12,8,2>``."""
    i, name = (3 if mangled.startswith("_ZN") else 2), mangled
    while i < len(mangled) and mangled[i].isdigit():   # <length><name>...
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    args = re.match(r"I((?:Li-?\d+E|f|13__nv_bfloat16)+)E", mangled[i:])
    if args:
        name += "<" + ",".join(
            n or ("float" if f else "bf16") for n, f in
            re.findall(r"Li(-?\d+)E|(f)|13__nv_bfloat16", args.group(1))) + ">"
    return name


def ptxas_kernels(text: str) -> list:
    """One record a kernel of an ``nvcc -Xptxas -v`` report (a build's
    ``ptxas``): ``{"kernel", "registers", "stack", "spill_stores",
    "spill_loads"}``, the last three in bytes."""
    recs = []
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            recs.append({"kernel": _kernel_label(entry.group(1))})
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        if frame and recs:
            recs[-1].update(stack=int(frame.group(1)),
                            spill_stores=int(frame.group(2)),
                            spill_loads=int(frame.group(3)))
        used = re.search(r"Used (\d+) registers", line)
        if used and recs:
            recs[-1]["registers"] = int(used.group(1))
    return recs


def _cuobjdump() -> str:
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("cuobjdump not found (PATH or /usr/local/cuda/bin)")


def sass_counts(name: str) -> Dict[str, Dict[str, int]]:
    """``{kernel: {"HGMMA": n, "HMMA": m}}``: how many warpgroup MMAs
    (``wgmma``) and warp-level MMAs (``mma.sync``) the SASS of each kernel
    of kernel ``name``'s current library holds, by ``cuobjdump -sass``."""
    opcodes = ("HGMMA", "HMMA")
    lib = _library_path(CSRC / _MODULES[name].SOURCE)
    text = subprocess.run([_cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out: Dict[str, Dict[str, int]] = {}
    counts = None
    for line in text.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            counts = out.setdefault(_kernel_label(fn.group(1)),
                                    {op: 0 for op in opcodes})
            continue
        if counts is not None:
            for op in opcodes:
                if re.search(rf"\b{op}\.", line):
                    counts[op] += 1
    return out


def _entry(name: str):
    """The bound C entry point of kernel ``name`` (built at first use)."""
    if name not in _FNS:
        build_kernels()
    return _FNS[name]


def _check_cuda(name: str, dtype, *tensors) -> None:
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    for t in tensors:
        if t.dtype not in dtypes or t.dtype != tensors[0].dtype:
            raise ValueError(f"{name}: the CUDA kernel takes one of "
                             f"{dtypes} for all of its tensors, got "
                             f"{[str(u.dtype) for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous "
                             f"tensors")


def _no_backward(name: str, why: str, *tensors) -> None:
    """Raise if autograd would need a gradient through this route (the
    CUDA kernel or the meta output), which has none (``why`` says why,
    or where one would come from)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: this route has no backward ({why}); call it under "
            f"torch.no_grad() or on tensors that do not require grad")


def _one_device(name: str, *tensors) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on several devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _counted(name: str, cost, run):
    """``run()``, the call of kernel ``name``; an active op counter is
    told of it as one kernel call of ``cost()`` = (flops, bytes) and does
    not count what ``run`` does."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if hasattr(mode, "kernel_call"):
            return mode.kernel_call(name, cost, run)
    return run()


# ---------------------------------------------------------------- moe
def moe_ffn(x_e, w1, w3, w2, slots: Sequence[int]):
    """Grouped expert SwiGLU FFN: x_e [E,C,d] -> [E,C,d] fp32.

    ``w1/w3 [S,d,F]``, ``w2 [S,F,d]`` hold S experts (the expert cache's
    slot buffers); row group e uses slot ``slots[e]``, read in place."""
    if x_e.dim() != 3 or w1.dim() != 3:
        raise ValueError(f"moe_ffn: x_e [E,C,d] and w1 [S,d,F], got "
                         f"{tuple(x_e.shape)} and {tuple(w1.shape)}")
    E, C, d = x_e.shape
    S, F = w1.shape[0], w1.shape[2]
    if (tuple(w1.shape) != (S, d, F) or w3.shape != w1.shape
            or tuple(w2.shape) != (S, F, d)):
        raise ValueError(f"moe_ffn: shapes x_e {tuple(x_e.shape)}, w1 "
                         f"{tuple(w1.shape)}, w3 {tuple(w3.shape)}, w2 "
                         f"{tuple(w2.shape)} do not fit [E,C,d], [S,d,F], "
                         f"[S,F,d]")
    slots = [int(s) for s in slots]
    if len(slots) != E or any(not 0 <= s < S for s in slots):
        raise ValueError(f"moe_ffn: need {E} slot indices in [0, {S}), "
                         f"got {slots}")
    dev = _one_device("moe_ffn", x_e, w1, w3, w2)

    def run():
        if dev.type == "cpu":
            return moe_gemm.plain(x_e, w1, w3, w2, torch.tensor(
                slots, dtype=torch.long)).contiguous()
        _no_backward("moe_ffn", "a decode-only kernel: no backward is "
                     "planned", x_e, w1, w3, w2)
        if dev.type == "meta":
            return x_e.new_empty((E, C, d), dtype=torch.float32)
        _check_cuda("moe_ffn", torch.float32, x_e, w1, w3, w2)
        fn = _entry("moe_ffn")
        # from pinned memory, so the upload does not wait for the stream
        sl = torch.tensor(slots, dtype=torch.int32, pin_memory=True).to(
            dev, non_blocking=True)
        y = moe_gemm.launch(fn, x_e, w1, w3, w2, sl)
        LAUNCHES["moe_ffn"] += 1
        return y
    return _counted("moe_ffn", lambda: moe_gemm.cost(x_e, w1), run)


# ------------------------------------------------------ paged attention
def paged_attention(q, k_pool, v_pool, block_tables, pos):
    """Single-token decode attention over a paged KV pool.

    q [B, H, hd]; k/v_pool [N, bs, KV, hd]; block_tables [B, T] (row
    b's logical block i lives at physical block ``block_tables[b, i]``,
    which must lie in [0, N)); pos [B] bounds each row's visible keys
    (logical index <= pos). GQA grouping is H // KV. Returns
    [B, H, hd] in q's dtype."""
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"paged_attention: q [B,H,hd] and pools "
                         f"[N,bs,KV,hd], got {tuple(q.shape)} and "
                         f"{tuple(k_pool.shape)}")
    B, H, hd = q.shape
    KV = k_pool.shape[2]
    if (v_pool.shape != k_pool.shape or k_pool.shape[3] != hd
            or H % KV != 0 or block_tables.dim() != 2
            or block_tables.shape[0] != B or tuple(pos.shape) != (B,)):
        raise ValueError(f"paged_attention: shapes q {tuple(q.shape)}, k/v "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, "
                         f"tables {tuple(block_tables.shape)}, pos "
                         f"{tuple(pos.shape)} do not fit")
    dev = _one_device("paged_attention", q, k_pool, v_pool, block_tables,
                      pos)

    def run():
        if dev.type == "cpu":
            return paged_mod.plain(q, k_pool, v_pool, block_tables,
                                   pos).contiguous()
        _no_backward("paged_attention", "a decode-only kernel: no backward "
                     "is planned", q, k_pool, v_pool)
        if dev.type == "meta":
            return q.new_empty((B, H, hd))
        _check_cuda("paged_attention", torch.float32, q, k_pool, v_pool)
        if H // KV > paged_mod.MAX_GROUP or hd > paged_mod.MAX_HEAD_DIM:
            raise ValueError(f"paged_attention: the CUDA kernel takes up to "
                             f"{paged_mod.MAX_GROUP} query heads per KV "
                             f"head and head_dim <= {paged_mod.MAX_HEAD_DIM},"
                             f" got {H // KV} and {hd}")
        fn = _entry("paged_attention")
        out = paged_mod.launch(fn, q, k_pool, v_pool,
                               block_tables.to(torch.int32).contiguous(),
                               pos.to(torch.int32).contiguous())
        LAUNCHES["paged_attention"] += 1
        return out
    return _counted("paged_attention",
                    lambda: paged_mod.cost(q, k_pool, block_tables), run)


# ------------------------------------------------------ flash attention
def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Full-sequence attention: q [B,Sq,H,hd], k [B,Sk,KV,hd], v
    [B,Sk,KV,vd] with vd <= hd (MLA's values are narrower) -> [B,Sq,H,vd]
    in q's dtype. GQA groups H // KV query heads per KV head; ``causal``
    masks keys after the query's position; ``window`` > 0 masks keys
    ``window`` or more positions back (0: unbounded). Scale 1/sqrt(hd)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q [B,Sq,H,hd], k [B,Sk,KV,hd], "
                         f"v [B,Sk,KV,vd], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if (k.shape[0] != B or k.shape[3] != hd or tuple(v.shape[:3]) != (B, Sk, KV)
            or v.shape[3] > hd or H % KV != 0 or window < 0):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (window "
                         f"{window}) do not fit")
    window = int(window)
    dev = _one_device("flash_attention", q, k, v)

    def run():
        if dev.type == "cpu":
            return flash_mod.plain(q, k, v, causal=causal,
                                   window=window).contiguous()
        if dev.type == "cuda":
            _check_cuda("flash_attention", (torch.float32, torch.bfloat16),
                        q, k, v)
            if H // KV > flash_mod.MAX_GROUP or hd > flash_mod.MAX_HEAD_DIM:
                raise ValueError(
                    f"flash_attention: the CUDA kernel takes up to "
                    f"{flash_mod.MAX_GROUP} query heads per KV head and "
                    f"head_dim <= {flash_mod.MAX_HEAD_DIM}, got {H // KV} "
                    f"and {hd}")
        return _FlashAttention.apply(q, k, v, causal, window)
    return _counted("flash_attention", lambda: flash_mod.cost(
        q, k, v, causal=causal, window=window), run)


class _FlashAttention(torch.autograd.Function):
    """The CUDA and meta routes of ``flash_attention``: the forward
    kernel, and the backward kernel for (dq, dk, dv) in q's dtype from
    the saved q, k and v (it recomputes the softmax and the output it
    needs), one call of ``flash_attention_bwd`` at ``bwd_cost`` to an
    active op counter. On meta tensors both give empty outputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        if q.is_meta:
            return q.new_empty((*q.shape[:3], v.shape[3]))
        out = flash_mod.launch(_entry("flash_attention"), q, k, v,
                               causal=causal, window=window)
        LAUNCHES["flash_attention"] += 1
        if flash_mod.plan_of(q, k, v) is not None:
            ROUTES["flash_attention_one_query"] += 1
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        kw = dict(causal=ctx.causal, window=ctx.window)

        def run():
            if q.is_meta:
                return tuple(torch.empty_like(t) for t in (q, k, v))
            grads = flash_mod.launch_bwd(_entry("flash_attention_bwd"), q,
                                         k, v, dout.contiguous(), **kw)
            LAUNCHES["flash_attention_bwd"] += 1
            return grads
        dq, dk, dv = _counted("flash_attention_bwd",
                              lambda: flash_mod.bwd_cost(q, k, v, **kw), run)
        return dq, dk, dv, None, None


# ------------------------------------------------------------ ssd chunk
def ssd_chunk(dA, xw, Bm, Cm):
    """Mamba2 SSD intra-chunk step over G chunks at once: dA [G,Q,H],
    xw [G,Q,H,P], Bm/Cm [G,Q,N] -> (Y_intra [G,Q,H,P], S_chunk
    [G,H,P,N]), both fp32."""
    if dA.dim() != 3 or xw.dim() != 4:
        raise ValueError(f"ssd_chunk: dA [G,Q,H] and xw [G,Q,H,P], got "
                         f"{tuple(dA.shape)} and {tuple(xw.shape)}")
    G, Q, H = dA.shape
    if (tuple(xw.shape[:3]) != (G, Q, H) or Bm.dim() != 3
            or tuple(Bm.shape[:2]) != (G, Q) or Cm.shape != Bm.shape):
        raise ValueError(f"ssd_chunk: shapes dA {tuple(dA.shape)}, xw "
                         f"{tuple(xw.shape)}, Bm {tuple(Bm.shape)}, Cm "
                         f"{tuple(Cm.shape)} do not fit [G,Q,H], [G,Q,H,P], "
                         f"[G,Q,N]")
    dev = _one_device("ssd_chunk", dA, xw, Bm, Cm)

    def run():
        if dev.type == "cpu":
            return tuple(t.contiguous()
                         for t in ssd_mod.plain(dA, xw, Bm, Cm))
        if dev.type == "cuda":
            _check_cuda("ssd_chunk", torch.float32, dA, xw, Bm, Cm)
            if Q > ssd_mod.MAX_CHUNK:
                raise ValueError(f"ssd_chunk: the CUDA kernels take chunks "
                                 f"of up to {ssd_mod.MAX_CHUNK} positions, "
                                 f"got {Q}")
        return _SsdChunk.apply(dA, xw, Bm, Cm)
    return _counted("ssd_chunk", lambda: ssd_mod.cost(dA, xw, Bm), run)


class _SsdChunk(torch.autograd.Function):
    """The CUDA and meta routes of ``ssd_chunk``: the forward kernel, and
    the backward kernel for the four input gradients from the saved
    inputs (it recomputes the scores and decays it needs), one call of
    ``ssd_chunk_bwd`` at ``bwd_cost`` to an active op counter. A gradient
    of an unused output arrives as zeros (autograd materialises it). On
    meta tensors both give empty outputs."""

    @staticmethod
    def forward(ctx, dA, xw, Bm, Cm):
        ctx.save_for_backward(dA, xw, Bm, Cm)
        if dA.is_meta:
            G, Q, H = dA.shape
            P, N = xw.shape[3], Bm.shape[2]
            return (dA.new_empty((G, Q, H, P), dtype=torch.float32),
                    dA.new_empty((G, H, P, N), dtype=torch.float32))
        out = ssd_mod.launch(_entry("ssd_chunk"), dA, xw, Bm, Cm)
        LAUNCHES["ssd_chunk"] += 1
        return out

    @staticmethod
    def backward(ctx, dy, ds):
        saved = ctx.saved_tensors

        def run():
            if dy.is_meta:
                return tuple(torch.empty_like(t) for t in saved)
            grads = ssd_mod.launch_bwd(_entry("ssd_chunk_bwd"), *saved,
                                       dy.contiguous(), ds.contiguous())
            LAUNCHES["ssd_chunk_bwd"] += 1
            return grads
        return _counted("ssd_chunk_bwd",
                        lambda: ssd_mod.bwd_cost(*saved[:3]), run)


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, ROUTES):
        for name in counts:
            counts[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def route_counts() -> Dict[str, int]:
    return dict(ROUTES)
