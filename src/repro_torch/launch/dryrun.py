"""Dry run: the per-device work of every (assigned arch x input shape) on
the production mesh, with no hardware (port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out /tmp/dry.json

The JAX package lowers each case with ``jax.jit`` over 256 (512) forced
host devices and reads the SPMD program's HLO. The port has no compiler
between it and the card: its per-device program is what one rank runs.
So each case runs the port's own model code as rank 0 of a fake process
group (``torch.testing``'s "fake" backend: every collective returns at
once, nothing is sent) that has the production mesh's world size, on
``meta`` tensors (shapes without storage: nothing is allocated, nothing
is computed, no GPU is touched), inside an ``op_cost.OpCost`` mode that
counts what the rank does: FLOPs, bytes, collective bytes by kind, the
live bytes' peak, and each kernel wrapper's calls with their closed-form
cost. The counts are work, not time.

A case: the (16, 16) mesh (``--multi-pod``: (2, 16, 16)),
``sharding_rules`` for the arch and the shape's global batch, the whole
params and decode state on ``meta`` cut to rank 0's blocks
(``shard_params``, ``shard_decode_state``), then ``prefill``
(``encoder_forward`` first for encdec), ``decode_step`` at the last
position of the shape's context, or a train step (loss, gradients,
AdamW; for a ``zero1`` config the moments cut on the data axis too). A
case that raises is reported with its error and the run goes on; the
entry points not yet ported under a mesh raise naming their ROADMAP.md
item.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict

import torch
import torch.distributed as dist

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.configs.all_configs import ASSIGNED
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh, sharding_rules
from repro_torch.launch.op_cost import OpCost, nbytes, tensors
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as tf
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_loop import make_train_step


def open_fake_group(world_size: int) -> None:
    """The default process group: rank 0 of ``world_size`` under the
    fake backend, opened once a process (and again at another world
    size). A real group that is open is left alone: that raises."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a process group is open; the dry run opens "
                               "its own (fake) one")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    # the testing package registers the "fake" backend on import
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _tree_bytes(*trees) -> int:
    return sum(nbytes(t) for t in tensors(trees))


# ---------------------------------------------------------------------
def build_case(cfg, shape_name: str, mesh, *, baseline: bool = False):
    """Returns (fn, args, rules, argument_bytes): ``fn(*args)`` is rank
    0's step on its meta inputs (params and state cut to its blocks,
    the whole batch, which the entry points cut to its rows), to run
    under ``sharding_ctx(mesh, rules)``; ``argument_bytes`` the rank's
    params, state (and optimizer state) and batch rows."""
    shape = INPUT_SHAPES[shape_name]
    if baseline and cfg.ssm_state:
        cfg = dataclasses.replace(cfg, ssm_chunk=256)  # pre-§Perf chunk size
    rules = sharding_rules(cfg, mesh, global_batch=shape.global_batch,
                           baseline=baseline)
    # specs are built under the sharding ctx: decode cache shapes depend
    # on head padding, which depends on the active mesh rules
    with shd.sharding_ctx(mesh, rules):
        fn, args, arg_bytes = _build_case_inner(cfg, shape, shape_name,
                                                mesh, rules)
    return fn, args, rules, arg_bytes


def _build_case_inner(cfg, shape, shape_name, mesh, rules):
    p_spec = S.params_spec(cfg)
    p_pspecs = shd.param_pspecs(p_spec, rules, mesh=mesh)
    params = shd.shard_tree(p_spec, p_pspecs, mesh)
    n_rows = shd.axis_size(rules.get("batch"), mesh)

    if shape.kind == "train":
        batch = S.input_specs(cfg, shape_name)
        opt_pspecs = S.opt_state_pspecs(p_pspecs, p_spec, cfg, rules)
        opt_state = shd.shard_tree(adamw_init(p_spec), opt_pspecs, mesh)
        step = make_train_step(cfg, opt_cfg=AdamWConfig())
        return (step, (params, opt_state, batch),
                _tree_bytes(params, opt_state) + _tree_bytes(batch) // n_rows)

    if shape.kind == "prefill":
        batch = S.input_specs(cfg, shape_name)

        def fn(params, batch):
            enc = None
            if cfg.family == "encdec":
                enc = tf.encoder_forward(params, cfg, batch["frames"])
            elif cfg.family == "vlm":
                enc = batch["patches"]
            return tf.prefill(params, cfg, batch["tokens"], enc=enc)

        return fn, (params, batch), \
            _tree_bytes(params) + _tree_bytes(batch) // n_rows

    # decode: the last position of the shape's context
    cache_len, window = S.decode_geometry(cfg, shape)
    inp = S.input_specs(cfg, shape_name)
    state = S.shard_decode_state(inp["state"], mesh, rules)
    pos = shape.seq_len - 1

    def fn(params, state, token):
        return tf.decode_step(params, cfg, state, token, pos, window=window)

    return fn, (params, state, inp["token"]), \
        _tree_bytes(params, state) + _tree_bytes(inp["token"]) // n_rows


def run_case(arch: str, shape_name: str, *, multi_pod: bool = False,
             baseline: bool = False, verbose: bool = True,
             mesh=None) -> Dict:
    """One case: rank 0's counts as the JAX dry run's result dict
    (``compile_s`` is ``run_s``, ``xla_*`` have no counterpart) plus
    ``matmul_flops``, ``collective_calls``, ``kernel_calls`` and
    ``by_op``."""
    cfg = get_config(arch)
    if mesh is None:
        open_fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    t0 = time.time()
    fn, args, rules, arg_bytes = build_case(cfg, shape_name, mesh,
                                            baseline=baseline)
    inputs = {t.untyped_storage()._cdata for t in tensors(args)}
    grad = (torch.enable_grad() if INPUT_SHAPES[shape_name].kind == "train"
            else torch.no_grad())
    with shd.sharding_ctx(mesh, rules), grad, OpCost() as cost:
        out = fn(*args)
    t1 = time.time()
    if cost.devices - {"meta"}:
        raise RuntimeError(f"the dry run allocated on {sorted(cost.devices)}"
                           f"; it runs on meta tensors only")
    out_bytes = sum(nbytes(t) for t in tensors(out)
                    if t.untyped_storage()._cdata not in inputs)

    n_chips = 1
    for i in range(mesh.ndim):
        n_chips *= mesh.size(i)
    total, active = cfg.param_counts()
    res = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(str(mesh.size(i)) for i in range(mesh.ndim)),
        "chips": n_chips,
        # per-device: rank 0's program
        "flops": cost.flops,
        "matmul_flops": cost.matmul_flops,
        "transcendental": cost.transcendental,
        "bytes_accessed": cost.bytes_accessed,
        "collective_bytes": dict(cost.collectives),
        "collective_calls": dict(cost.collective_calls),
        "collective_total": cost.collective_total,
        "kernel_calls": {k: dict(v) for k, v in cost.kernel_calls.items()},
        "by_op": {k: dict(v) for k, v in cost.by_op.items()},
        "params_total": total,
        "params_active": active,
        "run_s": round(t1 - t0, 1),
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": cost.temp_bytes},
    }
    if verbose:
        print(f"[{arch} × {shape_name} × mesh {res['mesh']}] "
              f"run {res['run_s']}s")
        print(f"  per-device: flops={res['flops']:.3e} "
              f"bytes={res['bytes_accessed']:.3e} "
              f"collective={res['collective_total']:.3e} "
              f"{ {k: f'{v:.2e}' for k, v in cost.collectives.items()} }")
        opt = (f" (optimizer state {_tree_bytes(args[1]) / 2**30:.2f}GiB)"
               if INPUT_SHAPES[shape_name].kind == "train" else "")
        print(f"  memory: args={arg_bytes / 2**30:.2f}GiB{opt} "
              f"out={out_bytes / 2**30:.2f}GiB "
              f"temp={cost.temp_bytes / 2**30:.2f}GiB")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry run")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--baseline", action="store_true",
                    help="paper-faithful pre-optimization sharding (§Perf)")
    ap.add_argument("--all", action="store_true",
                    help="every (assigned arch × shape), this mesh")
    ap.add_argument("--out", default=None, help="write JSON results here")
    args = ap.parse_args(argv)

    cases = []
    if args.all:
        for a in ASSIGNED:
            for s in INPUT_SHAPES:
                cases.append((a, s))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cases = [(args.arch, args.shape)]

    open_fake_group(512 if args.multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    device_type="cpu")
        results, failures = [], []
        for a, s in cases:
            try:
                results.append(run_case(a, s, multi_pod=args.multi_pod,
                                        baseline=args.baseline, mesh=mesh))
            except Exception as e:  # noqa: BLE001 — report and continue
                print(f"[{a} × {s}] FAILED: {type(e).__name__}: {e}")
                failures.append({"arch": a, "shape": s,
                                 "error": str(e)[:2000]})
    finally:
        dist.destroy_process_group()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"results": results, "failures": failures}, f, indent=1)
    print(f"\n{len(results)} ok, {len(failures)} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
