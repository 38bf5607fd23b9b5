"""Device meshes and per-architecture sharding rules (port of
``repro.launch.mesh``).

Single pod: (16, 16) = 256 ranks, axes ("data", "model").
Multi-pod:  (2, 16, 16) = 512 ranks, axes ("pod", "data", "model") —
the "pod" axis is an extra data-parallel dimension (batch shards over
("pod","data")).

A mesh is a ``torch.distributed`` ``DeviceMesh`` with named dims, made
over the default process group, which the caller opens first
(``torch.distributed.init_process_group`` with its own address, world
size and rank; nothing here reads a cluster's environment). Importing
this module starts nothing.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.models.sharding import axis_sizes


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the ranks of the default group
    (row-major), dims named ``axes``; ``device_type`` "cuda" (NCCL) or
    "cpu" (gloo)."""
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(f"a {shape} mesh needs a process group of {n} "
                           f"ranks; have {have}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh: (16, 16) or (2, 16, 16). It is built only in
    a process group of 256 (512) ranks; ``make_mesh`` refuses any other."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def sharding_rules(cfg, mesh, *, global_batch: Optional[int] = None,
                   baseline: bool = False) -> Dict:
    """Logical-axis → mesh-axis rules for this (arch, mesh, batch).

    - tiny archs (whisper) replicate weights entirely (pure DP);
    - "model" shards q-heads/ffn/vocab/ssm-inner; kv heads shard only
      when evenly divisible (else replicated — GQA kv counts are small);
    - MoE experts shard on "model" when E % model == 0 (expert
      parallelism, all-to-all dispatch), else expert weights shard their
      ffn dim (tensor parallelism — e.g. Mixtral's 8 experts on a
      16-way axis);
    - batch shards over ("pod","data") when divisible, else replicates
      (long_500k's global_batch=1).
    """
    sizes = axis_sizes(mesh)
    m = sizes["model"]
    b_axes = batch_axes(mesh)
    n_batch_shards = 1
    for a in b_axes:
        n_batch_shards *= sizes[a]

    tiny = cfg.d_model * cfg.num_layers < 16_384  # whisper-tiny class
    model_ax = None if tiny else "model"

    batch_rule: Optional[Tuple[str, ...]] = b_axes
    if global_batch is not None and global_batch % n_batch_shards != 0:
        batch_rule = None

    rules = {
        "batch": batch_rule,
        "model": model_ax,
        "heads": model_ax,
        "vocab": model_ax,
        "experts": model_ax,
        "capacity": None if tiny else "data",
        # caches/projections are head-padded to the axis size (see
        # attention._head_padding) so kv shards whenever the padded
        # count divides; sanitize_spec still drops non-dividing dims.
        "shard_kv": bool(model_ax),
        "experts_mode": "ep" if (cfg.num_experts and model_ax
                                 and cfg.num_experts % m == 0) else "tp",
        "_data_size": sizes["data"],
    }
    if baseline:
        # paper-faithful / pre-optimization configuration (§Perf):
        # pjit-scatter MoE dispatch, no head padding (replicated attn for
        # H % 16 != 0), replicated MLA latent cache
        rules.update({"pad_heads": False, "moe_shardmap": False,
                      "mla_seq_shard": False,
                      "shard_kv": bool(model_ax) and cfg.num_kv_heads % m == 0})
    return rules
