"""Logical-axis sharding over a ``torch.distributed`` device mesh (port
of ``repro.models.sharding``).

The JAX package names tensor dims with logical axes ("batch", "heads",
"vocab", ...); a launcher installs a mesh and rules that map each name
to a mesh axis, and XLA's partitioner inserts the collectives. The port
keeps the same context and the same rules, but the collectives are
explicit: every rank holds the slice of each tensor that its spec gives
it (``shard_params``), and the model code takes that slice as its
params: under a mesh every function's params are ``shard_params``'
output (a weight whose spec splits nothing is whole). It calls
``psum`` / ``pmax`` / ``all_gather`` / ``all_to_all`` over a named mesh
axis where the partitioner put an all-reduce, an all-gather or an
all-to-all. Under autograd each is differentiated by its transpose, so
training differentiates every rank's program as it is and then sums
each gradient over the axes its leaf is not split on (``psum_unsplit``).
The tensors stay plain ``torch.Tensor``s (no DTensor), so the ctypes
kernels take them as they are.

A spec is a plain tuple with one entry per dim: ``None`` (replicated), a
mesh-axis name, or a tuple of names (the dim split over their product,
row-major). The rules (``padded_count``, ``logical_to_spec``,
``sanitize_spec``, ``_spec_for``, ``param_pspecs``) are the JAX
package's, entry for entry.

``constrain`` is not ported: it asks XLA's partitioner to lay a value out
a given way and has no effect of its own, and here every function
already computes on the rank's slice and says where it communicates.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dims (``repro_torch.launch.mesh.make_mesh``). The rules read it through
``mesh_dim_names`` and ``size(i)`` only, so any object with those two
(a stand-in for the production mesh, say) works for them; the
collectives need the real mesh (``get_group``, ``get_local_rank``).
With no context installed nothing here is called by the model code.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

_CTX = {"mesh": None, "rules": {}}


def set_sharding(mesh, rules: dict) -> None:
    _CTX["mesh"] = mesh
    _CTX["rules"] = dict(rules)


def clear_sharding() -> None:
    _CTX["mesh"] = None
    _CTX["rules"] = {}


@contextmanager
def sharding_ctx(mesh, rules: dict):
    old = (_CTX["mesh"], _CTX["rules"])
    set_sharding(mesh, rules)
    try:
        yield
    finally:
        _CTX["mesh"], _CTX["rules"] = old


def active_mesh():
    return _CTX["mesh"]


def active_rules() -> dict:
    return _CTX["rules"]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh with named dims."""
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


def padded_count(n: int) -> int:
    """Round a head count up to the model-axis size so it shards
    evenly (zero-padded heads; exact because wo's padded rows are 0).
    Identity when no mesh/model rule is active or n already divides."""
    mesh = _CTX["mesh"]
    m = _CTX["rules"].get("model")
    if mesh is None or m is None or not _CTX["rules"].get("pad_heads", True):
        return n
    size = axis_sizes(mesh)[m]
    return -(-n // size) * size


def logical_to_spec(*axes) -> tuple:
    rules = _CTX["rules"]
    return tuple(rules.get(a) if a is not None else None for a in axes)


def entry_axes(axis) -> Tuple[str, ...]:
    """A spec entry as a tuple of mesh-axis names."""
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def sanitize_spec(spec: tuple, shape, mesh) -> tuple:
    """Drop mesh axes from dims they don't evenly divide (jit arg
    shardings require exact divisibility)."""
    sizes = axis_sizes(mesh)
    out = []
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for dim, axis in zip(shape, parts):
        if axis is None:
            out.append(None)
            continue
        total = 1
        for a in entry_axes(axis):
            total *= sizes[a]
        out.append(axis if dim % total == 0 else None)
    return tuple(out)


# ---------------------------------------------------------------------
# Parameter partition specs, derived from param-tree key paths.
# ---------------------------------------------------------------------
def _spec_for(path: str, ndim: int, rules: dict) -> tuple:
    """Map a parameter path (joined key names) + rank to a spec.

    Stacked (scanned) parameter trees have extra leading layer dims; the
    returned spec is padded with leading Nones to match ``ndim``.
    """
    m = rules.get("model")
    ep = rules.get("experts_mode", "ep")
    name = path.split("/")[-1]

    def base() -> tuple:
        # attention
        if name in ("wq", "wk", "wv"):
            return (None, m, None) if name == "wq" or rules.get("shard_kv", True) \
                else (None, None, None)
        if name == "wo":
            return (m, None, None)
        if name in ("bq", "bk", "bv"):
            return (m, None) if (name == "bq" or rules.get("shard_kv", True)) \
                else (None, None)
        if name in ("w_kb", "w_vb"):
            return (None, m, None)
        if name in ("w_dkv", "w_kr"):
            return (None, None)
        # mlp / moe
        if name in ("w1", "w3"):
            if "experts" in path:
                # stacked experts [E, d, ff]
                return (m, None, None) if ep == "ep" else (None, None, m)
            return (None, m)
        if name == "w2":
            if "experts" in path:
                return (m, None, None) if ep == "ep" else (None, m, None)
            return (m, None)
        if name in ("b1",):
            return (m,)
        if name in ("b2",):
            return (None,)
        if name == "router":
            return (None, None)
        # ssm
        if name in ("in_proj", "in_z", "in_xbc", "in_dt"):
            return (None, m)
        if name == "out_proj":
            return (m, None)
        if name == "conv_w":
            return (None, m)
        if name == "conv_b":
            return (m,)
        if name == "norm" and ndim >= 1:
            return (None,)
        # embeddings
        if name == "embed":
            return (None, m)
        if name == "unembed":
            return (None, m)
        return tuple()

    b = [a for a in base()]
    pad = ndim - len(b)
    if pad < 0:
        b = b[-ndim:] if ndim > 0 else []
        pad = 0
    return tuple([None] * pad + b)


def map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples, the
    path joined with "/" from dict keys and sequence indices (the JAX
    package's ``tree_map_with_path`` key names)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, f"{path}/{i}" if path
                                        else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_pspecs(params, rules: Optional[dict] = None, mesh=None):
    """Spec tree mirroring ``params`` (leaves need only ``.shape``). If
    ``mesh`` given, specs are divisibility-sanitized against leaf
    shapes."""
    rules = rules if rules is not None else _CTX["rules"]

    def f(path, leaf):
        spec = _spec_for(path, len(leaf.shape), rules)
        if mesh is not None:
            spec = sanitize_spec(spec, leaf.shape, mesh)
        return spec

    return map_with_path(f, params)


# ---------------------------------------------------------------------
# The rank's slices and the collectives
# ---------------------------------------------------------------------
def axis_index(axis, mesh=None) -> int:
    """This rank's index along a spec entry (a name or a tuple of names,
    row-major); 0 for ``None``."""
    mesh = mesh if mesh is not None else _CTX["mesh"]
    sizes = axis_sizes(mesh)
    idx = 0
    for a in entry_axes(axis):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


def axis_size(axis, mesh=None) -> int:
    """The number of ranks along a spec entry; 1 for ``None``."""
    n = 1
    if not entry_axes(axis):
        return n
    sizes = axis_sizes(mesh if mesh is not None else _CTX["mesh"])
    for a in entry_axes(axis):
        n *= sizes[a]
    return n


def local_slice(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (each named dim cut into
    equal blocks, the rank's taken), contiguous: a copy where the block is
    a strided part of ``t``, ``t`` itself where it is all of it (one rank,
    or no named dim)."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = axis_size(axis, mesh)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"over {axis!r} ({n} ranks)")
        size = t.shape[dim] // n
        t = t.narrow(dim, axis_index(axis, mesh) * size, size)
    return t.contiguous()


def zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree``, whose structure decides what a
    leaf is (a spec is itself a tuple)."""
    if isinstance(tree, dict):
        return {k: zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(zip_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def shard_tree(tree, specs, mesh):
    """Every leaf of ``tree`` cut to this rank's block by the spec at the
    same place in ``specs``."""
    return zip_map(lambda t, s: local_slice(t, s, mesh), tree, specs)


def gather_tree(tree, specs, mesh=None):
    """Inverse of ``shard_tree``: every leaf gathered along its split
    dims (a collective: every rank of the mesh calls it)."""
    def full(t, spec):
        for dim, axis in enumerate(spec):
            if axis is not None:
                t = all_gather(t, axis, dim, mesh)
        return t
    return zip_map(full, tree, specs)


def shard_params(params, mesh, rules: dict):
    """This rank's slice of every leaf of ``params`` (the whole tree, as
    ``init_params`` or ``from_jax_params`` made it), by its
    divisibility-sanitized ``param_pspecs`` spec."""
    return shard_tree(params, param_pspecs(params, rules, mesh), mesh)


def _groups(axis, mesh):
    mesh = mesh if mesh is not None else _CTX["mesh"]
    return [mesh.get_group(a) for a in entry_axes(axis)]


# The collectives under autograd. Each one's backward is its own
# transpose: an all-reduce's is the same all-reduce of the cotangents, an
# all-gather's a reduce-scatter, an all-to-all's the exchange with the
# splits reversed. So every rank's autograd gives the gradient of the sum
# of the ranks' outputs with respect to its own inputs: a training step
# differentiates loss / world size on each rank, then sums each
# gradient over the mesh axes its leaf is not split on
# (``psum_unsplit``), which is the gradient of the one global loss.
# Without autograd (grad mode off, or nothing to differentiate) the
# collectives run as they are, in place where they can.
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor
_ALL_GATHER_INTO = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """A fresh contiguous copy of ``x`` summed over ``group``."""
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _scatter_sum(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """A reduce-scatter: block i of ``x`` along ``dim``, summed over the
    ranks of ``group``, to rank i (a fresh contiguous tensor). The blocks
    are staged in rank order by one copy unless ``x`` already holds them
    so (one rank, or contiguous with no dim before ``dim`` longer than
    1)."""
    n, dim = dist.get_world_size(group), dim % x.dim()
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    src = x.contiguous() if n == 1 or math.prod(x.shape[:dim]) == 1 \
        else torch.stack(x.chunk(n, dim=dim))
    out = x.new_empty((*x.shape[:dim], x.shape[dim] // n,
                       *x.shape[dim + 1:]))
    _REDUCE_SCATTER(out.view(-1), src.view(-1), op=dist.ReduceOp.SUM,
                    group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.group, ctx.dim), None, None


def _exchange(x: torch.Tensor, group, out_rows, in_rows) -> torch.Tensor:
    rows = sum(out_rows) if out_rows is not None else x.shape[0]
    out = x.new_empty((rows, *x.shape[1:]))
    dist.all_to_all_single(out, x, output_split_sizes=out_rows,
                           input_split_sizes=in_rows, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, out_rows, in_rows):
        ctx.args = (group, in_rows, out_rows)   # the reverse exchange
        return _exchange(x, group, out_rows, in_rows)

    @staticmethod
    def backward(ctx, g):
        return (_exchange(g.contiguous(), *ctx.args), None, None, None)


def psum(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """Sum over the ranks along ``axis`` (a name or tuple of names).
    Under autograd a fresh result whose backward sums the cotangents
    over the same ranks; else ``x`` reduced in place and returned: pass
    a fresh result."""
    for g in _groups(axis, mesh):
        if _tracked(x):
            x = _AllReduce.apply(x, g)
        else:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=g)
    return x


def pmax(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """Elementwise max over the ranks along ``axis``, in place. It has no
    gradient: the callers take it of a detached max (a softmax's shift,
    which cancels), and a tensor that autograd tracks raises."""
    if _tracked(x):
        raise ValueError("pmax has no backward: pass a detached tensor")
    for g in _groups(axis, mesh):
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=g)
    return x


def all_gather(x: torch.Tensor, axis, dim: int, mesh=None) -> torch.Tensor:
    """The ranks' blocks along ``axis`` concatenated on ``dim`` in rank
    order (row-major over a tuple of names). Its backward is a
    reduce-scatter."""
    x = x.contiguous()
    for g in reversed(_groups(axis, mesh)):   # innermost axis first
        x = _AllGather.apply(x, g, dim) if _tracked(x) else _gather(x, g, dim)
    return x


def reduce_scatter(x: torch.Tensor, axis: str, dim: int,
                   mesh=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks along the mesh axis ``axis``, of
    which the rank of index i keeps block i of ``dim`` (a fresh
    contiguous tensor). It has no autograd: ``all_gather``'s backward is
    the differentiated use."""
    return _scatter_sum(x, _groups(axis, mesh)[0], dim)


def all_gather_into(out: torch.Tensor, x: torch.Tensor, axis: str,
                    dim: int, mesh=None) -> torch.Tensor:
    """``out`` (in place, and returned) set to the ranks' blocks ``x``
    along the mesh axis ``axis`` concatenated on ``dim`` in rank order:
    one ``all_gather_single`` (``all_gather_into_tensor``) into a buffer
    of ``out``'s size, then one copy into ``out``, however ``dim`` lies.
    No autograd."""
    g = _groups(axis, mesh)[0]
    n = dist.get_world_size(g)
    buf = x.new_empty(n * x.numel())
    _ALL_GATHER_INTO(buf, x.contiguous().view(-1), group=g)
    out.unflatten(dim, (n, x.shape[dim])).movedim(dim, 0).copy_(
        buf.view(n, *x.shape))
    return out


def all_to_all(x: torch.Tensor, axis: str, out_rows=None, in_rows=None,
               mesh=None) -> torch.Tensor:
    """One all-to-all over the mesh axis ``axis``: ``x``'s leading dim is
    cut into blocks of ``in_rows`` (equal blocks by default), block j sent
    to rank j; returns the blocks received, block i (``out_rows[i]`` rows,
    or as many as sent) from rank i. Its backward is the reverse
    exchange."""
    x = x.contiguous()
    g = _groups(axis, mesh)[0]
    if _tracked(x):
        return _AllToAll.apply(x, g, out_rows, in_rows)
    return _exchange(x, g, out_rows, in_rows)


def added_axis(spec: tuple, moment_spec: tuple):
    """(dim, axis) where a moment's spec (``launch.specs.opt_state_pspecs``)
    splits a dim over a mesh axis that its param's ``spec`` keeps whole
    (ZeRO-1's data axis), or None where the two split alike."""
    for dim, (a, b) in enumerate(zip(spec, moment_spec)):
        if a != b:
            if a is not None:
                raise ValueError(f"moment spec {moment_spec} does not refine "
                                 f"the param spec {spec}")
            return dim, b
    return None


def psum_unsplit(t: torch.Tensor, spec: tuple, moment_spec: tuple,
                 mesh=None) -> torch.Tensor:
    """A gradient leaf ``t`` (the rank's block of its leaf under the param
    spec ``spec``) summed over the mesh axes ``spec`` does not split: one
    all-reduce over the whole mesh (the default group) where it splits
    none, else one an axis, in place where ``t`` is contiguous. Where the
    leaf's ``moment_spec`` adds an axis on a dim (ZeRO-1's data axis), the
    sum over that axis is a reduce-scatter onto the rank's block of the
    dim, first, and the other axes' all-reduces run on the block; an
    empty such leaf is only cut to its (empty) block, with no collective,
    alike on every rank. Returns the sum."""
    mesh = mesh if mesh is not None else _CTX["mesh"]
    with torch.no_grad():
        t = t.contiguous()
        split = {a for e in spec for a in entry_axes(e)}
        added = added_axis(spec, moment_spec)
        if added is not None:
            dim, axis = added
            if t.numel() == 0:
                return t.narrow(dim, 0, t.shape[dim] // axis_size(axis, mesh))
            t = reduce_scatter(t, axis, dim, mesh)
            split.update(entry_axes(axis))
        axes = tuple(a for a in mesh.mesh_dim_names if a not in split)
        if len(axes) == mesh.ndim:
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
        elif axes:
            psum(t, axes, mesh)
    return t


# ---------------------------------------------------------------------
# What the model code asks of the active mesh
# ---------------------------------------------------------------------
def model_axis():
    """The active mesh's model axis name; None without a mesh or without
    a model rule (the model code's every sharded branch keys on it)."""
    return _CTX["rules"].get("model") if _CTX["mesh"] is not None else None


def model_split(n: int) -> bool:
    """Whether a dim of ``n`` splits over the model axis (a spec naming
    the axis survives ``sanitize_spec``)."""
    m = model_axis()
    return m is not None and n % axis_size(m) == 0


def batch_axis():
    """The batch rule under the active mesh (a name, a tuple of names or
    None)."""
    return _CTX["rules"].get("batch") if _CTX["mesh"] is not None else None


def batch_rows(t: torch.Tensor) -> torch.Tensor:
    """The rank's rows of a whole batch ``t`` (leading dim) under the
    batch rule. The rule is set only where the batch splits
    (``sharding_rules(global_batch=...)``): a batch that does not split
    raises."""
    b = batch_axis()
    if b is None:
        return t
    n = axis_size(b)
    if t.shape[0] % n:
        raise ValueError(f"a batch of {t.shape[0]} does not split over "
                         f"{b!r} ({n} ranks); build the rules with "
                         f"sharding_rules(cfg, mesh, global_batch=...)")
    size = t.shape[0] // n
    return t.narrow(0, axis_index(b) * size, size)


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Inverse of ``batch_rows``: the whole batch on every rank."""
    b = batch_axis()
    return t if b is None else all_gather(t, b, 0)
