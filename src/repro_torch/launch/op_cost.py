"""Per-device cost of an eager program, counted as it runs (the
counterpart of ``repro.launch.hlo_cost``).

The JAX package lowers a case with ``jax.jit`` and walks the optimized
HLO text: dot FLOPs, elementwise and transcendental counts, bytes at
fusion boundaries and collective bytes, with each ``while`` body
multiplied by its trip count. The port has no HLO to parse: it runs
eagerly, one kernel an aten op, and its program is what it dispatches.
So ``OpCost``, a ``TorchDispatchMode``, counts each aten op as it runs,
on any device; on ``meta`` tensors (the dry run) nothing is allocated
and nothing is computed. The conventions, with ``hlo_cost``'s kept where
they carry over:

* matmul-class ops (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  ``convolution``): 2 x result x contraction, by the formulas of
  ``torch.utils.flop_counter``'s registry (``matmul_flops`` holds their
  part of ``flops``);
* elementwise ops (tagged ``pointwise``; ``clone`` is a copy): 1 flop a
  result element; reductions 1 an input element; a softmax 4 (max,
  subtract, sum, divide) and one exponential an element;
* transcendentals apart, 1 a result element: exp, log, tanh, rsqrt,
  sqrt, sigmoid, silu, softplus, erf, pow (and their kin below);
* bytes: each op's operand + result bytes, the traffic the eager program
  pays (eager runs one kernel an op; this is not XLA's fusion-boundary
  count). A broadcast operand counts its distinct elements. Views,
  metadata ops and allocations are free; a fill writes its result once;
  gathers (``embedding``, ``index_select``, ``index``, ``gather``) count
  the result and the indices, not the table; in-place slice writes
  (``copy_`` into a view, ``index_put_``, ``scatter_``, ...) count the
  slice twice, ``hlo_cost._io_bytes``' dynamic-update-slice rule;
* collectives (``c10d`` ops): result bytes a kind, under
  ``hlo_cost.COLLECTIVES``' names (``all-reduce``, ``all-gather``,
  ``all-to-all``, ``reduce-scatter``: the kinds an NCCL run issues), and
  their input + result bytes in ``bytes_accessed``;
* a kernel wrapper's call (``kernels.ops``) is one opaque call: the
  kernel's closed-form FLOPs and bytes, and nothing of what the wrapper
  runs inside it, so a call counts the same on ``meta``, ``cpu`` (the
  plain version) and ``cuda`` (the kernel);
* memory: ``temp_bytes`` is the peak of the bytes allocated inside the
  mode and still live (each fresh storage from its op until its last
  tensor is freed, ``weakref.finalize``); a kernel call allocates its
  outputs, not its scratch; a collective runs on copies of its tensors
  (``_on_copies``), so a communication library's worker thread never
  holds, and frees, the program's own.

Eager has no loops to multiply: every executed op is counted once, so
there are no trip counts. ``by_op`` splits the aten ops' part by op
(calls, FLOPs, bytes), as a profile splits time.
"""
from __future__ import annotations

import math
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import flop_registry

_TRANSCENDENTAL = frozenset({
    "exp", "exp2", "expm1", "log", "log1p", "log2", "tanh", "rsqrt",
    "sqrt", "sigmoid", "silu", "softplus", "erf", "pow", "sin", "cos",
    "gelu"})
_REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax",
    "argmin", "cumsum", "cumprod", "var", "std", "var_mean",
    "linalg_vector_norm", "norm", "any", "all", "logsumexp"})
_SOFTMAX = frozenset({"_softmax", "_log_softmax"})
_COPIES = frozenset({"clone"})
_GATHERS = frozenset({"embedding", "index_select", "index", "gather"})
_FILLS = frozenset({"fill_", "zero_"})
_FREE = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                   "new_empty_strided", "_unsafe_view",
                   "_local_scalar_dense"})
# the c10d ops the port issues (``sharding.psum`` / ``pmax``,
# ``all_gather`` and its backward, ``all_to_all``, ZeRO-1's
# ``reduce_scatter`` and ``all_gather_into``) -> hlo_cost.COLLECTIVES'
# name; any other counts under its own name
_COLLECTIVES = {"allreduce_": "all-reduce", "allgather_": "all-gather",
                "_allgather_base_": "all-gather",
                "alltoall_base_": "all-to-all",
                "_reduce_scatter_base_": "reduce-scatter"}


def tensors(tree):
    """The tensors among the leaves of ``tree``."""
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def nbytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s distinct elements (a broadcast dim, stride 0,
    counts once)."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _on_copies(func, args, kwargs):
    """``func(*args, **kwargs)`` for a collective, run on copies of its
    tensors, waited for, and its results copied back into the tensors it
    writes. A communication library may hold the tensors it is given until
    its worker thread lets go of them (gloo's work queue does), so their
    Python objects, and ``OpCost``'s finalizers on them, would be freed on
    that thread at a time that varies from run to run; the copies take
    that hold, and the caller's tensors live as long as the program keeps
    them. Every c10d op writes its results into its first argument (its
    schema says so by name, ``tensors`` / ``output...``, not by alias
    annotation), so that argument's tensors are the ones copied back; the
    inputs are left as they are, which also holds where an input is a
    view of an output. Runs with the mode off (inside its dispatch): the
    copies are not counted."""
    pairs = {}

    def swap(x):
        if not isinstance(x, torch.Tensor):
            return x
        if id(x) not in pairs:
            pairs[id(x)] = (x, x.detach().clone())
        return pairs[id(x)][1]

    out = func(*tree_map(swap, args), **tree_map(swap, kwargs))
    for leaf in tree_leaves(out):
        if not isinstance(leaf, torch.Tensor) and hasattr(leaf, "wait"):
            leaf.wait()
    first = func._schema.arguments[0].name
    for t in tensors(args[0] if args else kwargs[first]):
        t.copy_(pairs[id(t)][1])
    back = {id(c): o for o, c in pairs.values()}
    return tree_map(lambda x: back.get(id(x), x)
                    if isinstance(x, torch.Tensor) else x, out)


class OpCost(TorchDispatchMode):
    """Counts what the program run inside it does (see the module's
    docstring). Use as ``with OpCost() as c: ...``, then ``c.to_dict()``;
    one instance counts one run."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.matmul_flops = 0
        self.transcendental = 0
        self.bytes_accessed = 0
        self.collectives: Dict[str, int] = {}
        self.collective_calls: Dict[str, int] = {}
        self.kernel_calls: Dict[str, Dict[str, int]] = {}
        self.by_op: Dict[str, Dict[str, int]] = {}
        self.devices: set = set()
        self.temp_bytes = 0
        self._live = 0
        self._opaque = 0

    @property
    def collective_total(self) -> int:
        return sum(self.collectives.values())

    def to_dict(self) -> Dict:
        return {"flops": self.flops, "matmul_flops": self.matmul_flops,
                "transcendental": self.transcendental,
                "bytes_accessed": self.bytes_accessed,
                "collectives": dict(self.collectives),
                "collective_calls": dict(self.collective_calls),
                "collective_total": self.collective_total,
                "kernel_calls": {k: dict(v)
                                 for k, v in self.kernel_calls.items()},
                "by_op": {k: dict(v) for k, v in self.by_op.items()},
                "temp_bytes": self.temp_bytes,
                "devices": sorted(self.devices)}

    # ------------------------------------------------------- memory
    def _allocated(self, t: torch.Tensor, size: int) -> None:
        """``size`` bytes live until the last tensor over ``t``'s storage
        is freed: a view keeps its base (the tensor it was cut from, not
        the view it came through) alive, so the finalizer goes there."""
        self.devices.add(t.device.type)
        self._live += size
        self.temp_bytes = max(self.temp_bytes, self._live)
        weakref.finalize(t if t._base is None else t._base, self._freed,
                         size)

    def _freed(self, size: int) -> None:
        self._live -= size

    # ------------------------------------------------------ kernels
    def kernel_call(self, name: str, cost, run):
        """One call of kernel ``name`` (``kernels.ops._counted``): its
        closed-form ``cost()`` = (flops, bytes); ``run()``'s own ops are
        not counted, its outputs are allocated."""
        flops, nb = cost()
        self._opaque += 1
        try:
            out = run()
        finally:
            self._opaque -= 1
        rec = self.kernel_calls.setdefault(
            name, {"calls": 0, "flops": 0, "bytes": 0})
        rec["calls"] += 1
        rec["flops"] += flops
        rec["bytes"] += nb
        self.flops += flops
        self.bytes_accessed += nb
        for t in tensors(out):
            self._allocated(t, t.numel() * t.element_size())
        return out

    # ---------------------------------------------------------- ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d":
            out = _on_copies(func, args, kwargs)
            if not self._opaque:
                self._collective(func, args)
            return out
        out = func(*args, **kwargs)
        if self._opaque:
            return out
        ins = tensors((args, kwargs))
        outs = tensors(out)
        seen = {_storage(t) for t in ins}
        for t in outs:
            if _storage(t) not in seen:
                seen.add(_storage(t))
                self._allocated(t, t.untyped_storage().nbytes())
        name = func.overloadpacket.__name__
        if func.is_view or name in _FREE:
            return out
        flops, matmul, trans = self._flops(func, name, args, kwargs, ins,
                                           out, outs)
        nb = self._bytes(name, args, ins, outs)
        self.flops += flops
        self.matmul_flops += matmul
        self.transcendental += trans
        self.bytes_accessed += nb
        rec = self.by_op.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        rec["calls"] += 1
        rec["flops"] += flops
        rec["bytes"] += nb
        return out

    @staticmethod
    def _flops(func, name, args, kwargs, ins, out, outs):
        """(flops, of which matmul, transcendentals) of one op."""
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            n = int(formula(*args, **kwargs, out_val=out))
            return n, n, 0
        n = outs[0].numel() if outs else 0
        if name.rstrip("_") in _TRANSCENDENTAL:
            return 0, 0, n
        if name in _SOFTMAX:
            return 4 * n, 0, n
        if name in _REDUCTIONS:
            return ins[0].numel(), 0, 0
        if torch.Tag.pointwise in func.tags and name not in _COPIES:
            return n, 0, 0
        return 0, 0, 0

    @staticmethod
    def _bytes(name, args, ins, outs) -> int:
        out_b = sum(nbytes(t) for t in outs)
        if name in _FILLS:
            return out_b
        if name in _GATHERS:      # result + indices, not the table
            return out_b + sum(nbytes(t) for t in ins[1:])
        if name == "copy_":       # the slice read and written
            return nbytes(args[0]) + nbytes(args[1])
        if name in ("index_put_", "_index_put_impl_"):
            idx = sum(nbytes(t) for t in tensors(args[1]))
            return 2 * nbytes(args[2]) + idx
        if name in ("scatter_", "scatter_add_", "scatter_reduce_"):
            index = args[2]
            return 2 * index.numel() * args[0].element_size() + nbytes(index)
        if name in ("index_copy_", "index_add_"):
            return 2 * nbytes(args[3]) + nbytes(args[2])
        return out_b + sum(nbytes(t) for t in ins)

    def _collective(self, func, args) -> None:
        name = func.overloadpacket.__name__
        kind = _COLLECTIVES.get(name, name)
        result = tensors(args[0])
        inputs = result if kind == "all-reduce" else tensors(args[1])
        for t in result + inputs:
            self.devices.add(t.device.type)
        out_b = sum(nbytes(t) for t in result)
        self.collectives[kind] = self.collectives.get(kind, 0) + out_b
        self.collective_calls[kind] = self.collective_calls.get(kind, 0) + 1
        self.bytes_accessed += out_b + sum(nbytes(t) for t in inputs)
