"""Paged KV cache for continuous-batching offload serving.

The dense serving state gave every batch slot a private ``[cache_len]``
KV strip, coupling slot count to max sequence length: admission could
never overcommit and long-prompt scenarios wasted HBM that could have
held cached experts instead (the paper's actual scarce resource). Here
KV lives in ONE pool of fixed-size blocks shared by every request:

  pool      [num_blocks, block_size, ...]   per layer, device memory
  free list [block ids]                     host, LIFO for reuse warmth
  table     rid -> [phys block ids]         logical block i of request
                                            rid lives at table[rid][i]

A token at request-local position ``p`` lives at
``(table[rid][p // block_size], p % block_size)``. Attention reads K/V
through the table (``attention.gqa_decode_paged``, the CUDA kernel in
``kernels/csrc/paged_attention.cu``; or MLA's latent and rope key,
``attention.mla_decode_paged``), so slot count and sequence length
decouple: the scheduler may overcommit the pool and handle exhaustion
by preempting/requeueing (see ``ContinuousOffloadServer``).

The allocator is pure host state (block ids only) and is property-
tested in isolation; pass ``cfg`` to also own the per-layer device
pools the engine's paged decode path reads and writes. Built under a
device mesh (``sharding.sharding_ctx``) the GQA pools hold the rank's KV
heads (``attention.gqa_paged_cache_init``) and MLA's latent pools are
whole; neither has a row dim, so every data rank's pool holds every
row's blocks. The allocator, the tables and the sink block are the same
on every rank, and ``block_nbytes`` is what one block of the unsharded
pool holds, so that a park is priced alike on every rank and as without
a mesh.

``park_blocks`` / ``restore_blocks`` move a request's blocks to host
tensors and back (the memory tiers' KV parking, see
``repro_torch.core.memory_tiers``). On a card both are asynchronous to
the host and ordered by events: a park gathers on the compute stream,
where the kernels that wrote the blocks run, into one buffer and copies
it to pinned host memory on the copy stream; a resume copies it to the
card on the copy stream and scatters on the compute stream, before any
kernel reads.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


class PagedKVCache:
    """Block-pool allocator (+ optional per-layer device K/V pools)."""

    def __init__(self, num_blocks: int, block_size: int, *,
                 cfg=None, dtype=None, device="cuda"):
        assert num_blocks >= 1 and block_size >= 1
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO free list: a just-retired request's blocks are handed to
        # the next admit (warm reuse, and deterministic for tests)
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self.tables: Dict[int, List[int]] = {}
        self.peak_used = 0
        # physical block ``num_blocks`` is the SINK: never allocated,
        # it backs every padded table entry, so inactive batch rows and
        # short rows' tail entries scatter/gather there instead of into
        # a live request's block (dense slots made such writes harmless
        # by construction; a shared pool must route them somewhere)
        self.sink = num_blocks

        # device pools, one per layer (num_blocks + 1: the sink block is
        # storage, not capacity); the paged decode path writes them in
        # place
        self.state = None
        self.block_nbytes = 0
        if cfg is not None:
            from repro_torch.models import attention as attn
            from repro_torch.models.sharding import sharding_ctx
            init = (attn.mla_paged_cache_init if cfg.use_mla
                    else attn.gqa_paged_cache_init)
            self.state = {"layers": [
                init(cfg, num_blocks + 1, block_size, dtype, device=device)
                for _ in range(cfg.num_layers)]}
            # one block of the unsharded pool (every KV head; MLA's latent
            # and rope key), every layer's pool tensors: a meta block
            # built outside any mesh
            with sharding_ctx(None, {}):
                block = init(cfg, 1, block_size, dtype, device="meta")
            self.block_nbytes = cfg.num_layers * sum(
                t.numel() * t.element_size() for t in block.values())

    # ----------------------------------------------------------- sizes
    @property
    def capacity_tokens(self) -> int:
        return self.num_blocks * self.block_size

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` KV rows."""
        return -(-max(n_tokens, 0) // self.block_size)

    # ------------------------------------------------------- lifecycle
    def allocate(self, rid: int) -> None:
        """Register a live request with an empty block table."""
        assert rid not in self.tables, f"rid {rid} already live"
        self.tables[rid] = []

    def reserve(self, rid: int, n_tokens: int) -> bool:
        """Grow ``rid``'s table to cover ``n_tokens`` positions.

        All-or-nothing: on shortfall the table is left untouched and
        False is returned (the caller preempts or defers admission)."""
        table = self.tables[rid]
        need = self.blocks_for(n_tokens) - len(table)
        if need <= 0:
            return True
        if need > len(self._free):
            return False
        for _ in range(need):
            table.append(self._free.pop())
        self.peak_used = max(self.peak_used, self.used_blocks)
        return True

    def ensure(self, rid: int, pos: int) -> bool:
        """Make position ``pos`` addressable. One-token decode grows by
        at most one block; a chunked prefill passes the chunk's LAST
        position and may claim several blocks at once — ``reserve`` is
        all-or-nothing either way, so a failed multi-block grow leaves
        the table untouched for the preempt-and-retry loop."""
        return self.reserve(rid, pos + 1)

    def free_request(self, rid: int) -> List[int]:
        """Retire ``rid``; its blocks return to the free list."""
        blocks = self.tables.pop(rid)
        self._free.extend(reversed(blocks))
        return blocks

    # ---------------------------------------------------------- views
    def table_array(self, rids: Sequence[Optional[int]],
                    min_blocks: int = 1) -> np.ndarray:
        """Dense ``[B, T]`` int32 block-table for a batch of slots.

        ``rids[b]`` is the request in slot b (None = free slot). T is
        the longest live table (>= min_blocks); rows are padded with
        the SINK block — attention masks gathers past ``idx <= pos``
        (every position <= pos is backed by a real table entry), and
        inactive rows' scatters land in the sink instead of a live
        request's block."""
        T = max([min_blocks] + [len(self.tables[r]) for r in rids
                                if r is not None])
        out = np.full((len(rids), T), self.sink, np.int32)
        for b, r in enumerate(rids):
            if r is None:
                continue
            t = self.tables[r]
            out[b, :len(t)] = t
        return out

    # ------------------------------------------------ host tier moves
    def _pool(self) -> torch.Tensor:
        """One pool tensor (layer 0's first: ``k`` for GQA, ``latent``
        for MLA), for the pools' device and dtype."""
        return next(iter(self.state["layers"][0].values()))

    def _index(self, blocks: Sequence[int]) -> torch.Tensor:
        """``blocks`` as an index tensor on the pools' device (uploaded
        from pinned memory, so the host does not wait for the stream)."""
        idx = torch.tensor(list(blocks), dtype=torch.long)
        dev = self._pool().device
        if dev.type != "cuda":
            return idx
        return idx.pin_memory().to(dev, non_blocking=True)

    def _views(self, flat: torch.Tensor, n: int) -> List[Dict]:
        """Per-layer views of ``flat``, one ``[n, *block shape]`` view
        for each of the layer's pool tensors under its key (``{"k",
        "v"}`` for GQA, ``{"latent", "k_rope"}`` for MLA): ``flat`` holds
        ``n`` blocks of every pool tensor, layer by layer."""
        out, off = [], 0
        for layer in self.state["layers"]:
            views = {}
            for k, t in layer.items():
                size = n * t[0].numel()
                views[k] = flat[off:off + size].view(n, *t.shape[1:])
                off += size
            out.append(views)
        return out

    def _follow(self, waiter, stream) -> None:
        """Make ``waiter`` wait for the work queued so far on ``stream``."""
        if waiter != stream:
            waiter.wait_stream(stream)

    def _move(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """Queue the copy of ``src`` into ``dst`` on the current stream."""
        dst.copy_(src, non_blocking=True)

    def park_blocks(self, blocks: Sequence[int],
                    copy_stream=None) -> "KVSnapshot":
        """Snapshot ``blocks`` (in that order) of every layer's pool into
        one host buffer (a ``KVSnapshot``: per-layer views ``[n, ...]``
        of the pool's tensors, under their keys), so the move is one
        copy.

        On a card the blocks are gathered on the current (compute)
        stream into one device buffer; ``copy_stream`` (the current
        stream if None) waits for the gather and copies the buffer into
        pinned host memory. Nothing waits on the host, and the caller may
        free the blocks at once: a later write to them is queued on the
        compute stream behind the gather. The snapshot holds the KV once
        the copy has run; read it on the same stream (``restore_blocks``)
        or after a synchronization."""
        idx = self._index(blocks)
        n = len(blocks)
        layers = self.state["layers"]
        pool = self._pool()
        size = n * sum(t[0].numel() for layer in layers
                       for t in layer.values())
        gathered = torch.empty(size, dtype=pool.dtype, device=pool.device)
        for views, layer in zip(self._views(gathered, n), layers):
            for k, t in layer.items():
                torch.index_select(t, 0, idx, out=views[k])
        if pool.device.type != "cuda":
            return KVSnapshot(self._views(gathered, n), gathered)
        # Pinned buffers come from PyTorch's caching host allocator. A
        # non-blocking copy records an event on the block for its stream,
        # and a freed block is handed out again only once those events
        # have completed: no later park can be given a buffer that this
        # copy, or the resume's copy out of it, still writes or reads.
        host = torch.empty(size, dtype=pool.dtype, pin_memory=True)
        compute = torch.cuda.current_stream(pool.device)
        stream = copy_stream if copy_stream is not None else compute
        self._follow(stream, compute)
        with torch.cuda.stream(stream):
            self._move(host, gathered)
        gathered.record_stream(stream)
        return KVSnapshot(self._views(host, n), host)

    def restore_blocks(self, blocks: Sequence[int], saved: "KVSnapshot",
                       copy_stream=None) -> None:
        """Write the snapshot ``saved`` (``park_blocks``) into ``blocks``
        of every layer's pool, in that order.

        On a card the snapshot's buffer is copied to a device staging
        buffer on ``copy_stream`` (the current stream if None) — the
        stream its park copied on, so that copy has landed first — and
        the current (compute) stream waits for it, then scatters into the
        blocks: every later kernel reads the restored KV. Nothing waits
        on the host."""
        idx = self._index(blocks)
        staged = saved.flat
        dev = self._pool().device
        if dev.type == "cuda":
            compute = torch.cuda.current_stream(dev)
            stream = copy_stream if copy_stream is not None else compute
            with torch.cuda.stream(stream):
                # allocated on the stream that writes it first
                staged = torch.empty(saved.flat.shape,
                                     dtype=saved.flat.dtype, device=dev)
                self._move(staged, saved.flat)
            self._follow(compute, stream)
            staged.record_stream(compute)
        for views, layer in zip(self._views(staged, len(blocks)),
                                self.state["layers"]):
            for k, t in layer.items():
                t.index_copy_(0, idx, views[k])

    def check_no_aliasing(self) -> None:
        """Invariant: every allocatable block id is owned by exactly
        one live table or the free list; the sink is owned by nobody
        (asserted by the property tests)."""
        seen: Dict[int, str] = {}
        for rid, table in self.tables.items():
            for blk in table:
                assert 0 <= blk < self.num_blocks  # sink never allocated
                assert blk not in seen, \
                    f"block {blk} aliased: {seen[blk]} and rid {rid}"
                seen[blk] = f"rid {rid}"
        for blk in self._free:
            assert blk not in seen, f"block {blk} free AND {seen[blk]}"
            seen[blk] = "free"
        assert len(seen) == self.num_blocks


class KVSnapshot(list):
    """A parked request's KV: per-layer dicts of the pool's tensors
    (``{"k", "v"}`` for GQA, ``{"latent", "k_rope"}`` for MLA), all views
    of ``flat``, one buffer (pinned host memory when the pool is on a
    card), so that a park or a resume moves it in one copy."""

    def __init__(self, layers: List[Dict], flat: torch.Tensor):
        super().__init__(layers)
        self.flat = flat
