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
through the table (``attention.gqa_decode_paged``; the CUDA kernel in
``kernels/csrc/paged_attention.cu``), so slot count and sequence length
decouple: the scheduler may overcommit the pool and handle exhaustion
by preempting/requeueing (see ``ContinuousOffloadServer``).

The allocator is pure host state (block ids only) and is property-
tested in isolation; pass ``cfg`` to also own the per-layer device
pools the engine's paged decode path reads and writes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


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
        if cfg is not None:
            if cfg.use_mla:
                raise NotImplementedError(
                    "paged MLA pools come with the MLA slice (ROADMAP.md)")
            from repro_torch.models import attention as attn
            self.state = {"layers": [
                attn.gqa_paged_cache_init(cfg, num_blocks + 1, block_size,
                                          dtype, device=device)
                for _ in range(cfg.num_layers)]}

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
