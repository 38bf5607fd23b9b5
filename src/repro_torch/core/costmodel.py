"""Latency / memory cost model for offloaded MoE inference.

The container is CPU-only, so host→device *time* cannot be measured —
but every quantity the paper reports is derivable from trace-level
counts (hits/misses/prefetches) plus hardware constants:

  token latency = attn_compute + moe_compute
                + (1-overlap_hidden) * transfer_stall

The defaults model the paper's setup (consumer GPU over PCIe4) and a
TPU v5e host-DMA profile is provided as an alternative. Table 1's
"~2 GB per extra offload" slope is reproduced by ``peak_memory_bytes``.
"""
from __future__ import annotations

import dataclasses

GiB = 1024 ** 3


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    flops: float              # effective FLOP/s for the expert GEMMs
    link_bw: float            # host->device bytes/s
    link_latency: float       # per-transfer fixed cost (s)
    hbm_bw: float             # device memory bytes/s
    # disk tier (FlashMoE-style SSD I/O model): the host<->disk link the
    # tiered memory manager prices demotions/promotions with. Defaults
    # model a PCIe4 NVMe drive; ``sata_ssd`` swaps in a slow profile.
    disk_bw: float = 3.5e9    # host<->disk bytes/s (sequential)
    disk_latency: float = 80e-6  # per-transfer fixed cost (s)

    def with_disk(self, bw: float, latency: float) -> "HardwareProfile":
        """Same compute/link profile over a different disk tier (the
        bench's tier-latency sweep axis)."""
        return dataclasses.replace(self, disk_bw=bw, disk_latency=latency)

    @classmethod
    def a6000_pcie4(cls):
        # ~38 TFLOP/s fp16 with ~50% MFU at bs=1; PCIe4 x16 ~25 GB/s eff.
        return cls("a6000", 19e12, 25e9, 20e-6, 768e9)

    @classmethod
    def a100_pcie4(cls):
        return cls("a100", 156e12, 25e9, 20e-6, 1555e9)

    @classmethod
    def l40_pcie4(cls):
        return cls("l40", 45e12, 25e9, 20e-6, 864e9)

    @classmethod
    def rtx3090_pcie4(cls):
        return cls("3090", 17e12, 22e9, 25e-6, 936e9)

    @classmethod
    def tpu_v5e(cls):
        # 197 TFLOP/s bf16; host DMA ~ 32 GB/s; 819 GB/s HBM.
        return cls("v5e", 98e12, 32e9, 10e-6, 819e9)

    @classmethod
    def by_name(cls, name: str) -> "HardwareProfile":
        return {"a6000": cls.a6000_pcie4, "a100": cls.a100_pcie4,
                "l40": cls.l40_pcie4, "3090": cls.rtx3090_pcie4,
                "v5e": cls.tpu_v5e}[name]()


@dataclasses.dataclass(frozen=True)
class ModelBytes:
    """Byte/FLOP shapes of one model for the cost model."""
    num_layers: int
    d_model: int
    expert_d_ff: int
    num_experts: int
    top_k: int
    expert_bytes: int          # bytes of ONE expert's weights (as stored)
    attn_bytes_per_layer: int  # non-expert per-layer weights resident bytes
    vocab_bytes: int
    kv_bytes_per_token: int = 0  # ONE layer's K+V rows for one position

    @classmethod
    def from_config(cls, cfg, *, expert_dtype_bytes: float = 2.0,
                    dense_dtype_bytes: float = 2.0):
        d, ff = cfg.d_model, cfg.expert_d_ff
        expert_bytes = int(3 * d * ff * expert_dtype_bytes)
        if cfg.use_mla:
            r, rd, H, hd = cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.num_heads, cfg.head_dim
            attn = d * H * (hd + rd) + d * (r + rd) + r * H * 2 * hd + H * hd * d
            kv_tok = (r + rd) * dense_dtype_bytes     # absorbed latent cache
        else:
            hd = cfg.head_dim
            attn = d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd \
                + cfg.num_heads * hd * d
            kv_tok = 2 * cfg.num_kv_heads * hd * dense_dtype_bytes
        attn_bytes = int(attn * dense_dtype_bytes)
        vocab_bytes = int(2 * cfg.vocab_size * d * dense_dtype_bytes)
        return cls(cfg.num_layers, d, ff, cfg.num_experts,
                   cfg.num_experts_per_tok, expert_bytes, attn_bytes,
                   vocab_bytes, int(kv_tok))

    def expert_flops_per_token(self) -> float:
        return 2.0 * 3 * self.d_model * self.expert_d_ff

    def attn_flops_per_token(self, ctx_len: int = 512) -> float:
        # projections + score/value against ctx_len cached keys
        proj = 2.0 * 4 * self.d_model * self.d_model
        attn = 2.0 * 2 * self.d_model * ctx_len
        return proj + attn


@dataclasses.dataclass
class CostModel:
    hw: HardwareProfile
    mb: ModelBytes
    overlap: bool = False      # prefetch transfers hidden under compute?
    ctx_len: int = 512

    # ---------------------------------------------------------- memory
    def peak_memory_bytes(self, offloads_per_layer: float,
                          kv_tokens: float = 0.0) -> int:
        """Device memory with `offloads_per_layer` experts offloaded
        (cache slots hold num_experts - offloads resident experts;
        may be fractional for non-uniform per-layer budgets).
        ``kv_tokens`` adds the residency of that many paged KV rows
        (block pool occupancy x block_size) across all layers."""
        resident = self.mb.num_experts - offloads_per_layer
        per_layer = self.mb.attn_bytes_per_layer + resident * self.mb.expert_bytes
        kv = kv_tokens * self.mb.kv_bytes_per_token
        return int(self.mb.num_layers * (per_layer + kv) + self.mb.vocab_bytes)

    def kv_block_bytes(self, block_size: int) -> int:
        """Device bytes one paged KV block pins ACROSS all layers (the
        pool is replicated per layer, block ids are shared)."""
        return int(block_size * self.mb.kv_bytes_per_token
                   * self.mb.num_layers)

    def kv_tokens_per_expert_slot(self) -> float:
        """How many paged KV rows fit in the bytes of ONE expert-cache
        slot (same layer). This is the residency exchange rate the
        paged scheduler trades on: shrinking the pool by this many
        tokens buys one more cached expert per layer — the block-size /
        pool-size tuning knob docs/serving.md discusses."""
        return self.mb.expert_bytes / max(self.mb.kv_bytes_per_token, 1)

    # ---------------------------------------------------------- timing
    def expert_transfer_time(self) -> float:
        return self.hw.link_latency + self.mb.expert_bytes / self.hw.link_bw

    # ------------------------------------------------- memory tiers
    def tier_transfer_time(self, nbytes: float, src: str, dst: str) -> float:
        """Seconds to move ``nbytes`` between memory tiers ("hbm",
        "host", "disk"). Each hop is latency + bytes/bandwidth on the
        link it crosses; hbm<->disk stages through host and pays both
        hops (FlashMoE-style I/O cost model — the tiered memory
        manager prices every demotion/promotion with this)."""
        assert src != dst and {src, dst} <= {"hbm", "host", "disk"}
        t = 0.0
        if "hbm" in (src, dst):
            t += self.hw.link_latency + nbytes / self.hw.link_bw
        if "disk" in (src, dst):
            t += self.hw.disk_latency + nbytes / self.hw.disk_bw
        return t

    def expert_fetch_extra_time(self, tier: str) -> float:
        """Stall a demand expert fetch adds ON TOP of the host->hbm
        transfer ``token_latency`` already prices per miss: 0 for a
        host-resident expert, the disk->host hop for a disk-resident
        one."""
        if tier == "host":
            return 0.0
        return self.hw.disk_latency + self.mb.expert_bytes / self.hw.disk_bw

    def layer_compute_time(self, batch: int = 1) -> float:
        tok_flops = (self.mb.attn_flops_per_token(self.ctx_len)
                     + self.mb.top_k * self.mb.expert_flops_per_token())
        # decode is memory-bound; floor at the HBM read of the active weights
        active_bytes = (self.mb.attn_bytes_per_layer
                        + self.mb.top_k * self.mb.expert_bytes)
        return max(batch * tok_flops / self.hw.flops,
                   active_bytes / self.hw.hbm_bw)

    def token_latency(self, misses_per_layer: float,
                      prefetch_per_layer: float = 0.0,
                      prefetch_hits_per_layer: float = 0.0,
                      batch: int = 1) -> float:
        """Seconds per token given trace-derived per-layer averages.

        misses: demand fetches that stall the layer.
        prefetch: speculative transfers issued (bandwidth cost).
        prefetch_hits: correct guesses (they remove a future demand miss;
        callers pass *post-prefetch* miss counts so this only matters for
        the overlap window accounting).

        The ``overlap`` branch here is ANALYTIC — a closed-form average
        that credits each speculative transfer one layer's compute
        window. Since PR 9 the engine's ``overlap=True`` mode no longer
        uses it for the clock: it executes transfers on the
        ``TransferEngine`` timeline and exposes the real per-layer
        ``max(0, dma_done - compute_done)`` stalls, against which this
        formula is validated (as an upper bound of the synchronous
        path) in tests and ``benchmarks/bench_overlap.py``. The formula
        stays because trace analyses and the synchronous path's
        ``step_latency`` depend on its exact arithmetic.
        """
        t_comp = self.layer_compute_time(batch)
        t_demand = misses_per_layer * self.expert_transfer_time()
        t_spec = prefetch_per_layer * self.expert_transfer_time()
        if self.overlap:
            # speculative transfers hide under the NEXT layer's compute
            t_spec = max(0.0, t_spec - t_comp)
        return self.mb.num_layers * (t_comp + t_demand + t_spec)

    def tokens_per_second(self, misses_per_layer: float, **kw) -> float:
        return 1.0 / self.token_latency(misses_per_layer, **kw)

    # ------------------------------------------------ batched serving
    def expected_union_experts(self, batch: int) -> float:
        """Expected DISTINCT experts per layer for a batch of tokens
        routing independently: E * (1 - (1 - k/E)^B).

        This is why misses amortize under batching — B co-scheduled
        tokens demand the union of their top-k sets, which grows
        sublinearly in B — and simultaneously why per-request hit rates
        degrade: the working set competing for the same slots grows.
        """
        E, k = self.mb.num_experts, self.mb.top_k
        return E * (1.0 - (1.0 - k / E) ** max(batch, 0))

    def expected_amortization(self, batch: int) -> float:
        """Fraction of naive per-token expert demand that survives
        unioning (1.0 at B=1, ->E/(B*k) as the union saturates)."""
        naive = max(batch, 1) * self.mb.top_k
        return self.expected_union_experts(batch) / naive

    def step_latency(self, union_misses_per_layer: float,
                     prefetch_per_layer: float = 0.0,
                     batch: int = 1) -> float:
        """Seconds for ONE decode step serving ``batch`` tokens.

        ``union_misses_per_layer`` are demand fetches for the batch's
        UNIONED working set (each missing expert is transferred once and
        shared by every request that routed to it); compute scales with
        ``batch`` inside ``layer_compute_time``. Per-token latency is
        this divided by the number of active requests — the continuous
        batching throughput win the serving benchmarks sweep.
        """
        return self.token_latency(union_misses_per_layer,
                                  prefetch_per_layer=prefetch_per_layer,
                                  batch=batch)

    def batched_tokens_per_second(self, union_misses_per_layer: float,
                                  batch: int = 1, **kw) -> float:
        return batch / self.step_latency(union_misses_per_layer,
                                         batch=batch, **kw)
