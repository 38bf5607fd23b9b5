"""jamba-1.5-large-398b [hybrid]. [arXiv:2403.19887]

72L, d_model=8192, 64 heads (GQA kv=8), d_ff=24576, vocab=65536,
MoE 16 experts top-2 on every SECOND layer (Jamba's e=2 rhythm — this
is what makes the 398B total / ~94B active arithmetic work out);
Mamba+attention 1:7 interleave (one attention layer per 8). SSM layers
use the Mamba2/SSD formulation of this repo's uniform SSM substrate.
Optimizer state uses ZeRO-1 data-axis sharding (398B params do not fit
fp32 Adam states on one pod otherwise).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24_576,
    vocab_size=65_536,
    pos_emb="none",  # Jamba uses no positional encoding in attention layers
    num_experts=16,
    num_experts_per_tok=2,
    moe_d_ff=24_576,
    moe_every=2,
    ssm_state=128,
    ssm_headdim=64,
    ssm_chunk=128,  # §Perf: halves SSD intra-chunk decay traffic vs 256
    attn_every=8,
    long_context_window=8192,  # attention layers windowed at 500k decode
    zero1=True,
    source="arXiv:2403.19887 (Jamba-1.5)",
))
