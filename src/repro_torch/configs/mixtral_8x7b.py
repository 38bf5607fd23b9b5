"""mixtral-8x7b [moe] — the paper's own model. [arXiv:2401.04088]

32L, d_model=4096, 32 heads (GQA kv=8), per-expert d_ff=14336,
vocab=32000, MoE 8 experts top-2. This is the model whose offloading
behavior the paper traces; the offload-mode experiments run its reduced
variant, and it participates in the dry-run as an extra (not one of the
40 assigned combos).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=32_000,
    pos_emb="rope",
    rope_theta=1e6,
    num_experts=8,
    num_experts_per_tok=2,
    moe_d_ff=14_336,
    long_context_window=8192,
    source="arXiv:2401.04088 (Mixtral of Experts)",
))
