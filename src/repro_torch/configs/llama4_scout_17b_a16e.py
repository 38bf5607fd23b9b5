"""llama4-scout-17b-a16e [moe]. [hf:meta-llama/Llama-4-Scout-17B-16E]

48L, d_model=5120, 40 heads (GQA kv=8), per-expert d_ff=8192,
vocab=202048, MoE 16 experts top-1. The "early fusion" multimodal
frontend is out of scope for the language backbone (text path is the
system under test); noted in DESIGN.md.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    pos_emb="rope",
    rope_theta=5e5,
    num_experts=16,
    num_experts_per_tok=1,
    moe_d_ff=8192,
    long_context_window=8192,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
))
