"""starcoder2-3b [dense]. [arXiv:2402.19173]

30L, d_model=3072, 24 heads (GQA kv=2), d_ff=12288, vocab=49152; RoPE.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12_288,
    vocab_size=49_152,
    pos_emb="rope",
    rope_theta=1e5,
    long_context_window=8192,
    source="arXiv:2402.19173 (StarCoder2)",
))
