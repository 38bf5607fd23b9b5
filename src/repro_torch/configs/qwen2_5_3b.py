"""qwen2.5-3b [dense]. [hf:Qwen/Qwen2.5-0.5B family card]

36L, d_model=2048, 16 heads (GQA kv=2), d_ff=11008, vocab=151936,
QKV bias.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11_008,
    vocab_size=151_936,
    pos_emb="rope",
    rope_theta=1e6,
    qkv_bias=True,
    tie_embeddings=True,
    long_context_window=8192,
    source="hf:Qwen/Qwen2.5-3B",
))
