"""qwen1.5-0.5b [dense]. [hf:Qwen/Qwen1.5-0.5B]

24L, d_model=1024, 16 heads (kv=16, i.e. MHA), d_ff=2816, vocab=151936,
QKV bias.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151_936,
    pos_emb="rope",
    qkv_bias=True,
    tie_embeddings=True,
    long_context_window=8192,
    source="hf:Qwen/Qwen1.5-0.5B",
))
