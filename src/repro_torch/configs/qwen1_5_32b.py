"""qwen1.5-32b [dense]. [hf:Qwen/Qwen1.5-32B]

64L, d_model=5120, 40 heads (kv=40, MHA), d_ff=27392, vocab=152064,
QKV bias.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27_392,
    vocab_size=152_064,
    pos_emb="rope",
    qkv_bias=True,
    long_context_window=8192,
    source="hf:Qwen/Qwen1.5-32B",
))
