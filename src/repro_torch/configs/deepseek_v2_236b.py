"""deepseek-v2-236b [moe, MLA]. [arXiv:2405.04434]

60L, d_model=5120, 128 heads, MLA with kv_lora_rank=512 (+64-d rope key),
per-expert d_ff=1536, vocab=102400; 2 shared + 160 routed experts, top-6.
Decode caches the 512-d compressed latent + 64-d rope key per position
(the whole point of MLA).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=1536,
    vocab_size=102_400,
    pos_emb="rope",
    use_mla=True,
    kv_lora_rank=512,
    qk_rope_dim=64,
    num_experts=160,
    num_experts_per_tok=6,
    num_shared_experts=2,
    moe_d_ff=1536,
    long_context_window=8192,
    zero1=True,
    source="arXiv:2405.04434 (DeepSeek-V2)",
))
