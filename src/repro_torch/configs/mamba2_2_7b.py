"""mamba2-2.7b [ssm, attention-free]. [arXiv:2405.21060]

64L, d_model=2560, d_inner=5120 (expand 2), headdim=64 (80 SSD heads),
ssm_state=128, vocab=50280. No attention, no separate FFN (Mamba2 blocks
only). long_500k runs natively (constant-size recurrent state).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=1,    # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50_280,
    pos_emb="none",
    ssm_state=128,
    ssm_headdim=64,
    source="arXiv:2405.21060 (Mamba2/SSD)",
))
