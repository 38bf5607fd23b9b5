"""llama-3.2-vision-11b [vlm]. [hf:meta-llama/Llama-3.2-11B-Vision]

40L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=128256;
cross-attention image layers every 5th layer. The ViT vision encoder +
projector is a STUB: input_specs supplies projected patch embeddings
[B, 1601, 4096].
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=128_256,
    pos_emb="rope",
    rope_theta=5e5,
    cross_attn_every=5,
    num_image_tokens=1601,
    long_context_window=8192,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
))
