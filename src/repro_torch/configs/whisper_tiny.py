"""whisper-tiny [audio, enc-dec]. [arXiv:2212.04356]

4 encoder + 4 decoder layers, d_model=384, 6 heads (kv=6), d_ff=1536,
vocab=51865. The mel-spectrogram + conv frontend is a STUB: input_specs
supplies precomputed frame embeddings of shape [B, 1500, 384].

Whisper uses sinusoidal (encoder) / learned (decoder) positions; we use
sinusoidal for both so decode positions scale past the real 448-token
decoder limit (the 32k/500k decode shapes are a scaling exercise; noted
in DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    pos_emb="sinusoidal",
    qkv_bias=True,
    encoder_layers=4,
    encoder_frames=1500,
    long_context_window=8192,
    source="arXiv:2212.04356 (Whisper)",
))
