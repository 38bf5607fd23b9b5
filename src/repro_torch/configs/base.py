"""Model/config system.

Every architecture in the assigned pool is expressed as a single
``ModelConfig`` consumed by ``repro_torch.models.transformer``.  Configs are
frozen dataclasses (hashable, comparable field by field with the JAX
package's copy).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

Family = str  # "dense" | "moe" | "ssm" | "hybrid" | "encdec" | "vlm"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    source: str = ""  # citation for the config

    head_dim: Optional[int] = None

    # --- attention ---
    pos_emb: str = "rope"  # "rope" | "sinusoidal" | "none"
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    sliding_window: Optional[int] = None      # always-on window (unused by default)
    long_context_window: Optional[int] = None  # SWA fallback for long_500k only

    # --- MLA (DeepSeek-V2) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: Optional[int] = None  # per-expert ffn dim (defaults to d_ff)
    capacity_factor: float = 1.25
    moe_every: int = 1  # layer i is MoE iff i % moe_every == moe_every-1

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0  # hybrid: layer i is attention iff i % attn_every == 0

    # --- encoder-decoder (audio) ---
    encoder_layers: int = 0
    encoder_frames: int = 0  # stub frontend sequence length

    # --- VLM ---
    cross_attn_every: int = 0  # layer i gets cross-attn iff (i+1) % N == 0
    num_image_tokens: int = 0

    # --- misc ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    zero1: bool = False  # shard optimizer state over the data axis too

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim is None:
            hd = self.d_model // max(self.num_heads, 1)
            object.__setattr__(self, "head_dim", hd)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def has_moe(self, i: int) -> bool:
        return self.is_moe and (i % self.moe_every == self.moe_every - 1)

    def layer_kind(self, i: int) -> str:
        """'attn' or 'ssm' mixer for decoder layer i."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            return "attn" if (i % self.attn_every) == 0 else "ssm"
        return "attn"

    def has_cross_attn(self, i: int) -> bool:
        if self.family == "encdec":
            return True
        if self.family == "vlm" and self.cross_attn_every:
            return (i + 1) % self.cross_attn_every == 0
        return False

    # ---- parameter counting (for roofline MODEL_FLOPS) --------------
    def param_counts(self) -> Tuple[int, int]:
        """Returns (total_params, active_params_per_token)."""
        d, hd = self.d_model, self.head_dim
        total = active = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d
            active += self.vocab_size * d

        def attn_params() -> int:
            if self.use_mla:
                r, rd = self.kv_lora_rank, self.qk_rope_dim
                p = d * self.num_heads * (hd + rd)          # q proj
                p += d * (r + rd)                            # kv_a
                p += r * self.num_heads * (hd + hd)          # kv_b (k_nope + v)
                p += self.num_heads * hd * d                 # o
                return p
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            return q + kv + o

        def ssm_params() -> int:
            di, n, g = self.d_inner, self.ssm_state, 1
            H = self.ssm_nheads
            p = d * (2 * di + 2 * g * n + H)   # in_proj (z,x,B,C,dt)
            p += self.ssm_conv_width * (di + 2 * g * n)  # conv
            p += H * (2 + self.ssm_headdim)    # A_log, D, dt_bias-ish
            p += di * d                        # out_proj
            return p

        def dense_ffn() -> int:
            return 3 * d * self.d_ff

        def moe_ffn() -> Tuple[int, int]:
            e = 3 * d * self.expert_d_ff
            tot = self.num_experts * e + self.num_shared_experts * e
            tot += d * self.num_experts  # router
            act = (self.num_experts_per_tok + self.num_shared_experts) * e
            act += d * self.num_experts
            return tot, act

        for i in range(self.num_layers):
            kind = self.layer_kind(i)
            mixer = attn_params() if kind == "attn" else ssm_params()
            total += mixer
            active += mixer
            if self.has_cross_attn(i):
                total += attn_params()
                active += attn_params()
            if self.family == "ssm":
                continue  # mamba2 blocks have no separate FFN
            if self.has_moe(i):
                t, a = moe_ffn()
                total += t
                active += a
            else:
                total += dense_ffn()
                active += dense_ffn()
        for _ in range(self.encoder_layers):
            total += attn_params() + dense_ffn()
            active += attn_params() + dense_ffn()
        return total, active


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

_REGISTRY = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    # import side-effect registration
    from repro_torch.configs import (  # noqa: F401
        deepseek_v2_236b, jamba_1_5_large_398b, llama4_scout_17b_a16e,
        llama_3_2_vision_11b, mamba2_2_7b, mixtral_8x7b, qwen1_5_0_5b,
        qwen1_5_32b, qwen2_5_3b, starcoder2_3b, whisper_tiny)


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 256,
            experts: int = 4, vocab: int = 512) -> ModelConfig:
    """A smoke-test-sized variant of the same architecture family."""
    num_heads = max(2, min(4, cfg.num_heads))
    head_dim = d_model // num_heads
    kv = cfg.num_kv_heads if cfg.num_kv_heads >= cfg.num_heads else max(
        1, min(cfg.num_kv_heads, num_heads))
    if cfg.num_kv_heads == cfg.num_heads:
        kv = num_heads
    n_exp = min(cfg.num_experts, experts) if cfg.is_moe else 0
    top_k = min(cfg.num_experts_per_tok, n_exp) if n_exp else 0
    attn_every = min(cfg.attn_every, 2) if cfg.attn_every else 0
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        num_layers=layers,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=kv,
        head_dim=head_dim,
        d_ff=4 * d_model if cfg.d_ff else 0,
        moe_d_ff=2 * d_model if cfg.is_moe else None,
        vocab_size=vocab,
        num_experts=n_exp,
        num_experts_per_tok=top_k,
        num_shared_experts=min(cfg.num_shared_experts, 1),
        kv_lora_rank=64 if cfg.use_mla else 0,
        qk_rope_dim=32 if cfg.use_mla else cfg.qk_rope_dim,
        ssm_state=min(cfg.ssm_state, 32) if cfg.ssm_state else 0,
        ssm_headdim=32 if cfg.ssm_state else cfg.ssm_headdim,
        ssm_chunk=64,
        attn_every=attn_every,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_frames=min(cfg.encoder_frames, 64),
        num_image_tokens=min(cfg.num_image_tokens, 33),
        cross_attn_every=min(cfg.cross_attn_every, 2) if cfg.cross_attn_every else 0,
    )
