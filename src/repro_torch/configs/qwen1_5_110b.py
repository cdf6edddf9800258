"""Qwen1.5 110B [hf:Qwen family]: dense, GQA(kv=8), QKV bias."""

from ..models.config import AttnConfig, ModelConfig

FULL = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    d_ff=49152,
    vocab=152_064,
    attn=AttnConfig(
        kind="gqa", n_heads=64, n_kv_heads=8, head_dim=128, qkv_bias=True,
        rope_theta=1_000_000.0,
    ),
    activation="silu_glu",
)

SMOKE = ModelConfig(
    name="qwen1.5-110b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    d_ff=192,
    vocab=512,
    attn=AttnConfig(kind="gqa", n_heads=4, n_kv_heads=2, head_dim=16, qkv_bias=True),
    activation="silu_glu",
    remat="none",
)
