"""Qwen2.5 32B [hf:Qwen family]: dense, GQA(kv=8), QKV bias."""

from ..models.config import AttnConfig, ModelConfig

FULL = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    d_ff=27648,
    vocab=152_064,
    attn=AttnConfig(
        kind="gqa", n_heads=40, n_kv_heads=8, head_dim=128, qkv_bias=True,
        rope_theta=1_000_000.0,
    ),
    activation="silu_glu",
)

SMOKE = ModelConfig(
    name="qwen2.5-32b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    d_ff=160,
    vocab=512,
    attn=AttnConfig(kind="gqa", n_heads=4, n_kv_heads=2, head_dim=16, qkv_bias=True),
    activation="silu_glu",
    remat="none",
)
