"""Qwen2-VL 2B [arXiv:2409.12191]: dense VLM backbone with M-RoPE.

The vision frontend (dynamic-resolution patch embed) is a STUB per the
assignment: the backbone consumes token ids; `input_specs` can also provide
precomputed patch embeddings."""

from ..models.config import AttnConfig, ModelConfig

FULL = ModelConfig(
    name="qwen2-vl-2b",
    family="dense",
    n_layers=28,
    d_model=1536,
    d_ff=8960,
    vocab=151_936,
    attn=AttnConfig(
        kind="gqa",
        n_heads=12,
        n_kv_heads=2,
        head_dim=128,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),  # (t, h, w) frequency bands; sums to hd/2
    ),
    activation="silu_glu",
    frontend="vision_stub",
)

SMOKE = ModelConfig(
    name="qwen2-vl-2b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    d_ff=128,
    vocab=512,
    attn=AttnConfig(
        kind="gqa", n_heads=4, n_kv_heads=2, head_dim=16, qkv_bias=True,
        mrope_sections=(2, 3, 3),
    ),
    activation="silu_glu",
    frontend="vision_stub",
    remat="none",
)
