"""Nemotron-4 15B [arXiv:2402.16819]: dense, GQA(kv=8), squared-ReLU MLP."""

from ..models.config import AttnConfig, ModelConfig

FULL = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    d_ff=24576,
    vocab=256_000,
    attn=AttnConfig(kind="gqa", n_heads=48, n_kv_heads=8, head_dim=128, rope_theta=10_000.0),
    activation="sq_relu",
)

SMOKE = ModelConfig(
    name="nemotron-4-15b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    d_ff=256,
    vocab=512,
    attn=AttnConfig(kind="gqa", n_heads=4, n_kv_heads=2, head_dim=16),
    activation="sq_relu",
    remat="none",
)
