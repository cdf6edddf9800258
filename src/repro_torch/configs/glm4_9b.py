"""GLM-4 9B [hf:THUDM/glm-4-9b]: dense, RoPE, GQA(kv=2)."""

from ..models.config import AttnConfig, ModelConfig

FULL = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    d_ff=13696,
    vocab=151_552,
    attn=AttnConfig(kind="gqa", n_heads=32, n_kv_heads=2, head_dim=128, rope_theta=10_000.0),
    activation="silu_glu",
)

SMOKE = ModelConfig(
    name="glm4-9b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    d_ff=128,
    vocab=512,
    attn=AttnConfig(kind="gqa", n_heads=4, n_kv_heads=2, head_dim=16),
    activation="silu_glu",
    remat="none",
)
