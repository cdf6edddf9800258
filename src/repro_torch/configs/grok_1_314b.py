"""Grok-1 314B [hf:xai-org/grok-1]: MoE, 8 experts top-2, GQA(kv=8)."""

from ..models.config import AttnConfig, ModelConfig, MoEConfig

FULL = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    d_ff=32768,
    vocab=131_072,
    attn=AttnConfig(kind="gqa", n_heads=48, n_kv_heads=8, head_dim=128),
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=0, d_ff_expert=32768),
    activation="gelu_glu",
)

SMOKE = ModelConfig(
    name="grok-1-314b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    d_ff=128,
    vocab=512,
    attn=AttnConfig(kind="gqa", n_heads=4, n_kv_heads=2, head_dim=16),
    moe=MoEConfig(n_experts=4, top_k=2, n_shared=0, d_ff_expert=64),
    activation="gelu_glu",
    remat="none",
)
