"""Zamba2 1.2B [arXiv:2411.15242]: Mamba2 backbone + shared attention block.

One transformer block (attention + MLP) with SHARED weights is applied after
every `shared_every` Mamba2 layers — the paper's block duplication idea in
reverse: one weight block serving many layer positions (each application
site keeps its own KV cache)."""

from ..models.config import AttnConfig, ModelConfig, SSMConfig

FULL = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    d_ff=8192,
    vocab=32_000,
    attn=AttnConfig(kind="gqa", n_heads=32, n_kv_heads=32, head_dim=64),
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128),
    shared_every=6,
    activation="gelu_glu",
)

SMOKE = ModelConfig(
    name="zamba2-1.2b-smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    d_ff=128,
    vocab=512,
    attn=AttnConfig(kind="gqa", n_heads=4, n_kv_heads=4, head_dim=16),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16),
    shared_every=2,
    activation="gelu_glu",
    remat="none",
)
