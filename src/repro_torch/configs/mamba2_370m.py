"""Mamba2 370M [arXiv:2405.21060]: attention-free SSD state-space model."""

from ..models.config import AttnConfig, ModelConfig, SSMConfig

FULL = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    d_ff=0,
    vocab=50_280,
    attn=AttnConfig(kind="none"),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=128),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-370m-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    d_ff=0,
    vocab=512,
    attn=AttnConfig(kind="none"),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=32),
    tie_embeddings=True,
    remat="none",
)
