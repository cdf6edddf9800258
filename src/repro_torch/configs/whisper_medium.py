"""Whisper medium [arXiv:2212.04356]: enc-dec transformer backbone.

The mel-spectrogram conv frontend is a STUB per the assignment:
`input_specs` provides precomputed frame embeddings (b, 1500, d_model)."""

from ..models.config import AttnConfig, ModelConfig

FULL = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,  # decoder layers
    n_encoder_layers=24,
    encoder_seq=1500,
    d_model=1024,
    d_ff=4096,
    vocab=51_865,
    attn=AttnConfig(kind="gqa", n_heads=16, n_kv_heads=16, head_dim=64),
    activation="gelu",
    frontend="audio_stub",
)

SMOKE = ModelConfig(
    name="whisper-medium-smoke",
    family="encdec",
    n_layers=2,
    n_encoder_layers=2,
    encoder_seq=32,
    d_model=64,
    d_ff=128,
    vocab=512,
    attn=AttnConfig(kind="gqa", n_heads=4, n_kv_heads=4, head_dim=16),
    activation="gelu",
    frontend="audio_stub",
    remat="none",
)
