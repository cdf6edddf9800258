"""DeepSeek-V2 236B [arXiv:2405.04434]: MLA (kv_lora=512) + MoE 160e top-6,
2 shared experts.  Primary showcase for the paper's block-wise (expert)
replication technique."""

from ..models.config import AttnConfig, ModelConfig, MoEConfig

FULL = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    d_ff=12288,  # dense-equivalent (unused: all layers MoE here)
    vocab=102_400,
    attn=AttnConfig(
        kind="mla",
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_rope_dim=64,
        qk_nope_dim=128,
        v_head_dim=128,
    ),
    moe=MoEConfig(n_experts=160, top_k=6, n_shared=2, d_ff_expert=1536),
    activation="silu_glu",
)

SMOKE = ModelConfig(
    name="deepseek-v2-236b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    d_ff=128,
    vocab=512,
    attn=AttnConfig(
        kind="mla",
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        kv_lora_rank=32,
        q_lora_rank=48,
        qk_rope_dim=8,
        qk_nope_dim=16,
        v_head_dim=16,
    ),
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_ff_expert=32),
    activation="silu_glu",
    remat="none",
)
