"""Model configuration for all assigned architectures.

One flexible config covers dense / MoE / SSM / hybrid / enc-dec families so
the distribution layer, launcher and dry-run treat every architecture
uniformly (``--arch <id>``).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Literal

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "AttnConfig"]

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec"]
Activation = Literal["silu_glu", "gelu_glu", "sq_relu", "gelu"]


@dataclass(frozen=True)
class AttnConfig:
    kind: Literal["gqa", "mla", "none"] = "gqa"
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: tuple[int, ...] = ()  # qwen2-vl M-RoPE (t, h, w) dims
    # MLA (DeepSeek-V2)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128
    causal: bool = True


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # Paper technique: extra replicas of hot experts (block-wise allocation).
    replication: tuple[int, ...] = ()  # replicas per expert; () -> all 1
    # Serving-only: shard each expert's ff dim over ('data', 'model') with
    # replicated tokens — weight-stationary 2D slicing for huge experts
    # (Grok) whose count divides no mesh axis.
    serve_ff_2d: bool = False


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    attn: AttnConfig = field(default_factory=AttnConfig)
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    activation: Activation = "silu_glu"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # hybrid (zamba2): one shared attention block applied every `shared_every`
    # SSM layers (weights shared across applications).
    shared_every: int = 0
    # enc-dec (whisper)
    n_encoder_layers: int = 0
    encoder_seq: int = 1500  # 30 s of audio at 50 Hz after the conv frontend
    # modality frontend stub: inputs arrive as precomputed embeddings
    frontend: Literal["none", "vision_stub", "audio_stub"] = "none"
    # compute dtype for activations (params kept fp32 master in the optimizer)
    dtype: str = "bfloat16"
    # activation remat policy for the scan-over-layers
    remat: Literal["none", "full", "dots"] = "full"

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    # ------------------------------------------------------------- accounting
    @property
    def sub_quadratic(self) -> bool:
        """True if 500k-token decode is feasible (SSM/hybrid state models)."""
        return self.family in ("ssm", "hybrid")

    def attn_dims(self) -> tuple[int, int, int]:
        a = self.attn
        hd = a.head_dim or (self.d_model // max(a.n_heads, 1))
        return a.n_heads, a.n_kv_heads, hd

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS = 6ND)."""
        d = self.d_model
        n = 0
        n += self.vocab * d * (1 if self.tie_embeddings else 2)
        L = self.n_layers

        def attn_params() -> int:
            a = self.attn
            if a.kind == "none":
                return 0
            nh, nkv, hd = self.attn_dims()
            if a.kind == "mla":
                p = d * a.q_lora_rank + a.q_lora_rank * nh * (a.qk_nope_dim + a.qk_rope_dim)
                p += d * (a.kv_lora_rank + a.qk_rope_dim)
                p += a.kv_lora_rank * nh * (a.qk_nope_dim + a.v_head_dim)
                p += nh * a.v_head_dim * d
                return p
            p = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
            if a.qkv_bias:
                p += (nh + 2 * nkv) * hd
            return p

        def ffn_params(ff: int) -> int:
            mats = 3 if self.activation.endswith("_glu") else 2
            return mats * d * ff

        def ssm_params() -> int:
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            p = d * (2 * di + 2 * s.n_groups * s.d_state + nh)  # in_proj
            p += s.d_conv * (di + 2 * s.n_groups * s.d_state)  # conv1d
            p += nh * 2  # A_log, D
            p += di * d  # out_proj
            return p

        if self.family == "dense":
            n += L * (attn_params() + ffn_params(self.d_ff))
        elif self.family == "moe":
            m = self.moe
            per_layer = attn_params()
            per_layer += m.n_experts * ffn_params(m.d_ff_expert)
            per_layer += m.n_shared * ffn_params(m.d_ff_expert)
            per_layer += d * m.n_experts  # router
            n += L * per_layer
        elif self.family == "ssm":
            n += L * ssm_params()
        elif self.family == "hybrid":
            n += L * ssm_params()
            n += attn_params() + ffn_params(self.d_ff)  # one shared block
        elif self.family == "encdec":
            n += self.n_encoder_layers * (attn_params() + ffn_params(self.d_ff))
            # decoder: self-attn + cross-attn + ffn
            n += L * (2 * attn_params() + ffn_params(self.d_ff))
        n += L * 2 * d  # norms (approx)
        return n

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only top-k + shared experts)."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        full = self.param_count()
        mats = 3 if self.activation.endswith("_glu") else 2
        expert_p = mats * self.d_model * m.d_ff_expert
        inactive = self.n_layers * (m.n_experts - m.top_k) * expert_p
        return full - inactive
