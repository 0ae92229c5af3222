"""Core configuration types (a copy of ``repro.core.types``).

Plain frozen dataclasses: every architecture is a :class:`ModelConfig`
(with its analytic parameter counts, which the roofline's 6·N·D reads),
the benchmark input shapes :class:`InputShape`, the optimizer/DC-S3GD
hyper-parameters a :class:`DCS3GDConfig`.  Field
names and defaults are the reference's, so a config means the same run
in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    # load-balance auxiliary loss coefficient (Switch-style)
    aux_loss_coef: float = 0.01
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 style selective SSM."""

    state_dim: int = 16
    conv_kernel: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU block settings."""

    lru_width: int = 0           # 0 -> d_model
    conv_kernel: int = 4
    block_pattern: Tuple[str, ...] = ("recurrent", "recurrent", "attention")
    attention_window: int = 2048  # local attention window


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style)."""

    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder tower for enc-dec models (whisper)."""

    n_layers: int
    n_frames: int = 1500


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    """VLM decoder settings (vision tower stubbed by patch embeddings)."""

    n_patches: int = 1024
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # attention features
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0          # 0 = full causal attention
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    activation: str = "silu"          # silu (gated) | gelu (plain)
    mlp_gated: bool = True
    # sub-configs (None when not applicable)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    mla: Optional[MLAConfig] = None
    encoder: Optional[EncoderConfig] = None
    vlm: Optional[VLMConfig] = None
    # dtypes
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # pad attention heads up to this count for even TP sharding (0 = off)
    pad_heads_to: int = 0
    # citation for the config (paper/model card)
    source: str = ""

    @property
    def eff_n_heads(self) -> int:
        return max(self.pad_heads_to, self.n_heads) if self.n_heads else 0

    @property
    def eff_n_kv_heads(self) -> int:
        if self.n_kv_heads and self.n_kv_heads == self.n_heads:
            return self.eff_n_heads  # MHA: pad kv alongside q
        return self.n_kv_heads

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        emb = V * d
        head = 0 if self.tie_embeddings else V * d
        per_layer = 0
        if self.family == "ssm":
            assert self.ssm is not None
            e = self.ssm.expand * d
            dt_rank = self.ssm.dt_rank or -(-d // 16)
            per_layer = (
                d * 2 * e            # in_proj (x, z)
                + e * self.ssm.conv_kernel
                + e * (dt_rank + 2 * self.ssm.state_dim)  # x -> dt,B,C
                + dt_rank * e        # dt proj
                + e * self.ssm.state_dim  # A_log
                + e                  # D
                + e * d              # out_proj
                + d                  # norm
            )
        else:
            # attention (or recurrent) mixer + mlp
            if self.mla is not None:
                m = self.mla
                qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
                attn = (
                    d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk_dim
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.n_heads
                    * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d
                )
            else:
                attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                    + self.n_heads * hd * d
            mlp_mult = 3 if self.mlp_gated else 2
            if self.moe is not None:
                mlp = d * self.moe.n_experts \
                    + self.moe.n_experts * mlp_mult * d * self.moe.d_ff_expert
            else:
                mlp = mlp_mult * d * f
            # recurrent blocks count as attention of the same size: crude,
            # but enough for the roofline's 6·N·D
            per_layer = attn + mlp + 2 * d
        total = emb + head + self.n_layers * per_layer
        if self.encoder is not None:
            enc_layer = 4 * d * d + mlp_mult_for(self) * d * f + 2 * d
            total += self.encoder.n_layers * enc_layer
            # decoder cross-attention adds another attn block per layer
            total += self.n_layers * 4 * d * d
        return total

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.n_params()
        m = self.moe
        mlp_mult = 3 if self.mlp_gated else 2
        full_moe = m.n_experts * mlp_mult * self.d_model * m.d_ff_expert
        active_moe = m.top_k * mlp_mult * self.d_model * m.d_ff_expert
        return self.n_params() - self.n_layers * (full_moe - active_moe)


def mlp_mult_for(cfg: ModelConfig) -> int:
    return 3 if cfg.mlp_gated else 2


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.global_batch * self.seq_len


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {s.name: s
                for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


# ---------------------------------------------------------------------------
# Optimizer / DC-S3GD hyper-parameters (paper §III/§IV-A)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DCS3GDConfig:
    learning_rate: float = 0.1
    momentum: float = 0.9
    lambda0: float = 0.2            # variance-control base (Eq. 17)
    weight_decay: float = 1e-4
    weight_decay_k: float = 2.3     # paper's wd multiplier
    # schedule (iteration-dependent linear warm-up + linear decay)
    warmup_steps: int = 0
    total_steps: int = 1
    schedule_weight_decay: bool = True  # paper applies the LR schedule to wd
    # lambda_i normalisation: 'global' (tree-global norms) or 'per_tensor'
    lambda_norm: str = "global"
    # local optimizer U(.): 'momentum' (paper) | 'lars' | 'adam' (§V)
    local_optimizer: str = "momentum"
    nesterov: bool = False
    # max per-worker step skew for the 'dynamic_ssp' staleness policy
    ssp_threshold: int = 4
    # communication precision for the delta all-reduce
    comm_dtype: str = "float32"
    # 'hierarchical' reducer: number of worker groups
    hier_groups: int = 2
    # 'gossip' reducer: ring neighbors averaged on each side per step
    gossip_neighbors: int = 1
    # compressed reducers: kept fraction per bucket / powersgd rank
    compress_density: float = 0.01
    compress_rank: int = 4
    # flat-buffer comm bucketing: target number of contiguous BLOCK-aligned
    # buckets (repro_torch.parallel.buckets); 0 = per-leaf paths
    buckets: int = 0
    # storage dtype of the per-worker optimizer slots and delta_prev
    state_dtype: str = "float32"
    # gradient-accumulation microbatches per step
    microbatches: int = 1
