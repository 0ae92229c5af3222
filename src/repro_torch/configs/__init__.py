"""Architecture registry (the port's share of ``repro.configs``).

Each config module exposes ``CONFIG`` (the full-size published config with
its source); ``reduced(cfg)`` gives the 2-layer smoke variant the CPU
tests use.  Every config of the reference is listed: the dense
qwen3-0.6b, stablelm-3b, granite-20b and minicpm3-4b (MLA), the moe
olmoe-1b-7b and phi3.5-moe-42b-a6.6b, the ssm falcon-mamba-7b, the hybrid
recurrentgemma-9b, the vlm qwen2-vl-7b and the encdec whisper-large-v3.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import (falcon_mamba_7b, granite_20b, minicpm3_4b,
                                 olmoe_1b_7b, phi35_moe_42b, qwen2_vl_7b,
                                 qwen3_0_6b, recurrentgemma_9b, stablelm_3b,
                                 whisper_large_v3)
from repro_torch.core.types import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    c.CONFIG.name: c.CONFIG
    for c in (qwen3_0_6b, falcon_mamba_7b, stablelm_3b, granite_20b,
              recurrentgemma_9b, olmoe_1b_7b, phi35_moe_42b, minicpm3_4b,
              qwen2_vl_7b, whisper_large_v3)
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant of the same family: 2 layers, d_model<=256,
    small vocab, f32 compute — the reference's ``reduced`` for every
    family (the ssm config is kept as it is; the
    hybrid one gets lru_width 256, a 64-token window and 4 layers: one
    full (recurrent, recurrent, attention) unit and a one-block remainder
    stage; MoE 4 experts, top-k at most 2, expert width 128; MLA the
    latent ranks 64 / 32, heads 32 + 16 wide, v 32 and ``head_dim`` 0;
    the encoder 2 layers over 32 frames; the VLM 8 patches, M-RoPE
    sections (8, 12, 12) over the 64-wide heads)."""
    kw = dict(
        name=cfg.name + "-smoke",
        ssm=cfg.ssm,
        n_layers=2,
        d_model=min(cfg.d_model, 256),
        n_heads=4,
        n_kv_heads=(min(max(cfg.n_kv_heads * 4 // cfg.n_heads, 1), 4)
                    if cfg.n_heads else 0),
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        head_dim=64,
        param_dtype="float32",
        compute_dtype="float32",
    )
    if cfg.rglru is not None:
        kw["rglru"] = dataclasses.replace(cfg.rglru, lru_width=256,
                                          attention_window=64)
        kw["n_layers"] = 4  # keep a full (rec, rec, attn) unit + remainder
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, n_experts=4,
                                        top_k=min(cfg.moe.top_k, 2),
                                        d_ff_expert=128)
    if cfg.mla is not None:
        kw["mla"] = dataclasses.replace(cfg.mla, q_lora_rank=64,
                                        kv_lora_rank=32, qk_nope_head_dim=32,
                                        qk_rope_head_dim=16, v_head_dim=32)
        kw["head_dim"] = 0
    if cfg.encoder is not None:
        kw["encoder"] = dataclasses.replace(cfg.encoder, n_layers=2,
                                            n_frames=32)
    if cfg.vlm is not None:
        kw["vlm"] = dataclasses.replace(cfg.vlm, n_patches=8,
                                        mrope_sections=(8, 12, 12))
    return dataclasses.replace(cfg, **kw)
