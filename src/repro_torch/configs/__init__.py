"""Architecture registry (the port's share of ``repro.configs``).

Each config module exposes ``CONFIG`` (the full-size published config with
its source); ``reduced(cfg)`` gives the 2-layer smoke variant the CPU
tests use.  Only the configs the port can run are listed (the dense
qwen3-0.6b and the ssm falcon-mamba-7b); the others are queued in
ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import falcon_mamba_7b, qwen3_0_6b
from repro_torch.core.types import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    c.CONFIG.name: c.CONFIG for c in (qwen3_0_6b, falcon_mamba_7b)
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant of the same family: 2 layers, d_model<=256,
    small vocab, f32 compute — the reference's ``reduced`` for the dense
    and ssm families (the ssm config is kept as it is)."""
    return dataclasses.replace(
        cfg,
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
