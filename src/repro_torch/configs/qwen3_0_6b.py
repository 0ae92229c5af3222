"""Qwen3-0.6B — dense decoder with qk-norm + GQA.  [hf:Qwen/Qwen3-8B]"""
from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B (Qwen3 family card; 0.6B variant dims)",
)
