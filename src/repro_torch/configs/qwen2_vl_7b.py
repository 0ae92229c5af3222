"""Qwen2-VL-7B — VLM decoder with M-RoPE; vision tower is a stub
(precomputed patch embeddings).  [arXiv:2409.12191]"""
from repro_torch.core.types import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    rope_theta=1_000_000.0,
    vlm=VLMConfig(n_patches=1024, mrope_sections=(16, 24, 24)),
    source="arXiv:2409.12191 (Qwen2-VL)",
)
