"""Whisper-large-v3 — encoder-decoder; mel/conv frontend is a stub
(precomputed frame embeddings).  [arXiv:2212.04356]"""
from repro_torch.core.types import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    norm="layernorm",
    activation="gelu",
    mlp_gated=False,
    rope_theta=0.0,  # whisper uses absolute (sinusoidal) positions
    encoder=EncoderConfig(n_layers=32, n_frames=1500),
    source="arXiv:2212.04356 (Whisper; large-v3 card)",
)
