"""RecurrentGemma-9B — RG-LRU + local attention, 2:1 pattern.
[arXiv:2402.19427 (Griffin)]"""
from repro_torch.core.types import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    activation="gelu",
    rglru=RGLRUConfig(lru_width=4096, conv_kernel=4,
                      block_pattern=("recurrent", "recurrent", "attention"),
                      attention_window=2048),
    source="arXiv:2402.19427 (Griffin / RecurrentGemma-9B)",
)
