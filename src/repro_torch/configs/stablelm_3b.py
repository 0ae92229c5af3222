"""StableLM-3B — dense decoder.  [hf:stabilityai/stablelm-2-1_6b family]"""
from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    norm="layernorm",
    rope_theta=10000.0,
    source="hf:stabilityai/stablelm-2-1_6b (StableLM-2 family; 3B dims)",
)
