"""OLMoE-1B-7B — MoE, 64 experts top-8.  [arXiv:2409.02060]"""
from repro_torch.core.types import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    qk_norm=True,
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024),
    source="arXiv:2409.02060 (OLMoE)",
)
