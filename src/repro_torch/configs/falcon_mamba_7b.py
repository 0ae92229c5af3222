"""Falcon-Mamba-7B — attention-free Mamba-1 SSM.  [arXiv:2410.05355]"""
from repro_torch.core.types import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    ssm=SSMConfig(state_dim=16, conv_kernel=4, expand=2),
    source="arXiv:2410.05355 (Falcon-Mamba)",
)
