"""Hymba-1.5B: hybrid parallel attention + Mamba heads [arXiv:2411.13676]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab_size=32001, head_dim=64, ssm_state=16, ssm_expand=2,
    sliding_window=1024,  # Hymba uses SWA on most layers; global mixing via SSM path
)
