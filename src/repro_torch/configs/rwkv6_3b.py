"""RWKV-6 (Finch) 3B: attention-free data-dependent-decay recurrence [arXiv:2404.05892]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=8960,
    vocab_size=65536, head_dim=64, rwkv_head_size=64,
)
