"""Kimi K2 1T-A32B: 384-expert top-8 MoE + 1 shared expert [arXiv:2501.kimi2]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab_size=163840, head_dim=112, n_experts=384, moe_top_k=8,
    n_shared_experts=1, first_dense_layers=0,  # uniform MoE stack (scan); see DESIGN.md
)
