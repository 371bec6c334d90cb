"""DBRX-132B: 16-expert top-4 fine-grained MoE [hf:databricks/dbrx-base]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab_size=100352, head_dim=128, n_experts=16, moe_top_k=4,
)
