"""Gemma-3-1B: 5:1 local:global sliding-window interleave, 128k context
[hf:google/gemma-3-1b-pt]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, d_ff=6912,
    vocab_size=262144, head_dim=256, sliding_window=1024,
    local_global_ratio=5, rope_theta=1_000_000.0,
)
