"""InternVL2-76B backbone (InternLM2-style LLM); ViT frontend is a STUB
(input_specs provides precomputed patch embeddings) [arXiv:2404.16821]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab_size=128256, head_dim=128, frontend="patch",
)
