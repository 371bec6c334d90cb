"""Whisper-small backbone: 12L enc + 12L dec; conv frontend is a STUB
(input_specs provides precomputed frame embeddings) [arXiv:2212.04356]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab_size=51865, head_dim=64, n_enc_layers=12, frontend="frame",
    max_decode_len=448,
)
