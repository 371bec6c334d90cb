"""SmolLM-135M: llama-arch small [hf:HuggingFaceTB/SmolLM-135M]. Also the
end-to-end training arch and the RAG-encoder example arch."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_ff=1536,
    vocab_size=49152, head_dim=64,
)
