"""llama3.2-1b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    source="hf:meta-llama/Llama-3.2-1B",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    head_dim=64,
    rope_theta=500000.0,
    block_unit=("attn",),
    tie_embeddings=True,
)
