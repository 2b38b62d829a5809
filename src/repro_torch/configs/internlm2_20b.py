"""internlm2-20b [dense] — GQA [arXiv:2403.17297]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    source="arXiv:2403.17297",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    head_dim=128,
    rope_theta=1000000.0,
    block_unit=("attn",),
    microbatches=4,
)
