"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].

The ViT vision encoder + projector is a STUB per the assignment:
``input_specs()`` feeds a mixed sequence of precomputed patch embeddings and
text tokens.  The backbone implements M-RoPE with (t, h, w) = (16, 24, 24)
rotary sections over the 64 rotary half-dims.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    source="arXiv:2409.12191",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    rope_theta=1000000.0,
    block_unit=("attn",),
    mrope_sections=(16, 24, 24),
    microbatches=8,
)
