"""hubert-xlarge [audio] — encoder-only transformer backbone [arXiv:2106.07447].

The mel-spectrogram + conv feature-extractor frontend is a STUB per the
assignment: ``input_specs()`` feeds precomputed frame embeddings of shape
(batch, frames, d_model).  The backbone does masked prediction over the
504-unit codebook.  Encoder-only => no decode step (decode shapes skipped,
see DESIGN.md §5).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    source="arXiv:2106.07447",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    head_dim=80,
    rope_theta=10000.0,
    block_unit=("attn",),
    causal=False,
    embed_inputs=False,
    microbatches=2,
)
