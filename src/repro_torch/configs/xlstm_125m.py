"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

Alternating mLSTM (matrix memory, parallel/chunkwise form for training) and
sLSTM (scalar memory, sequential scan) blocks.  d_ff = 0: the gated
up/down projections live inside the blocks themselves.  Decode keeps O(1)
recurrent state => long_500k runs natively.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    source="arXiv:2405.04517",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=192,
    rope_theta=10000.0,
    block_unit=("mlstm", "slstm"),
    tie_embeddings=True,
)
