"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 [arXiv:2402.19427].

Griffin-style pattern: two RG-LRU recurrent blocks followed by one
sliding-window (2048) attention block, cycled over 26 layers.  Decode keeps
O(1) recurrent state + a bounded window cache => long_500k runs natively.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    source="arXiv:2402.19427",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    rope_theta=10000.0,
    block_unit=("rec", "rec", "local"),
    attn_window=2048,
    lru_width=2560,
    conv1d_width=4,
)
