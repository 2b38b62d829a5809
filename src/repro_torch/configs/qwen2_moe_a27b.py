"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    head_dim=128,
    rope_theta=1000000.0,
    block_unit=("attn",),
    n_experts=60,
    pad_experts_to=64,  # 60 does not divide the 16-wide model axis (§Perf)
    top_k=4,
    n_shared_experts=4,
    expert_d_ff=1408,
    microbatches=2,
)
