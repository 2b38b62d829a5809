"""Extra architectures beyond the assigned pool (framework extensibility).

Not part of the assigned 10x4 grid (the dry-run/roofline deliverables stay
scoped to the assignment); these demonstrate that new literature models
drop in as pure configs:

  * mixtral-8x7b — the canonical open MoE (8 experts, top-2)
    [arXiv:2401.04088]; exercises the grouped dispatch with few experts.
  * gemma2-9b — alternating local/global attention (1:1, window 4096)
    [arXiv:2408.00118]; exercises the ("local","attn") block unit on a
    dense model, the same machinery recurrentgemma uses.
"""

from .base import ModelConfig

MIXTRAL_8X7B = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    source="arXiv:2401.04088",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    rope_theta=1e6,
    n_experts=8,
    top_k=2,
    expert_d_ff=14336,
)

GEMMA2_9B = ModelConfig(
    name="gemma2-9b",
    family="dense",
    source="arXiv:2408.00118",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=256000,
    head_dim=256,
    rope_theta=10000.0,
    block_unit=("local", "attn"),
    attn_window=4096,
    tie_embeddings=True,
)

EXTRAS: dict[str, ModelConfig] = {
    c.name: c for c in (MIXTRAL_8X7B, GEMMA2_9B)
}
