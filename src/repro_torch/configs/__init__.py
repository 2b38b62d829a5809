"""Architecture / shape / platform registry of the port.

The port's own copy of ``repro/configs/__init__.py``: ``REGISTRY`` maps
``--arch`` ids to :class:`ModelConfig`, ``EXTRAS`` holds the architectures
beyond the assigned pool, and ``SHAPES`` maps shape ids to
:class:`InputShape`.  :func:`get` resolves every architecture of the JAX
package; ``pairs()`` enumerates the assigned (arch x shape) grid,
honouring the documented skips (encoder-only archs have no decode step).

Resolving a config does not mean the port runs its model:
``models/transformer.py::check_supported`` raises for the families not
ported yet (M-RoPE and encoder-only inputs), naming the ROADMAP item.  The
fleet sizes jobs from any of them (``fleet/spec.py::job_from_model``).
"""

from __future__ import annotations

from .base import SHAPES, InputShape, ModelConfig, PlatformConfig
from .extras import EXTRAS
from .hubert_xlarge import CONFIG as HUBERT_XLARGE
from .internlm2_20b import CONFIG as INTERNLM2_20B
from .llama3_405b import CONFIG as LLAMA3_405B
from .llama32_1b import CONFIG as LLAMA32_1B
from .qwen2_moe_a27b import CONFIG as QWEN2_MOE_A27B
from .qwen2_vl_72b import CONFIG as QWEN2_VL_72B
from .qwen3_moe_235b_a22b import CONFIG as QWEN3_MOE_235B
from .recurrentgemma_2b import CONFIG as RECURRENTGEMMA_2B
from .tinyllama_11b import CONFIG as TINYLLAMA_11B
from .xlstm_125m import CONFIG as XLSTM_125M

__all__ = ["REGISTRY", "EXTRAS", "SHAPES", "get", "pairs", "skip_reason",
           "ModelConfig", "InputShape", "PlatformConfig"]

REGISTRY: dict[str, ModelConfig] = {
    cfg.name: cfg
    for cfg in (
        LLAMA3_405B,
        INTERNLM2_20B,
        QWEN3_MOE_235B,
        QWEN2_MOE_A27B,
        HUBERT_XLARGE,
        TINYLLAMA_11B,
        RECURRENTGEMMA_2B,
        QWEN2_VL_72B,
        LLAMA32_1B,
        XLSTM_125M,
    )
}


def get(name: str) -> ModelConfig:
    """Resolve an arch id: the assigned registry first, then extras."""
    if name in REGISTRY:
        return REGISTRY[name]
    if name in EXTRAS:
        return EXTRAS[name]
    raise KeyError(f"unknown arch {name!r}; known: "
                   f"{sorted(REGISTRY) + sorted(EXTRAS)}")


def skip_reason(cfg: ModelConfig, shape: InputShape) -> str | None:
    """Why an (arch, shape) pair is skipped, or None if it runs.

    Encoder-only architectures (hubert) have no decode step; this is the
    only skip.
    """
    if not cfg.causal and shape.kind == "decode":
        return "encoder-only: no decode step"
    return None


def pairs(include_skipped: bool = False):
    """Enumerate the assigned (arch, shape) grid."""
    for cfg in REGISTRY.values():
        for shape in SHAPES.values():
            reason = skip_reason(cfg, shape)
            if reason is None or include_skipped:
                yield cfg, shape, reason
