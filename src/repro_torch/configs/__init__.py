"""The port's model configurations.

``REGISTRY`` holds the dense decoders the port runs; :func:`get` resolves
an arch id.  The JAX package's other architectures need model code the
port does not have yet, so asking for one raises ``KeyError`` naming the
ROADMAP item that ports it.
"""

from __future__ import annotations

from .base import SHAPES, InputShape, ModelConfig, PlatformConfig
from .llama32_1b import CONFIG as LLAMA32_1B
from .tinyllama_11b import CONFIG as TINYLLAMA_11B

__all__ = ["REGISTRY", "SHAPES", "get", "ModelConfig", "InputShape",
           "PlatformConfig"]

REGISTRY: dict[str, ModelConfig] = {
    cfg.name: cfg for cfg in (TINYLLAMA_11B, LLAMA32_1B)
}

# Architectures of the JAX package that wait for model code in the port.
_PENDING = {
    "llama3-405b": "ROADMAP Queue A item 10.1 (dense configs; at full "
                   "width it needs item 13, sharding)",
    "internlm2-20b": "ROADMAP Queue A item 10.1 (dense configs)",
    "gemma2-9b": "ROADMAP Queue A item 10.1 (dense configs)",
    "qwen3-moe-235b-a22b": "ROADMAP Queue A item 10.2 (MoE)",
    "qwen2-moe-a2.7b": "ROADMAP Queue A item 10.2 (MoE)",
    "mixtral-8x7b": "ROADMAP Queue A item 10.2 (MoE)",
    "recurrentgemma-2b": "ROADMAP Queue A item 10.3 (RG-LRU)",
    "xlstm-125m": "ROADMAP Queue A item 10.4 (xLSTM)",
    "qwen2-vl-72b": "ROADMAP Queue A item 10.5 (M-RoPE VLM)",
    "hubert-xlarge": "ROADMAP Queue A item 10.6 (encoder-only audio)",
}


def get(name: str) -> ModelConfig:
    """Resolve an arch id among the configs the port has."""
    if name in REGISTRY:
        return REGISTRY[name]
    if name in _PENDING:
        raise KeyError(f"arch {name!r} is not ported yet: "
                       f"{_PENDING[name]}")
    raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
