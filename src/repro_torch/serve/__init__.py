"""Batched serving engine (prefill + KV-cache decode)."""

from .engine import GenerateResult, ServingEngine

__all__ = ["GenerateResult", "ServingEngine"]
