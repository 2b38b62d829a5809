"""Checkpointing: double-buffered full + delta-quantized proactive saves."""

from .manager import CheckpointManager, SaveInfo, state_bytes

__all__ = ["CheckpointManager", "SaveInfo", "state_bytes"]
