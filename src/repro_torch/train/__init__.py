"""Fault-tolerant training loop."""

from .loop import FaultTolerantTrainer, TrainerStats

__all__ = ["FaultTolerantTrainer", "TrainerStats"]
