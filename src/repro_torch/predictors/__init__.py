"""Predictor models of the port (the oracle only, in this slice)."""

from .models import OraclePredictor, PredictionStream

__all__ = ["OraclePredictor", "PredictionStream"]
