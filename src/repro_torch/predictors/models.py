"""The paper's oracle predictor (the port's copy of the ``oracle`` model).

The port's own copy of ``repro/predictors/models.py:54-108`` (per-trace
path) and of the ``PredictionStream`` record: each fault is predicted
with probability r, false alarms come from one renewal stream of mean
p·mu/(r(1-p)) — the same RNG draws in the same order, so traces are
bitwise the JAX package's.  The lead-time, drifting and bursty models
wait for a later slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.traces import (FAULT_PRED, FAULT_UNPRED, Distribution,
                           renewal_trace)

__all__ = ["OraclePredictor", "PredictionStream"]


@dataclasses.dataclass(frozen=True)
class PredictionStream:
    """What a predictor emits for one fault trace.

    ``kinds`` labels every ground-truth fault (``FAULT_PRED`` /
    ``FAULT_UNPRED``), ``false_times`` are the announcement dates of
    predictions that never materialize; the optional per-event windows
    are aligned with the faults and the false predictions.
    """

    kinds: np.ndarray                       # int8 per fault
    false_times: np.ndarray                 # float64, ascending
    true_windows: np.ndarray | None = None  # float64 per fault
    false_windows: np.ndarray | None = None  # float64 per false prediction


def _false_mean(recall: float, precision: float, mu: float) -> float:
    """Mean time between false predictions: p·mu / (r·(1-p)) (paper §2.3)."""
    return precision * mu / (recall * (1.0 - precision))


@dataclasses.dataclass(frozen=True)
class OraclePredictor:
    """The paper's stamped predictor at a fixed (recall, precision)."""

    recall: float
    precision: float

    def _false_stream(self, mu: float, horizon: float,
                      rng: np.random.Generator,
                      false_dist: Distribution) -> np.ndarray:
        if self.recall > 0.0 and self.precision < 1.0:
            mean_false = _false_mean(self.recall, self.precision, mu)
            return renewal_trace(false_dist.rescaled(mean_false), horizon,
                                 rng)
        return np.empty(0, dtype=np.float64)

    def predict(self, faults: np.ndarray, *, mu: float, horizon: float,
                rng: np.random.Generator,
                false_dist: Distribution) -> PredictionStream:
        predicted = rng.random(faults.size) < self.recall
        kinds = np.where(predicted, FAULT_PRED, FAULT_UNPRED).astype(np.int8)
        false_preds = self._false_stream(mu, horizon, rng, false_dist)
        return PredictionStream(kinds, false_preds)
