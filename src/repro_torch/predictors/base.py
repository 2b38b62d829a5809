"""Predictor subsystem: generative fault-prediction models.

The paper characterizes a fault predictor by two numbers — recall r and
precision p.  A :class:`PredictorModel` *consumes* a fault trace and
*emits* the prediction stream — which faults are announced, when the false
alarms fire, and what per-event prediction window (lead) each announcement
carries — so "which predictor?" is a scenario axis.  The paper's stamping
is the ``oracle`` model (:class:`repro_torch.predictors.models.OraclePredictor`);
models are registered by name (``@register_predictor``) so a
:class:`repro_torch.experiments.spec.PredictorSpec` builds them from plain
data.

The port's own copy of ``repro/predictors/base.py``, the per-trace draw
(``predict``) and the bank draw (``predict_bank``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from ..core.traces import Distribution

__all__ = [
    "PredictionStream",
    "PredictorModel",
    "register_predictor",
    "build_predictor",
    "list_predictors",
]


@dataclasses.dataclass(frozen=True)
class PredictionStream:
    """What a predictor emits for one fault trace.

    ``kinds`` labels every ground-truth fault (``FAULT_PRED`` /
    ``FAULT_UNPRED``), ``false_times`` are the announcement dates of
    predictions that never materialize.  ``true_windows`` (aligned with the
    faults; 0 for unpredicted ones) and ``false_windows`` (aligned with
    ``false_times``) optionally carry per-event prediction-window lengths
    (arXiv:1302.4558): an announcement at date t with window I promises the
    fault inside [t, t+I].  ``None`` means "no model-level windows" — the
    scenario's constant ``window`` stamping (if any) then applies.
    """

    kinds: np.ndarray                       # int8 per fault
    false_times: np.ndarray                 # float64, ascending
    true_windows: np.ndarray | None = None  # float64 per fault
    false_windows: np.ndarray | None = None  # float64 per false prediction


class PredictorModel:
    """Base class: generate the prediction stream for a fault trace.

    ``predict`` consumes the ground-truth fault times of one trace and the
    shared trace RNG; it must draw all its randomness from ``rng`` so trace
    generation stays reproducible per seed.  ``false_dist`` is the
    *family* used for false-alarm inter-arrival times (the scenario's
    ``false_pred_dist`` or, by default, its fault distribution), to be
    rescaled by the model to whatever mean its (r, p) semantics imply.
    """

    def predict(self, faults: np.ndarray, *, mu: float, horizon: float,
                rng: np.random.Generator,
                false_dist: Distribution) -> PredictionStream:
        raise NotImplementedError

    def predict_bank(self, fault_bank: Sequence[np.ndarray], *, mu: float,
                     horizon: float, rng: np.random.Generator,
                     false_dist: Distribution) -> list[PredictionStream]:
        """Prediction streams for a whole trace bank from one generator.

        The default draws per trace sequentially from the shared stream
        (statistically identical to per-trace generation; bank draws are
        documented as reproducible per (seed, n_traces), not per index).
        The oracle overrides this with the vectorized bank draw order so
        legacy batched banks stay bit-for-bit.
        """
        return [self.predict(f, mu=mu, horizon=horizon, rng=rng,
                             false_dist=false_dist) for f in fault_bank]


# ---------------------------------------------------------------------------
# Registry (mirrors the strategy / distribution registries)
# ---------------------------------------------------------------------------

_MODELS: dict[str, Callable[..., PredictorModel]] = {}


def register_predictor(name: str):
    """Register ``factory(recall, precision, **params) -> PredictorModel``."""
    def wrap(factory: Callable[..., PredictorModel]) -> Callable[..., PredictorModel]:
        if name in _MODELS:
            raise ValueError(f"predictor {name!r} already registered")
        _MODELS[name] = factory
        return factory
    return wrap


def build_predictor(name: str, recall: float, precision: float,
                    **params) -> PredictorModel:
    """Build a registered predictor at the scenario's nominal (r, p)."""
    if name not in _MODELS:
        raise KeyError(f"unknown predictor {name!r}; "
                       f"registered: {sorted(_MODELS)}")
    return _MODELS[name](recall, precision, **params)


def list_predictors() -> list[str]:
    return sorted(_MODELS)
