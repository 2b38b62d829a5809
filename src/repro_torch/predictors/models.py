"""The generative predictor family.

  * ``oracle(r, p)``      — the paper's stamping: each fault is predicted
                            with probability r, false alarms come from one
                            renewal stream of mean p·mu/(r(1-p));
  * ``lead_time(r, p)``   — every announcement carries a sampled per-event
                            prediction window I ~ ``lead_dist``;
                            announcements whose lead falls below
                            ``min_lead`` are reclassified as unpredicted
                            faults (the recall adjustment of paper §2.2);
  * ``drifting(r, p)``    — quality drifts linearly over the run to
                            (``recall_end``, ``precision_end``): per-fault
                            prediction probability r(t), false alarms from
                            a thinned non-homogeneous Poisson stream of
                            rate r(t)(1-p(t))/(p(t)·mu);
  * ``bursty(r, p)``      — false alarms in bursts (Poisson burst starts,
                            geometric sizes of mean ``burst_size``,
                            ``burst_gap``-spaced members) at the oracle's
                            long-run false rate.

All models draw exclusively from the trace RNG they are handed.  The port's
own copy of ``repro/predictors/models.py`` (the per-trace draws and the
oracle's bank draw): the same RNG draws in the same order, so traces and
banks are bitwise the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np

from ..core.traces import (FAULT_PRED, FAULT_UNPRED, Distribution,
                           Exponential, renewal_trace,
                           renewal_trace_bank)
from .base import PredictionStream, PredictorModel, register_predictor

__all__ = [
    "OraclePredictor",
    "LeadTimePredictor",
    "DriftingPredictor",
    "BurstyPredictor",
    "PredictionStream",
]


def _false_mean(recall: float, precision: float, mu: float) -> float:
    """Mean time between false predictions: p·mu / (r·(1-p)) (paper §2.3)."""
    return precision * mu / (recall * (1.0 - precision))


@dataclasses.dataclass(frozen=True)
class OraclePredictor(PredictorModel):
    """The paper's stamped predictor, extracted from ``make_event_trace``.

    Reproduces the legacy trace generation **bit-for-bit** for any fixed
    (r, p): the same RNG draws in the same order (per-fault flags, then the
    false-alarm renewal stream), pinned by a regression test.
    """

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

    def predict_bank(self, fault_bank, *, mu: float, horizon: float,
                     rng: np.random.Generator,
                     false_dist: Distribution) -> list[PredictionStream]:
        # The vectorized bank draw order of the legacy
        # make_event_trace_bank: one flags wave for every fault of the
        # bank, then one shared false-alarm bank.
        sizes = np.array([f.size for f in fault_bank])
        flags = rng.random(int(sizes.sum())) < self.recall
        kind_bank = [np.where(part, FAULT_PRED, FAULT_UNPRED).astype(np.int8)
                     for part in np.split(flags, np.cumsum(sizes)[:-1])]
        n_traces = len(fault_bank)
        if self.recall > 0.0 and self.precision < 1.0:
            mean_false = _false_mean(self.recall, self.precision, mu)
            false_bank = renewal_trace_bank(false_dist.rescaled(mean_false),
                                            horizon, rng, n_traces)
        else:
            false_bank = [np.empty(0, dtype=np.float64)] * n_traces
        return [PredictionStream(k, fp)
                for k, fp in zip(kind_bank, false_bank)]


@register_predictor("oracle")
def _oracle(recall: float, precision: float) -> OraclePredictor:
    return OraclePredictor(recall, precision)


def _build_lead_dist(spec: Any, mean: float) -> Distribution:
    """Build a lead-length distribution from a (name, params) mapping,
    rescaled to ``mean``.  Resolved through the experiment registry lazily
    so the predictor package stays import-cycle-free."""
    from ..experiments.spec import DistributionSpec
    if spec is None:
        spec = {"name": "exponential"}
    if not isinstance(spec, DistributionSpec):
        spec = DistributionSpec.from_dict(dict(spec))
    return spec.build().rescaled(mean)


@dataclasses.dataclass(frozen=True)
class LeadTimePredictor(PredictorModel):
    """Predictions arrive a sampled lead before the event.

    Each announcement (true or false) carries a per-event prediction
    window I drawn from ``lead_dist`` (rescaled to ``lead_mean``): the
    predictor fires I seconds of notice ahead of the (eventual) fault, so
    the announcement promises the interval [t, t+I] and the simulator
    materializes the true fault inside it — the window machinery's
    C_p-lead assumption, with *heterogeneous* windows the constant
    ``ScenarioSpec.window`` stamping cannot express.

    True predictions whose sampled lead is below ``min_lead`` (typically
    C_p) give the platform no time to act; per paper §2.2 they are
    reclassified as unpredicted faults, so the *effective* recall is
    r·P(I >= min_lead) < r — which an online estimator can discover and
    an adaptive strategy re-plan on.
    """

    recall: float
    precision: float
    lead_mean: float = 3600.0
    lead_dist: Any = None        # (name, params) mapping; default exponential
    min_lead: float = 0.0

    def predict(self, faults: np.ndarray, *, mu: float, horizon: float,
                rng: np.random.Generator,
                false_dist: Distribution) -> PredictionStream:
        oracle = OraclePredictor(self.recall, self.precision)
        base = oracle.predict(faults, mu=mu, horizon=horizon, rng=rng,
                              false_dist=false_dist)
        dist = _build_lead_dist(self.lead_dist, self.lead_mean)
        kinds = base.kinds.copy()
        true_windows = np.zeros(faults.size, dtype=np.float64)
        pred_idx = np.flatnonzero(kinds == FAULT_PRED)
        if pred_idx.size:
            leads = dist.sample(rng, pred_idx.size)
            usable = leads >= self.min_lead
            true_windows[pred_idx[usable]] = leads[usable]
            # Lead too short to fit C_p: the paper's recall adjustment.
            kinds[pred_idx[~usable]] = FAULT_UNPRED
        false_windows = np.empty(0, dtype=np.float64)
        if base.false_times.size:
            false_windows = dist.sample(rng, base.false_times.size)
        return PredictionStream(kinds, base.false_times,
                                true_windows=true_windows,
                                false_windows=false_windows)


@register_predictor("lead_time")
def _lead_time(recall: float, precision: float, lead_mean: float = 3600.0,
               lead_dist: Mapping | None = None,
               min_lead: float = 0.0) -> LeadTimePredictor:
    return LeadTimePredictor(recall, precision, lead_mean=lead_mean,
                             lead_dist=None if lead_dist is None
                             else dict(lead_dist), min_lead=min_lead)


@dataclasses.dataclass(frozen=True)
class DriftingPredictor(PredictorModel):
    """Predictor quality drifts linearly over the run.

    Recall moves from the nominal r to ``recall_end`` (precision
    likewise) along the drift ramp: flat at the nominal value until
    ``drift_start`` (trace time, seconds), then linear over ``drift_span``
    seconds (default: the rest of the trace horizon), then flat at the end
    value.  Each fault at date t is predicted with probability r(t), and
    false alarms follow a non-homogeneous Poisson process of rate
    lambda(t) = r(t)·(1-p(t)) / (p(t)·mu) — the instantaneous analogue of
    the oracle's false-alarm rate — realized by thinning a homogeneous
    candidate stream at the peak rate.  (The ``false_pred_dist`` family is
    ignored: a drifting rate needs the memoryless construction.)

    Scenario traces start ``ScenarioSpec.start`` seconds into the trace,
    so a drift meant to unfold *during* the job should set
    ``drift_start`` near the scenario's start and ``drift_span`` to a few
    ``time_base``.
    """

    recall: float
    precision: float
    recall_end: float | None = None
    precision_end: float | None = None
    drift_start: float = 0.0
    drift_span: float | None = None

    def _frac(self, t: np.ndarray, horizon: float) -> np.ndarray:
        span = self.drift_span if self.drift_span is not None \
            else max(horizon - self.drift_start, 1e-9)
        return np.clip((t - self.drift_start) / span, 0.0, 1.0)

    def _r_at(self, t: np.ndarray, horizon: float) -> np.ndarray:
        r1 = self.recall if self.recall_end is None else self.recall_end
        return self.recall + (r1 - self.recall) * self._frac(t, horizon)

    def _p_at(self, t: np.ndarray, horizon: float) -> np.ndarray:
        p1 = self.precision if self.precision_end is None \
            else self.precision_end
        return self.precision + (p1 - self.precision) * self._frac(t, horizon)

    def _false_rate(self, t: np.ndarray, horizon: float,
                    mu: float) -> np.ndarray:
        r = np.clip(self._r_at(t, horizon), 0.0, 1.0)
        p = np.clip(self._p_at(t, horizon), 1e-3, 1.0)
        return r * (1.0 - p) / (p * mu)

    def predict(self, faults: np.ndarray, *, mu: float, horizon: float,
                rng: np.random.Generator,
                false_dist: Distribution) -> PredictionStream:
        r_t = np.clip(self._r_at(faults, horizon), 0.0, 1.0)
        predicted = rng.random(faults.size) < r_t
        kinds = np.where(predicted, FAULT_PRED, FAULT_UNPRED).astype(np.int8)

        # Thinning bound on the false-alarm rate.  r(1-p)/p can peak
        # *inside* the ramp (not at its endpoints), so sample the ramp
        # densely in ramp-fraction space — where the rate is smooth with
        # mild curvature — and pad the grid maximum; acceptance
        # probabilities then never exceed 1.
        span = self.drift_span if self.drift_span is not None \
            else max(horizon - self.drift_start, 1e-9)
        ramp = self.drift_start + span * np.linspace(0.0, 1.0, 1025)
        grid = np.concatenate([np.linspace(0.0, horizon, 17), ramp])
        lam_max = 1.05 * float(self._false_rate(grid, horizon, mu).max())
        if lam_max <= 0.0:
            return PredictionStream(kinds, np.empty(0, dtype=np.float64))
        cand = np.cumsum(rng.exponential(
            1.0 / lam_max, max(16, int(horizon * lam_max * 1.5) + 8)))
        while cand.size and cand[-1] < horizon:
            cand = np.concatenate([
                cand, cand[-1] + np.cumsum(rng.exponential(
                    1.0 / lam_max, max(16, cand.size // 2)))])
        cand = cand[cand < horizon]
        keep = rng.random(cand.size) < (
            self._false_rate(cand, horizon, mu) / lam_max)
        return PredictionStream(kinds, cand[keep])


@register_predictor("drifting")
def _drifting(recall: float, precision: float,
              recall_end: float | None = None,
              precision_end: float | None = None,
              drift_start: float = 0.0,
              drift_span: float | None = None) -> DriftingPredictor:
    return DriftingPredictor(recall, precision, recall_end=recall_end,
                             precision_end=precision_end,
                             drift_start=drift_start, drift_span=drift_span)


@dataclasses.dataclass(frozen=True)
class BurstyPredictor(PredictorModel):
    """Correlated false alarms: one root cause fires a burst of them.

    Burst starts follow a Poisson process of rate lambda_f / burst_size
    (lambda_f = the oracle's false-alarm rate), each burst holds a
    Geometric(1/burst_size) number of alarms (mean ``burst_size``) spaced
    by Exponential(``burst_gap``) gaps — so the long-run false-alarm rate,
    and hence the nominal precision, matches the oracle while the alarms
    cluster.  Clustered false alarms stress trust policies: a burst landing
    late in a period triggers several proactive checkpoints back to back.
    """

    recall: float
    precision: float
    burst_size: float = 4.0
    burst_gap: float = 900.0

    def predict(self, faults: np.ndarray, *, mu: float, horizon: float,
                rng: np.random.Generator,
                false_dist: Distribution) -> PredictionStream:
        predicted = rng.random(faults.size) < self.recall
        kinds = np.where(predicted, FAULT_PRED, FAULT_UNPRED).astype(np.int8)
        if not (self.recall > 0.0 and self.precision < 1.0):
            return PredictionStream(kinds, np.empty(0, dtype=np.float64))
        if self.burst_size < 1.0:
            raise ValueError(f"burst_size must be >= 1, got {self.burst_size}")
        mean_false = _false_mean(self.recall, self.precision, mu)
        starts = renewal_trace(Exponential(mean_false * self.burst_size),
                               horizon, rng)
        if starts.size == 0:
            return PredictionStream(kinds, np.empty(0, dtype=np.float64))
        counts = rng.geometric(1.0 / self.burst_size, starts.size)
        extra = counts - 1
        times = starts
        n_extra = int(extra.sum())
        if n_extra:
            # Offsets within each burst: cumulative gaps restarted per
            # burst (segmented cumsum over the flat gap array).
            gaps = rng.exponential(self.burst_gap, n_extra)
            owner = np.repeat(np.arange(starts.size), extra)
            csum = np.cumsum(gaps)
            first = np.concatenate([[0], np.cumsum(extra)[:-1]])
            before = np.concatenate([[0.0], csum])[first]  # gaps before burst
            offsets = csum - before[owner]
            times = np.concatenate([starts, starts[owner] + offsets])
        times = np.sort(times[times < horizon])
        return PredictionStream(kinds, times)


@register_predictor("bursty")
def _bursty(recall: float, precision: float, burst_size: float = 4.0,
            burst_gap: float = 900.0) -> BurstyPredictor:
    return BurstyPredictor(recall, precision, burst_size=burst_size,
                           burst_gap=burst_gap)
