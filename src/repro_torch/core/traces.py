"""Failure / prediction trace generation (paper §5.1).

Produces the three event streams the simulator consumes:
  * fault times           — renewal process (Exponential, Weibull, Uniform,
                            LogNormal, log-based Empirical), either one
                            platform-level stream scaled to the platform
                            MTBF mu, or the superposition of N
                            per-processor streams;
  * predicted flags       — emitted by a generative predictor model
                            (:mod:`repro_torch.predictors`); the default
                            ``oracle`` predicts each fault with
                            probability r (recall);
  * false-prediction times — also predictor-emitted; the oracle uses a
                            renewal process with mean mu_P/(1-p)
                            = p mu /(r (1-p)).

Event encoding used throughout: structured arrays (time, kind) with kinds
  FAULT_UNPRED  actual fault, not predicted
  FAULT_PRED    actual fault, predicted (prediction date == fault date; the
                simulator adds the uncertainty window for InexactPrediction)
  FALSE_PRED    prediction that does not materialize
  SILENT        silent data corruption (arXiv:1310.8486): the strike is
                *latent* — the simulator only learns about it at the next
                verification point (or a detected fail-stop fault), and
                rolls back past any checkpoints taken while corrupted

Prediction *windows* (companion paper, arXiv:1302.4558): with ``window=I``
each prediction event additionally carries the announced interval length I
(``EventTrace.windows``) — the predictor promises the fault anywhere in
[t, t+I], and the simulator draws the materialization date from the lane
RNG.  ``window=0`` leaves ``windows`` unset, reproducing exact-date traces
bit-for-bit.

The port's own copy of ``repro/core/traces.py`` (the per-trace path; the
batched bank path is ROADMAP A2): the same numpy draws in the same order, so a trace made here from
a seed is bitwise the JAX package's.  :func:`traces_from_numpy` carries a
bank made elsewhere across as arrays.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

__all__ = [
    "FAULT_UNPRED",
    "FAULT_PRED",
    "FALSE_PRED",
    "SILENT",
    "EventTrace",
    "Distribution",
    "Exponential",
    "Weibull",
    "UniformDist",
    "LogNormalDist",
    "Empirical",
    "renewal_trace",
    "superposed_trace",
    "make_event_trace",
    "traces_from_numpy",
    "lanl_like_log",
]

FAULT_UNPRED = 0
FAULT_PRED = 1
FALSE_PRED = 2
SILENT = 3


# ---------------------------------------------------------------------------
# Inter-arrival distributions (all parameterized by their MEAN, so that they
# can be rescaled to any platform MTBF as the paper does).
# ---------------------------------------------------------------------------

class Distribution:
    """Base class: inter-arrival time distribution with a controllable mean."""

    mean: float

    def sample(self, rng: np.random.Generator, size: int) -> np.ndarray:
        raise NotImplementedError

    def rescaled(self, mean: float) -> "Distribution":
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Exponential(Distribution):
    mean: float

    def sample(self, rng: np.random.Generator, size: int) -> np.ndarray:
        return rng.exponential(self.mean, size)

    def rescaled(self, mean: float) -> "Exponential":
        return Exponential(mean)


@dataclasses.dataclass(frozen=True)
class Weibull(Distribution):
    """Weibull with shape k; scale chosen so that the mean is ``mean``."""

    shape: float
    mean: float

    @property
    def scale(self) -> float:
        return self.mean / math.gamma(1.0 + 1.0 / self.shape)

    def sample(self, rng: np.random.Generator, size: int) -> np.ndarray:
        return self.scale * rng.weibull(self.shape, size)

    def rescaled(self, mean: float) -> "Weibull":
        return Weibull(self.shape, mean)


@dataclasses.dataclass(frozen=True)
class UniformDist(Distribution):
    """Uniform on [0, 2*mean] (used for false-prediction traces, Appendix B)."""

    mean: float

    def sample(self, rng: np.random.Generator, size: int) -> np.ndarray:
        return rng.uniform(0.0, 2.0 * self.mean, size)

    def rescaled(self, mean: float) -> "UniformDist":
        return UniformDist(mean)


@dataclasses.dataclass(frozen=True)
class LogNormalDist(Distribution):
    """LogNormal with given sigma; mu chosen to match the mean (extension)."""

    sigma: float
    mean: float

    def sample(self, rng: np.random.Generator, size: int) -> np.ndarray:
        mu = math.log(self.mean) - 0.5 * self.sigma ** 2
        return rng.lognormal(mu, self.sigma, size)

    def rescaled(self, mean: float) -> "LogNormalDist":
        return LogNormalDist(self.sigma, mean)


@dataclasses.dataclass(frozen=True)
class Empirical(Distribution):
    """Empirical distribution over observed availability intervals (paper §5.1,
    log-based traces).  Sampling = resampling the interval set, which realizes
    exactly the conditional law P(X >= t | X >= tau) described in the paper.
    """

    samples: tuple[float, ...]

    @property
    def mean(self) -> float:  # type: ignore[override]
        return float(np.mean(self.samples))

    def sample(self, rng: np.random.Generator, size: int) -> np.ndarray:
        arr = np.asarray(self.samples, dtype=np.float64)
        return rng.choice(arr, size=size, replace=True)

    def rescaled(self, mean: float) -> "Empirical":
        cur = self.mean
        return Empirical(tuple(float(s) * mean / cur for s in self.samples))


# ---------------------------------------------------------------------------
# Renewal processes
# ---------------------------------------------------------------------------

def renewal_trace(dist: Distribution, horizon: float,
                  rng: np.random.Generator) -> np.ndarray:
    """Arrival times of a renewal process on [0, horizon)."""
    if horizon <= 0:
        return np.empty(0, dtype=np.float64)
    # Draw in batches until the horizon is exceeded.
    est = max(16, int(horizon / max(dist.mean, 1e-12) * 1.5) + 8)
    chunks: list[np.ndarray] = []
    total = 0.0
    while total < horizon:
        draws = dist.sample(rng, est)
        draws = np.maximum(draws, 1e-9)  # guard zero inter-arrivals
        chunks.append(draws)
        total += float(draws.sum())
        est = max(16, est // 2)
    times = np.cumsum(np.concatenate(chunks))
    return times[times < horizon]


def superposed_trace(dist_ind: Distribution, n: int, horizon: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Superposition of n i.i.d. per-processor renewal processes (paper §5.1).

    Vectorized wave sampling: processors that have not yet exceeded the
    horizon draw their next inter-arrival together.
    """
    t = np.zeros(n, dtype=np.float64)
    out: list[np.ndarray] = []
    active = np.arange(n)
    while active.size:
        draws = np.maximum(dist_ind.sample(rng, active.size), 1e-9)
        t[active] = t[active] + draws
        hit = t[active] < horizon
        out.append(t[active][hit])
        active = active[hit]
    if not out:
        return np.empty(0, dtype=np.float64)
    return np.sort(np.concatenate(out))


# ---------------------------------------------------------------------------
# Full event traces
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EventTrace:
    """Merged, time-sorted platform event stream.

    ``windows`` (optional) carries the announced prediction-window length I
    per event: a FAULT_PRED / FALSE_PRED event at time t promises the fault
    in [t, t+I].  ``None`` means exact-date predictions (the simulator's
    ``inexact_window`` argument then acts as the per-run fallback width).
    """

    times: np.ndarray  # float64, ascending
    kinds: np.ndarray  # int8, FAULT_UNPRED/FAULT_PRED/FALSE_PRED/SILENT
    horizon: float
    windows: np.ndarray | None = None  # float64 per-event window length

    def __post_init__(self) -> None:
        if self.times.shape != self.kinds.shape:
            raise ValueError("times/kinds shape mismatch")
        if self.windows is not None and self.windows.shape != self.times.shape:
            raise ValueError("times/windows shape mismatch")

    @property
    def fault_times(self) -> np.ndarray:
        """Fail-stop fault dates (silent corruptions are not fail-stop)."""
        return self.times[(self.kinds == FAULT_UNPRED)
                          | (self.kinds == FAULT_PRED)]

    @property
    def n_faults(self) -> int:
        return int(np.sum((self.kinds == FAULT_UNPRED)
                          | (self.kinds == FAULT_PRED)))

    @property
    def silent_times(self) -> np.ndarray:
        return self.times[self.kinds == SILENT]

    @property
    def n_silent(self) -> int:
        return int(np.sum(self.kinds == SILENT))

    def empirical_mtbf(self) -> float:
        n = self.n_faults
        return math.inf if n == 0 else self.horizon / n


def make_event_trace(
    fault_dist: Distribution,
    mu: float,
    recall: float,
    precision: float,
    horizon: float,
    rng: np.random.Generator,
    *,
    false_pred_dist: Distribution | None = None,
    n_processors: int | None = None,
    window: float = 0.0,
    predictor_model=None,
    silent_mu: float | None = None,
    silent_dist: Distribution | None = None,
) -> EventTrace:
    """Build the merged event trace for one simulated instance (paper §5.1).

    If ``n_processors`` is given, faults come from the superposition of
    per-processor streams using ``fault_dist`` as the *individual* law
    (its mean is interpreted as mu_ind = mu * n).  Otherwise a single
    platform-level stream rescaled to mean ``mu`` is used.

    The prediction stream is generated by ``predictor_model`` (an object
    with ``predict``), defaulting to the paper's ``oracle`` stamping
    (:class:`repro_torch.predictors.models.OraclePredictor`): each fault
    predicted with probability r, false predictions from one renewal
    stream of ``false_pred_dist`` (same family as the fault distribution
    by default, per §5.2) rescaled to mean p*mu/(r*(1-p)).

    ``window > 0`` stamps every prediction event with the announced window
    length I (arXiv:1302.4558): the fault materializes in [t, t+I], the
    offset being drawn by the simulator.  ``window=0`` produces exact-date
    traces identical to before.  Per-event windows emitted by the
    predictor model (e.g. ``lead_time`` sampled leads) take precedence
    over the constant stamping.

    ``silent_mu`` (finite, positive) adds a silent-data-corruption stream
    (kind ``SILENT``) drawn from ``silent_dist`` (default Exponential)
    rescaled to that platform-level MTBF.  The stream is drawn *after* all
    other streams, so ``silent_mu=None`` (or infinite) reproduces the
    silent-free trace bit-for-bit from the same generator state.
    """
    if n_processors:
        faults = superposed_trace(fault_dist.rescaled(mu * n_processors),
                                  n_processors, horizon, rng)
    else:
        faults = renewal_trace(fault_dist.rescaled(mu), horizon, rng)

    if predictor_model is None:
        from ..predictors.models import OraclePredictor
        predictor_model = OraclePredictor(recall, precision)
    stream = predictor_model.predict(
        faults, mu=mu, horizon=horizon, rng=rng,
        false_dist=false_pred_dist or fault_dist)

    silents = _silent_stream(silent_mu, silent_dist, horizon, rng)
    return _merge_events(faults, stream.kinds, stream.false_times, horizon,
                         window=window, true_windows=stream.true_windows,
                         false_windows=stream.false_windows, silents=silents)


def _silent_stream(silent_mu: float | None, silent_dist: Distribution | None,
                   horizon: float, rng: np.random.Generator
                   ) -> np.ndarray | None:
    """The silent-corruption renewal stream, or None when the rate is 0."""
    if silent_mu is None or not math.isfinite(silent_mu):
        return None
    if silent_mu <= 0.0:
        raise ValueError(f"silent_mu must be positive, got {silent_mu}")
    dist = (silent_dist or Exponential(1.0)).rescaled(silent_mu)
    return renewal_trace(dist, horizon, rng)


def _merge_events(faults: np.ndarray, kinds: np.ndarray,
                  false_preds: np.ndarray, horizon: float,
                  window: float = 0.0,
                  true_windows: np.ndarray | None = None,
                  false_windows: np.ndarray | None = None,
                  silents: np.ndarray | None = None) -> EventTrace:
    if silents is None:
        silents = np.empty(0, dtype=np.float64)
    times = np.concatenate([faults, false_preds, silents])
    all_kinds = np.concatenate(
        [kinds, np.full(false_preds.size, FALSE_PRED, dtype=np.int8),
         np.full(silents.size, SILENT, dtype=np.int8)])
    order = np.argsort(times, kind="stable")
    times, all_kinds = times[order], all_kinds[order]
    windows = None
    if window > 0.0 or true_windows is not None or false_windows is not None:
        # Prediction events (true and false) announce [t, t+I]; plain
        # faults and silent corruptions carry no window.  Per-event model
        # windows win over the constant stamping.
        wf = (np.asarray(true_windows, dtype=np.float64)
              if true_windows is not None
              else np.full(kinds.size, float(window)))
        wf = np.where(kinds == FAULT_UNPRED, 0.0, wf)
        wfp = (np.asarray(false_windows, dtype=np.float64)
               if false_windows is not None
               else np.full(false_preds.size, float(window)))
        windows = np.concatenate([wf, wfp, np.zeros(silents.size)])[order]
    return EventTrace(times, all_kinds, horizon, windows=windows)


def traces_from_numpy(times: Sequence[np.ndarray], kinds: Sequence[np.ndarray],
                      horizons: Sequence[float],
                      windows: Sequence[np.ndarray | None] | None = None
                      ) -> list[EventTrace]:
    """The port's :class:`EventTrace` bank from plain arrays.

    Takes one ``times`` / ``kinds`` / ``horizon`` (and optional per-event
    ``windows``) per trace, as any other implementation of the study can
    hand them over, so both engines run on the identical bank.  Arrays
    are copied as float64 / int8; nothing is re-sorted or re-drawn.
    """
    if windows is None:
        windows = [None] * len(times)
    if not len(times) == len(kinds) == len(horizons) == len(windows):
        raise ValueError("times, kinds, horizons and windows differ in length")
    return [EventTrace(np.array(t, dtype=np.float64),
                       np.array(k, dtype=np.int8), float(h),
                       windows=None if w is None
                       else np.array(w, dtype=np.float64))
            for t, k, h, w in zip(times, kinds, horizons, windows)]


def lanl_like_log(rng: np.random.Generator, n_intervals: int = 3010,
                  mu_ind_days: float = 691.0, shape: float = 0.6) -> Empirical:
    """Synthesize a LANL-18-like availability-interval log (paper §5.1).

    The real Failure Trace Archive files are not available offline; we generate
    an interval set once from a Weibull(k=0.6) whose mean matches the published
    per-processor MTBF, then treat it as an *empirical discrete distribution*
    exactly the way the paper treats the LANL logs.
    """
    base = Weibull(shape, mu_ind_days * 86400.0)
    samples = np.maximum(base.sample(rng, n_intervals), 60.0)
    return Empirical(tuple(float(s) for s in samples))
