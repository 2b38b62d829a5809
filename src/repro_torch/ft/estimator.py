"""Online estimation of platform and predictor parameters.

The paper assumes mu, r, p are known.  In production none of them are: the
platform MTBF drifts (hardware ages, fleets change), and a predictor's
recall/precision must be measured against observed faults.  This module
keeps running estimates from the event stream and re-plans the schedule
when they move — the missing piece that makes the paper's policy
deployable (and the mechanism behind the hazard-aware dynamic periods of
benchmarks/beyond.py, measured instead of assumed).

Estimators:
  * MTBF — exponentially-weighted mean of fault inter-arrival times
    (window ~ the last `halflife` faults), so burn-in decay shows up as a
    falling mu-hat instead of poisoning the estimate forever;
  * recall — EW fraction of faults that had been predicted;
  * precision — EW fraction of predictions that materialized (a prediction
    "materializes" if a fault strikes within `match_window` of its date).

`replan` hysteresis: the scheduler is rebuilt only when the optimal period
under the new estimates moves by more than `replan_threshold` (re-planning
every event would thrash the checkpoint cadence for no waste benefit —
the waste curve is flat near its minimum, WASTE''(T*) ~ 1/mu T^3).

The port's own copy of ``repro/ft/estimator.py``, over the port's
``configs/base.py`` and ``ft/scheduler.py``: the same estimates and the
same re-plans, bitwise.
"""

from __future__ import annotations

import dataclasses
import math

from ..configs.base import PlatformConfig
from .scheduler import CheckpointScheduler

__all__ = ["OnlineEstimator", "AdaptiveScheduler"]


class _EWMean:
    """Exponentially-weighted mean with a half-life in observations."""

    def __init__(self, halflife: float, init: float | None = None) -> None:
        self.alpha = 1.0 - 0.5 ** (1.0 / halflife)
        self.value = init
        self.n = 0

    def update(self, x: float) -> float:
        self.n += 1
        if self.value is None:
            self.value = x
        else:
            self.value += self.alpha * (x - self.value)
        return self.value


@dataclasses.dataclass
class EstimatorState:
    mu: float | None
    recall: float | None
    precision: float | None
    n_faults: int
    n_predictions: int


class OnlineEstimator:
    """Running (mu, recall, precision) estimates from observed events."""

    def __init__(self, *, halflife: float = 20.0,
                 match_window: float = 60.0,
                 prior: PlatformConfig | None = None) -> None:
        self.match_window = match_window
        self._mu = _EWMean(halflife, prior.mu_ind if prior else None)
        self._recall = _EWMean(halflife,
                               prior.recall if prior else None)
        self._precision = _EWMean(halflife,
                                  prior.precision if prior else None)
        self._last_fault: float | None = None
        self._open_predictions: list[float] = []  # predicted dates
        self.n_faults = 0
        self.n_predictions = 0

    # -- event feed -----------------------------------------------------------

    def observe_prediction(self, date: float) -> None:
        """A prediction announced for ``date`` (dates must be fed in order)."""
        self.n_predictions += 1
        self._open_predictions.append(date)

    def observe_fault(self, t: float, was_predicted: bool | None = None
                      ) -> None:
        """An actual fault at time ``t``."""
        self.n_faults += 1
        if self._last_fault is not None:
            self._mu.update(t - self._last_fault)
        self._last_fault = t

        # Match against open predictions for the precision estimate.
        matched = False
        still_open = []
        for d in self._open_predictions:
            if abs(d - t) <= self.match_window and not matched:
                matched = True
                self._precision.update(1.0)
            elif d < t - self.match_window:
                self._precision.update(0.0)  # expired false prediction
            else:
                still_open.append(d)
        self._open_predictions = still_open
        hit = matched if was_predicted is None else was_predicted
        self._recall.update(1.0 if hit else 0.0)

    def expire_predictions(self, now: float) -> None:
        """Flush predictions whose window passed without a fault."""
        still = []
        for d in self._open_predictions:
            if d < now - self.match_window:
                self._precision.update(0.0)
            else:
                still.append(d)
        self._open_predictions = still

    # -- state ------------------------------------------------------------------

    @property
    def state(self) -> EstimatorState:
        return EstimatorState(self._mu.value, self._recall.value,
                              self._precision.value,
                              self.n_faults, self.n_predictions)


class AdaptiveScheduler:
    """CheckpointScheduler that re-plans from online estimates."""

    def __init__(self, prior: PlatformConfig, n_devices: int, *,
                 c: float, cp: float, halflife: float = 20.0,
                 replan_threshold: float = 0.15) -> None:
        self.prior = prior
        self.n_devices = n_devices
        self.c, self.cp = c, cp
        self.threshold = replan_threshold
        self.estimator = OnlineEstimator(halflife=halflife, prior=prior)
        self.scheduler = CheckpointScheduler(prior, n_devices, c=c, cp=cp)
        self.n_replans = 0

    def _current_config(self) -> PlatformConfig:
        st = self.estimator.state
        mu_platform = st.mu if st.mu is not None \
            else self.prior.mu_ind / self.n_devices
        return dataclasses.replace(
            self.prior,
            # Estimated mu is already platform-level; scheduler divides by
            # n_devices, so scale back up.
            mu_ind=mu_platform * self.n_devices,
            recall=st.recall if st.recall is not None else self.prior.recall,
            precision=(st.precision if st.precision is not None
                       else self.prior.precision),
        )

    def maybe_replan(self) -> bool:
        """Rebuild the schedule if the optimal period moved enough."""
        cfg = self._current_config()
        if cfg.recall <= 0 or not (0 < cfg.precision <= 1):
            return False
        new = CheckpointScheduler(cfg, self.n_devices, c=self.c, cp=self.cp)
        old_t = self.scheduler.period
        if abs(new.period - old_t) / old_t > self.threshold:
            new._last_save_end = self.scheduler._last_save_end
            self.scheduler = new
            self.n_replans += 1
            return True
        return False
