"""Checkpoint scheduler: the paper's optimal policy as a runtime component.

The port's own copy of ``repro/ft/scheduler.py``, over the port's
``core/waste.py``, ``core/prediction.py`` and ``fleet/availability.py``
(bitwise copies of the reference's), so its decision is the reference's
floats:

  * the platform MTBF is derived from the mesh size
    (mu = mu_ind / n_devices, paper Prop. 2);
  * C and C_p come from the checkpoint manager's cost model (per-shard
    bytes / bandwidth) or are given;
  * the period T* is :func:`optimal_period_with_prediction` (Eq. 16/17)
    when a predictor is configured, :func:`t_rfo` (Eq. 13) otherwise;
  * predictions are trusted iff their date falls >= beta_lim = C_p / p
    after the last state save (Theorem 1).

The scheduler is deliberately stateless w.r.t. the training state — it just
answers "checkpoint now?", "trust this prediction?" from clock readings, so
the trainer, the serving engine, or an external orchestrator can all drive it.
"""

from __future__ import annotations

import dataclasses
import math

from ..configs.base import PlatformConfig
from ..core.prediction import (PredictedPlatform, Predictor, beta_lim,
                               optimal_period_with_prediction)
from ..core.waste import Platform, t_rfo, waste

__all__ = ["ScheduleDecision", "CheckpointScheduler"]


@dataclasses.dataclass(frozen=True)
class ScheduleDecision:
    period: float          # chosen checkpointing period T*
    use_predictions: bool  # whether the WASTE2 branch won
    beta_lim: float        # trust threshold (C_p/p; availability: beta_A)
    expected_waste: float  # analytic objective value at T* (waste or U)


class CheckpointScheduler:
    """Plans checkpoint cadence and trust decisions for a live job.

    ``objective`` selects the analytic model the plan minimizes:
    ``"waste"`` (default) is the paper's makespan overhead,
    ``"availability"`` the weighted outage fraction of
    :mod:`repro.fleet.availability`, using the platform's
    ``ckpt_outage`` / ``prockpt_outage`` / ``replay_outage`` fractions
    (unit weights plan identically to ``"waste"``).
    """

    def __init__(self, platform: PlatformConfig, n_devices: int, *,
                 c: float | None = None, cp: float | None = None,
                 use_predictor: bool = True,
                 objective: str = "waste") -> None:
        if objective not in ("waste", "availability"):
            raise ValueError(f"objective must be 'waste' or 'availability', "
                             f"got {objective!r}")
        self.cfg = platform
        self.n_devices = n_devices
        self.objective = objective
        self.c = float(c if c is not None else platform.c)
        self.cp = float(cp if cp is not None else platform.cp)
        if self.c <= 0 or self.cp <= 0:
            raise ValueError(
                "checkpoint costs must be positive; pass measured/modeled "
                f"costs (got C={self.c}, C_p={self.cp})")
        self.mu = platform.mu_ind / n_devices
        self.plat = Platform(mu=self.mu, c=self.c, d=platform.d, r=platform.r)
        self.use_predictor = use_predictor and platform.recall > 0
        if objective == "availability":
            from ..fleet.availability import (OutageWeights, beta_avail,
                                              optimal_period_availability,
                                              t_avail_nopred,
                                              unavailability_nopred)
            w = OutageWeights(ckpt=platform.ckpt_outage,
                              prockpt=platform.prockpt_outage,
                              replay=platform.replay_outage)
            if self.use_predictor:
                pred = Predictor(recall=platform.recall,
                                 precision=platform.precision)
                self.pp = PredictedPlatform(self.plat, pred, cp=self.cp)
                t, u, use = optimal_period_availability(self.pp, w)
                self.decision = ScheduleDecision(
                    t, use, beta_avail(self.pp, w), u)
            else:
                t = t_avail_nopred(self.plat, w)
                self.decision = ScheduleDecision(
                    t, False, math.inf, unavailability_nopred(t, self.plat, w))
        elif self.use_predictor:
            pred = Predictor(recall=platform.recall,
                             precision=platform.precision)
            self.pp = PredictedPlatform(self.plat, pred, cp=self.cp)
            t, w, use = optimal_period_with_prediction(self.pp)
            self.decision = ScheduleDecision(t, use, beta_lim(self.pp), w)
        else:
            t = t_rfo(self.plat)
            self.decision = ScheduleDecision(t, False, math.inf,
                                             waste(t, self.plat))
        self._last_save_end = 0.0

    # -- runtime queries -------------------------------------------------------

    @property
    def period(self) -> float:
        return self.decision.period

    def notify_save_completed(self, now: float) -> None:
        """Any completed state save (periodic, proactive, or recovery)."""
        self._last_save_end = now

    def next_checkpoint_start(self) -> float:
        """Wall-clock time at which the next periodic checkpoint should
        start: work for T - C after the last save."""
        return self._last_save_end + self.decision.period - self.c

    def due(self, now: float) -> bool:
        return now >= self.next_checkpoint_start()

    def trust(self, prediction_date: float) -> bool:
        """Theorem 1: act iff the predicted date is >= beta_lim after the
        last save (and predictions are worth using at all)."""
        if not self.use_predictor or not self.decision.use_predictions:
            return False
        offset = prediction_date - self._last_save_end
        return offset >= self.decision.beta_lim

    def steps_per_checkpoint(self, step_time: float) -> int:
        """Translate the period into a steps-per-checkpoint cadence."""
        return max(1, int((self.decision.period - self.c) / step_time))
