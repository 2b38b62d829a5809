"""Phase codes, trust policies and the per-lane result of the simulator.

The port's own copy of ``repro/core/simulator.py:97-137`` (and the
``SimResult`` record the lane engine's :class:`BatchResult` rebuilds).
The scalar event loop itself is not ported: the lane engine in
:mod:`repro_torch.core.batch_torch` is the port's engine, and its tests
hold it to the JAX package's scalar and numpy engines.

Phases of the execution machine: WORK / CKPT / PROCKPT / DOWN / RECOVER /
VERIFY.  Trust policies decide whether to act on a prediction given its
offset in the period (paper §4).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "WINDOW_MODES",
    "TrustPolicy",
    "NeverTrust",
    "AlwaysTrust",
    "FixedProbabilityTrust",
    "ThresholdTrust",
    "SimResult",
]

# Phases of the execution machine.
_WORK, _CKPT, _PROCKPT, _DOWN, _RECOVER, _VERIFY = range(6)

# Window action modes (companion paper, arXiv:1302.4558).
WINDOW_MODES = ("instant", "within")


# ---------------------------------------------------------------------------
# Trust policies (whether to act on a prediction)
# ---------------------------------------------------------------------------

class TrustPolicy:
    """Decides whether to act on a prediction given its offset in the period."""

    def trust(self, offset: float, rng: np.random.Generator) -> bool:
        raise NotImplementedError


class NeverTrust(TrustPolicy):
    def trust(self, offset: float, rng: np.random.Generator) -> bool:
        return False


class AlwaysTrust(TrustPolicy):
    def trust(self, offset: float, rng: np.random.Generator) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class FixedProbabilityTrust(TrustPolicy):
    """Paper §4.1: trust each actionable prediction with probability q."""

    q: float

    def trust(self, offset: float, rng: np.random.Generator) -> bool:
        return bool(rng.random() < self.q)


@dataclasses.dataclass(frozen=True)
class ThresholdTrust(TrustPolicy):
    """Paper Theorem 1: trust iff the prediction offset >= threshold."""

    threshold: float

    def trust(self, offset: float, rng: np.random.Generator) -> bool:
        return offset >= self.threshold


# ---------------------------------------------------------------------------
# Simulation result
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SimResult:
    makespan: float
    time_base: float
    n_faults: int = 0
    n_faults_hit: int = 0          # faults that destroyed work or a phase
    n_predictions: int = 0
    n_trusted: int = 0             # proactive checkpoints taken
    n_trusted_true: int = 0        # ... that did precede an actual fault
    n_ignored_by_necessity: int = 0
    n_periodic_ckpts: int = 0
    time_ckpt: float = 0.0         # periodic checkpointing time
    time_prockpt: float = 0.0      # proactive checkpointing time
    time_down: float = 0.0         # downtime + recovery
    time_lost: float = 0.0         # destroyed (re-executed) work
    # Waste-attribution split of ``time_down`` (repro.obs): independent
    # accumulators for the downtime (D, incl. interrupted downtimes) and
    # recovery (R, incl. interrupted recoveries) portions.  ``time_down``
    # stays the authoritative merged accrual; the split is accrued from the
    # same per-event terms, so time_downtime + time_recovery == time_down
    # up to summation order (not bitwise).
    time_downtime: float = 0.0     # downtime-only portion of time_down
    time_recovery: float = 0.0     # recovery-only portion of time_down
    n_proactive_ckpts: int = 0     # completed proactive checkpoints
    n_rollbacks: int = 0           # faults that discarded positive progress
    # Silent-error + verification diagnostics (arXiv:1310.8486).
    n_silent: int = 0              # silent strikes that corrupted state
    n_verifications: int = 0       # completed verification points
    n_deep_rollbacks: int = 0      # detections past >= 1 corrupted ckpt
    time_verify: float = 0.0       # completed verification time
    # Adaptive re-planning diagnostics (repro.predictors.estimator); the
    # sentinels keep non-adaptive runs comparable across engines.
    n_replans: int = 0
    final_period: float = -1.0     # last planned period (static: the period)
    final_threshold: float = -1.0  # last planned trust threshold (-1: static)
    est_recall: float = -1.0       # final r-hat (-1: no estimator / no data)
    est_precision: float = -1.0    # final p-hat
    est_mu: float = -1.0           # final mu-hat (-1: mu not estimated)

    @property
    def waste(self) -> float:
        return 1.0 - self.time_base / self.makespan if self.makespan > 0 else 0.0
