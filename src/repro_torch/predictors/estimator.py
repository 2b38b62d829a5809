"""Online (r, p) estimation and adaptive re-planning.

The paper's optimal policy needs the predictor's recall r and precision p
to pick the period T* and the trust breakpoint beta_lim = C_p/p — but as
Aupy et al. stress (arXiv:1207.6936 §5), r and p are not oracles: they
must be *estimated online* from the prediction stream.  This module holds
the two pieces:

  * :class:`OnlineRPEstimator` — running (r-hat, p-hat) from the observed
    stream of confirmed / false predictions and predicted / unpredicted
    faults, with a **confidence gate**: the estimates are not trusted until
    enough predictions *and* faults have been observed (a handful of
    events says nothing about a ratio).
  * :class:`AdaptiveConfig` — the declarative knob set for the ``adaptive``
    strategy: both simulation engines keep exactly this estimator per
    lane (scalar locals in ``simulate``, SoA arrays in the lane engine)
    and re-plan (T*, trust threshold) through :meth:`AdaptiveConfig.plan`
    whenever the gated estimates drift more than ``tol`` from the values
    last planned on — the hysteresis that keeps the checkpoint cadence
    from thrashing (the waste curve is flat near its minimum).

Estimator semantics in the engines: a prediction's outcome is observed at
announcement (the simulator knows whether it will materialize; a real
system learns it when the prediction window closes — a lead of at most one
window that the gate's minimum counts make irrelevant), and every
unpredicted fault is observed when it strikes.  Counts are plain integers,
so the two engines produce **bit-for-bit identical** estimates, replan
points and plans.

The replan math itself is :func:`maybe_replan` — a pure function shared by
both engines (the lane engine pre-filters lanes vectorized with the same
integer/float operations, then confirms per lane through this function).

The port's own copy of ``repro/predictors/estimator.py``: the same
floating-point operations in the same order, so plans are bitwise the JAX
package's.  The port's lane engine keeps the counters in its lane-loop
kernel and re-plans the lanes that fire through :func:`maybe_replan`
(``repro_torch/core/batch_torch.py``).
"""

from __future__ import annotations

import dataclasses
import math

from ..core.prediction import (PredictedPlatform, Predictor, beta_lim,
                               optimal_period_with_prediction)
from ..core.waste import Platform

__all__ = [
    "P_HAT_MIN",
    "AdaptiveConfig",
    "decay_factor",
    "OnlineRPEstimator",
    "estimate_recall",
    "estimate_precision",
    "maybe_replan",
]

# Precision estimate floor: p-hat = 0 (no prediction ever confirmed) would
# put beta_lim at infinity and break the Predictor domain; a tiny positive
# floor keeps the plan finite ("never worth trusting") instead.
P_HAT_MIN = 1e-3


def decay_factor(halflife: float | None) -> float:
    """Per-observation decay of the windowed (EW) estimator counters.

    ``halflife`` is measured in observations: after that many further
    events an old observation's weight has halved.  ``None`` (the legacy
    cumulative estimator) decays nothing.
    """
    return 1.0 if halflife is None else 0.5 ** (1.0 / halflife)


def estimate_recall(n_true_pred: float, n_unpred_faults: float) -> float:
    """r-hat = predicted faults / all faults (every true prediction is one
    predicted fault)."""
    return n_true_pred / (n_true_pred + n_unpred_faults)


def estimate_precision(n_true_pred: float, n_false_pred: float) -> float:
    """p-hat = confirmed predictions / all predictions, floored at
    :data:`P_HAT_MIN`."""
    p = n_true_pred / (n_true_pred + n_false_pred)
    return p if p >= P_HAT_MIN else P_HAT_MIN


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Knobs of the adaptive re-planning strategy (engine-agnostic).

    ``prior_recall`` / ``prior_precision`` are the (possibly stale) values
    the initial plan was computed from — they seed the hysteresis baseline,
    so the first replan fires as soon as the gated estimates leave the
    ``tol``-box around the prior.  ``min_preds`` / ``min_faults`` is the
    confidence gate; ``tol`` the re-plan hysteresis (absolute, on both
    estimates).  ``model_order`` selects the analysis each re-plan solves:
    the paper's first-order model (default) or the exact-Exponential
    renewal analysis of :mod:`repro_torch.core.exact`.

    ``estimate_mu`` additionally estimates the platform MTBF online (the
    EW mean of observed fault inter-arrival gaps, mirroring
    ``ft/estimator.py``) and re-plans on the estimated mu instead of the
    assumed ``platform.mu`` — the same hysteresis applies, *relative* for
    mu (``|mu_hat - planned_mu| > tol * planned_mu``) because mu is not a
    ratio in [0, 1].
    """

    prior_recall: float
    prior_precision: float
    min_preds: int = 32
    min_faults: int = 16
    tol: float = 0.05
    model_order: str = "first"
    halflife: float | None = None
    estimate_mu: bool = False

    def __post_init__(self) -> None:
        if self.min_preds < 1 or self.min_faults < 1:
            raise ValueError("confidence gate needs min_preds/min_faults >= 1")
        if self.tol <= 0.0:
            raise ValueError(f"tol must be positive, got {self.tol}")
        if self.model_order not in ("first", "exact"):
            raise ValueError(f"model_order must be 'first' or 'exact', "
                             f"got {self.model_order!r}")
        if self.halflife is not None:
            if self.halflife <= 0.0:
                raise ValueError(f"halflife must be positive, "
                                 f"got {self.halflife}")
            # The decayed counters converge to sum(decay^k) = 1/(1 - decay)
            # ~= 1.44 * halflife: a gate above that ceiling never opens.
            ceiling = 1.0 / (1.0 - decay_factor(self.halflife))
            if min(self.min_preds, self.min_faults) > ceiling:
                raise ValueError(
                    f"halflife {self.halflife} caps the effective counts at "
                    f"~{ceiling:.1f}; the gate (min_preds={self.min_preds}, "
                    f"min_faults={self.min_faults}) would never open")

    def plan(self, platform: Platform, cp: float, recall: float,
             precision: float, mu: float | None = None) -> tuple[float, float]:
        """(period, trust threshold) of the model-optimal plan at (r, p).

        The threshold is the trust breakpoint when the acting branch wins
        (beta_lim = C_p/p at first order, its numeric analogue for the
        exact model) and +inf when the predictor is analytically not worth
        using (never trust).  ``mu`` (if given) overrides the platform MTBF
        with the online estimate.
        """
        if mu is not None:
            platform = dataclasses.replace(platform, mu=float(mu))
        pp = PredictedPlatform(platform, Predictor(recall, precision), cp)
        if self.model_order == "exact":
            from ..core.exact import optimal_period_exact
            ep = optimal_period_exact(pp)
            t, thr = ep.period, (ep.threshold if ep.use_predictions
                                 else math.inf)
        else:
            t, _, use = optimal_period_with_prediction(pp)
            thr = beta_lim(pp) if use else math.inf
        # Degenerate-estimate guard: a plan with T <= C makes no forward
        # progress (W = T - C <= 0); floor the period so one checkpoint
        # plus a proactive-checkpoint's worth of work always fits.
        return max(float(t), platform.c + cp), thr

    def key(self) -> tuple:
        """Value-semantics tuple for result-cache candidate keys."""
        return (self.prior_recall, self.prior_precision, self.min_preds,
                self.min_faults, self.tol, self.halflife, self.model_order,
                self.estimate_mu)

    @property
    def decay(self) -> float:
        """Per-observation counter decay factor (1.0 = cumulative)."""
        return decay_factor(self.halflife)


def maybe_replan(cfg: AdaptiveConfig, platform: Platform, cp: float,
                 n_true_pred: float, n_false_pred: float,
                 n_unpred_faults: float,
                 planned_recall: float, planned_precision: float,
                 mu_hat: float | None = None,
                 planned_mu: float | None = None,
                 ) -> tuple[float, float, float, float] | None:
    """One estimator observation step, shared by both engines.

    Called after a counter update; returns ``None`` (keep the current
    plan: gate not passed, or estimates still inside the hysteresis box)
    or ``(r_hat, p_hat, period, threshold)`` for a re-plan.

    ``mu_hat`` / ``planned_mu`` (``estimate_mu`` configs only) widen the
    hysteresis box with a relative-mu axis: a large enough MTBF drift
    triggers a re-plan even when (r-hat, p-hat) sit still, and every
    re-plan is solved at the estimated mu.
    """
    if n_true_pred + n_false_pred < cfg.min_preds:
        return None
    if n_true_pred + n_unpred_faults < cfg.min_faults:
        return None
    r_hat = estimate_recall(n_true_pred, n_unpred_faults)
    p_hat = estimate_precision(n_true_pred, n_false_pred)
    mu_moved = (mu_hat is not None and planned_mu is not None
                and abs(mu_hat - planned_mu) > cfg.tol * planned_mu)
    if abs(r_hat - planned_recall) <= cfg.tol \
            and abs(p_hat - planned_precision) <= cfg.tol \
            and not mu_moved:
        return None
    period, threshold = cfg.plan(platform, cp, r_hat, p_hat, mu=mu_hat)
    return r_hat, p_hat, period, threshold


class OnlineRPEstimator:
    """Standalone running (r-hat, p-hat) estimator over an event feed.

    The user-facing counterpart of the per-lane counters the engines
    carry: feed it prediction outcomes and fault observations in event
    order, read the gated estimates back.  Used by the runtime layer and
    the examples; the engines inline the same integer counters for
    bit-for-bit scalar/batch parity.

    ``halflife`` turns the cumulative counters into exponentially-weighted
    ones (decayed by :func:`decay_factor` before every observation), so the
    estimates track a *drifting* predictor instead of converging to the
    stale all-time average — at the cost of capping the effective counts at
    ~1.44 * halflife (size the gate below that).
    """

    def __init__(self, *, min_preds: int = 32, min_faults: int = 16,
                 halflife: float | None = None) -> None:
        self.min_preds = min_preds
        self.min_faults = min_faults
        self.halflife = halflife
        self._decay = decay_factor(halflife)
        self.n_true_pred: float = 0
        self.n_false_pred: float = 0
        self.n_unpred_faults: float = 0

    def _age(self) -> None:
        if self._decay != 1.0:
            self.n_true_pred *= self._decay
            self.n_false_pred *= self._decay
            self.n_unpred_faults *= self._decay

    def observe_prediction(self, confirmed: bool) -> None:
        """A prediction whose outcome is known (materialized or not)."""
        self._age()
        if confirmed:
            self.n_true_pred += 1
        else:
            self.n_false_pred += 1

    def observe_fault(self, predicted: bool) -> None:
        """An actual fault; ``predicted`` = a prediction announced it.

        Predicted faults are already counted by their confirmed
        prediction, so only unpredicted ones advance a counter here."""
        if not predicted:
            self._age()
            self.n_unpred_faults += 1

    @property
    def n_predictions(self) -> float:
        return self.n_true_pred + self.n_false_pred

    @property
    def n_faults(self) -> float:
        return self.n_true_pred + self.n_unpred_faults

    @property
    def ready(self) -> bool:
        """The confidence gate: enough predictions *and* faults seen."""
        return self.n_predictions >= self.min_preds \
            and self.n_faults >= self.min_faults

    @property
    def recall(self) -> float | None:
        if self.n_faults == 0:
            return None
        return estimate_recall(self.n_true_pred, self.n_unpred_faults)

    @property
    def precision(self) -> float | None:
        if self.n_predictions == 0:
            return None
        return estimate_precision(self.n_true_pred, self.n_false_pred)
