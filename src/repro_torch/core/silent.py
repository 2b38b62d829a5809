"""Silent-error (SDC) checkpointing with verifications (arXiv:1310.8486).

Fail-stop faults announce themselves; *silent* data corruptions do not —
they are only caught by an explicit verification (cost V) comparing the
application state against invariants.  The simulator models this with a
per-trace silent-error stream (``make_event_trace(silent_mu=...)``), ``k``
verifications per period (the work splits into ``k`` equal chunks, each
followed by a verification, the last one guarding the periodic
checkpoint), and a retained-checkpoint ring of depth ``keep_ckpts`` so a
late detection can roll back *past* corrupted snapshots to the newest
clean one.

This module is the analytic mirror of that machinery, the same way
:mod:`repro_torch.core.prediction` mirrors the prediction simulator:

  * first-order combined waste ``W(T, k)`` for fail-stop rate ``1/mu``
    plus silent rate ``1/mu_s`` — checkpoint+verification overhead
    ``(C + kV)/T``, fail-stop loss ``(D + R + T/2)/mu``, and silent loss
    ``(R + T(k+1)/(2k))/mu_s`` (a corruption strikes uniformly in the
    period and is detected at the next verification, losing the guilty
    chunk's work plus half a chunk in expectation);
  * the closed-form per-``k`` optimal period
    ``T*(k) = sqrt((C + kV) / (1/(2 mu) + (k+1)/(2 k mu_s)))`` and the
    integer scan for the jointly optimal ``(T*, k*)``;
  * the composition with fault prediction: the silent terms add linearly
    to the WASTE2 coefficients of Eq. 15
    (``v' = v + kV``, ``w' = w + R/mu_s``, ``x' = x + (k+1)/(2k mu_s)``),
    so the §4.3 cubic machinery minimizes the combined model.

At silent rate 0 (``silent_mu`` None or inf) and ``k = 0`` everything
collapses bit-for-bit to the fail-stop formulas (Eq. 11/12 and the Eq. 15
machinery), which the regression tests pin.

The port's own copy of ``repro/core/silent.py``, operation for operation.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .policies import Strategy
from .prediction import PredictedPlatform, _waste2_coeffs, beta_lim
from .simulator import NeverTrust, ThresholdTrust
from .waste import ALPHA_CAP, Platform, t_rfo, waste

__all__ = [
    "SilentPlan",
    "waste_silent",
    "t_silent",
    "optimal_silent_plan",
    "waste_silent_pred",
    "t_silent_pred",
    "optimal_silent_pred_plan",
    "silent_strategy",
]

# Retained-ring depth the silent strategies default to: with a single
# retained checkpoint, a corruption striking *during* a checkpoint write
# evicts the only clean snapshot and detection restarts the job from
# scratch (the engines reproduce exactly that catastrophe).
DEFAULT_KEEP_CKPTS = 2


def _silent_off(silent_mu: float | None) -> bool:
    return silent_mu is None or math.isinf(silent_mu)


def _check_rates(silent_mu: float | None, verify_cost: float) -> None:
    if silent_mu is not None and not silent_mu > 0.0:
        raise ValueError(f"silent_mu must be positive (or None/inf for no "
                         f"silent errors), got {silent_mu}")
    if not (math.isfinite(verify_cost) and verify_cost >= 0.0):
        raise ValueError(f"verify_cost must be finite and >= 0, "
                         f"got {verify_cost}")


def waste_silent(t: float, k: int, platform: Platform,
                 silent_mu: float | None, verify_cost: float = 0.0) -> float:
    """First-order combined waste of (T, k) under both fault rates.

    ``k = 0`` is only valid at silent rate 0 (detection would otherwise
    wait for the end-of-job acceptance check, whose expected waste has no
    first-order model).  Collapses to :func:`repro_torch.core.waste.waste`
    exactly when the silent stream is off and ``k = 0``.
    """
    _check_rates(silent_mu, verify_cost)
    k = int(k)
    if k < 0:
        raise ValueError(f"n_verify must be >= 0, got {k}")
    if t < platform.c:
        raise ValueError(f"T={t} < C={platform.c}")
    if _silent_off(silent_mu):
        if k == 0:
            return waste(t, platform)
        wff = (platform.c + k * verify_cost) / t
        wfault = (platform.d + platform.r + t / 2.0) / platform.mu
        return wff + wfault - wff * wfault
    if k == 0:
        raise ValueError("n_verify=0 with a positive silent-error rate: "
                         "detection only happens at the end-of-job "
                         "acceptance check, outside the first-order model")
    if k * verify_cost >= t:
        raise ValueError(f"k*V = {k * verify_cost} >= T = {t}: "
                         f"verification consumes the whole period")
    wff = (platform.c + k * verify_cost) / t
    wfault = (platform.d + platform.r + t / 2.0) / platform.mu
    wsilent = (platform.r + t * (k + 1) / (2.0 * k)) / silent_mu
    loss = wfault + wsilent
    return wff + loss - wff * loss


def t_silent(k: int, platform: Platform, silent_mu: float | None,
             verify_cost: float = 0.0) -> float:
    """Per-``k`` optimal period: balance (C + kV)/T against the linear
    loss terms.  Clamped below at C."""
    _check_rates(silent_mu, verify_cost)
    k = int(k)
    if _silent_off(silent_mu):
        denom = 1.0 / (2.0 * platform.mu)
    else:
        if k < 1:
            raise ValueError("n_verify must be >= 1 with silent errors")
        denom = 1.0 / (2.0 * platform.mu) \
            + (k + 1) / (2.0 * k * silent_mu)
    t = math.sqrt((platform.c + k * verify_cost) / denom)
    return max(platform.c, min(t, ALPHA_CAP * platform.mu))


@dataclasses.dataclass(frozen=True)
class SilentPlan:
    """A jointly optimized (T*, k*) operating point (mirrors
    :class:`repro_torch.core.windows.WindowPlan`)."""

    period: float
    n_verify: int
    verify_cost: float
    keep_ckpts: int
    waste: float
    use_predictions: bool = False


def optimal_silent_plan(platform: Platform, silent_mu: float | None,
                        verify_cost: float = 0.0, *, k_max: int = 16,
                        keep_ckpts: int = DEFAULT_KEEP_CKPTS) -> SilentPlan:
    """Scan k in [1, k_max] for the best (T*(k), k); silent rate 0 returns
    the plain RFO point with k = 0.

    Domain guards: a ``k`` whose verification overhead swallows its own
    period (``k·V >= T*(k)``) is infeasible and skipped; if every ``k``
    is infeasible the verification cost cannot pay for itself and the
    call raises.
    """
    _check_rates(silent_mu, verify_cost)
    if k_max < 1:
        raise ValueError(f"k_max must be >= 1, got {k_max}")
    if keep_ckpts < 1:
        raise ValueError(f"keep_ckpts must be >= 1, got {keep_ckpts}")
    if _silent_off(silent_mu):
        t = max(platform.c, t_rfo(platform))
        return SilentPlan(t, 0, verify_cost, 1, waste(t, platform))
    best: SilentPlan | None = None
    for k in range(1, k_max + 1):
        t = t_silent(k, platform, silent_mu, verify_cost)
        if k * verify_cost >= t:
            continue
        w = waste_silent(t, k, platform, silent_mu, verify_cost)
        if best is None or w < best.waste:
            best = SilentPlan(t, k, verify_cost, keep_ckpts, w)
    if best is None:
        raise ValueError(
            f"no feasible verification count in [1, {k_max}]: verify_cost "
            f"{verify_cost} swallows every candidate period")
    return best


# ---------------------------------------------------------------------------
# Composition with fault prediction (the Eq. 15 WASTE2 machinery)
# ---------------------------------------------------------------------------

def _silent_pred_coeffs(k: int, pp: PredictedPlatform, silent_mu: float,
                        verify_cost: float
                        ) -> tuple[float, float, float, float]:
    """WASTE2 coefficients with the silent terms folded in:
    W(T) = u/T^2 + v'/T + w' + x'·T."""
    u, v, w, x = _waste2_coeffs(pp)
    v += k * verify_cost
    w += pp.platform.r / silent_mu
    x += (k + 1) / (2.0 * k * silent_mu)
    return u, v, w, x


def waste_silent_pred(t: float, k: int, pp: PredictedPlatform,
                      silent_mu: float, verify_cost: float = 0.0) -> float:
    """Combined prediction + silent-error waste at period T (WASTE2
    branch: predictions past beta_lim are acted on)."""
    _check_rates(silent_mu, verify_cost)
    k = int(k)
    if _silent_off(silent_mu) or k < 1:
        raise ValueError("waste_silent_pred needs a finite silent_mu and "
                         "n_verify >= 1; use the prediction-only model "
                         "otherwise")
    if k * verify_cost >= t:
        raise ValueError(f"k*V = {k * verify_cost} >= T = {t}: "
                         f"verification consumes the whole period")
    u, v, w, x = _silent_pred_coeffs(k, pp, silent_mu, verify_cost)
    return u / (t * t) + v / t + w + x * t


def t_silent_pred(k: int, pp: PredictedPlatform, silent_mu: float,
                  verify_cost: float = 0.0) -> float:
    """Minimizer of the combined WASTE2 on [max(C, beta_lim), +inf).

    Same cubic as :func:`repro_torch.core.prediction.t_pred` with the silent
    coefficients: x'·T^3 - v'·T - 2u = 0.  The lower bound mirrors the
    ``beta_lim < C`` guard — the validity interval never extends below a
    legal period.  ``x'`` is strictly positive for any finite silent
    rate (even at recall 1), so the cubic always has its unique positive
    root.
    """
    _check_rates(silent_mu, verify_cost)
    k = int(k)
    if _silent_off(silent_mu) or k < 1:
        raise ValueError("t_silent_pred needs a finite silent_mu and "
                         "n_verify >= 1")
    u, v, _, x = _silent_pred_coeffs(k, pp, silent_mu, verify_cost)
    lo = max(pp.platform.c, beta_lim(pp))
    roots = np.roots([x, 0.0, -v, -2.0 * u])
    candidates = [lo]
    for root in roots:
        if abs(root.imag) < 1e-9 * max(1.0, abs(root.real)) \
                and root.real > lo:
            candidates.append(float(root.real))

    def _w(t: float) -> float:
        return u / (t * t) + v / t + x * t

    return min(candidates, key=_w)


def optimal_silent_pred_plan(pp: PredictedPlatform, silent_mu: float,
                             verify_cost: float = 0.0, *, k_max: int = 16,
                             keep_ckpts: int = DEFAULT_KEEP_CKPTS
                             ) -> SilentPlan:
    """The jointly optimal (T*, k*) with prediction trust enabled."""
    _check_rates(silent_mu, verify_cost)
    if k_max < 1:
        raise ValueError(f"k_max must be >= 1, got {k_max}")
    if keep_ckpts < 1:
        raise ValueError(f"keep_ckpts must be >= 1, got {keep_ckpts}")
    if _silent_off(silent_mu):
        raise ValueError("optimal_silent_pred_plan needs a finite "
                         "silent_mu; use optimal_period_with_prediction "
                         "at rate 0")
    best: SilentPlan | None = None
    for k in range(1, k_max + 1):
        t = t_silent_pred(k, pp, silent_mu, verify_cost)
        if k * verify_cost >= t:
            continue
        w = waste_silent_pred(t, k, pp, silent_mu, verify_cost)
        if best is None or w < best.waste:
            best = SilentPlan(t, k, verify_cost, keep_ckpts, w,
                              use_predictions=True)
    if best is None:
        raise ValueError(
            f"no feasible verification count in [1, {k_max}]: verify_cost "
            f"{verify_cost} swallows every candidate period")
    return best


# ---------------------------------------------------------------------------
# Simulator-ready strategies
# ---------------------------------------------------------------------------

def silent_strategy(platform: Platform, silent_mu: float | None,
                    verify_cost: float = 0.0, *, mode: str = "verify",
                    pp: PredictedPlatform | None = None, k_max: int = 16,
                    keep_ckpts: int = DEFAULT_KEEP_CKPTS) -> Strategy:
    """Build the simulator-ready strategy for a silent-error scenario.

      * ``ignore``      — RFO, no verifications (the fail-stop baseline
                          running blind on the silent stream);
      * ``verify``      — the (T*, k*) plan, never trusting predictions;
      * ``verify_pred`` — the combined plan with Theorem-1 threshold
                          trust (needs ``pp``).
    """
    if mode == "ignore":
        t = max(platform.c, t_rfo(platform))
        return Strategy("SilentIgnore", t, NeverTrust())
    if mode == "verify":
        plan = optimal_silent_plan(platform, silent_mu, verify_cost,
                                   k_max=k_max, keep_ckpts=keep_ckpts)
        return Strategy("SilentVerify", plan.period, NeverTrust(),
                        n_verify=plan.n_verify,
                        verify_cost=plan.verify_cost,
                        keep_ckpts=plan.keep_ckpts)
    if mode == "verify_pred":
        if pp is None:
            raise ValueError("mode 'verify_pred' needs the predicted "
                             "platform pp")
        if _silent_off(silent_mu):
            from .policies import optimal_prediction
            base = optimal_prediction(pp)
            return dataclasses.replace(base, name="SilentVerifyPred")
        plan = optimal_silent_pred_plan(pp, silent_mu, verify_cost,
                                        k_max=k_max, keep_ckpts=keep_ckpts)
        return Strategy("SilentVerifyPred", plan.period,
                        ThresholdTrust(beta_lim(pp)),
                        n_verify=plan.n_verify,
                        verify_cost=plan.verify_cost,
                        keep_ckpts=plan.keep_ckpts)
    raise ValueError(f"unknown silent mode {mode!r} "
                     f"(expected 'ignore', 'verify' or 'verify_pred')")
