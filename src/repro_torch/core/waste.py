"""First-order waste model and optimal checkpoint periods (paper §3).

Implements:
  * Young's period       T = sqrt(2 mu C) + C                    [Young 1974]
  * Daly's period        T = sqrt(2 (mu + D + R) C) + C          [Daly 2004]
  * RFO period           T = sqrt(2 (mu - (D + R)) C)            [paper Eq. 13]
  * the waste model      WASTE = C/T + (1 - C/T) (D + R + T/2)/mu  [Eq. 12]
  * the exact Exponential-law optimum via Lambert W              [paper §3 end]

All durations share one unit (seconds by convention).  ``mu`` is the platform
MTBF; for a platform of N components with individual MTBF mu_ind,
``mu = mu_ind / N`` (paper Prop. 2, proved in Appendix A).

The first-order formulas here drop every O((T/mu)^2) term; the exact
renewal analysis (including the prediction-aware generalization of the
Lambert-W optimum below) lives in :mod:`repro_torch.core.exact`.

The port's own copy of ``repro/core/waste.py``: the same floating-point
operations in the same order, so periods planned here are bitwise the JAX
package's.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = [
    "Platform",
    "platform_mtbf",
    "waste_ff",
    "waste_fault",
    "waste",
    "t_young",
    "t_daly",
    "t_rfo",
    "lambert_w",
    "t_exact_exponential",
    "expected_makespan_first_order",
    "expected_makespan_exponential",
    "clamp_period",
    "ALPHA_CAP",
]

# Paper §3: cap T <= alpha * mu so that P(>=2 faults per period) <= 3%.
ALPHA_CAP = 0.27


def platform_mtbf(mu_ind: float, n: int) -> float:
    """MTBF of an N-component platform (paper Prop. 2): mu = mu_ind / N."""
    if n <= 0:
        raise ValueError(f"platform size must be positive, got {n}")
    if mu_ind <= 0:
        raise ValueError(f"individual MTBF must be positive, got {mu_ind}")
    return mu_ind / n


@dataclasses.dataclass(frozen=True)
class Platform:
    """Fault/checkpoint parameters of a platform (paper Table 1).

    Attributes:
      mu: platform MTBF (already divided by the number of components).
      c:  duration of a regular (periodic) checkpoint.
      d:  downtime after a fault.
      r:  recovery duration (reload from last checkpoint).
    """

    mu: float
    c: float
    d: float = 0.0
    r: float = 0.0

    def __post_init__(self) -> None:
        if self.mu <= 0 or self.c <= 0 or self.d < 0 or self.r < 0:
            raise ValueError(f"invalid platform parameters: {self}")

    @classmethod
    def from_components(cls, mu_ind: float, n: int, c: float, d: float = 0.0,
                        r: float = 0.0) -> "Platform":
        return cls(mu=platform_mtbf(mu_ind, n), c=c, d=d, r=r)


# ---------------------------------------------------------------------------
# Waste model (Eqs. 4, 7, 11, 12)
# ---------------------------------------------------------------------------

def waste_ff(t: float, c: float) -> float:
    """Fault-free waste WASTE_FF = C / T (Eq. 4).  Requires C <= T."""
    if t < c:
        raise ValueError(f"period T={t} must be >= checkpoint C={c}")
    return c / t


def waste_fault(t: float, p: Platform) -> float:
    """Waste due to faults: (D + R + T/2) / mu (Eq. 7)."""
    return (p.d + p.r + t / 2.0) / p.mu


def waste(t: float, p: Platform) -> float:
    """Total waste (Eq. 11/12): W_FF + W_fault - W_FF * W_fault."""
    wff = waste_ff(t, p.c)
    wf = waste_fault(t, p)
    return wff + wf - wff * wf


# ---------------------------------------------------------------------------
# First-order periods
# ---------------------------------------------------------------------------

def t_young(p: Platform) -> float:
    """Young's first-order period: sqrt(2 mu C) + C."""
    return math.sqrt(2.0 * p.mu * p.c) + p.c


def t_daly(p: Platform) -> float:
    """Daly's first-order period: sqrt(2 (mu + D + R) C) + C."""
    return math.sqrt(2.0 * (p.mu + p.d + p.r) * p.c) + p.c


def t_rfo(p: Platform) -> float:
    """Refined first-order period (Eq. 13): sqrt(2 (mu - (D + R)) C).

    Falls back to the lower bound C when mu <= D + R (the regime where the
    first-order model is invalid anyway; paper caps parameters at alpha*mu).
    """
    slack = p.mu - (p.d + p.r)
    if slack <= 0:
        return p.c
    return max(p.c, math.sqrt(2.0 * slack * p.c))


def clamp_period(t: float, p: Platform, alpha: float = ALPHA_CAP,
                 enforce_cap: bool = False) -> float:
    """Clamp a period into the admissible interval [C, alpha*mu] (paper §3).

    The paper notes that simulations may always use the raw Eq. (13) value;
    the cap is only needed for mathematical rigor, hence ``enforce_cap``.
    """
    lo = p.c
    hi = alpha * p.mu if enforce_cap else math.inf
    if hi < lo:  # degenerate: platform MTBF too small for the model
        return lo
    return min(max(t, lo), hi)


# ---------------------------------------------------------------------------
# Exact optimum for Exponential faults (Lambert W), paper §3 end
# ---------------------------------------------------------------------------

def lambert_w(z: float, branch: int = 0, tol: float = 1e-14,
              max_iter: int = 100) -> float:
    """Real Lambert W: solves w * exp(w) = z via Halley iteration.

    branch 0 (principal, w >= -1) for z >= -1/e; branch -1 (w <= -1) for
    -1/e <= z < 0.  No scipy dependency.
    """
    if z < -math.exp(-1.0) - 1e-12:
        raise ValueError(f"lambert_w undefined for z={z} < -1/e")
    z = max(z, -math.exp(-1.0))
    if branch == 0:
        # Initial guess: series near 0, log for large z.
        w = math.log1p(z) if z > -0.3 else -1.0 + math.sqrt(2.0 * (1.0 + math.e * z))
        if z > math.e:
            w = math.log(z) - math.log(math.log(z))
    elif branch == -1:
        if z >= 0:
            raise ValueError("branch -1 requires z in [-1/e, 0)")
        w = -1.0 - math.sqrt(2.0 * (1.0 + math.e * z))
        if z > -0.1:
            w = math.log(-z) - math.log(-math.log(-z))
    else:
        raise ValueError(f"unsupported branch {branch}")
    for _ in range(max_iter):
        ew = math.exp(w)
        f = w * ew - z
        # Halley step.
        denom = ew * (w + 1.0) - (w + 2.0) * f / (2.0 * w + 2.0) if w != -1.0 else ew
        step = f / denom
        w -= step
        if abs(step) <= tol * (1.0 + abs(w)):
            break
    return w


def t_exact_exponential(p: Platform) -> float:
    """Exact optimal period for Exponential faults.

    With TIME_final = (mu + D) e^{R/mu} (e^{T/mu} - 1) TIME_base/(T - C)
    [paper §3, citing Bougeret et al. SC'11], the optimum is
        T* = C + mu (1 + W(-e^{-(C/mu + 1)}))
    with W the principal Lambert branch.
    """
    w = lambert_w(-math.exp(-(p.c / p.mu + 1.0)), branch=0)
    return p.c + p.mu * (1.0 + w)


def expected_makespan_exponential(t: float, time_base: float, p: Platform) -> float:
    """Exact expected makespan under Exponential faults for period T."""
    if t <= p.c:
        raise ValueError(f"period T={t} must exceed C={p.c}")
    n_periods = time_base / (t - p.c)
    return (p.mu + p.d) * math.exp(p.r / p.mu) * (math.exp(t / p.mu) - 1.0) * n_periods


def expected_makespan_first_order(t: float, time_base: float, p: Platform) -> float:
    """First-order expected makespan: TIME_base / (1 - WASTE) (Eq. 10)."""
    w = waste(t, p)
    if w >= 1.0:
        return math.inf
    return time_base / (1.0 - w)
