"""First-order waste model and optimal checkpoint periods (paper §3).

Implements:
  * Young's period       T = sqrt(2 mu C) + C                    [Young 1974]
  * Daly's period        T = sqrt(2 (mu + D + R) C) + C          [Daly 2004]
  * RFO period           T = sqrt(2 (mu - (D + R)) C)            [paper Eq. 13]
  * the waste model      WASTE = C/T + (1 - C/T) (D + R + T/2)/mu  [Eq. 12]

All durations share one unit (seconds by convention).  ``mu`` is the platform
MTBF; for a platform of N components with individual MTBF mu_ind,
``mu = mu_ind / N`` (paper Prop. 2, proved in Appendix A).

The port's own copy of ``repro/core/waste.py:45-145``: the same
floating-point operations in the same order, so periods planned here are
bitwise the JAX package's.  The Lambert-W exact optimum waits for a later
slice.
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
