"""Frozen first-order policies of the benchmark (paper §3-4).

The study's candidates worked out again from a deployment's numbers:

* RFO: T = sqrt(2 (mu - (D + R)) C) (Eq. 13), never trusting predictions;
* OptimalPrediction: the better of the two branches of Eq. 15, WASTE1 at
  T_RFO clamped to [C, C_p/p] (no prediction acted on) and WASTE2 at the
  minimiser of its cubic (Eq. 17), trusting a prediction iff its offset in
  the period is at least beta_lim = C_p / p (Theorem 1);
* BestPeriod(RFO): the periods log-spaced in [T0/span, T0 span] around
  RFO's period T0 (clamped above C), T0 included, without repeats.

The same floating-point operations in the same order as the study's own
policies.  Plain NumPy; imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np


def t_rfo(mu: float, c: float, d: float, r: float) -> float:
    slack = mu - (d + r)
    if slack <= 0:
        return c
    return max(c, math.sqrt(2.0 * slack * c))


def beta_lim(cp: float, p: float) -> float:
    return cp / p


def _waste1(t: float, mu: float, c: float, d: float, r: float) -> float:
    return (c * (1.0 - (d + r) / mu)) / t + (d + r - c / 2.0) / mu \
        + t / (2.0 * mu)


def _coeffs(mu, c, d, r, cp, rec, p):
    dr = d + r
    u = rec * c * cp * cp / (2.0 * mu * p * p)
    v = c * (1.0 - (rec * cp / p + dr) / mu) - rec * cp * cp / (2.0 * mu * p * p)
    w = (-(1.0 - rec) * c / 2.0 + rec * cp / p + dr) / mu
    x = (1.0 - rec) / (2.0 * mu)
    return u, v, w, x


def _waste2(t: float, coeffs) -> float:
    u, v, w, x = coeffs
    return u / (t * t) + v / t + w + x * t


def _t_pred(mu, c, d, r, cp, rec, p) -> float:
    coeffs = _coeffs(mu, c, d, r, cp, rec, p)
    u, v, _, x = coeffs
    lo = max(c, beta_lim(cp, p))
    if x <= 0.0:
        raise ValueError("recall 1 is outside the benchmark's deployments")
    candidates = [lo]
    for root in np.roots([x, 0.0, -v, -2.0 * u]):
        if abs(root.imag) < 1e-9 * max(1.0, abs(root.real)) \
                and root.real > lo:
            candidates.append(float(root.real))
    return min(candidates, key=lambda t: _waste2(t, coeffs))


def optimal_prediction(mu, c, d, r, cp, rec, p) -> tuple[float, float | None]:
    """(period, trust threshold or None for never trusting)."""
    coeffs = _coeffs(mu, c, d, r, cp, rec, p)
    tp = _t_pred(mu, c, d, r, cp, rec, p)
    w2 = _waste2(tp, coeffs)
    if beta_lim(cp, p) < c:
        return tp, beta_lim(cp, p)
    tn = max(c, min(t_rfo(mu, c, d, r), beta_lim(cp, p)))
    if _waste1(tn, mu, c, d, r) <= w2:
        return tn, None
    return tp, beta_lim(cp, p)


def best_period_grid(t0: float, c: float, n_points: int,
                     span: float) -> np.ndarray:
    lo = max(c * 1.001, t0 / span)
    hi = max(lo * 1.01, t0 * span)
    return np.unique(np.append(np.geomspace(lo, hi, n_points), t0))


def candidates(plat: dict, strategies: list) -> tuple[list, list]:
    """The deduplicated (period, threshold) candidates of ``strategies``
    on platform ``plat`` (keys mu, c, d, r, cp, recall, precision) and,
    per strategy, the indices of its candidates, in the study's order."""
    mu, c, d, r, cp = (plat[k] for k in ("mu", "c", "d", "r", "cp"))
    rec, p = plat["recall"], plat["precision"]
    base = {"rfo": (t_rfo(mu, c, d, r), None),
            "optimal_prediction": optimal_prediction(mu, c, d, r, cp, rec,
                                                     p)}
    slot: dict = {}
    unique: list = []
    rows: list = []
    for item in strategies:
        if isinstance(item, str):
            expanded = [base[item]]
        else:
            t0, thr = base[item["base"]]
            expanded = [(float(t), thr) for t in best_period_grid(
                t0, c, item["n_points"], item["span"])]
        rows.append([])
        for cand in expanded:
            if cand not in slot:
                slot[cand] = len(unique)
                unique.append(cand)
            rows[-1].append(slot[cand])
    return unique, rows


def trace_mean(row) -> float:
    """The mean of a row in trace order, one addition at a time."""
    total = 0.0
    for x in row:
        total += float(x)
    return float(total / max(1, len(row)))


def best(makespans, rows) -> list[tuple[float, int]]:
    """Per strategy, (its least trace-order mean over its candidate rows,
    that candidate's index): the first minimum."""
    out = []
    for cand_rows in rows:
        means = [trace_mean(makespans[j]) for j in cand_rows]
        k = int(np.argmin(means))
        out.append((means[k], cand_rows[k]))
    return out
