"""The comparison that decides whether a study run is correct.

It holds what the window's passes produced against the plain reference
at the cell's own size, layer by layer:

* ``cands_off``: the candidates' periods and trust thresholds that differ
  from the reference's, worked out again from the deployment (and one
  for each candidate too many or too few);
* ``lanes_off``: the sampled lanes of which some field differs from the
  reference loop's run of the same candidate on the same trace (every
  field of the lane's results: makespan, counts and times).  The sample
  is drawn from the run's seed over every pass of the window, and holds
  the lane with the most events of the run;
* ``ms_gap``: the widest relative gap of a sampled lane's makespan;
* ``means_off``: over every pass, the strategies whose mean makespan
  differs from the reference's trace-order mean of that pass's makespans
  at the reference's best candidate (which also holds the period
  BestPeriod picks), and each strategy of a pass whose grid of results is
  not candidates x traces.

The study's contract is bitwise, so every limit is 0.  The program's
outputs are only read here; nothing of the program is imported.
"""

from __future__ import annotations

import math

import numpy as np

from . import policies, simulate
from .traces import platform_mu, time_base

LIMITS = {"cands_off": 0, "lanes_off": 0, "ms_gap": 0.0, "means_off": 0}
_INT_FIELDS = {f for f in simulate.FIELDS if f.startswith("n_")}


def same(field: str, a, b) -> bool:
    """Bitwise equality of one result field (floats by their float64 bits,
    so -0.0 and NaN are told apart)."""
    if a is None or b is None:
        return False
    if field in _INT_FIELDS:
        return int(a) == int(b)
    return np.float64(a).tobytes() == np.float64(b).tobytes()


def platform(cfg: dict) -> dict:
    """The deployment's platform numbers as the policies take them."""
    return {"mu": platform_mu(cfg), "c": cfg["c"], "d": cfg["d"],
            "r": cfg["r"], "cp": cfg["cp"], "recall": cfg["recall"],
            "precision": cfg["precision"]}


def sample(passes: list, shape: tuple, seed: int, k: int) -> list:
    """The (pass, candidate, trace) lanes to check: ``k`` drawn from the
    seed over all passes, then the lane with the most events (periodic
    checkpoints, predictions and faults, as the passes report them)."""
    rng = np.random.default_rng([seed % 2 ** 64, 4])
    n_c, n_t = shape
    picks = []
    for _ in range(k):
        lane = (int(rng.integers(len(passes))), int(rng.integers(n_c)),
                int(rng.integers(n_t)))
        if lane not in picks:
            picks.append(lane)
    best, longest = -1, None
    for p, out in enumerate(passes):
        res = out["result"]
        try:
            events = (np.asarray(res.n_periodic_ckpts, dtype=np.int64)
                      + res.n_predictions + res.n_faults)
        except (AttributeError, TypeError, ValueError):
            continue
        if events.shape != shape:
            continue
        j = int(np.argmax(events))
        if events.flat[j] > best:
            best, longest = int(events.flat[j]), (p, *np.unravel_index(
                j, shape))
    if longest is not None:
        longest = tuple(int(x) for x in longest)
        if longest not in picks:
            picks.append(longest)
    return picks


def reference_lane(cfg: dict, trace, cand: tuple, F=float) -> dict:
    """The reference loop's fields of one lane."""
    times, kinds, _ = trace
    return simulate.simulate(times.tolist(), kinds.tolist(), c=cfg["c"],
                             d=cfg["d"], r=cfg["r"], cp=cfg["cp"],
                             time_base=time_base(cfg), period=cand[0],
                             threshold=cand[1], F=F)


def judge(cfg: dict, strategies: list, pool: list, cands: list,
          passes: list, picks: list) -> tuple[dict, dict]:
    """``(checks, info)``: each number compared as ``{name: (value,
    limit)}``, and what was compared.

    ``cands`` are the program's candidates as (period, threshold or None);
    each pass is ``{"traces": pool indices, "result": its BatchResult,
    "means": its per-strategy means}``; ``picks`` the lanes to check
    (:func:`sample`)."""
    ref_cands, ref_rows = policies.candidates(platform(cfg), strategies)
    cands_off = abs(len(cands) - len(ref_cands))
    for got, want in zip(cands, ref_cands):
        if not (same("period", got[0], want[0])
                and (got[1] is None) == (want[1] is None)
                and (want[1] is None or same("thr", got[1], want[1]))):
            cands_off += 1

    n_traces = len(passes[0]["traces"]) if passes else 0
    shape = (len(ref_cands), n_traces)
    means_off, passes_off = 0, set()
    for p, out in enumerate(passes):
        ms = getattr(out["result"], "makespan", None)
        means = list(out["means"])
        if (ms is None or np.shape(ms) != shape
                or len(means) != len(ref_rows)):
            means_off += len(ref_rows)
            passes_off.add(p)
            continue
        for got, (want, _) in zip(means, policies.best(ms, ref_rows)):
            if not same("mean", got, want):
                means_off += 1
                passes_off.add(p)

    lanes_off, ms_gap = 0, 0.0
    for p, c, t in picks:
        ref = reference_lane(cfg, pool[passes[p]["traces"][t]],
                             ref_cands[c])
        res = passes[p]["result"]
        off = False
        for field in simulate.FIELDS:
            try:
                got = getattr(res, field)[c, t]
            except (AttributeError, IndexError, TypeError):
                got = None
            off |= not same(field, got, ref[field])
            if field == "makespan":
                gap = (math.inf if got is None or not math.isfinite(got)
                       else abs(float(got) - ref[field]) / abs(ref[field]))
                ms_gap = max(ms_gap, gap)
        lanes_off += off
        if off:
            passes_off.add(p)
    checks = {"cands_off": (cands_off, LIMITS["cands_off"]),
              "lanes_off": (lanes_off, LIMITS["lanes_off"]),
              "ms_gap": (ms_gap, LIMITS["ms_gap"]),
              "means_off": (means_off, LIMITS["means_off"])}
    info = {"passes": len(passes), "lanes_checked": len(picks),
            "strategies": len(ref_rows), "candidates": len(ref_cands),
            "passes_off": sorted(passes_off)}
    return checks, info


def correct(checks: dict) -> bool:
    return all(v <= lim for v, lim in checks.values())
