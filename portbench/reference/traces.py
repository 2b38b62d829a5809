"""Frozen trace generator of the benchmark (paper §5.1).

A plain NumPy copy of the study's per-trace generator: faults are the
superposition of N per-processor renewal streams (Exponential or Weibull,
each scaled to the individual MTBF), every fault is predicted with
probability r, and false predictions come from one platform-level
renewal stream of the same family with mean p mu / (r (1 - p)).  The job
starts ``start`` seconds into the trace, so the events before it are
dropped and the rest shifted.  Exact-date predictions only: no windows,
no silent corruptions.

The draws are those of ``make_event_trace`` in the same order, so a trace
made here from a generator state is the one the study's own generator
makes from it.  This file is the benchmark's yardstick: it imports
nothing of the program and is not edited by later changes.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

FAULT_UNPRED = 0
FAULT_PRED = 1
FALSE_PRED = 2
SECONDS_PER_DAY = 86400.0


def sample(law: dict, mean: float, rng: np.random.Generator,
           size: int) -> np.ndarray:
    """``size`` inter-arrival times of ``law`` scaled to ``mean``."""
    if law["name"] == "exponential":
        return rng.exponential(mean, size)
    if law["name"] == "weibull":
        k = float(law["shape"])
        return mean / math.gamma(1.0 + 1.0 / k) * rng.weibull(k, size)
    raise ValueError(f"unknown fault law {law['name']!r}")


def renewal(law: dict, mean: float, horizon: float,
            rng: np.random.Generator) -> np.ndarray:
    """Arrival times of one renewal stream on [0, horizon)."""
    if horizon <= 0:
        return np.empty(0, dtype=np.float64)
    est = max(16, int(horizon / max(mean, 1e-12) * 1.5) + 8)
    chunks = []
    total = 0.0
    while total < horizon:
        draws = np.maximum(sample(law, mean, rng, est), 1e-9)
        chunks.append(draws)
        total += float(draws.sum())
        est = max(16, est // 2)
    times = np.cumsum(np.concatenate(chunks))
    return times[times < horizon]


def superposed(law: dict, mean_ind: float, n: int, horizon: float,
               rng: np.random.Generator) -> np.ndarray:
    """The sorted union of ``n`` per-processor renewal streams."""
    t = np.zeros(n, dtype=np.float64)
    out = []
    active = np.arange(n)
    while active.size:
        draws = np.maximum(sample(law, mean_ind, rng, active.size), 1e-9)
        t[active] = t[active] + draws
        hit = t[active] < horizon
        out.append(t[active][hit])
        active = active[hit]
    if not out:
        return np.empty(0, dtype=np.float64)
    return np.sort(np.concatenate(out))


def platform_mu(cfg: dict) -> float:
    """The platform MTBF mu = mu_ind / N."""
    return cfg["mu_ind_years"] * 365.0 * SECONDS_PER_DAY / cfg["n"]


def time_base(cfg: dict) -> float:
    """The job's useful work: the paper's total processor-years over N."""
    return cfg["work_years_total"] * 365.0 * SECONDS_PER_DAY / cfg["n"]


def start(cfg: dict) -> float:
    return cfg["start_days"] * SECONDS_PER_DAY


def horizon(cfg: dict) -> float:
    """The trace's end: the start plus 60 jobs or 50 MTBFs, the longer."""
    return start(cfg) + max(60.0 * time_base(cfg), 50.0 * platform_mu(cfg))


def make_trace(cfg: dict, rng: np.random.Generator
               ) -> tuple[np.ndarray, np.ndarray, float]:
    """One trace of deployment ``cfg``: (event times, kinds, horizon),
    shifted so that the job starts at 0."""
    mu, n, hz = platform_mu(cfg), cfg["n"], horizon(cfg)
    law = cfg["fault_law"]
    r, p = cfg["recall"], cfg["precision"]
    faults = superposed(law, mu * n, n, hz, rng)
    predicted = rng.random(faults.size) < r
    kinds = np.where(predicted, FAULT_PRED, FAULT_UNPRED).astype(np.int8)
    if r > 0.0 and p < 1.0:
        false = renewal(law, p * mu / (r * (1.0 - p)), hz, rng)
    else:
        false = np.empty(0, dtype=np.float64)
    times = np.concatenate([faults, false, np.empty(0, dtype=np.float64)])
    all_kinds = np.concatenate([kinds,
                                np.full(false.size, FALSE_PRED, np.int8),
                                np.empty(0, dtype=np.int8)])
    order = np.argsort(times, kind="stable")
    times, all_kinds = times[order], all_kinds[order]
    s = start(cfg)
    sel = times >= s
    return times[sel] - s, all_kinds[sel], hz - s


def trace_rng(seed: int, index: int) -> np.random.Generator:
    """The generator of trace ``index`` of the pool of run seed ``seed``."""
    return np.random.default_rng([seed % 2 ** 64, 1, index])


def make_pool(cfg: dict, seed: int, size: int) -> list:
    """The run's pool of ``size`` traces, each from its own generator.

    The traces are made on up to eight threads (NumPy's draws and array
    operations release the interpreter's lock); each trace's draws are
    its own generator's, so the pool does not depend on the threads."""
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(lambda i: make_trace(cfg, trace_rng(seed, i)),
                           range(size)))
