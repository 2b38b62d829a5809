"""The ``study`` kind of cell: one planner's passes of the paper's study.

A pass is one call of the port's ``candidate_results`` over the cell's
candidates and one set of traces, on the card, then ``best_means``, ending
with the strategies' means on the host: ``chip_smoke.py`` phase 4's pass,
through the port's public names.

Set-up makes the run's pool of traces with the benchmark's frozen
generator (``reference/traces.py``) from the seed and hands it to the
port as arrays, builds the candidates with the port's policies, and runs
one warm pass on traces of its own.  Pass ``i`` takes ``traces_per_pass``
traces of the pool drawn without repeats from the seed and ``i``, so no
two passes of a run use the same set and every seed gives the same sizes.
Nothing is cached across passes: each packs its bank and runs its lanes.

Traffic parameters (``traffic`` in the cell's file):
``strategies`` (``"rfo"``, ``"optimal_prediction"`` or ``{"best_period":
base, "n_points": n, "span": s}``), ``traces_per_pass``, ``pool_traces``
and ``check_lanes`` (the lanes the check holds to the reference loop).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from portbench.reference import judge, roofline, traces as ref_traces


@dataclasses.dataclass
class Study:
    cfg: dict
    traffic: dict
    seed: int
    device: str
    pool: list            # the reference's traces: (times, kinds, horizon)
    port_pool: list       # the same traces as the port's EventTraces
    scenario: object
    candidates: list      # the port's Strategy objects
    rows: list
    strategies: list      # the traffic's strategies as the reference takes them
    setup_parts: dict = dataclasses.field(default_factory=dict)

    @property
    def lane_seed(self) -> int:
        return self.seed % 2 ** 31


def _reference_strategies(traffic: dict) -> list:
    out = []
    for item in traffic["strategies"]:
        if isinstance(item, str):
            out.append(item)
        else:
            out.append({"base": item["best_period"],
                        "n_points": int(item["n_points"]),
                        "span": float(item["span"])})
    return out


def _scenario(cfg: dict):
    from repro_torch.experiments import DistributionSpec, ScenarioSpec
    law = dict(cfg["fault_law"])
    dist = DistributionSpec(law.pop("name"), law)
    return ScenarioSpec(
        n=cfg["n"], dist=dist, recall=cfg["recall"],
        precision=cfg["precision"], cp_ratio=cfg["cp"] / cfg["c"],
        c=cfg["c"], r=cfg["r"], d=cfg["d"],
        mu_ind=cfg["mu_ind_years"] * 365.0 * 86400.0,
        time_base_years_total=cfg["work_years_total"],
        start=cfg["start_days"] * 86400.0)


def _port_candidates(sc, strategies: list):
    from repro_torch.core.policies import optimal_prediction, rfo
    from repro_torch.experiments import BestPeriodSearch, expand_candidates
    base = {"rfo": rfo(sc.platform), "optimal_prediction":
            optimal_prediction(sc.pp)}
    items = [base[s] if isinstance(s, str) else
             BestPeriodSearch(base[s["base"]], s["n_points"], s["span"])
             for s in strategies]
    return expand_candidates(items, sc.platform)


def setup(cfg: dict, traffic: dict, seed: int, device: str) -> Study:
    from repro_torch.core.traces import traces_from_numpy
    t0 = time.perf_counter()
    pool = ref_traces.make_pool(cfg, seed, int(traffic["pool_traces"]))
    port_pool = traces_from_numpy([t for t, _, _ in pool],
                                  [k for _, k, _ in pool],
                                  [h for _, _, h in pool])
    t1 = time.perf_counter()
    sc = _scenario(cfg)
    strategies = _reference_strategies(traffic)
    unique, rows = _port_candidates(sc, strategies)
    study = Study(cfg, traffic, seed, device, pool, port_pool, sc, unique,
                  rows, strategies)
    t2 = time.perf_counter()
    run_pass(study, request(study, None))
    study.setup_parts = {"pool_s": t1 - t0, "warm_pass_s":
                         time.perf_counter() - t2}
    return study


def request(study: Study, index: int | None) -> np.ndarray:
    """The pool indices of pass ``index`` (``None``: the warm pass)."""
    stream = [study.seed % 2 ** 64, 3] if index is None else \
        [study.seed % 2 ** 64, 2, index]
    rng = np.random.default_rng(stream)
    return np.sort(rng.choice(len(study.pool),
                              int(study.traffic["traces_per_pass"]),
                              replace=False))


def run_pass(study: Study, idx: np.ndarray) -> dict:
    """One pass over the traces ``idx``: the timed unit of work."""
    from torch.profiler import record_function

    from repro_torch.experiments import best_means, candidate_results
    sc = study.scenario
    traces = [study.port_pool[i] for i in idx]
    with record_function("study.candidate_results"):
        res = candidate_results(traces, sc.platform, sc.time_base, sc.cp,
                                study.candidates, seed=study.lane_seed,
                                device=study.device)
    with record_function("study.best_means"):
        means = best_means(res.makespan, study.rows)
    return {"traces": idx, "result": res, "means": means}


def units(study: Study, out: dict) -> int:
    """Lanes a pass ran."""
    return int(np.size(out["result"].makespan))


def candidates(study: Study) -> list:
    """The port's candidates as (period, threshold or None); a trust
    policy of another kind reads as NaN, which no threshold equals."""
    from repro_torch.core.simulator import NeverTrust, ThresholdTrust
    out = []
    for s in study.candidates:
        thr = (None if isinstance(s.trust, NeverTrust) else
               float(s.trust.threshold)
               if isinstance(s.trust, ThresholdTrust) else float("nan"))
        out.append((float(s.period), thr))
    return out


def check(study: Study, outs: list) -> tuple[dict, dict]:
    """The judge's checks and info over the window's passes."""
    shape = (len(study.candidates), int(study.traffic["traces_per_pass"]))
    picks = judge.sample(outs, shape, study.seed,
                         int(study.traffic["check_lanes"]))
    checks, info = judge.judge(study.cfg, study.strategies, study.pool,
                               candidates(study), outs, picks)
    info.update(study.setup_parts)
    return checks, info


def least_seconds(study: Study, out: dict) -> float:
    """The frozen roofline's least time of one pass on the card."""
    res = out["result"]
    counts = {k: int(np.sum(getattr(res, k)))
              for k in roofline.OPS_PER_EVENT}
    bank = sum(study.pool[i][0].size for i in out["traces"])
    return roofline.least_seconds(roofline.pass_ops(counts),
                                  roofline.pass_bytes(bank, units(study, out)))
