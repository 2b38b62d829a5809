"""Quickstart on the PyTorch port: the paper's planner in five minutes.

The port's copy of ``examples/quickstart.py``:

1. Plan the optimal checkpoint period for a 512-chip pod, with and without
   a fault predictor (the paper's core contribution, §3-§4), by declaring
   the deployment as a serializable ScenarioSpec and looking the strategies
   up in the registry.
2. Measure the plan: one small ExperimentSpec through the batched runner,
   whose lanes run ``lane_loop_kernel`` on the card.
3. Train a reduced llama3.2-1b for 60 steps with that schedule, injecting
   faults from a synthetic Weibull trace, and compare the measured waste
   against the analytic prediction.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
          [--steps 60] [--traces 5]

Everything runs on CUDA unless ``--device cpu`` is given.
"""

import argparse
import tempfile

import numpy as np

from repro_torch.configs import get
from repro_torch.configs.base import InputShape, PlatformConfig
from repro_torch.core.exact import optimal_period_exact
from repro_torch.core.prediction import (beta_lim,
                                         optimal_period_with_prediction)
from repro_torch.core.traces import Weibull, make_event_trace
from repro_torch.core.waste import t_rfo, waste
from repro_torch.experiments import (DistributionSpec, ExperimentSpec,
                                     ScenarioSpec, StrategySpec,
                                     build_strategy, run_experiment)
from repro_torch.train import FaultTolerantTrainer


def scenario(n_traces: int = 5) -> ScenarioSpec:
    """The deployment: 512 chips, Weibull(0.7) faults, the Yu et al.
    predictor."""
    return ScenarioSpec(n=512,
                        dist=DistributionSpec("weibull", {"shape": 0.7}),
                        recall=0.85, precision=0.82,
                        c=600.0, d=60.0, r=600.0, n_traces=n_traces)


def experiment(sc: ScenarioSpec) -> ExperimentSpec:
    return ExperimentSpec(
        name="quickstart",
        scenario=sc,
        strategies=(StrategySpec("rfo"), StrategySpec("optimal_prediction"),
                    StrategySpec("best_period", {"base": "rfo",
                                                 "n_points": 8})),
        metrics=("makespan_days", "waste"),
    )


def plan(sc: ScenarioSpec) -> dict:
    """Section 1: the analytic plan; returns its numbers."""
    print("=" * 64)
    print("1. Checkpoint planning for a 512-chip deployment")
    print("=" * 64)
    plat = sc.platform
    print(f"platform MTBF mu = {plat.mu / 3600:.1f} h  (mu_ind / {sc.n})")
    periods = {}
    for name in ("young", "daly", "rfo"):
        strat = build_strategy(name, sc)
        periods[strat.name] = strat.period
        print(f"{strat.name:5s} period : {strat.period:8.0f} s")
    w_rfo = waste(t_rfo(plat), plat)
    print(f"RFO waste     : {w_rfo:.4f}")

    pp = sc.pp
    t_star, w_star, use = optimal_period_with_prediction(pp)
    print(f"With the predictor: T* = {t_star:8.0f} s, waste {w_star:.4f}, "
          f"trust predictions past beta_lim = {beta_lim(pp):.0f} s")
    print(f"-> predicted waste reduction: "
          f"{100 * (1 - w_star / w_rfo):.1f}%")

    # The first-order model drops O((T/mu)^2) terms; the exact-Exponential
    # renewal analysis (repro_torch.core.exact, sweepable via
    # ScenarioSpec.model_order="exact") re-plans both knobs.
    exact = optimal_period_exact(pp)
    print(f"Exact-Exponential plan: T* = {exact.period:8.0f} s, "
          f"beta* = {exact.threshold:.0f} s, exact waste {exact.waste:.4f} "
          f"(first-order T* was {t_star:.0f} s)")
    return {"mu": plat.mu, "periods": periods, "rfo_waste": w_rfo,
            "t_star": t_star, "w_star": w_star, "use_predictions": use,
            "beta_lim": beta_lim(pp), "exact": exact}


def measure(sc: ScenarioSpec, device=None):
    """Section 2: the plan through the batched runner; returns the table."""
    print()
    print("=" * 64)
    print("2. Simulated check (ExperimentSpec -> batched runner)")
    print("=" * 64)
    exp = experiment(sc)
    print(f"spec round-trips through JSON: "
          f"{ExperimentSpec.from_json(exp.to_json()) == exp}")
    table = run_experiment(exp, device=device)
    print(table.format(["strategy", "period", "makespan_days", "waste"]))
    return table


def train(steps: int = 60, device=None):
    """Section 3: the reduced llama3.2-1b under injected faults; returns
    the trainer's stats."""
    print()
    print("=" * 64)
    print("3. Fault-tolerant training (reduced llama3.2-1b, virtual clock)")
    print("=" * 64)
    cfg = get("llama3.2-1b").reduced()
    shape = InputShape("quickstart", 64, 4, "train")
    # Dense-fault platform so something actually happens in 60 steps.
    demo = PlatformConfig(mu_ind=300.0, c=30.0, cp=10.0, d=5.0, r=15.0,
                          recall=0.85, precision=0.82)
    trace = make_event_trace(Weibull(0.7, 1.0), 300.0, 0.85, 0.82,
                             horizon=1e5, rng=np.random.default_rng(1))
    with tempfile.TemporaryDirectory() as d:
        tr = FaultTolerantTrainer(cfg, shape, demo, workdir=d,
                                  step_time=10.0, trace=trace, seed=0,
                                  device=device)
        print(f"scheduler: T* = {tr.scheduler.period:.0f} s, "
              f"beta_lim = {tr.scheduler.decision.beta_lim:.1f} s, "
              f"analytic waste = "
              f"{tr.scheduler.decision.expected_waste:.3f}")
        stats = tr.run(steps)
    print(f"steps secured      : {stats.n_steps}")
    print(f"faults / rollbacks : {stats.n_faults} / {stats.n_rollbacks}")
    print(f"periodic ckpts     : {stats.n_periodic}")
    print(f"proactive ckpts    : {stats.n_proactive} "
          f"({stats.n_trusted_true} before real faults)")
    print(f"final loss         : {stats.final_loss:.3f}")
    print(f"measured waste     : {stats.waste:.3f}")
    return stats


def main(device=None, steps: int = 60, n_traces: int = 5) -> dict:
    sc = scenario(n_traces)
    analytic = plan(sc)
    table = measure(sc, device=device)
    stats = train(steps, device=device)
    return {"analytic": analytic, "experiment": experiment(sc),
            "table": table, "stats": stats}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the CPU)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--traces", type=int, default=5)
    args = ap.parse_args()
    main(device=args.device, steps=args.steps, n_traces=args.traces)
