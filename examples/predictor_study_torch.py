"""Predictor design study on the PyTorch port's generative predictors.

The port's copy of ``examples/predictor_study.py``.

Part 1 (analytic, paper §5.4): what should a fault-predictor team
optimize?  Iso-waste over the (recall, precision) plane says recall —
reproduced with the experiment API's SweepSpec.

Part 2 (generative, repro_torch.predictors): what happens when the
predictor is not the idealized stamp?  A ``drifting`` predictor degrades
from the "good" literature predictor (r=0.85, p=0.82) to a poor one
*during* the run; the static paper-optimal plan keeps trusting with the
stale beta_lim while the ``adaptive`` strategy tracks (r-hat, p-hat)
online and re-plans period + trust threshold as the estimates drift.  The
adaptive lanes run ``lane_loop_kernel``'s adaptive instantiation on the
card, the host re-planning between its launches.

Run:  PYTHONPATH=src python examples/predictor_study_torch.py
          [--device cpu] [--traces 5]

Part 2 runs on CUDA unless ``--device cpu`` is given.
"""

import argparse

from repro_torch.core.batch import simulate_batch
from repro_torch.core.prediction import optimal_period_with_prediction
from repro_torch.core.waste import t_rfo, waste
from repro_torch.experiments import (PredictorSpec, ScenarioSpec, SweepSpec,
                                     build_strategy, evaluate_strategies,
                                     trace_bank)

GRID = [0.1, 0.3, 0.5, 0.7, 0.9, 0.99]


def analytic_plane() -> dict:
    """Part 1; returns the plane ``{(r, p): (waste, used)}``, the RFO
    waste without a predictor and the two sensitivities."""
    base = ScenarioSpec(n=2 ** 16, c=600.0, d=60.0, r=600.0)
    plat = base.platform
    w_nopred = waste(t_rfo(plat), plat)
    print(f"platform: N=2^16, mu={plat.mu:.0f}s; "
          f"RFO waste without predictor = {w_nopred:.4f}\n")

    sweep = SweepSpec(axes={"recall": GRID, "precision": GRID})
    cells = {(c["recall"], c["precision"]): sc for c, sc in sweep.cells(base)}
    print("analytic waste of OptimalPrediction (rows: recall; "
          "cols: precision)")
    print("        " + "".join(f"p={p:<7.2f}" for p in GRID))
    plane = {}
    for r in GRID:
        row = []
        for p in GRID:
            _, w, used = optimal_period_with_prediction(cells[(r, p)].pp)
            plane[(r, p)] = (w, used)
            row.append(f"{w:.4f}{'*' if not used else ' '}  ")
        print(f"r={r:<5.2f} " + "".join(row))
    print("(* = predictor analytically not worth using)")

    # Sensitivity at the literature predictor point (paper §5.4).
    r0, p0, eps = 0.7, 0.7, 0.05

    def w_at(r, p):
        return optimal_period_with_prediction(
            base.replace(recall=r, precision=p).pp)[1]

    dr = (w_at(r0 + eps, p0) - w_at(r0 - eps, p0)) / (2 * eps)
    dp = (w_at(r0, p0 + eps) - w_at(r0, p0 - eps)) / (2 * eps)
    print(f"\nat (r={r0}, p={p0}): dWaste/dRecall = {dr:+.4f}, "
          f"dWaste/dPrecision = {dp:+.4f} -> invest in recall "
          f"({abs(dr / dp):.1f}x more valuable)\n")
    assert abs(dr) > abs(dp)
    return {"w_nopred": w_nopred, "plane": plane, "dr": dr, "dp": dp}


def adaptive_demo(device=None, n_traces: int = 5) -> dict:
    """Part 2; returns the three mean makespans and the adaptive lanes'
    BatchResult."""
    # The drift ramp is placed inside the job window: quality starts
    # degrading when the job starts and bottoms out two time_bases later.
    base = ScenarioSpec(n_traces=n_traces, time_base_years_total=40000.0)
    sc = base.replace(predictor=PredictorSpec("drifting", {
        "precision_end": 0.25, "recall_end": 0.5,
        "drift_start": base.start, "drift_span": 2.0 * base.time_base}))
    traces = trace_bank(sc)
    plat, tb, cp = sc.platform, sc.time_base, sc.cp

    static = build_strategy("optimal_prediction", sc)
    adaptive = build_strategy("adaptive", sc, tol=0.03)
    rfo = build_strategy("rfo", sc)
    print("drifting predictor: (r, p) = (0.85, 0.82) -> (0.50, 0.25) "
          "during the run")
    m_rfo, m_static, m_ad = evaluate_strategies(
        traces, plat, tb, cp, [rfo, static, adaptive], seed=sc.seed,
        device=device)
    print(f"  RFO (ignore predictor):      {m_rfo / 86400:8.2f} days")
    print(f"  OptimalPrediction (static):  {m_static / 86400:8.2f} days")
    print(f"  Adaptive (online re-plan):   {m_ad / 86400:8.2f} days")

    # Inside the adaptive runs: what did the estimator see and do?
    batch = simulate_batch(
        traces, plat, tb, [adaptive.period], cp=cp, trust=adaptive.trust,
        adaptive=adaptive.adaptive,
        trace_seeds=[sc.seed + 7919 * i for i in range(len(traces))],
        device=device)
    print("\nper-trace adaptive diagnostics (start plan: "
          f"T={adaptive.period:.0f}s, beta_lim={adaptive.trust.threshold:.0f}s):")
    for ti in range(len(traces)):
        res = batch.result(0, ti)
        print(f"  trace {ti}: {res.n_replans:2d} replans -> "
              f"T={res.final_period:8.0f}s "
              f"thr={res.final_threshold:7.1f}s  "
              f"r-hat={res.est_recall:.3f} p-hat={res.est_precision:.3f}")
    assert all(batch.n_replans[0] >= 1), "drift must trigger re-planning"
    # The estimator should have noticed the degradation (estimates are
    # run-averages, so they sit between the start and end quality).
    assert float(batch.est_precision[0].mean()) < 0.75
    print("\nthe adaptive strategy noticed the degradation (p-hat well "
          "below the nominal 0.82) and re-planned; the static plan kept "
          "trusting a predictor that no longer deserved it")
    return {"makespans": (m_rfo, m_static, m_ad), "batch": batch}


def main(device=None, n_traces: int = 5) -> dict:
    return {"analytic": analytic_plane(),
            "adaptive": adaptive_demo(device=device, n_traces=n_traces)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the CPU)")
    ap.add_argument("--traces", type=int, default=5)
    args = ap.parse_args()
    main(device=args.device, n_traces=args.traces)
