"""A checkout with one tiny study cell beside the real ones, for tests
that drive the harness on the CPU.

The tiny deployment keeps the paper's C, R, D, C_p and predictor and cuts
N, the individual MTBF and the job so that a lane runs a few hundred
iterations; its BestPeriod grid has 4 points over a span of 2.
"""

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_CFG = {"name": "tiny", "source": "a test deployment", "n": 4096,
            "mu_ind_years": 2.0, "fault_law": {"name": "weibull",
                                                "shape": 0.7},
            "c": 600.0, "r": 600.0, "d": 60.0, "cp": 600.0,
            "recall": 0.85, "precision": 0.82, "work_years_total": 20.0,
            "start_days": 365.0, "assumed": [], "reduced": []}
TINY_TRAFFIC = {"name": "study-tiny",
                "strategies": ["rfo", "optimal_prediction",
                               {"best_period": "rfo", "n_points": 4,
                                "span": 2.0}],
                "traces_per_pass": 3, "pool_traces": 5, "check_lanes": 8}


def tiny_checkout(dest: Path, cell: str = "tiny-study") -> Path:
    """A copy of the benchmark under ``dest`` with the tiny cell added by
    two new files, a new configuration and cell in BENCHMARK.json, and the
    cell's name in ``lanes_per_s.short``'s cells."""
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pb = dest / "portbench"
    (pb / "configs" / "tiny.json").write_text(json.dumps(TINY_CFG))
    (pb / "workloads" / f"{cell}.json").write_text(json.dumps(
        {"config": "tiny", "kind": "study", "chips": 1, "why": "tests",
         "traffic": TINY_TRAFFIC}))
    bench["configs"].append({"name": "tiny", "source": "tests",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": cell, "config": "tiny",
                               "traffic": "study-tiny", "chips": 1,
                               "why": "tests"})
    for m in bench["end_to_end"]:
        if m["name"] == "lanes_per_s.short":
            m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest
