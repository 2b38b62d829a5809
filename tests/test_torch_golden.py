"""The port replays the golden parity net (tests/golden/parity_v1.json).

Each pinned cell's scenario and its traces are built by the port's own
``ScenarioSpec`` (bitwise the reference's banks, predictor models and the
exact model included), and its strategy by the port's ``StrategySpec`` /
``build_strategy``, for all 9 cells.  The port's lane engine runs the
cell on the CPU.  The makespans must equal the pinned values with ``==``
(tolerance: none, the engines' bit-for-bit contract), and the planned
period must be the pinned one.
"""

import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.batch import simulate_lanes  # noqa: E402
from repro_torch.experiments import ScenarioSpec, StrategySpec  # noqa: E402

GOLDEN = json.loads((Path(__file__).parent / "golden" / "parity_v1.json")
                    .read_text())["cells"]


def golden_strategy(name):
    """(the port's scenario, the cell's strategy)."""
    want = GOLDEN[name]
    scenario = ScenarioSpec.from_dict(want["scenario"])
    return scenario, StrategySpec.from_dict(want["strategy"]).build(scenario)


def golden_makespans(name, device):
    """The cell's makespans from the port's lane engine on ``device``."""
    scenario, strat = golden_strategy(name)
    traces = scenario.make_traces()
    n = len(traces)
    return simulate_lanes(
        traces, scenario.platform, scenario.time_base,
        cp=scenario.cp, trace_indices=list(range(n)),
        periods=[float(strat.period)] * n,
        trusts=[strat.trust] * n,
        windows=[strat.inexact_window] * n,
        window_modes=[strat.window_mode] * n,
        window_periods=[strat.window_period] * n,
        adaptives=[strat.adaptive] * n,
        n_verifies=[strat.n_verify] * n,
        verify_costs=[strat.verify_cost] * n,
        keep_ckpts=[strat.keep_ckpts] * n,
        seeds=[scenario.seed + 7919 * i for i in range(n)], device=device)


def test_golden_net_has_nine_cells():
    assert len(GOLDEN) == 9 and "adaptive_stale_prior" in GOLDEN


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_cell(name):
    want = GOLDEN[name]
    _, strat = golden_strategy(name)
    assert float(strat.period) == want["period"]
    ms = golden_makespans(name, "cpu")
    assert [float(m) for m in ms] == want["makespans"], name
