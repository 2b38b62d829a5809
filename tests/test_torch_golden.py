"""The port replays the golden parity net (tests/golden/parity_v1.json).

Each pinned cell's scenario and strategy are built by the JAX package
(exactly as its own jax golden check does), its traces are carried across
with ``traces_from_numpy``, and the port's lane engine runs them on the
CPU.  The makespans must equal the pinned values with ``==`` (tolerance:
none, the engines' bit-for-bit contract), and the planned period must be
the pinned one.  The adaptive cell waits for the slice that ports
adaptive lanes.
"""

import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.core import simulator as ref_sim  # noqa: E402
from repro.experiments import ScenarioSpec, StrategySpec  # noqa: E402

from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.core.batch import simulate_lanes  # noqa: E402
from repro_torch.core.traces import traces_from_numpy  # noqa: E402
from repro_torch.core.waste import Platform  # noqa: E402

GOLDEN = json.loads((Path(__file__).parent / "golden" / "parity_v1.json")
                    .read_text())["cells"]
ADAPTIVE = {"adaptive_stale_prior"}


def _port_trust(t):
    if isinstance(t, ref_sim.NeverTrust):
        return sim.NeverTrust()
    if isinstance(t, ref_sim.AlwaysTrust):
        return sim.AlwaysTrust()
    if isinstance(t, ref_sim.ThresholdTrust):
        return sim.ThresholdTrust(t.threshold)
    return sim.FixedProbabilityTrust(t.q)


def test_golden_net_has_nine_cells():
    assert len(GOLDEN) == 9 and ADAPTIVE <= set(GOLDEN)


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_cell(name):
    if name in ADAPTIVE:
        pytest.skip("adaptive lanes: a later slice")
    want = GOLDEN[name]
    scenario = ScenarioSpec.from_dict(want["scenario"])
    strat = StrategySpec.from_dict(want["strategy"]).build(scenario)
    assert float(strat.period) == want["period"]
    ref_traces = scenario.make_traces()
    traces = traces_from_numpy([t.times for t in ref_traces],
                               [t.kinds for t in ref_traces],
                               [t.horizon for t in ref_traces],
                               [t.windows for t in ref_traces])
    p = scenario.platform
    n = len(traces)
    ms = simulate_lanes(
        traces, Platform(mu=p.mu, c=p.c, d=p.d, r=p.r), scenario.time_base,
        cp=scenario.cp, trace_indices=list(range(n)),
        periods=[float(strat.period)] * n,
        trusts=[_port_trust(strat.trust)] * n,
        windows=[strat.inexact_window] * n,
        window_modes=[strat.window_mode] * n,
        window_periods=[strat.window_period] * n,
        n_verifies=[strat.n_verify] * n,
        verify_costs=[strat.verify_cost] * n,
        keep_ckpts=[strat.keep_ckpts] * n,
        seeds=[scenario.seed + 7919 * i for i in range(n)], device="cpu")
    assert [float(m) for m in ms] == want["makespans"], name
