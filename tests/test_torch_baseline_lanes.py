"""window_sweep and exact_vs_first_order of ``suites/quick.yaml`` through
the port's lanes on the CPU, held to the rows of
``suites/baselines/quick.json``.

The companion of ``tests/test_torch_baseline_rows.py`` (which holds all
five items through the scalar oracle, and the others through the lanes);
a file of its own so that the two spread over workers.  The one row of
exact_vs_first_order that the JAX package no longer gives is held to the
JAX package there and left out here.  Tolerance: none.
"""

import json

import pytest

pytest.importorskip("torch")

from test_torch_baseline_rows import RECORDS, _is_drift  # noqa: E402

from repro_torch.experiments import ExperimentSpec, run_experiment  # noqa: E402


def _canon(rows) -> list[str]:
    return sorted(json.dumps(r, sort_keys=True) for r in rows
                  if not _is_drift(r))


@pytest.mark.parametrize("name", ["window_sweep", "exact_vs_first_order"])
def test_record_rows_through_the_lanes(name):
    rec = RECORDS[name]
    table = run_experiment(ExperimentSpec.from_dict(rec["identity"]["spec"]),
                           device="cpu")
    assert len(table.rows) == len(rec["rows"])
    got, want = _canon(table.rows), _canon(rec["rows"])
    assert len(got) == len(want) >= len(rec["rows"]) - 1
    assert got == want, name
