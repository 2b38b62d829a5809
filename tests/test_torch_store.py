"""The port's result store and scenario suites (``repro_torch.store``).

* The JAX package's store tests (``tests/test_store.py``) and its CLI
  metrics view (``tests/test_obs.py::test_cli_metrics_view``), mirrored at
  their sizes with ``device="cpu"``.
* Against the reference, for every record of
  ``suites/baselines/quick.json``: the port's ``RunRecord.id_for`` gives
  the record's key, the port's ``canonical_json`` the reference's bytes,
  and ``diff_records`` of the record against itself is empty.
* ``suites/quick_torch.json`` holds the five experiment items of
  ``suites/quick.yaml`` with their claims, each as the inline spec the
  reference's builder makes; ``table2`` and ``silent_sweep`` run through
  the port's ``run_suite`` on the CPU (the scalar oracle) to records whose
  rows and payload ``==`` the baseline's and whose identity differs only
  in ``engine_fingerprint``.
* Benchmark items and unknown experiments are item errors, never stored;
  ``register`` never imports a module outside the port.

Tolerance: none (records are compared exactly).
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.experiments import (DistributionSpec, ResultTable,  # noqa: E402
                                     ScenarioSpec, run_suite)
from repro_torch.experiments.runner import (EvalCache,  # noqa: E402
                                            _cell_persist_key,
                                            _engine_fingerprint)
from repro_torch.store import (STORE_SCHEMA_VERSION, ClaimSpec,  # noqa: E402
                               ResultStore, RunRecord, SuiteItem, SuiteSpec,
                               canonical_json, content_hash, diff_records,
                               gc_cache)
from repro_torch.store.cli import main as cli_main  # noqa: E402
from repro_torch.store.suite import lookup_path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BASELINE = ROOT / "suites" / "baselines" / "quick.json"
QUICK_TORCH = ROOT / "suites" / "quick_torch.json"

# The deliberately small cell of test_experiments: a handful of events per
# trace, so suite-runner tests execute in well under a second per run.
SMALL = ScenarioSpec(n=32, dist=DistributionSpec("weibull", {"shape": 0.7}),
                     mu_ind=32 * 1e5, c=600.0, d=60.0, r=600.0,
                     time_base_years_total=0.1, start=0.0, n_traces=3,
                     seed=3)

TINY_SUITE = {
    "suite": "tiny",
    "register": [],
    "items": [{
        "spec": {"name": "tiny", "scenario": SMALL.to_dict(),
                 "strategies": [{"name": "rfo"},
                                {"name": "optimal_prediction"}]},
        "claims": [
            {"kind": "bound", "metric": "waste", "min": 0.0, "max": 1.0,
             "where": {"strategy": "RFO"}},
            {"kind": "compare", "metric": "makespan", "op": "<=",
             "rel_factor": 2.0,
             "lhs": {"strategy": "OptimalPrediction"},
             "rhs": {"strategy": "RFO"}},
        ],
    }],
}


def _baseline() -> dict:
    with open(BASELINE) as fh:
        return json.load(fh)


# ---------------------------------------------------------------------------
# Records: round-trip, ids, canonical serialization
# ---------------------------------------------------------------------------

def test_record_round_trip():
    rec = RunRecord.create(
        "experiment", "demo", {"spec": {"n": 2 ** 16}, "seed": 0},
        rows=[{"strategy": "RFO", "waste": np.float64(0.25)}],
        timings={"wall_s": 1.25})
    back = RunRecord.from_dict(json.loads(rec.to_json()))
    assert back == rec
    assert back.record_id == rec.record_id
    # numpy scalars became plain floats on the way in
    assert isinstance(rec.rows[0]["waste"], float)


def test_record_id_covers_inputs_not_outputs():
    a = RunRecord.create("experiment", "demo", {"seed": 0},
                         rows=[{"waste": 0.1}])
    b = RunRecord.create("experiment", "demo", {"seed": 0},
                         rows=[{"waste": 0.9}], timings={"wall_s": 99.0})
    c = RunRecord.create("experiment", "demo", {"seed": 1},
                         rows=[{"waste": 0.1}])
    assert a.record_id == b.record_id       # outputs don't affect identity
    assert a.record_id != c.record_id       # inputs do


def test_content_hash_stable_across_processes():
    """The id must not depend on PYTHONHASHSEED / dict insertion order."""
    payload = {"b": 2, "a": [1.5, {"z": True, "y": None}], "n": 2 ** 40}
    here = content_hash(payload)
    code = ("import sys, json; sys.path.insert(0, 'src'); "
            "from repro_torch.store import content_hash; "
            "print(content_hash(json.loads(sys.argv[1])))")
    for seed in ("0", "4242"):
        out = subprocess.run(
            [sys.executable, "-c", code, json.dumps(payload)],
            capture_output=True, text=True, check=True, cwd=ROOT,
            env=dict(os.environ, PYTHONHASHSEED=seed))
        assert out.stdout.strip() == here


def test_canonical_json_is_deterministic():
    a = canonical_json({"b": np.float64(0.1), "a": (1, 2)})
    b = canonical_json({"a": [1, 2], "b": 0.1})
    assert a == b
    assert json.loads(a) == {"a": [1, 2], "b": 0.1}


def test_schema_mismatch_invalidated_never_misread(tmp_path):
    store = ResultStore(tmp_path)
    rec = RunRecord.create("experiment", "demo", {"seed": 0})
    rid = store.put(rec)
    # Rewrite the record as if a future schema produced it.
    d = json.loads(store.record_path(rid).read_text())
    d["schema"] = STORE_SCHEMA_VERSION + 1
    store.record_path(rid).write_text(json.dumps(d))
    assert store.get(rid) is None
    assert store.invalidated == 1
    with pytest.raises(ValueError, match="never misread"):
        RunRecord.from_dict(d)
    # Corrupt JSON degrades the same way.
    store.record_path(rid).write_text("{not json")
    assert store.get(rid) is None


# ---------------------------------------------------------------------------
# Store CRUD / query / baselines / gc
# ---------------------------------------------------------------------------

def _rec(name, seed, created):
    rec = RunRecord.create("experiment", name, {"seed": seed})
    return dataclasses.replace(rec, created=created)


def test_store_find_latest(tmp_path):
    store = ResultStore(tmp_path)
    for i in range(3):
        store.put(_rec("a", i, created=100.0 + i))
    store.put(_rec("b", 0, created=50.0))
    assert len(list(store)) == 4
    assert [r.identity["seed"] for r in store.find(name="a")] == [2, 1, 0]
    assert store.latest("a").identity["seed"] == 2
    assert store.find(kind="benchmark") == []
    assert store.find(since=100.5)[0].identity["seed"] in (1, 2)


def test_store_gc_keep_and_size_cap(tmp_path):
    store = ResultStore(tmp_path)
    for i in range(6):
        store.put(_rec("a", i, created=float(i)))
    dry = store.gc(keep_per_name=2, dry_run=True)
    assert len(dry) == 4 and len(list(store)) == 6      # dry run deletes nothing
    gone = store.gc(keep_per_name=2)
    assert len(gone) == 4
    kept = store.find(name="a")
    assert [r.identity["seed"] for r in kept] == [5, 4]
    # Size cap: evict LRU (oldest created) past the budget.
    victims = store.gc(keep_per_name=10, max_bytes=0)
    assert len(victims) == 2 and "size cap" in victims[0][1]
    assert list(store) == []


def test_baseline_bundle_round_trip(tmp_path):
    store = ResultStore(tmp_path)
    member = RunRecord.create("experiment", "m", {"seed": 0},
                              rows=[{"waste": 0.1}])
    store.put(member)
    suite_rec = RunRecord.create(
        "suite", "s", {"member_ids": [member.record_id]},
        payload={"items": [{"record_id": member.record_id}]})
    bundle = ResultStore.bundle(suite_rec, [member])
    path = store.set_baseline("s", bundle)
    assert store.get_baseline("s") == json.loads(canonical_json(bundle))
    loaded = ResultStore.load_bundle(path)
    assert member.record_id in loaded["records"]
    bad = dict(bundle, schema=STORE_SCHEMA_VERSION + 1)
    (tmp_path / "bad.json").write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="never misread"):
        ResultStore.load_bundle(tmp_path / "bad.json")


# ---------------------------------------------------------------------------
# Deterministic diff
# ---------------------------------------------------------------------------

def test_diff_ignores_provenance_and_timing():
    a = RunRecord.create("benchmark", "b", {"q": True},
                         payload={"speedup": 10.0, "batch_s": 1.0,
                                  "scalar_s_measured": 2.0,
                                  "cell": {"value": 3.0}},
                         timings={"wall_s": 5.0})
    b = dataclasses.replace(
        a, payload={"speedup": 99.0, "batch_s": 9.0,
                    "scalar_s_measured": 7.0, "cell": {"value": 3.0}},
        timings={"wall_s": 50.0}, created=a.created + 100, git_rev="other")
    assert diff_records(a, b) == []
    # With a timing band, a 9.9x change trips it...
    banded = diff_records(a, b, timing_rel_tol=0.5)
    assert {d.path for d in banded} == {"payload.speedup", "payload.batch_s",
                                        "payload.scalar_s_measured"}
    assert all(d.kind == "timing" for d in banded)
    # ...but result cells stay exact regardless.
    c = dataclasses.replace(a, payload=dict(a.payload, cell={"value": 3.1}))
    assert [d.path for d in diff_records(a, c)] == ["payload.cell.value"]


def test_diff_values_lists_and_nan():
    a = RunRecord.create("experiment", "e", {"s": 0},
                         rows=[{"w": math.nan}, {"w": 1.0}])
    b = RunRecord.create("experiment", "e", {"s": 0},
                         rows=[{"w": math.nan}, {"w": 2.0}])
    diffs = diff_records(a, b)
    assert [d.path for d in diffs] == ["rows[1].w"]      # NaN == NaN
    short = RunRecord.create("experiment", "e", {"s": 0}, rows=[{"w": 1.0}])
    assert any(d.path == "rows.length" for d in diff_records(a, short))
    # bool vs int is a type change, not an equality
    x = RunRecord.create("experiment", "e", {"s": 0}, payload={"v": True})
    y = RunRecord.create("experiment", "e", {"s": 0}, payload={"v": 1})
    assert len(diff_records(x, y)) == 1


# ---------------------------------------------------------------------------
# Suites: parsing + claim evaluation
# ---------------------------------------------------------------------------

def test_suite_yaml_parse(tmp_path):
    pytest.importorskip("yaml")
    text = """\
suite: demo
register: []
defaults: {n_traces: 2}
items:
  - experiment: foo
    claims:
      - {kind: pinned, metric: period, value: 1.0, tol: 0.1, where: {n: 4}}
  - experiment: baz
    n_traces: 5
"""
    path = tmp_path / "demo.yaml"
    path.write_text(text)
    suite = SuiteSpec.from_file(path)
    assert suite.name == "demo"
    assert suite.items[0].n_traces == 2          # defaults merged
    assert suite.items[0].claims[0].kind == "pinned"
    assert suite.items[1].n_traces == 5          # item wins over defaults

    bench = SuiteSpec.from_dict({"suite": "b", "items": [
        {"benchmark": "bar",
         "claims": [{"kind": "bound", "path": "a.b", "min": 0}]}]})
    assert bench.items[0].kind == "benchmark"
    assert bench.items[0].claims[0].path == "a.b"


def test_suite_item_validation():
    with pytest.raises(ValueError, match="exactly one"):
        SuiteItem()
    with pytest.raises(ValueError, match="exactly one"):
        SuiteItem(experiment="a", benchmark="b")
    with pytest.raises(ValueError, match="owns its parameters"):
        SuiteItem(benchmark="b", overrides={"n": 4})
    with pytest.raises(KeyError, match="unknown suite item fields"):
        SuiteItem.from_dict({"experiment": "a", "bogus": 1})
    with pytest.raises(ValueError, match="unknown claim kind"):
        ClaimSpec(kind="magic")
    with pytest.raises(ValueError, match="needs 'over'"):
        ClaimSpec(kind="monotonic", metric="w")


def test_claim_evaluation_kinds():
    table = ResultTable([
        {"x": 1, "strategy": "A", "w": 0.10},
        {"x": 2, "strategy": "A", "w": 0.20},
        {"x": 3, "strategy": "A", "w": 0.15},
        {"x": 1, "strategy": "B", "w": 0.30},
    ])
    payload = {"cell": {"speedup": 12.0}, "list": [{"v": 5}]}

    pinned = ClaimSpec(kind="pinned", metric="w", value=0.1, tol=0.01,
                       where={"x": 1, "strategy": "A"})
    assert pinned.evaluate(table, payload)["ok"]
    exact = ClaimSpec(kind="pinned", metric="w", value=0.100001,
                      where={"x": 1, "strategy": "A"})
    assert not exact.evaluate(table, payload)["ok"]     # no tol = exact

    bound = ClaimSpec(kind="bound", path="cell.speedup", min=10.0)
    assert bound.evaluate(table, payload)["ok"]
    assert lookup_path(payload, "list.0.v") == 5

    comp = ClaimSpec(kind="compare", metric="w", op="<",
                     lhs={"x": 1, "strategy": "A"},
                     rhs={"x": 1, "strategy": "B"})
    assert comp.evaluate(table, payload)["ok"]
    scaled = ClaimSpec(kind="compare", metric="w", op="<=", rel_factor=0.5,
                       lhs={"x": 1, "strategy": "B"},
                       rhs={"x": 1, "strategy": "B"})
    assert not scaled.evaluate(table, payload)["ok"]

    mono = ClaimSpec(kind="monotonic", metric="w", over="x", tol=0.06,
                     direction="increasing", where={"strategy": "A"})
    assert mono.evaluate(table, payload)["ok"]          # 0.2 -> 0.15 in tol
    strict = ClaimSpec(kind="monotonic", metric="w", over="x",
                       direction="increasing", where={"strategy": "A"})
    assert not strict.evaluate(table, payload)["ok"]

    missing = ClaimSpec(kind="bound", path="cell.nope", min=0.0)
    res = missing.evaluate(table, payload)
    assert not res["ok"] and "lookup error" in res["detail"]


def test_claim_round_trip():
    c = ClaimSpec.from_dict({"kind": "compare", "metric": "w", "op": "==",
                             "lhs": {"a": 1}, "rhs": {"a": 2}})
    assert ClaimSpec.from_dict(c.to_dict()) == c
    with pytest.raises(KeyError, match="unknown claim fields"):
        ClaimSpec.from_dict({"kind": "bound", "path": "x", "mim": 0})


# ---------------------------------------------------------------------------
# Suite runner: store-backed resume
# ---------------------------------------------------------------------------

def test_run_suite_resumes_from_store(tmp_path):
    store = ResultStore(tmp_path)
    suite = SuiteSpec.from_dict(TINY_SUITE)

    first = run_suite(suite, store=store, device="cpu")
    assert first.ok and not first.items[0].cached
    assert len(first.items[0].claims) == 2
    stored = store.get(first.items[0].record_id)
    assert stored is not None and stored.ok

    second = run_suite(suite, store=store, device="cpu")
    assert second.ok and second.items[0].cached
    assert second.items[0].record_id == first.items[0].record_id
    assert second.record_id == first.record_id   # suite identity too
    # the cached rows are the executed rows, verbatim
    assert second.items[0].record.rows == first.items[0].record.rows

    third = run_suite(suite, store=store, resume=False, device="cpu")
    assert not third.items[0].cached
    assert third.items[0].record.rows == first.items[0].record.rows


def test_run_suite_failed_run_not_stored(tmp_path):
    store = ResultStore(tmp_path)
    suite = SuiteSpec.from_dict({
        "suite": "broken", "register": [],
        "items": [{"experiment": "no_such_experiment_xyz"}]})
    result = run_suite(suite, store=store, device="cpu")
    assert not result.ok
    assert result.items[0].error is not None
    assert store.get(result.items[0].record_id) is None
    assert any("ERROR" in f for f in result.failures())


def test_run_suite_reevaluates_claims_on_resume(tmp_path):
    store = ResultStore(tmp_path)
    run_suite(SuiteSpec.from_dict(TINY_SUITE), store=store, device="cpu")
    tightened = json.loads(json.dumps(TINY_SUITE))
    tightened["items"][0]["claims"] = [
        {"kind": "bound", "metric": "waste", "max": -1.0,
         "where": {"strategy": "RFO"}}]
    result = run_suite(SuiteSpec.from_dict(tightened), store=store,
                       device="cpu")
    assert result.items[0].cached          # no re-simulation...
    assert not result.ok                   # ...but the new claim gates


# ---------------------------------------------------------------------------
# EvalCache spill gc
# ---------------------------------------------------------------------------

def _spill(tmp_path, name, size, mtime):
    path = tmp_path / f"eval-{name}.json"
    path.write_text("x" * size)
    os.utime(path, (mtime, mtime))
    return path


def _strategy(period):
    from repro_torch.core.policies import Strategy
    from repro_torch.core.simulator import NeverTrust
    return Strategy("S", period, NeverTrust())


def test_gc_cache_lru_eviction(tmp_path):
    old = _spill(tmp_path, "old", 600, 1_000.0)
    mid = _spill(tmp_path, "mid", 600, 2_000.0)
    new = _spill(tmp_path, "new", 600, 3_000.0)
    other = tmp_path / "not-a-spill.json"
    other.write_text("x" * 600)

    dry = gc_cache(tmp_path, max_bytes=1300, dry_run=True)
    assert [p for p, _ in dry] == [old] and old.exists()

    evicted = gc_cache(tmp_path, max_bytes=1300)
    assert [p for p, _ in evicted] == [old]
    assert not old.exists() and mid.exists() and new.exists()
    assert other.exists()                     # only eval-*.json is fair game
    assert gc_cache(tmp_path, max_bytes=1300) == []


def test_evalcache_flush_triggers_gc(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_CACHE_MAX_MB", str(1e-5))   # ~10 bytes
    _spill(tmp_path, "stale", 400, 1_000.0)

    monkeypatch.setenv("REPRO_CACHE_GC_DRY_RUN", "1")
    key = _cell_persist_key(SMALL, False, "cpu")
    cache = EvalCache(persist_key=key, cache_dir=tmp_path)
    cache.put(_strategy(1200.0), 0, 123.0)
    cache.flush()
    assert "would evict" in capsys.readouterr().err
    assert (tmp_path / "eval-stale.json").exists()        # dry run

    monkeypatch.delenv("REPRO_CACHE_GC_DRY_RUN")
    cache.put(_strategy(1300.0), 0, 124.0)
    cache.flush()
    assert not (tmp_path / "eval-stale.json").exists()    # LRU victim

    monkeypatch.setenv("REPRO_CACHE_MAX_MB", "0")         # 0 disables
    _spill(tmp_path, "stale2", 400, 1_000.0)
    cache.put(_strategy(1400.0), 0, 125.0)
    cache.flush()
    assert (tmp_path / "eval-stale2.json").exists()


def test_evalcache_load_touches_lru_clock(tmp_path):
    key = _cell_persist_key(SMALL, False, "cpu")
    cache = EvalCache(persist_key=key, cache_dir=tmp_path)
    cache.put(_strategy(1200.0), 0, 123.0)
    cache.flush()
    path = tmp_path / f"{key}.json"
    os.utime(path, (1_000.0, 1_000.0))
    EvalCache(persist_key=key, cache_dir=tmp_path)        # pure read
    assert path.stat().st_mtime > 1_000.0


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_list_show_diff_gc_baseline(tmp_path, capsys):
    store_dir = str(tmp_path / "store")
    a = RunRecord.create("experiment", "demo", {"seed": 0},
                         rows=[{"w": 0.1}])
    b = RunRecord.create("experiment", "demo", {"seed": 1},
                         rows=[{"w": 0.2}])
    store = ResultStore(store_dir)
    store.put(a)
    store.put(b)

    assert cli_main(["--store", store_dir, "list"]) == 0
    out = capsys.readouterr().out
    assert a.record_id in out and b.record_id in out

    assert cli_main(["--store", store_dir, "show", a.record_id]) == 0
    assert json.loads(capsys.readouterr().out)["record_id"] == a.record_id

    rc = cli_main(["--store", store_dir, "diff", a.record_id, b.record_id])
    assert rc == 1
    assert "identity.seed" in capsys.readouterr().out
    assert cli_main(["--store", store_dir, "diff", a.record_id,
                     a.record_id]) == 0
    capsys.readouterr()

    # bundle diff: clean then injected regression
    suite_rec = RunRecord.create("suite", "s",
                                 {"member_ids": [a.record_id]},
                                 payload={"items": [
                                     {"record_id": a.record_id}]})
    store.put(suite_rec)
    bundle = ResultStore.bundle(suite_rec, [a])
    good = tmp_path / "good.json"
    good.write_text(canonical_json(bundle))
    assert cli_main(["--store", store_dir, "diff", str(good)]) == 0
    bad_bundle = json.loads(canonical_json(bundle))
    bad_bundle["records"][a.record_id]["rows"][0]["w"] = 9.9
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(bad_bundle))
    assert cli_main(["--store", store_dir, "diff", str(bad)]) == 1
    capsys.readouterr()

    assert cli_main(["--store", store_dir, "baseline", "s",
                     "--out", str(tmp_path / "base.json")]) == 0
    exported = ResultStore.load_bundle(tmp_path / "base.json")
    assert a.record_id in exported["records"]

    assert cli_main(["--store", store_dir, "gc", "--keep", "1"]) == 0
    assert len(store.find(name="demo")) == 1


def test_cli_run_gate_and_require_cached(tmp_path, capsys):
    store_dir = str(tmp_path / "store")
    suite_path = tmp_path / "tiny.json"
    suite_path.write_text(json.dumps(TINY_SUITE))
    baseline = tmp_path / "baseline.json"

    rc = cli_main(["--store", store_dir, "run", str(suite_path),
                   "--device", "cpu", "--update-baseline", str(baseline)])
    assert rc == 0 and baseline.exists()
    capsys.readouterr()

    # resume: everything cached, gate clean
    rc = cli_main(["--store", store_dir, "run", str(suite_path),
                   "--device", "cpu", "--require-cached",
                   "--gate", str(baseline)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "1 from store" in out and "no divergence" in out

    # injected regression: perturb the baseline, the gate must fail
    bundle = json.loads(baseline.read_text())
    for rec in bundle["records"].values():
        if rec["kind"] == "experiment":
            rec["rows"][0]["makespan"] += 1.0
    baseline.write_text(json.dumps(bundle))
    rc = cli_main(["--store", store_dir, "run", str(suite_path),
                   "--device", "cpu", "--gate", str(baseline)])
    assert rc == 1
    assert "makespan" in capsys.readouterr().out


def test_cli_metrics_view(tmp_path, capsys):
    store_dir = str(tmp_path / "store")
    store = ResultStore(store_dir)
    rec = RunRecord.create(
        "benchmark", "obs_demo", {"v": 1},
        payload={"metrics": {"runner.cells": 3, "fleet.faults": 7}},
        timings={"wall_s": 1.25, "torch.lanes_per_s": 0.5})
    store.put(rec)
    assert cli_main(["--store", store_dir, "metrics", rec.record_id]) == 0
    out = capsys.readouterr().out
    assert "runner.cells" in out and "fleet.faults" in out
    assert "wall_s" in out and "torch.lanes_per_s" in out
    # Name-based lookup + empty-metrics record both work.
    bare = RunRecord.create("benchmark", "bare", {"v": 1})
    store.put(bare)
    assert cli_main(["--store", store_dir, "metrics", "bare"]) == 0
    assert "no metrics" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Determinism knobs riding along
# ---------------------------------------------------------------------------

def test_result_table_to_json_sorted():
    table = ResultTable([{"b": 1, "a": 2}])
    assert table.to_json() == '[{"a": 2, "b": 1}]'
    assert table.to_json(sort_keys=False) == '[{"b": 1, "a": 2}]'


def test_with_overrides():
    from repro_torch.experiments import (ExperimentSpec, StrategySpec,
                                         SweepSpec)
    exp = ExperimentSpec(
        name="t", scenario=SMALL, strategies=(StrategySpec("rfo"),),
        sweep=SweepSpec(axes={"n": [32, 64]}, labels={"n": ["s", "l"]}))
    # axis override replaces the swept values and drops the stale labels
    over = exp.with_overrides({"n": [128]})
    assert tuple(over.sweep.axes["n"]) == (128,)
    assert "n" not in over.sweep.labels
    # scenario override on a non-swept field
    assert over.with_overrides({"seed": 9}).scenario.seed == 9


def test_with_overrides_covered_field():
    from repro_torch.experiments import (ExperimentSpec, StrategySpec,
                                         SweepSpec)
    exp = ExperimentSpec(
        name="t", scenario=SMALL, strategies=(StrategySpec("rfo"),),
        sweep=SweepSpec(
            axes={"recall,precision": [(0.85, 0.82), (0.7, 0.4)]}))
    # a scenario field controlled by a (zipped) sweep axis cannot be
    # overridden underneath it — the axis would discard it per cell
    with pytest.raises(ValueError, match="controlled by sweep axis"):
        exp.with_overrides({"recall": 0.9})
    # paths the axis does not cover merge fine
    assert exp.with_overrides(
        {"dist.params.shape": 0.9}).scenario.dist.params["shape"] == 0.9


# ---------------------------------------------------------------------------
# Against the reference: the baseline bundle's records
# ---------------------------------------------------------------------------

BASELINE_IDS = sorted(_baseline()["records"])


@pytest.mark.parametrize("rid", BASELINE_IDS)
def test_record_id_is_the_baseline_key(rid):
    rec = _baseline()["records"][rid]
    assert RunRecord.id_for(rec["kind"], rec["name"], rec["identity"]) == rid
    assert RunRecord.from_dict(rec).record_id == rid


@pytest.mark.parametrize("rid", BASELINE_IDS)
def test_canonical_bytes_are_the_reference_s(rid):
    from repro.store import RunRecord as RefRecord
    from repro.store import canonical_json as ref_canonical_json
    rec = _baseline()["records"][rid]
    for indent in (1, None):
        assert canonical_json(rec, indent=indent) \
            == ref_canonical_json(rec, indent=indent)
    assert RunRecord.from_dict(rec).to_json() \
        == RefRecord.from_dict(rec).to_json()


@pytest.mark.parametrize("rid", BASELINE_IDS)
def test_baseline_record_diffs_empty_against_itself(rid):
    rec = _baseline()["records"][rid]
    assert diff_records(rec, json.loads(json.dumps(rec))) == []
    assert diff_records(RunRecord.from_dict(rec), rec) == []


def test_baseline_bundle_bytes():
    """The committed bundle is the port's canonical JSON of itself."""
    text = BASELINE.read_text()
    assert canonical_json(json.loads(text)) + "\n" == text
    assert ResultStore.load_bundle(BASELINE)["schema"] == STORE_SCHEMA_VERSION


# ---------------------------------------------------------------------------
# suites/quick_torch.json against suites/quick.yaml and the reference
# ---------------------------------------------------------------------------

def _yaml_experiment_items() -> list[dict]:
    yaml = pytest.importorskip("yaml")
    data = yaml.safe_load((ROOT / "suites" / "quick.yaml").read_text())
    return [it for it in data["items"] if "experiment" in it]


def test_quick_torch_items_are_quick_yaml_s():
    mine = json.loads(QUICK_TORCH.read_text())
    assert mine["register"] == []
    theirs = _yaml_experiment_items()
    assert [it["label"] for it in mine["items"]] \
        == [it.get("label", it["experiment"]) for it in theirs] \
        == ["table2", "window_sweep", "exact_vs_first_order",
            "silent_sweep", "recall_axis"]
    for it, ref in zip(mine["items"], theirs):
        assert set(it) == {"label", "spec", "claims"}
        assert it["claims"] == ref["claims"], it["label"]
    suite = SuiteSpec.from_file(QUICK_TORCH)
    assert [i.name for i in suite.items] == [it["label"]
                                            for it in mine["items"]]


def test_quick_torch_specs_are_the_builders():
    pytest.importorskip("jax")
    import benchmarks.run as bench_run
    from repro.experiments import build_experiment
    bench_run._import_benchmarks()
    records = {r["name"]: r for r in _baseline()["records"].values()}
    mine = json.loads(QUICK_TORCH.read_text())["items"]
    for it, ref in zip(mine, _yaml_experiment_items()):
        built = build_experiment(ref["experiment"], quick=True,
                                 **ref.get("args", {})).to_dict()
        assert it["spec"] == json.loads(json.dumps(built)), it["label"]
        # the builder's key order, which fixes the rows' order
        assert json.dumps(it["spec"]) == json.dumps(built), it["label"]
        assert it["spec"] == records[it["label"]]["identity"]["spec"]
        from repro_torch.experiments import ExperimentSpec
        assert ExperimentSpec.from_dict(it["spec"]).to_dict() == it["spec"]


def test_run_suite_matches_the_baseline_records(tmp_path):
    """table2 and silent_sweep of quick_torch.json through the port's
    run_suite on the CPU (the scalar oracle): rows and payload == the
    baseline's records, identity == but for the engine fingerprint."""
    data = json.loads(QUICK_TORCH.read_text())
    data["items"] = [it for it in data["items"]
                     if it["label"] in ("table2", "silent_sweep")]
    store = ResultStore(tmp_path)
    result = run_suite(SuiteSpec.from_dict(data), store=store,
                       engine="scalar", device="cpu")
    assert result.ok, result.summary()
    base = {(r["kind"], r["name"]): r
            for r in _baseline()["records"].values()}
    for it in result.items:
        rec = store.get(it.record_id).to_dict()
        want = base[("experiment", it.name)]
        assert rec["rows"] == want["rows"], it.name
        assert rec["payload"] == want["payload"], it.name
        got_id, want_id = dict(rec["identity"]), dict(want["identity"])
        assert got_id.pop("engine_fingerprint") == _engine_fingerprint("cpu")
        assert want_id.pop("engine_fingerprint") == ""
        assert got_id == want_id, it.name
        assert rec["record_id"] != want["record_id"]
        assert [str(d) for d in diff_records(want, rec)] == [
            f"identity.engine_fingerprint: '' != "
            f"{_engine_fingerprint('cpu')!r}"]
        assert "torch.chunks" not in rec["payload"].get("metrics", {})


def test_benchmark_and_unknown_items_are_errors_not_stored(tmp_path):
    store = ResultStore(tmp_path)
    suite = SuiteSpec.from_dict({
        "suite": "mixed", "register": [],
        "items": [{"benchmark": "fleet_sweep"},
                  {"experiment": "no_such_experiment_xyz"}]})
    result = run_suite(suite, store=store, device="cpu")
    assert not result.ok
    bench, unknown = result.items
    assert bench.kind == "benchmark" and "A5" in bench.error
    assert bench.record_id and store.get(bench.record_id) is None
    assert "no_such_experiment_xyz" in unknown.error
    # only the suite record is stored
    assert [r.kind for r in store] == ["suite"]


def test_register_imports_only_the_port(tmp_path, monkeypatch):
    import importlib
    seen = []
    real = importlib.import_module

    def spy(name, *args, **kw):
        seen.append(name)
        return real(name, *args, **kw)

    monkeypatch.setattr(importlib, "import_module", spy)
    SuiteSpec.from_dict({"suite": "r", "items": [],
                         "register": ["benchmarks.run", "repro.store",
                                      "repro_torch.experiments"]}
                        ).ensure_registered()
    assert seen == ["repro_torch.experiments"]
    # the default register is the reference's, and is skipped the same way
    assert SuiteSpec(name="d").register == ("benchmarks.run",)
