"""The harness's arithmetic, its reading of the profiler's timeline, and
how it finds a cell by name."""

import json
import types
from pathlib import Path

import numpy as np
import pytest

from portbench import harness
from portbench.reference import roofline
from portbench_tiny import tiny_checkout

PB = Path(__file__).resolve().parents[1]
REPO = PB.parent


def _reader(name: str):
    return harness.load_module(PB / "metrics" / f"{name}.py",
                               f"portbench_metric_{name}")


def _rec(**kw) -> dict:
    rec = {"setup_s": 1.0, "window_s": 1.0, "pass_s": [], "passes": 0,
           "units": 0, "timers": {}, "counters": {}, "least_s": None,
           "device_events": None, "trace_window_s": None}
    rec.update(kw)
    return rec


def test_lanes_per_s_counts_all_lanes_over_all_the_window():
    steady = _rec(pass_s=[1.0] * 4, passes=4, units=400, window_s=4.0)
    stalled = _rec(pass_s=[1.0] * 3 + [5.0], passes=4, units=400,
                   window_s=8.0)
    read = _reader("lanes_per_s").read
    assert read(steady) == 100.0
    assert read(stalled) == 50.0


def test_pass_percentiles_are_over_every_pass():
    pass_s = [0.001] * 90 + [0.010] * 10 + [0.002] * 20
    rec = _rec(pass_s=pass_s, passes=len(pass_s))
    want90 = float(np.percentile(np.array(pass_s) * 1e3, 90))
    assert _reader("pass_p90_ms").read(rec) == want90
    assert _reader("pass_p50_ms").read(rec) == 1.0
    # Not the median of the medians of chunks of passes.
    chunks = [np.percentile(np.array(pass_s[i:i + 30]) * 1e3, 90)
              for i in range(0, len(pass_s), 30)]
    assert want90 != pytest.approx(float(np.median(chunks)))


def test_host_tables_and_transfer():
    timers = {"torch.tables_s": 0.2, "torch.upload_s": 0.1,
              "torch.run_s": 1.0, "torch.readback_s": 0.3}
    rec = _rec(pass_s=[1.0, 1.0], passes=2, timers=timers)
    assert _reader("study.host_ms").read(rec) == pytest.approx(200.0)
    assert _reader("engine.tables_ms").read(rec) == pytest.approx(100.0)
    assert _reader("engine.transfer_ms").read(rec) == pytest.approx(200.0)
    assert _reader("study.host_ms").read(_rec(passes=2)) is None


KERNEL = "void (anonymous namespace)::lane_loop_kernel<false, false>(...)"
EVENTS = [(KERNEL, 0.10, 0.40), ("Memcpy HtoD (Pageable -> Device)", 0.05,
                                 0.12),
          (KERNEL, 0.60, 0.70), ("Memcpy DtoH (Device -> Pinned)", 0.90,
                                 0.95)]


def test_device_time_and_idle_share_of_a_synthetic_trace():
    rec = _rec(passes=2, device_events=EVENTS, trace_window_s=1.0,
               least_s=[0.001, 0.003])
    assert _reader("lane_loop.device_ms").read(rec) == pytest.approx(200.0)
    # Busy: [0.05, 0.40], [0.60, 0.70], [0.90, 0.95] = 0.50 s of 1.0 s.
    assert _reader("device.idle_pct").read(rec) == pytest.approx(50.0)
    assert harness.busy_seconds(EVENTS) == pytest.approx(0.5)
    assert _reader("lane_loop_roofline").read(rec) == pytest.approx(1.0)
    for name in ("lane_loop.device_ms", "lane_loop_roofline",
                 "device.idle_pct"):
        assert _reader(name).read(_rec(passes=2)) is None
    no_kernel = _rec(passes=2, device_events=EVENTS[1::2],
                     trace_window_s=1.0, least_s=[0.001])
    assert _reader("lane_loop.device_ms").read(no_kernel) is None
    assert _reader("lane_loop_roofline").read(no_kernel) is None


class _Event:
    def __init__(self, name, dev, s_ns, d_ns, annotation=False):
        self._v = (name, dev, s_ns, d_ns, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def test_timeline_leaves_labels_off_the_card_and_names_gaps():
    events = [_Event(harness.PASS_SPAN, "DeviceType.CPU", 0, 1_000_000_000),
              _Event(harness.PASS_SPAN, "DeviceType.CUDA", 100_000_000,
                     800_000_000, annotation=True),
              _Event("study.best_means", "DeviceType.CUDA", 0, 10, True),
              _Event("aten::copy_", "DeviceType.CPU", 450_000_000,
                     100_000_000),
              _Event(KERNEL, "DeviceType.CUDA", 100_000_000, 300_000_000),
              _Event(KERNEL, "DeviceType.CUDA", 600_000_000, 300_000_000)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    dev, host = harness.timeline(prof)
    assert [n for n, _, _ in dev] == [KERNEL, KERNEL]
    assert len(host) == 2
    bd = harness.breakdown(dev, host, 0.0, 1.0)
    assert bd["device_ops"] == [[KERNEL, pytest.approx(0.6)]]
    gaps = {round(v, 6): n for n, v in bd["idle_gaps"]}
    assert gaps == {0.1: harness.PASS_SPAN, 0.2: "aten::copy_"}


def test_roofline_bound_is_the_larger_of_operations_and_bytes():
    counts = {"n_periodic_ckpts": 10 ** 6, "n_faults_hit": 10,
              "n_rollbacks": 0, "n_predictions": 100,
              "n_proactive_ckpts": 1}
    ops = roofline.pass_ops(counts)
    assert ops == 19 * 10 ** 6 + 5 * 10 + 2 * 100 + 14
    nbytes = roofline.pass_bytes(1000, 26)
    assert nbytes == 9 * 1000 + 232 * 26
    assert roofline.least_seconds(ops, nbytes) == ops / 34e12
    assert roofline.least_seconds(0, nbytes) == nbytes / 3.35e12


def test_a_new_cell_needs_only_new_files(tmp_path):
    """One config file, one workload file and one metric file (and their
    entries in BENCHMARK.json) make a runnable cell and metric."""
    root = tiny_checkout(tmp_path)
    (root / "portbench" / "metrics" / "study.passes.py").write_text(
        "def read(rec):\n    return float(rec['passes'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "study.passes", "unit": "passes", "better": "higher",
        "source": "program_counter", "layer": "experiments and lane packing",
        "moves": "lanes_per_s.short", "workloads": ["tiny-study"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for name in ("BENCHMARK.json", "portbench/harness.py",
                 "portbench/drivers/study.py", "portbench/run.py"):
        if name != "BENCHMARK.json":
            assert (root / name).read_bytes() == (REPO / name).read_bytes()
    cell = harness.load_cell(root, "tiny-study")
    assert cell.cfg["n"] == 4096
    assert [m["name"] for m in cell.metrics["end_to_end"]] == [
        "lanes_per_s.short", "setup_s"]
    assert "study.passes" in [m["name"] for m in cell.metrics["per_layer"]]
    res = harness.run(cell, seed=2 ** 31 + 3, seconds=0.1, trace=True,
                      device="cpu", t_start=0.0)
    assert res["correct"] and res["metrics"]["study.passes"]["value"] >= 1
    assert list(res)[-1] == "checks"
    for name in ("study.host_ms", "engine.tables_ms", "engine.transfer_ms"):
        assert name + ".short" in res["metrics"]
    # No card, so no device metric: the readers find nothing to read.
    assert "lane_loop.device_ms.short" not in res["metrics"]


def test_cells_of_the_benchmark_load():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = harness.load_cell(REPO, w["name"])
        e2e = {m["name"] for m in cell.metrics["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) == 3
        layer = cell.metrics["per_layer"]
        assert len(layer) == 6 and {m["moves"] for m in layer} < e2e
        assert cell.readers["lanes_per_s.long" if "w05" in w["name"]
                            else "lanes_per_s.short"].__file__.endswith(
                                "lanes_per_s.py")


def test_split_metric_finds_the_quantitys_reader(tmp_path):
    (tmp_path / "metrics").mkdir()
    for name in ("a.py", "a.b.py"):
        (tmp_path / "metrics" / name).write_text("")
    assert harness.reader_path(tmp_path, "a.b.c").name == "a.b.py"
    assert harness.reader_path(tmp_path, "a.x").name == "a.py"
    with pytest.raises(FileNotFoundError):
        harness.reader_path(tmp_path, "z.b")


def test_test_file_names_are_not_the_repo_tests():
    ours = {p.name for p in (PB / "tests").iterdir() if p.is_file()}
    theirs = {p.name for p in (REPO / "tests").iterdir()}
    assert ours and not ours & theirs
