"""The port stands alone: no jax, nothing of ``repro``, no CPU fallback.

* An AST scan of every file under ``src/repro_torch/``, of the example
  copies ``examples/*_torch.py`` and of ``chip_smoke.py`` finds no import
  of ``jax``, none of ``repro`` / ``repro.*`` and none of ``benchmarks``.
* A subprocess in which ``jax`` and ``repro`` cannot be imported at all
  imports ``repro_torch``, runs a tiny CPU grid (static and adaptive
  lanes, over traces of a generative predictor model), builds a tiny CPU
  trainer that takes a step, a full and a proactive save and a restore,
  serves a tiny CPU ``generate`` through both attention routes (the
  families and the M-RoPE VLM too), takes the encoder-only model's
  forward and masked-prediction loss through the kernel route, and runs
  the two-level model, attribution and a traced replay, a small fleet
  sized from the model zoo, the availability scheduler and the adaptive
  scheduler, and a tiny inline suite through ``run_suite`` and the result
  store (its ``register`` naming ``benchmarks.run``, which is skipped);
  afterwards ``sys.modules`` holds neither, nor ``benchmarks``.
* Without CUDA, an entry point called without ``device=`` raises instead
  of running on the CPU.
* The constants and configs the port re-declares equal the reference's
  (the estimator's ``P_HAT_MIN`` among them), and the lane loop's new rows
  sit between the fixed rows and the deferred-fault slots.
"""

import ast
import dataclasses
import os
import tempfile
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + sorted((ROOT / "examples").glob("*_torch.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "benchmarks")


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"batch_torch.py", "event_step.py", "chip_smoke.py",
            "ckpt_delta.py", "manager.py", "loop.py", "transformer.py",
            "adamw.py", "pipeline.py", "scheduler.py", "runtime.py",
            "convert.py", "train.py", "engine.py", "serve.py",
            "flash_attention.py", "decode_attention.py", "ops.py",
            "exact.py", "estimator.py", "base.py", "models.py",
            "registry.py", "multilevel.py", "trace.py", "attribution.py",
            "perfetto.py", "availability.py", "plan.py", "sim.py",
            "spec.py", "experiment.py", "extras.py", "llama3_405b.py",
            "internlm2_20b.py", "hubert_xlarge.py", "qwen2_moe_a27b.py",
            "qwen2_vl_72b.py", "qwen3_moe_235b_a22b.py",
            "recurrentgemma_2b.py", "xlstm_125m.py", "moe.py", "rglru.py",
            "xlstm.py", "record.py", "store.py", "suite.py", "cli.py",
            "__main__.py", "quickstart_torch.py", "predictor_study_torch.py",
            "trace_timeline_torch.py", "serving_torch.py",
            "fault_tolerant_training_torch.py"} <= names
    port = ROOT / "src" / "repro_torch"
    assert {"fleet/__init__.py", "fleet/sim.py", "ft/estimator.py",
            "obs/trace.py", "core/multilevel.py", "store/__init__.py",
            "store/__main__.py", "store/cli.py", "store/record.py",
            "store/store.py", "store/suite.py"} \
        <= {str(p.relative_to(port)) for p in PORT_FILES
            if port in p.parents}


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_import(path):
    bad = [n for n in _imported_modules(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


_NO_JAX = r"""
import importlib.abc
import sys


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks"):
            raise ImportError(f"{name} is blocked in this process")
        return None


sys.meta_path.insert(0, Block())
import numpy as np
import repro_torch
from repro_torch.core.simulator import ThresholdTrust
from repro_torch.core.traces import Exponential, make_event_trace
from repro_torch.core.waste import Platform

traces = [make_event_trace(Exponential(1.0), 2500.0, 0.7, 0.6, 40000.0,
                           np.random.default_rng(s)) for s in (1, 2)]
res = repro_torch.simulate_batch(
    traces, Platform(mu=2500.0, c=60.0, d=10.0, r=30.0), 10000.0,
    [1200.0, 2000.0], cp=30.0, trust=ThresholdTrust(100.0),
    inexact_window=300.0, trace_seeds=[3, 4], device="cpu")
assert res.makespan.shape == (2, 2) and (res.makespan > 10000.0).all()

from repro_torch.experiments import ScenarioSpec, build_strategy
from repro_torch.predictors import AdaptiveConfig

cfg = AdaptiveConfig(prior_recall=0.5, prior_precision=0.5, min_preds=2,
                     min_faults=1, tol=0.02, model_order="exact")
res = repro_torch.simulate_batch(
    traces, Platform(mu=2500.0, c=60.0, d=10.0, r=30.0), 10000.0,
    [1200.0], cp=30.0, trust=ThresholdTrust(100.0), adaptive=cfg,
    trace_seeds=[3, 4], device="cpu")
assert (res.n_replans > 0).any()
sc = ScenarioSpec(n=64, mu_ind=64 * 3e4, time_base_years_total=0.05,
                  start=0.0, predictor={"name": "bursty"})
assert sc.make_trace(0).times.size > 0
assert build_strategy("adaptive", sc).adaptive is not None

import dataclasses
import tempfile

from repro_torch.configs import get
from repro_torch.configs.base import InputShape, PlatformConfig
from repro_torch.train import FaultTolerantTrainer

cfg = dataclasses.replace(get("tinyllama-1.1b").reduced(), n_layers=1,
                          d_model=32, n_heads=2, n_kv_heads=1, head_dim=16,
                          d_ff=64, vocab_size=64, dtype="float32")
with tempfile.TemporaryDirectory() as d:
    tr = FaultTolerantTrainer(cfg, InputShape("t", 8, 2, "train"),
                              PlatformConfig(mu_ind=300.0, c=30.0, cp=10.0,
                                             d=5.0, r=15.0),
                              workdir=d, step_time=10.0, device="cpu")
    stats = tr.run(1)
    assert stats.n_steps == 1 and stats.n_periodic == 1
    tr.manager.save_proactive(2, tr.state)
    step, _ = tr.manager.restore(like=tr.state)
    assert step == 2

import torch

from repro_torch.models.model import init_params
from repro_torch.serve import ServingEngine

for impl in ("ref", "pallas"):
    scfg = dataclasses.replace(cfg, attn_impl=impl)
    eng = ServingEngine(scfg, init_params(scfg, seed=0, device="cpu"),
                        cache_len=12)
    out = eng.generate({"tokens": torch.zeros((2, 8), dtype=torch.int32)}, 4)
    assert out.tokens.shape == (2, 4) and bool((out.logprobs <= 0).all())
from repro_torch.configs import get
from repro_torch.models.model import loss_fn, make_batch
gen = torch.Generator()
gen.manual_seed(0)
for arch in ("qwen2-moe-a2.7b", "recurrentgemma-2b", "xlstm-125m",
             "qwen2-vl-72b"):
    fcfg = dataclasses.replace(get(arch).reduced(), attn_impl="pallas")
    eng = ServingEngine(fcfg, init_params(fcfg, seed=0, device="cpu"),
                        cache_len=12)
    out = eng.generate(make_batch(fcfg, InputShape("t", 8, 2, "prefill"),
                                  gen), 4)
    assert out.tokens.shape == (2, 4) and bool((out.logprobs <= 0).all())
acfg = dataclasses.replace(get("hubert-xlarge").reduced(), head_dim=80,
                           attn_impl="pallas")
loss, _ = loss_fn(acfg, init_params(acfg, seed=0, device="cpu"),
                  make_batch(acfg, InputShape("t", 8, 2, "train"), gen))
assert bool(torch.isfinite(loss))
from repro_torch.configs import REGISTRY, EXTRAS
from repro_torch.core import (TwoLevelPlatform, optimal_two_level,
                              simulate_two_level, two_level_stream)
from repro_torch.fleet import (FleetJobSpec, FleetSpec, OutageWeights,
                               evaluate_fleet, job_from_model)
from repro_torch.ft import AdaptiveScheduler, CheckpointScheduler
from repro_torch.obs import (RecordingSink, attribute_lanes,
                             attribute_result, fleet_to_perfetto,
                             record_run)

assert len(REGISTRY) == 10 and len(EXTRAS) == 2
p2 = TwoLevelPlatform(mu=5000.0, phi=0.7, c1=5.0, c2=100.0, r1=5.0,
                      r2=100.0, d=2.0)
t1, k, _ = optimal_two_level(p2)
f, soft = two_level_stream(p2, 1e6, np.random.default_rng(0))
assert simulate_two_level(f, soft, p2, 1e5, t1, k).makespan > 1e5
lanes, closed = attribute_lanes(res)
assert closed.shape == res.makespan.shape
run, sink = record_run(traces[0], Platform(mu=2500.0, c=60.0, d=10.0,
                                           r=30.0), 10000.0, 1200.0, cp=30.0,
                       trust=ThresholdTrust(100.0))
assert len(sink) > 0 and attribute_result(run).makespan == run.makespan
assert fleet_to_perfetto([("job", sink.events)])["traceEvents"]
fleet = FleetSpec(jobs=(job_from_model("llama3-405b", n_devices=8192,
                                       n_traces=1, time_base_days=1.0),
                        FleetJobSpec(scenario=sc)),
                  objective="availability",
                  outage=OutageWeights(ckpt=0.25, prockpt=0.25),
                  storage_streams=1, repair_slots=1)
assert len(evaluate_fleet(fleet).rows) == 2
plat = PlatformConfig(mu_ind=3e5, c=30.0, cp=10.0, d=5.0, r=15.0,
                      ckpt_outage=0.5)
assert CheckpointScheduler(plat, 1, objective="availability").period > 0
ada = AdaptiveScheduler(plat, 1, c=30.0, cp=10.0)
ada.estimator.observe_fault(100.0)
ada.maybe_replan()
from repro_torch.experiments import run_suite
from repro_torch.store import ResultStore, SuiteSpec
from repro_torch.store.cli import main as store_main

tiny = SuiteSpec.from_dict({
    "suite": "tiny", "register": ["benchmarks.run"],
    "items": [{"label": "tiny", "spec": {
        "name": "tiny", "scenario": sc.replace(n_traces=2).to_dict(),
        "strategies": [{"name": "rfo"}]},
        "claims": [{"kind": "bound", "metric": "waste", "min": 0.0,
                    "max": 1.0, "where": {"strategy": "RFO"}}]}]})
with tempfile.TemporaryDirectory() as d:
    first = run_suite(tiny, store=ResultStore(d), device="cpu")
    assert first.ok and not first.items[0].cached, first.summary()
    again = run_suite(tiny, store=ResultStore(d), device="cpu")
    assert again.ok and again.items[0].cached
    assert store_main(["--store", d, "list"]) == 0
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro",
                                       "benchmarks"))
assert not leaked, leaked
print("ISOLATED-OK")
"""


def test_runs_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "ISOLATED-OK" in proc.stdout


def _entry_points():
    import numpy as np

    from repro_torch.core.batch import simulate_batch, simulate_lanes
    from repro_torch.core.batch_torch import run_lanes_torch
    from repro_torch.core.policies import Strategy
    from repro_torch.core.simulator import NeverTrust
    from repro_torch.core.traces import EventTrace
    from repro_torch.core.waste import Platform
    from repro_torch.configs import get
    from repro_torch.configs.base import InputShape, PlatformConfig
    from repro_torch.experiments import (ExperimentSpec, ScenarioSpec,
                                         evaluate_strategies, run_experiment)
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models.model import init_cache, init_params
    from repro_torch.experiments import run_suite
    from repro_torch.store import ResultStore, SuiteSpec
    from repro_torch.store.cli import main as store_main
    from repro_torch.train import FaultTolerantTrainer

    plat = Platform(mu=2500.0, c=60.0, d=10.0, r=30.0)
    suite = {"suite": "s", "register": [], "items": [{"spec": {
        "name": "x", "scenario": {"n": 4096, "n_traces": 1},
        "strategies": [{"name": "rfo"}]}}]}
    trace = EventTrace(np.array([500.0]), np.zeros(1, dtype=np.int8), 1e5)
    return {
        "simulate_batch": lambda: simulate_batch([trace], plat, 1000.0,
                                                 [600.0]),
        "simulate_lanes": lambda: simulate_lanes(
            [trace], plat, 1000.0, cp=30.0, trace_indices=[0],
            periods=[600.0], trusts=[NeverTrust()], windows=[0.0],
            seeds=[0]),
        "evaluate_strategies": lambda: evaluate_strategies(
            [trace], plat, 1000.0, 30.0,
            [Strategy("s", 600.0, NeverTrust())]),
        "run_experiment": lambda: run_experiment(ExperimentSpec(
            "x", ScenarioSpec(n=4096, time_base_years_total=10.0,
                              n_traces=1), strategies=("rfo",))),
        "run_lanes_torch": lambda: run_lanes_torch(
            None, plat, 1000.0, np.zeros(1, np.int64), np.full(1, 600.0),
            np.zeros(1, np.int8), np.zeros(1), np.zeros(1),
            np.zeros(1, np.int64), 30.0),
        "FaultTolerantTrainer": lambda: FaultTolerantTrainer(
            get("tinyllama-1.1b").reduced(), InputShape("t", 8, 1, "train"),
            PlatformConfig(c=30.0, cp=10.0), workdir=tempfile.mkdtemp()),
        "init_params": lambda: init_params(get("tinyllama-1.1b").reduced()),
        "params_from_numpy": lambda: params_from_numpy(
            {"w": np.zeros((2, 2), np.float32)}),
        "init_cache": lambda: init_cache(get("tinyllama-1.1b").reduced(),
                                         1, 8),
        "serve_cli": lambda: serve_main(["--new-tokens", "1"]),
        "run_suite": lambda: run_suite(SuiteSpec.from_dict(suite),
                                       store=ResultStore(tempfile.mkdtemp())),
        "store_cli_run": lambda: store_main(
            ["--store", tempfile.mkdtemp(), "run",
             str(ROOT / "suites" / "quick_torch.json")]),
    }


@pytest.mark.parametrize("entry", ["simulate_batch", "simulate_lanes",
                                   "evaluate_strategies", "run_experiment",
                                   "run_lanes_torch",
                                   "FaultTolerantTrainer", "init_params",
                                   "params_from_numpy", "init_cache",
                                   "serve_cli", "run_suite",
                                   "store_cli_run"])
def test_no_silent_cpu_fallback(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[entry]()


def test_default_device_is_cuda(monkeypatch):
    from repro_torch import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device().type == "cuda"
    assert resolve_device("cpu").type == "cpu"


def test_redeclared_constants_match_reference():
    pytest.importorskip("jax")
    import repro.core.batch as ref_batch
    import repro.core.batch_jax as ref_bj
    import repro.core.simulator as ref_sim
    import repro.core.traces as ref_traces
    import repro.kernels.event_step as ref_es

    import repro_torch.core.batch as batch
    import repro_torch.core.batch_torch as bt
    import repro_torch.core.simulator as sim
    import repro_torch.core.traces as traces
    import repro_torch.kernels.event_step as es
    import repro_torch.kernels.lane_loop as ll

    assert es.F_FIELDS == ref_es.F_FIELDS and es.I_FIELDS == ref_es.I_FIELDS
    assert (es.N_F, es.N_I) == (ref_es.N_F, ref_es.N_I) == (23, 12)
    for name in [n for n in dir(ref_es) if n[:2] in ("F_", "I_")
                 and n not in ("F_FIELDS", "I_FIELDS")]:
        assert getattr(es, name) == getattr(ref_es, name), name
    phases = ("_WORK", "_CKPT", "_PROCKPT", "_DOWN", "_RECOVER", "_VERIFY")
    for name in phases:
        assert getattr(sim, name) == getattr(ref_sim, name) \
            == getattr(es, name) == getattr(ref_es, name), name
    for name in ("FAULT_UNPRED", "FAULT_PRED", "FALSE_PRED", "SILENT"):
        assert getattr(traces, name) == getattr(ref_traces, name), name
    assert sim.WINDOW_MODES == ref_sim.WINDOW_MODES
    # The lane engine keeps its window codes; its loop body (lane_loop)
    # the trust codes and the rest.
    codes = (("_TRUST_NEVER", ll), ("_TRUST_ALWAYS", ll),
             ("_TRUST_THRESHOLD", ll), ("_TRUST_FIXED_Q", ll),
             ("_WMODE_INSTANT", bt), ("_WMODE_WITHIN", bt))
    for name, mod in codes:
        assert getattr(batch, name) == getattr(ref_batch, name) \
            == getattr(mod, name) == getattr(ref_bj, name), name
    for name in ("_PC_POP", "_PC_FAULT", "_PC_PRED", "_PC_FINAL",
                 "_PC_SILENT", "_DEF_SLOTS", "_ADV_PASSES", "_BIG_SEQ"):
        assert getattr(ll, name) == getattr(ref_bj, name), name
    import repro.predictors.estimator as ref_est

    import repro_torch.predictors.estimator as est
    assert est.P_HAT_MIN == ref_est.P_HAT_MIN == ll.P_HAT_MIN
    # The estimator's rows follow the fixed ones and precede the slots,
    # one row each, so the slots stay last at any slot count.
    lf = [ll.LF_WINDOW, ll.LF_NTP, ll.LF_NFP, ll.LF_NUF, ll.LF_GS, ll.LF_GN,
          ll.LF_LASTF, ll.LF_PR, ll.LF_PP, ll.LF_PMU, ll.LF_DEC, ll.LF_MINP,
          ll.LF_MINF, ll.LF_TOL, ll.LF_DEF]
    li = [ll.LI_COUNTS + len(ll.COUNTS) - 1, ll.LI_ACT, ll.LI_ESTMU,
          ll.LI_NREPLANS, ll.LI_RESUME, ll.LI_DEFSEQ]
    assert lf == list(range(lf[0], lf[0] + len(lf)))
    assert li == list(range(li[0], li[0] + len(li)))


def test_redeclared_checkpoint_constants_match_reference(tmp_path):
    pytest.importorskip("jax")
    import repro.ckpt.manager as ref_manager
    import repro.kernels.ckpt_delta as ref_delta

    import repro_torch.ckpt.manager as manager
    import repro_torch.kernels.ckpt_delta as delta

    assert delta.BLOCK == ref_delta.BLOCK == 256
    assert manager.DELTA_RATIO_PRIOR == ref_manager.DELTA_RATIO_PRIOR
    port = manager.CheckpointManager(str(tmp_path / "p"))
    ref = ref_manager.CheckpointManager(str(tmp_path / "r"))
    assert port.block == ref.block and port.keep == ref.keep
    assert port.bandwidth == ref.bandwidth
    for step in (0, 7, 12345678):
        assert os.path.basename(port._full_path(step)) \
            == os.path.basename(ref._full_path(step))
        assert os.path.basename(port._delta_path(step)) \
            == os.path.basename(ref._delta_path(step))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "llama3.2-1b"])
def test_copied_configs_match_reference(arch):
    pytest.importorskip("jax")
    from repro.configs import get as ref_get
    from repro.configs.base import SHAPES as REF_SHAPES
    from repro.configs.base import PlatformConfig as RefPlatform
    from repro.configs.paper import SYNTHETIC as REF_SYNTHETIC

    from repro_torch.configs import get
    from repro_torch.configs.base import SHAPES, PlatformConfig
    from repro_torch.configs.paper import SYNTHETIC

    port, ref = get(arch), ref_get(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) \
        == dataclasses.asdict(ref.reduced())
    assert port.param_count() == ref.param_count()
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    long = SHAPES["long_500k"]
    assert dataclasses.asdict(port.for_shape(long)) \
        == dataclasses.asdict(ref.for_shape(REF_SHAPES["long_500k"]))
    assert dataclasses.asdict(PlatformConfig()) \
        == dataclasses.asdict(RefPlatform())
    assert dataclasses.asdict(SYNTHETIC) == dataclasses.asdict(REF_SYNTHETIC)
