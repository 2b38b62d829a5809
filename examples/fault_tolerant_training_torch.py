"""End-to-end driver on the PyTorch port: train a ~100M-param model for a
few hundred steps under injected faults with the paper's optimal
checkpoint schedule.

The port's copy of ``examples/fault_tolerant_training.py``.

Phase 1 (flagship): a ~100M-parameter xLSTM variant (d_model widened to
896, 10 layers, full 50k vocab) trains for --steps steps with Weibull
faults injected on a virtual clock.  Every rollback restores real
parameters/optimizer state from disk; proactive checkpoints are
delta-quantized (the C_p < C path) by the ``ckpt_delta`` kernels on the
card.  Loss must decrease and the measured waste is compared with the
scheduler's analytic prediction.

Phase 2 (policy comparison): the same trace replayed against three
policies — Young (no predictor), RFO (no predictor), OptimalPrediction —
on the fast reduced config, reproducing the paper's ordering end-to-end.

Run:  PYTHONPATH=src python examples/fault_tolerant_training_torch.py \\
          [--steps 200] [--phase 1|2|all] [--device cpu]

Runs on CUDA unless ``--device cpu`` is given.
"""

import argparse
import dataclasses
import tempfile

import numpy as np

from repro_torch.configs import get
from repro_torch.configs.base import InputShape, PlatformConfig
from repro_torch.core.traces import Weibull, make_event_trace
from repro_torch.core.waste import Platform, t_young
from repro_torch.train import FaultTolerantTrainer


def flagship_cfg():
    """~100M-parameter xLSTM (widened to d_model=896, 10 layers)."""
    cfg = get("xlstm-125m")
    cfg = dataclasses.replace(cfg, n_layers=10, d_model=896, head_dim=224,
                              name="xlstm-100m-demo", remat=False)
    return cfg


def phase1(steps: int, device=None) -> dict:
    cfg = flagship_cfg()
    shape = InputShape("e2e", 128, 1, "train")
    print(f"== Phase 1: {cfg.name} (~{cfg.param_count()/1e6:.0f}M params), "
          f"{steps} steps, {shape.global_batch}x{shape.seq_len} tokens/step")
    plat = PlatformConfig(mu_ind=900.0, c=60.0, cp=20.0, d=10.0, r=30.0,
                          recall=0.85, precision=0.82)
    trace = make_event_trace(Weibull(0.7, 1.0), 900.0, 0.85, 0.82,
                             horizon=1e6, rng=np.random.default_rng(7))
    with tempfile.TemporaryDirectory() as d:
        tr = FaultTolerantTrainer(cfg, shape, plat, workdir=d,
                                  step_time=20.0, trace=trace, seed=0,
                                  device=device)
        print(f"   schedule: T*={tr.scheduler.period:.0f}s "
              f"beta_lim={tr.scheduler.decision.beta_lim:.1f}s "
              f"analytic waste={tr.scheduler.decision.expected_waste:.3f}")
        first_loss = None

        orig = tr._do_step

        def logged(stats):
            nonlocal first_loss
            m = orig(stats)
            step = int(tr.state["data_step"])
            if first_loss is None:
                first_loss = float(m["loss"])
            if step % 25 == 0:
                print(f"   step {step:4d} loss {float(m['loss']):.3f} "
                      f"(faults so far: {stats.n_faults})", flush=True)
            return m

        tr._do_step = logged
        stats = tr.run(steps)
    print(f"   secured {stats.n_steps} steps | faults {stats.n_faults} | "
          f"periodic {stats.n_periodic} | proactive {stats.n_proactive} "
          f"({stats.n_trusted_true} true)")
    print(f"   loss {first_loss:.3f} -> {stats.final_loss:.3f} | "
          f"measured waste {stats.waste:.3f}")
    assert stats.final_loss < first_loss, "loss must decrease"
    return {"cfg": cfg, "stats": stats, "first_loss": first_loss}


def phase2(steps: int, device=None) -> dict:
    print(f"\n== Phase 2: policy comparison (reduced config, {steps} steps)")
    cfg = get("llama3.2-1b").reduced()
    shape = InputShape("cmp", 64, 4, "train")
    plat = PlatformConfig(mu_ind=500.0, c=60.0, cp=20.0, d=10.0, r=30.0,
                          recall=0.85, precision=0.82)
    trace = make_event_trace(Weibull(0.7, 1.0), 500.0, 0.85, 0.82,
                             horizon=3e5, rng=np.random.default_rng(7))

    results = {}
    with tempfile.TemporaryDirectory() as d:
        young_T = t_young(Platform(mu=500.0, c=60.0, d=10.0, r=30.0))
        for name, use_pred, override in (
                ("Young", False, young_T),
                ("RFO", False, None),
                ("OptimalPrediction", True, None)):
            tr = FaultTolerantTrainer(cfg, shape, plat,
                                      workdir=f"{d}/{name}",
                                      step_time=20.0, trace=trace, seed=0,
                                      use_predictor=use_pred, device=device)
            if override is not None:
                tr.scheduler.decision = dataclasses.replace(
                    tr.scheduler.decision, period=override,
                    use_predictions=False)
            stats = tr.run(steps)
            results[name] = stats
            print(f"   {name:20s} waste={stats.waste:.3f} "
                  f"makespan={stats.total_time:7.0f}s "
                  f"faults={stats.n_faults} proactive={stats.n_proactive} "
                  f"loss={stats.final_loss:.3f}")
    gain = 100 * (1 - results["OptimalPrediction"].total_time
                  / results["RFO"].total_time)
    print(f"   OptimalPrediction vs RFO: {gain:.1f}% shorter makespan")
    assert results["OptimalPrediction"].waste <= results["RFO"].waste + 0.02
    return results


def main(steps: int = 200, phase: str = "all", device=None) -> dict:
    out = {}
    if phase in ("1", "all"):
        out["phase1"] = phase1(steps, device=device)
    if phase in ("2", "all"):
        out["phase2"] = phase2(min(steps, 120), device=device)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--phase", default="all", choices=["1", "2", "all"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the CPU)")
    args = ap.parse_args()
    main(steps=args.steps, phase=args.phase, device=args.device)
