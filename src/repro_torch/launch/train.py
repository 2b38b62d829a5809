"""Training launcher CLI: the fault-tolerant trainer on the card (or CPU).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --steps 200 --seq 128 --batch 8 --faults --workdir "$TMPDIR/ck"

The same flags as the JAX package's ``repro.launch.train``, plus
``--device`` (default: CUDA; ``--device cpu`` runs on the CPU).  It trains
every model family the port runs (dense, MoE, RG-LRU, xLSTM, the M-RoPE
VLM on token and patch batches, the encoder-only audio model on frames
with its masked-prediction loss).  Like the
reference, ``--reduced`` is declared ``store_true`` with default True, so
the CLI always runs the reduced config (logged in ROADMAP Queue C);
a full-width run goes through :class:`FaultTolerantTrainer` directly, as
``chip_smoke.py`` does.  Without ``--workdir`` the checkpoints go to a
fresh temporary directory (under ``$TMPDIR``), removed at the end.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile

import numpy as np

from repro_torch.configs import REGISTRY, get
from repro_torch.configs.base import InputShape, PlatformConfig
from repro_torch.configs.paper import SYNTHETIC
from repro_torch.core.traces import Exponential, Weibull, make_event_trace
from repro_torch.train import FaultTolerantTrainer


def cli_platform(step_time: float, mtbf: float) -> PlatformConfig:
    """The CLI's platform: C = 3 steps, C_p = 1 step, D = half a step,
    R = 1 step, the paper's synthetic predictor."""
    return PlatformConfig(
        mu_ind=mtbf, c=3.0 * step_time, cp=step_time, d=step_time / 2,
        r=step_time, recall=SYNTHETIC.recall, precision=SYNTHETIC.precision)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=sorted(REGISTRY))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--workdir", default=None,
                    help="checkpoint directory (default: a fresh temporary "
                         "directory, removed at the end)")
    ap.add_argument("--faults", action="store_true",
                    help="inject faults from a synthetic trace")
    ap.add_argument("--fault-dist", default="exponential",
                    choices=["exponential", "weibull"])
    ap.add_argument("--mtbf", type=float, default=600.0,
                    help="platform MTBF in virtual seconds")
    ap.add_argument("--step-time", type=float, default=10.0,
                    help="virtual seconds per training step")
    ap.add_argument("--no-predictor", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    if args.workdir is not None:
        run(args, args.workdir)
        return
    with tempfile.TemporaryDirectory(prefix="repro_ckpt_") as workdir:
        run(args, workdir)


def run(args: argparse.Namespace, workdir: str) -> None:
    """One trainer run of the parsed CLI flags, checkpointing to workdir."""
    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = InputShape("cli", args.seq, args.batch, "train")
    plat = cli_platform(args.step_time, args.mtbf)

    trace = None
    if args.faults:
        dist = Exponential(1.0) if args.fault_dist == "exponential" \
            else Weibull(0.7, 1.0)
        trace = make_event_trace(
            dist, args.mtbf, plat.recall, plat.precision,
            horizon=max(1e6, args.steps * args.step_time * 20),
            rng=np.random.default_rng(args.seed))

    trainer = FaultTolerantTrainer(
        cfg, shape, plat, workdir=workdir, step_time=args.step_time,
        trace=trace, use_predictor=not args.no_predictor, seed=args.seed,
        device=args.device)
    print(f"arch={cfg.name} device={trainer.device} "
          f"period T*={trainer.scheduler.period:.1f}s "
          f"use_pred={trainer.scheduler.decision.use_predictions} "
          f"beta_lim={trainer.scheduler.decision.beta_lim:.1f}s")
    stats = trainer.run(args.steps)
    print(json.dumps(dataclasses.asdict(stats), indent=1))
    print(f"waste={stats.waste:.4f} "
          f"(analytic {trainer.scheduler.decision.expected_waste:.4f})")


if __name__ == "__main__":
    main()
