"""Fault-tolerant training loop: the paper's policy wired to real state.

The port of ``repro/train/loop.py:49-253``.  The trainer executes real
train steps (model forward, ``backward``, then the port's AdamW) on the
device (the host batch of :class:`SyntheticLM`, tokens, VLM patches and
positions or audio frames, labels and mask, moved there by the model and
the loss) and overlays the paper's fault/checkpoint schedule on a virtual
clock:

  * every step costs ``step_time`` virtual seconds (measured on the card
    when ``step_time`` is None);
  * periodic checkpoints of cost C follow the scheduler's period T*
    (RFO or OptimalPrediction);
  * trusted predictions trigger proactive checkpoints (cost C_p, int8
    delta-encoded by the ``ckpt_delta`` kernels) timed to complete exactly
    at the predicted date (§4.1);
  * injected faults roll the real training state back to the last durable
    checkpoint: parameters and optimizer state are restored from disk, the
    deterministic data stream replays from the restored step, and the
    clock pays D + R.

The virtual-clock logic (steps 1-5 of :meth:`run`, :meth:`_save` and
:meth:`_rollback`) is a line-for-line copy of the reference, so the port
trainer takes the reference's decisions and its :class:`TrainerStats`
counters and virtual times are the reference's for the same trace.  One
reference behaviour is kept on purpose: a fault before the first save
restarts from the init of seed 0, whatever the trainer's seed
(``loop.py:182``, logged in ROADMAP Queue C).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from ..ckpt.manager import CheckpointManager
from ..configs.base import InputShape, ModelConfig, PlatformConfig
from ..core.traces import EventTrace
from ..data.pipeline import DataConfig, SyntheticLM
from ..device import resolve_device
from ..ft.runtime import (FaultInjector, Prediction, PredictorRuntime,
                          VirtualClock)
from ..ft.scheduler import CheckpointScheduler
from ..models.model import init_params, loss_fn
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..tree import flatten, unflatten

__all__ = ["TrainerStats", "FaultTolerantTrainer"]


@dataclasses.dataclass
class TrainerStats:
    """Measured waste breakdown (same axes as the paper's simulator)."""

    total_time: float = 0.0
    useful_time: float = 0.0     # first-execution step time
    lost_time: float = 0.0       # re-executed (destroyed) step time
    ckpt_time: float = 0.0
    prockpt_time: float = 0.0
    down_time: float = 0.0
    n_steps: int = 0
    n_faults: int = 0
    n_rollbacks: int = 0
    n_periodic: int = 0
    n_proactive: int = 0
    n_trusted_true: int = 0
    final_loss: float = float("nan")

    @property
    def waste(self) -> float:
        return 1.0 - self.useful_time / self.total_time \
            if self.total_time > 0 else 0.0


class FaultTolerantTrainer:
    """End-to-end trainer with faults, predictions and optimal checkpoints.

    ``device=None`` means CUDA and raises without a card; ``device="cpu"``
    runs on the CPU.
    """

    def __init__(self, cfg: ModelConfig, shape: InputShape,
                 platform: PlatformConfig, *, workdir: str,
                 n_devices: int = 1, step_time: float | None = None,
                 trace: EventTrace | None = None, lead_time: float = 0.0,
                 use_predictor: bool = True, seed: int = 0,
                 opt: AdamWConfig | None = None,
                 data_cfg: DataConfig | None = None,
                 device: str | torch.device | None = None) -> None:
        self.device = resolve_device(device)
        self.cfg = cfg
        self.shape = shape
        self.platform = platform
        self.opt_cfg = opt or AdamWConfig(moment_dtype=cfg.opt_dtype)
        self.data = SyntheticLM(cfg, shape, data_cfg or DataConfig(seed=seed))
        self.manager = CheckpointManager(workdir,
                                         bandwidth=platform.ckpt_bandwidth)
        self.state: dict[str, Any] = self.init_state(seed)

        c, cp = platform.c, platform.cp
        if c <= 0:  # derive from state bytes / bandwidth (TPU_V5E preset)
            c, cp = self.manager.modeled_costs(self.state,
                                               n_shards=n_devices)
        self.scheduler = CheckpointScheduler(
            platform, n_devices, c=c, cp=cp, use_predictor=use_predictor)

        self.clock = VirtualClock()
        self.injector = FaultInjector(trace) if trace is not None else None
        self._trace = trace
        self._lead_time = lead_time
        self._use_predictor = use_predictor
        self.predictor = None  # built in run() once step_time is known
        self._step_time = step_time

    # -- helpers ---------------------------------------------------------------

    def init_state(self, seed: int) -> dict[str, Any]:
        """A fresh train state: params of ``seed``, zero moments, step 0."""
        params = init_params(self.cfg, seed, self.device)
        return {"params": params,
                "opt": adamw_init(params, self.opt_cfg),
                "data_step": torch.zeros((), dtype=torch.int32,
                                         device=self.device)}

    def _train_step(self, params: Any, opt_state: dict, batch: dict
                    ) -> tuple[Any, dict, dict]:
        """Loss, gradients and one AdamW update; new tensors throughout."""
        leaves = [p.detach().requires_grad_() for p in flatten(params)]
        loss, metrics = loss_fn(self.cfg, unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        metrics = {k: v.detach() for k, v in metrics.items()}
        del loss, leaves
        new_params, new_opt, opt_metrics = adamw_update(
            params, unflatten(params, list(grads)), opt_state, self.opt_cfg)
        return new_params, new_opt, {**metrics, **opt_metrics}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _measure_step_time(self) -> float:
        batch = self.data.batch_at(0)
        self._train_step(self.state["params"], self.state["opt"],
                         batch)  # warm up
        self._sync()
        t0 = time.perf_counter()
        self._train_step(self.state["params"], self.state["opt"], batch)
        self._sync()
        return time.perf_counter() - t0

    def _do_step(self, stats: TrainerStats) -> dict:
        step = int(self.state["data_step"])
        batch = self.data.batch_at(step)
        params, opt, metrics = self._train_step(
            self.state["params"], self.state["opt"], batch)
        self.state = {"params": params, "opt": opt,
                      "data_step": torch.tensor(step + 1, dtype=torch.int32,
                                                device=self.device)}
        return metrics

    def _save(self, stats: TrainerStats, *, proactive: bool,
              complete_at: float | None = None) -> None:
        cost = self.scheduler.cp if proactive else self.scheduler.c
        if complete_at is not None:
            # Stall work so the save completes exactly at the predicted date.
            idle = complete_at - cost - self.clock.now
            if idle > 0:
                self.clock.advance(idle)
        step = int(self.state["data_step"])
        if proactive:
            self.manager.save_proactive(step, self.state)
            stats.prockpt_time += cost
            stats.n_proactive += 1
        else:
            self.manager.save(step, self.state)
            stats.ckpt_time += cost
            stats.n_periodic += 1
        self.clock.advance(cost)
        self.scheduler.notify_save_completed(self.clock.now)
        self._work_since_save = 0.0

    def _rollback(self, stats: TrainerStats, fault_time: float) -> None:
        stats.n_faults += 1
        stats.n_rollbacks += 1
        # Destroyed work: completed-but-unsaved steps plus the partial step
        # that was in flight when the fault struck.
        partial = max(0.0, fault_time - self.clock.now)
        stats.lost_time += self._work_since_save + partial
        stats.useful_time -= self._work_since_save
        self._work_since_save = 0.0
        if fault_time > self.clock.now:
            self.clock.advance(fault_time - self.clock.now)
        self.clock.advance(self.platform.d + self.platform.r)
        stats.down_time += self.platform.d + self.platform.r
        try:
            _, self.state = self.manager.restore(like=self.state)
        except FileNotFoundError:
            # No checkpoint yet: restart from scratch (the reference
            # restarts from seed 0's init, whatever the trainer's seed).
            self.state = self.init_state(0)
        self.scheduler.notify_save_completed(self.clock.now)

    # -- the loop ---------------------------------------------------------------

    def run(self, n_steps: int) -> TrainerStats:
        """Train until ``n_steps`` *useful* steps are secured."""
        stats = TrainerStats()
        if self._step_time is None:
            self._step_time = self._measure_step_time()
        dt = self._step_time
        if self.predictor is None and self._trace is not None \
                and self._use_predictor:
            # Steps are atomic: a prediction announced mid-step can only be
            # acted on once the step completes, so the minimum usable lead
            # time is C_p + one step (predictions with shorter leads count
            # as unpredicted faults, exactly the paper's §2.2 rule).
            lead = max(self._lead_time, self.scheduler.cp + dt)
            self.predictor = PredictorRuntime(self._trace, lead)
        self._work_since_save = 0.0
        metrics: dict = {}

        while int(self.state["data_step"]) < n_steps:
            t0 = self.clock.now
            t1 = t0 + dt

            # 1. Does a fault strike during this step?
            fault = (self.injector.next_fault_in(t0, t1)
                     if self.injector else None)
            if fault is not None:
                self._rollback(stats, fault)
                continue

            # 2. Predictions announced during this step.  Steps are atomic,
            #    so the reaction happens right after the step; the lead-time
            #    floor above guarantees date - C_p >= t1.
            planned: Prediction | None = None
            if self.predictor is not None:
                for pred in self.predictor.announced_in(t0, t1):
                    if pred.date - self.scheduler.cp < t1:
                        continue  # too late to honour: ignore by necessity
                    if self.scheduler.trust(pred.date):
                        planned = pred
                        break  # one proactive save covers this window

            # 3. Execute the real step.
            metrics = self._do_step(stats)
            self.clock.advance(dt)
            stats.useful_time += dt
            self._work_since_save += dt
            stats.n_steps += 1

            # 4. Take the planned proactive checkpoint, completing exactly
            #    at the predicted date (§4.1).
            if planned is not None:
                self._save(stats, proactive=True, complete_at=planned.date)
                if planned.is_true:
                    stats.n_trusted_true += 1

            # 5. Periodic checkpoint when due.
            if self.scheduler.due(self.clock.now):
                self._save(stats, proactive=False)

        # Final checkpoint (the paper checkpoints at the end of execution).
        self._save(stats, proactive=False)
        stats.total_time = self.clock.now
        if "loss" in metrics:
            stats.final_loss = float(metrics["loss"])
        return stats
