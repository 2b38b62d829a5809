"""PyTorch/CUDA port of the checkpointing-with-prediction system.

The counterpart of the JAX package ``repro``, which stays the reference.
The port imports torch and numpy only, never jax and nothing of ``repro``.
Its entry points run on CUDA unless the caller passes ``device="cpu"``;
there is no silent fallback (:func:`resolve_device`).

Ported so far:

* the simulation study: :class:`ScenarioSpec` -> traces ->
  :func:`evaluate_strategies` (or :func:`simulate_batch` /
  :func:`simulate_lanes`) -> the torch lane engine, whose loop is the
  hand-written CUDA kernel ``lane_loop_kernel`` in
  ``kernels/csrc/event_step.cu``;
* the paper's experiment layer:
  :class:`repro_torch.experiments.ExperimentSpec` ->
  :func:`repro_torch.experiments.run_experiment` -> a ``ResultTable``,
  over every registered strategy (the lanes for constant periods, the
  scalar oracle :func:`repro_torch.core.simulator.simulate` for dynamic
  ones);
* the fault-tolerant trainer: ``launch/train.py`` ->
  :class:`repro_torch.train.FaultTolerantTrainer` (a dense decoder,
  AdamW, the synthetic stream, the scheduler and the checkpoint manager),
  whose proactive saves and delta restores run the hand-written CUDA
  kernels ``kernels/csrc/ckpt_delta.cu``;
* the serving engine: ``launch/serve.py`` ->
  :class:`repro_torch.serve.ServingEngine`, whose decode steps run
  ``kernels/csrc/decode_attention.cu`` (and ``forward_train`` runs
  ``kernels/csrc/flash_attention.cu``).
"""

from .core.batch import BatchResult, simulate_batch, simulate_lanes
from .core.policies import Strategy, optimal_prediction, rfo
from .device import resolve_device
from .experiments import BestPeriodSearch, ScenarioSpec, evaluate_strategies

__all__ = ["BatchResult", "BestPeriodSearch", "ScenarioSpec", "Strategy",
           "evaluate_strategies", "optimal_prediction", "resolve_device",
           "rfo", "simulate_batch", "simulate_lanes"]
