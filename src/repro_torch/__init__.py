"""PyTorch/CUDA port of the checkpointing-with-prediction simulation study.

The counterpart of the JAX package ``repro``, which stays the reference.
The port imports torch and numpy only, never jax and nothing of ``repro``.
Its entry points run on CUDA unless the caller passes ``device="cpu"``;
there is no silent fallback (:func:`resolve_device`).

Main path: :class:`ScenarioSpec` -> traces -> :func:`evaluate_strategies`
(or :func:`simulate_batch` / :func:`simulate_lanes`) -> the torch lane
engine, whose schedule step is the hand-written CUDA kernel
``kernels/csrc/event_step.cu``.
"""

from .core.batch import BatchResult, simulate_batch, simulate_lanes
from .core.policies import Strategy, optimal_prediction, rfo
from .device import resolve_device
from .experiments import BestPeriodSearch, ScenarioSpec, evaluate_strategies

__all__ = ["BatchResult", "BestPeriodSearch", "ScenarioSpec", "Strategy",
           "evaluate_strategies", "optimal_prediction", "resolve_device",
           "rfo", "simulate_batch", "simulate_lanes"]
