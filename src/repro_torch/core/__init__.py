"""Host-side models, the scalar oracle and the lane engine of the port.

Layers (each the port's own copy of the JAX package's module of the same
name, except the engine):
  waste.py       Young/Daly/RFO periods, first-order waste model, exact
                 Exponential optimum (Lambert W).
  prediction.py  predictor algebra, WASTE1/WASTE2 (Eq. 15), Theorem 1
                 breakpoint beta_lim = C_p/p, optimal periods.
  exact.py       exact-Exponential renewal analysis (arXiv:1207.6936).
  multilevel.py  two-level (hierarchical) checkpointing: first-order model,
                 (T1*, k*) optimum and its own simulator.
  windows.py     prediction windows (arXiv:1302.4558).
  silent.py      silent errors and verifications (arXiv:1310.8486).
  traces.py      fault / prediction trace generation, per trace and in
                 banks.
  simulator.py   the scalar event loop (the oracle).
  batch.py       the lane engine's front; batch_torch.py its torch
                 engine, whose loop is the hand-written lane_loop_kernel
                 on CUDA.
  policies.py    the compared strategies incl. BestPeriod search.
"""

from . import (batch, exact, multilevel, policies, prediction, silent,
               simulator, traces, waste, windows)
from .batch import BatchResult, lane_results, simulate_batch, simulate_lanes
from .exact import (ExactPlan, beta_lim_exact, optimal_period_exact,
                    t_exact_nopred, waste_exact_nopred,
                    waste_exact_prediction)
from .multilevel import (TwoLevelPlatform, TwoLevelResult,
                         optimal_two_level, simulate_two_level,
                         two_level_stream, waste_two_level)
from .prediction import (PredictedPlatform, Predictor, beta_lim,
                         optimal_period_with_prediction, t_pred,
                         t_pred_asymptotic, waste1, waste2,
                         waste_with_prediction)
from .silent import SilentPlan, optimal_silent_plan, silent_strategy
from .simulator import SimResult, average_makespan, simulate
from .traces import (EventTrace, Exponential, UniformDist, Weibull,
                     make_event_trace, make_event_trace_bank)
from .waste import Platform, platform_mtbf, t_daly, t_rfo, t_young
from .windows import (WindowPlan, beta_lim_window, optimal_window_plan,
                      t_window_period, waste_window, window_strategy)

__all__ = [
    "batch", "exact", "multilevel", "policies", "prediction", "silent",
    "simulator", "traces", "waste", "windows",
    "TwoLevelPlatform", "TwoLevelResult", "optimal_two_level",
    "simulate_two_level", "two_level_stream", "waste_two_level",
    "BatchResult", "lane_results", "simulate_batch", "simulate_lanes",
    "ExactPlan", "beta_lim_exact", "optimal_period_exact", "t_exact_nopred",
    "waste_exact_nopred", "waste_exact_prediction",
    "Platform", "Predictor", "PredictedPlatform", "EventTrace", "SimResult",
    "Exponential", "Weibull", "UniformDist",
    "platform_mtbf", "t_young", "t_daly", "t_rfo", "beta_lim",
    "optimal_period_with_prediction", "t_pred", "t_pred_asymptotic",
    "waste1", "waste2", "waste_with_prediction",
    "make_event_trace", "make_event_trace_bank", "simulate",
    "average_makespan",
    "SilentPlan", "optimal_silent_plan", "silent_strategy",
    "WindowPlan", "beta_lim_window", "optimal_window_plan", "t_window_period",
    "waste_window", "window_strategy",
]
