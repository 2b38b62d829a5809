"""Fleet availability subsystem: N heterogeneous jobs, shared limits.

Layers (each importable on its own):

  * :mod:`repro_torch.fleet.availability` — the analytic availability model
    (availability-optimal interval, beta_A trust breakpoint, measured
    weighted-outage accounting);
  * :mod:`repro_torch.fleet.sim` — the fleet discrete-event engine (storage
    contention + repair slots over the exact single-job mechanics);
  * :mod:`repro_torch.fleet.spec` — declarative fleet specs + the model-zoo
    job sizing helper;
  * :mod:`repro_torch.fleet.plan` — per-job planning under a shared objective,
    with bandwidth-aware staggering;
  * :mod:`repro_torch.fleet.experiment` — ``evaluate_fleet`` producing per-tenant
    SLO result tables.

The port's own copy of ``repro/fleet``: every module keeps the JAX
package's floating-point operations in the same order over the port's
oracle (``core/simulator.py``), so fleet rows are bitwise the JAX
package's on the same specs.
"""

from .availability import (OutageWeights, beta_avail,
                                      measured_unavailability,
                                      optimal_period_availability,
                                      t_avail_nopred, t_avail_pred,
                                      unavailability, unavailability_nopred,
                                      unavailability_pred)
from .experiment import evaluate_fleet, fleet_run_results
from .plan import (JobPlan, plan_fleet, plan_job,
                              staggered_period)
from .sim import (FleetJobInput, FleetJobResult, FleetSimResult,
                             simulate_fleet)
from .spec import (STATE_BYTES_PER_PARAM, FleetJobSpec, FleetSpec,
                              job_from_model)

__all__ = [
    "OutageWeights", "beta_avail", "measured_unavailability",
    "optimal_period_availability", "t_avail_nopred", "t_avail_pred",
    "unavailability", "unavailability_nopred", "unavailability_pred",
    "evaluate_fleet", "fleet_run_results",
    "JobPlan", "plan_fleet", "plan_job", "staggered_period",
    "FleetJobInput", "FleetJobResult", "FleetSimResult", "simulate_fleet",
    "FleetJobSpec", "FleetSpec", "job_from_model",
    "STATE_BYTES_PER_PARAM",
]
