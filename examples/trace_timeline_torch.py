"""Waste-attribution telemetry end-to-end on the PyTorch port: trace a
contended fleet run and export a Perfetto-loadable timeline.

The port's copy of ``examples/trace_timeline.py``.  Three jobs with
predicted faults share one storage stream and one repair slot.  Each job
carries a :class:`repro_torch.obs.RecordingSink`, so every checkpoint,
proactive checkpoint, fault, rollback, re-execution span,
downtime/recovery window, prediction arrival and trust decision lands in
a structured event stream.  The script then:

  1. prints the per-job waste attribution — every simulated second
     bucketed into {work, ckpt, proactive_ckpt, re_exec, downtime,
     recovery, wait}, summing to the makespan *bit-for-bit*;
  2. writes ``trace_timeline.json``, a Chrome ``trace_event`` file: load
     it at https://ui.perfetto.dev (or chrome://tracing).  Jobs are
     tracks; checkpoints/downtime/recovery are slices; faults,
     rollbacks, predictions and trust decisions are instants.  One trace
     microsecond equals one simulated second.

The fleet simulator is host code (event by event, as in the reference),
so this example runs on the CPU wherever it is started; the file it
writes is byte for byte the reference example's.

Run:  PYTHONPATH=src python examples/trace_timeline_torch.py [OUT.json]
"""

import sys

import numpy as np

from repro_torch.experiments import ScenarioSpec, StrategySpec
from repro_torch.fleet.sim import FleetJobInput, simulate_fleet
from repro_torch.obs import RecordingSink, attribute_fleet_job, write_trace

N_JOBS = 3


def main(out_path: str = "trace_timeline.json") -> dict:
    scenario = ScenarioSpec(n=2 ** 16, c=600.0, d=60.0, r=600.0,
                            n_traces=N_JOBS,
                            time_base_years_total=2000.0, seed=5)
    strat = StrategySpec("optimal_prediction").build(scenario)
    traces = scenario.make_traces()

    sinks = [RecordingSink() for _ in traces]
    fleet = simulate_fleet(
        [FleetJobInput(trace=tr, platform=scenario.platform,
                       time_base=scenario.time_base, period=strat.period,
                       cp=scenario.cp, trust=strat.trust,
                       rng=np.random.default_rng(scenario.seed + 7919 * i),
                       name=f"job{i}", sink=sinks[i])
         for i, tr in enumerate(traces)],
        storage_streams=1, repair_slots=1)

    print(f"fleet of {N_JOBS} jobs, 1 storage stream, 1 repair slot "
          f"(T={strat.period:.0f}s)")
    print(f"{'job':>6} {'makespan':>12}  work%  ckpt% prock%  reex%  "
          f"down%   rec%  wait%   events")
    attributions = []
    for job, sink in zip(fleet.jobs, sinks):
        att = attribute_fleet_job(job)
        assert att.total() == job.sim.makespan  # exact bucket closure
        attributions.append(att)
        f = att.fractions()
        print(f"{job.name:>6} {job.sim.makespan:>12.1f} "
              + " ".join(f"{100 * f[b]:>6.2f}"
                         for b in ("work", "ckpt", "proactive_ckpt",
                                   "re_exec", "downtime", "recovery",
                                   "wait"))
              + f" {len(sink):>8}")

    write_trace(out_path,
                [(j.name, s.events) for j, s in zip(fleet.jobs, sinks)],
                title="fleet")
    print(f"\nwrote {out_path} — open it at https://ui.perfetto.dev")
    return {"fleet": fleet, "sinks": sinks, "attributions": attributions,
            "path": out_path}


if __name__ == "__main__":
    main(*sys.argv[1:2])
