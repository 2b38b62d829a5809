"""The lower-precision control: the reference in the program's place,
computed in float32 (the precision below the deployment's float64).

Layer by layer, what the judge reads of a pass comes from the reference
held in float32: the candidates' periods and thresholds rounded to
float32, the sampled lanes run by the reference loop in float32, and the
strategies' means as float32 trace-order sums over the pass's makespans.
The judge (``judge.py``) must find the control not correct.  Plain
NumPy; imports nothing of the program.
"""

from __future__ import annotations

import types

import numpy as np

from . import judge, policies, simulate

F32 = np.float32


def _mean32(row) -> float:
    total = F32(0.0)
    for x in row:
        total += F32(x)
    return float(total / F32(max(1, len(row))))


def _best32(makespans, rows) -> list[float]:
    out = []
    for cand_rows in rows:
        means = [_mean32(makespans[j]) for j in cand_rows]
        out.append(means[int(np.argmin(means))])
    return out


def view(cfg: dict, strategies: list, pool: list, passes: list,
         picks: list) -> tuple[list, list]:
    """``(candidates, passes)`` of the control, in the shapes the judge
    takes from the program; ``passes`` are the program's, whose sampled
    lanes and means the control replaces."""
    ref_cands, ref_rows = policies.candidates(judge.platform(cfg),
                                              strategies)
    cands = [(float(F32(p)), None if thr is None else float(F32(thr)))
             for p, thr in ref_cands]
    out = []
    for out_pass in passes:
        res = out_pass["result"]
        fields = {f: np.array(getattr(res, f), copy=True)
                  for f in simulate.FIELDS}
        out.append({"traces": out_pass["traces"],
                    "result": types.SimpleNamespace(**fields),
                    "means": _best32(fields["makespan"], ref_rows)})
    for p, c, t in picks:
        lane = judge.reference_lane(cfg, pool[out[p]["traces"][t]],
                                    ref_cands[c], F=F32)
        for f, v in lane.items():
            out[p]["result"].__dict__[f][c, t] = v
    return cands, out
