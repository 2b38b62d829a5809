"""Frozen roofline arithmetic of the lane loop on an NVIDIA H100 SXM.

The least time the card could take for one study pass is the larger of
(a) the float64 operations the pass's lanes need over the card's float64
rate and (b) the bytes the pass must move over its memory rate.  Both
count the work whatever implements the loop:

(a) Each lane event of the pass's results is charged the float64
    operations (adds, subtracts, multiplies, divides, compares, min and
    max) that the reference loop body (``simulate.py``) does for it at
    the least:

    * a periodic checkpoint, 19: the work step that ends the period (the
      loop test, the work-left test, ``target - now``, a two-way min, the
      three updates of now, done and the work left, the end-of-work test,
      the checkpoint's end date) and the checkpoint's completion (the two
      loop tests, ``t_ckpt += C``, ``time_base - eps`` and its test, the
      next period's work ``max(eps, T - C)`` and ``min(., time_base -
      saved)``);
    * a fault that strikes, 5: the lost work, the phase-end test, the lost
      time's update, the rollback test and the downtime's end date;
    * a rollback (a fault that lost work), 9 more: the partial work step
      up to the fault;
    * a prediction, 2: the proactive checkpoint's start date and the test
      that it is not past;
    * a proactive checkpoint, 14: the partial work step up to its start
      (9), the offset and the trust test (2), its completion (3).

(b) The bank's events, 9 bytes each (a float64 date and its kind), each
    lane's inputs (its period, trust threshold and trace index: 24 bytes)
    and its 26 float64 results (208 bytes), each byte counted once.

Peaks: NVIDIA's H100 SXM5 data sheet, float64 outside the tensor cores
and HBM3, at the full 700 W.
"""

from __future__ import annotations

FP64_FLOP_PER_S = 34e12
HBM_BYTES_PER_S = 3.35e12

OPS_PER_EVENT = {"n_periodic_ckpts": 19, "n_faults_hit": 5,
                 "n_rollbacks": 9, "n_predictions": 2,
                 "n_proactive_ckpts": 14}
EVENT_BYTES = 9
LANE_INPUT_BYTES = 24
LANE_RESULT_BYTES = 26 * 8


def pass_ops(counts: dict) -> int:
    """Float64 operations of a pass from its summed lane event counts."""
    return sum(OPS_PER_EVENT[k] * int(counts[k]) for k in OPS_PER_EVENT)


def pass_bytes(bank_events: int, n_lanes: int) -> int:
    """Bytes a pass moves: its bank's events, the lanes' inputs and
    results."""
    return (EVENT_BYTES * int(bank_events)
            + (LANE_INPUT_BYTES + LANE_RESULT_BYTES) * int(n_lanes))


def least_seconds(ops: int, nbytes: int) -> float:
    """The least time of the work on the card: the larger bound."""
    return max(ops / FP64_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)
