"""Waste attribution: bucket every simulated second into a paper term.

The engines' accrual-exact accounting (see ``_Machine.fault``) already
decomposes the makespan as ``base + ckpt + prockpt + lost + down``; this
module re-expresses that decomposition in the paper's vocabulary —

    {work, ckpt, proactive_ckpt, verify, re_exec, downtime, recovery, wait}

— with the invariant ``sum(buckets) == makespan`` **bit-for-bit**.  The
``work`` bucket is the closure term (makespan minus the overhead
buckets, subtracted in a fixed order); ``total()`` re-adds the same
terms in the exact reverse order, and the constructor repairs the
residual ulp when the float round-trip lands one off, so the invariant
holds exactly, not approximately.

``downtime``/``recovery`` come from the engines' independent split
accumulators (``SimResult.time_downtime`` / ``time_recovery``); the
merged ``time_down`` stays the authoritative golden-parity accrual and
is *not* used in bucket math.  ``verify`` is the silent-error
verification accrual (``SimResult.time_verify``; 0 unless the run used
``n_verify >= 1``, and read with a 0 default so pre-silent result
objects still attribute).  ``wait`` is the fleet-level coupling cost
(storage contention stretch + repair-queue waiting); it is 0 for
single-job runs.

:func:`expected_fractions` gives the paper's first-order expectation of
each bucket as a fraction of the makespan — ``C/T`` checkpointing,
``D/mu`` downtime, ``R/mu`` recovery, ``T/2mu`` re-execution (Eq. 7),
and with a predictor the refined-policy terms of Eq. 15 /
``unavailability_pred`` — so a measured attribution reconciles
term-by-term against ``waste1``/``waste2`` instead of only in aggregate.

The port's own copy of ``repro/obs/attribution.py``: the same closure
loop and the same operations in the same order, so the buckets are
bitwise the JAX package's on the same lanes; ``expected_fractions`` uses
the port's ``core/prediction.py::beta_lim``.  The repair does not always
converge: on some lanes no ``work`` makes the fold land on the makespan,
and the attribution raises there as the JAX package's does;
:func:`attribute_lanes` says which lanes close.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

__all__ = ["BUCKETS", "WasteAttribution", "attribute_result",
           "attribute_fleet_job", "attribute_batch", "attribute_lanes",
           "expected_fractions"]

BUCKETS = ("work", "ckpt", "proactive_ckpt", "verify", "re_exec",
           "downtime", "recovery", "wait")

# The overhead buckets in the fixed fold order total()/closure use.
_OVERHEADS = BUCKETS[1:]


@dataclasses.dataclass(frozen=True)
class WasteAttribution:
    """Per-run (or per-job) bucketed decomposition of the makespan."""

    makespan: float
    work: float
    ckpt: float
    proactive_ckpt: float
    verify: float
    re_exec: float
    downtime: float
    recovery: float
    wait: float = 0.0

    def total(self) -> float:
        """Left-fold sum of the buckets — equals ``makespan`` exactly."""
        tot = self.work
        for name in _OVERHEADS:
            tot += getattr(self, name)
        return tot

    def buckets(self) -> dict[str, float]:
        return {name: getattr(self, name) for name in BUCKETS}

    def fractions(self) -> dict[str, float]:
        """Bucket shares of the makespan (0 if the run is empty)."""
        if self.makespan <= 0.0:
            return {name: 0.0 for name in BUCKETS}
        return {name: getattr(self, name) / self.makespan
                for name in BUCKETS}

    def waste_fraction(self) -> float:
        """Share of the makespan not spent on useful work."""
        if self.makespan <= 0.0:
            return 0.0
        return 1.0 - self.work / self.makespan


def _close(makespan: float, ckpt: float, proactive_ckpt: float,
           verify: float, re_exec: float, downtime: float,
           recovery: float, wait: float) -> WasteAttribution:
    """Build the attribution with ``work`` as the exact closure term.

    ``work`` subtracts the overheads in reverse fold order so
    ``total()`` is the float round-trip of the same chain; the repair
    loop absorbs the rare half-ulp tie where the round-trip lands one
    ulp off, making ``total() == makespan`` a hard invariant.
    """
    work = makespan
    for v in (wait, recovery, downtime, re_exec, verify, proactive_ckpt,
              ckpt):
        work -= v
    for _ in range(8):
        att = WasteAttribution(makespan=makespan, work=work, ckpt=ckpt,
                               proactive_ckpt=proactive_ckpt,
                               verify=verify,
                               re_exec=re_exec, downtime=downtime,
                               recovery=recovery, wait=wait)
        err = makespan - att.total()
        if err == 0.0:
            return att
        work += err
    raise ArithmeticError(           # pragma: no cover - repair converges
        f"bucket closure did not converge (residual {err!r})")


def attribute_result(res: Any, *, wait: float = 0.0) -> WasteAttribution:
    """Attribution of a :class:`repro_torch.core.simulator.SimResult` (or any
    object with the same time fields, e.g. ``BatchResult.result()``)."""
    return _close(res.makespan, res.time_ckpt, res.time_prockpt,
                  getattr(res, "time_verify", 0.0), res.time_lost,
                  res.time_downtime, res.time_recovery, wait)


def attribute_fleet_job(job: Any) -> WasteAttribution:
    """Attribution of a :class:`repro_torch.fleet.sim.FleetJobResult`.

    The ``wait`` bucket collects the fleet couplings: storage-contention
    stretch on periodic and proactive saves plus repair-queue waiting.
    """
    wait = job.time_contention_ckpt
    wait += job.time_contention_prockpt
    wait += job.time_repair_wait
    return attribute_result(job.sim, wait=wait)


def attribute_batch(batch: Any) -> dict[str, Any]:
    """Vectorized attribution of the port's ``BatchResult``, whichever
    device made it (its fields are numpy arrays either way).

    Returns ``{bucket: ndarray}`` (the grid shape of the batch) built
    with the same closure + repair construction, so
    ``sum(buckets) == makespan`` holds elementwise bit-for-bit.  Raises
    ``ArithmeticError``, as the JAX package's does, if the repair does not
    close on every lane (see :func:`attribute_lanes`).
    """
    buckets, closed = attribute_lanes(batch)
    if not closed.all():
        raise ArithmeticError("bucket closure did not converge")
    return buckets


def attribute_lanes(batch: Any) -> tuple[dict[str, Any], Any]:
    """:func:`attribute_batch` lane by lane: the buckets and a boolean
    mask of the lanes on which ``sum(buckets) == makespan`` holds.

    The closure's left fold cannot reach every makespan: on some lanes
    the repair loop alternates between one ulp below and one ulp above it
    (the fold skips the makespan's float), and ``attribute_batch`` (the
    JAX package's too) raises for the whole batch.  On every lane of the
    mask the buckets are ``attribute_batch``'s bits: the loop is its loop,
    and a lane that closes is left as it is.
    """
    import numpy as np

    if batch.time_downtime is None or batch.time_recovery is None:
        raise ValueError("batch result lacks the downtime/recovery split "
                         "(engine predates the observability fields)")
    makespan = np.asarray(batch.makespan, dtype=np.float64)
    time_verify = getattr(batch, "time_verify", None)
    if time_verify is None:
        time_verify = np.zeros_like(makespan)
    over = [np.broadcast_to(np.asarray(a, dtype=np.float64),
                            makespan.shape)
            for a in (batch.time_ckpt, batch.time_prockpt, time_verify,
                      batch.time_lost, batch.time_downtime,
                      batch.time_recovery)]
    ckpt, proactive, verify, re_exec, downtime, recovery = over
    wait = np.zeros_like(makespan)
    work = makespan.copy()
    for v in (wait, recovery, downtime, re_exec, verify, proactive, ckpt):
        work -= v
    for _ in range(8):
        tot = work.copy()
        for v in (ckpt, proactive, verify, re_exec, downtime, recovery,
                  wait):
            tot += v
        err = makespan - tot
        closed = err == 0.0
        if closed.all():
            break
        work += err
    return ({"work": work, "ckpt": ckpt, "proactive_ckpt": proactive,
             "verify": verify, "re_exec": re_exec, "downtime": downtime,
             "recovery": recovery, "wait": wait}, closed)


def expected_fractions(t: float, platform: Any, pp: Any = None, *,
                       n_verify: int = 0,
                       verify_cost: float = 0.0) -> dict[str, float]:
    """First-order expected bucket fractions of the makespan.

    Without a predictor (``pp=None``) these are the terms of Eq. 4/7:
    ``ckpt = C/T``, ``downtime = D/mu``, ``recovery = R/mu``,
    ``re_exec = T/2mu``.  With a :class:`PredictedPlatform` acting past
    ``beta_lim`` they are the refined-policy terms of Eq. 15 (the unit
    weight case of ``fleet.availability.unavailability_pred``):
    re-execution drops to ``(1-r)T/2mu + r beta^2/2Tmu`` and proactive
    checkpoints cost ``(r/p) C_p max(0, 1 - beta/T)/mu``.  With
    ``n_verify = k >= 1`` verifications of cost ``verify_cost = V`` per
    period (arXiv:1310.8486; see :mod:`repro_torch.core.silent`) the
    fault-free verification term is ``kV/T``.  ``work`` is the
    complement; ``wait`` is 0 (single-job analysis).
    """
    mu = platform.mu
    out = {"ckpt": platform.c / t, "downtime": platform.d / mu,
           "recovery": platform.r / mu, "wait": 0.0,
           "verify": n_verify * verify_cost / t}
    if pp is None:
        out["proactive_ckpt"] = 0.0
        out["re_exec"] = t / (2.0 * mu)
    else:
        from ..core.prediction import beta_lim

        rec = pp.predictor.recall
        prec = pp.predictor.precision
        beta = beta_lim(pp)
        act = max(0.0, 1.0 - beta / t)
        out["proactive_ckpt"] = (rec / prec) * pp.cp * act / mu
        out["re_exec"] = ((1.0 - rec) * t / 2.0
                          + rec * beta * beta / (2.0 * t)) / mu
    out["work"] = 1.0 - math.fsum(out[n] for n in _OVERHEADS)
    return out
