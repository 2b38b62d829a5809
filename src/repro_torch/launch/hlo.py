"""The traced step's cost: FLOPs, bytes, collective traffic, peak memory.

The port of ``repro/launch/hlo.py``, under the reference's name so that a
reader finds the counterpart.  The reference reads XLA's cost and memory
analyses and parses the partitioned HLO text for collectives; the port
has no HLO.  It traces the step instead (``launch/steps.py::lower_step``)
with :class:`StepCounter`, a ``FakeTensorMode`` that sees every op DTensor
runs on one device's *local* shards, and counts there, per device:

* FLOPs: the matrix products (``mm``, ``bmm``, ...) by torch's own flop
  formulas (``torch.utils.flop_counter``), and the recurrent products of
  the sLSTM's time loop, which a trace sees as one op each way
  (``models/xlstm.py``, as XLA sees the reference's ``lax.scan``);
  elementwise work is not counted;
* bytes accessed: each op's inputs read once and outputs written once,
  for every op that is not a view, a factory of uninitialised memory or a
  collective (what the eager ops would move, with no fusion);
* collective bytes: the result bytes of every functional collective the
  trace issued (``torch.distributed._functional_collectives``), under the
  reference's five kinds;
* peak bytes: the most bytes of live local storage at any point, inputs
  (state, batch, cache) included, the role of ``parse_memory_analysis``.

A dispatch mode *above* DTensor would see the global ops (a (256, 4096,
8192) x (8192, 28672) product on a 16 x 16 mesh counts 4.93e14 FLOPs, the
whole product); this one sits below it, because DTensor runs its local
ops on the fake shards, which dispatch to the fake mode that made them.
DTensor's sharding propagation also runs ops on fake tensors of global
shape, to learn output shapes; :func:`local_only` moves that bookkeeping
out of the counting mode.

Hardware: one NVIDIA H100 SXM5 (NVIDIA's H100 datasheet): 989.4 TFLOP/s
dense bf16, 3.35 TB/s HBM3, 80 GB, NVLink 4 at 900 GB/s per GPU (450 GB/s
per direction, the "link" term), and InfiniBand NDR at 400 Gb/s = 50 GB/s
per GPU for traffic between nodes (the pod term).  The reference's formula
is kept: every collective byte over the link rate.  A 16-wide "model"
axis spans two 8-GPU NVLink domains, so part of that traffic would ride
InfiniBand instead, and the collective term is optimistic.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref
from typing import Any

import torch

__all__ = ["H100", "CollectiveStats", "Hardware", "RooflineTerms",
           "StepCounter", "collective_bytes", "local_only",
           "parse_memory_analysis", "roofline_terms"]

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# Functional collective op name -> the reference's kind.
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "permute_tensor": "collective-permute",
    "broadcast": "collective-permute",
}

# Factories of uninitialised memory: they write nothing.
_NO_BYTES = ("empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided")


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    flops_bf16: float        # per device
    hbm_bw: float            # bytes/s per device
    link_bw: float           # bytes/s per direction over NVLink
    pod_bw: float            # bytes/s per device between nodes
    hbm_bytes: float         # capacity per device


H100 = Hardware(name="h100_sxm5", flops_bf16=989.4e12, hbm_bw=3.35e12,
                link_bw=450e9, pod_bw=50e9, hbm_bytes=80e9)


@dataclasses.dataclass
class CollectiveStats:
    """Per-device result bytes by collective kind."""

    by_kind: dict
    n_ops: int

    @property
    def total(self) -> int:
        return sum(self.by_kind.values())


def collective_bytes(ops: list[tuple[str, int]]) -> CollectiveStats:
    """Sum ``(functional collective op name, result bytes)`` records by
    the reference's kinds; a name outside them (a ``wait_tensor``) is not
    a collective."""
    by_kind: dict[str, int] = {k: 0 for k in _COLLECTIVES}
    n = 0
    for name, nbytes in ops:
        kind = _KIND.get(name)
        if kind is None:
            continue
        by_kind[kind] += nbytes
        n += 1
    return CollectiveStats({k: v for k, v in by_kind.items() if v}, n)


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _scan_flops(wx, r, *args, out_val=None) -> int:
    """The sLSTM scan's recurrent products (``models/xlstm.py``): T
    tokens of (B, H, hd) x (4, H, hd, hd)."""
    b, t = wx.shape[:2]
    return 2 * b * t * r.shape[0] * r.shape[1] * r.shape[2] * r.shape[3]


# The port's own ops a trace sees whole: FLOPs by the products inside.
_PORT_FLOPS = {
    "slstm_scan": _scan_flops,
    # d(h) and d(r) of each product.
    "slstm_scan_backward": lambda *a, **k: 2 * _scan_flops(*a, **k),
}


def _flop_formula(func):
    from torch.utils.flop_counter import flop_registry

    if func.namespace == "repro_torch":
        return _PORT_FLOPS[func._opname]
    return flop_registry.get(func._overloadpacket)


class StepCounter:
    """Counts one device's work in a trace: FLOPs, bytes accessed,
    collectives and live bytes.  :meth:`mode` gives the fake mode to
    trace under (the local shards must be made inside it)."""

    def __init__(self) -> None:
        from torch._subclasses.fake_tensor import FakeTensorMode

        counter = self

        class _Mode(FakeTensorMode):
            def dispatch(self, func, types, args=(), kwargs=None):
                counter._depth += 1
                try:
                    out = super().dispatch(func, types, args, kwargs)
                finally:
                    counter._depth -= 1
                # Only the op itself: the first time the fake mode meets a
                # signature it may run the op's Python decomposition, whose
                # inner ops dispatch here too.
                if counter._depth == 0 and out is not NotImplemented:
                    counter._record(func, args, kwargs or {}, out)
                return out

        self._mode = _Mode(allow_non_fake_inputs=False)
        self._depth = 0
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.collectives: list[tuple[str, int]] = []
        self.live = 0
        self.peak = 0
        self._storages: dict[int, list[int]] = {}   # key -> [refs, bytes]

    def mode(self):
        return self._mode

    def _release(self, key: int) -> None:
        entry = self._storages[key]
        entry[0] -= 1
        if entry[0] == 0:
            self.live -= entry[1]
            del self._storages[key]

    def _track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage live until its last tensor dies (the
        fake tensors' Python objects live as long as their TensorImpl,
        autograd's saved tensors included)."""
        storage = t.untyped_storage()
        key = storage._cdata
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [0, storage.nbytes()]
            self.live += entry[1]
            self.peak = max(self.peak, self.live)
        entry[0] += 1
        weakref.finalize(t, self._release, key)

    def _record(self, func, args, kwargs, out) -> None:
        leaves = torch.utils._pytree.tree_leaves(out)
        # Meta-device stand-ins (shapes for the sharded prefill cache, say)
        # stand for no memory on any device.
        outs = [o for o in leaves if isinstance(o, torch.Tensor)
                and o.device.type != "meta"]
        if not outs and any(isinstance(o, torch.Tensor) for o in leaves):
            return
        for o in outs:
            self._track(o)
        out_bytes = sum(o.numel() * o.element_size() for o in outs)
        if func.namespace == "_c10d_functional":
            self.collectives.append((func._opname, out_bytes))
            return
        formula = _flop_formula(func)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not outs or _is_view(func) or func._opname in _NO_BYTES:
            return
        ins = [a for a in torch.utils._pytree.tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        self.bytes_accessed += out_bytes + sum(
            a.numel() * a.element_size() for a in ins)

    @property
    def stats(self) -> CollectiveStats:
        return collective_bytes(self.collectives)


def _real(fn):
    """``fn`` run with the fake mode unset."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with unset_fake_temporarily():
            return fn(*args, **kwargs)

    return run


@contextlib.contextmanager
def local_only():
    """DTensor's bookkeeping outside the fake mode: its sharding
    propagation (which runs each op on global-shape fakes, and whose
    strided-shard offsets read index tensors back, which fake tensors
    refuse) and the strided-shard offsets of a redistribution.  Under a
    fake mode DTensor also skips its propagation cache; the cached entry
    point is used either way (every shape here is static).  Only the
    entry points this torch has are patched."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import placement_types

    prop = DTensor._op_dispatcher.sharding_propagator
    saved: list[tuple[Any, str, Any, bool]] = []

    def patch(owner, name, fn) -> None:
        own = name in vars(owner)
        saved.append((owner, name, vars(owner).get(name), own))
        setattr(owner, name, fn)

    cached = getattr(prop, "propagate_op_sharding", None)
    if cached is not None:
        patch(prop, "propagate_op_sharding", _real(cached))
        patch(prop, "propagate_op_sharding_non_cached", _real(cached))
    strided = getattr(placement_types, "_StridedShard", None)
    for name in ("local_shard_size_and_offset",
                 "_local_shard_size_and_offset", "_local_shard_size"):
        if strided is not None and name in vars(strided):
            fn = vars(strided)[name]
            wrapped = staticmethod(_real(fn.__func__)) \
                if isinstance(fn, staticmethod) else _real(fn)
            patch(strided, name, wrapped)
    try:
        yield
    finally:
        for owner, name, old, own in reversed(saved):
            if own:
                setattr(owner, name, old)
            else:
                delattr(owner, name)


@dataclasses.dataclass
class RooflineTerms:
    """Three-term roofline for one traced (arch x shape x mesh)."""

    arch: str
    shape: str
    mesh: str
    n_devices: int
    hlo_flops: float           # FLOPs per device (matrix products)
    hlo_bytes: float           # bytes accessed per device
    coll_bytes: float          # collective bytes per device
    t_compute: float
    t_memory: float
    t_collective: float
    model_flops: float         # 6*N*D useful flops (global)
    bytes_per_device: float    # peak live bytes per device
    n_collectives: int = 0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (global traced FLOPs): recompute/dispatch probe."""
        total = self.hlo_flops * self.n_devices
        return self.model_flops / total if total else 0.0

    def as_row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "bytes_per_device": self.bytes_per_device,
            "n_collectives": self.n_collectives,
        }


def parse_memory_analysis(counter: Any) -> float:
    """Peak per-device bytes of a traced step (the role of the
    reference's reading of ``compiled.memory_analysis()``)."""
    return float(getattr(counter, "peak", 0.0))


def roofline_terms(cost: Any, *, arch: str, shape: str, mesh_name: str,
                   n_devices: int, model_flops: float,
                   hw: Hardware = H100) -> RooflineTerms:
    """The three roofline terms of a traced step's per-device ``cost``
    (anything with ``flops``, ``bytes_accessed``, ``stats`` and
    ``peak``: a :class:`StepCounter`, or the extrapolated totals of
    ``steps.lower_step``)."""
    stats = cost.stats
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        hlo_flops=float(cost.flops), hlo_bytes=float(cost.bytes_accessed),
        coll_bytes=float(stats.total),
        t_compute=cost.flops / hw.flops_bf16,
        t_memory=cost.bytes_accessed / hw.hbm_bw,
        t_collective=stats.total / hw.link_bw,
        model_flops=model_flops,
        bytes_per_device=parse_memory_analysis(cost),
        n_collectives=stats.n_ops,
    )
