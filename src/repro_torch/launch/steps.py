"""Sharded step builders: train_step / prefill_step / serve_step + specs.

The port of ``repro/launch/steps.py``: the bridge between the model code
and the distribution layer.  It builds the step functions, the
partition-spec trees derived from the logical-axes trees, and the
meta-device stand-ins the dry run traces without allocating a byte of
model state.

The steps take plain tensors or DTensors.  On DTensors they run under
DTensor's op-by-op partitioning, with :func:`repro_torch.parallel.sharding.
constrain` pinning the activations the reference pins; on a one-device
mesh they run on the local tensors (``to_local()``, the same storage) and
wrap the results back, so the kernels see exactly the unsharded path.

:func:`lower_step` is the dry run's entry: it builds the state as
DTensors over fake local shards of the production mesh and traces one
step, counting one device's work (:class:`repro_torch.launch.hlo.
StepCounter`).  The reference's ``jit.lower().compile()`` sees a
``lax.scan`` over the stacked layers and the microbatches once; a torch
trace runs every op, so :func:`lower_step` traces the step at one and two
repeats of the block unit (and, for a train step of more than 2
microbatches, at one and two microbatches of the full run's microbatch
size, through the accumulating step) and extends the counts linearly:
every repeat has the same local shapes and placements (the "layers" axis
is never sharded), and so has every microbatch, so each adds the same
FLOPs, bytes, collectives and live bytes.  ``full_depth=True`` traces the
whole step instead (the tests hold the two equal).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from ..configs.base import InputShape, ModelConfig
from ..models import transformer
from ..models.model import _batch_shapes, cache_len_for, init_cache, loss_fn
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..parallel import sharding as shd
from ..tree import flatten, tree_map, unflatten
from . import hlo

__all__ = ["LoweredPair", "ShardedSpec", "abstract_cache", "abstract_state",
           "batch_specs", "cache_specs", "lower_step",
           "make_prefill_step", "make_serve_step", "make_train_step",
           "shard_tree", "state_specs"]


class ShardedSpec(NamedTuple):
    """A stand-in for one input: shape, dtype and partition spec (the
    reference's ``ShapeDtypeStruct(..., sharding=...)``)."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    spec: shd.PartitionSpec


# ---------------------------------------------------------------------------
# Abstract state / cache (meta tensors + aligned axes, no allocation)
# ---------------------------------------------------------------------------

def abstract_state(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None
                   ) -> tuple[Any, Any, Any]:
    """(params, params_axes, opt_state) with meta tensors at the leaves."""
    params = transformer.init_params(cfg, device="meta")
    opt = adamw_init(params, opt_cfg) if opt_cfg is not None else None
    return params, transformer.param_axes(cfg), opt


def abstract_cache(cfg: ModelConfig, batch: int, cache_len: int) -> Any:
    return init_cache(cfg, batch, cache_len, device="meta")


# ---------------------------------------------------------------------------
# Sharding specs
# ---------------------------------------------------------------------------

def state_specs(cfg: ModelConfig, mesh: Any, params_abs: Any, axes: Any,
                opt_abs: Any = None, rules: shd.AxisRules | None = None):
    """PartitionSpec trees for (params, opt_state): the moments shard as
    their parameters, the step count replicates."""
    rules = rules or shd.DEFAULT_RULES
    pspecs = shd.spec_tree(axes, params_abs, mesh, rules)
    if opt_abs is None:
        return pspecs, None
    return pspecs, {"m": pspecs, "v": pspecs, "step": shd.P()}


def _batch_axes(name: str, rank: int) -> tuple:
    if name == "positions_thw":
        axes = ("batch", "seq", None)
    elif name == "vision_embeds":
        axes = ("batch", None, "embed")
    else:
        axes = {2: ("batch", "seq"), 3: ("batch", "seq", "embed")}[rank]
    # Activations never shard "embed" on inputs (weights own that axis).
    return tuple(None if a == "embed" else a for a in axes)


def batch_specs(cfg: ModelConfig, shape: InputShape, mesh: Any,
                rules: shd.AxisRules | None = None) -> dict:
    """:class:`ShardedSpec` of each input of the train/prefill batch."""
    rules = rules or shd.DEFAULT_RULES
    out = {}
    for name, (shp, dt) in _batch_shapes(cfg, shape).items():
        axes = _batch_axes(name, len(shp))
        out[name] = ShardedSpec(shp, dt,
                                shd.logical_to_spec(axes, shp, mesh, rules))
    return out


def cache_specs(cfg: ModelConfig, shape: InputShape, mesh: Any,
                rules: shd.AxisRules | None = None):
    """(cache stand-ins (meta), PartitionSpec tree) for a decode shape."""
    rules = rules or shd.DECODE_RULES
    cache_abs = abstract_cache(cfg, shape.global_batch,
                               cache_len_for(cfg, shape))
    specs = shd.spec_tree(transformer.cache_axes(cfg), cache_abs, mesh,
                          rules)
    return cache_abs, specs


def shard_tree(tree: Any, specs: Any, mesh: Any) -> Any:
    """Real tensors as DTensors on ``mesh`` under ``specs`` (each scattered
    from this rank's full copy)."""
    from torch.distributed.tensor import distribute_tensor

    flat_specs = flatten(specs, is_leaf=shd.is_spec)
    return unflatten(tree, [
        distribute_tensor(t, mesh, shd.placements(s, mesh))
        for t, s in zip(flatten(tree), flat_specs)])


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------

def _on_local(step: Callable) -> Callable:
    """``step`` run on the local tensors when its DTensor arguments live
    on a one-device mesh, the results wrapped back (replicated)."""

    def run(*args):
        from torch.distributed.tensor import DTensor, Replicate

        leaves = flatten(args)
        meshes = {id(t.device_mesh): t.device_mesh for t in leaves
                  if isinstance(t, DTensor)}
        if len(meshes) != 1:
            return step(*args)
        (mesh,) = meshes.values()
        if mesh.size() != 1:
            return step(*args)
        local = unflatten(args, [t.to_local() if isinstance(t, DTensor)
                                 else t for t in leaves])
        out = step(*local)
        return unflatten(out, [
            DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
            if isinstance(t, torch.Tensor) else t for t in flatten(out)])

    return run


def _grads(cfg: ModelConfig, params: Any, batch: dict) -> tuple[Any, dict]:
    """Gradients of the loss in ``params`` (the trainer's ``_train_step``
    up to the update), and the detached metrics."""
    leaves = [p.detach().requires_grad_() for p in flatten(params)]
    loss, metrics = loss_fn(cfg, unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return (unflatten(params, list(grads)),
            {k: v.detach() for k, v in metrics.items()})


def _kept(batch: int, m: int, sizes: list[int]) -> tuple[int, ...]:
    """Which of the mesh dims that shard a batch of ``batch`` rows (their
    extents ``sizes``, in mesh order) keep sharding its microbatches: the
    set with the largest product that still leaves each device a multiple
    of ``m`` rows (the inner dims on a tie)."""
    best: tuple[int, ...] = ()
    best_extent = 1
    for mask in range(1 << len(sizes)):
        keep = tuple(j for j in range(len(sizes)) if mask >> j & 1)
        extent = 1
        for j in keep:
            extent *= sizes[j]
        if batch % (extent * m) == 0 and extent >= best_extent:
            best, best_extent = keep, extent
    return best


def _microbatch(x: torch.Tensor, i: int, m: int) -> torch.Tensor:
    """Microbatch ``i`` of ``m`` of a batch-major input: each device's own
    rows split into ``m`` contiguous parts (no communication).  Without
    sharding that is rows ``[i B/m, (i+1) B/m)``, the reference's
    ``reshape((m, B // m) + ...)`` order.  Mesh dims that would leave a
    device fewer rows than ``m`` parts are replicated first (``_kept``)."""
    b = x.shape[0]
    extent = 1
    if shd.is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        mesh = x.device_mesh
        dims = [j for j, p in enumerate(x.placements)
                if isinstance(p, Shard) and p.dim == 0]
        keep = {dims[k] for k in _kept(b, m, [mesh.size(j) for j in dims])}
        for j in keep:
            extent *= mesh.size(j)
        target = tuple(Replicate() if j in dims and j not in keep else p
                       for j, p in enumerate(x.placements))
        if target != tuple(x.placements):
            x = x.redistribute(mesh, target)
    parts = x.reshape((extent, m, b // (extent * m)) + tuple(x.shape[1:]))
    return parts[:, i].reshape((b // m,) + tuple(x.shape[1:]))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    grad_specs: Any = None) -> Callable:
    """Microbatched train step: grad-accumulate over ``cfg.microbatches``
    in ``cfg.grad_accum_dtype``, divide by m, average the metrics, then
    ``adamw_update`` (``steps.py:118-162``).  With one microbatch it is
    the trainer's ``_train_step``, op for op.

    ``grad_specs`` (the params' PartitionSpec tree) pins the accumulator
    of DTensor gradients to the params' placements, where the reference
    pins ``grad_shardings``."""
    return _on_local(_train_step(cfg, opt_cfg, grad_specs,
                                 accumulate=cfg.microbatches > 1))


def _train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, grad_specs: Any,
                accumulate: bool) -> Callable:
    """:func:`make_train_step`'s step; ``accumulate`` takes the
    accumulator path even for one microbatch (the dry run's traces of a
    microbatched config at one and two microbatches)."""
    m = max(1, cfg.microbatches)
    acc_dt = torch.bfloat16 if cfg.grad_accum_dtype == "bfloat16" \
        else torch.float32

    def pin(tree: Any) -> Any:
        if grad_specs is None:
            return tree
        specs = flatten(grad_specs, is_leaf=shd.is_spec)
        return unflatten(tree, [
            g.redistribute(g.device_mesh, shd.placements(s, g.device_mesh))
            if shd.is_dtensor(g) else g
            for g, s in zip(flatten(tree), specs)])

    def train_step(params: Any, opt_state: dict, batch: dict):
        if not accumulate:
            grads, metrics = _grads(cfg, params, batch)
            grads = pin(grads)
        else:
            acc = pin(tree_map(lambda p: torch.zeros_like(p, dtype=acc_dt),
                               params))
            per_mb = []
            for i in range(m):
                grads, metrics = _grads(
                    cfg, params, {k: _microbatch(v, i, m)
                                  for k, v in batch.items()})
                acc = pin(tree_map(lambda a, g: a + g.to(acc_dt), acc,
                                   grads))
                per_mb.append(metrics)
                del grads
            # A 0-dim divisor: CUDA turns x / python_scalar into a product
            # by the reciprocal (optim/adamw.py).
            grads = tree_map(lambda g: g / torch.full(
                (), m, dtype=acc_dt, device=g.device), acc)
            metrics = {k: torch.stack([mt[k] for mt in per_mb]).mean()
                       for k in per_mb[0]}
        new_params, new_opt, opt_metrics = adamw_update(
            params, grads, opt_state, opt_cfg)
        return new_params, new_opt, {**metrics, **opt_metrics}

    return train_step


def make_prefill_step(cfg: ModelConfig, shape: InputShape) -> Callable:
    """Prefill (decoder archs) or full encode (encoder-only archs)."""
    if cfg.causal:
        def prefill_step(params, batch):
            return transformer.prefill(cfg, params, batch,
                                       cache_len=shape.seq_len)
    else:
        def prefill_step(params, batch):
            return transformer.forward_train(cfg, params, batch)[0]
    return _on_local(prefill_step)


def make_serve_step(cfg: ModelConfig) -> Callable:
    def serve_step(params, token, cache):
        return transformer.decode_step(cfg, params, token, cache)
    return _on_local(serve_step)


# ---------------------------------------------------------------------------
# Tracing (dry-run entry)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepCost:
    """One device's counts for a step (what :func:`hlo.roofline_terms`
    reads): FLOPs, bytes accessed, collective bytes by kind, collective
    ops, peak live bytes."""

    flops: float
    bytes_accessed: float
    coll: dict
    n_coll: int
    peak: float

    @classmethod
    def of(cls, counter: hlo.StepCounter) -> "StepCost":
        stats = counter.stats
        return cls(counter.flops, counter.bytes_accessed,
                   dict(stats.by_kind), stats.n_ops, float(counter.peak))

    @property
    def stats(self) -> hlo.CollectiveStats:
        return hlo.CollectiveStats(
            {k: v for k, v in self.coll.items() if v}, int(self.n_coll))

    def _fields(self) -> list[float]:
        kinds = [self.coll.get(k, 0) for k in hlo._COLLECTIVES]
        return [self.flops, self.bytes_accessed, *kinds, self.n_coll,
                self.peak]

    @classmethod
    def _from(cls, vals: list[float]) -> "StepCost":
        kinds = dict(zip(hlo._COLLECTIVES, vals[2:7]))
        return cls(vals[0], vals[1], kinds, vals[7], vals[8])

    def extend(self, other: "StepCost", times: float) -> "StepCost":
        """``self + (other - self) * times``: the count at ``times`` more
        steps of a traced increment."""
        return StepCost._from([a + (b - a) * times for a, b in
                               zip(self._fields(), other._fields())])


@dataclasses.dataclass
class LoweredPair:
    """One traced (arch x shape) step on a mesh: its per-device cost and
    the depths (repeats of the block unit, microbatches) it was traced
    at."""

    arch: str
    shape: str
    kind: str
    cost: StepCost
    traced: list[tuple[int, int]]


def _fake_dtensor(shape: tuple[int, ...], dtype: torch.dtype,
                  spec: shd.PartitionSpec, mesh: Any) -> torch.Tensor:
    """A contiguous DTensor of global ``shape`` over an uninitialised fake
    local shard (made under the active fake mode)."""
    from torch.distributed.tensor import DTensor

    local = torch.empty(shd.local_shape(spec, tuple(shape), mesh),
                        dtype=dtype)
    stride, step = [], 1
    for n in reversed(tuple(shape)):
        stride.insert(0, step)
        step *= n
    return DTensor.from_local(local, mesh, shd.placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def _fake_tree(tree: Any, specs: Any, mesh: Any) -> Any:
    return unflatten(tree, [
        _fake_dtensor(t.shape, t.dtype, s, mesh)
        for t, s in zip(flatten(tree), flatten(specs, is_leaf=shd.is_spec))])


def _trace(cfg: ModelConfig, shape: InputShape, mesh: Any,
           rules: shd.AxisRules, opt_cfg: AdamWConfig | None,
           accumulate: bool) -> StepCost:
    """Trace one step of (cfg, shape) on ``mesh`` and count a device."""
    from torch.distributed.tensor.experimental import implicit_replication

    counter = hlo.StepCounter()
    params_abs, axes, opt_abs = abstract_state(
        cfg, opt_cfg if shape.kind == "train" else None)
    pspecs, ospecs = state_specs(cfg, mesh, params_abs, axes, opt_abs, rules)
    if shape.kind == "decode":
        cache_abs, cspecs = cache_specs(cfg, shape, mesh, rules)
    else:
        bspecs = batch_specs(cfg, shape, mesh, rules)
    with counter.mode(), hlo.local_only(), implicit_replication(), \
            shd.use_rules(rules, mesh):
        params = _fake_tree(params_abs, pspecs, mesh)
        if shape.kind == "decode":
            cache = _fake_tree(cache_abs, cspecs, mesh)
            b = shape.global_batch
            token = _fake_dtensor((b,), torch.int32, shd.logical_to_spec(
                ("batch",), (b,), mesh, rules), mesh)
            out = make_serve_step(cfg)(params, token, cache)
            del cache, token
        else:
            batch = {k: _fake_dtensor(*v, mesh) for k, v in bspecs.items()}
            if shape.kind == "train":
                opt = _fake_tree(opt_abs, ospecs, mesh)
                step = _train_step(cfg, opt_cfg, pspecs, accumulate)
                out = step(params, opt, batch)
                del opt
            else:
                out = make_prefill_step(cfg, shape)(params, batch)
            del batch
        del params, out
    return StepCost.of(counter)


def _at(cfg: ModelConfig, shape: InputShape, repeats: int, m_full: int,
        microbatches: int) -> tuple[ModelConfig, InputShape]:
    """(cfg, shape) cut to ``repeats`` of the block unit (the tail kept)
    and ``microbatches`` microbatches of the full run's size."""
    unit = len(cfg.block_unit)
    n_tail = cfg.n_layers - (cfg.n_layers // unit) * unit
    cfg = dataclasses.replace(cfg, n_layers=repeats * unit + n_tail,
                              microbatches=microbatches)
    if shape.kind == "train":
        per_mb = shape.global_batch // m_full
        shape = dataclasses.replace(shape, global_batch=per_mb * microbatches)
    return cfg, shape


def _same_microbatch(shape: InputShape, m_full: int, m: int, mesh: Any,
                     rules: shd.AxisRules) -> bool:
    """Whether a run of ``m`` microbatches of the full run's size gives a
    device the same microbatch rows under the same placements."""
    def layout(batch: int, mm: int):
        spec = shd.logical_to_spec(("batch",), (batch,), mesh, rules)
        axes = spec[0] if spec else ()
        axes = axes if isinstance(axes, tuple) else (axes,)
        sizes = [shd.mesh_shape(mesh)[a] for a in axes]
        kept = _kept(batch, mm, sizes)
        extent = 1
        for j in kept:
            extent *= sizes[j]
        return tuple(axes[j] for j in kept), batch // (extent * mm)

    per_mb = shape.global_batch // m_full
    return layout(shape.global_batch, m_full) == layout(per_mb * m, m)


_PROBE_SEQ = 256


def lower_step(cfg: ModelConfig, shape: InputShape, mesh: Any, *,
               opt_cfg: AdamWConfig | None = None,
               rules: shd.AxisRules | None = None,
               full_depth: bool = False) -> LoweredPair:
    """Trace the right step for (cfg, shape) on ``mesh`` and count one
    device's work, extended to the full depth (see the module doc)."""
    cfg = cfg.for_shape(shape)
    opt_cfg = opt_cfg or AdamWConfig(moment_dtype=cfg.opt_dtype)
    rules = rules or (shd.DECODE_RULES if shape.kind == "decode"
                      else shd.DEFAULT_RULES)
    n_rep = cfg.n_layers // len(cfg.block_unit)
    m = max(1, cfg.microbatches) if shape.kind == "train" else 1
    reps = (n_rep,) if full_depth or n_rep <= 2 else (1, 2)
    mbs = (m,) if (full_depth or m <= 2 or not all(
        _same_microbatch(shape, m, k, mesh, rules) for k in (1, 2))) \
        else (1, 2)
    if shape.kind != "decode" and shape.seq_len > _PROBE_SEQ:
        # An op DTensor cannot partition shows at any length: find it in
        # a short trace first (an sLSTM's time loop at 4,096 steps takes
        # minutes to reach its backward).
        probe_cfg, probe_shape = _at(cfg, shape, 1, m, min(m, 1))
        _trace(probe_cfg, dataclasses.replace(probe_shape,
                                              seq_len=_PROBE_SEQ),
               mesh, rules, opt_cfg, accumulate=m > 1)
    costs = {(r, k): _trace(*_at(cfg, shape, r, m, k), mesh, rules, opt_cfg,
                            accumulate=m > 1)
             for r in reps for k in mbs}
    cost = costs[(reps[0], mbs[0])]
    if len(reps) == 2:
        cost = cost.extend(costs[(reps[1], mbs[0])], n_rep - reps[0])
    if len(mbs) == 2:
        at_mb = costs[(reps[0], mbs[1])]
        if len(reps) == 2:
            at_mb = at_mb.extend(costs[(reps[1], mbs[1])], n_rep - reps[0])
        cost = cost.extend(at_mb, (m - mbs[0]) / (mbs[1] - mbs[0]))
    return LoweredPair(cfg.name, shape.name, shape.kind, cost,
                       sorted(costs))
