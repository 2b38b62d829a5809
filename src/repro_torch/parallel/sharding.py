"""Logical-axis sharding: map model-level axis names to mesh axes.

The port of ``repro/parallel/sharding.py``.  Every parameter (and the
main activations) carries a tuple of *logical* axis names (e.g.
``("vocab", "embed")``).  :class:`AxisRules` maps those names to mesh axes
with the reference's fallbacks: an axis whose size does not divide the
assigned mesh-axis extent is replicated instead, a mesh axis is used at
most once per spec, and "batch" shards over ``("pod", "data")`` jointly
when divisible, else over "data".

Default placement (Megatron/FSDP hybrid):
  * "model"-assigned: attention heads, FFN hidden, vocab, experts, LRU width;
  * "data"-assigned (FSDP-style weight sharding): the d_model ("embed") dim;
  * batch: ("pod", "data"): pods are pure data parallelism;
  * everything else replicated.

A :class:`PartitionSpec` lists, per tensor dim, the mesh axis (or the
tuple of mesh axes) that shards it, or None, with trailing Nones trimmed,
as JAX's does.  :func:`placements` turns it into DTensor placements on a
``torch.distributed.device_mesh.DeviceMesh``: those are listed per *mesh*
dim, so a tensor dim sharded by ``("pod", "data")`` becomes ``Shard(d)``
on both mesh dims, in the mesh's order (DTensor splits a dim by the mesh
dims in order, which is JAX's major-to-minor order of the tuple).

A mesh is anything with named extents: a ``DeviceMesh`` with
``mesh_dim_names``, or an object whose ``shape`` is a dict of axis name to
size (the tests' ``FakeMesh``).  :func:`constrain` is the reference's
``with_sharding_constraint``: outside :func:`use_rules` with a mesh, or on
a tensor that is not a DTensor, it returns its argument itself, so the
unsharded path is the one it always was; inside, it redistributes a
DTensor to the spec's placements.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import Any

import torch

from ..tree import flatten, is_axes, tree_map, unflatten

__all__ = ["AxisRules", "DECODE_RULES", "DEFAULT_RULES", "PartitionSpec",
           "SEQ_PARALLEL_RULES", "constrain", "is_dtensor",
           "is_spec",
           "local_shape", "logical_to_spec", "merge_dims", "mesh_shape",
           "per_shard",
           "placements", "replicate_dims", "sharded_zeros",
           "shard_batch_spec", "spec_tree", "split_dim", "use_rules"]


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Mapping logical axis name -> preferred mesh axis (or None)."""

    rules: tuple[tuple[str, str | None], ...]

    def mesh_axis(self, logical: str | None) -> str | None:
        if logical is None:
            return None
        for name, target in self.rules:
            if name == logical:
                return target
        return None

    def replace(self, **kw: str | None) -> "AxisRules":
        rules = tuple((k, kw.get(k, v)) for k, v in self.rules)
        extra = tuple((k, v) for k, v in kw.items()
                      if k not in dict(self.rules))
        return AxisRules(rules + extra)


DEFAULT_RULES = AxisRules((
    ("batch", "data"),        # batch additionally shards over "pod" (below)
    ("embed", "data"),        # FSDP-style: d_model dim of weights over data
    ("heads", "model"),
    ("kv_heads", "model"),
    ("mlp", "model"),
    ("vocab", "model"),
    ("experts", "model"),     # expert parallelism
    ("capacity", "data"),     # MoE dispatch-buffer token slots
    ("lru", "model"),
    ("seq", None),
    ("head_dim", None),
    ("layers", None),
    ("conv", None),
))

# Decode-mode rules: the KV-cache time axis shards over "model" (a 32k-deep
# cache for a 100+-layer model does not fit one device otherwise).
DECODE_RULES = DEFAULT_RULES.replace(seq="model")

# Train-mode sequence-parallel rules: activations shard their seq axis over
# "model" between blocks, Megatron-SP style.
SEQ_PARALLEL_RULES = DEFAULT_RULES.replace(seq="model")


class PartitionSpec(tuple):
    """Per tensor dim: a mesh axis name, a tuple of names, or None."""

    def __new__(cls, *entries: Any) -> "PartitionSpec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def is_spec(x: Any) -> bool:
    """The leaf test of a spec tree (a spec is a tuple, so a plain walk
    would descend into it)."""
    return isinstance(x, PartitionSpec)

_ACTIVE_RULES: AxisRules = DEFAULT_RULES
_ACTIVE_MESH: Any = None


@contextlib.contextmanager
def use_rules(rules: AxisRules, mesh: Any = None):
    """Scoped override of the rules (and mesh) used by :func:`constrain`."""
    global _ACTIVE_RULES, _ACTIVE_MESH
    old = (_ACTIVE_RULES, _ACTIVE_MESH)
    _ACTIVE_RULES = rules
    _ACTIVE_MESH = mesh
    try:
        yield rules
    finally:
        _ACTIVE_RULES, _ACTIVE_MESH = old


def mesh_shape(mesh: Any) -> dict[str, int]:
    """Axis name -> extent, in the mesh's order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _divisible(size: int, shape: dict[str, int], axis: str | None) -> bool:
    if axis is None or axis not in shape:
        return False
    return size % shape[axis] == 0


def logical_to_spec(axes: tuple[str | None, ...], shape: tuple[int, ...],
                    mesh: Any, rules: AxisRules = DEFAULT_RULES
                    ) -> PartitionSpec:
    """PartitionSpec for one tensor given its logical axes and shape."""
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} do not match shape {tuple(shape)}")
    extents = mesh_shape(mesh)
    used: set[str] = set()
    out: list[Any] = []
    for name, size in zip(axes, shape):
        target = rules.mesh_axis(name)
        if name == "batch":
            # Batch shards over ("pod", "data") jointly when divisible.
            cand = [a for a in ("pod", "data") if a in extents]
            extent = 1
            for a in cand:
                extent *= extents[a]
            if cand and size % extent == 0 and not (set(cand) & used):
                out.append(tuple(cand) if len(cand) > 1 else cand[0])
                used.update(cand)
                continue
            target = "data"
        if target in used or not _divisible(size, extents, target):
            out.append(None)
        else:
            out.append(target)
            used.add(target)  # a mesh axis may appear only once per spec
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def spec_tree(axes_tree: Any, params_tree: Any, mesh: Any,
              rules: AxisRules = DEFAULT_RULES) -> Any:
    """A tree of PartitionSpecs from a logical-axes tree and the tensors
    (or shape holders) it describes, leaf for leaf."""
    return tree_map(
        lambda axes, p: logical_to_spec(tuple(axes), tuple(p.shape), mesh,
                                        rules),
        axes_tree, params_tree, is_leaf=is_axes)


def shard_batch_spec(mesh: Any, batch: int) -> PartitionSpec:
    """PartitionSpec for a (batch, ...) input tensor."""
    return logical_to_spec(("batch",), (batch,), mesh)


def _entries(spec: PartitionSpec) -> list[tuple[int, tuple[str, ...]]]:
    """(tensor dim, mesh axes that shard it) for each sharded dim."""
    out = []
    for dim, entry in enumerate(spec):
        if entry is not None:
            out.append((dim, entry if isinstance(entry, tuple) else (entry,)))
    return out


def placements(spec: PartitionSpec, mesh: Any) -> tuple:
    """DTensor placements (one per mesh dim) for ``spec``: ``Shard(d)`` on
    each mesh dim that shards tensor dim d, ``Replicate()`` elsewhere and
    on a mesh dim of extent 1 (a one-device mesh replicates everything,
    where the rules, which only test divisibility, name its axes)."""
    from torch.distributed.tensor import Replicate, Shard

    extents = mesh_shape(mesh)
    names = list(extents)
    out: list[Any] = [Replicate()] * len(names)
    for dim, axes in _entries(spec):
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"{spec}: mesh axes {axes} of dim {dim} are "
                             f"not in the mesh's order {tuple(names)}")
        for i in order:
            if extents[names[i]] > 1:
                out[i] = Shard(dim)
    return tuple(out)


def local_shape(spec: PartitionSpec, shape: tuple[int, ...],
                mesh: Any) -> tuple[int, ...]:
    """One device's shard of a tensor of ``shape`` under ``spec``."""
    extents = mesh_shape(mesh)
    out = list(shape)
    for dim, axes in _entries(spec):
        for a in axes:
            if out[dim] % extents[a]:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                 f"divide over {a}={extents[a]}")
            out[dim] //= extents[a]
    return tuple(out)


def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a DTensor.  No DTensor exists before its module is
    imported, so the unsharded path never imports it."""
    module = sys.modules.get("torch.distributed.tensor")
    return module is not None and isinstance(x, module.DTensor)


def split_dim(x: torch.Tensor, dim: int, sizes: tuple[int, ...]
              ) -> torch.Tensor:
    """``x`` with dim ``dim`` split into ``sizes``.  DTensor can split a
    sharded dim only when the first part divides over the mesh dims that
    shard it; those that do not are replicated first (what GSPMD does when
    a reshape meets a sharding it cannot keep)."""
    dim %= x.dim()
    x = replicate_dims(x, (dim,), unless=lambda extent: sizes[0] % extent == 0)
    return x.reshape(x.shape[:dim] + tuple(sizes) + x.shape[dim + 1:])


def merge_dims(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` with its dims ``dim`` .. ``dim + n - 1`` merged into one, the
    inverse of :func:`split_dim`.  A plain tensor is reshaped; on a
    DTensor the backward splits the gradient through :func:`split_dim`
    (a reshape's own backward cannot split a gradient sharded wider than
    the first part)."""
    dim %= x.dim()
    if not is_dtensor(x):
        return x.reshape(x.shape[:dim] + (-1,) + x.shape[dim + n:])
    return _Merge.apply(x, dim, tuple(x.shape[dim:dim + n]))


class _Merge(torch.autograd.Function):
    """:func:`merge_dims` on a DTensor."""

    @staticmethod
    def forward(ctx, x, dim, sizes):
        ctx.dim, ctx.sizes = dim, sizes
        return x.reshape(x.shape[:dim] + (-1,) + x.shape[dim + len(sizes):])

    @staticmethod
    def backward(ctx, g):
        return split_dim(g, ctx.dim, ctx.sizes), None, None


def replicate_dims(x: torch.Tensor, dims: tuple[int, ...],
                   unless=None) -> torch.Tensor:
    """A DTensor ``x`` with the mesh dims that shard any of ``dims``
    replicated (all-gathered), except those whose extent ``unless``
    accepts; a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    dims = tuple(d % x.dim() for d in dims)
    target = tuple(
        Replicate() if isinstance(p, Shard) and p.dim in dims
        and not (unless is not None and unless(mesh.size(i))) else p
        for i, p in enumerate(x.placements))
    if target == tuple(x.placements):
        return x
    return x.redistribute(mesh, target)


def per_shard(fn, *args: torch.Tensor, dims: tuple):
    """``fn(*args)`` run on each device's shards, as ``shard_map`` runs
    it, for a function that is independent along the tensor dims ``dims``
    of its arguments and its results (attention: batch rows and heads;
    the MoE dispatch: groups; the expert products: groups and experts).
    ``fn`` returns a tensor or a tuple of tensors.  ``dims`` is one tuple
    of dims for every argument, or a tuple per argument, aligned with the
    first's, ``None`` where an argument lacks that dim (an expert weight
    has no group dim).

    Plain tensors go straight to ``fn``.  When the first argument is a
    DTensor, a plain argument is taken as replicated (a zero state, say),
    and a mesh dim keeps
    sharding where it shards one of ``dims`` of the first argument and
    its extent divides that dim of every argument that has it; every
    other mesh dim is replicated.  Each argument is redistributed to that
    plan (an argument without the dim is replicated over the mesh dim,
    and its gradient there is a partial sum: each shard used it on its
    own rows), and each result carries the first argument's placements.
    Without this, DTensor partitions the ops inside ``fn`` one by one:
    folding a data-sharded batch dim into a model-sharded head dim makes
    it gather whole activations, and some ops (a sort, an accumulating
    ``index_put``) have no rule at all."""
    if not is_dtensor(args[0]):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    per_arg = dims if dims and isinstance(dims[0], tuple) \
        else (tuple(dims),) * len(args)
    mesh = args[0].device_mesh
    extent: dict[int, int] = {}
    for i, p in enumerate(args[0].placements):
        if isinstance(p, Shard):
            extent[p.dim] = extent.get(p.dim, 1) * mesh.size(i)
    kept: dict[int, int] = {}       # mesh dim -> index into the dims
    for i, p in enumerate(args[0].placements):
        if isinstance(p, Shard) and p.dim in per_arg[0]:
            k = per_arg[0].index(p.dim)
            if all(ad[k] is None or a.shape[ad[k]] % extent[p.dim] == 0
                   for a, ad in zip(args, per_arg)):
                kept[i] = k

    def plan(ad: tuple) -> tuple:
        return tuple(Shard(ad[kept[i]]) if i in kept and ad[kept[i]]
                     is not None else Replicate() for i in range(mesh.ndim))

    local = []
    for a, ad in zip(args, per_arg):
        target = plan(ad)
        if not is_dtensor(a):       # the same tensor on every rank
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if tuple(a.placements) != target:
            a = a.redistribute(mesh, target)
        grad = tuple(Partial() if i in kept and ad[kept[i]] is None else p
                     for i, p in enumerate(target))
        local.append(a.to_local(grad_placements=grad))
    out = fn(*local)
    target = plan(per_arg[0])

    def wrap(t: torch.Tensor) -> torch.Tensor:
        return DTensor.from_local(t, mesh, target, run_check=False)

    if isinstance(out, torch.Tensor):
        return wrap(out)
    return tuple(wrap(t) for t in out)


def sharded_zeros(tree: Any, axes_tree: Any, mesh: Any) -> Any:
    """Zero DTensors shaped and typed like ``tree``'s leaves (meta tensors
    will do), placed by ``axes_tree`` under the active rules."""
    from torch.distributed.tensor import zeros

    specs = flatten(spec_tree(axes_tree, tree, mesh, _ACTIVE_RULES),
                    is_leaf=is_spec)
    return unflatten(tree, [
        zeros(tuple(t.shape), dtype=t.dtype, device_mesh=mesh,
              placements=placements(s, mesh))
        for t, s in zip(flatten(tree), specs)])


def constrain(x: torch.Tensor, axes: tuple[str | None, ...],
              rules: AxisRules | None = None) -> torch.Tensor:
    """Pin a DTensor activation, and its gradient, to the placements of
    its logical axes (JAX's constraint applies to the cotangent too).

    Returns ``x`` itself outside :func:`use_rules` with a mesh, and for a
    tensor that is not a DTensor (the unsharded path, and a one-device
    mesh's steps, which run on the local tensors)."""
    mesh = _ACTIVE_MESH
    if mesh is None or not is_dtensor(x):
        return x
    spec = logical_to_spec(axes, tuple(x.shape), mesh, rules or _ACTIVE_RULES)
    return _Constrain.apply(x, placements(spec, mesh))


class _Constrain(torch.autograd.Function):
    """Redistribute to ``target``; the gradient goes through ``target``
    on its way back to the input's own placements (a partial sum's
    gradient is replicated), as ``DTensor.redistribute``'s does."""

    @staticmethod
    def forward(ctx, x, target):
        from torch.distributed.tensor import Replicate

        ctx.target = target
        ctx.source = tuple(Replicate() if p.is_partial() else p
                           for p in x.placements)
        if tuple(x.placements) == target:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, target)

    @staticmethod
    def backward(ctx, g):
        for want in (ctx.target, ctx.source):
            if tuple(g.placements) != want:
                g = g.redistribute(g.device_mesh, want)
        return g, None
