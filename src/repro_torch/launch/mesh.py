"""Production meshes as torch ``DeviceMesh`` objects.

The port of ``repro/launch/mesh.py``: the 16 x 16 ``("data", "model")``
single-pod mesh, or 2 x 16 x 16 ``("pod", "data", "model")`` across two
pods.  No machine here holds 256 or 512 cards, so the production meshes
live on a *fake* process group (``torch.testing``'s ``FakeStore`` and the
``"fake"`` backend): collectives are recorded by the trace and move no
bytes, which is what the dry run needs.  This process is rank 0.

A process group's world size is fixed when it is made, so moving between
the 256- and 512-rank meshes destroys the group this module made first
(:func:`release`); the reference's dry run fixed its device count once
per process through ``XLA_FLAGS`` instead.

:func:`make_cpu_mesh` is the 1 x 1 mesh over the CPU and
:func:`make_device_mesh` the same over one card, under the port's device
policy (``device=None`` means CUDA), both on a world-size-1 group.
Functions, not module-level constants, so importing this module touches
no process group.
"""

from __future__ import annotations

import torch

from ..device import resolve_device

__all__ = ["make_cpu_mesh", "make_device_mesh", "make_fake_mesh",
           "make_production_mesh", "mesh_name", "release"]

_OWNED = False   # whether this module made the current default group


def release() -> None:
    """Destroy the default process group if this module made it."""
    global _OWNED
    import torch.distributed as dist

    if _OWNED and dist.is_initialized():
        dist.destroy_process_group()
    _OWNED = False


def _group(backend: str, world: int, **kw) -> None:
    """A default process group of ``world`` ranks (this process rank 0),
    remade if the current one is ours and of another size or backend."""
    global _OWNED
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == backend:
            return
        if not _OWNED:
            raise RuntimeError(
                f"a {dist.get_world_size()}-rank {dist.get_backend()} "
                f"process group exists that this module did not make; a "
                f"{world}-rank {backend} mesh needs its own process")
        release()
    dist.init_process_group(backend, rank=0, world_size=world, **kw)
    _OWNED = True


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single-pod mesh, or 2x16x16 multi-pod, on a fake group."""
    if multi_pod:
        return make_fake_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_fake_mesh((16, 16), ("data", "model"))


def make_fake_mesh(shape: tuple[int, ...], names: tuple[str, ...]):
    """A CPU ``DeviceMesh`` of ``shape`` on a fake group of as many ranks
    (the tests' small meshes, and the production ones)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = 1
    for n in shape:
        world *= n
    _group("fake", world, store=FakeStore())
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def make_device_mesh(device: str | torch.device | None = None):
    """The 1x1 ``("data", "model")`` mesh over one device (``None`` means
    CUDA), on a world-size-1 group (gloo on the CPU, nccl on a card)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    _group(backend, 1, store=dist.HashStore())
    return init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))


def make_cpu_mesh():
    """1x1 mesh over the CPU (the tests' mesh)."""
    return make_device_mesh("cpu")


def mesh_name(mesh) -> str:
    """"16x16", "2x16x16", "1x1": the extents joined by x."""
    return "x".join(str(n) for n in tuple(mesh.shape))
