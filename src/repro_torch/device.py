"""Device policy of the port: CUDA unless the caller asks for the CPU.

Every entry point takes ``device=None``, which means ``"cuda"``.  There is
no silent fallback: asking for CUDA on a machine without a usable card
raises, and only an explicit ``device="cpu"`` runs on the CPU.  An
explicit ``device="meta"`` gives shape-and-dtype stand-ins (the launch
layer's abstract state), where an entry point supports it.

The lane engine and its front ends also take a list (or tuple) of
devices, over which each chunk of lanes is split (:func:`resolve_devices`).
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

__all__ = ["DeviceSpec", "resolve_device", "resolve_devices"]

# What the lane engine's entry points take as ``device``: one device, a
# list or tuple of them (a split), or ``None`` (CUDA).
DeviceSpec = Union[str, torch.device, Sequence[Union[str, torch.device]],
                   None]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The torch device an entry point runs on (``None`` means CUDA)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA unless told otherwise, and no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    if (dev.type == "cuda" and dev.index is not None
            and dev.index >= torch.cuda.device_count()):
        raise ValueError(f"{dev} names a card beyond the "
                         f"{torch.cuda.device_count()} visible")
    return dev


def resolve_devices(device: DeviceSpec = None) -> tuple[torch.device, ...]:
    """The devices a lane grid's chunks are split over.

    A list or tuple gives its entries, each through :func:`resolve_device`
    (repeats allowed: ``["cpu"] * 4`` cuts a chunk into four shards on
    the CPU); it must be non-empty and of one device type, CUDA or CPU.
    ``None`` gives every visible card when there are more than one, else
    ``(resolve_device(None),)``.  A single device gives itself alone.
    """
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("a device list needs at least one device")
        types = {torch.device(d).type for d in device}
        if len(types) > 1:
            raise ValueError(f"a device list mixes device types "
                             f"{sorted(types)}")
        if not types <= {"cuda", "cpu"}:
            raise ValueError(f"a device list takes CUDA or CPU devices, "
                             f"got {types.pop()}")
        return tuple(resolve_device(d) for d in device)
    dev = resolve_device(device)
    if device is None and torch.cuda.device_count() > 1:
        return tuple(torch.device("cuda", k)
                     for k in range(torch.cuda.device_count()))
    return (dev,)
