"""Device policy of the port: CUDA unless the caller asks for the CPU.

Every entry point takes ``device=None``, which means ``"cuda"``.  There is
no silent fallback: asking for CUDA on a machine without a usable card
raises, and only an explicit ``device="cpu"`` runs on the CPU.  An
explicit ``device="meta"`` gives shape-and-dtype stand-ins (the launch
layer's abstract state), where an entry point supports it.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The torch device an entry point runs on (``None`` means CUDA)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA unless told otherwise, and no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
