"""Carry weights, train states and decode caches between the JAX package
and the port.

Both packages keep one parameter layout: nested dicts, the ``layers``
tuple of stacked tensors, and ``x @ W`` weights of shape ``(in, out)``;
and one decode-cache layout: ``layers`` (a tuple of stacked entries, one
per kind of the block unit: ``{"k", "v"}`` for attention, ``{"h",
"conv"}`` for the RG-LRU, the tuples ``(C, n, m)`` and ``(c, n, m, h)``
for the mLSTM and sLSTM), ``tail`` and an int32 ``length``.  So a tree read as numpy
(``jax.tree.map(np.asarray, tree)``) becomes the port's tree leaf for
leaf with :func:`params_from_numpy`, and :func:`state_to_numpy` gives it
back, for parameters, train states and caches alike.

numpy has no bfloat16 of its own.  :func:`params_from_numpy` takes a
bfloat16 leaf either as the ``ml_dtypes`` array that ``np.asarray`` of a
JAX array gives, or as its ``uint16`` bits; :func:`state_to_numpy` gives
bfloat16 leaves back as ``uint16`` bits, the encoding the checkpoint files
use.  The bits are never routed through float32.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..tree import flatten, unflatten

__all__ = ["params_from_numpy", "state_to_numpy", "tensor_from_numpy",
           "tensor_to_numpy"]


def tensor_from_numpy(arr: Any, device: str | torch.device | None = None
                      ) -> torch.Tensor:
    """One leaf; bfloat16 (by dtype name) and uint16 become bfloat16.
    ``device=None`` means CUDA, as everywhere in the port."""
    dev = resolve_device(device)
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16" or arr.dtype == np.uint16:
        bits = np.ascontiguousarray(arr).view(np.int16)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(dev)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One leaf on the host; bfloat16 comes back as its uint16 bits."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def params_from_numpy(tree: Any, device: str | torch.device | None = None
                      ) -> Any:
    """A numpy tree (the reference's layout) as a tree of torch tensors on
    ``device`` (``None`` means CUDA)."""
    dev = resolve_device(device)
    return unflatten(tree, [tensor_from_numpy(a, dev)
                            for a in flatten(tree)])


def state_to_numpy(state: Any) -> Any:
    """A tree of torch tensors as a tree of numpy arrays (same layout)."""
    return unflatten(state, [tensor_to_numpy(t) for t in flatten(state)])
