"""Checkpoint manager: periodic (full) + proactive (delta) checkpoints.

The port of ``repro/ckpt/manager.py:48-273``, the framework realization of
the paper's two checkpoint costs:

  * C   — a *full* checkpoint: every leaf of the train state written to
          stable storage, double-buffered (the previous checkpoint is
          dropped only once the new one is durable, so a fault during a
          checkpoint rolls back to the previous one, as in the paper).
  * C_p — a *proactive* checkpoint taken on a fault prediction: each large
          float leaf as a blockwise int8 delta against the last full
          checkpoint (``kernels/ckpt_delta.py``), the other leaves raw.
          Restoring adds the dequantized delta back to the base.

The on-disk layout is the reference's, file for file: ``full_%08d.npz``
(``leaf_i``, ``__names__``) and ``delta_%08d.npz`` (``q_i``, ``s_i``,
``raw_i``, ``__base__``), leaves in ``jax.tree.leaves`` order
(:mod:`repro_torch.tree`), bfloat16 stored as its uint16 bits.  A
checkpoint written by either manager restores in the other.

A leaf is quantized exactly when the reference quantizes it:
``np.issubdtype(dtype, np.floating)`` and at least ``block`` elements.
numpy's floating types are float16/32/64; bfloat16 is not among them, so
bf16 parameters, like the integer ``step`` leaves, are stored raw.

Where the port differs: the base of the deltas, the state of the last full
save, is kept **on the device** (the reference keeps a host copy), and
only for the leaves a proactive save quantizes; the others are stored raw
and need no base.  The quantize kernel then reads cur and base in device
memory, and only q and the scales cross to the host.  For tinyllama-1.1b
that copy is the fp32 AdamW moments, 8.8 GB of the card's 80 GB.  On a
CUDA state the quantize and dequantize are the CUDA kernels, never the
plain versions.  Their kernels take fp32 and bf16; a float16 or float64
leaf, which no config of the port has, makes a CUDA save raise.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from typing import Any

import numpy as np
import torch

from ..kernels import ckpt_delta as _delta
from ..models.convert import tensor_from_numpy, tensor_to_numpy
from ..tree import flatten, leaf_names, unflatten

__all__ = ["DELTA_RATIO_PRIOR", "SaveInfo", "CheckpointManager",
           "is_quantized", "state_bytes", "modeled_costs_from_bytes"]

# Prior payload ratio of proactive (int8 delta + per-block scales) vs full
# (bf16/fp32) checkpoints, used until a manager has measured its own saves.
DELTA_RATIO_PRIOR = 0.27

# The leaf dtypes numpy calls floating (np.issubdtype(., np.floating)).
_NP_FLOATING = (torch.float16, torch.float32, torch.float64)


def modeled_costs_from_bytes(nbytes: float, *, bandwidth: float,
                             n_shards: int = 1,
                             delta_ratio: float = DELTA_RATIO_PRIOR,
                             ) -> tuple[float, float]:
    """(C, C_p) in seconds from a state size in bytes (no state needed)."""
    b = nbytes / max(1, n_shards)
    return b / bandwidth, delta_ratio * b / bandwidth


def state_bytes(state: Any) -> int:
    return sum(t.numel() * t.element_size() for t in flatten(state))


def is_quantized(leaf: torch.Tensor, block: int = 256) -> bool:
    """Whether a proactive save stores ``leaf`` as an int8 delta (the
    reference's ``manager.py:175`` predicate, in torch terms)."""
    return leaf.dtype in _NP_FLOATING and leaf.numel() >= block


def _decode(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A stored leaf as a tensor of ``like``'s dtype on ``like``'s device."""
    if like.dtype == torch.bfloat16 and arr.dtype == np.uint16:
        return tensor_from_numpy(arr, like.device)
    return torch.from_numpy(np.asarray(arr)).to(device=like.device,
                                                dtype=like.dtype)


@dataclasses.dataclass(frozen=True)
class SaveInfo:
    step: int
    kind: str          # "full" | "proactive"
    bytes: int         # serialized payload size
    seconds: float     # measured wall-clock (host) save time
    path: str

    def modeled_cost(self, bandwidth: float, n_shards: int = 1) -> float:
        """Modeled checkpoint duration: per-shard bytes / bandwidth."""
        return self.bytes / max(1, n_shards) / bandwidth


class CheckpointManager:
    """Double-buffered full checkpoints + delta-encoded proactive ones."""

    def __init__(self, directory: str, *, keep: int = 2,
                 bandwidth: float = 2e9, block: int = 256) -> None:
        self.dir = directory
        self.keep = keep
        self.bandwidth = bandwidth
        self.block = block
        os.makedirs(directory, exist_ok=True)
        # Device copy of the last full save's quantized leaves (None for
        # the leaves stored raw).
        self._last_full_state: list[torch.Tensor | None] | None = None
        self._last_full_step: int = -1
        self._last_full_bytes: int = -1     # measured full payload size
        self._delta_ratios: list[float] = []  # measured delta/full ratios

    # -- paths ---------------------------------------------------------------

    def _full_path(self, step: int) -> str:
        return os.path.join(self.dir, f"full_{step:08d}.npz")

    def _delta_path(self, step: int) -> str:
        return os.path.join(self.dir, f"delta_{step:08d}.npz")

    def checkpoints(self) -> list[tuple[int, str]]:
        """Sorted [(step, kind)] of all durable checkpoints."""
        out = []
        for f in os.listdir(self.dir):
            m = re.match(r"(full|delta)_(\d+)\.npz$", f)
            if m:
                out.append((int(m.group(2)), m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        cks = self.checkpoints()
        return cks[-1][0] if cks else None

    # -- full checkpoints ------------------------------------------------------

    def save(self, step: int, state: Any) -> SaveInfo:
        """Full checkpoint (paper cost C).  Atomic: tmp + rename."""
        t0 = time.perf_counter()
        leaves = [t.detach() for t in flatten(state)]
        payload = {f"leaf_{i}": tensor_to_numpy(t)
                   for i, t in enumerate(leaves)}
        payload["__names__"] = np.asarray(json.dumps(leaf_names(state)))
        path = self._full_path(step)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)  # durable before the old one is dropped
        del payload
        secs = time.perf_counter() - t0
        self._last_full_state = None         # free the old base first
        self._last_full_state = [t.clone() if is_quantized(t, self.block)
                                 else None for t in leaves]
        self._last_full_step = step
        self._gc()
        nbytes = os.path.getsize(path)
        self._last_full_bytes = nbytes
        return SaveInfo(step, "full", nbytes, secs, path)

    # -- proactive (delta) checkpoints ----------------------------------------

    def save_proactive(self, step: int, state: Any) -> SaveInfo:
        """Proactive checkpoint (paper cost C_p): int8 delta vs last full.

        Falls back to a full save if no full checkpoint exists yet.
        """
        if self._last_full_state is None:
            return self.save(step, state)
        t0 = time.perf_counter()
        leaves = [t.detach() for t in flatten(state)]
        payload: dict[str, np.ndarray] = {}
        for i, (cur, base) in enumerate(zip(leaves, self._last_full_state)):
            if is_quantized(cur, self.block):
                q, scales = _delta.quantize_delta(cur, base,
                                                  block=self.block)
                payload[f"q_{i}"] = q.cpu().numpy()
                payload[f"s_{i}"] = scales.cpu().numpy()
            else:  # small / integer / bfloat16 leaves stored raw
                payload[f"raw_{i}"] = tensor_to_numpy(cur)
        payload["__base__"] = np.asarray(self._last_full_step)
        path = self._delta_path(step)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
        secs = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        if self._last_full_bytes > 0:
            self._delta_ratios.append(nbytes / self._last_full_bytes)
        return SaveInfo(step, "proactive", nbytes, secs, path)

    # -- restore ----------------------------------------------------------------

    def restore(self, like: Any, step: int | None = None) -> tuple[int, Any]:
        """Restore the latest (or a given) checkpoint into the structure,
        dtypes and devices of ``like`` (a train state)."""
        cks = self.checkpoints()
        if not cks:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        if step is None:
            step, kind = cks[-1]
        else:
            kind = dict(cks)[step]
        if kind == "full":
            return step, self._restore_full(like, step)
        return step, self._restore_delta(like, step)

    def _restore_full(self, like: Any, step: int) -> Any:
        flat_like = flatten(like)
        with np.load(self._full_path(step), allow_pickle=False) as z:
            out = [_decode(z[f"leaf_{i}"], t)
                   for i, t in enumerate(flat_like)]
        return unflatten(like, out)

    def _restore_delta(self, like: Any, step: int) -> Any:
        with np.load(self._delta_path(step), allow_pickle=False) as z:
            base_step = int(z["__base__"])
            flat_base = flatten(self._restore_full(like, base_step))
            out = []
            for i, b in enumerate(flat_base):
                if f"q_{i}" in z:
                    q = torch.from_numpy(z[f"q_{i}"]).to(b.device)
                    s = torch.from_numpy(z[f"s_{i}"]).to(b.device)
                    cur = _delta.dequantize_delta(q, s, b, block=self.block)
                    out.append(cur.to(b.dtype))
                else:
                    out.append(_decode(z[f"raw_{i}"], b))
                flat_base[i] = None          # free each base leaf once used
        return unflatten(like, out)

    # -- cost model ---------------------------------------------------------------

    @property
    def measured_delta_ratio(self) -> float | None:
        """Mean measured proactive/full payload ratio, or None if this
        manager has not yet written a delta against a measured full."""
        if not self._delta_ratios:
            return None
        return sum(self._delta_ratios) / len(self._delta_ratios)

    def modeled_costs(self, state: Any, n_shards: int = 1,
                      delta_ratio: float | None = None) -> tuple[float, float]:
        """(C, C_p) in seconds from bytes/bandwidth.

        When ``delta_ratio`` is None the ratio measured from this manager's
        own saves is used; before any delta, ``DELTA_RATIO_PRIOR``.
        """
        if delta_ratio is None:
            measured = self.measured_delta_ratio
            delta_ratio = DELTA_RATIO_PRIOR if measured is None else measured
        return modeled_costs_from_bytes(
            state_bytes(state), bandwidth=self.bandwidth, n_shards=n_shards,
            delta_ratio=delta_ratio)

    # -- gc -------------------------------------------------------------------

    def _gc(self) -> None:
        """Keep the last ``keep`` full checkpoints (+ deltas on them)."""
        fulls = [s for s, k in self.checkpoints() if k == "full"]
        for s in fulls[:-self.keep]:
            os.remove(self._full_path(s))
            for ds, dk in self.checkpoints():
                if dk == "delta":
                    with np.load(self._delta_path(ds)) as z:
                        if int(z["__base__"]) == s:
                            os.remove(self._delta_path(ds))
