"""AdamW, learning-rate schedules and global-norm clipping (functional torch).

The port of ``repro/optim/adamw.py:23-128``.  The optimizer state is a
tree aligned with the parameters, ``{"m": ..., "v": ..., "step": int32}``,
with fp32 or bf16 moments.  The update is the reference's operations in
the reference's order: clip by the global norm, bias correction folded
into the step (``m / c1``, ``v / c2``), the clamp ``v >= 0``, decoupled
weight decay, the new parameter cast back to its dtype.  It is not
``torch.optim.AdamW``, whose update differs.

Every division by a constant divides by a 0-dim tensor on the operands'
device, never by a Python number: on CUDA, torch turns ``x / scalar`` into
``x * (1 / scalar)``, which is not the IEEE quotient the reference takes.
The update is functional (new tensors), like the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from ..tree import flatten, unflatten

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "clip_by_global_norm", "cosine_schedule", "linear_schedule",
           "constant_schedule"]


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"

    def lr_at(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return _f32(self.lr, step)


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> Callable:
    """Linear warmup then cosine decay to ``floor_frac * peak``."""

    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak * step / _f32(max(1.0, warmup), step)
        prog = torch.clamp((step - warmup)
                           / _f32(max(1.0, total - warmup), step), 0.0, 1.0)
        cos = floor_frac * peak + (1.0 - floor_frac) * peak \
            * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)

    return lr


def linear_schedule(peak: float, warmup: int, total: int) -> Callable:
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak * step / _f32(max(1.0, warmup), step)
        decay = peak * torch.clamp(
            (total - step) / _f32(max(1.0, total - warmup), step), 0.0, 1.0)
        return torch.where(step < warmup, warm, decay)

    return lr


def constant_schedule(value: float) -> Callable:
    return lambda step: _f32(value, step)


def global_norm(tree: Any) -> torch.Tensor:
    leaves = [torch.sum(torch.square(leaf.float())) for leaf in flatten(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(
        _f32(max_norm, norm) / torch.clamp(norm, min=1e-12), max=1.0)


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(tree: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    leaves = [_clipped(g, scale) for g in flatten(tree)]
    return unflatten(tree, leaves), norm


def adamw_init(params: Any, cfg: AdamWConfig) -> dict:
    dt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32
    leaves = flatten(params)
    device = leaves[0].device if leaves else torch.device("cpu")

    def zeros():
        return unflatten(params, [torch.zeros(p.shape, dtype=dt,
                                              device=p.device)
                                  for p in leaves])

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_update(params: Any, grads: Any, state: dict, cfg: AdamWConfig,
                 ) -> tuple[Any, dict, dict]:
    """One AdamW step. Returns (new_params, new_state, metrics).

    Each gradient leaf is clipped just before its own update (the
    operations of :func:`clip_by_global_norm`), so no clipped copy of the
    whole tree exists, and each leaf's temporaries go as soon as they are
    used: at full width the new state beside the old one is what fills a
    card (recurrentgemma-2b's 35.5 GB twice)."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    step = state["step"] + 1
    lr = cfg.lr_at(step)
    b1, b2 = cfg.b1, cfg.b2
    # Bias correction folded into the step size.
    c1 = 1.0 - torch.pow(_f32(b1, step), step.float())
    c2 = 1.0 - torch.pow(_f32(b2, step), step.float())

    def upd(p, g, m, v):
        gf = _clipped(g, scale).float()
        m32 = m.float() * b1 + (1.0 - b1) * gf
        # v >= 0: a delta-quantized restore (the proactive C_p path) can
        # carry tiny negative noise into v.
        v32 = torch.clamp(v.float(), min=0.0) * b2 \
            + (1.0 - b2) * torch.square(gf)
        del gf
        mhat = m32 / c1
        vhat = torch.clamp(v32 / c2, min=0.0)
        denom = torch.sqrt(vhat) + cfg.eps
        del vhat
        delta = mhat / denom
        del mhat, denom
        delta = delta + cfg.weight_decay * p.float()
        newp = (p.float() - lr * delta).to(p.dtype)
        return newp, m32.to(m.dtype), v32.to(v.dtype)

    out = [upd(p, g, m, v) for p, g, m, v in
           zip(flatten(params), flatten(grads), flatten(state["m"]),
               flatten(state["v"]))]
    new_params = unflatten(params, [o[0] for o in out])
    new_state = {"m": unflatten(params, [o[1] for o in out]),
                 "v": unflatten(params, [o[2] for o in out]),
                 "step": step}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
