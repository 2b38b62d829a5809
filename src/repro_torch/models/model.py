"""Public model API: the training loss of decoder LMs.

The port of ``repro/models/model.py:38-80`` for token inputs: next-token
cross entropy in float32, a logsumexp minus the target logit, where the
target logit is taken by the reference's masked reduction over the vocab
axis (``_pick``), not by a gather.  The masked-prediction loss of the
encoder-only models waits for them (ROADMAP Queue A item 10.6).
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .transformer import forward_train, init_params, param_dtype

__all__ = ["forward_train", "init_params", "loss_fn", "param_dtype"]


def _pick(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits[..., targets] via a masked reduction over the vocab axis."""
    iota = torch.arange(logits.shape[-1], device=logits.device)
    hit = iota == targets[..., None]
    return torch.sum(torch.where(hit, logits, 0.0), dim=-1)


def _lm_loss(cfg: ModelConfig, logits: torch.Tensor,
             tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy: predict tokens[:, 1:] from logits[:, :-1]."""
    logits = logits[:, :-1].float()
    targets = tokens[:, 1:].to(device=logits.device, dtype=torch.long)
    lse = torch.logsumexp(logits, dim=-1)
    picked = _pick(logits, targets)
    return torch.mean(lse - picked)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """Training loss (+ metrics dict). Differentiable in ``params``."""
    logits, moe_aux = forward_train(cfg, params, batch)
    loss = _lm_loss(cfg, logits, batch["tokens"])
    total = loss + cfg.router_aux_coef * moe_aux
    return total, {"loss": loss, "moe_aux": moe_aux}
