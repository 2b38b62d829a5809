"""Public model API: the training loss of decoder LMs, prompt batches and
the serving modes.

The port of ``repro/models/model.py:33-80`` and ``:129-140`` for token
inputs: next-token cross entropy in float32, a logsumexp minus the target
logit, where the target logit is taken by the reference's masked
reduction over the vocab axis (``_pick``), not by a gather, plus
``router_aux_coef`` times the MoE layers' load-balance loss.  The
masked-prediction loss of the encoder-only models waits for them (ROADMAP
Queue A item 10.6).  :func:`make_batch` draws tokens from an explicit
``torch.Generator``: the reference's ``jax.random`` draw cannot be
replayed, so tests that compare the two packages give both the same numpy
tokens instead.
"""

from __future__ import annotations

import torch

from ..configs.base import InputShape, ModelConfig
from .transformer import (decode_step, forward_train, init_cache,
                          init_params, param_dtype, prefill)

__all__ = ["cache_len_for", "decode_step", "forward_train", "init_cache",
           "init_params", "loss_fn", "make_batch", "param_dtype", "prefill"]


def cache_len_for(cfg: ModelConfig, shape: InputShape) -> int:
    """Decode-cache length for a shape (the cache covers the full
    context)."""
    return shape.seq_len


def make_batch(cfg: ModelConfig, shape: InputShape,
               gen: torch.Generator) -> dict:
    """A random token batch (B, S) int32, uniform over the vocabulary, on
    ``gen``'s device."""
    tokens = torch.randint(0, cfg.vocab_size,
                           (shape.global_batch, shape.seq_len),
                           generator=gen, device=gen.device,
                           dtype=torch.int32)
    return {"tokens": tokens}


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
