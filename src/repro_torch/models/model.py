"""Public model API: the training losses, batches and the serving modes.

The port of ``repro/models/model.py:33-84``, ``:129-156`` and
``:159-165`` (:func:`state_bytes`): for decoder
LMs, next-token cross entropy; for encoder-only (audio) models, the
masked-prediction cross entropy over the codebook at the ``mask``
positions (HuBERT-style), over at least one position.  Both are float32, a
logsumexp minus the target logit, where the target logit is taken by the
reference's masked reduction over the vocab axis (``_pick``), not by a
gather, plus ``router_aux_coef`` times the MoE layers' load-balance loss.

:func:`make_batch` draws from an explicit ``torch.Generator``: tokens; for
a VLM also the vision-stub patch embeddings, with the reference's
deterministic ``vision_mask`` (the first quarter of the sequence) and
(t, h, w) ``positions_thw`` (:func:`vision_layout`); for an audio encoder
frame embeddings, labels and a Bernoulli(0.35) mask.  The reference's
``jax.random`` draws cannot be replayed, so tests that compare the two
packages give both the same numpy inputs instead.
"""

from __future__ import annotations

from typing import Any

import torch

from ..configs.base import InputShape, ModelConfig
from ..tree import flatten
from .transformer import (decode_step, forward_train, init_cache,
                          init_params, param_dtype, prefill)

__all__ = ["MASK_PROB", "VISION_FRACTION", "cache_len_for", "decode_step",
           "forward_train", "init_cache", "init_params", "loss_fn",
           "make_batch", "param_dtype", "prefill", "state_bytes",
           "vision_layout"]

# The vision stub's share of the sequence that is image patches, and the
# audio batches' masked-prediction rate (repro/models/model.py:30, :141).
VISION_FRACTION = 0.25
MASK_PROB = 0.35


def cache_len_for(cfg: ModelConfig, shape: InputShape) -> int:
    """Decode-cache length for a shape (the cache covers the full
    context)."""
    return shape.seq_len


def vision_layout(b: int, s: int, device: str | torch.device = "cpu"
                  ) -> tuple[int, torch.Tensor, torch.Tensor]:
    """The vision stub's geometry, deterministic as in the reference: the
    first ``n_patches = max(1, int(s * VISION_FRACTION))`` positions are
    patches on a (t, h, w) = (0, i // grid % grid, i % grid) grid, with
    ``grid = int(sqrt(n_patches)) + 1``; text positions continue after it
    at (p - n_patches + grid) in all three.  Returns (n_patches,
    vision_mask (B, S) bool, positions_thw (B, S, 3) int32)."""
    n_patches = max(1, int(s * VISION_FRACTION))
    pos = torch.arange(s, device=device)
    vision = pos < n_patches
    grid = int(n_patches ** 0.5) + 1
    text = pos - n_patches + grid
    thw = torch.stack([torch.where(vision, 0, text),
                       torch.where(vision, (pos // grid) % grid, text),
                       torch.where(vision, pos % grid, text)], dim=-1)
    return (n_patches, vision.expand(b, s).contiguous(),
            thw.to(torch.int32).expand(b, s, 3).contiguous())


def make_batch(cfg: ModelConfig, shape: InputShape,
               gen: torch.Generator) -> dict:
    """A random batch on ``gen``'s device: tokens (B, S) int32, uniform
    over the vocabulary; for a VLM also ``vision_embeds`` (B, n_patches,
    d) ~ N(0, 1) in the parameter dtype with :func:`vision_layout`'s mask
    and positions; for an audio encoder ``frames`` (B, S, d) ~ N(0, 1) in
    the parameter dtype, ``labels`` (B, S) int32 uniform over the codebook
    and ``mask`` (B, S) bool, Bernoulli(MASK_PROB)."""
    b, s = shape.global_batch, shape.seq_len
    dev, dt = gen.device, param_dtype(cfg)

    def normal(shp):
        return torch.randn(shp, generator=gen, dtype=torch.float32,
                           device=dev).to(dt)

    def labels():
        return torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                             device=dev, dtype=torch.int32)

    if not cfg.embed_inputs:
        return {"frames": normal((b, s, cfg.d_model)), "labels": labels(),
                "mask": torch.rand((b, s), generator=gen, device=dev)
                < MASK_PROB}
    out = {"tokens": labels()}
    if cfg.mrope_sections is not None:
        n_patches, mask, thw = vision_layout(b, s, dev)
        out.update(vision_embeds=normal((b, n_patches, cfg.d_model)),
                   vision_mask=mask, positions_thw=thw)
    return out


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


def _masked_loss(cfg: ModelConfig, logits: torch.Tensor,
                 labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked-prediction CE over the codebook (HuBERT-style): the mean over
    the masked positions, over at least one."""
    logits = logits.float()
    labels = labels.to(device=logits.device, dtype=torch.long)
    mask = mask.to(device=logits.device, dtype=torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    per_tok = (lse - _pick(logits, labels)) * mask
    return per_tok.sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """Training loss (+ metrics dict). Differentiable in ``params``."""
    logits, moe_aux = forward_train(cfg, params, batch)
    if cfg.embed_inputs:
        loss = _lm_loss(cfg, logits, batch["tokens"])
    else:
        loss = _masked_loss(cfg, logits, batch["labels"], batch["mask"])
    total = loss + cfg.router_aux_coef * moe_aux
    return total, {"loss": loss, "moe_aux": moe_aux}


def state_bytes(params: Any, opt_state: Any = None) -> int:
    """Total bytes of a (params, optimizer) state tree (checkpoint
    payload): each tensor leaf's ``numel * element_size``."""
    total = 0
    for leaf in flatten(params) + (
            flatten(opt_state) if opt_state is not None else []):
        if leaf is not None:      # jax.tree.leaves skips None
            total += leaf.numel() * leaf.element_size()
    return total
