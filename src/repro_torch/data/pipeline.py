"""Synthetic deterministic LM data stream.

The port of ``repro/data/pipeline.py:29-90``: an infinite, seedable,
stateless-resumable stream.  ``batch_at(step)`` is a pure
function of (seed, step), so resuming from a checkpoint needs only the
step counter, which the train state carries as ``data_step``.

The reference draws from ``jax.random``, whose bits torch cannot replay.
The port draws on the host from numpy's ``default_rng([seed, step])`` and
keeps the contract and the statistics: a Zipf(a = 1.2) unigram over the
vocabulary, and a first-order Markov chain that follows
``x_t = (x_{t-1} + 17) mod V`` with probability 0.65, else takes a fresh
Zipf draw.  Audio and VLM configs get the structure of
:func:`~repro_torch.models.model.make_batch` (as the reference's stream
reuses its ``make_batch``), drawn from the same numpy generator: frames
and patch embeddings ~ N(0, 1) in the parameter dtype, labels and VLM
tokens uniform, the mask Bernoulli(0.35), and the deterministic vision
mask and (t, h, w) positions.  Parity tests of the model and the trainer
feed the reference's own batches through numpy instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import InputShape, ModelConfig
from ..models.model import MASK_PROB, param_dtype, vision_layout

__all__ = ["DataConfig", "SyntheticLM", "DataState"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    zipf_a: float = 1.2          # unigram power-law exponent
    bigram_shift: int = 17       # next-token bias: x_{t+1} ~ x_t + shift
    bigram_prob: float = 0.65    # probability of following the bigram rule


@dataclasses.dataclass
class DataState:
    """Pipeline cursor (what the checkpoint saves)."""

    step: int = 0


class SyntheticLM:
    """Deterministic synthetic LM stream for (cfg, shape)."""

    def __init__(self, cfg: ModelConfig, shape: InputShape,
                 data_cfg: DataConfig = DataConfig()) -> None:
        self.cfg = cfg
        self.shape = shape
        self.data_cfg = data_cfg
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-data_cfg.zipf_a)
        self._cdf = np.cumsum(probs / probs.sum())

    def batch_at(self, step: int) -> dict:
        """Batch for a given step: a pure function of (seed, step), on the
        CPU.  ``{"tokens": (B, S) int32}``, or :meth:`_stub_batch`'s for
        audio and VLM configs."""
        b, s = self.shape.global_batch, self.shape.seq_len
        v = self.cfg.vocab_size
        rng = np.random.default_rng([self.data_cfg.seed, step])
        if not self.cfg.embed_inputs or self.cfg.mrope_sections is not None:
            return self._stub_batch(rng)
        fresh = np.minimum(np.searchsorted(self._cdf, rng.random((b, s)),
                                           side="right"), v - 1)
        follow = rng.random((b, s)) < self.data_cfg.bigram_prob
        tokens = np.empty((b, s), dtype=np.int64)
        tokens[:, 0] = fresh[:, 0]
        for t in range(1, s):
            tokens[:, t] = np.where(
                follow[:, t],
                (tokens[:, t - 1] + self.data_cfg.bigram_shift) % v,
                fresh[:, t])
        return {"tokens": torch.from_numpy(tokens.astype(np.int32))}

    def _stub_batch(self, rng: np.random.Generator) -> dict:
        """The audio encoder's ``frames``, ``labels`` and ``mask``, or the
        VLM's uniform ``tokens``, ``vision_embeds``, ``vision_mask`` and
        ``positions_thw``."""
        cfg = self.cfg
        b, s = self.shape.global_batch, self.shape.seq_len
        dt = param_dtype(cfg)

        def normal(shp):
            return torch.from_numpy(
                rng.standard_normal(shp, dtype=np.float32)).to(dt)

        def labels():
            return torch.from_numpy(
                rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32))

        if not cfg.embed_inputs:
            return {"frames": normal((b, s, cfg.d_model)), "labels": labels(),
                    "mask": torch.from_numpy(rng.random((b, s)) < MASK_PROB)}
        n_patches, mask, thw = vision_layout(b, s)
        return {"tokens": labels(),
                "vision_embeds": normal((b, n_patches, cfg.d_model)),
                "vision_mask": mask, "positions_thw": thw}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
