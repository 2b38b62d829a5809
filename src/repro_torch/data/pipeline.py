"""Synthetic deterministic LM data stream.

The port of ``repro/data/pipeline.py:29-90`` for token inputs: an infinite,
seedable, stateless-resumable stream.  ``batch_at(step)`` is a pure
function of (seed, step), so resuming from a checkpoint needs only the
step counter, which the train state carries as ``data_step``.

The reference draws from ``jax.random``, whose bits torch cannot replay.
The port draws on the host from numpy's ``default_rng([seed, step])`` and
keeps the contract and the statistics: a Zipf(a = 1.2) unigram over the
vocabulary, and a first-order Markov chain that follows
``x_t = (x_{t-1} + 17) mod V`` with probability 0.65, else takes a fresh
Zipf draw.  Parity tests of the model and the trainer feed the reference's
own batches through numpy instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import InputShape, ModelConfig

__all__ = ["DataConfig", "SyntheticLM"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    zipf_a: float = 1.2          # unigram power-law exponent
    bigram_shift: int = 17       # next-token bias: x_{t+1} ~ x_t + shift
    bigram_prob: float = 0.65    # probability of following the bigram rule


class SyntheticLM:
    """Deterministic synthetic LM stream for (cfg, shape)."""

    def __init__(self, cfg: ModelConfig, shape: InputShape,
                 data_cfg: DataConfig = DataConfig()) -> None:
        if not cfg.embed_inputs or cfg.mrope_sections is not None:
            raise NotImplementedError(
                f"{cfg.name}: the port's stream has token inputs only; "
                f"audio and VLM batches are ROADMAP Queue A items 10.5-10.6")
        self.cfg = cfg
        self.shape = shape
        self.data_cfg = data_cfg
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-data_cfg.zipf_a)
        self._cdf = np.cumsum(probs / probs.sum())

    def batch_at(self, step: int) -> dict:
        """Batch for a given step: a pure function of (seed, step).
        ``{"tokens": (B, S) int32}`` on the CPU."""
        b, s = self.shape.global_batch, self.shape.seq_len
        v = self.cfg.vocab_size
        rng = np.random.default_rng([self.data_cfg.seed, step])
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

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
