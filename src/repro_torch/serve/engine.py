"""Batched serving engine: prefill + KV-cache decode, greedy or sampled.

The port of ``repro/serve/engine.py``.  The engine serves a batch of
requests in lockstep (static-batch serving): :meth:`ServingEngine.prefill`
encodes the prompts and fills the decode cache, then
:meth:`ServingEngine.generate` runs single-token steps on the device the
parameters lie on.  Decode attention goes through the hand-written CUDA
kernel when ``cfg.attn_impl != "ref"`` (:mod:`repro_torch.models`).

As in the reference, the argmax of the prefill logits is the first token
fed to decode and is not returned; each step returns the chosen token and
the log-softmax of the unscaled logits at it.  The same engine serves every
decoder family the port runs (dense, MoE, the RG-LRU hybrid, xLSTM, the
M-RoPE VLM): the cache carries the attention entries and the recurrent
states alike.  A VLM batch (tokens, ``vision_embeds``, ``vision_mask``,
``positions_thw``) goes whole to prefill; the decode steps take no
``positions_thw``, as the reference's ``_step`` passes none, so each new
token sits at (length, length, length) (ROADMAP Queue C R3).  An
encoder-only config is refused: it has no decode step.  ``jax.random.categorical``
cannot be replayed in torch, so a sampled token is the Gumbel-max draw
``argmax(logits / T - log(-log U))`` with U uniform from a
``torch.Generator`` on the device, seeded with ``seed``; greedy decoding
(``temperature=0``, the parity target) draws nothing.  Each step writes
the attention caches in place and replaces the recurrent states.
"""

from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig
from ..models.model import decode_step, init_cache, prefill
from ..models.transformer import check_supported

__all__ = ["GenerateResult", "ServingEngine"]


@dataclasses.dataclass
class GenerateResult:
    tokens: torch.Tensor     # (B, n_new) int32
    logprobs: torch.Tensor   # (B, n_new) float32
    steps: int


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params: dict, *,
                 cache_len: int = 4096) -> None:
        if not cfg.causal:
            raise ValueError(f"{cfg.name} is encoder-only; nothing to serve")
        check_supported(cfg)
        self.cfg = cfg
        self.params = params
        self.cache_len = cache_len
        self.device = params["embed"].device

    @torch.no_grad()
    def prefill(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """Encode prompts. Returns (last-position logits, cache)."""
        return prefill(self.cfg, self.params, batch,
                       cache_len=self.cache_len)

    def _step(self, token: torch.Tensor, cache: dict, temperature: float,
              gen: torch.Generator) -> tuple[torch.Tensor, ...]:
        logits, cache = decode_step(self.cfg, self.params, token, cache)
        logits = logits.float()
        if temperature > 0:
            u = torch.rand(logits.shape, generator=gen, device=logits.device)
            tok = torch.argmax(logits / temperature - torch.log(-torch.log(u)),
                               dim=-1)
        else:
            tok = torch.argmax(logits, dim=-1)
        lp = torch.log_softmax(logits, dim=-1).gather(-1, tok[:, None])[:, 0]
        return tok.to(torch.int32), lp, cache

    @torch.no_grad()
    def generate(self, batch: dict, n_new: int, *, temperature: float = 0.0,
                 seed: int = 0) -> GenerateResult:
        logits, cache = self.prefill(batch)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        tok = torch.argmax(logits.float(), dim=-1).to(torch.int32)
        toks, lps = [], []
        for _ in range(n_new):
            tok, lp, cache = self._step(tok, cache, temperature, gen)
            toks.append(tok)
            lps.append(lp)
        return GenerateResult(torch.stack(toks, dim=1),
                              torch.stack(lps, dim=1), n_new)

    def fresh_cache(self, batch_size: int) -> dict:
        return init_cache(self.cfg, batch_size, self.cache_len,
                          device=self.device)
