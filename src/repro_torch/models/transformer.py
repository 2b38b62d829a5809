"""Dense decoder blocks: parameter init and the teacher-forced forward pass.

The port of the dense part of ``repro/models/transformer.py`` (``:50-237``,
``:408-499``): global ("attn") and sliding-window ("local") attention
blocks with a SwiGLU FFN, RMSNorm, RoPE, token embedding and an LM head
(untied or tied).

The parameter tree keeps the reference's layout, so that the train state
flattens to the same leaves (:mod:`repro_torch.tree`): the repeats of the
block unit are stacked along a leading layer axis in the ``layers`` tuple
(one dict per kind in the unit), a remainder runs as the ``tail`` tuple,
and weights are ``x @ W`` matrices of shape ``(in, out)``.  The stacked
layers run as a Python loop over :func:`torch.unbind` views (one stacked
gradient per weight, no per-layer zero-fill).

Not ported yet, and raising ``NotImplementedError``: MoE FFNs (ROADMAP
Queue A item 10.2), RG-LRU (10.3), xLSTM (10.4), M-RoPE (10.5),
encoder-only inputs (10.6), and ``attn_impl != "ref"`` (the attention
kernels, Queue B4/B5).  ``cfg.remat`` is ignored: the port keeps every
activation, which does not change the numbers.
"""

from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .layers import (apply_rope, chunked_attention, dense_init, norm_init,
                     rms_norm, rope_angles, swiglu, swiglu_init)

__all__ = ["forward_train", "init_params", "param_dtype"]

_DENSE = ("attn", "local")


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the parts of ``cfg`` the port does not run yet."""
    if cfg.n_experts:
        raise NotImplementedError(f"{cfg.name}: MoE FFNs are ROADMAP Queue "
                                  f"A item 10.2")
    for kind in cfg.blocks:
        if kind == "rec":
            raise NotImplementedError(f"{cfg.name}: RG-LRU blocks are "
                                      f"ROADMAP Queue A item 10.3")
        if kind in ("mlstm", "slstm"):
            raise NotImplementedError(f"{cfg.name}: xLSTM blocks are "
                                      f"ROADMAP Queue A item 10.4")
        if kind not in _DENSE:
            raise ValueError(f"unknown block kind {kind!r}")
    if cfg.mrope_sections is not None:
        raise NotImplementedError(f"{cfg.name}: M-RoPE is ROADMAP Queue A "
                                  f"item 10.5")
    if not cfg.embed_inputs:
        raise NotImplementedError(f"{cfg.name}: encoder-only inputs are "
                                  f"ROADMAP Queue A item 10.6")
    if cfg.attn_impl != "ref":
        raise NotImplementedError(
            f"{cfg.name}: attn_impl={cfg.attn_impl!r} needs the attention "
            f"kernels (ROADMAP Queue B4/B5); the port trains through "
            f"attn_impl='ref'")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _block_init(cfg: ModelConfig, kind: str, gen: torch.Generator,
                lead: tuple[int, ...]) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    dt = param_dtype(cfg)
    dev = gen.device
    p: dict = {"norm_t": norm_init(d, dt, dev, lead=lead)}
    if kind in _DENSE:
        p["attn"] = {
            "w_q": dense_init(gen, d, cfg.n_heads * hd, dt, lead=lead),
            "w_k": dense_init(gen, d, cfg.n_kv_heads * hd, dt, lead=lead),
            "w_v": dense_init(gen, d, cfg.n_kv_heads * hd, dt, lead=lead),
            "w_o": dense_init(gen, cfg.n_heads * hd, d, dt, lead=lead),
        }
    if cfg.d_ff:
        p["norm_f"] = norm_init(d, dt, dev, lead=lead)
        p["ffn"] = swiglu_init(gen, d, cfg.d_ff, dt, lead=lead)
    return p


def init_params(cfg: ModelConfig, seed: int = 0,
                device: str | torch.device | None = None) -> dict:
    """The full parameter tree, drawn from ``torch.Generator(device)``
    seeded with ``seed`` (a pure function of (cfg, seed, device type)).
    ``device=None`` means CUDA, as everywhere in the port."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = param_dtype(cfg)
    unit = cfg.block_unit
    n_rep = cfg.n_layers // len(unit)
    n_tail = cfg.n_layers - n_rep * len(unit)

    params: dict = {}
    emb = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                      dtype=torch.float32, device=dev) \
        * (1.0 / math.sqrt(cfg.d_model))
    params["embed"] = emb.to(dt)
    params["norm_out"] = norm_init(cfg.d_model, dt, dev)
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt)
    params["layers"] = tuple(_block_init(cfg, kind, gen, (max(n_rep, 1),))
                             for kind in unit)
    if n_tail:
        tail_kinds = cfg.blocks[n_rep * len(unit):]
        params["tail"] = tuple(_block_init(cfg, kind, gen, ())
                               for kind in tail_kinds)
    return params


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def _attn_apply(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["w_q"]).reshape(b, s, cfg.n_heads, hd)
    k = (x @ p["w_k"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ p["w_v"]).reshape(b, s, cfg.n_kv_heads, hd)
    k = apply_rope(k, cos, sin)
    q = apply_rope(q, cos, sin)
    if cfg.attn_layout == "repeat_kv":
        g = cfg.n_heads // cfg.n_kv_heads
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    window = cfg.attn_window if kind == "local" else 0
    out = chunked_attention(q, k, v, causal=cfg.causal, window=window,
                            q_chunk=cfg.attn_q_chunk,
                            kv_chunk=cfg.attn_kv_chunk)
    return out.reshape(b, s, cfg.n_heads * hd) @ p["w_o"]


def _block_apply_full(cfg: ModelConfig, kind: str, p: dict,
                      x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["norm_t"], cfg.norm_eps)
    x = x + _attn_apply(cfg, kind, p["attn"], h, cos, sin)
    if "ffn" in p:
        h = rms_norm(x, p["norm_f"], cfg.norm_eps)
        x = x + swiglu(p["ffn"], h)
    return x


def _unbind_tree(tree: dict, n: int) -> list[dict]:
    """A stacked param dict as ``n`` per-layer dicts of views."""
    out: list[dict] = [{} for _ in range(n)]
    for key, val in tree.items():
        parts = (_unbind_tree(val, n) if isinstance(val, dict)
                 else torch.unbind(val, 0))
        for i in range(n):
            out[i][key] = parts[i]
    return out


def _embed(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    tokens = batch["tokens"].to(device=params["embed"].device,
                                dtype=torch.long)
    return params["embed"][tokens]


def _head(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["norm_out"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["head"]


def forward_train(cfg: ModelConfig, params: dict, batch: dict
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced pass. Returns (logits (B,S,V), moe_aux_loss scalar)."""
    check_supported(cfg)
    x = _embed(cfg, params, batch)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    unit = cfg.block_unit
    n_rep = cfg.n_layers // len(unit)
    per_kind = [_unbind_tree(stack, n_rep) for stack in params["layers"]]
    for i in range(n_rep):
        for kind, layers in zip(unit, per_kind):
            x = _block_apply_full(cfg, kind, layers[i], x, cos, sin)
    tail = params.get("tail", ())
    for kind, p in zip(cfg.blocks[len(cfg.blocks) - len(tail):], tail):
        x = _block_apply_full(cfg, kind, p, x, cos, sin)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(cfg, params, x), aux
