"""Decoder blocks: parameter init and the three execution modes.

The port of ``repro/models/transformer.py``: global ("attn") and
sliding-window ("local") attention blocks, RG-LRU ("rec", :mod:`.rglru`)
and xLSTM ("mlstm", "slstm", :mod:`.xlstm`) blocks, each attention or
RG-LRU block with an FFN (SwiGLU, or the MoE of :mod:`.moe`), RMSNorm,
RoPE or M-RoPE, the inputs (token embedding; for a VLM, vision patch
embeddings in place of the tokens at the ``vision_mask`` positions; for an
encoder-only model, frame embeddings as they are, and no ``embed`` leaf)
and an LM head (untied or tied), run as

* :func:`forward_train`: the teacher-forced pass -> logits and the
  MoE layers' summed router aux loss;
* :func:`prefill`: the full-sequence pass that also fills the decode cache;
* :func:`decode_step`: one token against the cache.

The parameter tree keeps the reference's layout, so that the train state
flattens to the same leaves (:mod:`repro_torch.tree`): the repeats of the
block unit are stacked along a leading layer axis in the ``layers`` tuple
(one dict per kind in the unit), a remainder runs as the ``tail`` tuple,
and weights are ``x @ W`` matrices of shape ``(in, out)``.  The stacked
layers run as a Python loop over :func:`torch.unbind` views (one stacked
gradient per weight, no per-layer zero-fill).  The decode cache keeps the
reference's tree too: ``layers`` is a tuple (one entry per kind of the
unit) stacked along the layer axis, ``tail`` a tuple, ``length`` ``(B,)``
int32.  An "attn" entry is ``{"k", "v"}``, each a ``(B, cache_len, KV,
hd)`` append buffer (valid prefix = length); a "local" entry the same as
a ``(B, window, KV, hd)`` ring buffer (slot of position t = t mod
window); "rec" ``{"h": (B, w) f32, "conv": (B, cw - 1, w)}``; "mlstm" the
tuple ``(C~ (B, H, hd, hd), n~ (B, H, hd), m (B, H))`` in float32 with hd
= 2 d / H; "slstm" the tuple ``(c, n, m, h)``, each ``(B, d)`` float32.

Attention follows ``cfg.attn_impl`` as in the reference, dispatched by
:mod:`repro_torch.kernels.ops`: ``"ref"`` runs the plain
``chunked_attention`` / ``decode_attention`` of :mod:`.layers`; any other
value the hand-written flash kernel in :func:`forward_train` and the
decode kernel in :func:`decode_step`.  :func:`prefill` runs
``chunked_attention`` whatever ``attn_impl`` is, as the reference's does.

Unlike the reference, :func:`prefill` writes into a fresh cache and
:func:`decode_step` writes the new token's k and v into the cache it is
given, in place, and returns that cache: the reference's one-hot blend
(``_scatter_time``) reads and writes every layer's whole cache three times
a token.  A caller that reuses a cache clones it first.  The recurrent
entries are replaced, as in the reference: :func:`decode_step` returns
new stacked state tensors and leaves the given ones as they were.

MoE layers drop at ``cfg.capacity_factor`` in :func:`forward_train` and
:func:`prefill`, and are dropless in :func:`decode_step`, as in the
reference.

M-RoPE configs (``cfg.mrope_sections``) take their tables from the
batch's ``positions_thw`` (B, S, 3), or (pos, pos, pos) without it; a
decode step places the new token at ``positions_thw`` (B, 3) if given,
else at (length, length, length), as the reference does.  Encoder-only
configs (``embed_inputs=False``, bidirectional) have no decode step.
Under ``cfg.remat`` a :func:`forward_train` that autograd records runs
each repeat of the block unit as one checkpoint region, recomputed in the
backward, and the tail outside, as the reference's ``_scan_over_repeats``
does, on plain tensors and DTensors alike: the backward keeps each
unit's input, not its activations, and the numbers do not change.  On
DTensors (the launch layer's sharded steps) the model follows the
reference's sharding annotations
(:func:`repro_torch.parallel.sharding.constrain`), runs attention on each
device's shards, and builds a sharded prefill cache.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..kernels import ops
from ..parallel.sharding import (constrain, is_dtensor, per_shard,
                                 replicate_dims, sharded_zeros, split_dim)
from ..tree import is_axes, tree_map
from .layers import (apply_rope, chunked_attention, dense_init,
                     mrope_angles, norm_init, rms_norm, rope_angles, swiglu,
                     swiglu_axes, swiglu_init)
from .moe import moe_apply, moe_axes, moe_init
from .rglru import (rglru_block_apply, rglru_block_axes, rglru_block_init,
                    rglru_decode_step, rglru_init_state)
from .xlstm import (mlstm_block_apply, mlstm_block_axes, mlstm_block_init,
                    mlstm_decode_step, mlstm_init_state, slstm_block_apply,
                    slstm_block_axes, slstm_block_init, slstm_decode_step,
                    slstm_init_state)

__all__ = ["cache_axes", "decode_step", "forward_train", "init_cache",
           "init_params", "param_axes", "param_dtype", "prefill"]

_ATTN = ("attn", "local")
_KINDS = _ATTN + ("rec", "mlstm", "slstm")
_XLSTM = ("mlstm", "slstm")     # blocks without an FFN
_RESIDUAL = ("batch", "seq", "embed")


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a block kind or ``attn_impl`` the port does not know."""
    for kind in cfg.blocks:
        if kind not in _KINDS:
            raise ValueError(f"unknown block kind {kind!r}")
    ops.check_impl(cfg.attn_impl)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _block_init(cfg: ModelConfig, kind: str, gen: torch.Generator,
                lead: tuple[int, ...]) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    dt = param_dtype(cfg)
    dev = gen.device
    p: dict = {"norm_t": norm_init(d, dt, dev, lead=lead)}
    if kind in _ATTN:
        p["attn"] = {
            "w_q": dense_init(gen, d, cfg.n_heads * hd, dt, lead=lead),
            "w_k": dense_init(gen, d, cfg.n_kv_heads * hd, dt, lead=lead),
            "w_v": dense_init(gen, d, cfg.n_kv_heads * hd, dt, lead=lead),
            "w_o": dense_init(gen, cfg.n_heads * hd, d, dt, lead=lead),
        }
    elif kind == "rec":
        p["rec"] = rglru_block_init(gen, d, cfg.lru_width, cfg.conv1d_width,
                                    dt, lead=lead)
    elif kind == "mlstm":
        p["mlstm"] = mlstm_block_init(gen, d, cfg.n_heads, dt, lead=lead)
    else:
        p["slstm"] = slstm_block_init(gen, d, cfg.n_heads, dt, lead=lead)
    if kind in _XLSTM:
        return p
    if cfg.n_experts:
        p["norm_f"] = norm_init(d, dt, dev, lead=lead)
        p["ffn"] = moe_init(gen, d, cfg.n_experts,
                            cfg.expert_d_ff or cfg.d_ff,
                            cfg.n_shared_experts, dt,
                            pad_to=cfg.pad_experts_to, lead=lead)
    elif cfg.d_ff:
        p["norm_f"] = norm_init(d, dt, dev, lead=lead)
        p["ffn"] = swiglu_init(gen, d, cfg.d_ff, dt, lead=lead)
    return p


def init_params(cfg: ModelConfig, seed: int = 0,
                device: str | torch.device | None = None) -> dict:
    """The full parameter tree, drawn from ``torch.Generator(device)``
    seeded with ``seed`` (a pure function of (cfg, seed, device type)).
    ``device=None`` means CUDA, as everywhere in the port; ``"meta"``
    gives shape-and-dtype stand-ins (the CPU init traced under fake
    tensors, nothing allocated)."""
    check_supported(cfg)
    dev = resolve_device(device)
    if dev.type == "meta":
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode():
            fake = init_params(cfg, seed, device="cpu")
        return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device=dev), fake)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = param_dtype(cfg)
    unit = cfg.block_unit
    n_rep = cfg.n_layers // len(unit)
    n_tail = cfg.n_layers - n_rep * len(unit)

    params: dict = {}
    if cfg.embed_inputs:
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


def _block_axes(cfg: ModelConfig, kind: str) -> dict:
    """Logical axes aligned with :func:`_block_init`'s tree."""
    norm = ("embed",)
    axes: dict = {"norm_t": norm}
    if kind in _ATTN:
        axes["attn"] = {"w_q": ("embed", "heads"),
                        "w_k": ("embed", "kv_heads"),
                        "w_v": ("embed", "kv_heads"),
                        "w_o": ("heads", "embed")}
    elif kind == "rec":
        axes["rec"] = rglru_block_axes()
    elif kind == "mlstm":
        axes["mlstm"] = mlstm_block_axes()
    else:
        axes["slstm"] = slstm_block_axes()
    if kind in _XLSTM:
        return axes
    if cfg.n_experts:
        axes["norm_f"] = norm
        axes["ffn"] = moe_axes(cfg.n_shared_experts)
    elif cfg.d_ff:
        axes["norm_f"] = norm
        axes["ffn"] = swiglu_axes()
    return axes


def param_axes(cfg: ModelConfig) -> dict:
    """The logical-axes tree aligned leaf for leaf with
    :func:`init_params`'s tree (the second half of the reference's
    ``init_params`` return, ``transformer.py:106-151``): each leaf a tuple
    of axis names or None, the stacked repeats prefixed by "layers"."""
    check_supported(cfg)
    unit = cfg.block_unit
    n_rep = cfg.n_layers // len(unit)
    axes: dict = {}
    if cfg.embed_inputs:
        axes["embed"] = ("vocab", "embed")
    axes["norm_out"] = ("embed",)
    if not cfg.tie_embeddings:
        axes["head"] = ("embed", "vocab")
    axes["layers"] = tuple(
        tree_map(lambda a: ("layers",) + a, _block_axes(cfg, kind),
                 is_leaf=is_axes) for kind in unit)
    if cfg.n_layers - n_rep * len(unit):
        axes["tail"] = tuple(_block_axes(cfg, kind)
                             for kind in cfg.blocks[n_rep * len(unit):])
    return axes


def cache_axes(cfg: ModelConfig) -> dict:
    """The logical-axes tree aligned with :func:`init_cache`'s tree (the
    reference's ``cache_axes``, ``transformer.py:563-590``).  A KV cache's
    "seq" axis is what the decode rules map to the "model" mesh axis; the
    recurrent states shard on batch only."""
    check_supported(cfg)

    def entry(kind: str):
        if kind in _ATTN:
            kv = ("batch", "seq", "kv_heads", None)
            return {"k": kv, "v": kv}
        if kind == "rec":
            return {"h": ("batch", "lru"), "conv": ("batch", None, "lru")}
        if kind == "mlstm":
            return (("batch", "heads", None, None),
                    ("batch", "heads", None), ("batch", "heads"))
        return tuple(("batch", None) for _ in range(4))

    unit = cfg.block_unit
    n_rep = cfg.n_layers // len(unit)
    n_tail = cfg.n_layers - n_rep * len(unit)
    stacked = tuple(tree_map(lambda a: ("layers",) + a, entry(kind),
                             is_leaf=is_axes) for kind in unit)
    tail = tuple(entry(k) for k in cfg.blocks[cfg.n_layers - n_tail:])
    return {"layers": stacked, "tail": tail, "length": ("batch",)}


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def _attn_apply(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x, cos, sin)
    # Heads own the model axis inside attention, never seq
    # (transformer.py:181-183).
    q = constrain(q, ("batch", None, "heads", None))
    kx, vx = _layout_kv(cfg, k, v)
    window = cfg.attn_window if kind == "local" else 0
    out = per_shard(
        lambda q, k, v: ops.flash_attention(
            q, k, v, causal=cfg.causal, window=window, impl=cfg.attn_impl,
            q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk),
        q, kx, vx, dims=(0, 2))
    out = constrain(out.reshape(b, s, -1), ("batch", None, "heads"))
    return out @ p["w_o"]


def _layout_kv(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """k, v as attention takes them: expanded to H heads under
    ``attn_layout="repeat_kv"``, else (``"grouped"``) as they are."""
    if cfg.attn_layout != "repeat_kv":
        return k, v
    g = cfg.n_heads // cfg.n_kv_heads
    axes = ("batch", "seq", "heads", None)
    return (constrain(torch.repeat_interleave(k, g, dim=2), axes),
            constrain(torch.repeat_interleave(v, g, dim=2), axes))


def _qkv(cfg: ModelConfig, a: dict, h: torch.Tensor, cos: torch.Tensor,
         sin: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The projections of ``h`` (B, S, d), with RoPE on q and k."""
    b, s, _ = h.shape
    hd = cfg.head_dim
    q = split_dim(h @ a["w_q"], -1, (cfg.n_heads, hd))
    k = split_dim(h @ a["w_k"], -1, (cfg.n_kv_heads, hd))
    v = split_dim(h @ a["w_v"], -1, (cfg.n_kv_heads, hd))
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _ffn(cfg: ModelConfig, p: dict, x: torch.Tensor,
         capacity_factor: float | None) -> tuple[torch.Tensor, torch.Tensor]:
    """The block's FFN on the residual ``x``: (x out, MoE aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "ffn" not in p:
        return x, aux
    h = rms_norm(x, p["norm_f"], cfg.norm_eps)
    if cfg.n_experts:
        out, aux = moe_apply(p["ffn"], h, top_k=cfg.top_k,
                             capacity_factor=capacity_factor)
    else:
        out = swiglu(p["ffn"], h)
    return x + out, aux


def _recurrent(cfg: ModelConfig, kind: str, p: dict, h: torch.Tensor
               ) -> tuple[torch.Tensor, object]:
    """A recurrent block's full-sequence apply from a zero state: (output,
    final state)."""
    if kind == "rec":
        return rglru_block_apply(p["rec"], h)
    if kind == "mlstm":
        return mlstm_block_apply(p["mlstm"], h, n_heads=cfg.n_heads,
                                 chunk=cfg.mlstm_chunk)
    return slstm_block_apply(p["slstm"], h, n_heads=cfg.n_heads)


def _block_apply_full(cfg: ModelConfig, kind: str, p: dict,
                      x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Training-mode apply: (x out, MoE aux loss)."""
    h = rms_norm(x, p["norm_t"], cfg.norm_eps)
    if kind in _ATTN:
        x = x + _attn_apply(cfg, kind, p["attn"], h, cos, sin)
    else:
        x = x + _recurrent(cfg, kind, p, h)[0]
    # The block's output constraint (transformer.py:236), here also on the
    # residual between the mixer and the FFN and on the xLSTM blocks'
    # output: GSPMD propagates a constraint backwards through the
    # elementwise add and carries the residual's placement from block to
    # block, DTensor does not (an unpinned xLSTM residual reached the head
    # with another placement at each depth).
    x = constrain(x, _RESIDUAL)
    x, aux = _ffn(cfg, p, x, cfg.capacity_factor)
    return constrain(x, _RESIDUAL), aux


def _store(entry, new) -> None:
    """Copy a layer's state ``new`` into its cache ``entry`` (views into
    the stacked cache), leaf for leaf."""
    if isinstance(entry, dict):
        for key in entry:
            _store(entry[key], new[key])
    elif isinstance(entry, tuple):
        for e, n in zip(entry, new):
            _store(e, n)
    else:
        entry.copy_(new)


def _block_prefill(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor,
                   cos: torch.Tensor, sin: torch.Tensor,
                   entry) -> torch.Tensor:
    """Prefill-mode apply: attention through ``chunked_attention`` (the
    reference's prefill takes no kernel), and the layer's k, v or final
    recurrent state written into its cache ``entry``."""
    b, s, _ = x.shape
    h = rms_norm(x, p["norm_t"], cfg.norm_eps)
    if kind not in _ATTN:
        out, state = _recurrent(cfg, kind, p, h)
        _store(entry, state)
        x = constrain(x + out, _RESIDUAL)
        return constrain(_ffn(cfg, p, x, cfg.capacity_factor)[0], _RESIDUAL)
    q, k, v = _qkv(cfg, p["attn"], h, cos, sin)
    # The training pass's pins (the reference's prefill has only the k/v
    # ones, and GSPMD carries the batch sharding of its inputs through;
    # DTensor places each op on its own, so the residual is pinned too).
    q = constrain(q, ("batch", None, "heads", None))
    kx, vx = _layout_kv(cfg, k, v)
    window = cfg.attn_window if kind == "local" else 0
    out = per_shard(
        lambda q, k, v: chunked_attention(
            q, k, v, causal=cfg.causal, window=window,
            q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk),
        q, kx, vx, dims=(0, 2))
    x = constrain(x + out.reshape(b, s, -1) @ p["attn"]["w_o"], _RESIDUAL)
    for name, t in (("k", k), ("v", v)):
        buf = entry[name]
        if kind == "local" and s >= buf.shape[1]:
            # Ring buffer of the last w keys, rolled so that slot t mod w
            # holds the key at absolute position t.
            w = buf.shape[1]
            buf.copy_(torch.roll(t[:, -w:], s % w, dims=1))
        else:
            buf[:, :s] = t
    return constrain(_ffn(cfg, p, x, cfg.capacity_factor)[0], _RESIDUAL)


def _block_decode(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor,
                  entry, new_length: torch.Tensor, slot: tuple | None,
                  cos: torch.Tensor, sin: torch.Tensor
                  ) -> tuple[torch.Tensor, object]:
    """Decode-mode apply: x (B,1,d) -> (x out, the layer's cache entry).
    Attention: the token's k, v go into ``entry`` at ``slot`` (in place),
    then attention over ``new_length`` entries.  Recurrent blocks: one
    step from ``entry``, returning a new state.  MoE FFNs are dropless."""
    b = x.shape[0]
    h = rms_norm(x, p["norm_t"], cfg.norm_eps)
    if kind == "mlstm":
        out, entry = mlstm_decode_step(p["mlstm"], h, entry,
                                       n_heads=cfg.n_heads)
        return x + out, entry
    if kind == "slstm":
        out, entry = slstm_decode_step(p["slstm"], h, entry)
        return x + out, entry
    if kind == "rec":
        out, entry = rglru_decode_step(p["rec"], h, entry)
        return _ffn(cfg, p, x + out, None)[0], entry
    q, k, v = _qkv(cfg, p["attn"], h, cos, sin)
    # The decode rules give "model" to the cache's time axis, which the
    # attention sums over; the one-token query keeps only its batch axis
    # (the cheap side to gather), so no head dim is sharded there too.
    q = constrain(q, ("batch", None, None, None))
    kc, vc = entry["k"], entry["v"]
    _scatter_time(kc, k, slot)
    _scatter_time(vc, v, slot)
    win = cfg.attn_window if kind == "local" else 0
    out = ops.decode_attention(q, kc, vc, new_length, window=win,
                               impl=cfg.attn_impl)
    x = x + out.reshape(b, 1, -1) @ p["attn"]["w_o"]
    return _ffn(cfg, p, x, None)[0], entry


def _slot(pos: torch.Tensor, size: int) -> tuple:
    """Where each batch row's new entry goes in a cache axis of ``size``:
    (rows, index, keep).  The reference's one-hot blend writes nothing for
    a position >= size (``one_hot(size, size)`` is all zeros); ``keep``
    marks the rows that are written."""
    rows = torch.arange(pos.shape[0], device=pos.device)
    return rows, torch.clamp(pos, max=size - 1).long(), pos < size


def _scatter_time(cache: torch.Tensor, new: torch.Tensor,
                  slot: tuple) -> None:
    """Write new (B,1,KV,hd) into cache (B,S,KV,hd) at each row's slot, in
    place.  For finite values this gives the bits of the reference's
    ``cache * (1 - onehot) + onehot * new`` (``transformer.py:366-371``),
    which reads and writes the whole cache; a dropped row rewrites its
    own value."""
    rows, idx, keep = slot
    if is_dtensor(cache):
        # A sharded cache takes the reference's blend (elementwise, so it
        # keeps the cache's placements), written back in place.
        hit = (torch.arange(cache.shape[1], device=idx.device)
               == idx[:, None]) & keep[:, None]
        cache.copy_(torch.where(hit[:, :, None, None], new, cache))
        return
    cache[rows, idx] = torch.where(keep[:, None, None], new[:, 0],
                                   cache[rows, idx])


def _unbind_tree(tree, n: int) -> list:
    """A stacked tree (dicts, tuples, tensors with a leading layer axis)
    as ``n`` per-layer trees of views."""
    if isinstance(tree, dict):
        parts = {key: _unbind_tree(val, n) for key, val in tree.items()}
        return [{key: parts[key][i] for key in tree} for i in range(n)]
    if isinstance(tree, tuple):
        parts = [_unbind_tree(val, n) for val in tree]
        return [tuple(p[i] for p in parts) for i in range(n)]
    return list(torch.unbind(tree, 0))


def _stack_tree(trees: list):
    """Per-layer trees stacked along a new leading layer axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {key: _stack_tree([t[key] for t in trees]) for key in first}
    if isinstance(first, tuple):
        return tuple(_stack_tree([t[i] for t in trees])
                     for i in range(len(first)))
    return torch.stack(trees)


class _EmbedLookup(torch.autograd.Function):
    # Only reached with DTensor tables (``_embed``).
    """The table's rows at ``tokens``, with the reference's sharded
    gradient (``transformer.py:381-405``): the scatter-add of the rows'
    gradients goes into a zero table pinned to the table's own
    ("vocab", "embed") placements, in the gradient's dtype, so no device
    holds a replicated full-size buffer."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, tokens: torch.Tensor):
        ctx.save_for_backward(tokens)
        ctx.shape, ctx.dtype = table.shape, table.dtype
        # Gather the d_model dim (the FSDP gather): a table sharded there
        # would make DTensor replicate the tokens instead, and every
        # device would then run the whole batch.  The vocab-sharded
        # lookup's masked partial sum is reduced here, inside the
        # function, since DTensor cannot turn its gradient back into one.
        from torch.distributed.tensor import Replicate

        x = F.embedding(tokens, replicate_dims(table, (1,)))
        return x.redistribute(x.device_mesh, [
            Replicate() if p.is_partial() else p for p in x.placements])

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (tokens,) = ctx.saved_tensors
        dtable = torch.ops.aten.embedding_dense_backward(
            g, tokens, ctx.shape[0], -1, False)
        return constrain(dtable, ("vocab", "embed")).to(ctx.dtype), None


def _embed(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """The input sequence (B, S, d) on the parameters' device: frame
    embeddings as they are (encoder-only), else token embeddings, with a
    VLM's patch embeddings in their place at the ``vision_mask``
    positions, in order (the i-th vision position takes patch i, through
    the reference's ``clip(cumsum - 1)`` gather: no host read-back)."""
    dev = params["norm_out"].device     # an encoder has no "embed" leaf
    if not cfg.embed_inputs:
        return batch["frames"].to(dev)
    tokens = batch["tokens"].to(device=dev, dtype=torch.long)
    if is_dtensor(params["embed"]):
        x = _EmbedLookup.apply(params["embed"], tokens)
    else:
        x = params["embed"][tokens]
    if "vision_embeds" in batch:
        mask = batch["vision_mask"].to(dev)                   # (B, S) bool
        patches = batch["vision_embeds"].to(dev)              # (B, P, d)
        idx = torch.clamp(torch.cumsum(mask, dim=1) - 1, 0,
                          patches.shape[1] - 1)
        gathered = torch.gather(
            patches, 1, idx[..., None].expand(-1, -1, patches.shape[2]))
        x = torch.where(mask[..., None], gathered.to(x.dtype), x)
    return x


def _rope_tables(cfg: ModelConfig, positions: torch.Tensor,
                 thw: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin for the attention layers at ``positions`` ((S,) or (B, S)):
    RoPE tables, or for M-RoPE (B, S, half) tables from ``thw`` (B, S, 3),
    by default (pos, pos, pos)."""
    if cfg.mrope_sections is None:
        return rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    if thw is None:     # text only: (t, h, w) all equal the text position
        thw = positions[..., None].expand(*positions.shape, 3)
        if thw.dim() == 2:
            thw = thw[None]
    return mrope_angles(thw.to(positions.device), cfg.mrope_sections,
                        cfg.head_dim, cfg.rope_theta)


def _head(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["norm_out"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["head"]
    # Vocab owns the model axis, even under seq-parallel rules
    # (transformer.py:430-436).
    return constrain(logits, ("batch", None, "vocab"))


def _layers(cfg: ModelConfig, params: dict, cache: dict | None = None):
    """(kind, layer params, layer cache entry) in execution order: the
    stacked repeats of the unit, then the tail.  Params and cache entries
    are views into the stacked trees; the entry is None without a cache."""
    unit = cfg.block_unit
    n_rep = cfg.n_layers // len(unit)
    per_kind = [_unbind_tree(stack, n_rep) for stack in params["layers"]]
    entries = [_unbind_tree(stack, n_rep) for stack in cache["layers"]] \
        if cache is not None else [[None] * n_rep for _ in unit]
    for i in range(n_rep):
        for u, kind in enumerate(unit):
            yield kind, per_kind[u][i], entries[u][i]
    tail = params.get("tail", ())
    tail_entries = cache["tail"] if cache is not None else (None,) * len(tail)
    yield from zip(cfg.blocks[len(cfg.blocks) - len(tail):], tail,
                   tail_entries)


def _run_layers(cfg: ModelConfig, layers: list, x: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor
                ) -> tuple[torch.Tensor, list]:
    """Training-mode apply of ``layers`` ((kind, params) pairs) in order:
    (x out, each layer's MoE aux loss)."""
    auxes = []
    for kind, p in layers:
        x, layer_aux = _block_apply_full(cfg, kind, p, x, cos, sin)
        auxes.append(layer_aux)
    return x, auxes


def forward_train(cfg: ModelConfig, params: dict, batch: dict
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced pass. Returns (logits (B,S,V), moe_aux_loss scalar).

    Under ``cfg.remat``, while autograd records, each repeat of
    ``cfg.block_unit`` runs as one non-reentrant checkpoint region and the
    tail layers run outside any, as in the reference's
    ``_scan_over_repeats`` (``transformer.py:443-482``).
    ``cfg.remat_policy`` ``"default"`` and
    ``"nothing"`` both keep only a region's inputs and recompute the rest,
    as ``jax.checkpoint`` does with ``policy=None`` and with
    ``nothing_saveable``.  The layers' aux losses are added layer after
    layer, with remat or without.
    """
    check_supported(cfg)
    x = constrain(_embed(cfg, params, batch), _RESIDUAL)
    positions = torch.arange(x.shape[1], device=x.device)
    cos, sin = _rope_tables(cfg, positions, batch.get("positions_thw"))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = [(kind, p) for kind, p, _ in _layers(cfg, params)]
    n_unit = len(cfg.block_unit)
    n_scanned = cfg.n_layers // n_unit * n_unit
    remat = cfg.remat and torch.is_grad_enabled()
    for start in range(0, n_scanned, n_unit):
        unit = layers[start:start + n_unit]
        if remat:
            x, auxes = checkpoint(_run_layers, cfg, unit, x, cos, sin,
                                  use_reentrant=False)
        else:
            x, auxes = _run_layers(cfg, unit, x, cos, sin)
        for layer_aux in auxes:
            aux = aux + layer_aux
    x, auxes = _run_layers(cfg, layers[n_scanned:], x, cos, sin)
    for layer_aux in auxes:
        aux = aux + layer_aux
    return _head(cfg, params, x), aux


def init_cache(cfg: ModelConfig, batch_size: int, cache_len: int,
               device: str | torch.device | None = None) -> dict:
    """Zero decode cache (``device=None`` means CUDA), as the reference's
    ``init_cache``: "attn" entries (B, cache_len, KV, hd), "local" ring
    buffers (B, window, KV, hd), in the parameters' dtype; the recurrent
    states (the RG-LRU conv window in the parameters' dtype, the rest
    float32, the stabilisers m at -1e30); ``length`` zeros."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = param_dtype(cfg)
    unit = cfg.block_unit
    n_rep = cfg.n_layers // len(unit)

    def entry(kind: str, lead: tuple[int, ...]):
        if kind == "rec":
            return rglru_init_state(batch_size, cfg.lru_width,
                                    cfg.conv1d_width, dt, dev, lead=lead)
        if kind == "mlstm":
            return mlstm_init_state(batch_size, cfg.n_heads,
                                    2 * cfg.d_model // cfg.n_heads, dev,
                                    lead=lead)
        if kind == "slstm":
            return slstm_init_state(batch_size, cfg.d_model, dev, lead=lead)
        size = cfg.attn_window if kind == "local" else cache_len
        shape = lead + (batch_size, size, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev)}

    n_tail = cfg.n_layers - n_rep * len(unit)
    return {"layers": tuple(entry(k, (max(n_rep, 1),)) for k in unit),
            "tail": tuple(entry(k, ())
                          for k in cfg.blocks[cfg.n_layers - n_tail:]),
            "length": torch.zeros((batch_size,), dtype=torch.int32,
                                  device=dev)}


def prefill(cfg: ModelConfig, params: dict, batch: dict, *,
            cache_len: int) -> tuple[torch.Tensor, dict]:
    """Full-sequence pass filling a fresh decode cache on the parameters'
    device.  Returns (logits for the last position (B,V), cache)."""
    check_supported(cfg)
    x = _embed(cfg, params, batch)
    b, s = x.shape[:2]
    if "attn" in cfg.blocks and s > cache_len:
        raise ValueError(f"a {s}-token prompt does not fit a cache of "
                         f"{cache_len}")
    cos, sin = _rope_tables(cfg, torch.arange(s, device=x.device),
                            batch.get("positions_thw"))
    if is_dtensor(x):
        cache = sharded_zeros(init_cache(cfg, b, cache_len, device="meta"),
                              cache_axes(cfg), x.device_mesh)
    else:
        cache = init_cache(cfg, b, cache_len, device=x.device)
    for kind, p, entry in _layers(cfg, params, cache):
        x = _block_prefill(cfg, kind, p, x, cos, sin, entry)
    cache["length"].fill_(s)
    return _head(cfg, params, x[:, -1:])[:, 0], cache


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: dict, positions_thw: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, dict]:
    """One decode step. token (B,) -> (logits (B,V), cache).

    Writes the token's k and v into ``cache``'s attention entries in place
    and returns a cache holding those entries, new recurrent states and
    ``length`` + 1 (a new tensor).  ``positions_thw`` (B, 3) overrides the
    new token's M-RoPE position (default (length, length, length)).
    """
    check_supported(cfg)
    if not cfg.embed_inputs:
        raise ValueError(f"{cfg.name}: encoder-only model has no decode step")
    x = _embed(cfg, params, {"tokens": token[:, None]})
    length = cache["length"]
    new_length = length + 1
    # Per-row positions: cos/sin (B, 1, hd/2).
    cos, sin = _rope_tables(
        cfg, length[:, None],
        None if positions_thw is None else positions_thw[:, None, :])
    slots: dict = {}
    new_entries = []
    for kind, p, entry in _layers(cfg, params, cache):
        if kind in _ATTN and kind not in slots:
            size = entry["k"].shape[1]
            slots[kind] = _slot(length % size if kind == "local" else length,
                                size)
        x, entry = _block_decode(cfg, kind, p, x, entry, new_length,
                                 slots.get(kind), cos, sin)
        new_entries.append(entry)
    logits = _head(cfg, params, x)[:, 0]
    # Restack the recurrent states; the attention stacks were written in
    # place.
    unit = cfg.block_unit
    n_rep = cfg.n_layers // len(unit)
    layers = tuple(
        cache["layers"][u] if kind in _ATTN
        else _stack_tree(new_entries[u:n_rep * len(unit):len(unit)])
        for u, kind in enumerate(unit))
    tail = tuple(new_entries[n_rep * len(unit):])
    return logits, {"layers": layers, "tail": tail, "length": new_length}
