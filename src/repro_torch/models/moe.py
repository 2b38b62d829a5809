"""Mixture-of-Experts layer: top-k router and grouped capacity dispatch.

The port of ``repro/models/moe.py:27-172`` (``moe_init``,
``router_aux_loss``, ``moe_apply``).  No Pallas kernel sits in this
module: the expert products are batched matrix products (``torch.einsum``)
as the reference leaves them to XLA.  The semantics are the reference's:

* the router runs in float32 (``x.float() @ router``), softmax, top-k,
  weights renormalised over the k picks;
* the T tokens split into ``g = gcd(T, n_groups)`` groups; capacity is
  counted per group, ``ceil(Tl * k / E * capacity_factor)``, or every
  assignment fits (dropless) under ``capacity_factor=None``;
* an assignment's position in its expert's bucket is the prefix count over
  the group's (token, slot) order, and positions at or past the capacity
  are dropped (their residual passes through);
* the dead padded experts (``pad_to`` > ``n_experts``) are never routed to:
  the router is ``n_experts`` wide;
* the pick weights are cast to the input's dtype before the k-way combine;
* shared experts run as one dense SwiGLU of width ``n_shared * expert_ff``.

Ties in the top-k: ``jax.lax.top_k`` takes the lower expert index first;
``torch.topk`` does not promise an order for equal values, so the port
takes the first k of a stable descending sort, which does.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..parallel.sharding import constrain, per_shard
from .layers import dense_init, swiglu, swiglu_axes, swiglu_init

__all__ = ["moe_apply", "moe_axes", "moe_init", "router_aux_loss"]


def moe_init(gen: torch.Generator, d: int, n_experts: int, expert_ff: int,
             n_shared: int, dtype: torch.dtype, pad_to: int = 0, *,
             lead: tuple[int, ...] = ()) -> dict:
    """The layer's parameters, ``lead`` stacking layers.  ``pad_to`` >
    ``n_experts`` appends dead experts (60 -> 64).  The expert weights are
    drawn in float32 one ``(n_phys, d, f)`` slab at a time and cast, so
    that a full-width stack (24 x 64 x 2048 x 1408) never exists in
    float32."""
    n_phys = max(n_experts, pad_to)
    dev = gen.device

    def experts(rows: int, cols: int) -> torch.Tensor:
        out = torch.empty(lead + (n_phys, rows, cols), dtype=dtype,
                          device=dev)
        for slab in out.view(-1, n_phys, rows, cols):
            slab.copy_(torch.randn((n_phys, rows, cols), generator=gen,
                                   dtype=torch.float32, device=dev)
                       * (1.0 / math.sqrt(rows)))
        return out

    p = {"router": dense_init(gen, d, n_experts, torch.float32, lead=lead),
         "experts": {"w_gate": experts(d, expert_ff),
                     "w_up": experts(d, expert_ff),
                     "w_down": experts(expert_ff, d)}}
    if n_shared:
        p["shared"] = swiglu_init(gen, d, n_shared * expert_ff, dtype,
                                  lead=lead)
    return p


def moe_axes(n_shared: int) -> dict:
    """Logical axes aligned with :func:`moe_init`'s tree."""
    axes = {"router": ("embed", "experts"),
            "experts": {"w_gate": ("experts", "embed", "mlp"),
                        "w_up": ("experts", "embed", "mlp"),
                        "w_down": ("experts", "mlp", "embed")}}
    if n_shared:
        axes["shared"] = swiglu_axes()
    return axes


def router_aux_loss(gates: torch.Tensor, top_idx: torch.Tensor,
                    n_experts: int) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum_e f_e * P_e.

    gates: (T, E) softmax probabilities; top_idx: (T, k) selected experts.
    """
    experts = torch.arange(n_experts, device=top_idx.device)
    counts = (top_idx.reshape(-1)[:, None] == experts).sum(dim=0)
    return _aux_loss(gates, counts, top_idx.numel(), n_experts)


def _aux_loss(gates: torch.Tensor, counts: torch.Tensor, n_assigned: int,
              n_experts: int) -> torch.Tensor:
    """:func:`router_aux_loss` from the experts' assignment ``counts``:
    integers, so f_e is exact in float32 whatever order summed them (and,
    unlike bincount, no read-back to the host on CUDA)."""
    pe = gates.mean(dim=0)
    fe = counts.float() / max(1.0, float(n_assigned))
    return n_experts * torch.sum(fe * pe)


def _top_k(gates: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, equal values in index order (as
    ``jax.lax.top_k``)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch(logits: torch.Tensor, xg: torch.Tensor, *, top_k: int,
              n_experts: int, n_phys: int, capacity: int):
    """Route the groups' tokens and scatter them into their experts'
    buckets.  logits (G, Tl, E) float32, xg (G, Tl, d).  Every group is
    independent of the others, so this runs on each device's groups.

    Returns the gates (G, Tl, E), the experts' assignment counts per group
    (G, n_phys), the ``(G, n_phys, C+1, d)`` buffer, and each assignment's
    expert, slot, kept flag and weight (G, Tl k)."""
    g, tl, d = xg.shape
    gates = torch.softmax(logits, dim=-1)
    top_w, top_idx = _top_k(gates, top_k)                     # (G, Tl, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    ts_l = tl * top_k
    flat_e = top_idx.reshape(g, ts_l)                         # (G, TSl)
    flat_w = top_w.reshape(g, ts_l).to(xg.dtype)

    # Position of each assignment in its (group, expert) bucket: the count
    # of the group's earlier assignments to the same expert (a comparison,
    # not one_hot, which reads the indices back to the host on CUDA).
    experts = torch.arange(n_phys, device=xg.device)
    onehot = (flat_e[..., None] == experts).long()            # (G, TSl, E)
    pos = torch.gather(torch.cumsum(onehot, dim=1), 2,
                       flat_e[..., None])[..., 0] - 1
    keep = pos < capacity
    safe_pos = torch.where(keep, pos, capacity)               # overflow slot

    upd = xg[:, :, None, :].expand(g, tl, top_k, d).reshape(g, ts_l, d)
    upd = torch.where(keep[..., None], upd, torch.zeros((), dtype=xg.dtype,
                                                        device=xg.device))
    # Scatter into (G, E, C+1, d); slot `capacity` takes the drops (zeros).
    # Kept assignments have distinct slots, so each is written once.
    rows = torch.arange(g, device=xg.device)[:, None].expand(g, ts_l)
    buf = torch.zeros((g, n_phys, capacity + 1, d), dtype=xg.dtype,
                      device=xg.device)
    buf = buf.index_put((rows, flat_e, safe_pos), upd, accumulate=True)
    return (gates, onehot.sum(dim=1), buf, flat_e, safe_pos, keep, flat_w)


def _experts(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU on its bucket: (G, E, C+1, d) x (E, d, f)."""
    gate = F.silu(torch.einsum("gecd,edf->gecf", buf, w_gate))
    up = torch.einsum("gecd,edf->gecf", buf, w_up)
    return torch.einsum("gecf,efd->gecd", gate * up, w_down)


def _combine(out_buf: torch.Tensor, flat_e: torch.Tensor,
             safe_pos: torch.Tensor, keep: torch.Tensor,
             flat_w: torch.Tensor, top_k: int) -> torch.Tensor:
    """Gather each assignment's expert output, weight it and sum over its
    token's k picks: (G, Tl, d), group by group."""
    g, ts_l = flat_e.shape
    rows = torch.arange(g, device=out_buf.device)[:, None].expand(g, ts_l)
    contrib = out_buf[rows, flat_e, safe_pos]                 # (G, TSl, d)
    contrib = torch.where(keep[..., None], contrib,
                          torch.zeros((), dtype=contrib.dtype,
                                      device=out_buf.device)) \
        * flat_w[..., None]
    return contrib.reshape(g, ts_l // top_k, top_k, -1).sum(dim=2)


def moe_apply(params: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float | None = 1.25,
              n_groups: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply the MoE layer. x (..., d) -> (same shape, aux_loss scalar).

    ``capacity_factor=None`` is the dropless capacity (decode).

    On DTensors the routing, the dispatch and the combine run on each
    device's own groups (:func:`per_shard`: the groups carry "batch", so
    they are local by construction, as under the reference's ``vmap``),
    and only the expert products between the two constraints that carry
    the all-to-all see the expert-sharded buffer.  The aux loss is the
    only cross-group term: the gates' mean and the summed counts."""
    orig_shape = x.shape
    d = orig_shape[-1]
    xt = x.reshape(-1, d)                                     # (T, d)
    t = xt.shape[0]
    n_experts = params["router"].shape[-1]
    n_phys = params["experts"]["w_gate"].shape[0]

    g = math.gcd(t, max(1, n_groups))
    tl = t // g
    xg = constrain(xt.reshape(g, tl, d), ("batch", None, None))
    logits = constrain(xg.float() @ params["router"],        # (G, Tl, E)
                       ("batch", None, None))

    ts_l = tl * top_k
    if capacity_factor is None:
        capacity = ts_l
    else:
        capacity = max(1, int(math.ceil(ts_l / n_experts * capacity_factor)))
    gates, counts, buf, flat_e, safe_pos, keep, flat_w = per_shard(
        functools.partial(_dispatch, top_k=top_k, n_experts=n_experts,
                          n_phys=n_phys, capacity=capacity),
        logits, xg, dims=(0,))
    aux = _aux_loss(gates.reshape(t, n_experts), counts.sum(dim=0)[:n_experts],
                    t * top_k, n_experts)

    # The MoE all-to-all: the expert axis picks up "model" (moe.py:152).
    # The expert products run on each device's groups and experts, the
    # weights gathered over their other axes (FSDP's gather).
    buf = constrain(buf, ("batch", "experts", None, None))
    e = params["experts"]
    out_buf = per_shard(_experts, buf, e["w_gate"], e["w_up"], e["w_down"],
                        dims=((0, 1),) + ((None, 0),) * 3)
    out_buf = constrain(out_buf, ("batch", "experts", None, None))

    yt = per_shard(functools.partial(_combine, top_k=top_k),
                   out_buf, flat_e, safe_pos, keep, flat_w, dims=(0,))
    yt = constrain(yt, ("batch", None, None)).reshape(t, d)

    if "shared" in params:
        yt = yt + swiglu(params["shared"], xt)
    return yt.reshape(orig_shape), aux
