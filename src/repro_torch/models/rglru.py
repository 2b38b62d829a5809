"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The port of ``repro/models/rglru.py:33-153``.  The block: two branches of
the normed input, a GeLU gate (``w_gate``, tanh approximation as
``jax.nn.gelu``) and a recurrent branch (``w_in``, a causal depthwise conv
of width ``cw`` over time, then the RG-LRU), multiplied and projected back
(``w_out``).  Per channel, in float32:

    r_t = sigmoid(W_a y_t + b_a),  i_t = sigmoid(W_x y_t + b_x)
    log a_t = c * r_t * log sigmoid(Lambda)            (c = -8)
    h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) * (i_t * y_t)

as the reference computes it.  With c = -8 and log sigmoid < 0, log a_t
is >= 0 (the Griffin paper's a_t = sigma(Lambda)^(8 r_t) is <= 1): the
state grows by up to e^0.42 a token and overflows float32 within a few
hundred tokens.  That is a fault of the reference (ROADMAP Queue C R2),
which the port copies so that it stays held to the reference.

No Pallas kernel sits here.  The reference runs the recurrence as
``jax.lax.associative_scan``; :func:`_linear_scan` is a log-depth
(Hillis-Steele) scan of the same operator, rounding in another order, so
the port is held to the reference at float32 tolerance, not bits.  Decode
carries ``{"h": (B, w) f32, "conv": (B, cw - 1, w)}``: the state and the
last ``cw - 1`` conv inputs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..parallel.sharding import constrain
from .layers import dense_init, log_sigmoid

__all__ = ["rglru_block_apply", "rglru_block_axes", "rglru_block_init",
           "rglru_decode_step", "rglru_init_state"]

_C = -8.0  # the paper's fixed exponent scale


def rglru_block_init(gen: torch.Generator, d: int, w: int, conv_width: int,
                     dtype: torch.dtype, *,
                     lead: tuple[int, ...] = ()) -> dict:
    """Lambda so that a = sigmoid(Lambda)^(c r) covers slow and fast
    decays: a^2 uniform in [0.9, 0.999], as in the Griffin paper."""
    dev = gen.device
    u = 0.9 + 0.099 * torch.rand(lead + (w,), generator=gen,
                                 dtype=torch.float32, device=dev)
    lam = torch.log(torch.sqrt(u) / (1.0 - torch.sqrt(u)))
    conv = torch.randn(lead + (conv_width, w), generator=gen,
                       dtype=torch.float32, device=dev) \
        * (1.0 / math.sqrt(conv_width))
    return {
        "w_gate": dense_init(gen, d, w, dtype, lead=lead),
        "w_in": dense_init(gen, d, w, dtype, lead=lead),
        "w_out": dense_init(gen, w, d, dtype, lead=lead),
        "w_rg": dense_init(gen, w, 2 * w, dtype, lead=lead),
        "conv": conv.to(dtype),
        "lambda": lam,
        "b_rg": torch.zeros(lead + (2 * w,), dtype=torch.float32, device=dev),
    }


def rglru_block_axes() -> dict:
    """Logical axes aligned with :func:`rglru_block_init`'s tree."""
    return {"w_gate": ("embed", "lru"), "w_in": ("embed", "lru"),
            "w_out": ("lru", "embed"), "w_rg": ("lru", "lru"),
            "conv": ("conv", "lru"), "lambda": ("lru",), "b_rg": ("lru",)}


def _causal_conv(y: torch.Tensor, conv: torch.Tensor,
                 prefix: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv over time. y (B,S,w); conv (cw, w); ``prefix``
    (B, cw-1, w) is the input left of t = 0 (zeros if None)."""
    cw = conv.shape[0]
    if prefix is None:
        prefix = y.new_zeros(y.shape[:1] + (cw - 1,) + y.shape[2:])
    ypad = torch.cat([prefix, y], dim=1)
    out = torch.zeros_like(y)
    for i in range(cw):
        out = out + ypad[:, i:i + y.shape[1], :] * conv[cw - 1 - i]
    return out


def _rg_gates(params: dict, y: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(log_a, gated input) of the recurrence, float32."""
    w = params["lambda"].shape[0]
    # The product sums over the "lru"-sharded width: reduced before the
    # bias and the gates' halves are taken (GSPMD's placement of it).
    rg = y.float() @ params["w_rg"].float()
    rg = constrain(rg, ("batch",) + (None,) * (rg.dim() - 1)) + params["b_rg"]
    r = torch.sigmoid(rg[..., :w])
    i = torch.sigmoid(rg[..., w:])
    log_a = _C * r * log_sigmoid(params["lambda"])
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-12))
    return log_a, beta * i * y.float()


def _linear_scan(log_a: torch.Tensor, b: torch.Tensor,
                 h0: torch.Tensor | None = None) -> torch.Tensor:
    """h_t = exp(log_a_t) h_{t-1} + b_t over axis 1, from h_{-1} = h0 (or
    0): a log-depth scan of the operator (la_x, b_x), (la_y, b_y) ->
    (la_x + la_y, exp(la_y) b_x + b_y)."""
    if h0 is not None:          # fold the carry into the first step
        b = torch.cat([b[:, :1] + torch.exp(log_a[:, :1]) * h0[:, None],
                       b[:, 1:]], dim=1)
    la, h = log_a, b
    shift = 1
    while shift < h.shape[1]:
        h = torch.cat([h[:, :shift],
                       torch.exp(la[:, shift:]) * h[:, :-shift]
                       + h[:, shift:]], dim=1)
        la = torch.cat([la[:, :shift], la[:, :-shift] + la[:, shift:]],
                       dim=1)
        shift *= 2
    return h


def rglru_block_apply(params: dict, x: torch.Tensor,
                      state: dict | None = None
                      ) -> tuple[torch.Tensor, dict]:
    """Full-sequence apply. x (B,S,d) -> (B,S,d) and the final state
    ``{"h", "conv"}``; ``state`` carries across segments."""
    dtype = x.dtype
    gate = F.gelu(x @ params["w_gate"], approximate="tanh")
    y = constrain(x @ params["w_in"], ("batch", None, "lru"))  # (B,S,w)
    prefix = state["conv"].to(y.dtype) if state else None
    yc = _causal_conv(y, params["conv"], prefix)
    log_a, b = _rg_gates(params, yc)
    h = _linear_scan(log_a, b, state["h"] if state else None)  # fp32
    out = (gate.float() * h).to(dtype) @ params["w_out"]
    cw = params["conv"].shape[0]
    if prefix is None:
        prefix = y.new_zeros((y.shape[0], cw - 1, y.shape[2]))
    ytail = torch.cat([prefix, y], dim=1)[:, -(cw - 1):, :]
    return out, {"h": h[:, -1], "conv": ytail}


def rglru_init_state(batch: int, w: int, conv_width: int, dtype: torch.dtype,
                     device: torch.device, *,
                     lead: tuple[int, ...] = ()) -> dict:
    return {"h": torch.zeros(lead + (batch, w), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(lead + (batch, conv_width - 1, w),
                                dtype=dtype, device=device)}


def rglru_decode_step(params: dict, x: torch.Tensor, state: dict
                      ) -> tuple[torch.Tensor, dict]:
    """One token. x (B,1,d); returns the output and a new state (the
    conv window in float32 here, as the reference computes it)."""
    dtype = x.dtype
    gate = F.gelu(x @ params["w_gate"], approximate="tanh")[:, 0]
    y = (x @ params["w_in"])[:, 0]                            # (B,w)
    hist = torch.cat([state["conv"], y[:, None, :]], dim=1)   # (B,cw,w)
    yc = torch.einsum("bcw,cw->bw", hist.float(), params["conv"].float())
    log_a, b = _rg_gates(params, yc)
    h = torch.exp(log_a) * state["h"] + b
    out = (gate.float() * h).to(dtype)[:, None, :] @ params["w_out"]
    return out, {"h": h, "conv": hist[:, 1:, :].to(state["conv"].dtype)}
