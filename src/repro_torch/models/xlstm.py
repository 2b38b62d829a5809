"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory)
[arXiv:2405.04517].

The port of ``repro/models/xlstm.py:46-295``; no Pallas kernel sits here.

mLSTM: per head a matrix memory C (hd x hd, hd = 2 d / H) with
exponential gating, run chunkwise in its stabilised form: within a chunk
of length L a decay matrix plays the role of attention (masked to -inf
above the diagonal), between chunks the state (C~, n~, m) carries with
the true C = C~ exp(m).  The chunk is ``min(chunk, S)`` lowered until it
divides S.  The stabiliser m is guarded at -1e30 (rows with no valid
entry) and the output divides by ``max(|n . q|, exp(-m))``.  Masked
entries enter as exp(-inf) = 0, whose gradient is 0, so autograd through
the mask gives no NaN.

sLSTM: scalar memory with block-diagonal recurrent weights, a sequential
loop over time carrying (c, n, m, h), log-space stabilised the same way,
then a GLU feed-forward.  Both blocks have one-token decode steps; states
are float32.

On DTensors (the sharded steps and the dry run) the projections are
pinned before their biases and head splits, and the mLSTM's chunk scan
and the sLSTM's time loop, independent per batch row (and head), run on
each device's shards (``parallel/sharding.py::per_shard``).  A traced
step, on fake tensors, sees the sLSTM loop as one op each way
(``repro_torch::slstm_scan``), as XLA sees the reference's ``lax.scan``;
every eager step runs the loop itself.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor

from ..parallel.sharding import constrain, merge_dims, per_shard, split_dim
from .layers import dense_init, log_sigmoid, rms_norm

__all__ = ["mlstm_block_apply", "mlstm_block_axes", "mlstm_block_init",
           "mlstm_decode_step", "mlstm_init_state", "slstm_block_apply",
           "slstm_block_axes", "slstm_block_init", "slstm_decode_step",
           "slstm_init_state"]


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_block_init(gen: torch.Generator, d: int, n_heads: int,
                     dtype: torch.dtype, *,
                     lead: tuple[int, ...] = ()) -> dict:
    """Up-projection (2x) -> [mLSTM | silu gate] -> down-projection."""
    up = 2 * d
    dev = gen.device
    b_if = torch.cat([torch.zeros(n_heads),
                      torch.linspace(3.0, 6.0, n_heads)]).to(dev)
    return {
        "w_up": dense_init(gen, d, up, dtype, lead=lead),
        "w_gate": dense_init(gen, d, up, dtype, lead=lead),
        "w_q": dense_init(gen, up, up, dtype, lead=lead),
        "w_k": dense_init(gen, up, up, dtype, lead=lead),
        "w_v": dense_init(gen, up, up, dtype, lead=lead),
        "w_down": dense_init(gen, up, d, dtype, lead=lead),
        "w_if": dense_init(gen, up, 2 * n_heads, torch.float32, lead=lead),
        # Forget-gate biases positive: remember by default.
        "b_if": b_if.expand(lead + (2 * n_heads,)).clone(),
        "ln_inner": torch.ones(lead + (up,), dtype=dtype, device=dev),
    }


def mlstm_block_axes() -> dict:
    """Logical axes aligned with :func:`mlstm_block_init`'s tree."""
    qkv = ("mlp", "heads_mlp")
    return {"w_up": ("embed", "mlp"), "w_gate": ("embed", "mlp"),
            "w_q": qkv, "w_k": qkv, "w_v": qkv, "w_down": ("mlp", "embed"),
            "w_if": ("mlp", None), "b_if": (None,), "ln_inner": ("mlp",)}


def _mlstm_chunk(q, k, v, log_i, log_f, state):
    """One chunk of the stabilised chunkwise mLSTM.

    q, k, v: (B,H,L,hd) float32 (q, k pre-scaled); log_i, log_f: (B,H,L);
    state (C~ (B,H,hd,hd), n~ (B,H,hd), m (B,H)).  Returns h (B,H,L,hd)
    and the state at the end of the chunk.
    """
    c_p, n_p, m_p = state
    fcum = torch.cumsum(log_f, dim=-1)                     # F_j
    # Intra-chunk log decay: F_j - F_t + log i_t for t <= j.
    ld = fcum[..., :, None] - fcum[..., None, :] + log_i[..., None, :]
    l = q.shape[-2]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=q.device))
    ld = ld.masked_fill(~mask, -math.inf)
    m_intra = ld.amax(dim=-1)
    m_inter = fcum + m_p[..., None]
    m = torch.maximum(m_intra, m_inter)
    m = torch.clamp(m, min=-1e30)                          # all--inf rows
    d_mat = torch.exp(ld - m[..., None])
    inter_scale = torch.exp(m_inter - m)

    s = torch.einsum("bhld,bhtd->bhlt", q, k) * d_mat
    num = torch.einsum("bhlt,bhtd->bhld", s, v) \
        + inter_scale[..., None] * torch.einsum("bhld,bhde->bhle", q, c_p)
    den = s.sum(dim=-1) + inter_scale * torch.einsum("bhld,bhd->bhl", q, n_p)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m))[..., None]

    f_tot = fcum[..., -1]
    m_new = torch.maximum(f_tot + m_p,
                          (f_tot[..., None] - fcum + log_i).amax(dim=-1))
    carry = torch.exp(f_tot + m_p - m_new)
    w = torch.exp(f_tot[..., None] - fcum + log_i - m_new[..., None])
    c_new = carry[..., None, None] * c_p \
        + torch.einsum("bht,bhtd,bhte->bhde", w, k, v)
    n_new = carry[..., None] * n_p + torch.einsum("bht,bhtd->bhd", w, k)
    return h, (c_new, n_new, m_new)


def _mlstm_qkvif(params: dict, xin: torch.Tensor, n_heads: int):
    """Per-head q, k, v (float32) and gate logits of the up-projected
    input.  On DTensors each projection is pinned before it is split into
    heads (the feature on "model", so the split keeps what divides)."""
    b, s, up = xin.shape
    hd = up // n_heads

    def heads(w):
        proj = constrain(xin @ w, ("batch", None, "heads"))
        return split_dim(proj, -1, (n_heads, hd)).transpose(1, 2).float()

    q = heads(params["w_q"]) / math.sqrt(hd)
    k = heads(params["w_k"]) / math.sqrt(hd)
    v = heads(params["w_v"])
    gates = constrain(xin.float() @ params["w_if"], ("batch", None, None)) \
        + params["b_if"]                                   # (B,S,2H)
    log_i = gates[..., :n_heads].transpose(1, 2)           # (B,H,S)
    log_f = log_sigmoid(gates[..., n_heads:]).transpose(1, 2)
    return q, k, v, log_i, log_f


def mlstm_init_state(batch: int, n_heads: int, hd: int,
                     device: torch.device, *,
                     lead: tuple[int, ...] = ()) -> tuple:
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros(lead + (batch, n_heads, hd, hd), **f32),
            torch.zeros(lead + (batch, n_heads, hd), **f32),
            torch.full(lead + (batch, n_heads), -1e30, **f32))


def _mlstm_scan(q, k, v, log_i, log_f, c_p, n_p, m_p, *, chunk: int):
    """The chunkwise mLSTM over the whole sequence: h (B,H,S,hd) and the
    final state.  Independent per batch row and head, so it runs on each
    device's rows and heads (:func:`per_shard`)."""
    s = q.shape[2]
    c = min(chunk, s)
    while s % c:
        c -= 1
    state = (c_p, n_p, m_p)
    hs = []
    for i in range(s // c):
        sl = slice(i * c, (i + 1) * c)
        h_i, state = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                  log_i[:, :, sl], log_f[:, :, sl], state)
        hs.append(h_i)
    return (torch.cat(hs, dim=2),) + state


def mlstm_block_apply(params: dict, x: torch.Tensor,
                      state: tuple | None = None, *, n_heads: int,
                      chunk: int = 256) -> tuple[torch.Tensor, tuple]:
    """Full-sequence mLSTM block. x (B,S,d) -> (B,S,d), final state."""
    dtype = x.dtype
    b, s, _ = x.shape
    xin = constrain(x @ params["w_up"], ("batch", None, "mlp"))
    gate = F.silu(x @ params["w_gate"])
    q, k, v, log_i, log_f = _mlstm_qkvif(params, xin, n_heads)
    up = xin.shape[-1]
    if state is None:
        state = mlstm_init_state(b, n_heads, up // n_heads, x.device)
    h, *state = per_shard(functools.partial(_mlstm_scan, chunk=chunk),
                          q, k, v, log_i, log_f, *state, dims=(0, 1))
    h = merge_dims(h.transpose(1, 2), 2, 2)                # (B,S,up)
    h = rms_norm(h.to(dtype), params["ln_inner"])
    return (h * gate) @ params["w_down"], tuple(state)


def _mlstm_step(q, k, v, log_i, log_f, c_p, n_p, m_p):
    """One token of the mLSTM per batch row and head: h (B,H,hd) and the
    new state."""
    m_new = torch.maximum(log_f + m_p, log_i)
    f_t = torch.exp(log_f + m_p - m_new)
    i_t = torch.exp(log_i - m_new)
    c = f_t[..., None, None] * c_p \
        + i_t[..., None, None] * k[..., :, None] * v[..., None, :]
    n = f_t[..., None] * n_p + i_t[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, c)
    den = torch.einsum("bhd,bhd->bh", q, n)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    return h, c, n, m_new


def mlstm_decode_step(params: dict, x: torch.Tensor, state: tuple, *,
                      n_heads: int) -> tuple[torch.Tensor, tuple]:
    """One token. x (B,1,d); returns the output and a new state."""
    dtype = x.dtype
    b = x.shape[0]
    xin = constrain(x @ params["w_up"], ("batch", None, "mlp"))
    gate = F.silu(x @ params["w_gate"])
    q, k, v, log_i, log_f = _mlstm_qkvif(params, xin, n_heads)
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]           # (B,H,hd)
    log_i, log_f = log_i[:, :, 0], log_f[:, :, 0]          # (B,H)
    h, *state = per_shard(_mlstm_step, q, k, v, log_i, log_f, *state,
                          dims=(0, 1))
    up = params["w_up"].shape[-1]
    h = rms_norm(h.reshape(b, 1, up).to(dtype), params["ln_inner"])
    return (h * gate) @ params["w_down"], tuple(state)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_block_init(gen: torch.Generator, d: int, n_heads: int,
                     dtype: torch.dtype, *,
                     lead: tuple[int, ...] = ()) -> dict:
    hd = d // n_heads
    dev = gen.device
    r = torch.randn(lead + (4, n_heads, hd, hd), generator=gen,
                    dtype=torch.float32, device=dev) * (1.0 / math.sqrt(hd))
    bias = torch.zeros(lead + (4, d), dtype=torch.float32, device=dev)
    bias[..., 1, :] = 2.0                                  # forget bias
    return {
        # The four gates' (i, f, z, o) input projections together.
        "w_in": dense_init(gen, d, 4 * d, dtype, lead=lead),
        # GLU feed-forward after the recurrence (proj factor 4/3).
        "w_ff_gate": dense_init(gen, d, (4 * d) // 3, dtype, lead=lead),
        "w_ff_down": dense_init(gen, (4 * d) // 3, d, dtype, lead=lead),
        "r": r,
        "b": bias,
        "ln_inner": torch.ones(lead + (d,), dtype=dtype, device=dev),
    }


def slstm_block_axes() -> dict:
    """Logical axes aligned with :func:`slstm_block_init`'s tree."""
    return {"w_in": ("embed", "mlp"), "w_ff_gate": ("embed", "mlp"),
            "w_ff_down": ("mlp", "embed"), "r": (None, "heads", None, None),
            "b": (None, "embed"), "ln_inner": ("embed",)}


def slstm_init_state(batch: int, d: int, device: torch.device, *,
                     lead: tuple[int, ...] = ()) -> tuple:
    f32 = dict(dtype=torch.float32, device=device)
    shape = lead + (batch, d)
    return (torch.zeros(shape, **f32), torch.zeros(shape, **f32),
            torch.full(shape, -1e30, **f32), torch.zeros(shape, **f32))


def _slstm_cell(r: torch.Tensor, bias: torch.Tensor, wx: torch.Tensor,
                state: tuple, n_heads: int) -> tuple:
    """One time step. wx (B,4,d) = W x_t, float32."""
    c, n, m, h = state
    b, d = h.shape
    hh = h.reshape(b, n_heads, d // n_heads)
    rec = torch.einsum("bhk,ghkl->bghl", hh, r).reshape(b, 4, d)
    pre = wx + rec + bias
    log_i = pre[:, 0]
    log_f = F.logsigmoid(pre[:, 1])
    z = torch.tanh(pre[:, 2])
    o = torch.sigmoid(pre[:, 3])
    m_new = torch.maximum(log_f + m, log_i)
    f_t = torch.exp(log_f + m - m_new)
    i_t = torch.exp(log_i - m_new)
    c_new = f_t * c + i_t * z
    n_new = torch.maximum(f_t * n + i_t, torch.exp(-m_new))
    return c_new, n_new, m_new, o * c_new / n_new


def _slstm_scan(wx, r, bias, c, n, m, h):
    """The sLSTM's loop over time: the hidden states (B,S,d) and the final
    state.  Independent per batch row (the recurrence mixes a head's
    channels), so it runs on each device's rows (:func:`per_shard`), the
    recurrent weights gathered."""
    state = (c, n, m, h)
    hs = []
    for t in range(wx.shape[1]):
        state = _slstm_cell(r, bias, wx[:, t], state, r.shape[1])
        hs.append(state[3])
    return (torch.stack(hs, dim=1),) + state


_SCAN_IN = "Tensor wx, Tensor r, Tensor bias, Tensor c, Tensor n, " \
    "Tensor m, Tensor h"


@torch.library.custom_op("repro_torch::slstm_scan", mutates_args=(),
                         schema=f"({_SCAN_IN}) -> (Tensor, Tensor, Tensor, "
                                "Tensor, Tensor)")
def _slstm_scan_op(wx, r, bias, c, n, m, h):
    """:func:`_slstm_scan` as one op: how a traced step (the dry run, on
    fake tensors) sees the loop, as XLA sees the reference's
    ``lax.scan``; an eager step runs the loop itself."""
    return _slstm_scan(wx, r, bias, c, n, m, h)


@_slstm_scan_op.register_fake
def _(wx, r, bias, c, n, m, h):
    return (wx.new_empty(wx.shape[:2] + h.shape[1:]), c.new_empty(c.shape),
            n.new_empty(n.shape), m.new_empty(m.shape), h.new_empty(h.shape))


@torch.library.custom_op("repro_torch::slstm_scan_backward", mutates_args=(),
                         schema=f"({_SCAN_IN}, Tensor g_hs, Tensor g_c, "
                                "Tensor g_n, Tensor g_m, Tensor g_h) -> "
                                "(Tensor, Tensor, Tensor, Tensor, Tensor, "
                                "Tensor, Tensor)")
def _slstm_scan_backward_op(wx, r, bias, c, n, m, h, *grads):
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (wx, r, bias, c, n, m, h)]
        got = torch.autograd.grad(_slstm_scan(*ins), ins, grads,
                                  allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g
                 for t, g in zip(ins, got))


@_slstm_scan_backward_op.register_fake
def _(wx, r, bias, c, n, m, h, *grads):
    return tuple(t.new_empty(t.shape) for t in (wx, r, bias, c, n, m, h))


def _scan_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _scan_backward(ctx, *grads):
    ins = ctx.saved_tensors
    wx, h = ins[0], ins[-1]
    like = (wx.new_empty(wx.shape[:2] + h.shape[1:]),) + ins[3:]
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(like, grads)]
    return _slstm_scan_backward_op(*ins, *grads)


_slstm_scan_op.register_autograd(_scan_backward, setup_context=_scan_setup)


def _slstm_local(wx, r, bias, c, n, m, h):
    if isinstance(wx, FakeTensor):
        return _slstm_scan_op(wx, r, bias, c, n, m, h)
    return _slstm_scan(wx, r, bias, c, n, m, h)


def _slstm(params: dict, wx: torch.Tensor, state: tuple):
    return per_shard(_slstm_local, wx, params["r"], params["b"], *state,
                     dims=((0,), (None,), (None,)) + ((0,),) * 4)


def slstm_block_apply(params: dict, x: torch.Tensor,
                      state: tuple | None = None, *,
                      n_heads: int) -> tuple[torch.Tensor, tuple]:
    """Full-sequence sLSTM: a sequential loop over time. x (B,S,d)."""
    dtype = x.dtype
    b, s, d = x.shape
    if state is None:
        state = slstm_init_state(b, d, x.device)
    wx = split_dim(constrain(x @ params["w_in"], ("batch", None, "mlp")),
                   -1, (4, d)).float()
    hs, *state = _slstm(params, wx, state)
    h = rms_norm(hs.to(dtype), params["ln_inner"])
    return F.silu(h @ params["w_ff_gate"]) @ params["w_ff_down"], \
        tuple(state)


def slstm_decode_step(params: dict, x: torch.Tensor, state: tuple
                      ) -> tuple[torch.Tensor, tuple]:
    """One token. x (B,1,d)."""
    dtype = x.dtype
    b, _, d = x.shape
    wx = split_dim(constrain(x @ params["w_in"], ("batch", None, "mlp")),
                   -1, (4, d)).float()
    _, *state = _slstm(params, wx, state)
    h = rms_norm(state[3][:, None, :].to(dtype), params["ln_inner"])
    return F.silu(h @ params["w_ff_gate"]) @ params["w_ff_down"], \
        tuple(state)
