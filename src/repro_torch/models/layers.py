"""Model primitives: RMSNorm, RoPE and M-RoPE, GQA attention, SwiGLU
(plain torch).

The port of ``repro/models/layers.py:27-257``.  No
Pallas kernel sits in this module, so plain torch is the port:

* the init helpers draw from a ``torch.Generator`` on the target device
  (the reference's ``jax.random`` bits cannot be replayed; tests carry the
  reference's weights across with :mod:`.convert` instead);
* :func:`chunked_attention` is the reference's chunked online-softmax
  (flash-style) attention, written out with the same chunking, masks and
  accumulator updates.  It is deliberately not
  ``F.scaled_dot_product_attention``: the reference computes this function
  itself.  The model's ``attn_impl != "ref"`` route goes to the
  hand-written kernels of :mod:`repro_torch.kernels` instead;
* :func:`decode_attention` is the reference's plain one-token attention
  against a KV cache (the ``attn_impl="ref"`` decode path).

The logical axes of the parameters (:func:`swiglu_axes` here, the
``*_axes`` functions of the other model modules) are trees of their own,
aligned leaf for leaf with the init functions' tensors, as the reference's
``(params, axes)`` pairs are; :func:`swiglu` pins its hidden activation
through :func:`repro_torch.parallel.sharding.constrain` where the
reference does (``layers.py:257``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..parallel.sharding import constrain, per_shard, split_dim

__all__ = ["NEG_INF", "apply_rope", "chunked_attention", "decode_attention",
           "dense_init", "log_sigmoid", "mrope_angles", "norm_init",
           "rms_norm", "rope_angles", "swiglu", "swiglu_axes", "swiglu_init"]

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype, scale: float | None = None, *,
               lead: tuple[int, ...] = ()) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in float32, cast to ``dtype``; shape
    ``lead + (in_dim, out_dim)`` (``lead`` stacks layers)."""
    scale = 1.0 / math.sqrt(in_dim) if scale is None else scale
    w = torch.randn(lead + (in_dim, out_dim), generator=gen,
                    dtype=torch.float32, device=gen.device) * scale
    return w.to(dtype)


def norm_init(dim: int, dtype: torch.dtype, device: torch.device, *,
              lead: tuple[int, ...] = ()) -> torch.Tensor:
    return torch.ones(lead + (dim,), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid``; on a DTensor shard by shard (an elementwise op,
    so each device's shard is its own: DTensor has no rule for
    ``aten.log_sigmoid_backward``), its bits and its backward's the plain
    op's."""
    return per_shard(F.logsigmoid, x, dims=tuple(range(x.dim())))


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dtype)


# ---------------------------------------------------------------------------
# RoPE and M-RoPE
# ---------------------------------------------------------------------------

def _inv_freq(head_dim: int, theta: float,
              device: torch.device) -> torch.Tensor:
    """The head_dim//2 rotary frequencies, float32."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=device) / half
    return 1.0 / torch.pow(
        torch.tensor(theta, dtype=torch.float32, device=device), exponent)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables. positions (..., S) -> (..., S, head_dim//2), fp32."""
    inv_freq = _inv_freq(head_dim, theta, positions.device)
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def mrope_angles(positions_thw: torch.Tensor,
                 sections: tuple[int, int, int], head_dim: int,
                 theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE (Qwen2-VL): positions_thw (B, S, 3) -> (B, S, head_dim//2)
    tables.

    The head_dim//2 rotary frequencies are split into (t, h, w) sections;
    each frequency rotates by its section's positional component.  The
    frequencies are :func:`rope_angles`' own, so text tokens, which carry
    (t, h, w) = (pos, pos, pos), get its bits.
    """
    half = head_dim // 2
    st, sh, sw = sections
    if st + sh + sw != half:
        raise ValueError(f"M-RoPE sections {sections} must sum to {half}")
    dev = positions_thw.device
    # Which positional component drives each frequency.
    comp = torch.cat([torch.full((n,), c, dtype=torch.long, device=dev)
                      for c, n in enumerate(sections)])
    inv_freq = _inv_freq(head_dim, theta, dev)
    pos = torch.gather(positions_thw.float(), -1,
                       comp.expand(positions_thw.shape[:2] + (half,)))
    ang = pos * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, hd); cos/sin (S, hd//2) or, for per-row positions as
    in decode, (B, S, hd//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos_b, sin_b = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos_b, sin_b = cos[:, :, None, :], sin[:, :, None, :]
    xf = x.dtype
    x1, x2 = x1.float(), x2.float()
    out = torch.cat([x1 * cos_b - x2 * sin_b,
                     x2 * cos_b + x1 * sin_b], dim=-1)
    return out.to(xf)


# ---------------------------------------------------------------------------
# Attention (reference path): chunked online-softmax, GQA, causal / window /
# bidirectional.
# ---------------------------------------------------------------------------

def _pick_chunk(s: int, target: int) -> int:
    """Largest divisor of s that is <= target."""
    c = min(s, target)
    while s % c:
        c -= 1
    return c


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: int = 0, q_offset: int = 0,
                      q_chunk: int = 512, kv_chunk: int = 512
                      ) -> torch.Tensor:
    """Flash-style attention. q (B,Sq,H,hd); k,v (B,Skv,KV,hd) -> (B,Sq,H,hd).

    The reference's ``lax.map`` over q chunks and ``lax.scan`` over kv
    chunks are Python loops here; each step is the same einsum, mask,
    running max, rescale and accumulate.
    """
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    qc = _pick_chunk(sq, q_chunk)
    kc = _pick_chunk(skv, kv_chunk)
    nq, nk = sq // qc, skv // kc
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    qr = q.reshape(b, nq, qc, kv, g, hd).float() * scale
    kr = k.reshape(b, nk, kc, kv, hd).float()
    vr = v.reshape(b, nk, kc, kv, hd).float()
    q_pos = q_offset + torch.arange(sq, device=dev).reshape(nq, qc)
    k_pos = torch.arange(skv, device=dev).reshape(nk, kc)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)

    outs = []
    for qi in range(nq):
        qblk = qr[:, qi]                                  # (b,qc,kv,g,hd)
        qp = q_pos[qi]
        m = torch.full((b, kv, g, qc), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kv, g, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kv, g, qc, hd), dtype=torch.float32,
                          device=dev)
        for kj in range(nk):
            kblk, vblk, kp = kr[:, kj], vr[:, kj], k_pos[kj]
            s = torch.einsum("bqkgd,bckd->bkgqc", qblk, kblk)
            mask = torch.ones((qc, kc), dtype=torch.bool, device=dev)
            if causal:
                mask &= qp[:, None] >= kp[None, :]
            if window:
                mask &= qp[:, None] - kp[None, :] < window
            s = torch.where(mask[None, None, None], s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqc,bckd->bkgqd", p, vblk)
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]  # (b,kv,g,qc,hd)
        outs.append(out.permute(0, 3, 1, 2, 4))           # (b,qc,kv,g,hd)
    out = torch.stack(outs, dim=1)                        # (b,nq,qc,kv,g,hd)
    return out.reshape(b, sq, kv * g, hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """Single-token attention against a KV cache (the reference's
    ``layers.decode_attention``; its unused ``ring_pos`` is not carried).

    q (B, 1, H, hd); caches (B, S, KV, hd); ``length`` (B,) = number of
    valid entries.  With ``window`` > 0 the cache is a ring buffer of size
    S == window holding min(length, window) valid entries.
    """
    b, _, h, hd = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(hd)
    qr = split_dim(q[:, 0], 1, (kv, g)).float() * scale
    scores = torch.einsum("bkgd,bskd->bkgs", qr, k_cache.float())
    idx = torch.arange(s, device=q.device)[None, :]
    lim = torch.clamp(length, max=window) if window else length
    valid = idx < lim[:, None]
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)
    scores = torch.where(valid[:, None, None, :], scores, neg)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def swiglu_init(gen: torch.Generator, d: int, f: int, dtype: torch.dtype, *,
                lead: tuple[int, ...] = ()) -> dict[str, torch.Tensor]:
    return {
        "w_gate": dense_init(gen, d, f, dtype, lead=lead),
        "w_up": dense_init(gen, d, f, dtype, lead=lead),
        "w_down": dense_init(gen, f, d, dtype, lead=lead),
    }


def swiglu_axes() -> dict[str, tuple]:
    return {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed")}


def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(x @ params["w_gate"])
    h = gate * (x @ params["w_up"])
    # The model axis on the hidden dim, never on seq (layers.py:250-257).
    axes = ("batch",) + (None,) * (h.dim() - 2) + ("mlp",)
    return constrain(h, axes) @ params["w_down"]
