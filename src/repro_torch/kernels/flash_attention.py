"""Forward flash attention: the plain torch version and the CUDA kernel.

The model's kernel route (``cfg.attn_impl != "ref"``) of the teacher-forced
pass runs attention through this module, as the JAX package's
``forward_train`` runs ``kernels/flash_attention.py::flash_attention_pallas``.

* :func:`flash_attention_ref` is the plain version, a copy of the JAX
  package's ``ref.flash_attention_ref`` (``repro/kernels/ref.py:21-47``):
  dense GQA softmax attention in float32 with causal, sliding-window and
  ``q_offset`` masks at ``NEG_INF = -1e30``.
* :func:`flash_attention` is the wrapper: a CPU tensor goes to the plain
  version, a CUDA tensor to the hand-written kernel in
  ``csrc/flash_attention.cu`` (built on first use by :mod:`._build`):
  bfloat16 inputs on the tensor cores (wgmma, P in three bf16 parts),
  float32 inputs on the CUDA cores, at head dims 32, 64, 80, 128 and 256
  (:data:`HEAD_DIMS`; the Pallas kernel takes any; 80 is hubert-xlarge's,
  bidirectional).  A
  CUDA call launches the kernel or raises; it never falls back.  Each
  launch adds one to ``flash_attention.launches``.  The kernel is forward
  only, like the Pallas kernel: a CUDA call on inputs that need a gradient
  raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..models.layers import NEG_INF
from ._build import device_of, entry

__all__ = ["HEAD_DIMS", "NEG_INF", "bytes_moved", "flash_attention",
           "flash_attention_ref", "flops", "valid_pairs"]

HEAD_DIMS = (32, 64, 80, 128, 256)  # the head dims the kernel is built for

# dtype codes of the C entry points.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0) -> torch.Tensor:
    """Dense softmax attention with GQA. q (B,Sq,H,hd); k,v (B,Skv,KV,hd).

    ``window`` > 0 limits attention to the last ``window`` keys (requires
    causal).  ``q_offset`` is the absolute position of q[0].
    """
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    qf = q.float() / math.sqrt(hd)
    qr = qf.reshape(b, sq, kv, g, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qr, k.float())   # (B,KV,g,Sq,Skv)
    qp = q_offset + torch.arange(sq, device=q.device)
    kp = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp[:, None] >= kp[None, :]
    if window:
        mask &= qp[:, None] - kp[None, :] < window
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)
    s = torch.where(mask[None, None, None], s, neg)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def valid_pairs(sq: int, skv: int, *, causal: bool = True, window: int = 0,
                q_offset: int = 0) -> int:
    """(query, key) pairs the masks leave for one (batch, head)."""
    qp = q_offset + torch.arange(sq, dtype=torch.int64)
    hi = torch.clamp(qp, max=skv - 1) if causal \
        else torch.full_like(qp, skv - 1)
    lo = torch.clamp(qp - window + 1, min=0) if window \
        else torch.zeros_like(qp)
    return int(torch.clamp(hi - lo + 1, min=0).sum())


def flops(q_shape, skv: int, *, causal: bool = True, window: int = 0,
          q_offset: int = 0) -> int:
    """Operations one call needs: 2 * hd for q.k and 2 * hd for p @ v per
    valid (query, key) pair, over every batch row and head."""
    b, sq, h, hd = q_shape
    return 4 * hd * b * h * valid_pairs(sq, skv, causal=causal,
                                        window=window, q_offset=q_offset)


def bytes_moved(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """Least bytes one call moves: q, k and v read once, the output
    (q's shape and dtype) written once."""
    return sum(t.numel() * t.element_size() for t in (q, q, k, v))


def check_kernel_inputs(name: str, *tensors: torch.Tensor,
                        head_dims: tuple[int, ...] = HEAD_DIMS) -> None:
    """Raise for what the CUDA attention kernels do not take: mixed or
    other dtypes, a head dim outside ``head_dims`` (this kernel's
    :data:`HEAD_DIMS` unless the caller names its own), or inputs that
    need a gradient (the kernels have no backward, as the Pallas kernels
    have none)."""
    dtype = tensors[0].dtype
    if dtype not in _DTYPES or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"the {name} kernel takes float32 or bfloat16 "
                        f"inputs of one dtype, not "
                        f"{[str(t.dtype) for t in tensors]}")
    if tensors[0].shape[-1] not in head_dims:
        raise ValueError(f"the {name} kernel is built for head dims "
                         f"{head_dims}, not {tensors[0].shape[-1]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"the {name} kernel is forward only; take "
                           f"attn_impl='ref' to differentiate")


def check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """Raise for a tensor that does not start on a 16-byte boundary: the
    kernels copy rows into shared memory 16 bytes at once (cp.async)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"the {name} kernel copies rows 16 bytes at "
                             f"once; a {tuple(t.shape)} input starts at "
                             f"address {t.data_ptr():#x}, not on a 16-byte "
                             f"boundary")


# C signature of csrc/flash_attention.cu's entry point.
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 \
    + [ctypes.c_float, ctypes.c_void_p]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """Attention of ``q`` (B,Sq,H,hd) over ``k``, ``v`` (B,Skv,KV,hd).

    CPU tensors take the plain version; CUDA tensors the kernel, which
    raises if it cannot be built or launched.
    """
    if device_of("flash_attention", q, k, v) == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    check_kernel_inputs("flash_attention", q, k, v)
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    if k.shape != (b, skv, kv, hd) or v.shape != k.shape or h % kv:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} are not (B,Sq,H,hd) and "
                         f"(B,Skv,KV,hd) with KV dividing H")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.dtype == torch.bfloat16:
        check_aligned("flash_attention", q, k, v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if skv == 0:
        raise ValueError("flash_attention over no keys")
    launch = entry("flash_attention", "flash_attention_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), _DTYPES[q.dtype], b, sq, skv, h, kv, hd,
                     int(causal), window, q_offset, 1.0 / math.sqrt(hd),
                     stream)
    flash_attention.launches += 1
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out


flash_attention.launches = 0
