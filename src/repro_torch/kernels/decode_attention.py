"""One-token GQA attention against a KV cache: plain torch and the CUDA
kernel.

The serving engine's decode step runs attention through this module when
``cfg.attn_impl != "ref"``, as the JAX package's ``_block_decode`` runs
``kernels/decode_attention.py::decode_attention_pallas``.

* :func:`decode_attention_ref` is the plain version: the model's plain
  decode ``layers.decode_attention``, which computes what the JAX
  package's ``ref.decode_attention_ref`` (``repro/kernels/ref.py:50-70``)
  computes (q is scaled by ``* (1 / sqrt(hd))`` where ``ref.py`` divides by
  ``sqrt(hd)``: the same bits at head dim 64, within an fp32 ulp else).
* :func:`decode_attention` is the wrapper: a CPU tensor goes to the plain
  version, a CUDA tensor to the hand-written kernel in
  ``csrc/decode_attention.cu`` (built on first use by :mod:`._build`): one
  launch of clusters of 8 blocks per (batch, kv head), merged in shared
  memory, with no scratch in device memory, at head dims 32, 64, 128 and
  256 (:data:`HEAD_DIMS`; the Pallas kernel takes any, and no model with a
  decode step has another; ROADMAP Queue B, B13).  A CUDA call launches the
  kernel or raises; it never falls back.  Each call that launches adds one
  to ``decode_attention.launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..models.layers import decode_attention as decode_attention_ref
from ._build import device_of, entry
from .flash_attention import _DTYPES, check_aligned, check_kernel_inputs

__all__ = ["HEAD_DIMS", "MAX_GROUP", "bytes_moved", "decode_attention",
           "decode_attention_ref"]

HEAD_DIMS = (32, 64, 128, 256)  # the head dims the kernel is built for
MAX_GROUP = 16      # query heads per kv head the kernel takes


def bytes_moved(q: torch.Tensor, k_cache: torch.Tensor,
                length: torch.Tensor, *, window: int = 0) -> int:
    """Least bytes one call moves for these lengths: q read and the output
    written once, ``length`` read, and the valid k and v prefix of each
    batch row (min(lim, S) entries; all S when lim is 0) read once."""
    s, kv, hd = k_cache.shape[1:]
    lim = torch.clamp(length, max=window) if window else length
    rows = torch.where(lim > 0, torch.clamp(lim, max=s), s)
    kv_bytes = 2 * int(rows.sum()) * kv * hd * k_cache.element_size()
    return 2 * q.numel() * q.element_size() \
        + length.numel() * length.element_size() + kv_bytes


# C signature of csrc/decode_attention.cu's entry point.
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
    + [ctypes.c_float, ctypes.c_void_p]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """Attention of the one-token ``q`` (B,1,H,hd) over the caches
    (B,S,KV,hd) up to ``length`` (B,) int32.

    CPU tensors take the plain version; CUDA tensors the kernel, which
    raises if it cannot be built or launched.
    """
    if device_of("decode_attention", q, k_cache, v_cache, length) == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, length,
                                    window=window)
    check_kernel_inputs("decode_attention", q, k_cache, v_cache,
                        head_dims=HEAD_DIMS)
    b, one, h, hd = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    if one != 1 or k_cache.shape != (b, s, kv, hd) \
            or v_cache.shape != k_cache.shape or h % kv \
            or length.shape != (b,) or length.dtype != torch.int32:
        raise ValueError(f"q {tuple(q.shape)}, caches {tuple(k_cache.shape)}"
                         f" / {tuple(v_cache.shape)} and length "
                         f"{tuple(length.shape)} {length.dtype} are not "
                         f"(B,1,H,hd), (B,S,KV,hd) and (B,) int32")
    if h // kv > MAX_GROUP:
        raise ValueError(f"the decode_attention kernel takes at most "
                         f"{MAX_GROUP} query heads per kv head, not "
                         f"{h // kv}")
    if s == 0:
        raise ValueError("decode_attention over an empty cache")
    q, k_cache, v_cache, length = (t.contiguous() for t in
                                   (q, k_cache, v_cache, length))
    # k and v rows are copied 16 bytes at once.  The cache tree's per-layer
    # views start on such a boundary; a cache that does not is refused, not
    # copied (a copy of both caches per call would cost more than the call).
    check_aligned("decode_attention", k_cache, v_cache)
    out = torch.empty_like(q)
    if b == 0:
        return out
    launch = entry("decode_attention", "decode_attention_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                     length.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], b,
                     s, h, kv, hd, window, 1.0 / math.sqrt(hd), stream)
    decode_attention.launches += 1
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out


decode_attention.launches = 0
