"""The model's attention, dispatched by ``cfg.attn_impl`` in one place.

The port of ``repro/kernels/ops.py:24-41`` and of the model's
``attn_impl`` branches (``repro/models/transformer.py:195-199``,
``:336-341``).  ``impl``:

* ``"ref"``: the model's plain route, on any device: the chunked
  online-softmax :func:`~repro_torch.models.layers.chunked_attention` for
  a whole sequence and :func:`~repro_torch.models.layers.decode_attention`
  for one token against a KV cache;
* ``"pallas"`` and ``"pallas_interpret"``: the kernel wrappers, which
  launch the hand-written CUDA kernels for CUDA tensors and take their
  plain versions for CPU tensors.  The port has no interpreter; both names
  are kept so that a config's value means the same in both packages.
"""

from __future__ import annotations

import torch

from ..models import layers
from . import decode_attention as _da
from . import flash_attention as _fa

__all__ = ["IMPLS", "check_impl", "decode_attention", "flash_attention"]

IMPLS = ("ref", "pallas", "pallas_interpret")


def check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown attn_impl {impl!r}; one of {IMPLS}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    impl: str = "ref", q_chunk: int = 512,
                    kv_chunk: int = 512) -> torch.Tensor:
    """Attention of q (B,Sq,H,hd) over k, v (B,Skv,KV,hd); ``q_chunk`` and
    ``kv_chunk`` are the plain route's chunk sizes."""
    check_impl(impl)
    if impl == "ref":
        return layers.chunked_attention(q, k, v, causal=causal, window=window,
                                        q_offset=q_offset, q_chunk=q_chunk,
                                        kv_chunk=kv_chunk)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor, *,
                     window: int = 0, impl: str = "ref") -> torch.Tensor:
    """Attention of the one-token q (B,1,H,hd) over the caches (B,S,KV,hd)
    up to ``length`` (B,) int32."""
    check_impl(impl)
    fn = layers.decode_attention if impl == "ref" else _da.decode_attention
    return fn(q, k_cache, v_cache, length, window=window)
