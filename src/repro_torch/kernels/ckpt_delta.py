"""Blockwise int8 delta quantization of checkpoint leaves: plain torch and
the CUDA kernels.

The proactive checkpoint (the paper's cost C_p) stores each large float
leaf of the train state as its delta against the last full checkpoint,
quantized to int8 with one absmax scale per block of ``BLOCK`` elements;
a restore adds the dequantized delta back to the base.

* :func:`quantize_delta_ref` / :func:`dequantize_delta_ref` are the plain
  versions, copies of the JAX package's ``ref.quantize_delta_ref`` /
  ``dequantize_delta_ref`` (``repro/kernels/ref.py:73-101``) in torch.
  Every step is an IEEE float32 operation.  The divisor ``127`` is a 0-dim
  tensor, not a Python number: on CUDA torch would multiply by its
  reciprocal instead.
* :func:`quantize_delta` / :func:`dequantize_delta` are the wrappers: a
  CPU tensor goes to the plain version, a CUDA tensor to the hand-written
  kernels of ``csrc/ckpt_delta.cu`` (built on first use by :mod:`._build`).
  A CUDA call launches the kernel or raises; it never falls back.  Each
  launch adds one to the wrapper's ``launches``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import device_of, entry

__all__ = ["BLOCK", "bytes_moved", "dequantize_delta", "dequantize_delta_ref",
           "quantize_delta", "quantize_delta_ref"]

BLOCK = 256

# dtype codes of the C entry points: the dtypes of the port's train states.
# float16 and float64 leaves, which the manager's predicate would also
# quantize, come from no config of the port; the kernels refuse them.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _pad_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, block)


def quantize_delta_ref(cur: torch.Tensor, base: torch.Tensor, *,
                       block: int = BLOCK
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise-absmax int8 quantization of (cur - base).

    Returns (q (n_blocks, block) int8, scales (n_blocks,) f32).  The flat
    delta is zero-padded to a block multiple.
    """
    delta = cur.float() - base.float()
    blocks = _pad_blocks(delta, block)
    absmax = torch.amax(torch.abs(blocks), dim=1)
    div = torch.tensor(127.0, dtype=torch.float32, device=absmax.device)
    scales = torch.where(absmax > 0, absmax / div, 1.0)
    q = torch.clamp(torch.round(blocks / scales[:, None]), -127, 127)
    return q.to(torch.int8), scales.float()


def dequantize_delta_ref(q: torch.Tensor, scales: torch.Tensor,
                         base: torch.Tensor, *,
                         block: int = BLOCK) -> torch.Tensor:
    """Inverse of :func:`quantize_delta_ref`: base + q * scale."""
    delta = (q.float() * scales[:, None]).reshape(-1)
    delta = delta[: base.numel()].reshape(base.shape)
    return (base.float() + delta).to(base.dtype)


def bytes_moved(n: int, dtype: torch.dtype, block: int = BLOCK) -> int:
    """Least bytes one quantize (or dequantize) of an ``n``-element leaf
    moves: two leaf reads and one int8 write per element (dequantize: one
    int8 and one leaf read, one leaf write), plus 4 bytes of scale per
    block."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return n * (2 * itemsize + 1) + 4 * (-(-n // block))


def _vec_ok(*tensors: torch.Tensor) -> int:
    return int(all(t.data_ptr() % 16 == 0 for t in tensors))


# C signatures of csrc/ckpt_delta.cu's entry points: pointers and the
# stream as c_void_p, element counts as c_longlong.
_QUANT_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
_DEQUANT_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_void_p]


def _check_kernel(dtype: torch.dtype, block: int) -> None:
    if dtype not in _DTYPES:
        raise TypeError(f"the ckpt_delta kernels take float32 or bfloat16, "
                        f"not {dtype}")
    if block != BLOCK:
        raise ValueError(f"the ckpt_delta kernels quantize blocks of "
                         f"{BLOCK}, not {block}")


def quantize_delta(cur: torch.Tensor, base: torch.Tensor, *,
                   block: int = BLOCK) -> tuple[torch.Tensor, torch.Tensor]:
    """Int8 delta of ``cur`` against ``base``: ``(q, scales)``.

    CPU tensors take the plain version; CUDA tensors the kernel (cur and
    base of one shape and one float dtype), which raises if it cannot be
    built or launched.
    """
    if device_of("ckpt_delta", cur, base) == "cpu":
        return quantize_delta_ref(cur, base, block=block)
    if cur.shape != base.shape or cur.dtype != base.dtype:
        raise ValueError(f"cur {tuple(cur.shape)} {cur.dtype} and base "
                         f"{tuple(base.shape)} {base.dtype} differ")
    _check_kernel(cur.dtype, block)
    cur, base = cur.contiguous(), base.contiguous()
    n = cur.numel()
    n_blocks = -(-n // BLOCK)
    q = torch.empty((n_blocks, BLOCK), dtype=torch.int8, device=cur.device)
    scales = torch.empty((n_blocks,), dtype=torch.float32, device=cur.device)
    if n == 0:
        return q, scales
    launch = entry("ckpt_delta", "ckpt_quantize_delta", _QUANT_ARGTYPES)
    with torch.cuda.device(cur.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(cur.data_ptr(), base.data_ptr(), _DTYPES[cur.dtype], n,
                     _vec_ok(cur, base), q.data_ptr(), scales.data_ptr(),
                     stream)
    quantize_delta.launches += 1
    if err != 0:
        raise RuntimeError(f"quantize_delta kernel launch failed: CUDA "
                           f"error {err}")
    return q, scales


quantize_delta.launches = 0


def dequantize_delta(q: torch.Tensor, scales: torch.Tensor,
                     base: torch.Tensor, *, block: int = BLOCK
                     ) -> torch.Tensor:
    """``base + q * scale`` in float32, cast to ``base.dtype``.

    CPU tensors take the plain version; CUDA tensors the kernel, which
    raises if it cannot be built or launched.
    """
    if device_of("ckpt_delta", q, scales, base) == "cpu":
        return dequantize_delta_ref(q, scales, base, block=block)
    _check_kernel(base.dtype, block)
    n = base.numel()
    n_blocks = -(-n // BLOCK)
    if q.dtype != torch.int8 or scales.dtype != torch.float32 \
            or q.shape != (n_blocks, BLOCK) or scales.shape != (n_blocks,):
        raise ValueError(f"a {n}-element leaf takes q ({n_blocks}, {BLOCK}) "
                         f"int8 and scales ({n_blocks},) float32, got "
                         f"{tuple(q.shape)} {q.dtype} and "
                         f"{tuple(scales.shape)} {scales.dtype}")
    q, scales, base = q.contiguous(), scales.contiguous(), base.contiguous()
    if q.data_ptr() % 8:                 # the kernel reads q 8 bytes at once
        q = q.clone()
    out = torch.empty_like(base)
    if n == 0:
        return out
    launch = entry("ckpt_delta", "ckpt_dequantize_delta",
                   _DEQUANT_ARGTYPES)
    with torch.cuda.device(base.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(q.data_ptr(), scales.data_ptr(), base.data_ptr(),
                     _DTYPES[base.dtype], n, _vec_ok(base, out),
                     out.data_ptr(), stream)
    dequantize_delta.launches += 1
    if err != 0:
        raise RuntimeError(f"dequantize_delta kernel launch failed: CUDA "
                           f"error {err}")
    return out


dequantize_delta.launches = 0
