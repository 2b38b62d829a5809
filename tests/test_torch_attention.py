"""The port's attention plain versions against the JAX package's.

Inputs are made with numpy from a seed and given to both frameworks (bf16
inputs are cast from the same float32 arrays, which rounds identically).
On the CPU the kernel wrappers take the plain versions, so:

* ``flash_attention_ref`` / ``decode_attention_ref`` and the wrappers are
  held to the reference's ``ref.*`` and to its Pallas kernels in interpret
  mode (``impl="pallas_interpret"``) on the reference's own cases
  (``tests/test_kernels.py``: ``FLASH_CASES`` with seq 96, ``DECODE_CASES``
  and per-batch lengths 1/64/128), at its tolerances: 2e-6 in float32,
  2e-2 in bfloat16;
* the model's plain decode ``layers.decode_attention`` and ``apply_rope``
  with per-row tables are held to the reference's;
* the CUDA kernels against their plain versions are ``gpu``-marked and
  skip without a card (the kernels have no CPU mode).
"""

import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers  # noqa: E402

FLASH_CASES = [
    # (b, sq, skv, h, kv, hd, causal, window, q_offset)
    (2, 128, 128, 4, 4, 64, True, 0, 0),      # MHA causal
    (2, 128, 128, 4, 2, 64, True, 0, 0),      # GQA
    (1, 256, 256, 8, 1, 64, True, 0, 0),      # MQA
    (1, 128, 128, 4, 2, 64, True, 64, 0),     # sliding window
    (2, 128, 256, 4, 2, 32, True, 0, 128),    # continuation (q_offset)
    (2, 128, 128, 4, 4, 64, False, 0, 0),     # bidirectional (encoder)
    (1, 64, 64, 2, 2, 128, True, 0, 0),       # head_dim 128
    (1, 96, 96, 2, 2, 32, True, 0, 0),        # seq 96: a ragged key tile
]

DECODE_CASES = [
    # (b, s, h, kv, hd, window, length)
    (2, 256, 8, 2, 64, 0, 200),
    (2, 256, 8, 8, 64, 0, 17),
    (3, 128, 10, 1, 32, 64, 100),   # ring buffer (recurrentgemma-like GQA)
    (1, 512, 4, 4, 128, 0, 512),
    (2, 128, 4, 2, 64, 128, 40),    # window larger than filled prefix
]

DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 2e-6, "bfloat16": 2e-2}


@functools.cache
def reference():
    """The JAX package's kernel entry points: (jnp, ops, ref), with the
    plain versions jitted (one compile per shape instead of one dispatch
    per operation)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as ref_ops
    from repro.kernels import ref
    jitted = types.SimpleNamespace(
        flash_attention_ref=jax.jit(
            ref.flash_attention_ref,
            static_argnames=("causal", "window", "q_offset")),
        decode_attention_ref=jax.jit(ref.decode_attention_ref,
                                     static_argnames="window"))
    return jnp, ref_ops, jitted


def arrays(shapes, seed):
    g = np.random.default_rng(seed)
    return [g.standard_normal(s).astype(np.float32) for s in shapes]


def as_jax(a, dtype):
    jnp, _, _ = reference()
    return jnp.asarray(a).astype(dtype)


def as_torch(a, dtype, device="cpu"):
    return torch.from_numpy(a).to(getattr(torch, dtype)).to(device)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def flash_inputs(case, seed=0):
    b, sq, skv, h, kv, hd = case[:6]
    return arrays([(b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd)], seed)


def decode_inputs(b, s, h, kv, hd, seed=3):
    return arrays([(b, 1, h, hd), (b, s, kv, hd), (b, s, kv, hd)], seed)


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_plain_matches_reference(case, dtype):
    _, ref_ops, ref = reference()
    causal, window, q_offset = case[6:]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    arrs = flash_inputs(case)
    j = [as_jax(a, dtype) for a in arrs]
    t = [as_torch(a, dtype) for a in arrs]
    out = fa.flash_attention(*t, **kw)          # CPU: the plain version
    assert out.dtype == t[0].dtype and out.shape == t[0].shape
    tol = TOL[dtype]
    np.testing.assert_allclose(f32(out),
                               f32(ref.flash_attention_ref(*j, **kw)),
                               atol=tol, rtol=tol)
    interp = ref_ops.flash_attention(*j, impl="pallas_interpret", bq=64,
                                     bk=64, **kw)
    np.testing.assert_allclose(f32(out), f32(interp), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_plain_matches_reference(case, dtype):
    jnp, ref_ops, ref = reference()
    b, s, h, kv, hd, window, length = case
    arrs = decode_inputs(b, s, h, kv, hd)
    j = [as_jax(a, dtype) for a in arrs]
    t = [as_torch(a, dtype) for a in arrs]
    lengths = np.full((b,), length, np.int32)
    out = da.decode_attention(*t, torch.from_numpy(lengths), window=window)
    assert out.dtype == t[0].dtype and out.shape == t[0].shape
    tol = TOL[dtype]
    jl = jnp.asarray(lengths)
    np.testing.assert_allclose(
        f32(out), f32(ref.decode_attention_ref(*j, jl, window=window)),
        atol=tol, rtol=tol)
    interp = ref_ops.decode_attention(*j, jl, window=window,
                                      impl="pallas_interpret", bk=64)
    np.testing.assert_allclose(f32(out), f32(interp), atol=tol, rtol=tol)


def test_decode_per_batch_lengths():
    jnp, ref_ops, ref = reference()
    arrs = decode_inputs(3, 128, 4, 2, 32, seed=4)
    j = [as_jax(a, "float32") for a in arrs]
    lengths = np.array([1, 64, 128], np.int32)
    out = da.decode_attention(*[torch.from_numpy(a) for a in arrs],
                              torch.from_numpy(lengths))
    jl = jnp.asarray(lengths)
    np.testing.assert_allclose(out.numpy(),
                               f32(ref.decode_attention_ref(*j, jl)),
                               atol=2e-6)
    interp = ref_ops.decode_attention(*j, jl, impl="pallas_interpret", bk=32)
    np.testing.assert_allclose(out.numpy(), f32(interp), atol=2e-6)


@pytest.mark.parametrize("window, lengths", [
    (0, [1, 200, 256]), (0, [0, 5, 300]), (64, [3, 64, 100])])
def test_model_decode_attention_matches_reference(window, lengths):
    """``layers.decode_attention`` (the attn_impl="ref" decode) against the
    reference's, with empty, partial, full and over-full caches."""
    jnp, _, _ = reference()
    import jax
    from repro.models import layers as ref_layers
    s = 64 if window else 256
    arrs = decode_inputs(3, s, 8, 2, 64, seed=5)
    lengths = np.array(lengths, np.int32)
    got = layers.decode_attention(*[torch.from_numpy(a) for a in arrs],
                                  torch.from_numpy(lengths), window=window)
    want = jax.jit(ref_layers.decode_attention, static_argnames="window")(
        *[jnp.asarray(a) for a in arrs], jnp.asarray(lengths), window=window)
    np.testing.assert_allclose(got.numpy(), f32(want), atol=2e-6, rtol=2e-6)


def test_apply_rope_per_row_tables_match_reference():
    """Decode passes per-row positions: cos/sin (B, S, hd/2)."""
    jnp, _, _ = reference()
    from repro.models import layers as ref_layers
    (x,) = arrays([(3, 1, 4, 64)], seed=6)
    pos = np.array([[0], [17], [4095]], np.int32)
    cos_r, sin_r = ref_layers.rope_angles(jnp.asarray(pos), 64, 10000.0)
    cos_t, sin_t = layers.rope_angles(torch.from_numpy(pos), 64, 10000.0)
    assert tuple(cos_t.shape) == cos_r.shape == (3, 1, 32)
    np.testing.assert_allclose(cos_t.numpy(), f32(cos_r), atol=1e-6)
    got = layers.apply_rope(torch.from_numpy(x), cos_t, sin_t)
    want = ref_layers.apply_rope(jnp.asarray(x), cos_r, sin_r)
    np.testing.assert_allclose(got.numpy(), f32(want), atol=1e-5)


@pytest.mark.parametrize("impl", ops.IMPLS)
def test_ops_dispatch_on_cpu(impl):
    """"ref" takes the model's plain route (chunked attention, the plain
    decode); the kernel impls take the kernels' plain versions for CPU
    tensors."""
    case = FLASH_CASES[1]
    q, k, v = (torch.from_numpy(a) for a in flash_inputs(case))
    want = layers.chunked_attention(q, k, v, causal=True, q_chunk=64,
                                    kv_chunk=32) if impl == "ref" \
        else fa.flash_attention_ref(q, k, v)
    assert torch.equal(ops.flash_attention(q, k, v, impl=impl, q_chunk=64,
                                           kv_chunk=32), want)
    q, kc, vc = (torch.from_numpy(a) for a in decode_inputs(2, 64, 4, 2, 32))
    n = torch.tensor([5, 64], dtype=torch.int32)
    assert torch.equal(ops.decode_attention(q, kc, vc, n, impl=impl),
                       layers.decode_attention(q, kc, vc, n))
    with pytest.raises(ValueError, match="attn_impl"):
        ops.flash_attention(q, kc, vc, impl="triton")


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flops_count_the_mask(case):
    b, sq, skv, h, kv, hd, causal, window, q_offset = case
    qp = q_offset + np.arange(sq)[:, None]
    kp = np.arange(skv)[None, :]
    mask = np.ones((sq, skv), bool)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= qp - kp < window
    assert fa.valid_pairs(sq, skv, causal=causal, window=window,
                          q_offset=q_offset) == mask.sum()
    assert fa.flops((b, sq, h, hd), skv, causal=causal, window=window,
                    q_offset=q_offset) == 4 * hd * b * h * mask.sum()


def test_bytes_moved():
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in flash_inputs(FLASH_CASES[1]))
    assert fa.bytes_moved(q, k, v) == 2 * (2 * q.numel() + 2 * k.numel())
    q, kc, _ = (torch.from_numpy(a) for a in decode_inputs(3, 128, 8, 2, 64))
    n = torch.tensor([0, 5, 300], dtype=torch.int32)
    # lim 0 reads all 128 entries, lim 300 all 128 of a full cache.
    assert da.bytes_moved(q, kc, n) \
        == 2 * q.numel() * 4 + 3 * 4 + 2 * (128 + 5 + 128) * 2 * 64 * 4
    assert da.bytes_moved(q, kc, n, window=64) \
        == 2 * q.numel() * 4 + 3 * 4 + 2 * (128 + 5 + 64) * 2 * 64 * 4


# -- the CUDA kernels against their plain versions (on the card) --------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; the kernels have no CPU "
                    "mode")


# Kernel against plain on the card.  Both compute in float32 and round the
# result to the input dtype once, so bf16 outputs differ by at most one
# bf16 ulp (2**-7 of the value; atol for values near 0).
CARD_TOL = {"float32": dict(atol=2e-6, rtol=2e-6),
            "bfloat16": dict(atol=1e-6, rtol=2.0 ** -7)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES + [
    (1, 2048, 2048, 32, 4, 64, True, 0, 0),     # tinyllama heads, seq 2048
    # Cases that cut the bf16 kernel's 64-row and 64-key tiles unevenly.
    (1, 130, 130, 4, 2, 64, True, 0, 0),
    (1, 64, 200, 4, 2, 64, True, 0, 136),
    (2, 130, 130, 4, 2, 32, True, 0, 0),
    (1, 200, 200, 2, 1, 128, True, 0, 0),
    (1, 130, 130, 4, 2, 128, True, 48, 0),
    (1, 70, 130, 2, 2, 64, False, 0, 0),
    # Head dim 80 (hubert-xlarge): bidirectional, uneven tiles, a window,
    # q_offset.
    (2, 128, 128, 4, 4, 80, False, 0, 0), (1, 130, 200, 4, 2, 80, False, 0, 0),
    (2, 130, 130, 4, 2, 80, True, 64, 0), (1, 64, 200, 4, 2, 80, True, 0, 136)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_matches_plain_on_card(case, dtype):
    _card()
    causal, window, q_offset = case[6:]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    t = [as_torch(a, dtype, "cuda") for a in flash_inputs(case)]
    launches = fa.flash_attention.launches
    out = fa.flash_attention(*t, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == launches + 1
    np.testing.assert_allclose(f32(out), f32(fa.flash_attention_ref(*t, **kw)),
                               **CARD_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("case", DECODE_CASES + [
    (3, 128, 4, 2, 32, 0, (1, 64, 128)), (2, 130, 16, 1, 64, 0, 0),
    (2, 64, 8, 2, 128, 0, 65),
    (8, 2176, 32, 4, 64, 0, (2176, 2175, 2113, 2049, 2048, 1000, 64, 1)),
    # Valid prefixes that end inside the last block of a cluster.
    (2, 2176, 32, 4, 64, 0, (2175, 273)), (2, 300, 32, 2, 128, 0, (299, 5))])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_matches_plain_on_card(case, dtype):
    """The reference's cases, per-batch lengths 1/64/128, an empty cache
    (length 0: the uniform average), a full one (length S + 1, the
    reference's dropped write), tinyllama's heads (g = 8) over a cache of
    2,176 with ragged lengths, and prefixes that end inside the last block
    of a cluster of 8 (2,175 and 273 of 2,176; 299 and 5 of 300, where
    three blocks have no key)."""
    _card()
    b, s, h, kv, hd, window, length = case
    t = [as_torch(a, dtype, "cuda") for a in decode_inputs(b, s, h, kv, hd)]
    n = torch.tensor(length if isinstance(length, tuple) else [length] * b,
                     dtype=torch.int32, device="cuda")
    launches = da.decode_attention.launches
    out = da.decode_attention(*t, n, window=window)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == launches + 1
    np.testing.assert_allclose(
        f32(out), f32(da.decode_attention_ref(*t, n, window=window)),
        **CARD_TOL[dtype])


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take_on_card():
    _card()
    q, k, v = (torch.zeros((1, 8, 2, 64), device="cuda", dtype=dt)
               for dt in (torch.float16, torch.float16, torch.float16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q, k, v)
    q = torch.zeros((1, 8, 2, 48), device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        fa.flash_attention(q, q.detach(), q.detach())
    q = torch.zeros((1, 1, 34, 64), device="cuda")
    kc = torch.zeros((1, 16, 2, 64), device="cuda")
    n = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="at most 16"):
        da.decode_attention(q, kc, kc, n)


@pytest.mark.gpu
def test_decode_is_one_kernel_launch_on_card():
    """One CUDA call is one device kernel (no combine pass, no scratch
    allocation's memset) and adds one to the launch count."""
    _card()
    from torch.profiler import ProfilerActivity, profile
    t = [as_torch(a, "bfloat16", "cuda")
         for a in decode_inputs(8, 2176, 32, 4, 64)]
    n = torch.full((8,), 2000, dtype=torch.int32, device="cuda")
    da.decode_attention(*t, n)                  # built and warm
    torch.cuda.synchronize()
    launches = da.decode_attention.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        da.decode_attention(*t, n)
        torch.cuda.synchronize()
    assert da.decode_attention.launches == launches + 1
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert [e.name for e in kernels if "decode" in e.name] \
        and len(kernels) == 1, [e.name for e in kernels]


@pytest.mark.gpu
def test_kernels_refuse_misaligned_inputs_on_card():
    """The kernels copy rows 16 bytes at once: an input that does not
    start on a 16-byte boundary is refused, not copied."""
    _card()
    buf = torch.zeros(64 * 2 * 64 + 4, device="cuda", dtype=torch.bfloat16)
    odd = buf[4:].view(1, 64, 2, 64)            # 8 bytes off
    q = torch.zeros((1, 1, 4, 64), device="cuda", dtype=torch.bfloat16)
    kc = torch.zeros((1, 64, 2, 64), device="cuda", dtype=torch.bfloat16)
    n = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        da.decode_attention(q, kc, odd, n)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(odd, kc, kc)
