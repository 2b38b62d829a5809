"""The port's ckpt_delta plain versions against the JAX package's.

Inputs are made with numpy from a seed and given to both frameworks (bf16
inputs are cast from the same float32 arrays, which rounds identically).

* Against the reference's plain ``ref.quantize_delta_ref`` /
  ``dequantize_delta_ref``: ``==`` on q, scales and the restored leaf.
  Every step is an IEEE float32 operation in both.
* Against the reference's Pallas kernel in interpret mode
  (``ops.*(impl="pallas_interpret")``): the interpreter takes the scale
  as ``absmax * (1/127)`` and contracts ``base + q*scale`` into one fused
  rounding, so the port is held to the reference's own bounds there
  (``tests/test_kernels.py:120-135``: |dq| <= 1 on < 2e-3 of elements,
  scales rtol 1e-6), and each difference is shown to be exactly that.
* The CUDA kernels ``==`` their plain versions: ``gpu``-marked, skipped
  without a card and nvcc.  JAX is imported by the tests that use it, so
  the card's tests also run where JAX is not installed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ckpt_delta as cd  # noqa: E402

SHAPES = [(1000, 37), (256,), (8, 8, 8), (4096, 16), (123,)]
DTYPES = ["float32", "bfloat16"]


def reference():
    """The JAX package's kernel entry points: (jnp, ops, ref)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops, ref
    return jnp, ops, ref


def pair(shape, dtype, seed=5, scale=0.01):
    """(cur, base) as (jax, torch) pairs with identical bits."""
    jnp, _, _ = reference()
    g = np.random.default_rng(seed)
    base = g.standard_normal(shape).astype(np.float32)
    cur = (base + scale * g.standard_normal(shape)).astype(np.float32)
    j = [jnp.asarray(a).astype(dtype) for a in (cur, base)]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (cur, base)]
    for a, b in zip(j, t):
        assert (np.asarray(a.astype(jnp.float32)) == b.float().numpy()).all()
    return j, t


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    jnp, _, _ = reference()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_equals_reference_ref(shape, dtype):
    _, _, ref = reference()
    (jc, jb), (tc, tb) = pair(shape, dtype)
    q_r, s_r = ref.quantize_delta_ref(jc, jb)
    q_t, s_t = cd.quantize_delta(tc, tb)          # CPU: the plain version
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_r))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_r))
    rec_r = ref.dequantize_delta_ref(q_r, s_r, jb)
    rec_t = cd.dequantize_delta(q_t, s_t, tb)
    assert rec_t.dtype == tb.dtype and rec_t.shape == tb.shape
    np.testing.assert_array_equal(as_f32(rec_t), as_f32(rec_r))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_against_pallas_interpret(shape, dtype):
    jnp, ops, _ = reference()
    (jc, jb), (tc, tb) = pair(shape, dtype)
    q_p, s_p = ops.quantize_delta(jc, jb, impl="pallas_interpret")
    q_t, s_t = cd.quantize_delta(tc, tb)
    diff = np.abs(np.asarray(q_p, np.int32) - q_t.numpy().astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 2e-3
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_p), rtol=1e-6)
    # Where the scales differ, the interpreter's is absmax * (1/127).
    absmax = torch.amax(torch.abs(cd._pad_blocks(tc.float() - tb.float(),
                                                 cd.BLOCK)), dim=1)
    recip = (absmax * torch.tensor(np.float32(1) / np.float32(127))).numpy()
    differ = np.asarray(s_p) != s_t.numpy()
    np.testing.assert_array_equal(np.asarray(s_p)[differ], recip[differ])

    # Dequantize the same (q, scales): where the interpreter differs, it
    # rounded base + q*scale once (a fused multiply-add).
    rec_p = as_f32(ops.dequantize_delta(jnp.asarray(q_t.numpy()),
                                        jnp.asarray(s_t.numpy()), jb,
                                        impl="pallas_interpret"))
    rec_t = as_f32(cd.dequantize_delta(q_t, s_t, tb))
    q_s = (q_t.double() * s_t.double()[:, None]).reshape(-1)
    fused = (tb.double() + q_s[: tb.numel()].reshape(tb.shape)).float() \
        .to(tb.dtype)
    differ = rec_p != rec_t
    np.testing.assert_array_equal(rec_p[differ], as_f32(fused)[differ])


@pytest.mark.parametrize("dtype", DTYPES)
def test_roundtrip_error_bound(dtype):
    """Reconstruction error <= scale/2 = absmax/254 per block (plus one
    bf16 rounding of the result for bf16 leaves)."""
    (_, _), (tc, tb) = pair((513, 17), dtype, seed=6, scale=0.05)
    q, s = cd.quantize_delta(tc, tb)
    rec = cd.dequantize_delta(q, s, tb)
    err = np.abs(tc.float().numpy() - rec.float().numpy())
    bound = float(s.max()) * 0.5 + 1e-2 * (dtype == "bfloat16")
    assert err.max() <= bound + 1e-7


def test_zero_delta():
    x = torch.ones((512,), dtype=torch.float32)
    q, s = cd.quantize_delta(x, x)
    assert int(q.abs().max()) == 0
    np.testing.assert_array_equal(s.numpy(), np.ones(2, np.float32))
    np.testing.assert_array_equal(cd.dequantize_delta(q, s, x).numpy(),
                                  x.numpy())


def test_cpu_tensors_take_the_plain_version():
    (_, _), (tc, tb) = pair((300,), "float32")
    before = (cd.quantize_delta.launches, cd.dequantize_delta.launches)
    q, s = cd.quantize_delta(tc, tb)
    cd.dequantize_delta(q, s, tb)
    assert (cd.quantize_delta.launches,
            cd.dequantize_delta.launches) == before


def test_bytes_moved():
    assert cd.bytes_moved(256, torch.float32) == 256 * 9 + 4
    assert cd.bytes_moved(257, torch.bfloat16) == 257 * 5 + 8


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES + [(0,), (65536 * 8 + 5,)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_equals_plain_on_card(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    g = np.random.default_rng(7)
    base = torch.from_numpy(g.standard_normal(shape)).to(
        getattr(torch, dtype)).cuda()
    cur = (base.float() + 0.01 * torch.from_numpy(
        g.standard_normal(shape)).float().cuda()).to(base.dtype)
    for c in (cur, base):                       # a real and a zero delta
        q_k, s_k = cd.quantize_delta(c, base)
        q_r, s_r = cd.quantize_delta_ref(c, base)
        torch.cuda.synchronize()
        assert torch.equal(q_k, q_r) and torch.equal(s_k, s_r)
        out_k = cd.dequantize_delta(q_k, s_k, base)
        out_r = cd.dequantize_delta_ref(q_r, s_r, base)
        torch.cuda.synchronize()
        assert out_k.dtype == base.dtype and out_k.shape == base.shape
        if out_k.numel():
            assert torch.equal(out_k.reshape(-1).view(torch.uint8),
                               out_r.reshape(-1).view(torch.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float16", "float64"])
def test_kernel_refuses_other_dtypes_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    base = torch.zeros(512, dtype=getattr(torch, dtype), device="cuda")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cd.quantize_delta(base, base)
    q = torch.zeros((2, cd.BLOCK), dtype=torch.int8, device="cuda")
    s = torch.ones(2, dtype=torch.float32, device="cuda")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cd.dequantize_delta(q, s, base)
