"""The bf16 route of ``csrc/flash_attention.cu``, emulated in plain torch.

The tensor-core kernel cannot run on the CPU, but its arithmetic can: this
file repeats it step for step and holds the result to the plain version
``flash_attention_ref`` at the card's bf16 tolerance (one bf16 ulp; atol
1e-6 near zero), which the kernel must meet on the card.  What it emulates:

* q.k as bf16 products summed in f32 (exact products, as the tensor cores
  form them), the scale applied to the f32 score after the product;
* 64-row q tiles and 64-key tiles in the kernel's order, with its masks
  (NEG_INF = -1e30 for masked keys, -inf past Skv) and its skipping of
  key tiles masked for every row of a q tile;
* the online softmax in f32 (m, l, acc; ``expf``; acc / max(l, 1e-30));
* p @ v with p in ``parts`` bf16 parts, each product summed in f32.

The kernel takes three parts.  One rounding of p to bf16, or two parts,
leaves outputs near zero more than one bf16 ulp (and 1e-6) from the plain
version; ``python tests/test_torch_attention_numerics.py`` prints the
largest error and the count of outputs past the tolerance for 1, 2 and 3
parts.  No GPU is needed.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402

NEG_INF = -1e30
TILE = 64               # q rows and keys per tile, as in the kernel
PARTS = 3               # bf16 parts of p in the kernel
CARD_TOL = dict(atol=1e-6, rtol=2.0 ** -7)   # test_torch_attention.py's bf16

CASES = [
    # (b, sq, skv, h, kv, hd, causal, window, q_offset): the reference's
    # FLASH_CASES (tests/test_kernels.py) ...
    (2, 128, 128, 4, 4, 64, True, 0, 0),
    (2, 128, 128, 4, 2, 64, True, 0, 0),
    (1, 256, 256, 8, 1, 64, True, 0, 0),
    (1, 128, 128, 4, 2, 64, True, 64, 0),
    (2, 128, 256, 4, 2, 32, True, 0, 128),
    (2, 128, 128, 4, 4, 64, False, 0, 0),
    (1, 64, 64, 2, 2, 128, True, 0, 0),
    (1, 96, 96, 2, 2, 32, True, 0, 0),
    # ... tinyllama-1.1b's heads (32 / 4, hd 64) at seq 512 ...
    (1, 512, 512, 32, 4, 64, True, 0, 0),
    # ... and tiles cut unevenly (130 rows and keys; 64 rows over 200 keys
    # from position 136; hd 32 and 128).
    (1, 130, 130, 4, 2, 64, True, 0, 0),
    (1, 64, 200, 4, 2, 64, True, 0, 136),
    (2, 130, 130, 4, 2, 32, True, 0, 0),
    (1, 200, 200, 2, 1, 128, True, 0, 0),
]


def split_parts(p: torch.Tensor, parts: int) -> list[torch.Tensor]:
    """p (f32) as ``parts`` bf16 values (returned in f32) whose sum
    approximates p: each part is the bf16 rounding of what is left."""
    out, rest = [], p
    for _ in range(parts):
        part = rest.bfloat16().float()
        out.append(part)
        rest = rest - part
    return out


def emulate(q, k, v, *, causal=True, window=0, q_offset=0, parts=PARTS):
    """The bf16 kernel's arithmetic on bf16 q (B,Sq,H,hd), k, v
    (B,Skv,KV,hd); returns bf16 (B,Sq,H,hd)."""
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().permute(0, 2, 1, 3)                      # (B,H,Sq,hd)
    kf = k.float().repeat_interleave(g, 2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(g, 2).permute(0, 2, 1, 3)
    out = torch.empty((b, h, sq, hd))
    for q0 in range(0, sq, TILE):
        rows = min(TILE, sq - q0)
        qp = q_offset + q0 + torch.arange(rows)
        qp_lo, qp_hi = int(qp[0]), int(qp[-1])
        all_rows_valid = (not causal or qp_lo >= 0) and \
            (not window or qp_hi - window + 1 <= skv - 1)
        k_lo, k_hi = 0, skv
        if all_rows_valid:
            if causal:
                k_hi = min(skv, qp_hi + 1)
            if window:
                k_lo = max(0, qp_lo - window + 1)
        qt = qf[:, :, q0:q0 + rows]
        m = torch.full((b, h, rows, 1), NEG_INF)
        l = torch.zeros((b, h, rows, 1))
        acc = torch.zeros((b, h, rows, hd))
        for k0 in range(k_lo, k_hi, TILE):
            keys = torch.arange(k0, k0 + TILE)
            inside = keys < skv
            kt = torch.zeros((b, h, TILE, hd))     # rows past Skv: zeros
            vt = torch.zeros((b, h, TILE, hd))
            n_in = int(inside.sum())
            kt[:, :, :n_in] = kf[:, :, k0:k0 + n_in]
            vt[:, :, :n_in] = vf[:, :, k0:k0 + n_in]
            s = (qt @ kt.transpose(-1, -2)) * scale
            ok = torch.ones((rows, TILE), dtype=torch.bool)
            if causal:
                ok &= qp[:, None] >= keys[None]
            if window:
                ok &= qp[:, None] - keys[None] < window
            x = torch.where(ok, s, torch.tensor(NEG_INF))
            x = torch.where(inside[None], x, torch.tensor(-math.inf))
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            p = torch.exp(x - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr
            m = m_new
            for part in split_parts(p, parts):
                acc = acc + part @ vt
        out[:, :, q0:q0 + rows] = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def inputs(case, seed=0):
    b, sq, skv, h, kv, hd = case[:6]
    g = np.random.default_rng(seed)
    return [torch.from_numpy(g.standard_normal(s).astype(np.float32))
            .bfloat16() for s in ((b, sq, h, hd), (b, skv, kv, hd),
                                  (b, skv, kv, hd))]


def errors(case, parts, seed=0):
    """(largest |emulation - plain|, outputs past CARD_TOL) for a case."""
    causal, window, q_offset = case[6:]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v = inputs(case, seed)
    got = emulate(q, k, v, parts=parts, **kw).float()
    want = fa.flash_attention_ref(q, k, v, **kw).float()
    err = (got - want).abs()
    past = err > CARD_TOL["atol"] + CARD_TOL["rtol"] * want.abs()
    return float(err.max()), int(past.sum())


@pytest.mark.parametrize("case", CASES)
def test_bf16_route_within_one_ulp_of_plain(case):
    causal, window, q_offset = case[6:]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v = inputs(case)
    got = emulate(q, k, v, **kw)
    want = fa.flash_attention_ref(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               **CARD_TOL)


def test_split_parts_are_exact_remainders():
    """Each part takes what the ones before left, exactly (f32 subtraction
    of a bf16 rounding is exact), and three parts carry p to 2**-24."""
    p = torch.exp(-torch.from_numpy(
        np.random.default_rng(1).exponential(3.0, 4096).astype(np.float32)))
    one, two, three = split_parts(p, 3)
    assert torch.equal(one, p.bfloat16().float())
    assert torch.equal((p - one).double(), p.double() - one.double())
    assert torch.equal((p - one - two).double(),
                       p.double() - one.double() - two.double())
    rel = ((one.double() + two.double() + three.double()) - p.double()).abs() \
        / p.double()
    assert float(rel.max()) <= 2.0 ** -24


def test_one_part_is_the_single_rounding():
    """The one-part emulation rounds p to bf16 once: what a kernel without
    the split computes (its errors are reported, not bounded)."""
    case = CASES[1]
    q, k, v = inputs(case)
    out = emulate(q, k, v, parts=1)
    assert out.shape == q.shape and bool(torch.isfinite(out.float()).all())
    assert errors(case, 1)[0] >= errors(case, PARTS)[0]


if __name__ == "__main__":
    print("case, then for 1 / 2 / 3 bf16 parts of p: (largest error, "
          "outputs past one bf16 ulp + 1e-6)")
    for seed in range(3):
        for case in CASES:
            print(seed, case, [errors(case, n, seed) for n in (1, 2, 3)],
                  flush=True)
