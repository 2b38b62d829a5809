"""The port's optimizer and data stream against the JAX package's.

AdamW: the same params and gradients (numpy, from a seed) go through the
reference's ``adamw_update`` and the port's, one and three updates, with
fp32 and bf16 moments over fp32 and bf16 params.  Tolerance 2e-6 of each
leaf's largest magnitude: a few float32 ulps, from the order of the
global-norm sum and from XLA's fused multiply-adds, which eager torch does
not form (``m = b1*m + (1-b1)*g`` can cancel, so the bound is not taken
element by element).  The schedules and
clipping mirror ``tests/test_substrates.py:27-72``.

The data stream cannot replay ``jax.random``; it is held to the contract
instead (``tests/test_substrates.py:73-100``, token modality):
determinism and resume, and the learnable bigram structure; audio and VLM
configs get ``make_batch``'s structure (``tests/test_torch_modalities.py``
holds those batches in full).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as ref_adamw  # noqa: E402

from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.optim import adamw as port_adamw  # noqa: E402

RTOL = 2e-6


def close(port, ref):
    np.testing.assert_allclose(port, ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def both(arrays, dtype):
    """The same numpy arrays as a jax tree and a torch tree of ``dtype``."""
    return ({k: jnp.asarray(v).astype(dtype) for k, v in arrays.items()},
            {k: torch.from_numpy(v).to(getattr(torch, dtype))
             for k, v in arrays.items()})


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(moments, pdtype):
    g = np.random.default_rng(1)
    shapes = {"w": (64, 33), "b": (7,)}
    p_r, p_t = both({k: g.standard_normal(s).astype(np.float32)
                     for k, s in shapes.items()}, pdtype)
    cfg_r = ref_adamw.AdamWConfig(lr=1e-2, moment_dtype=moments,
                                  clip_norm=0.5)
    cfg_t = port_adamw.AdamWConfig(lr=1e-2, moment_dtype=moments,
                                   clip_norm=0.5)
    s_r, s_t = ref_adamw.adamw_init(p_r, cfg_r), \
        port_adamw.adamw_init(p_t, cfg_t)
    assert s_t["m"]["w"].dtype == getattr(torch, moments)
    for _ in range(3):
        g_r, g_t = both({k: g.standard_normal(s).astype(np.float32)
                         for k, s in shapes.items()}, pdtype)
        p_r, s_r, m_r = ref_adamw.adamw_update(p_r, g_r, s_r, cfg_r)
        p_t, s_t, m_t = port_adamw.adamw_update(p_t, g_t, s_t, cfg_t)
        assert int(s_t["step"]) == int(s_r["step"])
        for k in shapes:
            assert p_t[k].dtype == getattr(torch, pdtype)
            close(f32(p_t[k]), f32(p_r[k]))
            for mom in ("m", "v"):
                close(f32(s_t[mom][k]), f32(s_r[mom][k]))
        np.testing.assert_allclose(float(m_t["grad_norm"]),
                                   float(m_r["grad_norm"]), rtol=RTOL)
        assert float(m_t["lr"]) == float(m_r["lr"])


def test_adamw_converges_on_quadratic():
    cfg = port_adamw.AdamWConfig(lr=0.1, weight_decay=0.0, clip_norm=100.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = port_adamw.adamw_init(params, cfg)
    target = torch.tensor([1.0, 2.0])
    for _ in range(300):
        grads = {"w": 2.0 * (params["w"] - target)}
        params, state, _ = port_adamw.adamw_update(params, grads, state, cfg)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)
    assert int(state["step"]) == 300


def test_clip_by_global_norm():
    tree = {"a": torch.full((4,), 3.0), "b": torch.full((4,), 4.0)}
    clipped, norm = port_adamw.clip_by_global_norm(tree, 1.0)
    assert float(norm) == pytest.approx(10.0)
    assert float(port_adamw.global_norm(clipped)) == pytest.approx(
        1.0, rel=1e-5)
    same, _ = port_adamw.clip_by_global_norm(tree, 100.0)
    np.testing.assert_allclose(same["a"].numpy(), 3.0)


@pytest.mark.parametrize("name", ["cosine", "linear"])
def test_schedules_match_reference(name):
    ref = getattr(ref_adamw, f"{name}_schedule")(1.0, 10, 110)
    port = getattr(port_adamw, f"{name}_schedule")(1.0, 10, 110)
    steps = np.arange(0, 130)
    a = np.array([float(ref(jnp.asarray(s, jnp.int32))) for s in steps])
    b = np.array([float(port(torch.tensor(s, dtype=torch.int32)))
                  for s in steps])
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
    assert b[0] == pytest.approx(0.0)
    assert b[10] == pytest.approx(1.0, abs=1e-2)
    assert b[110] == pytest.approx(0.1 if name == "cosine" else 0.0,
                                   abs=1e-2)
    const = port_adamw.constant_schedule(0.5)(torch.tensor(3))
    assert const.dtype == torch.float32 and float(const) == 0.5


def test_adamw_bf16_moments_step():
    cfg = port_adamw.AdamWConfig(lr=0.01, moment_dtype="bfloat16")
    params = {"w": torch.ones((8,), dtype=torch.bfloat16)}
    state = port_adamw.adamw_init(params, cfg)
    assert state["m"]["w"].dtype == torch.bfloat16
    grads = {"w": torch.ones((8,), dtype=torch.bfloat16)}
    params2, _, _ = port_adamw.adamw_update(params, grads, state, cfg)
    assert params2["w"].dtype == torch.bfloat16
    assert float(params2["w"][0]) < 1.0


# -- data stream -------------------------------------------------------------------

def test_data_determinism_and_resume():
    cfg = REGISTRY["tinyllama-1.1b"].reduced()
    shape = InputShape("t", 32, 4, "train")
    pipe1 = SyntheticLM(cfg, shape, DataConfig(seed=7))
    pipe2 = SyntheticLM(cfg, shape, DataConfig(seed=7))
    for step in (0, 5, 123):
        b1, b2 = pipe1.batch_at(step)["tokens"], pipe2.batch_at(step)["tokens"]
        assert b1.dtype == torch.int32 and tuple(b1.shape) == (4, 32)
        assert torch.equal(b1, b2)
    assert not torch.equal(pipe1.batch_at(0)["tokens"],
                           pipe1.batch_at(1)["tokens"])
    pipe3 = SyntheticLM(cfg, shape, DataConfig(seed=8))
    assert not torch.equal(pipe1.batch_at(0)["tokens"],
                           pipe3.batch_at(0)["tokens"])
    it = iter(pipe1)
    assert torch.equal(next(it)["tokens"], pipe1.batch_at(0)["tokens"])
    assert torch.equal(next(it)["tokens"], pipe1.batch_at(1)["tokens"])


def test_data_has_learnable_structure():
    """The bigram injection is present, and the unigram is Zipf-heavy."""
    cfg = REGISTRY["tinyllama-1.1b"].reduced()
    shape = InputShape("t", 256, 4, "train")
    toks = SyntheticLM(cfg, shape, DataConfig(seed=0)).batch_at(0)[
        "tokens"].numpy()
    assert toks.min() >= 0 and toks.max() < cfg.vocab_size
    follows = (toks[:, 1:] == (toks[:, :-1] + 17) % cfg.vocab_size).mean()
    assert follows > 0.5  # bigram_prob=0.65 minus collisions
    fresh = SyntheticLM(cfg, shape, DataConfig(seed=0, bigram_prob=0.0))
    toks = fresh.batch_at(0)["tokens"].numpy().ravel()
    # Zipf(1.2) over 512 tokens puts ~30% of the mass on token 0.
    assert 0.2 < (toks == 0).mean() < 0.4


def test_data_other_modalities_stream():
    """Audio and VLM configs (ROADMAP 10.5, 10.6) get the stub batches of
    ``make_batch``, not token streams."""
    from repro.configs import REGISTRY as REF
    shape = InputShape("t", 32, 2, "train")
    vlm = SyntheticLM(REF["qwen2-vl-72b"].reduced(), shape).batch_at(0)
    assert set(vlm) == {"tokens", "vision_embeds", "vision_mask",
                        "positions_thw"}
    assert vlm["vision_mask"][:, :8].all() and not vlm["vision_mask"][:, 8:].any()
    audio = SyntheticLM(REF["hubert-xlarge"].reduced(), shape).batch_at(0)
    assert set(audio) == {"frames", "labels", "mask"}
    assert audio["frames"].shape == (2, 32, 256)
