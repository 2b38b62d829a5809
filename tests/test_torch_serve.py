"""The port's serving path against the JAX package's, weights carried across.

Reduced llama3.2-1b in float32: the reference's ``init_params`` tree,
read as numpy, becomes the port's parameters (``models/convert.py``), and
prompts are drawn with numpy.  On the CPU:

* prefill logits and cache, and three ``decode_step``s from the
  reference's own cache (carried across), logits and cache after each;
* greedy ``generate``: tokens ``==`` and logprobs within 1e-4 of the
  reference's ``ServingEngine``;
* the kernel route, ``attn_impl="pallas"``, against the reference's
  ``"pallas_interpret"`` at 1e-3 (``tests/test_kernels.py:189-215``);
* a ``("local", "attn")`` unit whose prompt and decode wrap the ring;
* a full "attn" cache: the write is dropped and attention runs over
  length + 1 entries, as in the reference (ROADMAP Queue C);
* mirrors of ``tests/test_serve.py`` for the dense family: determinism,
  sampling differs from greedy, sampled logprobs <= 0, non-causal
  rejected; and the CLI on the CPU.

``decode_step`` updates the cache it is given in place, so a cache that is
used twice is cloned first.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.serve import ServingEngine as RefEngine  # noqa: E402

from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models import transformer as port_tf  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        state_to_numpy)
from repro_torch.serve import ServingEngine  # noqa: E402
from repro_torch.tree import flatten, leaf_names, tree_map  # noqa: E402

B, PROMPT, NEW, CACHE = 3, 24, 8, 48          # tests/test_serve.py's shape
TOL = dict(atol=1e-5, rtol=1e-5)               # float32 logits and caches

# The reference's modes, jitted as its ServingEngine runs them.
ref_prefill = jax.jit(ref_tf.prefill, static_argnums=0,
                      static_argnames="cache_len")
ref_decode = jax.jit(ref_tf.decode_step, static_argnums=0)
ref_forward = jax.jit(ref_tf.forward_train, static_argnums=0)


def config(**kw):
    return dataclasses.replace(REGISTRY["llama3.2-1b"].reduced(),
                               dtype="float32", **kw)


def carried(cfg, seed=0):
    params = jax.jit(lambda key: ref_tf.init_params(cfg, key)[0])(
        jax.random.PRNGKey(seed))
    return params, params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


def prompts(cfg, b=B, s=PROMPT, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def assert_cache_close(port, ref):
    assert leaf_names(port) == [jax.tree_util.keystr(p) for p, _ in
                                jax.tree_util.tree_flatten_with_path(ref)[0]]
    for name, t, r in zip(leaf_names(port), flatten(port),
                          jax.tree.leaves(ref)):
        r = np.asarray(r)
        assert t.shape == r.shape and t.numpy().dtype == r.dtype, name
        np.testing.assert_allclose(t.numpy(), r, err_msg=name, **TOL)


@pytest.fixture(scope="module")
def dense():
    cfg = config()
    return (cfg, *carried(cfg))


def test_prefill_logits_and_cache_match_reference(dense):
    cfg, ref_params, port_params = dense
    toks = prompts(cfg)
    lr, cr = ref_prefill(cfg, ref_params, {"tokens": jnp.asarray(toks)},
                         cache_len=CACHE)
    lt, ct = port_tf.prefill(cfg, port_params,
                             {"tokens": torch.from_numpy(toks)},
                             cache_len=CACHE)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lr), **TOL)
    assert_cache_close(ct, cr)


def test_decode_steps_match_reference(dense):
    """Three steps from the reference's prefill cache, carried across."""
    cfg, ref_params, port_params = dense
    toks = prompts(cfg)
    _, cr = ref_prefill(cfg, ref_params, {"tokens": jnp.asarray(toks)},
                        cache_len=CACHE)
    ct = params_from_numpy(jax.tree.map(np.asarray, cr), "cpu")
    tok = toks[:, -1]
    for _ in range(3):
        lr, cr = ref_decode(cfg, ref_params, jnp.asarray(tok), cr)
        lt, ct = port_tf.decode_step(cfg, port_params, torch.from_numpy(tok),
                                     ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lr), **TOL)
        assert_cache_close(ct, cr)
        tok = np.asarray(lr).argmax(-1).astype(np.int32)


def test_cache_round_trips_through_numpy(dense):
    cfg, _, port_params = dense
    _, cache = port_tf.prefill(cfg, port_params,
                               {"tokens": torch.from_numpy(prompts(cfg))},
                               cache_len=CACHE)
    back = params_from_numpy(state_to_numpy(cache), "cpu")
    assert leaf_names(back) == leaf_names(cache)
    assert all(torch.equal(a, b) for a, b in zip(flatten(cache),
                                                 flatten(back)))
    assert back["length"].dtype == torch.int32


def test_fresh_cache_matches_reference_init_cache(dense):
    cfg, _, port_params = dense
    engine = ServingEngine(cfg, port_params, cache_len=CACHE)
    port = engine.fresh_cache(B)
    ref = ref_tf.init_cache(cfg, B, CACHE)
    assert_cache_close(port, ref)
    assert all(not t.any() for t in flatten(port))


def test_greedy_generate_matches_reference(dense):
    cfg, ref_params, port_params = dense
    toks = prompts(cfg)
    r = RefEngine(cfg, ref_params, cache_len=CACHE).generate(
        {"tokens": jnp.asarray(toks)}, NEW)
    t = ServingEngine(cfg, port_params, cache_len=CACHE).generate(
        {"tokens": torch.from_numpy(toks)}, NEW)
    assert t.steps == r.steps == NEW
    assert t.tokens.dtype == torch.int32 and t.logprobs.dtype == torch.float32
    np.testing.assert_array_equal(t.tokens.numpy(), np.asarray(r.tokens))
    np.testing.assert_allclose(t.logprobs.numpy(), np.asarray(r.logprobs),
                               atol=1e-4)


def test_kernel_route_matches_reference_interpret(dense):
    """attn_impl="pallas" (on the CPU: the kernels' plain versions) against
    the reference's Pallas kernels in interpret mode, as
    ``tests/test_kernels.py::test_model_level_kernel_parity``."""
    cfg, ref_params, port_params = dense
    cfg_r = dataclasses.replace(cfg, attn_impl="pallas_interpret")
    cfg_t = dataclasses.replace(cfg, attn_impl="pallas")
    toks = prompts(cfg, b=2, s=32)
    lr, _ = ref_forward(cfg_r, ref_params, {"tokens": jnp.asarray(toks)})
    lt, _ = port_tf.forward_train(cfg_t, port_params,
                                  {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lr), atol=1e-3)
    _, cr = ref_prefill(cfg_r, ref_params, {"tokens": jnp.asarray(toks)},
                        cache_len=40)
    _, ct = port_tf.prefill(cfg_t, port_params,
                            {"tokens": torch.from_numpy(toks)}, cache_len=40)
    tok = toks[:, -1]
    lr, _ = ref_decode(cfg_r, ref_params, jnp.asarray(tok), cr)
    lt, _ = port_tf.decode_step(cfg_t, port_params, torch.from_numpy(tok), ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lr), atol=1e-3)


@pytest.fixture(scope="module")
def local():
    cfg = config(block_unit=("local", "attn"), attn_window=16)
    return (cfg, *carried(cfg))


@pytest.mark.parametrize("attn_impl", ["ref", "pallas"])
def test_local_ring_wraps_like_reference(local, attn_impl):
    """A ("local", "attn") unit with a 16-entry ring: the 24-token prompt
    wraps it in prefill (the roll) and 10 decode steps wrap it again."""
    cfg, ref_params, port_params = local
    cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    cfg_r = dataclasses.replace(
        cfg, attn_impl="ref" if attn_impl == "ref" else "pallas_interpret")
    toks = prompts(cfg)
    lr, cr = ref_prefill(cfg_r, ref_params, {"tokens": jnp.asarray(toks)},
                         cache_len=CACHE)
    lt, ct = port_tf.prefill(cfg, port_params,
                             {"tokens": torch.from_numpy(toks)},
                             cache_len=CACHE)
    assert ct["layers"][0]["k"].shape[2] == 16        # the ring
    assert_cache_close(ct, cr)
    tok = toks[:, -1]
    for _ in range(10):
        lr, cr = ref_decode(cfg_r, ref_params, jnp.asarray(tok), cr)
        lt, ct = port_tf.decode_step(cfg, port_params, torch.from_numpy(tok),
                                     ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lr), **TOL)
        assert_cache_close(ct, cr)
        tok = np.asarray(lr).argmax(-1).astype(np.int32)


@pytest.mark.parametrize("attn_impl", ["ref", "pallas"])
def test_full_cache_drops_the_write_like_reference(dense, attn_impl):
    """A prompt that fills an "attn" cache: the reference's one-hot blend
    writes nothing at slot == cache_len, and attention still runs over
    length + 1 entries (ROADMAP Queue C).  The port does the same."""
    cfg, ref_params, port_params = dense
    cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    cfg_r = dataclasses.replace(
        cfg, attn_impl="ref" if attn_impl == "ref" else "pallas_interpret")
    toks = prompts(cfg)
    _, cr = ref_prefill(cfg_r, ref_params, {"tokens": jnp.asarray(toks)},
                        cache_len=PROMPT)
    _, ct = port_tf.prefill(cfg, port_params,
                            {"tokens": torch.from_numpy(toks)},
                            cache_len=PROMPT)
    before = tree_map(torch.clone, ct)
    tok = toks[:, -1]
    lr, cr = ref_decode(cfg_r, ref_params, jnp.asarray(tok), cr)
    lt, ct = port_tf.decode_step(cfg, port_params, torch.from_numpy(tok), ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lr), **TOL)
    assert_cache_close(ct, cr)
    assert ct["length"].tolist() == [PROMPT + 1] * B
    for a, b in zip(flatten(before["layers"]), flatten(ct["layers"])):
        assert torch.equal(a, b)                      # nothing written


def test_prompt_longer_than_cache_raises(dense):
    cfg, _, port_params = dense
    with pytest.raises(ValueError, match="does not fit"):
        port_tf.prefill(cfg, port_params,
                        {"tokens": torch.from_numpy(prompts(cfg))},
                        cache_len=PROMPT - 1)


# -- mirrors of tests/test_serve.py (dense family) ----------------------------

@pytest.fixture(scope="module")
def engine():
    cfg = REGISTRY["llama3.2-1b"].reduced()
    params = port_model.init_params(cfg, seed=0, device="cpu")
    return cfg, ServingEngine(cfg, params, cache_len=CACHE)


def batch(cfg, shape, seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return port_model.make_batch(cfg, shape, gen)


def test_make_batch(engine):
    cfg, _ = engine
    a = batch(cfg, InputShape("s", PROMPT, B, "prefill"), 1)
    b = batch(cfg, InputShape("s", PROMPT, B, "prefill"), 1)
    assert a["tokens"].shape == (B, PROMPT)
    assert a["tokens"].dtype == torch.int32
    assert torch.equal(a["tokens"], b["tokens"])
    assert 0 <= int(a["tokens"].min()) and \
        int(a["tokens"].max()) < cfg.vocab_size
    shape = InputShape("decode_32k", 32768, 128, "decode")
    assert port_model.cache_len_for(cfg, shape) == 32768


def test_generate_shapes_and_determinism(engine):
    cfg, eng = engine
    bt = batch(cfg, InputShape("s", PROMPT, B, "prefill"), 1)
    r1 = eng.generate(bt, NEW)
    r2 = eng.generate(bt, NEW)
    assert r1.tokens.shape == (B, NEW)
    assert torch.equal(r1.tokens, r2.tokens)
    assert bool(torch.isfinite(r1.logprobs).all())
    assert int(r1.tokens.max()) < cfg.vocab_size


def test_sampling_differs_from_greedy(engine):
    cfg, eng = engine
    bt = batch(cfg, InputShape("s", PROMPT, B, "prefill"), 2)
    greedy = eng.generate(bt, 12)
    hot = eng.generate(bt, 12, temperature=1.5, seed=9)
    assert not torch.equal(greedy.tokens, hot.tokens)
    again = eng.generate(bt, 12, temperature=1.5, seed=9)
    assert torch.equal(hot.tokens, again.tokens)      # seeded


def test_sampled_logprobs_are_of_sampled_tokens(engine):
    cfg, eng = engine
    bt = batch(cfg, InputShape("s", 16, 2, "prefill"), 3)
    res = eng.generate(bt, 4, temperature=0.9, seed=1)
    assert float(res.logprobs.max()) <= 0.0


def test_non_causal_rejected(engine):
    cfg, eng = engine
    with pytest.raises(ValueError, match="encoder-only"):
        ServingEngine(dataclasses.replace(cfg, causal=False), eng.params)


def test_cli_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--arch", "llama3.2-1b", "--batch", "2",
          "--prompt-len", "8", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "arch=llama3.2-1b-smoke device=cpu batch=2 prompt=8 new=4" in out
    assert "tok/s (reduced, cpu)" in out
