"""The port's MoE, RG-LRU hybrid and xLSTM families against the JAX
package's, weights carried across.

``REGISTRY[arch].reduced()`` of qwen2-moe-a2.7b, qwen3-moe-235b-a22b,
recurrentgemma-2b and xlstm-125m: the reference's ``init_params`` tree,
read as numpy, becomes the port's parameters (``models/convert.py``), and
tokens are drawn with numpy.  At float32, on the CPU:

* the parameter tree has the reference's leaf names, shapes and dtypes;
* ``forward_train`` logits, and ``loss_fn``'s loss and ``moe_aux``, agree
  at atol/rtol 1e-5; gradients at 1e-4 of each leaf's largest gradient;
* prefill's last logits, and every cache leaf, against the reference's
  prefill; seven ``decode_step``s from the reference's prefill cache; the
  port's ``init_cache`` against the reference's and against its own
  prefill's tree; three steps from a zero cache; greedy ``generate``
  tokens ``==`` (logprobs within 1e-4) the reference's ``ServingEngine``
  at ``tests/test_serve.py``'s shapes.  Cache leaves hold recurrent
  states carried through up to 71 sequential float32 steps (the sLSTM's
  h feeds back through its recurrent weights), which the two frameworks
  round differently: they are held at 1e-5 of each leaf's largest
  magnitude (and 1e-5 relative);
* ``moe_apply`` alone under a capacity small enough that assignments
  drop, the RG-LRU with a carried state and its growing state (a fault of
  the reference the port copies, ROADMAP Queue C R2), the mLSTM at a
  length the chunk
  does not divide (and its gradient finite), and the plain attention at
  head dim 256, g = 10, over a wrapped window, against
  ``repro/kernels/ref.py``;
* the kernel route (``attn_impl="pallas"``: on the CPU the kernels'
  plain versions) of recurrentgemma against the reference's
  ``"pallas_interpret"`` at 1e-3 (``tests/test_kernels.py:189-215``);
* one bfloat16 case per family at 2e-2 of the largest logit (bf16 rounds
  at other places in the two frameworks);
* ``check_supported`` takes every config of the zoo, and the attention
  kernels' input checks take head dim 256 (ROADMAP Queue C); the serving
  and training CLIs run each family.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.configs import REGISTRY  # noqa: E402
from repro.kernels import ref as ref_kernels  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import rglru as ref_rglru  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.models import xlstm as ref_xlstm  # noqa: E402
from repro.serve import ServingEngine as RefEngine  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models import moe as port_moe  # noqa: E402
from repro_torch.models import rglru as port_rglru  # noqa: E402
from repro_torch.models import transformer as port_tf  # noqa: E402
from repro_torch.models import xlstm as port_xlstm  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        state_to_numpy)
from repro_torch.serve import ServingEngine  # noqa: E402
from repro_torch.tree import flatten, leaf_names, unflatten  # noqa: E402

ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b", "recurrentgemma-2b",
         "xlstm-125m"]
FAMILIES = ["qwen2-moe-a2.7b", "recurrentgemma-2b", "xlstm-125m"]
B, PROMPT, NEW, CACHE = 3, 24, 8, 48          # tests/test_serve.py's shape
SEQ = 64                                       # forward / prefill length
TOL = dict(atol=1e-5, rtol=1e-5)

ref_prefill = jax.jit(ref_tf.prefill, static_argnums=0,
                      static_argnames="cache_len")
ref_decode = jax.jit(ref_tf.decode_step, static_argnums=0)
ref_forward = jax.jit(ref_tf.forward_train, static_argnums=0)


def config(arch, dtype="float32", **kw):
    return dataclasses.replace(REGISTRY[arch].reduced(), dtype=dtype, **kw)


def carried(cfg, seed=0):
    params = jax.jit(lambda key: ref_tf.init_params(cfg, key)[0])(
        jax.random.PRNGKey(seed))
    return params, params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


def tokens(cfg, b=2, s=SEQ, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def ref_names(tree):
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def assert_tree_close(port, ref, tol=1e-5):
    """Leaf names, shapes and dtypes ``==``; values within ``tol`` of each
    leaf's largest magnitude (at least 1) and ``tol`` relative."""
    assert leaf_names(port) == ref_names(ref)
    for name, t, r in zip(leaf_names(port), flatten(port),
                          jax.tree.leaves(ref)):
        r = np.asarray(r)
        assert tuple(t.shape) == r.shape, name
        assert t.detach().numpy().dtype == r.dtype, name
        np.testing.assert_allclose(
            t.detach().numpy(), r, rtol=tol,
            atol=tol * max(1.0, float(np.abs(r).max(initial=0.0))),
            err_msg=name)


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    cfg = config(request.param)
    return (cfg, *carried(cfg))


# -- parameters, forward, loss, gradients --------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    for dtype in ("float32", "bfloat16"):
        cfg = config(arch, dtype)
        ref_params, _ = ref_tf.init_params(cfg, jax.random.PRNGKey(0))
        port_params = port_tf.init_params(cfg, seed=0, device="cpu")
        assert leaf_names(port_params) == ref_names(ref_params)
        for t, r in zip(flatten(port_params), jax.tree.leaves(ref_params)):
            assert tuple(t.shape) == r.shape
            assert str(t.dtype).split(".")[1] == str(r.dtype)


def test_forward_loss_and_grads_match_reference_f32(family):
    cfg, ref_params, port_params = family
    toks = tokens(cfg)
    batch_r = {"tokens": jnp.asarray(toks)}
    batch_t = {"tokens": torch.from_numpy(toks)}

    logits_r, aux_r = ref_forward(cfg, ref_params, batch_r)
    logits_t, aux_t = port_tf.forward_train(cfg, port_params, batch_t)
    np.testing.assert_allclose(f32(logits_t), f32(logits_r), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_r), **TOL)
    assert (float(aux_t) > 0) == bool(cfg.n_experts)

    (loss_r, metrics_r), grads_r = jax.value_and_grad(
        lambda p: ref_model.loss_fn(cfg, p, batch_r), has_aux=True)(
            ref_params)
    leaves = [p.detach().requires_grad_() for p in flatten(port_params)]
    loss_t, metrics = port_model.loss_fn(
        cfg, unflatten(port_params, leaves), batch_t)
    grads_t = torch.autograd.grad(loss_t, leaves, allow_unused=True)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_r), **TOL)
    np.testing.assert_allclose(float(metrics["moe_aux"]),
                               float(metrics_r["moe_aux"]), **TOL)
    for name, gt, gr in zip(leaf_names(port_params), grads_t,
                            jax.tree.leaves(grads_r)):
        gr = f32(gr)
        gt = np.zeros_like(gr) if gt is None else f32(gt)
        assert np.isfinite(gt).all(), name
        np.testing.assert_allclose(gt, gr, atol=1e-4 * np.abs(gr).max(),
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_reference_bf16(arch):
    """Every token's logits within 2e-2 of the largest, except, for MoE,
    at most 1 in 64 tokens: where two router probabilities nearly tie,
    bf16 rounding upstream picks other experts for the token (the
    reference's own bf16 route flips 1 of these 128 tokens against its
    float32 route on the same weights), which moves its logits by a whole
    expert's share."""
    cfg = config(arch, "bfloat16")
    ref_params, port_params = carried(cfg)
    toks = tokens(cfg)
    logits_r, _ = ref_forward(cfg, ref_params, {"tokens": jnp.asarray(toks)})
    logits_t, _ = port_tf.forward_train(cfg, port_params,
                                        {"tokens": torch.from_numpy(toks)})
    assert logits_t.dtype == torch.bfloat16
    ref = f32(logits_r)
    per_token = np.abs(f32(logits_t) - ref).max(axis=-1)
    off = int((per_token > 2e-2 * np.abs(ref).max()).sum())
    assert off <= (toks.size // 64 if cfg.n_experts else 0)


# -- prefill, decode, caches ----------------------------------------------------

def test_prefill_logits_and_cache_match_reference(family):
    cfg, ref_params, port_params = family
    toks = tokens(cfg)
    lr, cr = ref_prefill(cfg, ref_params, {"tokens": jnp.asarray(toks)},
                         cache_len=SEQ + 16)
    lt, ct = port_tf.prefill(cfg, port_params,
                             {"tokens": torch.from_numpy(toks)},
                             cache_len=SEQ + 16)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lr), **TOL)
    assert_tree_close(ct, cr)


def test_decode_steps_match_reference(family):
    """Seven steps from the reference's prefill cache, carried across; the
    port replaces the recurrent entries and leaves the given ones as they
    were."""
    cfg, ref_params, port_params = family
    toks = tokens(cfg)
    _, cr = ref_prefill(cfg, ref_params, {"tokens": jnp.asarray(toks)},
                        cache_len=SEQ + 16)
    ct = params_from_numpy(jax.tree.map(np.asarray, cr), "cpu")
    tok = toks[:, -1]
    for _ in range(7):
        kept = [t.clone() for t in flatten(ct)]
        lr, cr = ref_decode(cfg, ref_params, jnp.asarray(tok), cr)
        lt, new = port_tf.decode_step(cfg, port_params,
                                      torch.from_numpy(tok), ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lr), **TOL)
        assert_tree_close(new, cr)
        for kind, old_e, new_e in zip(cfg.block_unit, ct["layers"],
                                      new["layers"]):
            if kind in ("rec", "mlstm", "slstm"):
                before = kept[:len(flatten(old_e))]
                assert all(torch.equal(a, b)
                           for a, b in zip(before, flatten(old_e)))
            kept = kept[len(flatten(old_e)):]
        ct = new
        tok = np.asarray(lr).argmax(-1).astype(np.int32)


def test_init_cache_matches_reference_and_prefill(family):
    cfg, _, port_params = family
    port = port_tf.init_cache(cfg, 2, SEQ + 16, device="cpu")
    assert_tree_close(port, ref_tf.init_cache(cfg, 2, SEQ + 16), tol=0.0)
    _, filled = port_tf.prefill(cfg, port_params,
                                {"tokens": torch.from_numpy(tokens(cfg))},
                                cache_len=SEQ + 16)
    assert leaf_names(filled) == leaf_names(port)
    for a, b in zip(flatten(filled), flatten(port)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_decode_from_zero_cache_matches_reference(family):
    cfg, ref_params, port_params = family
    cr = ref_tf.init_cache(cfg, 2, 16)
    ct = port_tf.init_cache(cfg, 2, 16, device="cpu")
    tok = tokens(cfg, s=1)[:, 0]
    for _ in range(3):
        lr, cr = ref_decode(cfg, ref_params, jnp.asarray(tok), cr)
        lt, ct = port_tf.decode_step(cfg, port_params,
                                     torch.from_numpy(tok), ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lr), **TOL)
        assert_tree_close(ct, cr)
        tok = np.asarray(lr).argmax(-1).astype(np.int32)


def test_cache_round_trips_through_numpy(family):
    cfg, _, port_params = family
    _, cache = port_tf.prefill(cfg, port_params,
                               {"tokens": torch.from_numpy(tokens(cfg))},
                               cache_len=SEQ + 16)
    back = params_from_numpy(state_to_numpy(cache), "cpu")
    assert leaf_names(back) == leaf_names(cache)
    assert all(torch.equal(a, b) for a, b in zip(flatten(cache),
                                                 flatten(back)))


def test_greedy_generate_matches_reference(family):
    cfg, ref_params, port_params = family
    toks = tokens(cfg, b=B, s=PROMPT, seed=1)
    r = RefEngine(cfg, ref_params, cache_len=CACHE).generate(
        {"tokens": jnp.asarray(toks)}, NEW)
    engine = ServingEngine(cfg, port_params, cache_len=CACHE)
    t = engine.generate({"tokens": torch.from_numpy(toks)}, NEW)
    assert t.steps == r.steps == NEW
    np.testing.assert_array_equal(t.tokens.numpy(), np.asarray(r.tokens))
    np.testing.assert_allclose(t.logprobs.numpy(), np.asarray(r.logprobs),
                               atol=1e-4)
    again = engine.generate({"tokens": torch.from_numpy(toks)}, NEW)
    assert torch.equal(again.tokens, t.tokens)            # deterministic
    fresh = engine.fresh_cache(B)
    assert_tree_close(fresh, RefEngine(cfg, ref_params,
                                       cache_len=CACHE).fresh_cache(B),
                      tol=0.0)


def test_kernel_route_matches_reference_interpret():
    """recurrentgemma's "local" blocks through attn_impl="pallas" (on the
    CPU: the kernels' plain versions) against the reference's Pallas
    kernels in interpret mode: forward_train, and a decode step past the
    ring's wrap (prompt 80 over a window of 64)."""
    cfg = config("recurrentgemma-2b")
    ref_params, port_params = carried(cfg)
    cfg_r = dataclasses.replace(cfg, attn_impl="pallas_interpret")
    cfg_t = dataclasses.replace(cfg, attn_impl="pallas")
    toks = tokens(cfg, s=80)
    lr, _ = ref_forward(cfg_r, ref_params, {"tokens": jnp.asarray(toks)})
    lt, _ = port_tf.forward_train(cfg_t, port_params,
                                  {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lr), atol=1e-3)
    _, cr = ref_prefill(cfg_r, ref_params, {"tokens": jnp.asarray(toks)},
                        cache_len=96)
    _, ct = port_tf.prefill(cfg_t, port_params,
                            {"tokens": torch.from_numpy(toks)}, cache_len=96)
    tok = toks[:, -1]
    lr, _ = ref_decode(cfg_r, ref_params, jnp.asarray(tok), cr)
    lt, _ = port_tf.decode_step(cfg_t, port_params, torch.from_numpy(tok), ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lr), atol=1e-3)


# -- the modules alone ----------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, None])
def test_moe_apply_drops_like_reference(capacity_factor):
    """The layer alone, 2 x 48 tokens over 8 experts (6 live, 2 dead
    padding), top 2 and a shared expert: the output and aux loss at 1e-5,
    and at capacity 0.5 some assignments dropped.  A different set of
    drops would change a token's output by a whole expert's share, so
    agreement at 1e-5 means the same drops."""
    d, n_exp, top_k = 32, 6, 2
    params, _ = ref_moe.moe_init(jax.random.PRNGKey(3), d, n_exp, 16, 1,
                                 jnp.float32, pad_to=8)
    x = np.random.default_rng(4).standard_normal((2, 48, d)) \
        .astype(np.float32)
    out_r, aux_r = ref_moe.moe_apply(params, jnp.asarray(x), top_k=top_k,
                                     capacity_factor=capacity_factor)
    port = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    out_t, aux_t = port_moe.moe_apply(port, torch.from_numpy(x),
                                      top_k=top_k,
                                      capacity_factor=capacity_factor)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_r), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_r), **TOL)
    # The reference's drops, from its own routing: groups of 3 tokens
    # (gcd(96, 32) = 32 groups), capacity ceil(6 / 6 * cf) per expert.
    gates = jax.nn.softmax(jnp.asarray(x).reshape(32, 3, d)
                           @ params["router"], axis=-1)
    flat = np.asarray(jax.lax.top_k(gates, top_k)[1]).reshape(32, 6)
    pos = np.array([[int((row[:j] == row[j]).sum()) for j in range(6)]
                    for row in flat])
    cap = 6 if capacity_factor is None else max(
        1, int(np.ceil(6 / n_exp * capacity_factor)))
    drops = int((pos >= cap).sum())
    assert drops > 0 if capacity_factor == 0.5 else True
    assert drops == 0 if capacity_factor is None else True
    dropless, _ = port_moe.moe_apply(port, torch.from_numpy(x), top_k=top_k,
                                     capacity_factor=None)
    assert np.allclose(dropless.numpy(), out_t.numpy(), atol=1e-6) \
        == (drops == 0)


def test_moe_top_k_ties_take_the_lower_index():
    gates = torch.tensor([[0.2, 0.3, 0.3, 0.2]])
    vals, idx = port_moe._top_k(gates, 3)
    ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(gates.numpy()), 3)
    assert idx.tolist() == np.asarray(ref_idx).tolist() == [[1, 2, 0]]
    assert vals.tolist() == np.asarray(ref_vals).tolist()


def test_rglru_with_carried_state_matches_reference():
    d, w = 32, 48
    params, _ = ref_rglru.rglru_block_init(jax.random.PRNGKey(5), d, w, 4,
                                           jnp.float32)
    g = np.random.default_rng(6)
    x = g.standard_normal((2, 40, d)).astype(np.float32)
    state = {"h": g.standard_normal((2, w)).astype(np.float32),
             "conv": g.standard_normal((2, 3, w)).astype(np.float32)}
    out_r, st_r = ref_rglru.rglru_block_apply(
        params, jnp.asarray(x), jax.tree.map(jnp.asarray, state))
    port = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    out_t, st_t = port_rglru.rglru_block_apply(
        port, torch.from_numpy(x),
        {k: torch.from_numpy(v) for k, v in state.items()})
    # The output projection sums terms of hundreds to values near 1, so the
    # output is held at 1e-5 of its largest magnitude (as the states are).
    assert_tree_close(out_t, out_r)
    assert_tree_close(st_t, st_r)
    # Segments carry: two halves from the carried state == the whole.
    out_a, st_a = port_rglru.rglru_block_apply(
        port, torch.from_numpy(x[:, :17]),
        {k: torch.from_numpy(v) for k, v in state.items()})
    out_b, st_b = port_rglru.rglru_block_apply(
        port, torch.from_numpy(x[:, 17:]), st_a)
    np.testing.assert_allclose(torch.cat([out_a, out_b], 1).numpy(),
                               out_t.numpy(), rtol=1e-5,
                               atol=1e-5 * float(out_t.abs().max()))
    np.testing.assert_allclose(st_b["h"].numpy(), st_t["h"].numpy(), **TOL)


def test_rglru_state_grows_like_reference():
    """ROADMAP Queue C R2, a fault of the reference that the port copies:
    ``log a = _C * r * log_sigmoid(Lambda)`` with ``_C = -8`` is >= 0, so
    a >= 1 and the state grows by up to e^0.42 a token.  Both packages
    give finite logits at 64 tokens and none that are all finite at 512."""
    cfg = config("recurrentgemma-2b")
    ref_params, port_params = carried(cfg)
    layer = {k: v[0] for k, v in port_params["layers"][0]["rec"].items()}
    y = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (2, 8, cfg.lru_width)).astype(np.float32))
    log_a, _ = port_rglru._rg_gates(layer, y)
    assert bool((log_a >= 0).all())
    for s, finite in ((64, True), (512, False)):
        toks = tokens(cfg, b=1, s=s)
        lr, _ = ref_forward(cfg, ref_params, {"tokens": jnp.asarray(toks)})
        lt, _ = port_tf.forward_train(cfg, port_params,
                                      {"tokens": torch.from_numpy(toks)})
        assert bool(np.isfinite(f32(lr)).all()) == finite
        assert bool(np.isfinite(f32(lt)).all()) == finite


@pytest.mark.parametrize("s, chunk", [(50, 16), (37, 8), (24, 256)])
def test_mlstm_chunk_not_dividing_matches_reference(s, chunk):
    """The chunk is lowered until it divides s (50 -> 10, 37 -> 1, 24 -> 24);
    output, state and the gradient through the masked exp (finite)."""
    d, heads = 32, 4
    params, _ = ref_xlstm.mlstm_block_init(jax.random.PRNGKey(7), d, heads,
                                           jnp.float32)
    x = np.random.default_rng(8).standard_normal((2, s, d)) \
        .astype(np.float32)
    out_r, st_r = ref_xlstm.mlstm_block_apply(params, jnp.asarray(x),
                                              n_heads=heads, chunk=chunk)
    port = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    xt = torch.from_numpy(x).requires_grad_()
    out_t, st_t = port_xlstm.mlstm_block_apply(port, xt, n_heads=heads,
                                               chunk=chunk)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_r),
                               **TOL)
    assert_tree_close(st_t, st_r)
    g_r = jax.grad(lambda a: ref_xlstm.mlstm_block_apply(
        params, a, n_heads=heads, chunk=chunk)[0].sum())(jnp.asarray(x))
    (g_t,) = torch.autograd.grad(out_t.sum(), xt)
    assert bool(torch.isfinite(g_t).all())
    g_r = np.asarray(g_r)
    np.testing.assert_allclose(g_t.numpy(), g_r,
                               atol=1e-4 * np.abs(g_r).max(), rtol=1e-4)


def test_plain_attention_hd256_g10_wrapped_window_matches_reference():
    """recurrentgemma's attention shape: 10 query heads over one kv head
    of 256.  The decode plain version over a 64-slot ring at lengths past
    the wrap, and the flash plain version with a window, against
    ``repro/kernels/ref.py``; the kernel wrappers take the plain versions
    for CPU tensors."""
    g = np.random.default_rng(9)
    q = g.standard_normal((3, 1, 10, 256)).astype(np.float32)
    kc = g.standard_normal((3, 64, 1, 256)).astype(np.float32)
    vc = g.standard_normal((3, 64, 1, 256)).astype(np.float32)
    n = np.array([100, 64, 7], np.int32)
    want = np.asarray(ref_kernels.decode_attention_ref(
        *map(jnp.asarray, (q, kc, vc, n)), window=64))
    t = [torch.from_numpy(a) for a in (q, kc, vc, n)]
    for got in (da.decode_attention_ref(*t, window=64),
                da.decode_attention(*t, window=64)):
        np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=2e-6)
    q = g.standard_normal((1, 96, 10, 256)).astype(np.float32)
    k = g.standard_normal((1, 96, 1, 256)).astype(np.float32)
    v = g.standard_normal((1, 96, 1, 256)).astype(np.float32)
    want = np.asarray(ref_kernels.flash_attention_ref(
        *map(jnp.asarray, (q, k, v)), causal=True, window=32))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    for got in (fa.flash_attention_ref(*t, causal=True, window=32),
                fa.flash_attention(*t, causal=True, window=32)):
        np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_input_checks_take_head_dim_256(dtype):
    """ROADMAP Queue C: the kernels were built for head dims 32-128 only,
    and their input check refused recurrentgemma's 256.  The check (the
    one a CUDA call passes before it launches) now takes 256 and still
    refuses a head dim no kernel is built for."""
    t = torch.zeros((1, 4, 2, 256), dtype=dtype)
    assert 256 in fa.HEAD_DIMS
    fa.check_kernel_inputs("flash_attention", t, t, t)
    fa.check_kernel_inputs("decode_attention", t[:, :1], t, t)
    bad = torch.zeros((1, 4, 2, 96), dtype=dtype)
    with pytest.raises(ValueError, match="head dims"):
        fa.check_kernel_inputs("flash_attention", bad, bad, bad)


# -- configs, entry points ------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ref_configs.REGISTRY)
                         + sorted(ref_configs.EXTRAS))
def test_check_supported_takes_every_config(arch):
    """Every config of the zoo, M-RoPE and encoder-only ones included
    (ROADMAP 10.5, 10.6), at full size and reduced."""
    cfg = configs.get(arch)
    port_tf.check_supported(cfg)
    port_tf.check_supported(cfg.reduced())


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_cli_on_cpu(arch, capsys):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--arch", arch, "--batch", "2",
          "--prompt-len", "8", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke device=cpu batch=2 prompt=8 new=4" in out


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_cli_on_cpu(arch, capsys, tmp_path):
    from repro_torch.launch.train import main
    main(["--device", "cpu", "--arch", arch, "--steps", "3", "--seq", "16",
          "--batch", "2", "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke device=cpu" in out and "waste=" in out
