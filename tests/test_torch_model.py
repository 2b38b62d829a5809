"""The port's dense decoder against the JAX package's, weights carried across.

The reference's ``init_params`` tree, read as numpy, becomes the port's
parameters (``models/convert.py``); tokens are drawn with numpy.  At
float32 on reduced tinyllama-1.1b (untied head) and llama3.2-1b (tied):

* the parameter tree has the reference's leaf names, shapes and dtypes;
* ``forward_train`` logits and ``loss_fn`` agree at atol/rtol 1e-5;
* the gradients of the loss agree with ``jax.grad`` at 1e-4 of each
  leaf's largest gradient (summation order differs between the two);

also with ``attn_layout="grouped"`` and with a sliding-window ("local")
block.  One bfloat16 case per config is held at 2e-2 of the largest
logit: bf16 rounds at other places in the two frameworks.  The kernel
route (``attn_impl="pallas"``) of ``forward_train`` matches the "ref"
path on the CPU, where it takes the flash kernel's plain version.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402

from repro_torch.configs import get  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models import transformer as port_tf  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        state_to_numpy)
from repro_torch.tree import flatten, leaf_names, unflatten  # noqa: E402

ARCHS = ["tinyllama-1.1b", "llama3.2-1b"]
VARIANTS = {
    "repeat_kv": {},
    "grouped": {"attn_layout": "grouped"},
    "local": {"block_unit": ("local",), "attn_window": 16},
}


def config(arch, dtype="float32", **kw):
    return dataclasses.replace(REGISTRY[arch].reduced(), dtype=dtype, **kw)


def carried(cfg, seed=0):
    params, _ = ref_tf.init_params(cfg, jax.random.PRNGKey(seed))
    return params, params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


def tokens(cfg, b=2, s=64, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    for dtype in ("float32", "bfloat16"):
        cfg = config(arch, dtype)
        ref_params, _ = ref_tf.init_params(cfg, jax.random.PRNGKey(0))
        port_params = port_tf.init_params(cfg, seed=0, device="cpu")
        ref_paths = jax.tree_util.tree_flatten_with_path(ref_params)[0]
        assert leaf_names(port_params) == [jax.tree_util.keystr(p)
                                           for p, _ in ref_paths]
        for t, (_, r) in zip(flatten(port_params), ref_paths):
            assert tuple(t.shape) == r.shape
            assert str(t.dtype).split(".")[1] == str(r.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_round_trip_through_numpy(arch):
    _, port = carried(config(arch, "bfloat16"))
    back = params_from_numpy(state_to_numpy(port), "cpu")
    for a, b in zip(flatten(port), flatten(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_loss_and_grads_match_reference_f32(arch, variant):
    cfg = config(arch, **VARIANTS[variant])
    ref_params, port_params = carried(cfg)
    toks = tokens(cfg)
    batch_r = {"tokens": jnp.asarray(toks)}
    batch_t = {"tokens": torch.from_numpy(toks)}

    logits_r, _ = ref_tf.forward_train(cfg, ref_params, batch_r)
    logits_t, _ = port_tf.forward_train(cfg, port_params, batch_t)
    np.testing.assert_allclose(f32(logits_t), f32(logits_r), atol=1e-5,
                               rtol=1e-5)

    (loss_r, _), grads_r = jax.value_and_grad(
        lambda p: ref_model.loss_fn(cfg, p, batch_r), has_aux=True)(
            ref_params)
    leaves = [p.detach().requires_grad_() for p in flatten(port_params)]
    loss_t, metrics = port_model.loss_fn(
        cfg, unflatten(port_params, leaves), batch_t)
    grads_t = torch.autograd.grad(loss_t, leaves)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_r),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(metrics["loss"], loss_t)
    for name, gt, gr in zip(leaf_names(port_params), grads_t,
                            jax.tree.leaves(grads_r)):
        gr = f32(gr)
        np.testing.assert_allclose(f32(gt), gr,
                                   atol=1e-4 * np.abs(gr).max(), rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference_bf16(arch):
    cfg = config(arch, "bfloat16")
    ref_params, port_params = carried(cfg)
    toks = tokens(cfg)
    logits_r, _ = ref_tf.forward_train(cfg, ref_params,
                                       {"tokens": jnp.asarray(toks)})
    logits_t, _ = port_tf.forward_train(cfg, port_params,
                                        {"tokens": torch.from_numpy(toks)})
    assert logits_t.dtype == torch.bfloat16
    ref = f32(logits_r)
    assert np.abs(f32(logits_t) - ref).max() <= 2e-2 * np.abs(ref).max()


def test_get_knows_the_ported_configs_only():
    """``get`` resolves every architecture of the JAX package (the model
    code, not the registry, raises for the unported families) and still
    raises for a name neither package knows."""
    from repro.configs import EXTRAS
    for name in list(REGISTRY) + list(EXTRAS):
        ref = REGISTRY.get(name) or EXTRAS[name]
        assert dataclasses.asdict(get(name)) == dataclasses.asdict(ref)
    with pytest.raises(KeyError, match="unknown arch"):
        get("no-such-model")


@pytest.mark.parametrize("arch, message", [
    ("qwen2-moe-a2.7b", "10.2"), ("recurrentgemma-2b", "10.3"),
    ("xlstm-125m", "10.4"), ("qwen2-vl-72b", "10.5")])
def test_unported_blocks_raise(arch, message):
    with pytest.raises(NotImplementedError, match=message):
        port_tf.init_params(REGISTRY[arch].reduced(), device="cpu")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_kernel_attention_impl_matches_ref_path(variant):
    """attn_impl="pallas" takes the flash kernel's wrapper, which on the
    CPU is its plain version (dense softmax, ``flash_attention_ref``); the
    "ref" path is ``chunked_attention``.  Both are float32 softmax
    attention, so the logits agree at the forward test's 1e-5."""
    cfg = config("tinyllama-1.1b", **VARIANTS[variant])
    _, port_params = carried(cfg)
    batch = {"tokens": torch.from_numpy(tokens(cfg))}
    logits_ref, _ = port_tf.forward_train(cfg, port_params, batch)
    logits_k, _ = port_tf.forward_train(
        dataclasses.replace(cfg, attn_impl="pallas"), port_params, batch)
    np.testing.assert_allclose(f32(logits_k), f32(logits_ref), atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="attn_impl"):
        port_tf.forward_train(dataclasses.replace(cfg, attn_impl="triton"),
                              port_params, batch)
