"""The reference's per-unit remat on the port's train step.

``repro/models/transformer.py:443-482`` runs each repeat of
``cfg.block_unit`` under ``jax.checkpoint`` when ``cfg.remat`` is set and
the unrolled tail outside it; the port's ``forward_train`` runs each
repeat as one ``torch.utils.checkpoint`` region (non-reentrant) while
autograd records.  For every family (dense, MoE, RG-LRU, xLSTM, encoder,
M-RoPE VLM) at its reduced config in float32 and at least two repeats of
the unit (RG-LRU also at 5 layers: one unit and a 2-layer tail), on the
CPU, the port's weights carried across to the reference:

* the loss, ``moe_aux`` and every gradient with ``remat=True`` (both
  ``remat_policy`` values) ``==`` on the bits to ``remat=False``;
* those within the existing tolerances (loss and ``moe_aux`` 1e-5,
  gradients 1e-4 of each leaf's largest) of the reference's
  ``jax.value_and_grad(loss_fn)`` under its own ``remat=True``;
* the bytes saved for the backward (``saved_tensors_hooks``, one count
  per storage, the parameters' storages left out) rise by one unit input
  (B x S x d elements) per extra repeat with remat, and by a whole
  layer's activations without;
* a no-grad ``forward_train`` opens no checkpoint region; a recorded one
  opens one a repeat of the unit, none for the tail.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.utils.checkpoint import checkpoint  # noqa: E402
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402

from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models import transformer as port_tf  # noqa: E402
from repro_torch.tree import (flatten, leaf_names, tree_map,  # noqa: E402
                              unflatten)

B, SEQ = 2, 32
TOL = dict(atol=1e-5, rtol=1e-5)
# (arch, layers): two repeats of each family's unit; recurrentgemma-2b's
# unit is (rec, rec, local), so 5 layers run one unit and a 2-layer tail.
CASES = [("tinyllama-1.1b", 2), ("qwen2-moe-a2.7b", 2),
         ("recurrentgemma-2b", 6), ("recurrentgemma-2b", 5),
         ("xlstm-125m", 4), ("hubert-xlarge", 2), ("qwen2-vl-72b", 2)]
FAMILIES = ["tinyllama-1.1b", "qwen2-moe-a2.7b", "recurrentgemma-2b",
            "xlstm-125m", "hubert-xlarge", "qwen2-vl-72b"]


def config(arch, n_layers=None, **kw):
    cfg = REGISTRY[arch].reduced()
    return dataclasses.replace(cfg, dtype="float32",
                               n_layers=n_layers or cfg.n_layers, **kw)


def batches(cfg, seed=0):
    """The same float32 inputs for both packages: (reference batch, port
    batch); the VLM's mask and (t, h, w) grid from the port's
    ``vision_layout`` (the reference's ``make_batch`` gives them ``==``,
    ``tests/test_torch_modalities.py``)."""
    g = np.random.default_rng(seed)
    if not cfg.embed_inputs:
        arrays = {"frames": g.standard_normal((B, SEQ, cfg.d_model))
                  .astype(np.float32),
                  "labels": g.integers(0, cfg.vocab_size, (B, SEQ))
                  .astype(np.int32),
                  "mask": g.random((B, SEQ)) < 0.35}
    else:
        arrays = {"tokens": g.integers(0, cfg.vocab_size, (B, SEQ))
                  .astype(np.int32)}
        if cfg.mrope_sections is not None:
            n_patches, mask, thw = port_model.vision_layout(B, SEQ)
            arrays.update(
                vision_embeds=g.standard_normal((B, n_patches, cfg.d_model))
                .astype(np.float32),
                vision_mask=mask.numpy(), positions_thw=thw.numpy())
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def carried(cfg):
    """The port's ``init_params`` and the same numbers as the reference's
    tree (its leaves are the port's, in the same order)."""
    params = port_tf.init_params(cfg, seed=0, device="cpu")
    return tree_map(lambda t: jnp.asarray(t.numpy()), params), params


def port_step(cfg, params, batch, pack=None):
    """The port's loss, ``moe_aux`` and gradients (None where a leaf takes
    none); ``pack`` sees every tensor saved for the backward."""
    leaves = [p.detach().requires_grad_() for p in flatten(params)]
    if pack is None:
        loss, metrics = port_model.loss_fn(cfg, unflatten(params, leaves),
                                           batch)
    else:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, metrics = port_model.loss_fn(
                cfg, unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), metrics["moe_aux"].detach(), grads


def same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.parametrize("arch,n_layers", CASES)
def test_remat_matches_no_remat_bits_and_reference(arch, n_layers):
    cfg = config(arch, n_layers)
    ref_params, params = carried(cfg)
    batch_r, batch_t = batches(cfg)
    plain = port_step(dataclasses.replace(cfg, remat=False), params, batch_t)
    for policy in ("default", "nothing"):
        got = port_step(dataclasses.replace(cfg, remat_policy=policy),
                        params, batch_t)
        assert same_bits(got[0], plain[0]), policy
        assert same_bits(got[1], plain[1]), policy
        for name, g, h in zip(leaf_names(params), got[2], plain[2]):
            assert (g is None) == (h is None), name
            assert g is None or same_bits(g, h), (policy, name)

    assert cfg.remat
    # Each graph runs once: compiled without XLA's backend optimisation,
    # which halves the compile and changes no operation's rounding here.
    (loss_r, metrics_r), grads_r = jax.jit(jax.value_and_grad(
        lambda p, b: ref_model.loss_fn(cfg, p, b), has_aux=True)).lower(
            ref_params, batch_r).compile(
                {"xla_backend_optimization_level": 0})(ref_params, batch_r)
    assert [jax.tree_util.keystr(k) for k, _ in
            jax.tree_util.tree_flatten_with_path(grads_r)[0]] \
        == leaf_names(params)
    loss, moe_aux, grads = got
    np.testing.assert_allclose(float(loss), float(loss_r), **TOL)
    np.testing.assert_allclose(float(moe_aux), float(metrics_r["moe_aux"]),
                               **TOL)
    assert (float(moe_aux) > 0) == bool(cfg.n_experts)
    for name, g, r in zip(leaf_names(params), grads, jax.tree.leaves(grads_r)):
        r = np.asarray(r, dtype=np.float32)
        g = np.zeros_like(r) if g is None else g.numpy()
        np.testing.assert_allclose(g, r, atol=1e-4 * np.abs(r).max(),
                                   rtol=1e-4, err_msg=name)


def saved_bytes(cfg, batch):
    """Bytes of the distinct storages saved for the backward of one loss,
    the parameters' storages left out."""
    params = port_tf.init_params(cfg, seed=0, device="cpu")
    mine = {t.untyped_storage().data_ptr() for t in flatten(params)}
    seen = {}

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in mine:
            seen[ptr] = t.untyped_storage().nbytes()
        return t

    port_step(cfg, params, batch, pack)
    return sum(seen.values())


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_saves_one_unit_input_per_repeat(arch):
    """One more repeat of the unit adds its input (B x S x d float32) to
    what the backward keeps under remat, and a whole layer's activations
    (the normed input, projections, scores or gates: many times that)
    without."""
    base = config(arch)
    n_unit = len(base.block_unit)
    depths = (n_unit, 2 * n_unit)
    _, batch = batches(config(arch, depths[0]))
    unit_input = B * SEQ * base.d_model * 4
    rise = {}
    for remat in (True, False):
        got = [saved_bytes(config(arch, d, remat=remat), batch)
               for d in depths]
        rise[remat] = got[1] - got[0]
    assert 0 < rise[True] <= unit_input, rise
    assert rise[False] > 8 * unit_input, rise


@pytest.mark.parametrize("arch,n_layers,regions",
                         [("tinyllama-1.1b", 3, 3),
                          ("recurrentgemma-2b", 5, 1),
                          ("xlstm-125m", 4, 2)])
def test_regions_one_a_unit_and_none_without_grad(arch, n_layers, regions,
                                                  monkeypatch):
    cfg = config(arch, n_layers)
    params = port_tf.init_params(cfg, seed=0, device="cpu")
    _, batch = batches(cfg)
    calls = []

    def counted(fn, *args, **kw):
        calls.append(len(args[1]))
        return checkpoint(fn, *args, **kw)

    monkeypatch.setattr(port_tf, "checkpoint", counted)
    with torch.no_grad():
        logits, _ = port_tf.forward_train(cfg, params, batch)
    assert calls == [] and logits.shape == (B, SEQ, cfg.vocab_size)
    port_step(cfg, params, batch)
    assert calls == [len(cfg.block_unit)] * regions
    port_step(dataclasses.replace(cfg, remat=False), params, batch)
    assert len(calls) == regions
