"""The port's model zoo against the JAX package's.

* ``dataclasses.asdict`` of every config in ``REGISTRY`` and ``EXTRAS``,
  of its ``reduced()`` and of its ``for_shape()`` variants, and its
  parameter counts, ``==`` the reference's; ``get``, ``pairs`` and
  ``skip_reason`` give the reference's answers.
* The dense configs the port's decoder runs beyond tinyllama and
  llama3.2-1b (``llama3-405b``, ``internlm2-20b``, ``gemma2-9b``: global
  and sliding-window blocks, tied and untied heads) give the reference's
  ``forward_train`` logits and loss at their ``reduced()`` size in float32,
  weights carried across, at the atol/rtol 1e-5 that
  ``tests/test_torch_model.py`` holds tinyllama to; the sequence is longer
  than gemma2's reduced window, so its "local" blocks cut attention.
* The MoE, RG-LRU hybrid and xLSTM configs (``qwen3-moe-235b-a22b``,
  ``qwen2-moe-a2.7b``, ``mixtral-8x7b``, ``recurrentgemma-2b``,
  ``xlstm-125m``) do the same at the same tolerance.
* The M-RoPE VLM and the encoder-only audio config (``qwen2-vl-72b``,
  ``hubert-xlarge``) pass ``check_supported`` and do the same on the
  reference's ``make_batch`` (vision patches and (t, h, w) positions;
  frames, labels and a mask for the masked-prediction loss).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.configs.base import InputShape  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models import transformer as port_tf  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCHS = sorted(ref_configs.REGISTRY) + sorted(ref_configs.EXTRAS)
DENSE = ("llama3-405b", "internlm2-20b", "gemma2-9b")
FAMILIES = ("qwen3-moe-235b-a22b", "qwen2-moe-a2.7b", "mixtral-8x7b",
            "recurrentgemma-2b", "xlstm-125m")
# The last two families ported (ROADMAP 10.5 M-RoPE, 10.6 encoder-only
# inputs).
MODALITIES = ("hubert-xlarge", "qwen2-vl-72b")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    port, ref = configs.get(arch), ref_configs.get(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) \
        == dataclasses.asdict(ref.reduced())
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert port.reduced().param_count() == ref.reduced().param_count()
    assert (port.blocks, port.q_per_kv) == (ref.blocks, ref.q_per_kv)
    for name, shape in configs.SHAPES.items():
        assert dataclasses.asdict(port.for_shape(shape)) == \
            dataclasses.asdict(ref.for_shape(ref_configs.SHAPES[name]))


def test_registry_surface_equals_reference():
    assert list(configs.REGISTRY) == list(ref_configs.REGISTRY)
    assert list(configs.EXTRAS) == list(ref_configs.EXTRAS)
    assert sorted(configs.__all__) == sorted(ref_configs.__all__)
    port = [(c.name, s.name, r)
            for c, s, r in configs.pairs(include_skipped=True)]
    ref = [(c.name, s.name, r)
           for c, s, r in ref_configs.pairs(include_skipped=True)]
    assert port == ref and any(r is not None for _, _, r in port)
    assert [(c.name, s.name) for c, s, _ in configs.pairs()] \
        == [(c.name, s.name) for c, s, _ in ref_configs.pairs()]
    for name in ("no-such-model", "llama3-405b-smoke", ""):
        with pytest.raises(KeyError, match="unknown arch"):
            configs.get(name)
        with pytest.raises(KeyError, match="unknown arch"):
            ref_configs.get(name)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_forward_matches_reference(arch):
    _forward_matches_reference(arch)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_config_forward_matches_reference(arch):
    """As the dense configs, but the logits at 1e-5 of the largest: the
    RG-LRU and xLSTM recurrences carry 128 sequential float32 steps, which
    the two frameworks round in other orders (1.5-1.8e-5 apart at logits
    up to about 5)."""
    _forward_matches_reference(arch, scaled=True)


def _forward_matches_reference(arch, scaled=False):
    cfg = dataclasses.replace(ref_configs.get(arch).reduced(),
                              dtype="float32")
    port_cfg = dataclasses.replace(configs.get(arch).reduced(),
                                   dtype="float32")
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(cfg)
    port_tf.check_supported(port_cfg)
    ref_params, _ = ref_tf.init_params(cfg, jax.random.PRNGKey(1))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    seq = 2 * port_cfg.attn_window      # past the reduced window of 64
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, seq)).astype(np.int32)
    logits_r, _ = ref_tf.forward_train(cfg, ref_params,
                                       {"tokens": jnp.asarray(toks)})
    logits_t, _ = port_tf.forward_train(port_cfg, params,
                                        {"tokens": torch.from_numpy(toks)})
    assert logits_t.shape == (2, seq, cfg.vocab_size)
    ref = _f32(logits_r)
    np.testing.assert_allclose(
        _f32(logits_t), ref, rtol=1e-5,
        atol=1e-5 * (float(np.abs(ref).max()) if scaled else 1.0))
    loss_r, _ = ref_model.loss_fn(cfg, ref_params,
                                  {"tokens": jnp.asarray(toks)})
    loss_t, _ = port_model.loss_fn(port_cfg, params,
                                   {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(loss_t), float(loss_r), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("arch", MODALITIES)
def test_modality_config_forward_matches_reference(arch):
    """ROADMAP items 10.5 and 10.6 are ported: the full config passes
    ``check_supported``, and the reduced one's forward and loss on the
    reference's ``make_batch`` (cast to numpy and carried across) agree
    at 1e-5."""
    cfg = dataclasses.replace(configs.get(arch).reduced(), dtype="float32")
    port_tf.check_supported(configs.get(arch))
    ref_params, _ = ref_tf.init_params(cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    batch_r = ref_model.make_batch(cfg, InputShape("t", 32, 2, "train"),
                                   jax.random.PRNGKey(1))
    batch_t = {k: torch.from_numpy(np.array(v)) for k, v in batch_r.items()}
    logits_r, _ = ref_tf.forward_train(cfg, ref_params, batch_r)
    logits_t, _ = port_tf.forward_train(cfg, params, batch_t)
    np.testing.assert_allclose(_f32(logits_t), _f32(logits_r), rtol=1e-5,
                               atol=1e-5)
    loss_r, _ = ref_model.loss_fn(cfg, ref_params, batch_r)
    loss_t, _ = port_model.loss_fn(cfg, params, batch_t)
    np.testing.assert_allclose(float(loss_t), float(loss_r), atol=1e-5,
                               rtol=1e-5)
