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
* Every other family raises ``NotImplementedError`` naming its ROADMAP
  item when the port is asked to build it.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models import transformer as port_tf  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCHS = sorted(ref_configs.REGISTRY) + sorted(ref_configs.EXTRAS)
DENSE = ("llama3-405b", "internlm2-20b", "gemma2-9b")
# The families the port's decoder does not run yet, by ROADMAP item.
UNPORTED = {"qwen3-moe-235b-a22b": "10.2", "qwen2-moe-a2.7b": "10.2",
            "mixtral-8x7b": "10.2", "recurrentgemma-2b": "10.3",
            "xlstm-125m": "10.4", "qwen2-vl-72b": "10.5",
            "hubert-xlarge": "10.6"}


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
    np.testing.assert_allclose(_f32(logits_t), _f32(logits_r), atol=1e-5,
                               rtol=1e-5)
    loss_r, _ = ref_model.loss_fn(cfg, ref_params,
                                  {"tokens": jnp.asarray(toks)})
    loss_t, _ = port_model.loss_fn(port_cfg, params,
                                   {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(loss_t), float(loss_r), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("arch", sorted(UNPORTED))
def test_unported_family_raises_naming_its_item(arch):
    with pytest.raises(NotImplementedError, match=UNPORTED[arch]):
        port_tf.init_params(configs.get(arch).reduced(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_tf.check_supported(configs.get(arch))
