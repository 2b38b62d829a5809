"""The port's checkpoint manager: round trips, gc, cost model, and
cross-restore with the JAX package's manager.

The single-manager tests mirror ``tests/test_ckpt_manager.py`` and
``tests/test_substrates.py:123-190`` on the port's manager (CPU tensors:
the plain quantize/dequantize).  The cross tests write a checkpoint with
one package's manager and restore it with the other's, on the reduced
tinyllama-1.1b train state (params, AdamW moments, step counters) at
float32 and at bfloat16:

* full restores are ``==``;
* both managers write the same files for the same state: every array of
  the full and the delta ``.npz`` (``leaf_i``, ``q_i``, ``s_i``,
  ``raw_i``, ``__names__``, ``__base__``) is ``==``;
* a delta restore agrees with the reference's own restore of the same file
  to 1 float32 ulp (XLA:CPU may contract ``base + q*scale`` into a fused
  multiply-add; eager torch does not).
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import CheckpointManager as RefManager  # noqa: E402
from repro.configs import REGISTRY  # noqa: E402
from repro.models.transformer import init_params as ref_init  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402

from repro_torch.ckpt import CheckpointManager, state_bytes  # noqa: E402
from repro_torch.ckpt.manager import (DELTA_RATIO_PRIOR,  # noqa: E402
                                      is_quantized,
                                      modeled_costs_from_bytes)
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        state_to_numpy)
from repro_torch.configs import get  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.tree import flatten, leaf_names, tree_map  # noqa: E402


def tiny_state(seed=0):
    g = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(g.standard_normal((64, 32)))
                   .to(torch.bfloat16),
                   "b": torch.zeros((32,), dtype=torch.float32)},
        "opt": {"m": torch.from_numpy(g.standard_normal((64, 32)))
                .float()},
        "data_step": torch.tensor(17, dtype=torch.int32),
    }


def drift(state, by=0.01):
    return tree_map(lambda x: x + (by if x.is_floating_point() else 1),
                    state)


def assert_trees_close(a, b, atol=0.0):
    for x, y in zip(flatten(a), flatten(b)):
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(),
                                   atol=atol)


# -- one manager (mirrors of the reference's tests) ---------------------------

def test_full_restore_round_trip_is_exact(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = tiny_state()
    info = mgr.save(7, state)
    assert info.kind == "full" and info.bytes > 0
    step, restored = mgr.restore(like=state)
    assert step == 7
    assert_trees_close(state, restored)          # bit-exact incl. bf16
    assert leaf_names(restored) == leaf_names(state)
    for x, y in zip(flatten(state), flatten(restored)):
        assert x.dtype == y.dtype and x.shape == y.shape


def test_delta_restore_round_trip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = tiny_state()
    mgr.save(1, state)
    info = mgr.save_proactive(2, drift(state))
    assert info.kind == "proactive"
    step, restored = mgr.restore(like=state)
    assert step == 2
    assert_trees_close(drift(state), restored, atol=2e-3)


def test_restore_specific_step_and_gc_drops_orphan_deltas(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = tiny_state()
    mgr.save(1, state)
    mgr.save_proactive(2, state)          # delta on full_1
    mgr.save(3, state)
    mgr.save_proactive(4, state)          # delta on full_3
    assert [s for s, _ in mgr.checkpoints()] == [1, 2, 3, 4]
    mgr.save(5, state)                    # gc: full_1 + its delta_2 go
    assert mgr.checkpoints() == [(3, "full"), (4, "delta"), (5, "full")]
    for step in (3, 4, 5):
        got, restored = mgr.restore(like=state, step=step)
        assert got == step
        assert_trees_close(state, restored, atol=2e-3)
    assert mgr.latest_step() == 5


def test_gc_keeps_last_two(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tiny_state())
    assert [s for s, k in mgr.checkpoints() if k == "full"] == [3, 4]


def test_proactive_without_base_falls_back_to_full(tmp_path):
    info = CheckpointManager(str(tmp_path)).save_proactive(1, tiny_state())
    assert info.kind == "full"


def big_state():
    g = np.random.default_rng(0)
    return {"p": torch.from_numpy(g.standard_normal((4096, 64))).float()}


def test_proactive_payload_smaller(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    full = mgr.save(1, big_state())
    pro = mgr.save_proactive(2, tree_map(lambda x: x * 1.001, big_state()))
    assert pro.bytes < 0.45 * full.bytes  # int8+scales vs fp32: ~4x smaller


def test_modeled_costs_track_measured_delta_ratio(tmp_path):
    mgr = CheckpointManager(str(tmp_path), bandwidth=1e6)
    state = big_state()
    full = mgr.save(1, state)
    assert mgr.measured_delta_ratio is None
    c0, cp0 = mgr.modeled_costs(state)
    assert cp0 == pytest.approx(DELTA_RATIO_PRIOR * c0)
    pro = mgr.save_proactive(2, tree_map(lambda x: x * 1.001, state))
    ratio = mgr.measured_delta_ratio
    assert ratio == pytest.approx(pro.bytes / full.bytes)
    assert abs(ratio - DELTA_RATIO_PRIOR) > 0.005
    c1, cp1 = mgr.modeled_costs(state)
    assert c1 == c0 and cp1 == pytest.approx(ratio * c1)
    _, cp_expl = mgr.modeled_costs(state, delta_ratio=0.5)
    assert cp_expl == pytest.approx(0.5 * c1)
    assert modeled_costs_from_bytes(state_bytes(state), bandwidth=1e6,
                                    delta_ratio=ratio) == (c1, cp1)


def test_modeled_costs(tmp_path):
    mgr = CheckpointManager(str(tmp_path), bandwidth=1e6)
    state = tiny_state()
    c, cp = mgr.modeled_costs(state, n_shards=2)
    assert c == pytest.approx(state_bytes(state) / 2 / 1e6)
    assert cp < c


def test_modeled_costs_from_bytes_shards():
    c1, cp1 = modeled_costs_from_bytes(1e9, bandwidth=2e9)
    c8, cp8 = modeled_costs_from_bytes(1e9, bandwidth=2e9, n_shards=8)
    assert c1 == pytest.approx(0.5)
    assert cp1 == pytest.approx(DELTA_RATIO_PRIOR * 0.5)
    assert c8 == pytest.approx(c1 / 8) and cp8 == pytest.approx(cp1 / 8)


# -- which leaves are quantized -----------------------------------------------

def mixed_state_np():
    g = np.random.default_rng(3)
    return {
        "bf16_big": g.standard_normal(300).astype(np.float32),
        "f32_big": g.standard_normal(256).astype(np.float32),
        "f32_small": g.standard_normal(255).astype(np.float32),
        "f16_big": g.standard_normal(400).astype(np.float16),
        "f64_big": g.standard_normal(300),
        "i32_big": g.integers(0, 9, 300).astype(np.int32),
    }


def test_quantized_leaves_match_reference(tmp_path):
    """The reference quantizes a leaf iff numpy calls its dtype floating and
    it has >= 256 elements; bf16 is not numpy-floating, so it stays raw."""
    arrs = mixed_state_np()
    port = {k: torch.from_numpy(v) for k, v in arrs.items()}
    port["bf16_big"] = port["bf16_big"].to(torch.bfloat16)
    ref = {k: jnp.asarray(v) for k, v in arrs.items()}
    ref["bf16_big"] = ref["bf16_big"].astype(jnp.bfloat16)
    names = leaf_names(port)
    assert names == ["['bf16_big']", "['f16_big']", "['f32_big']",
                     "['f32_small']", "['f64_big']", "['i32_big']"]
    assert [is_quantized(t) for t in flatten(port)] == [
        False, True, True, False, True, False]
    # The same decision, leaf for leaf, as the reference's manager makes.
    for mgr, state, d in ((CheckpointManager, port, "p"),
                          (RefManager, ref, "r")):
        m = mgr(str(tmp_path / d))
        m.save(1, state)
        m.save_proactive(2, state)
    with np.load(tmp_path / "p" / "delta_00000002.npz") as zp, \
            np.load(tmp_path / "r" / "delta_00000002.npz") as zr:
        assert sorted(zp.files) == sorted(zr.files) == sorted(
            ["raw_0", "q_1", "s_1", "q_2", "s_2", "raw_3", "q_4", "s_4",
             "raw_5", "__base__"])


# The families the trainer runs at full width (chip_smoke.py phase 18) and
# the VLM, each with its own leaves: fp32 params (the RG-LRU's lambda and
# gate bias, the MoE router), xLSTM's 48-element gate bias (fp32 but under
# one 256-element block: raw), hubert-xlarge without an embedding.
FAMILIES = ("qwen2-moe-a2.7b", "recurrentgemma-2b", "xlstm-125m",
            "hubert-xlarge", "qwen2-vl-72b")


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_train_states_quantize_like_reference(arch, tmp_path):
    """A family's reduced train state (its config's dtype): both managers'
    proactive saves store the same leaves as q_i / s_i and the same as
    raw_i, by the port's is_quantized."""
    params = init_params(get(arch).reduced(), seed=0, device="cpu")
    port = {"params": params, "opt": adamw_init(params, AdamWConfig()),
            "data_step": torch.tensor(5, dtype=torch.int32)}
    ref = jax.tree.map(
        lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy()), port)
    for mgr, state, d in ((CheckpointManager, port, "p"),
                          (RefManager, ref, "r")):
        m = mgr(str(tmp_path / d))
        m.save(1, state)
        m.save_proactive(2, state)
    want = ["__base__"]
    for i, t in enumerate(flatten(port)):
        want += [f"q_{i}", f"s_{i}"] if is_quantized(t) else [f"raw_{i}"]
    with np.load(tmp_path / "p" / "delta_00000002.npz") as zp, \
            np.load(tmp_path / "r" / "delta_00000002.npz") as zr:
        assert sorted(zp.files) == sorted(zr.files) == sorted(want)
    assert any(k.startswith("q_") for k in want)
    assert any(k.startswith("raw_") and k != "raw_0" for k in want)


# -- cross-restore with the reference -----------------------------------------

def ref_train_state(dtype):
    cfg = dataclasses.replace(REGISTRY["tinyllama-1.1b"].reduced(),
                              dtype=dtype)
    params, _ = ref_init(cfg, jax.random.PRNGKey(0))
    return {"params": params,
            "opt": ref_adamw_init(params, RefAdamWConfig()),
            "data_step": jnp.asarray(5, jnp.int32)}


def to_jax(state, like):
    """A port state as a jax tree shaped like ``like`` (same leaf order)."""
    out = []
    for arr, ref_leaf in zip(flatten(state_to_numpy(state)),
                             jax.tree.leaves(like)):
        a = jnp.asarray(arr)
        out.append(a.view(jnp.bfloat16) if ref_leaf.dtype == jnp.bfloat16
                   else a)
    return jax.tree.unflatten(jax.tree.structure(like), out)


def ref_leaves_f32(tree):
    return [np.asarray(leaf.astype(jnp.float32)) for leaf in
            jax.tree.leaves(tree)]


def within_one_ulp(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    tol = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return bool((np.abs(a - b) <= tol).all())


@pytest.fixture(params=["float32", "bfloat16"])
def states(request):
    """(reference, port) base states and drifted states, identical bits."""
    ref0 = ref_train_state(request.param)
    port0 = params_from_numpy(jax.tree.map(np.asarray, ref0), "cpu")
    g = np.random.default_rng(11)
    port1 = tree_map(
        lambda x: ((x.float() + 0.01 * torch.from_numpy(
            g.standard_normal(tuple(x.shape))).float()).to(x.dtype)
            if x.is_floating_point() else x + 1), port0)
    return ref0, port0, to_jax(port1, ref0), port1


def test_train_state_leaf_names_match_reference(states):
    ref0, port0, _, _ = states
    ref_names = [jax.tree_util.keystr(p) for p, _ in
                 jax.tree_util.tree_flatten_with_path(ref0)[0]]
    assert leaf_names(port0) == ref_names
    assert "['opt']['m']['layers'][0]['attn']['w_q']" in ref_names


def test_both_managers_write_the_same_files(states, tmp_path):
    ref0, port0, ref1, port1 = states
    rm = RefManager(str(tmp_path / "r"))
    rm.save(1, ref0)
    rm.save_proactive(2, ref1)
    pm = CheckpointManager(str(tmp_path / "p"))
    pm.save(1, port0)
    pm.save_proactive(2, port1)
    for name in ("full_00000001.npz", "delta_00000002.npz"):
        with np.load(tmp_path / "p" / name) as zp, \
                np.load(tmp_path / "r" / name) as zr:
            assert sorted(zp.files) == sorted(zr.files)
            for key in zr.files:
                assert zp[key].dtype == zr[key].dtype, (name, key)
                np.testing.assert_array_equal(zp[key], zr[key],
                                              err_msg=f"{name}:{key}")
    with np.load(tmp_path / "p" / "full_00000001.npz") as zp:
        assert json.loads(str(zp["__names__"])) == leaf_names(port0)


def test_reference_checkpoints_restore_in_port(states, tmp_path):
    ref0, port0, ref1, port1 = states
    rm = RefManager(str(tmp_path))
    rm.save(1, ref0)
    rm.save_proactive(2, ref1)
    pm = CheckpointManager(str(tmp_path))
    _, full = pm.restore(like=port0, step=1)
    for x, y in zip(flatten(full), flatten(port0)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    _, delta = pm.restore(like=port0, step=2)
    _, ref_delta = rm.restore(like=ref0, step=2)
    for x, y in zip(flatten(delta), ref_leaves_f32(ref_delta)):
        assert within_one_ulp(x.float().numpy(), y)
    assert_trees_close(port1, delta, atol=2e-3)


def test_port_checkpoints_restore_in_reference(states, tmp_path):
    ref0, port0, ref1, port1 = states
    pm = CheckpointManager(str(tmp_path))
    pm.save(1, port0)
    pm.save_proactive(2, port1)
    rm = RefManager(str(tmp_path))
    _, full = rm.restore(like=ref0, step=1)
    for x, y in zip(jax.tree.leaves(full), jax.tree.leaves(ref0)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    _, delta = rm.restore(like=ref0, step=2)
    _, port_delta = pm.restore(like=port0, step=2)
    for x, y in zip(flatten(port_delta), ref_leaves_f32(delta)):
        assert within_one_ulp(x.float().numpy(), y)
