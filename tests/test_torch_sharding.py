"""The port's distribution layer against the JAX package's.

* ``logical_to_spec`` ``==`` the reference's over a grid of logical axes,
  shapes, rules and mesh extents (``tests/test_substrates.py:194-226``'s
  cases among them), compared as tuples of mesh-axis entries.
* ``param_axes`` and ``cache_axes`` ``==`` the reference's axes trees leaf
  by leaf (by ``keystr`` name) for every ``REGISTRY`` arch at full size;
  the spec trees of the params ``==`` the reference's ``spec_tree`` on
  ``FakeMesh(data=16, model=16)`` and ``FakeMesh(pod=2, data=16,
  model=16)``, and so do the caches of ``tests/test_launch.py:93-113``'s
  three decode cases under ``DECODE_RULES``.
* One device's bytes of params and AdamW state, from the port's specs,
  ``==`` the same sum from the reference's specs.
* ``_batch_shapes`` and ``input_specs`` ``==`` the reference's for every
  (arch x shape) pair: shapes exact, dtypes by name.
* Placements: a dim sharded by ``("pod", "data")`` is ``Shard(d)`` on both
  mesh dims; ``constrain`` returns its argument itself outside a mesh.

Every comparison here is exact: specs, names, shapes and byte counts are
integers and strings.  Nothing here makes a process group.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import REGISTRY, SHAPES, pairs  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.parallel import sharding as ref_shd  # noqa: E402

from repro_torch.configs import get  # noqa: E402
from repro_torch.launch import steps as port_steps  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models import transformer as port_tf  # noqa: E402
from repro_torch.parallel import sharding as port_shd  # noqa: E402
from repro_torch.tree import flatten, is_axes, leaf_names  # noqa: E402


class FakeMesh:
    """Minimal stand-in exposing .shape (no devices, no process group)."""

    def __init__(self, **shape):
        self.shape = shape


MESHES = {"16x16": dict(data=16, model=16),
          "2x16x16": dict(pod=2, data=16, model=16)}
RULES = {"default": "DEFAULT_RULES", "decode": "DECODE_RULES",
         "seq_parallel": "SEQ_PARALLEL_RULES"}


def spec_key(spec):
    """A spec as a plain tuple of entries (tuples for joint axes)."""
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in spec)


def ref_named(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {jax.tree_util.keystr(p): v for p, v in flat}


def port_named(tree, is_leaf=None):
    return dict(zip(leaf_names(tree, is_leaf), flatten(tree, is_leaf)))


def ref_is_axes(x):
    return isinstance(x, tuple) and len(x) > 0 and all(
        isinstance(e, (str, type(None))) for e in x)


def ref_is_spec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


# ---------------------------------------------------------------------------
# logical_to_spec
# ---------------------------------------------------------------------------

SUBSTRATE_CASES = [
    (("embed", "mlp"), (64, 128), dict(data=4, model=8), "default"),
    (("embed", "mlp"), (62, 128), dict(data=4, model=8), "default"),
    (("mlp", "heads"), (64, 64), dict(data=4, model=8), "default"),
    (("batch", "seq"), (16, 128), dict(pod=2, data=4, model=8), "default"),
    (("batch", "seq"), (4, 128), dict(pod=2, data=4, model=8), "default"),
    (("batch", "seq", "kv_heads", None), (16, 1024, 2, 64),
     dict(data=4, model=8), "decode"),
]

AXES = [("batch", "seq"), ("batch", "seq", "embed"), ("embed", "vocab"),
        ("vocab", "embed"), ("layers", "embed", "heads"),
        ("layers", "experts", "embed", "mlp"), ("batch", "heads"),
        ("batch", "seq", "kv_heads", None), ("lru", "lru"),
        ("batch", None, "vocab"), (None, "heads", None, None), ("conv", "lru"),
        ("batch", "experts", None, None), ("batch",), ("capacity", "embed")]
SIZES = [1, 2, 3, 4, 8, 16, 32, 48, 60, 64, 128, 256]


def grid_cases():
    rng = np.random.default_rng(0)
    cases = []
    for mesh in (dict(data=16, model=16), dict(pod=2, data=16, model=16),
                 dict(data=4, model=8), dict(data=1, model=1)):
        for axes in AXES:
            for rules in RULES:
                for _ in range(3):
                    shape = tuple(int(rng.choice(SIZES)) for _ in axes)
                    cases.append((axes, shape, mesh, rules))
    return cases


@pytest.mark.parametrize("axes,shape,mesh,rules", SUBSTRATE_CASES)
def test_logical_to_spec_matches_reference_cases(axes, shape, mesh, rules):
    ref = ref_shd.logical_to_spec(axes, shape, FakeMesh(**mesh),
                                  getattr(ref_shd, RULES[rules]))
    port = port_shd.logical_to_spec(axes, shape, FakeMesh(**mesh),
                                    getattr(port_shd, RULES[rules]))
    assert spec_key(port) == spec_key(ref)


def test_logical_to_spec_matches_reference_grid():
    cases = grid_cases()
    assert len(cases) == 4 * len(AXES) * len(RULES) * 3
    for axes, shape, mesh, rules in cases:
        ref = ref_shd.logical_to_spec(axes, shape, FakeMesh(**mesh),
                                      getattr(ref_shd, RULES[rules]))
        port = port_shd.logical_to_spec(axes, shape, FakeMesh(**mesh),
                                        getattr(port_shd, RULES[rules]))
        assert spec_key(port) == spec_key(ref), (axes, shape, mesh, rules)


def test_logical_to_spec_rejects_rank_mismatch():
    with pytest.raises(ValueError, match="do not match"):
        port_shd.logical_to_spec(("embed",), (4, 4), FakeMesh(data=2))


def test_rules_match_reference():
    for name in RULES.values():
        assert getattr(port_shd, name).rules == getattr(ref_shd, name).rules
    assert port_shd.DEFAULT_RULES.replace(foo="data").mesh_axis("foo") \
        == "data"


# ---------------------------------------------------------------------------
# Axes trees and spec trees at full size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_param_axes_match_reference(arch):
    _, ref_axes, _ = ref_steps.abstract_state(REGISTRY[arch])
    port_axes = port_tf.param_axes(get(arch))
    assert port_named(port_axes, is_axes) == ref_named(ref_axes, ref_is_axes)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_param_specs_and_state_bytes_match_reference(arch, mesh):
    cfg_r = REGISTRY[arch]
    cfg_p = get(arch)
    opt_r = ref_steps.AdamWConfig(moment_dtype=cfg_r.opt_dtype)
    p_abs, ref_axes, o_abs = ref_steps.abstract_state(cfg_r, opt_r)
    fm = FakeMesh(**MESHES[mesh])
    ref_specs = ref_named(ref_shd.spec_tree(ref_axes, p_abs, fm),
                          ref_is_spec)

    opt_p = port_steps.AdamWConfig(moment_dtype=cfg_p.opt_dtype)
    params, axes, opt = port_steps.abstract_state(cfg_p, opt_p)
    pspecs, ospecs = port_steps.state_specs(cfg_p, fm, params, axes, opt)
    port_specs = port_named(pspecs, port_shd.is_spec)
    assert {k: spec_key(v) for k, v in port_specs.items()} \
        == {k: spec_key(v) for k, v in ref_specs.items()}

    # Shapes and dtypes of the meta params == the reference's abstract
    # params; then one device's bytes of params + moments.
    ref_p = ref_named(p_abs)
    port_p = port_named(params)
    assert {k: (tuple(v.shape), dtype_name(v.dtype))
            for k, v in port_p.items()} \
        == {k: (tuple(v.shape), dtype_name(np.dtype(v.dtype)))
            for k, v in ref_p.items()}
    assert all(t.device.type == "meta" for t in port_p.values())

    def ref_local(shape, spec):
        out = list(shape)
        for d, e in enumerate(spec):
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None:
                    out[d] //= MESHES[mesh][a]
        return out

    ref_bytes = 0
    for name, leaf in ref_named(p_abs).items():
        n = int(np.prod(ref_local(leaf.shape, ref_specs[name])))
        ref_bytes += n * leaf.dtype.itemsize
    for name, leaf in ref_named(o_abs["m"]).items():
        n = int(np.prod(ref_local(leaf.shape, ref_specs[name])))
        ref_bytes += 2 * n * leaf.dtype.itemsize
    port_bytes = 0
    for tree, specs in ((params, pspecs), (opt["m"], ospecs["m"]),
                        (opt["v"], ospecs["v"])):
        for t, s in zip(flatten(tree), flatten(specs, port_shd.is_spec)):
            n = int(np.prod(port_shd.local_shape(s, tuple(t.shape), fm)))
            port_bytes += n * t.element_size()
    assert port_bytes == ref_bytes
    assert spec_key(ospecs["step"]) == ()


@pytest.mark.parametrize("arch,shape_name", [
    ("llama3-405b", "decode_32k"),
    ("recurrentgemma-2b", "long_500k"),
    ("xlstm-125m", "decode_32k"),
])
def test_cache_axes_and_specs_match_reference(arch, shape_name):
    shape = SHAPES[shape_name]
    cfg_r = REGISTRY[arch].for_shape(shape)
    cfg_p = get(arch).for_shape(shape)
    assert port_named(port_tf.cache_axes(cfg_p), is_axes) \
        == ref_named(ref_tf.cache_axes(cfg_r), ref_is_axes)
    ref_cache = ref_steps.abstract_cache(cfg_r, shape.global_batch,
                                         shape.seq_len)
    for mesh in MESHES.values():
        fm = FakeMesh(**mesh)
        ref_specs = ref_named(ref_shd.spec_tree(
            ref_tf.cache_axes(cfg_r), ref_cache, fm, ref_shd.DECODE_RULES),
            ref_is_spec)
        cache, specs = port_steps.cache_specs(cfg_p, shape, fm)
        assert {k: spec_key(v) for k, v in
                port_named(specs, port_shd.is_spec).items()} \
            == {k: spec_key(v) for k, v in ref_specs.items()}
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in port_named(cache).items()} \
            == {k: (tuple(v.shape), str(v.dtype))
                for k, v in ref_named(ref_cache).items()}


# ---------------------------------------------------------------------------
# Batch shapes and input specs
# ---------------------------------------------------------------------------

def dtype_name(dt):
    name = str(dt).split(".")[-1]
    return {"bool_": "bool"}.get(name, name)


@pytest.mark.parametrize("arch,shape_name",
                         [(c.name, s.name) for c, s, _ in pairs()])
def test_batch_shapes_and_input_specs_match_reference(arch, shape_name):
    shape = SHAPES[shape_name]
    cfg_r, cfg_p = REGISTRY[arch], get(arch)
    if shape.kind != "decode":
        ref = ref_model._batch_shapes(cfg_r, shape)
        port = port_model._batch_shapes(cfg_p, shape)
        assert {k: (s, dtype_name(np.dtype(d))) for k, (s, d) in ref.items()} \
            == {k: (s, dtype_name(d)) for k, (s, d) in port.items()}
    ref_in = ref_named(ref_model.input_specs(cfg_r, shape))
    port_in = port_named(port_model.input_specs(cfg_p, shape))
    assert {k: (tuple(v.shape), dtype_name(np.dtype(v.dtype)))
            for k, v in ref_in.items()} \
        == {k: (tuple(v.shape), dtype_name(v.dtype))
            for k, v in port_in.items()}
    assert all(v.device.type == "meta" for v in port_in.values())


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "hubert-xlarge",
                                  "llama3-405b"])
def test_batch_specs_match_reference(arch, mesh):
    fm = FakeMesh(**MESHES[mesh])
    shape = SHAPES["train_4k"]

    ref = {}
    for name, (shp, _) in ref_model._batch_shapes(REGISTRY[arch],
                                                  shape).items():
        if name == "positions_thw":
            axes = ("batch", "seq", None)
        elif name == "vision_embeds":
            axes = ("batch", None, None)
        else:
            axes = {2: ("batch", "seq"), 3: ("batch", "seq", None)}[len(shp)]
        ref[name] = spec_key(ref_shd.logical_to_spec(axes, shp, fm))
    port = port_steps.batch_specs(get(arch), shape, fm)
    assert {k: spec_key(v.spec) for k, v in port.items()} == ref


# ---------------------------------------------------------------------------
# Placements and constrain
# ---------------------------------------------------------------------------

def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    fm = FakeMesh(pod=2, data=16, model=16)
    spec = port_shd.logical_to_spec(("batch", "seq", "heads"),
                                    (64, 128, 32), fm)
    assert spec_key(spec) == (("pod", "data"), None, "model")
    assert port_shd.placements(spec, fm) == (Shard(0), Shard(0), Shard(2))
    assert port_shd.placements(port_shd.P(), fm) == (Replicate(),) * 3
    assert port_shd.local_shape(spec, (64, 128, 32), fm) == (2, 128, 2)
    with pytest.raises(ValueError, match="mesh's order"):
        port_shd.placements(port_shd.P(("data", "pod")), fm)


def test_constrain_is_identity_outside_a_mesh():
    x = torch.randn(4, 8)
    assert port_shd.constrain(x, ("batch", "embed")) is x
    with port_shd.use_rules(port_shd.DECODE_RULES):
        assert port_shd.constrain(x, ("batch", "seq")) is x
    with port_shd.use_rules(port_shd.DEFAULT_RULES,
                            FakeMesh(data=2, model=2)):
        assert port_shd.constrain(x, ("batch", "embed")) is x  # not a DTensor
    assert not port_shd.is_dtensor(x)


def test_meta_device_is_explicit_only():
    from repro_torch import resolve_device

    assert resolve_device("meta").type == "meta"
    cfg = get("tinyllama-1.1b")
    params = port_tf.init_params(cfg, device="meta")
    assert all(t.device.type == "meta" for t in flatten(params))
    cache = port_tf.init_cache(cfg, 2, 16, device="meta")
    assert all(t.device.type == "meta" for t in flatten(cache))
