"""The port's launch layer: step builders, the traced cost and the dry run.

* ``make_train_step`` with one and with two microbatches,
  ``make_prefill_step`` (decoder and encoder) and ``make_serve_step``
  against the JAX package's builders at reduced size in float32, the
  reference's weights carried across.  Tolerances: the metrics at 1e-5
  relative; the gradient-shaped state (AdamW's m, and the step's update
  (new - old) / lr) at 1e-4 of each leaf's largest magnitude, v at 2e-4
  (the gradient bound of ``tests/test_torch_model.py``: summation order
  differs); logits and caches at 1e-5 of the largest (the forward bound).
  The optimizer's eps is 1.0 here, so the update is smooth in the
  gradient (with eps 1e-8 the first step is sign(g) and a near-zero
  gradient may flip).
* On the CPU's 1x1 mesh, the steps on replicated DTensor state give the
  plain steps' bits (they run on the local tensors).
* ``RooflineTerms``' math (``tests/test_launch.py:64-72``) and the
  collective tally.
* A reduced pair traced on a 2x2 fake mesh is an ``ok`` row with
  collectives, the MoE, RG-LRU and xLSTM pairs ROADMAP A13.1-A13.4 logged
  as ``error`` among them, and xLSTM's head splits on a model axis wider
  than its heads; the two-depth extension of the counts ``==`` a trace
  of every layer and microbatch; an op DTensor cannot partition is
  named.  The fake process groups are made per test and destroyed after it
  (``--dist loadfile`` runs other files in the same worker afterwards).
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402

from repro_torch.configs import get  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import dryrun, hlo, mesh as port_mesh  # noqa: E402
from repro_torch.launch import steps as port_steps  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw as port_adamw  # noqa: E402
from repro_torch.tree import flatten, leaf_names, unflatten  # noqa: E402

METRIC_RTOL = 1e-5
GRAD_TOL = 1e-4
FWD_TOL = 1e-5


@pytest.fixture
def release_group():
    """Destroy the process group a test's mesh made."""
    yield
    port_mesh.release()


def config(arch="tinyllama-1.1b", **kw):
    return dataclasses.replace(REGISTRY[arch].reduced(), dtype="float32",
                               **kw)


def carried(cfg, seed=0):
    params, _ = ref_tf.init_params(cfg, jax.random.PRNGKey(seed))
    return params, params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


def close_leafwise(port, ref, tol):
    """Each leaf within ``tol`` of its largest magnitude."""
    for name, a, b in zip(leaf_names(port), flatten(port),
                          jax.tree.leaves(ref)):
        a = a.detach().float().numpy()
        b = np.asarray(b, dtype=np.float32)
        scale = max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# Step builders against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    cfg = config(microbatches=microbatches)
    p_r, p_t = carried(cfg)
    opt_r = ref_adamw.AdamWConfig(lr=1e-2, eps=1.0)
    opt_t = port_adamw.AdamWConfig(lr=1e-2, eps=1.0)
    s_r, s_t = ref_adamw.adamw_init(p_r, opt_r), \
        port_adamw.adamw_init(p_t, opt_t)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)
    new_r, o_r, m_r = jax.jit(ref_steps.make_train_step(cfg, opt_r))(
        p_r, s_r, {"tokens": jnp.asarray(toks)})
    new_t, o_t, m_t = port_steps.make_train_step(cfg, opt_t)(
        p_t, s_t, {"tokens": torch.from_numpy(toks)})
    assert sorted(m_t) == sorted(m_r)
    for k in m_r:
        np.testing.assert_allclose(float(m_t[k]), float(m_r[k]),
                                   rtol=METRIC_RTOL, err_msg=k)
    close_leafwise(o_t["m"], o_r["m"], GRAD_TOL)
    close_leafwise(o_t["v"], o_r["v"], 2 * GRAD_TOL)
    assert int(o_t["step"]) == int(o_r["step"]) == 1
    upd_t = [(a - b) / opt_t.lr for a, b in zip(flatten(new_t), flatten(p_t))]
    upd_r = jax.tree.map(lambda a, b: (a - b) / opt_r.lr, new_r, p_r)
    close_leafwise(unflatten(p_t, upd_t), upd_r, GRAD_TOL)


def test_microbatches_split_rows_like_reference():
    """Microbatch i holds rows [i B/m, (i+1) B/m), as the reference's
    reshape((m, B // m) + ...) gives them."""
    x = torch.arange(24).reshape(6, 4)
    parts = [port_steps._microbatch(x, i, 3) for i in range(3)]
    ref = np.asarray(jnp.arange(24).reshape(6, 4).reshape(3, 2, 4))
    for i in range(3):
        assert np.array_equal(parts[i].numpy(), ref[i])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "recurrentgemma-2b",
                                  "hubert-xlarge"])
def test_prefill_step_matches_reference(arch):
    cfg = config(arch)
    p_r, p_t = carried(cfg)
    shape = InputShape("p", 32, 2, "prefill")
    rng = np.random.default_rng(1)
    if cfg.embed_inputs:
        batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                        (2, 32)).astype(np.int32)}
    else:
        batch = {"frames": rng.standard_normal(
            (2, 32, cfg.d_model)).astype(np.float32)}
    out_r = ref_steps.make_prefill_step(cfg, shape)(
        p_r, {k: jnp.asarray(v) for k, v in batch.items()})
    out_t = port_steps.make_prefill_step(cfg, shape)(
        p_t, {k: torch.from_numpy(v) for k, v in batch.items()})
    if not cfg.causal:
        close_leafwise(out_t, out_r, FWD_TOL)
        return
    close_leafwise(out_t[0], out_r[0], FWD_TOL)
    ref_cache = jax.tree.map(np.asarray, out_r[1])
    for name, a, b in zip(leaf_names(out_t[1]), flatten(out_t[1]),
                          jax.tree.leaves(ref_cache)):
        if a.dtype == torch.int32:
            assert np.array_equal(a.numpy(), b), name
        else:
            close_leafwise(a, b, FWD_TOL)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "xlstm-125m"])
def test_serve_step_matches_reference(arch):
    cfg = config(arch)
    p_r, p_t = carried(cfg)
    cache_r = ref_tf.init_cache(cfg, 2, 16)
    cache_t = params_from_numpy(jax.tree.map(np.asarray, cache_r), "cpu")
    step_r = jax.jit(ref_steps.make_serve_step(cfg))
    step_t = port_steps.make_serve_step(cfg)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 2))
    for tok in toks.astype(np.int32):
        lr, cache_r = step_r(p_r, jnp.asarray(tok), cache_r)
        lt, cache_t = step_t(p_t, torch.from_numpy(tok), cache_t)
        close_leafwise(lt, lr, FWD_TOL)
    ref_cache = jax.tree.map(np.asarray, cache_r)
    for name, a, b in zip(leaf_names(cache_t), flatten(cache_t),
                          jax.tree.leaves(ref_cache)):
        if a.dtype == torch.int32:
            assert np.array_equal(a.numpy(), b), name
        else:
            close_leafwise(a, b, FWD_TOL)


def test_steps_on_a_one_device_mesh_give_the_plain_bits(release_group):
    """Replicated DTensor state on the CPU's 1x1 mesh: the steps run on
    the local tensors, so every result is the plain step's, bit for
    bit."""
    from torch.distributed.tensor import DTensor

    cfg = dataclasses.replace(get("tinyllama-1.1b").reduced(),
                              dtype="float32", microbatches=2)
    mesh = port_mesh.make_cpu_mesh()
    assert port_mesh.mesh_name(mesh) == "1x1"
    from repro_torch.models.transformer import init_params
    params = init_params(cfg, seed=3, device="cpu")
    opt_cfg = port_adamw.AdamWConfig()
    opt = port_adamw.adamw_init(params, opt_cfg)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32))
    p_abs, axes, o_abs = port_steps.abstract_state(cfg, opt_cfg)
    pspecs, ospecs = port_steps.state_specs(cfg, mesh, p_abs, axes, o_abs)
    d_params = port_steps.shard_tree(params, pspecs, mesh)
    d_opt = port_steps.shard_tree(opt, ospecs, mesh)
    assert all(isinstance(t, DTensor) for t in flatten(d_params))
    bspec = port_steps.batch_specs(cfg, InputShape("t", 16, 4, "train"),
                                   mesh)["tokens"].spec
    d_batch = port_steps.shard_tree({"tokens": toks}, {"tokens": bspec},
                                    mesh)
    for m in (1, 2):
        step = port_steps.make_train_step(
            dataclasses.replace(cfg, microbatches=m), opt_cfg)
        plain = step(params, opt, {"tokens": toks})
        sharded = step(d_params, d_opt, d_batch)
        for a, b in zip(flatten(sharded), flatten(plain)):
            assert isinstance(a, DTensor)
            assert torch.equal(a.to_local(), b)
    logits, cache = port_steps.make_prefill_step(
        cfg, InputShape("p", 16, 4, "prefill"))(d_params, d_batch)
    ref_logits, ref_cache = port_steps.make_prefill_step(
        cfg, InputShape("p", 16, 4, "prefill"))(params, {"tokens": toks})
    assert torch.equal(logits.to_local(), ref_logits)
    tok = torch.zeros(4, dtype=torch.int32)
    out = port_steps.make_serve_step(cfg)(
        d_params, port_steps.shard_tree(tok, port_steps.shd.P(), mesh), cache)
    ref_out = port_steps.make_serve_step(cfg)(params, tok, ref_cache)
    for a, b in zip(flatten(out), flatten(ref_out)):
        assert torch.equal(a.to_local(), b)


# ---------------------------------------------------------------------------
# Roofline math and the collective tally
# ---------------------------------------------------------------------------

def test_roofline_terms_math():
    t = hlo.RooflineTerms(
        arch="a", shape="s", mesh="m", n_devices=256,
        hlo_flops=197e12, hlo_bytes=819e9, coll_bytes=100e9,
        t_compute=1.0, t_memory=1.0, t_collective=2.0,
        model_flops=197e12 * 128, bytes_per_device=8e9)
    assert t.dominant == "collective"
    assert t.useful_flops_ratio == pytest.approx(0.5)
    assert t.as_row()["dominant"] == "collective"


def test_h100_terms_from_counts():
    class Cost:
        flops, bytes_accessed, peak = 989.4e12, 3.35e12, 1e9
        stats = hlo.CollectiveStats({"all-reduce": 900e9}, 3)

    t = hlo.roofline_terms(Cost(), arch="a", shape="s", mesh_name="m",
                           n_devices=4, model_flops=989.4e12)
    assert (t.t_compute, t.t_memory, t.t_collective) == (1.0, 1.0, 2.0)
    assert t.dominant == "collective" and t.bytes_per_device == 1e9
    assert hlo.H100.hbm_bytes == 80e9


def test_collective_bytes_by_kind():
    stats = hlo.collective_bytes([
        ("all_gather_into_tensor", 100), ("all_reduce", 40),
        ("reduce_scatter_tensor", 8), ("all_to_all_single", 2),
        ("permute_tensor", 1), ("wait_tensor", 999), ("all_reduce", 2)])
    assert stats.by_kind == {"all-gather": 100, "all-reduce": 42,
                             "reduce-scatter": 8, "all-to-all": 2,
                             "collective-permute": 1}
    assert stats.n_ops == 6 and stats.total == 153


# ---------------------------------------------------------------------------
# Traced pairs on a small fake mesh
# ---------------------------------------------------------------------------

def small_mesh():
    return port_mesh.make_fake_mesh((2, 2), ("data", "model"))


def test_reduced_pair_dry_runs_ok_on_a_2x2_mesh(release_group):
    cfg = get("tinyllama-1.1b").reduced()
    row = dryrun.run_pair(cfg, InputShape("train_small", 64, 8, "train"),
                          small_mesh(), "2x2")
    assert row["status"] == "ok" and row["fits_hbm"]
    assert row["coll_bytes_per_dev"] > 0 and row["n_collectives"] > 0
    assert row["hlo_flops_per_dev"] > 0 and row["hlo_bytes_per_dev"] > 0
    assert 0 < row["memory_analysis"]["args"] < row["bytes_per_device"]
    assert row["dominant"] in ("compute", "memory", "collective")
    json.dumps(row)


def test_flops_are_counted_on_local_shards(release_group):
    """One device's FLOPs of a model sharded 2x2: about a quarter of the
    unsharded trace's (the vocab and batch both split), never the whole."""
    cfg = dataclasses.replace(get("tinyllama-1.1b").reduced(), remat=False)
    shape = InputShape("p", 64, 8, "prefill")
    one = port_steps.lower_step(cfg, shape,
                                port_mesh.make_fake_mesh((1, 1),
                                                         ("data", "model")))
    four = port_steps.lower_step(cfg, shape, small_mesh())
    ratio = four.cost.flops / one.cost.flops
    assert 0.2 < ratio < 0.35, ratio


@pytest.mark.parametrize("kind,seq,batch,m", [("train", 32, 8, 4),
                                              ("prefill", 32, 4, 1),
                                              ("decode", 32, 4, 1)])
def test_depth_extension_equals_full_trace(kind, seq, batch, m,
                                           release_group):
    cfg = dataclasses.replace(get("tinyllama-1.1b").reduced(), n_layers=4,
                              microbatches=m)
    shape = InputShape("x", seq, batch, kind)
    mesh = small_mesh()
    short = port_steps.lower_step(cfg, shape, mesh)
    full = port_steps.lower_step(cfg, shape, mesh, full_depth=True)
    assert short.traced != full.traced
    assert short.cost._fields() == full.cost._fields()


# The pairs ROADMAP A13.1-A13.4 logged as ``error``, at reduced size: the
# MoE's routing, dispatch and combine per shard (A13.1), the per-shard
# log_sigmoid whose backward DTensor has no rule for (A13.2, A13.3).
@pytest.mark.parametrize("arch,kind,seq", [
    ("qwen2-moe-a2.7b", "prefill", 32), ("qwen2-moe-a2.7b", "train", 32),
    ("qwen2-moe-a2.7b", "decode", 32), ("recurrentgemma-2b", "train", 32),
    ("xlstm-125m", "train", 8)])
def test_repaired_pair_dry_runs_ok_on_a_2x2_mesh(arch, kind, seq,
                                                release_group):
    row = dryrun.run_pair(get(arch).reduced(), InputShape("x", seq, 8, kind),
                          small_mesh(), "2x2")
    assert row["status"] == "ok" and row["n_collectives"] > 0
    assert row["hlo_flops_per_dev"] > 0 and row["coll_bytes_per_dev"] > 0


# xlstm-125m's 4 heads split from an up-projection sharded 16 ways at
# full size (A13.3, A13.4): the reduced model's 4 heads on 8 model ranks.
@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_head_split_wider_than_the_heads_dry_runs_ok(kind, release_group):
    cfg = get("xlstm-125m").reduced()
    mesh = port_mesh.make_fake_mesh((1, 8), ("data", "model"))
    assert mesh.size(1) > cfg.n_heads
    row = dryrun.run_pair(cfg, InputShape("x", 8, 8, kind), mesh, "1x8")
    assert row["status"] == "ok" and row["n_collectives"] > 0


def _count_tokens(ids):
    """A function of the test's own on an op DTensor has no rule for."""
    return torch.bincount(ids.reshape(-1))


def test_unpartitionable_op_is_named(release_group):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    ids = distribute_tensor(torch.arange(16).reshape(8, 2) % 5,
                            small_mesh(), (Shard(0), Replicate()))
    with pytest.raises(Exception) as err:
        _count_tokens(ids)
    op, where = dryrun.failing_op(err.value)
    assert op is not None and "bincount" in op
    assert where is None        # no line of the port's models on the way


def test_dryrun_cli_rows(tmp_path, release_group):
    out = tmp_path / "rows.json"
    rc = dryrun.main(["--arch", "tinyllama-1.1b,hubert-xlarge",
                      "--shape", "long_500k", "--mesh", "single",
                      "--out", str(out)])
    rows = json.loads(out.read_text())
    assert rc == 0
    assert [(r["arch"], r["status"]) for r in rows] == [
        ("tinyllama-1.1b", "ok"), ("hubert-xlarge", "skipped")]
    assert rows[0]["mesh"] == "16x16" and rows[0]["fits_hbm"]
    for key in ("bytes_per_device", "t_compute_s", "t_memory_s",
                "t_collective_s", "dominant", "model_flops",
                "useful_flops_ratio", "n_collectives", "compile_s"):
        assert key in rows[0]
