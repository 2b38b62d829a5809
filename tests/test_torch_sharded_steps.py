"""The sharded train step with real collectives, against the unsharded one.

A ``gloo`` group of 4 processes on the CPU hosts a 2x2 ``("data",
"model")`` ``DeviceMesh``.  Each process builds the reduced float32
train state of qwen2-moe-a2.7b, recurrentgemma-2b and xlstm-125m from the
same seed, runs ``launch/steps.py::make_train_step`` once on the plain
tensors and once on the state sharded by ``state_specs`` (the batch by
``batch_specs``, the gradients pinned to the params' placements), and
rank 0 compares the two.  The fake process group of the dry run only
traces; here every all-gather, reduce-scatter and all-reduce moves real
numbers, so the sharding rules the model code gives DTensor (the MoE's
per-shard routing, dispatch, expert products and combine, the per-shard
``log_sigmoid``, the head splits of ``split_dim`` / ``merge_dims``)
compute the right step, not only a step that traces.

Tolerances are those of ``tests/test_torch_launch.py``: the loss within
1e-5 relative; AdamW's m and the update (new - old) / lr within 1e-4 of
each leaf's largest magnitude, v within 2e-4 (summation order differs
between the sharded and the plain step).  AdamW's eps is 1.0, so the
update is smooth in the gradient.
"""

import dataclasses
import json
import multiprocessing
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ARCHS = ("qwen2-moe-a2.7b", "recurrentgemma-2b", "xlstm-125m")
WORLD = 4
SEQ, BATCH = 16, 8
METRIC_RTOL = 1e-5
GRAD_TOL = 1e-4
JOIN_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _leaf_errors(got, want) -> dict:
    """Per leaf: (largest |got - want|, largest |want|)."""
    from repro_torch.tree import flatten, leaf_names
    return {name: (float((a - b).abs().max()), float(b.abs().max()))
            for name, a, b in zip(leaf_names(want), flatten(got),
                                  flatten(want))}


def _worker(rank: int, port: int, out_path: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import steps
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.parallel import sharding as shd
    from repro_torch.tree import flatten, unflatten

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        opt_cfg = AdamWConfig(lr=1e-2, eps=1.0)
        result = {}
        for arch in ARCHS:
            cfg = dataclasses.replace(get(arch).reduced(), dtype="float32")
            params = init_params(cfg, seed=0, device="cpu")
            opt = adamw_init(params, opt_cfg)
            toks = torch.from_numpy(np.random.default_rng(0).integers(
                0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32))
            plain = steps.make_train_step(cfg, opt_cfg)(
                params, opt, {"tokens": toks})

            p_abs, axes, o_abs = steps.abstract_state(cfg, opt_cfg)
            pspecs, ospecs = steps.state_specs(cfg, mesh, p_abs, axes, o_abs)
            bspec = steps.batch_specs(cfg, InputShape("t", SEQ, BATCH,
                                                      "train"),
                                      mesh)["tokens"].spec
            d_state = (steps.shard_tree(params, pspecs, mesh),
                       steps.shard_tree(opt, ospecs, mesh),
                       steps.shard_tree({"tokens": toks},
                                        {"tokens": bspec}, mesh))
            with implicit_replication(), \
                    shd.use_rules(shd.DEFAULT_RULES, mesh):
                out = steps.make_train_step(cfg, opt_cfg,
                                            grad_specs=pspecs)(*d_state)
            full = unflatten(out, [t.full_tensor() if shd.is_dtensor(t)
                                   else t for t in flatten(out)])
            new_p, new_o, metrics = full
            pl_p, pl_o, pl_m = plain
            lr = opt_cfg.lr

            def update(new):
                return unflatten(params, [(a - b) / lr for a, b in
                                          zip(flatten(new), flatten(params))])

            result[arch] = {
                "loss": (float(metrics["loss"]), float(pl_m["loss"])),
                "step": (int(new_o["step"]), int(pl_o["step"])),
                "m": _leaf_errors(new_o["m"], pl_o["m"]),
                "v": _leaf_errors(new_o["v"], pl_o["v"]),
                "update": _leaf_errors(update(new_p), update(pl_p)),
                "sharded_leaves": sum(
                    any(not p.is_replicate() for p in t.placements)
                    for t in flatten(d_state[0])),
            }
        if rank == 0:
            with open(out_path, "w") as fh:
                json.dump(result, fh)
    finally:
        dist.destroy_process_group()


def test_sharded_train_step_matches_unsharded(tmp_path):
    out_path = str(tmp_path / "result.json")
    port = _free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, port, out_path))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
        alive = [p.pid for p in procs if p.is_alive()]
        assert not alive, f"workers {alive} still running after {JOIN_S} s"
        assert [p.exitcode for p in procs] == [0] * WORLD
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    with open(out_path) as fh:
        result = json.load(fh)
    assert sorted(result) == sorted(ARCHS)
    for arch, r in result.items():
        assert r["sharded_leaves"] > 0, arch
        got, want = r["loss"]
        assert np.isfinite(got), arch
        np.testing.assert_allclose(got, want, rtol=METRIC_RTOL,
                                   err_msg=f"{arch} loss")
        assert r["step"] == [1, 1], arch
        for tree, tol in (("m", GRAD_TOL), ("v", 2 * GRAD_TOL),
                          ("update", GRAD_TOL)):
            for name, (err, scale) in r[tree].items():
                assert err <= tol * max(scale, 1e-30), \
                    f"{arch} {tree}{name}: {err} > {tol} x {scale}"
