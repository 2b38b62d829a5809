"""Multi-pod dry run: trace every (arch x shape x mesh) step on fake meshes.

The port of ``repro/launch/dryrun.py``.  It shows the distribution config
is coherent without the hardware: a fake process group of 256 or 512
ranks hosts the production meshes (16x16 single-pod, 2x16x16 multi-pod),
and every pair's step must trace under its sharding specs on DTensors
over fake local shards (``launch/steps.py::lower_step``).  The trace
gives one device's peak live bytes (does it fit the H100's 80 GB?) and
its FLOPs, bytes and collective bytes, the three roofline terms of
``launch/hlo.py``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out dryrun_torch.json --jobs 6

``--jobs N`` traces N pairs at a time, each worker process with its own
fake process group (a group's world size is fixed when it is made).  A
pair DTensor cannot partition (an op with no sharding rule, an in-place
op on a plain tensor) becomes an ``error`` row that names the op and the
model line; the command then exits 1, as the reference's does.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import time
import traceback

from repro_torch.configs import REGISTRY, SHAPES, get, skip_reason
from repro_torch.launch import hlo

__all__ = ["failing_op", "main", "model_flops", "run_pair"]

MESHES = {"16x16": False, "2x16x16": True}
_KIND_ORDER = {"train": 0, "prefill": 1, "decode": 2}


def model_flops(cfg, shape) -> float:
    """Useful FLOPs per step: 6*N*D train, 2*N*D prefill, 2*N*B decode."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq


def _input_bytes(cfg, shape, mesh, rules) -> float:
    """One device's bytes of the step's inputs: state, and the batch or
    the token and cache."""
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import sharding as shd
    from repro_torch.tree import flatten

    cfg = cfg.for_shape(shape)
    rules = rules or (shd.DECODE_RULES if shape.kind == "decode"
                      else shd.DEFAULT_RULES)
    opt_cfg = AdamWConfig(moment_dtype=cfg.opt_dtype) \
        if shape.kind == "train" else None
    params, axes, opt = steps.abstract_state(cfg, opt_cfg)
    pspecs, ospecs = steps.state_specs(cfg, mesh, params, axes, opt, rules)
    pairs = [(params, pspecs)] + ([(opt, ospecs)] if opt is not None else [])
    if shape.kind == "decode":
        pairs.append(steps.cache_specs(cfg, shape, mesh, rules))
    total = 0.0
    for tree, specs in pairs:
        for t, s in zip(flatten(tree), flatten(specs, is_leaf=shd.is_spec)):
            n = 1
            for d in shd.local_shape(s, tuple(t.shape), mesh):
                n *= d
            total += n * t.element_size()
    if shape.kind != "decode":
        for v in steps.batch_specs(cfg, shape, mesh, rules).values():
            n = 1
            for d in shd.local_shape(v.spec, v.shape, mesh):
                n *= d
            total += n * v.dtype.itemsize
    return total


def run_pair(cfg, shape, mesh, mesh_name: str, rules=None) -> dict:
    """Trace one pair and return its ``ok`` row."""
    from repro_torch.launch.steps import lower_step

    t0 = time.time()
    pair = lower_step(cfg, shape, mesh, rules=rules)
    terms = hlo.roofline_terms(
        pair.cost, arch=cfg.name, shape=shape.name, mesh_name=mesh_name,
        n_devices=mesh.size(), model_flops=model_flops(cfg, shape))
    args = _input_bytes(cfg, shape, mesh, rules)
    return {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
        "status": "ok",
        "compile_s": round(time.time() - t0, 1),
        "bytes_per_device": terms.bytes_per_device,
        "fits_hbm": terms.bytes_per_device <= hlo.H100.hbm_bytes,
        "hlo_flops_per_dev": terms.hlo_flops,
        "hlo_bytes_per_dev": terms.hlo_bytes,
        "coll_bytes_per_dev": terms.coll_bytes,
        "coll_by_kind": pair.cost.stats.by_kind,
        "n_collectives": terms.n_collectives,
        "t_compute_s": terms.t_compute,
        "t_memory_s": terms.t_memory,
        "t_collective_s": terms.t_collective,
        "dominant": terms.dominant,
        "model_flops": terms.model_flops,
        "useful_flops_ratio": terms.useful_flops_ratio,
        "memory_analysis": {"temp": terms.bytes_per_device - args,
                            "args": args, "output": None, "alias": None},
        "traced": [list(t) for t in pair.traced],
        "hardware": hlo.H100.name,
    }


def failing_op(exc: BaseException) -> tuple[str | None, str | None]:
    """(the ATen op DTensor was dispatching, the innermost model line)
    where ``exc`` was raised, read from the traceback's frames."""
    op = where = None
    tb = exc.__traceback__
    while tb is not None:
        frame = tb.tb_frame
        name = frame.f_code.co_filename
        if "torch/distributed/tensor" in name:
            call = frame.f_locals.get("op_call")
            schema = frame.f_locals.get("op_schema")
            if call is not None:
                op = str(call)
            elif schema is not None and hasattr(schema, "op"):
                op = str(schema.op)
        if "repro_torch" in name and "/launch/" not in name:
            where = f"{name.split('repro_torch/')[-1]}:{tb.tb_lineno}"
        tb = tb.tb_next
    if op is None and exc.__cause__ is not None:
        op = failing_op(exc.__cause__)[0]
    if op is None:
        msg = str(exc)
        if "Operator " in msg:
            op = msg.split("Operator ", 1)[1].split()[0]
    return op, where


_MESHES: dict = {}


def _mesh(name: str):
    from repro_torch.launch.mesh import make_production_mesh

    if name not in _MESHES:
        _MESHES.clear()     # another world size: the group is remade
        _MESHES[name] = make_production_mesh(multi_pod=MESHES[name])
    return _MESHES[name]


def _task(task: tuple) -> dict:
    """One grid cell: a skipped, ok or error row."""
    arch, shape_name, mesh_name, overrides, rules_name, tag = task
    cfg, shape = get(arch), SHAPES[shape_name]
    row: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    reason = skip_reason(cfg, shape)
    if reason:
        return {**row, "status": "skipped", "reason": reason}
    rules = None
    if rules_name == "seq_parallel":
        from repro_torch.parallel.sharding import SEQ_PARALLEL_RULES
        rules = SEQ_PARALLEL_RULES
    cfg_run = dataclasses.replace(cfg, **overrides) if overrides else cfg
    t0 = time.time()
    try:
        row = run_pair(cfg_run, shape, _mesh(mesh_name), mesh_name,
                       rules=rules)
    except Exception as e:  # noqa: BLE001 - report and continue
        op, where = failing_op(e)
        row = {**row, "status": "error",
               "error": f"{type(e).__name__}: {str(e)[:500]}",
               "op": op, "where": where,
               "compile_s": round(time.time() - t0, 1),
               "traceback": traceback.format_exc()[-2000:]}
        # One device's state and inputs need no trace.
        row["args_bytes_per_device"] = _input_bytes(
            cfg_run, shape, _mesh(mesh_name), rules)
    if tag:
        row["tag"] = tag
    return row


def _show(row: dict) -> str:
    head = f"{row['arch']} x {row['shape']} on {row['mesh']}"
    if row["status"] == "skipped":
        return f"[skip] {head}: {row['reason']}"
    if row["status"] == "error":
        return (f"[error] {head}: {row['op']} at {row['where']} "
                f"({row['error'][:160]})")
    return (f"[ok] {head}: {row['compile_s']}s, "
            f"{row['bytes_per_device'] / 1e9:.2f} GB/dev of "
            f"{hlo.H100.hbm_bytes / 1e9:.0f}, compute "
            f"{row['t_compute_s']:.4g} s, memory {row['t_memory_s']:.4g} s, "
            f"collective {row['t_collective_s']:.4g} s, "
            f"dominant={row['dominant']}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="dryrun_torch.json")
    ap.add_argument("--append", action="store_true",
                    help="merge results into --out instead of overwriting")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (python literal)")
    ap.add_argument("--rules", default=None, choices=[None, "seq_parallel"])
    ap.add_argument("--tag", default=None)
    ap.add_argument("--jobs", type=int, default=1,
                    help="pairs traced at a time (worker processes)")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = v

    archs = list(REGISTRY) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": ["16x16"], "multi": ["2x16x16"],
              "both": ["16x16", "2x16x16"]}[args.mesh]

    results = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"], r.get("tag"))
            for r in results}
    # The longest traces first (a train step, then a prefill, then a
    # decode step), so that the last pair a worker takes is a short one.
    tasks = sorted(((a, s, m, overrides, args.rules, args.tag)
                    for m in meshes for a in archs for s in shapes
                    if (a, s, m, args.tag) not in done),
                   key=lambda t: _KIND_ORDER[SHAPES[t[1]].kind])

    def save(row: dict) -> None:
        print(_show(row), flush=True)
        results.append(row)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    if args.jobs > 1 and len(tasks) > 1:
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(args.jobs, len(tasks))) as pool:
            for row in pool.imap_unordered(_task, tasks):
                save(row)
    else:
        for task in tasks:
            save(_task(task))
        from repro_torch.launch.mesh import release
        release()

    ok = sum(r["status"] == "ok" for r in results)
    skip = sum(r["status"] == "skipped" for r in results)
    err = sum(r["status"] == "error" for r in results)
    print(f"\ndry-run complete: {ok} ok, {skip} skipped, {err} errors "
          f"-> {args.out}")
    return 1 if err else 0


if __name__ == "__main__":
    raise SystemExit(main())
