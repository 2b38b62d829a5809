"""``python -m repro_torch.store``: query, diff, gc and gate the store.

The port's copy of ``repro/store/cli.py``::

    python -m repro_torch.store list [--kind K] [--name N]
    python -m repro_torch.store show RECORD_ID
    python -m repro_torch.store metrics RECORD_ID_OR_NAME
    python -m repro_torch.store diff A B [--timing-rel-tol 0.5]
    python -m repro_torch.store diff BUNDLE.json      # bundle vs the store
    python -m repro_torch.store gc [--keep 5] [--max-mb 64] [--dry-run]
    python -m repro_torch.store gc --cache --max-mb 512   # spill LRU
    python -m repro_torch.store baseline NAME --out BUNDLE.json
    python -m repro_torch.store run suites/quick_torch.json [--gate BUNDLE]
        [--update-baseline PATH] [--no-resume] [--require-cached]
        [--engine auto|batch|scalar] [--device cuda|cpu]

``run`` executes a suite file through
:func:`repro_torch.experiments.run_suite` (store-backed, resumable) on
``--device`` (default CUDA; no CPU fallback) and exits nonzero on any
failed claim;
``--gate`` additionally diffs the run's records against a committed
baseline bundle (exact on result cells, timing cells banded by
``--timing-rel-tol``) and fails on divergence — the CI regression gate.
``--update-baseline`` writes the bundle the gate compares against.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Any

from .record import RunRecord, canonical_json
from .store import ResultStore, default_store_dir, diff_records, gc_cache

_EXIT_OK = 0
_EXIT_REGRESSION = 1
_EXIT_USAGE = 2


def _store(args: argparse.Namespace) -> ResultStore:
    return ResultStore(args.store)


def _cmd_list(args: argparse.Namespace) -> int:
    store = _store(args)
    recs = store.find(kind=args.kind, name=args.name)
    if not recs:
        print(f"no records in {store.root}")
        return _EXIT_OK
    print(f"{'record_id':22s} {'kind':10s} {'name':24s} "
          f"{'created':19s} {'ok':3s} git_rev")
    for rec in recs:
        ts = time.strftime("%Y-%m-%d %H:%M:%S",
                           time.localtime(rec.created)) \
            if rec.created else "-"
        ok = ("yes" if rec.ok else "NO") if rec.claims else "-"
        print(f"{rec.record_id:22s} {rec.kind:10s} {rec.name:24s} "
              f"{ts:19s} {ok:3s} {rec.git_rev}")
    if store.invalidated:
        print(f"({store.invalidated} record(s) of another schema version "
              f"ignored)", file=sys.stderr)
    return _EXIT_OK


def _resolve_record(store: ResultStore, ref: str) -> RunRecord | None:
    """A record by id, by file path, or the newest by name."""
    if Path(ref).is_file():
        import json
        with open(ref) as fh:
            return RunRecord.from_dict(json.load(fh))
    rec = store.get(ref)
    if rec is not None:
        return rec
    return store.latest(ref)


def _cmd_show(args: argparse.Namespace) -> int:
    rec = _resolve_record(_store(args), args.record)
    if rec is None:
        print(f"error: no record {args.record!r}", file=sys.stderr)
        return _EXIT_USAGE
    print(rec.to_json())
    return _EXIT_OK


def _diff_pair(a: Any, b: Any, label: str,
               timing_rel_tol: float | None) -> int:
    diffs = diff_records(a, b, timing_rel_tol=timing_rel_tol)
    for d in diffs:
        print(f"{label}: {d}")
    return len(diffs)


def _cmd_diff(args: argparse.Namespace) -> int:
    store = _store(args)
    if args.b is None:
        # One argument: a baseline bundle, compared member-by-member
        # against the store (by record id — an identity change shows up as
        # a missing record, which is itself a divergence).
        try:
            bundle = ResultStore.load_bundle(args.a)
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return _EXIT_USAGE
        n = 0
        for rid, rec_dict in sorted(bundle["records"].items()):
            mine = store.get(rid)
            label = f"{rec_dict.get('kind')}/{rec_dict.get('name')}"
            if mine is None:
                print(f"{label}: record {rid} missing from store "
                      f"(identity changed or never run)")
                n += 1
                continue
            n += _diff_pair(rec_dict, mine, label, args.timing_rel_tol)
        if n == 0:
            print(f"baseline {args.a}: no divergence "
                  f"({len(bundle['records'])} records)")
        return _EXIT_REGRESSION if n else _EXIT_OK
    a = _resolve_record(store, args.a)
    b = _resolve_record(store, args.b)
    if a is None or b is None:
        missing = args.a if a is None else args.b
        print(f"error: no record {missing!r}", file=sys.stderr)
        return _EXIT_USAGE
    n = _diff_pair(a, b, f"{a.name}", args.timing_rel_tol)
    if n == 0:
        print("no divergence")
    return _EXIT_REGRESSION if n else _EXIT_OK


def _cmd_metrics(args: argparse.Namespace) -> int:
    """Tabulate a record's observability metrics: the deterministic
    counters of ``payload["metrics"]`` plus the timing-banded timers and
    gauges persisted under ``timings``."""
    rec = _resolve_record(_store(args), args.record)
    if rec is None:
        print(f"error: no record {args.record!r}", file=sys.stderr)
        return _EXIT_USAGE
    sections = (
        ("counters", rec.payload.get("metrics", {}) or {}),
        ("timings", rec.timings or {}),
    )
    print(f"{rec.kind}/{rec.name} ({rec.record_id})")
    empty = True
    for title, values in sections:
        if not values:
            continue
        empty = False
        print(f"  {title}:")
        for key in sorted(values):
            v = values[key]
            shown = f"{v:.6g}" if isinstance(v, float) else v
            print(f"    {key:32s} {shown}")
    if empty:
        print("  (no metrics recorded)")
    return _EXIT_OK


def _cmd_gc(args: argparse.Namespace) -> int:
    if args.cache:
        if args.max_mb is None:
            print("error: gc --cache needs --max-mb", file=sys.stderr)
            return _EXIT_USAGE
        evicted = gc_cache(args.cache_dir,
                           max_bytes=int(args.max_mb * 1024 * 1024),
                           dry_run=args.dry_run)
        verb = "would evict" if args.dry_run else "evicted"
        for path, size in evicted:
            print(f"{verb} {path} ({size} bytes)")
        print(f"{verb} {len(evicted)} spill file(s), "
              f"{sum(s for _, s in evicted)} bytes")
        return _EXIT_OK
    store = _store(args)
    max_bytes = None if args.max_mb is None \
        else int(args.max_mb * 1024 * 1024)
    victims = store.gc(keep_per_name=args.keep, max_bytes=max_bytes,
                       dry_run=args.dry_run)
    verb = "would delete" if args.dry_run else "deleted"
    for rid, reason in victims:
        print(f"{verb} {rid}: {reason}")
    print(f"{verb} {len(victims)} record(s) from {store.root}")
    return _EXIT_OK


def _suite_bundle(store: ResultStore, suite_rec: RunRecord) -> dict:
    members = []
    for item in suite_rec.payload.get("items", ()):
        rec = store.get(item["record_id"])
        if rec is not None:
            members.append(rec)
    return ResultStore.bundle(suite_rec, members)


def _cmd_baseline(args: argparse.Namespace) -> int:
    store = _store(args)
    suite_rec = store.latest(args.name, kind="suite") \
        if args.record is None else store.get(args.record)
    if suite_rec is None or suite_rec.kind != "suite":
        print(f"error: no suite record for {args.name!r} "
              f"(run the suite first)", file=sys.stderr)
        return _EXIT_USAGE
    bundle = _suite_bundle(store, suite_rec)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(canonical_json(bundle) + "\n")
        print(f"baseline {args.name} ({len(bundle['records'])} records) "
              f"-> {out}")
    else:
        path = store.set_baseline(args.name, bundle)
        print(f"baseline {args.name} ({len(bundle['records'])} records) "
              f"-> {path}")
    return _EXIT_OK


def _gate(store: ResultStore, result: Any, baseline_path: str,
          timing_rel_tol: float | None) -> int:
    """Diff a suite run against a committed baseline bundle, by item name
    (so an identity change diffs loudly instead of just going missing)."""
    bundle = ResultStore.load_bundle(baseline_path)
    base_by_name = {(r.get("kind"), r.get("name")): r
                    for r in bundle["records"].values()}
    cur_by_name = {(it.kind, it.name): it.record for it in result.items
                   if it.record is not None}
    n = 0
    for key in sorted(set(base_by_name) | set(cur_by_name),
                      key=lambda kv: (str(kv[0]), str(kv[1]))):
        label = f"{key[0]}/{key[1]}"
        if key not in cur_by_name:
            print(f"gate: {label} in baseline but not in this run")
            n += 1
        elif key not in base_by_name:
            print(f"gate: {label} ran but has no baseline record "
                  f"(update the baseline)")
            n += 1
        else:
            n += _diff_pair(base_by_name[key], cur_by_name[key], label,
                            timing_rel_tol)
    if n == 0:
        print(f"gate: no divergence vs {baseline_path} "
              f"({len(base_by_name)} records)")
    return n


def _cmd_run(args: argparse.Namespace) -> int:
    from ..experiments.runner import run_suite

    store = _store(args)
    result = run_suite(args.suite, store=store, resume=not args.no_resume,
                       engine=args.engine, workers=args.workers,
                       verbose=args.verbose, device=args.device)
    print(result.summary())
    rc = _EXIT_OK
    if not result.ok:
        rc = _EXIT_REGRESSION
    if args.require_cached:
        missed = [it.name for it in result.items if not it.cached]
        if missed:
            print(f"require-cached: {len(missed)} item(s) executed instead "
                  f"of resuming from the store: {missed}")
            rc = _EXIT_REGRESSION
    if args.gate:
        if _gate(store, result, args.gate, args.timing_rel_tol):
            rc = _EXIT_REGRESSION
    if args.update_baseline:
        bundle = _suite_bundle(store, result.record)
        out = Path(args.update_baseline)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(canonical_json(bundle) + "\n")
        print(f"baseline ({len(bundle['records'])} records) -> {out}")
    return rc


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.store", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--store", default=None, metavar="DIR",
                    help=f"store root (default $REPRO_STORE_DIR or "
                         f"{default_store_dir()})")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("list", help="list records, newest first")
    p.add_argument("--kind", default=None,
                   choices=("experiment", "benchmark", "suite"))
    p.add_argument("--name", default=None)
    p.set_defaults(fn=_cmd_list)

    p = sub.add_parser("show", help="print one record as canonical JSON")
    p.add_argument("record", help="record id, file path, or name (newest)")
    p.set_defaults(fn=_cmd_show)

    p = sub.add_parser(
        "diff", help="diff two records, or a baseline bundle vs the store")
    p.add_argument("a", help="record id/path/name, or a baseline bundle")
    p.add_argument("b", nargs="?", default=None,
                   help="second record (omit when A is a bundle)")
    p.add_argument("--timing-rel-tol", type=float, default=None,
                   metavar="FRAC",
                   help="compare timing cells within this relative band "
                        "(default: ignore them)")
    p.set_defaults(fn=_cmd_diff)

    p = sub.add_parser(
        "metrics", help="show a record's counters / timers / gauges")
    p.add_argument("record", help="record id, file path, or name (newest)")
    p.set_defaults(fn=_cmd_metrics)

    p = sub.add_parser("gc", help="prune store records / the EvalCache spill")
    p.add_argument("--keep", type=int, default=5, metavar="N",
                   help="newest records kept per (kind, name) (default 5)")
    p.add_argument("--max-mb", type=float, default=None,
                   help="size cap; LRU-evict past it")
    p.add_argument("--dry-run", action="store_true",
                   help="report would-be deletions without deleting")
    p.add_argument("--cache", action="store_true",
                   help="gc the EvalCache spill (eval-*.json) instead of "
                        "store records")
    p.add_argument("--cache-dir", default=None, metavar="DIR",
                   help="spill dir for --cache (default $REPRO_CACHE_DIR "
                        "or ~/.cache/repro)")
    p.set_defaults(fn=_cmd_gc)

    p = sub.add_parser(
        "baseline", help="export a suite run as a baseline bundle")
    p.add_argument("name", help="suite name (newest suite record)")
    p.add_argument("--record", default=None,
                   help="a specific suite record id instead of the newest")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="write the bundle here (for committing); default: "
                        "the store's baselines/ dir")
    p.set_defaults(fn=_cmd_baseline)

    p = sub.add_parser("run", help="run a suite file (store-backed)")
    p.add_argument("suite", help="suite file (.yaml/.yml/.json)")
    p.add_argument("--no-resume", action="store_true",
                   help="execute every item even when the store has it")
    p.add_argument("--require-cached", action="store_true",
                   help="fail unless every item resumed from the store")
    p.add_argument("--gate", default=None, metavar="BASELINE",
                   help="fail on divergence vs this baseline bundle")
    p.add_argument("--update-baseline", default=None, metavar="PATH",
                   help="write the run's baseline bundle here")
    p.add_argument("--timing-rel-tol", type=float, default=None,
                   metavar="FRAC", help="timing band for --gate")
    p.add_argument("--engine", default=None,
                   choices=("auto", "batch", "scalar"))
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="device of the experiment items (default cuda)")
    p.add_argument("--workers", type=int, default=None)
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=_cmd_run)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
