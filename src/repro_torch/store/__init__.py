"""Queryable result store + declarative scenario suites of the port.

The port's own copy of ``repro/store``, the ops layer over
:mod:`repro_torch.experiments`: every run lands as an
immutable, content-addressed :class:`RunRecord` in the on-disk
:class:`ResultStore` (provenance, engine fingerprints, per-cell results),
suite files collect :class:`~repro_torch.experiments.spec.ExperimentSpec`s
with expected-claim asserts (:class:`SuiteSpec` / :class:`ClaimSpec`), and
the CLI (``python -m repro_torch.store``) lists / shows / diffs /
garbage-collects records and gates suite runs against baseline bundles.

The suite *runner* lives with the experiment runner:
:func:`repro_torch.experiments.runner.run_suite`; it runs each experiment
item on CUDA unless told ``device="cpu"``.
"""

from .record import (STORE_SCHEMA_VERSION, RunRecord, canonical_json,
                     content_hash)
from .store import (Diff, ResultStore, default_store_dir, diff_records,
                    gc_cache, is_timing_key)
from .suite import ClaimSpec, SuiteItem, SuiteSpec, evaluate_claims

__all__ = [
    "STORE_SCHEMA_VERSION",
    "RunRecord",
    "canonical_json",
    "content_hash",
    "Diff",
    "ResultStore",
    "default_store_dir",
    "diff_records",
    "gc_cache",
    "is_timing_key",
    "ClaimSpec",
    "SuiteItem",
    "SuiteSpec",
    "evaluate_claims",
]
