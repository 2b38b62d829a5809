"""The port's silent-error layer against the JAX package's, bitwise.

Every public function of ``repro_torch.core.silent`` (``waste_silent``,
``t_silent``, ``optimal_silent_plan``, ``waste_silent_pred``,
``t_silent_pred``, ``optimal_silent_pred_plan`` and ``silent_strategy`` in
its three modes) returns the reference's floats, plans and strategies over
the grid of ``tests/test_silent.py`` (its platform mu = 50,000 s, C = 600,
R = 900, D = 60 with silent MTBF 20,000 s and V = 100) and the paper
platform at 2^16 and 2^19 with the quick suite's silent cells
(``silent_mu_ind`` 8e9 and 2e9, V = 120), silent rates off, k = 0..6 and
keep_ckpts 1-3.  Tolerance: none.
"""

import dataclasses
import importlib
import math

import pytest

pytest.importorskip("torch")

ref_silent = importlib.import_module("repro.core.silent")
from repro.core.prediction import PredictedPlatform as RefPP  # noqa: E402
from repro.core.prediction import Predictor as RefPredictor  # noqa: E402
from repro.core.waste import Platform as RefPlatform  # noqa: E402

from repro_torch.core import silent  # noqa: E402
from repro_torch.core.prediction import PredictedPlatform, Predictor  # noqa: E402
from repro_torch.core.waste import Platform  # noqa: E402

MU_IND = 125.0 * 365.0 * 86400.0
# (platform, silent_mu, verify_cost)
CELLS = [((50_000.0, 600.0, 900.0, 60.0), 20_000.0, 100.0),
         ((50_000.0, 600.0, 900.0, 60.0), None, 100.0),
         ((50_000.0, 600.0, 900.0, 60.0), math.inf, 0.0),
         ((MU_IND / 2 ** 16, 600.0, 600.0, 60.0), 8e9 / 2 ** 16, 120.0),
         ((MU_IND / 2 ** 16, 600.0, 600.0, 60.0), 2e9 / 2 ** 16, 120.0),
         ((MU_IND / 2 ** 19, 600.0, 600.0, 60.0), 2e9 / 2 ** 19, 120.0),
         ((MU_IND / 2 ** 19, 1800.0, 600.0, 60.0), 8e9 / 2 ** 19, 0.0)]
PREDICTORS = [(0.85, 0.82, 1.0), (0.7, 0.4, 2.0), (0.5, 0.9, 0.1)]


def _pair(plat, r=0.85, p=0.82, cp_ratio=1.0):
    mu, c, rr, d = plat
    a, b = Platform(mu=mu, c=c, r=rr, d=d), RefPlatform(mu=mu, c=c, r=rr, d=d)
    return (a, b, PredictedPlatform(a, Predictor(r, p), cp_ratio * c),
            RefPP(b, RefPredictor(r, p), cp_ratio * c))


def _same_call(fn, ref_fn, args, ref_args, ref_kw=None, **kw):
    """Both raise ValueError, or both return the same value
    (``ref_kw`` overrides keyword arguments for the reference)."""
    try:
        want = ref_fn(*ref_args, **{**kw, **(ref_kw or {})})
    except ValueError as e:
        with pytest.raises(ValueError):
            fn(*args, **kw)
        return str(e)
    got = fn(*args, **kw)
    if dataclasses.is_dataclass(want):
        if hasattr(want, "trust"):
            assert (got.name, got.period, type(got.trust).__name__,
                    vars(got.trust), got.n_verify, got.verify_cost,
                    got.keep_ckpts, got.window_mode) == \
                (want.name, want.period, type(want.trust).__name__,
                 vars(want.trust), want.n_verify, want.verify_cost,
                 want.keep_ckpts, want.window_mode)
        else:
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
    else:
        assert got == want
    return got


@pytest.mark.parametrize("cell", range(len(CELLS)))
def test_silent_functions_match_reference(cell):
    plat, smu, vc = CELLS[cell]
    a, b, pp, ref_pp = _pair(plat)
    for k in range(0, 7):
        for t in (a.c * 0.5, a.c * 1.5, 3000.0, 9000.0, 40000.0):
            _same_call(silent.waste_silent, ref_silent.waste_silent,
                       (t, k, a, smu, vc), (t, k, b, smu, vc))
            _same_call(silent.waste_silent_pred, ref_silent.waste_silent_pred,
                       (t, k, pp, smu, vc), (t, k, ref_pp, smu, vc))
        _same_call(silent.t_silent, ref_silent.t_silent,
                   (k, a, smu, vc), (k, b, smu, vc))
        _same_call(silent.t_silent_pred, ref_silent.t_silent_pred,
                   (k, pp, smu, vc), (k, ref_pp, smu, vc))
    for kc in (1, 2, 3):
        for k_max in (1, 4, 16):
            _same_call(silent.optimal_silent_plan,
                       ref_silent.optimal_silent_plan, (a, smu, vc),
                       (b, smu, vc), k_max=k_max, keep_ckpts=kc)
            _same_call(silent.optimal_silent_pred_plan,
                       ref_silent.optimal_silent_pred_plan, (pp, smu, vc),
                       (ref_pp, smu, vc), k_max=k_max, keep_ckpts=kc)
        for mode in ("ignore", "verify"):
            _same_call(silent.silent_strategy, ref_silent.silent_strategy,
                       (a, smu, vc), (b, smu, vc), mode=mode, keep_ckpts=kc)
        _same_call(silent.silent_strategy, ref_silent.silent_strategy,
                   (a, smu, vc), (b, smu, vc), {"pp": ref_pp},
                   mode="verify_pred", pp=pp, keep_ckpts=kc)


@pytest.mark.parametrize("pred", PREDICTORS)
def test_silent_pred_plans_across_predictors(pred):
    r, p, cp_ratio = pred
    for plat, smu, vc in CELLS[:1] + CELLS[3:]:
        _, _, pp, ref_pp = _pair(plat, r, p, cp_ratio)
        _same_call(silent.optimal_silent_pred_plan,
                   ref_silent.optimal_silent_pred_plan, (pp, smu, vc),
                   (ref_pp, smu, vc))


def test_silent_refusals_match_reference():
    a, b, pp, ref_pp = _pair(CELLS[0][0])
    assert silent.DEFAULT_KEEP_CKPTS == ref_silent.DEFAULT_KEEP_CKPTS
    for mod, plat in ((silent, a), (ref_silent, b)):
        with pytest.raises(ValueError):
            mod.silent_strategy(plat, 20_000.0, 100.0, mode="verify_pred")
        with pytest.raises(ValueError, match="unknown silent mode"):
            mod.silent_strategy(plat, 20_000.0, 100.0, mode="late")
        with pytest.raises(ValueError):
            mod.waste_silent(plat.c / 2.0, 1, plat, 20_000.0, 100.0)
