"""The port's prediction-window layer against the JAX package's, bitwise.

Every public function of ``repro_torch.core.windows`` (``beta_lim_window``,
the four ``waste_window*`` functions, ``t_window_period``,
``optimal_window_plan`` and ``window_strategy``) returns the reference's
floats, plans and strategies over the grids of ``tests/test_windows.py``
(the paper platform at 2^16, windows 0..18,000 s, the three modes) and the
ranges ``tests/test_window_properties.py`` draws from (r, p in 0.1-0.95,
cp_ratio 0.25-2, n 2^12-2^19, window 2-60 x C_p, T_p 1.2-8 x C_p), taken
here on a seeded grid.  Tolerance: none (a copy, operation for operation).
"""

import dataclasses
import importlib

import numpy as np
import pytest

pytest.importorskip("torch")

ref_windows = importlib.import_module("repro.core.windows")
from repro.core.prediction import PredictedPlatform as RefPP  # noqa: E402
from repro.core.prediction import Predictor as RefPredictor  # noqa: E402
from repro.core.waste import Platform as RefPlatform  # noqa: E402

from repro_torch.core import windows  # noqa: E402
from repro_torch.core.prediction import PredictedPlatform, Predictor  # noqa: E402
from repro_torch.core.waste import Platform  # noqa: E402

MU_IND = 125.0 * 365.0 * 86400.0


def _pp(r, p, cp_ratio, n, c=600.0):
    plat = dict(mu=MU_IND / n, c=c, d=60.0, r=600.0)
    return (PredictedPlatform(Platform(**plat), Predictor(r, p), cp_ratio * c),
            RefPP(RefPlatform(**plat), RefPredictor(r, p), cp_ratio * c))


def _grid():
    """(r, p, cp_ratio, n, window, tp_mult): the paper cells of
    test_windows.py and 24 seeded draws over test_window_properties.py's
    ranges."""
    cells = [(r, p, 1.0, 2 ** 16, w, 2.0)
             for r, p in ((0.85, 0.82), (0.7, 0.4))
             for w in (0.0, 600.0, 3000.0, 9000.0, 18000.0)]
    g = np.random.default_rng(2024)
    for _ in range(24):
        cells.append((float(g.uniform(0.1, 0.95)), float(g.uniform(0.1, 0.95)),
                      float(g.choice([0.25, 0.5, 1.0, 2.0])),
                      int(g.integers(2 ** 12, 2 ** 19)),
                      float(g.uniform(2.0, 60.0)) * 600.0,
                      float(g.uniform(1.2, 8.0))))
    return cells


GRID = _grid()


def _strat_tuple(s):
    return (s.name, s.period, type(s.trust).__name__, vars(s.trust),
            s.inexact_window, s.window_mode, s.window_period)


@pytest.mark.parametrize("cell", range(len(GRID)))
def test_window_functions_match_reference(cell):
    r, p, cp_ratio, n, window, tp_mult = GRID[cell]
    pp, ref_pp = _pp(r, p, cp_ratio, n)
    tp = tp_mult * pp.cp
    for t in (pp.platform.c * 1.5, 5000.0, 15000.0, 60000.0):
        assert windows.waste_window_ignore(t, pp, window) == \
            ref_windows.waste_window_ignore(t, ref_pp, window)
        assert windows.waste_window_instant(t, pp, window) == \
            ref_windows.waste_window_instant(t, ref_pp, window)
        assert windows.waste_window_within(t, pp, window, tp) == \
            ref_windows.waste_window_within(t, ref_pp, window, tp)
        for mode in windows.WINDOW_STRATEGY_MODES:
            assert windows.waste_window(t, pp, window, mode, tp) == \
                ref_windows.waste_window(t, ref_pp, window, mode, tp)
    assert windows.beta_lim_window(pp, window) == \
        ref_windows.beta_lim_window(ref_pp, window)
    assert windows.beta_lim_window(pp, window, tp) == \
        ref_windows.beta_lim_window(ref_pp, window, tp)
    assert windows.t_window_period(pp, window) == \
        ref_windows.t_window_period(ref_pp, window)
    for mode in (None,) + windows.WINDOW_STRATEGY_MODES:
        assert dataclasses.astuple(windows.optimal_window_plan(
            pp, window, mode)) == dataclasses.astuple(
                ref_windows.optimal_window_plan(ref_pp, window, mode))
    for mode in windows.WINDOW_STRATEGY_MODES:
        assert _strat_tuple(windows.window_strategy(pp, window, mode)) == \
            _strat_tuple(ref_windows.window_strategy(ref_pp, window, mode))
    assert _strat_tuple(windows.window_strategy(
        pp, window, "within", window_period=tp)) == _strat_tuple(
            ref_windows.window_strategy(ref_pp, window, "within",
                                        window_period=tp))


def test_window_refusals_match_reference():
    pp, ref_pp = _pp(0.85, 0.82, 1.0, 2 ** 16)
    for mod, p in ((windows, pp), (ref_windows, ref_pp)):
        with pytest.raises(ValueError, match="window_period"):
            mod.waste_window(5000.0, p, 900.0, "within")
        with pytest.raises(ValueError, match="unknown window mode"):
            mod.waste_window(5000.0, p, 900.0, "late")
        with pytest.raises(ValueError, match="window_period"):
            mod.window_strategy(p, 900.0, "within", window_period=p.cp)
        with pytest.raises(ValueError):
            mod.optimal_window_plan(p, 900.0, "late")
