"""Public names of ported modules, held ``==`` the JAX package's.

* ``core/prediction.py``: ``optimal_q`` (the mirror of
  ``tests/test_prediction.py:50-59``, plus its value ``==`` the
  reference's on a grid) and ``t_pred_asymptotic`` (the mirror of
  ``:140-144``, plus ``==``); both re-exported by ``repro_torch.core`` with
  ``waste_with_prediction``.
* ``configs/paper.py``: ``SYNTHETIC``, ``LOGBASED``, ``PREDICTOR_GOOD``,
  ``PREDICTOR_FAIR``, ``CP_SCENARIOS`` and ``TPU_V5E``.
* ``data/pipeline.py``: ``DataState``.
* ``models/model.py``: ``state_bytes`` on a reduced train state carried
  across to JAX arrays.
* ``kernels/ops.py``: ``quantize_delta`` / ``dequantize_delta`` with
  ``impl="ref"`` and the kernel names (the plain version on CPU tensors)
  against ``repro.kernels.ops``.

Tolerance: none (the names compute the same operations in the same
order, so results are bitwise equal).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.core.prediction import (PredictedPlatform,  # noqa: E402
                                         Predictor,
                                         optimal_period_with_prediction,
                                         optimal_q, t_pred_asymptotic,
                                         waste_simple_policy)
from repro_torch.core.waste import Platform  # noqa: E402

MU_IND = 125.0 * 365.0 * 86400.0


def pp(n=2**16, c=600.0, cp=600.0, d=60.0, r=600.0, recall=0.85,
       precision=0.82) -> PredictedPlatform:
    plat = Platform(mu=MU_IND / n, c=c, d=d, r=r)
    return PredictedPlatform(plat, Predictor(recall, precision), cp)


def ref_pp(n=2**16, c=600.0, cp=600.0, d=60.0, r=600.0, recall=0.85,
           precision=0.82):
    from repro.core.prediction import PredictedPlatform as RefPP
    from repro.core.prediction import Predictor as RefPredictor
    from repro.core.waste import Platform as RefPlatform
    plat = RefPlatform(mu=MU_IND / n, c=c, d=d, r=r)
    return RefPP(plat, RefPredictor(recall, precision), cp)


# -- core/prediction.py --------------------------------------------------------

@given(st.floats(0.05, 0.99), st.floats(0.05, 0.99),
       st.integers(2**10, 2**19))
@settings(max_examples=50, deadline=None)
def test_optimal_q_is_extreme(r, p, n):
    """Waste is linear in q, so the optimum is always q in {0, 1}."""
    ppl = pp(n=n, recall=r, precision=p)
    t = 2.0 * ppl.platform.c + 1000.0
    w0 = waste_simple_policy(t, 0.0, ppl)
    w1 = waste_simple_policy(t, 1.0, ppl)
    wmid = waste_simple_policy(t, 0.5, ppl)
    assert wmid == pytest.approx(0.5 * (w0 + w1), rel=1e-9)  # linearity
    assert optimal_q(t, ppl) in (0, 1)


def test_asymptotic_period():
    """T* ~ sqrt(2 mu C / (1-r)) for large mu (paper §4.3 remark)."""
    ppl = pp(n=2**8)  # large mu
    t_star, _, _ = optimal_period_with_prediction(ppl)
    assert t_star == pytest.approx(t_pred_asymptotic(ppl), rel=0.05)


@pytest.mark.parametrize("n", [2**8, 2**12, 2**16, 2**19])
@pytest.mark.parametrize("recall,precision",
                         [(0.85, 0.82), (0.7, 0.4), (0.3, 0.99), (1.0, 0.5)])
def test_prediction_names_equal_reference(n, recall, precision):
    from repro.core.prediction import optimal_q as ref_optimal_q
    from repro.core.prediction import t_pred_asymptotic as ref_asymptotic
    mine, theirs = pp(n=n, recall=recall, precision=precision), \
        ref_pp(n=n, recall=recall, precision=precision)
    assert t_pred_asymptotic(mine) == ref_asymptotic(theirs)
    for t in (700.0, 5000.0, 50000.0, 5e5):
        assert optimal_q(t, mine) == ref_optimal_q(t, theirs)


def test_core_reexports():
    import repro.core as ref_core

    import repro_torch.core as core
    from repro_torch.core import prediction
    for name in ("t_pred_asymptotic", "waste_with_prediction"):
        assert name in core.__all__ and name in ref_core.__all__
        assert getattr(core, name) is getattr(prediction, name)
    assert {"optimal_q", "t_pred_asymptotic"} <= set(prediction.__all__)


# -- configs/paper.py -----------------------------------------------------------

@pytest.mark.parametrize("name", ["SYNTHETIC", "LOGBASED", "PREDICTOR_GOOD",
                                  "PREDICTOR_FAIR", "CP_SCENARIOS",
                                  "TPU_V5E"])
def test_paper_constants_equal_reference(name):
    import repro.configs.paper as ref_paper

    import repro_torch.configs.paper as paper
    mine, theirs = getattr(paper, name), getattr(ref_paper, name)
    if dataclasses.is_dataclass(mine):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    else:
        assert mine == theirs
    assert name in paper.__all__


# -- data/pipeline.py ------------------------------------------------------------

def test_data_state_equals_reference():
    from repro.data.pipeline import DataState as RefDataState

    from repro_torch.data.pipeline import DataState
    assert [(f.name, f.default) for f in dataclasses.fields(DataState)] \
        == [(f.name, f.default) for f in dataclasses.fields(RefDataState)]
    assert dataclasses.asdict(DataState(step=7)) \
        == dataclasses.asdict(RefDataState(step=7))
    state = DataState()
    state.step += 3                      # a mutable cursor, as the reference
    assert state == DataState(step=3)


# -- models/model.py --------------------------------------------------------------

def _to_jax(tree):
    import jax.numpy as jnp
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_jax(v) for v in tree)
    dtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
             torch.int32: jnp.int32}[tree.dtype]
    return jnp.asarray(tree.float().numpy() if tree.is_floating_point()
                       else tree.numpy()).astype(dtype)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "xlstm-125m",
                                  "qwen2-moe-a2.7b"])
def test_state_bytes_equals_reference(arch):
    from repro.models.model import state_bytes as ref_state_bytes

    from repro_torch.configs import get
    from repro_torch.models.model import init_params, state_bytes
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    cfg = get(arch).reduced()
    params = init_params(cfg, seed=0, device="cpu")
    opt = adamw_init(params, AdamWConfig(moment_dtype=cfg.opt_dtype))
    jparams, jopt = _to_jax(params), _to_jax(opt)
    assert state_bytes(params) == ref_state_bytes(jparams) > 0
    assert state_bytes(params, opt) == ref_state_bytes(jparams, jopt) \
        > state_bytes(params)


# -- kernels/ops.py ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(123,), (256,), (1000, 37)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["ref", "pallas", "pallas_interpret"])
def test_ops_delta_dispatchers_equal_reference(shape, dtype, impl):
    import jax.numpy as jnp
    from repro.kernels import ops as ref_ops

    from repro_torch.kernels import ops
    rng = np.random.default_rng(sum(shape))
    base = rng.standard_normal(shape).astype(np.float32)
    cur = base + 0.01 * rng.standard_normal(shape).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tcur, tbase = (torch.from_numpy(x).to(tdt) for x in (cur, base))
    jcur, jbase = (jnp.asarray(x).astype(jdt) for x in (cur, base))

    q, scales = ops.quantize_delta(tcur, tbase, impl=impl)
    rq, rscales = ref_ops.quantize_delta(jcur, jbase, impl="ref")
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert np.array_equal(scales.numpy(), np.asarray(rscales))
    out = ops.dequantize_delta(q, scales, tbase, impl=impl)
    rout = ref_ops.dequantize_delta(rq, rscales, jbase, impl="ref")
    assert out.dtype == tdt and out.shape == tbase.shape
    assert np.array_equal(out.float().numpy(),
                          np.asarray(rout.astype(jnp.float32)))


def test_ops_delta_rejects_unknown_impl():
    from repro_torch.kernels import ops
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="unknown"):
        ops.quantize_delta(x, x, impl="triton")
    with pytest.raises(ValueError, match="unknown"):
        ops.dequantize_delta(torch.zeros((1, 256), dtype=torch.int8),
                             torch.ones(1), x, impl="cuda")
