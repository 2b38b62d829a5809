"""The port's event_step against the JAX package's, bit for bit.

The same full states (23 float64 + 12 int32 rows, drawn with numpy by
``repro_torch.kernels.event_step.random_state``) go through the port's
plain torch version on the CPU and through the reference's
``event_step(impl="ref")`` and ``impl="pallas_interpret"``.  The reference
needs x64, so it runs in a subprocess with ``JAX_ENABLE_X64=1
JAX_PLATFORMS=cpu``.  Tolerance: none, the comparison is ``==`` on the
bits, because every operation of the step is an IEEE float64 add,
subtract, divide, compare or select done in the reference's order.

The CUDA kernel against the plain version runs only where there is a
card (marker ``gpu``); here it skips.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.event_step import (  # noqa: E402
    N_F, N_I, event_step, event_step_ref, random_state)

KW = dict(c=60.0, cp=30.0, d=10.0, r=30.0, time_base=4000.0)
CASES = [(n, passes) for n in (300, 1500) for passes in (1, 4)]
# The paper study's lane count in chip_smoke.py: (24 grid periods + the
# rfo period + optimal_prediction) x 200 traces.
MAIN_LANES = 5200
SRC = str(Path(__file__).resolve().parents[1] / "src")

_JAX_STEP = """
import sys
import numpy as np
import jax.numpy as jnp
from repro.kernels.event_step import event_step

kw = dict(c=60.0, cp=30.0, d=10.0, r=30.0, time_base=4000.0)
inp = np.load(sys.argv[1])
out = {}
for key in sorted({k.rsplit("_", 1)[0] for k in inp.files}):
    n, passes = (int(v) for v in key.split("x"))
    for impl in ("ref", "pallas_interpret"):
        fs, is_ = jnp.asarray(inp[key + "_fs"]), jnp.asarray(inp[key + "_is"])
        for _ in range(passes):
            fs, is_ = event_step(fs, is_, impl=impl, **kw)
        out[f"{key}_{impl}_fs"] = np.asarray(fs)
        out[f"{key}_{impl}_is"] = np.asarray(is_)
np.savez(sys.argv[2], **out)
"""


def _state(n):
    return random_state(n, seed=n)


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    """The reference's outputs for every case, from one x64 subprocess."""
    pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("event_step")
    inp = {}
    for n, passes in CASES:
        fs, is_ = _state(n)
        inp[f"{n}x{passes}_fs"], inp[f"{n}x{passes}_is"] = fs, is_
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([SRC] + sys.path))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_STEP, str(d / "in.npz"),
         str(d / "out.npz")], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    return dict(np.load(d / "out.npz"))


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int64) if a.dtype == np.float64 else a


@pytest.mark.parametrize("impl", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("n,passes", CASES)
def test_plain_matches_reference(jax_steps, n, passes, impl):
    fs, is_ = _state(n)
    f, i = event_step_ref(torch.from_numpy(fs), torch.from_numpy(is_),
                          passes=passes, **KW)
    want_f = jax_steps[f"{n}x{passes}_{impl}_fs"]
    want_i = jax_steps[f"{n}x{passes}_{impl}_is"]
    assert (_bits(f.numpy()) == _bits(want_f)).all()
    assert (i.numpy() == want_i).all()
    # The state really moved: the comparison is not between two no-ops.
    assert (f.numpy() != fs).any(axis=0).mean() > 0.5


def test_random_state_covers_every_path():
    """Every phase, verify on/off, open/closed windows, the sentinels,
    finished and corrupted lanes appear in the checked states."""
    from repro_torch.kernels.event_step import (F_TARGET, F_VREM, F_WINEND,
                                                I_CORR, I_FIN, I_NV,
                                                I_PHASE)
    fs, is_ = _state(300)
    assert set(np.unique(is_[I_PHASE])) == set(range(6))
    assert (is_[I_NV] == 0).any() and (is_[I_NV] >= 1).any()
    assert np.isneginf(fs[F_WINEND]).any() and np.isfinite(
        fs[F_WINEND]).any()
    assert np.isposinf(fs[F_TARGET]).any() and np.isposinf(fs[F_VREM]).any()
    assert is_[I_FIN].any() and is_[I_CORR].any()


def test_wrapper_takes_plain_version_on_cpu():
    fs, is_ = _state(300)
    before = event_step.launches
    f, i = event_step(torch.from_numpy(fs), torch.from_numpy(is_),
                      passes=4, **KW)
    f_ref, i_ref = event_step_ref(torch.from_numpy(fs),
                                  torch.from_numpy(is_), passes=4, **KW)
    assert torch.equal(f, f_ref) and torch.equal(i, i_ref)
    assert event_step.launches == before    # no kernel ran


def test_passes_compose():
    """``passes=4`` is bitwise four single steps."""
    fs, is_ = (torch.from_numpy(a) for a in _state(300))
    f4, i4 = event_step(fs, is_, passes=4, **KW)
    f1, i1 = fs, is_
    for _ in range(4):
        f1, i1 = event_step(f1, i1, **KW)
    assert torch.equal(f4, f1) and torch.equal(i4, i1)


@pytest.mark.parametrize("bad", ["dtype", "rows", "lanes", "passes"])
def test_wrapper_rejects_bad_state(bad):
    fs, is_ = (torch.from_numpy(a) for a in _state(8))
    kw = dict(KW)
    if bad == "dtype":
        fs = fs.float()
    elif bad == "rows":
        is_ = is_[:4]
    elif bad == "lanes":
        fs = fs[:, :5]
    else:
        kw["passes"] = 0
    with pytest.raises((TypeError, ValueError)):
        event_step(fs, is_, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [300, 4800, MAIN_LANES])
def test_cuda_kernel_matches_plain(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode "
                    "(chip_smoke.py runs this check on the GPU)")
    fs, is_ = (torch.from_numpy(a).cuda() for a in _state(n))
    assert fs.shape == (N_F, n) and is_.shape == (N_I, n)
    for passes in (1, 4):
        before = event_step.launches
        fk, ik = event_step(fs, is_, passes=passes, **KW)
        fr, ir = event_step_ref(fs, is_, passes=passes, **KW)
        assert event_step.launches == before + 1
        assert torch.equal(fk.view(torch.int64), fr.view(torch.int64))
        assert torch.equal(ik, ir)
