"""Build a CUDA kernel source of the port with nvcc and load it with ctypes.

A source ``csrc/<name>.cu`` exposes a plain C entry point and is compiled
on first use into ``build/repro_torch/`` at the root of the checkout
(listed in ``.gitignore``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -o <name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded.  Nothing here falls
back: a missing nvcc or a failed compile raises.  The wrapper of each
kernel declares its entry point's C signature.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "build", "load", "nvcc_path",
           "ptx"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (set CUDA_HOME)")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{tag[:16]}.so"


def build(name: str) -> dict:
    """Compile one source unless it is built already.

    Returns ``{"path", "seconds", "log"}``; ``log`` holds nvcc's
    ``-Xptxas -v`` report (registers, spills) when it was built now.
    """
    lib = _lib_path(name)
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-shared", "-Xcompiler", "-fPIC",
         "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    os.replace(tmp, lib)
    return {"path": str(lib), "seconds": time.perf_counter() - t0,
            "log": proc.stdout}


def ptx(name: str) -> str:
    """The PTX nvcc emits for a source under the build flags (for checks
    such as "no fma.rn.f64 on the bitwise path")."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    dst = BUILD_DIR / f"{name}.{os.getpid()}.ptx"
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    flags[flags.index("arch=compute_90a,code=sm_90a")] = \
        "arch=compute_90a,code=compute_90a"
    subprocess.run([nvcc_path(), *flags, "-ptx", "-o", str(dst),
                    str(CSRC / f"{name}.cu")], check=True,
                   capture_output=True, text=True)
    try:
        return dst.read_text()
    finally:
        dst.unlink()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(build(name)["path"])
    return lib
