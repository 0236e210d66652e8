"""Build and load the CUDA kernels in `csrc/` at first use.

`nvcc` compiles every `csrc/*.cu` for sm_90a into one shared library with a
plain C interface, bound here with ctypes (no PyTorch headers, so a build
takes seconds). The library lands in `build/mamri_tpu_torch/<hash>/` beside
the package, keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is loaded as it is. Nothing is built or
loaded on import: the first wrapper that launches a kernel calls `library()`.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "mamri_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # name: argument types (every entry takes the stream last, returns cudaError_t)
    "mamri_close_init": [_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, ctypes.c_float],
    "mamri_reset_distances": [_P, _P, _P, _I, _I, _I, _I],
    "mamri_run_min": [_P, _P, _P, _I, _I, _I, _I, _P],
    "mamri_check": [_P, _P, _I, _I, _I, _I, _P],
    "mamri_z_runs": [_P, _P, _P, _P, _P, _P, _P, _P] + [_I] * 9,
    "mamri_run_stats": [_P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _P, _I, _P, _P],
}

# what the last build in this process took and printed (read by chip_smoke.py)
last_build = {"seconds": 0.0, "log": "", "path": ""}


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")) + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], "libmamri_kernels.so")


def _build(so_path: str) -> None:
    os.makedirs(os.path.dirname(so_path), exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(s for s in _sources() if s.endswith(".cu"))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    last_build["seconds"] = time.perf_counter() - t0
    last_build["log"] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{last_build['log']}")
    os.replace(tmp, so_path)  # atomic: a concurrent loader sees all or nothing


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has none."""
    so_path = _library_path()
    if not os.path.exists(so_path):
        _build(so_path)
    last_build["path"] = so_path
    lib = ctypes.CDLL(so_path)
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args + [_P]
        fn.restype = _I
    lib.mamri_error_string.argtypes = [_I]
    lib.mamri_error_string.restype = ctypes.c_char_p
    return lib
