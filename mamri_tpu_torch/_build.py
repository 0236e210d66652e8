"""Build and load the CUDA kernels in `csrc/` at first use.

`nvcc` compiles every `csrc/*.cu` for sm_90a (one process per source, all
started together) and links them into one shared library with a plain C
interface, bound here with ctypes (no PyTorch headers, so a build takes
seconds). The library lands in `build/mamri_tpu_torch/<hash>/` beside
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
    "mamri_scan_lines": [_P, _P, _P, ctypes.c_longlong, _I],
    "mamri_root_candidates": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I],
    "mamri_component_stats": [_P, ctypes.c_longlong, _P, _I, _I, _I, _I, _I, _P, _P],
    "mamri_noop": [_I],
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


def _run_all(cmds):
    """Run the commands side by side; (return codes, combined output)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [p.returncode for p in procs], "".join(outs)


def _build(so_path: str) -> None:
    """One nvcc per source, all started together, then one link."""
    out_dir = os.path.dirname(so_path)
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs, cmds = [], []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = os.path.join(out_dir, f"{os.path.basename(src)}.{tag}.o")
        objs.append(obj)
        cmds.append([nvcc, *compile_flags, "-c", "-o", obj, src])
    t0 = time.perf_counter()
    rcs, log = _run_all(cmds)
    if not any(rcs):
        link_rcs, link_log = _run_all([[nvcc, *NVCC_FLAGS, "-o", f"{so_path}.{tag}", *objs]])
        rcs, log = rcs + link_rcs, log + link_log
    last_build["seconds"] = time.perf_counter() - t0
    last_build["log"] = log
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if any(rcs):
        raise RuntimeError(f"nvcc failed ({rcs}):\n{log}")
    os.replace(f"{so_path}.{tag}", so_path)  # atomic: a concurrent loader sees all or nothing


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
