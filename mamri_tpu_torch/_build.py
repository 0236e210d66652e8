"""Build and load the CUDA kernels in `csrc/` at first use.

`nvcc` compiles every `csrc/*.cu` for sm_90a (one process per source, all
started together) and links them into one shared library with a plain C
interface, bound here with ctypes (no PyTorch headers, so a build takes
seconds). The library lands in `build/mamri_tpu_torch/<hash>/` beside
the package, keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is loaded as it is. Nothing is built or
loaded on import: the first wrapper that launches a kernel calls `library()`.

It is also the one seam every kernel wrapper (`perception/gpu_ops.py`,
`ik/fused_lm.py`, `registration/kabsch.py`) goes through: `on_cuda` picks
the kernel or the plain twin from the tensors' device, `check` holds a
tensor to what a C entry reads, and `launch` calls an entry on the current
stream of the inputs' device, raises on a CUDA error and adds one to the
kernel's count in `LAUNCHES`. The counts are taken under a lock, since the
shards of `parallel.shard_seg` launch from threads of their own. Under a
CUDA graph capture a launch is queued into the graph and runs only when the
graph is replayed: `launches_recorded` collects the capture's launches apart
from `LAUNCHES`, and each replay adds them (`add_launches`), so the counts
stay those of launches that ran.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from contextvars import ContextVar
from typing import Dict, Optional

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "mamri_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # name: argument types (every entry takes the stream last, returns cudaError_t)
    "mamri_close_init": [_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, ctypes.c_float, _I, _I],
    "mamri_reset_distances": [_P, _P, _P, _I, _I, _I, _I],
    "mamri_run_min": [_P, _P, _P, _I, _I, _I, _I, _P],
    "mamri_check": [_P, _P, _I, _I, _I, _I, _P],
    "mamri_z_runs": [_P, _P, _P, _P, _P, _P, _P, _P] + [_I] * 9,
    "mamri_run_stats": [_P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _P, _I, _P, _P],
    "mamri_scan_lines": [_P, _P, _P, ctypes.c_longlong, _I],
    "mamri_root_candidates": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I],
    "mamri_component_stats": [_P, ctypes.c_longlong, _P, _I, _I, _I, _I, _I, _P, _P],
    "mamri_noop": [_I],
    "mamri_full_chain_lm": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _F, _F, _F,
                            _F, _P, _P, _P, _P],
    "mamri_kabsch": [_P, _P, ctypes.c_longlong, _I, _P],
}

# kernel launches by wrapper name, so a run can show which kernels it went through
LAUNCHES = dict.fromkeys(
    ("close_init", "reset_distances", "run_min", "check", "z_runs", "run_stats", "run_stats_compact", "scan_lines",
     "root_candidates", "component_stats_xyz", "component_stats_raster", "full_chain_lm", "kabsch"), 0)
_LAUNCHES_LOCK = threading.Lock()
# the launches of the capture open in this thread, if one is
_RECORDED: ContextVar[Optional[Dict[str, int]]] = ContextVar("mamri_tpu_torch_recorded_launches", default=None)

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


def reset_launch_counts() -> None:
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


@contextlib.contextmanager
def launches_recorded():
    """Within the block, a launch of this thread adds one to its name in the
    dict this yields and not to `LAUNCHES` (a graph capture's launches)."""
    recorded: Dict[str, int] = {}
    token = _RECORDED.set(recorded)
    try:
        yield recorded
    finally:
        _RECORDED.reset(token)


def add_launches(counts: Dict[str, int]) -> None:
    """Add `counts` ({name: launches}) to `LAUNCHES`: a replay of the graph
    whose capture recorded them."""
    with _LAUNCHES_LOCK:
        for name, n in counts.items():
            LAUNCHES[name] += n


def on_cuda(*tensors) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (the
    twin); anything else, or a mix of devices, is an error."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"tensors on different devices: {[str(t.device) for t in tensors]}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def check(t, name, dtype, shape=None) -> None:
    """`t` must be `dtype`, of `shape` where one is given, and contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def launch(name: str, entry: str, device, *args) -> None:
    """Call the C entry `entry` with `args` on the current stream of
    `device`, the inputs' card; a CUDA error is raised as `name`'s, and a
    launch adds one to `LAUNCHES[name]`."""
    lib = library()
    err = getattr(lib, entry)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} ({lib.mamri_error_string(err).decode()})")
    recorded = _RECORDED.get()
    if recorded is not None:
        recorded[name] = recorded.get(name, 0) + 1
        return
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1
