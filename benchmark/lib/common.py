"""What every cell's run shares: percentiles, the import guard, the card's
description and the program's cache directories."""

from __future__ import annotations

import os
import statistics
import subprocess
import sys

# top-level module names the benchmark's process may never hold: the JAX
# package and JAX itself (the port, `mamri_tpu_torch`, only begins with it)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "mamri_tpu")
PEAK_HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet


def forbidden_modules():
    """Sorted top-level names in `sys.modules` that are forbidden, compared
    whole (the part before the first dot)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN_MODULES))


def percentile(values, q: int) -> float:
    """The q-th percentile, q in 1..99, by `statistics.quantiles(n=100)`
    (the exclusive method); the median for q == 50."""
    values = list(values)
    if q == 50:
        return float(statistics.median(values))
    if len(values) < 2:
        return float(values[0])
    return float(statistics.quantiles(values, n=100)[q - 1])


def set_cache_dirs(root: str) -> None:
    """Fixed cache directories inside the checkout for anything the program
    or torch builds (the port's own kernels build under `build/` there)."""
    base = os.path.join(root, "build", "benchmark_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(base, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))


def card_description():
    """(name, power limit) of GPU 0 as nvidia-smi reads them (limit None
    where nvidia-smi is absent)."""
    import torch

    name = torch.cuda.get_device_name(0)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True)
        return name, out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return name, None

