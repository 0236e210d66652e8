"""Lightweight tracing/profiling spans: the port's `Tracer`.

The API of `mamri_tpu/utils/trace.py` (named spans with wall-clock stats,
`span`, `stats`, `report`, `reset`, the module-level `span` and
`global_tracer`, `device_trace`) on torch: `span(..., sync=True, result=x)`
waits for the card behind `x` (a CUDA synchronization, where the reference
calls `jax.block_until_ready`), so device work is charged to the span that
launched it, and `device_trace` wraps `torch.profiler`.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch


def _wait_for(result) -> None:
    """Wait for the device behind every tensor in `result` (a tensor or a
    nested list / tuple / dict / NamedTuple of them)."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _wait_for(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _wait_for(v)


class Tracer:
    """Collects named span durations; thread-compatible for host-side loops."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.spans: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False, result=None):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and result is not None:
                _wait_for(result)
            self.spans[name].append(time.perf_counter() - t0)

    def stats(self, name: str) -> Dict[str, float]:
        xs = sorted(self.spans.get(name, []))
        if not xs:
            return {}
        n = len(xs)
        return {
            "count": n,
            "total_s": sum(xs),
            "mean_s": sum(xs) / n,
            "p50_s": xs[n // 2],
            "min_s": xs[0],
            "max_s": xs[-1],
        }

    def report(self) -> str:
        lines = []
        for name in sorted(self.spans):
            s = self.stats(name)
            lines.append(
                f"{name:32s} n={s['count']:<5d} p50={s['p50_s']*1e3:8.2f}ms "
                f"mean={s['mean_s']*1e3:8.2f}ms max={s['max_s']*1e3:8.2f}ms"
            )
        return "\n".join(lines)

    def reset(self):
        self.spans.clear()


_GLOBAL = Tracer()


def span(name: str, **kw):
    """Module-level convenience: `with trace.span("segmentation"): ...`"""
    return _GLOBAL.span(name, **kw)


def global_tracer() -> Tracer:
    return _GLOBAL


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Wrap a block in a `torch.profiler` session (host ops, and the card's
    kernels where there is one) and write its Chrome trace into `log_dir`."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
