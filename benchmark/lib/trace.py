"""Reading the card: a `torch.profiler` timeline of a few calls of a cell's
entry (device ops, busy and idle time, the breakdown), and CUDA-event times
of one stage with the host's enqueue and the L2 kept out of them.

The timeline is kept in memory and reduced here; nothing is written out.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import numpy as np

WINDOW_LABEL = "benchmark.traced_window"
SPIN_CYCLES = 40_000_000  # ~24 ms at 1.7 GHz: longer than the host takes to enqueue a segmentation
FLUSH_BYTES = 128 << 20  # over twice the H100's 50 MB L2
PROFILE_TRIES = 3


def _merge(intervals):
    """Sorted, disjoint union of (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_op_at(cpu, starts, t):
    """The innermost host op running at time `t` (not a CUDA runtime call),
    or "host (no op)"."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 200, -1), -1):
        s, e, name = cpu[j]
        if e >= t:
            return name
    return "host (no op)"


def profile(fn, calls: int):
    """Run `fn()` `calls` times under torch.profiler (CPU and CUDA), synchronised
    at both ends. -> {calls, device_ops, busy_s, window_s, breakdown}, or
    None without device activity. A session that recorded no device activity (which
    torch.profiler has returned now and then) is profiled again."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    for _ in range(PROFILE_TRIES if cuda else 1):
        sync()
        with torch_profile(activities=activities) as prof:
            with torch.profiler.record_function(WINDOW_LABEL):
                for _ in range(calls):
                    fn()
                sync()
        events = prof.profiler.kineto_results.events()
        # the window's own label comes back on the device's timeline too: not an op
        dev = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in events
               if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()
               and e.name() != WINDOW_LABEL]
        if dev:
            break
    else:
        return None
    win = next(e for e in events if e.name() == WINDOW_LABEL)
    w0, w1 = win.start_ns(), win.start_ns() + win.duration_ns()
    busy = _merge((max(s, w0), min(e, w1)) for s, e, _ in dev if e > w0 and s < w1)
    busy_ns = sum(e - s for s, e in busy)
    by_name = defaultdict(float)
    for s, e, name in dev:
        by_name[name[:name.rfind("(")] if name.endswith(")") else name] += (e - s) / 1e9  # without its signature
    cpu = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in events
                 if e.device_type() == torch.autograd.DeviceType.CPU and e.name() != WINDOW_LABEL
                 and e.start_thread_id() == win.start_thread_id() and not e.name().startswith("cuda"))
    starts = [c[0] for c in cpu]
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            gaps[_host_op_at(cpu, starts, (s + e) // 2)] += (e - s) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    facts = {
        "calls": calls,
        "device_ops": len(dev),
        "busy_s": busy_ns / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "breakdown": {"device_ops": top(by_name), "idle_gaps": top(gaps)},
    }
    return facts


class StageTimer:
    """CUDA-event times of one call each: the L2 flushed by a 128 MB read
    (a write would leave dirty lines for the timed call to write back), and
    the call queued behind a spin kernel, so that the start event fires
    when the card reaches the call, not while the host is still issuing
    it."""

    def __init__(self):
        import torch

        self.torch = torch
        self.flush_src = torch.ones(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
        self.flush_dst = torch.empty((), dtype=torch.float32, device="cuda")

    def ms(self, fn, reps: int):
        torch = self.torch
        fn()  # warm
        times = []
        for _ in range(reps):
            torch.sum(self.flush_src, dim=0, out=self.flush_dst)
            torch.cuda._sleep(SPIN_CYCLES)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))


def host_ms(fn, reps: int, sync) -> float:
    """Median host-clock ms of `fn()` followed by `sync()`, after one warm call."""
    fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))
