"""The program's own spans and counters on the scan -> pose path, read once
per traced run and kept in `run.facts["program_spans"]` for the readers of
the per-layer metrics that use them.

Two passes over the cell's own traffic, each of the workload's
`trace_calls` calls (the pose cell: `estimate_pose` of the next scene of the
seeded order from a fresh host buffer; the stream cell: `PoseTracker.step`
on the next frame):

1. with a fresh enabled `Tracer` on the engine and no profiler: each
   `estimate_pose` request's span tree and counters give the host times
   (medians over the requests);
2. under `torch.profiler` (CPU and CUDA): the spans are `record_function`
   events on the profiler's timeline, and each device op (kernel, copy,
   memset) is charged to the spans around the CUDA runtime call that
   launched it; the device's idle time is split by the spans it falls in.

The engine's previous tracer is put back afterwards. One stderr line gives
the whole split by span. A program without these spans (no
`Tracer.requests`) gives no facts, and its readers give no value.
"""

from __future__ import annotations

import bisect
import json
import statistics
import sys
from collections import defaultdict

import numpy as np

from benchmark.lib.trace import PROFILE_TRIES, _merge

KEY = "program_spans"
WINDOW_LABEL = "benchmark.program_spans_window"
ROOT = "estimate_pose"
SPANS = ("pose.upload", "pose.segment", "pose.ik", "ik.lm.jacobian", "pose.fetch")


def facts(run) -> dict:
    """{"host": {...}, "device": {...} or None}, or {} where the program or
    the cell has no such spans; read on first use."""
    if KEY not in run.facts:
        run.facts[KEY] = _read(run)
    return run.facts[KEY]


def host(run, key: str):
    return facts(run).get("host", {}).get(key)


def device(run, key: str, span: str):
    """Pass 2's `key` ("ops" or "idle_pct") of span `span`, or None."""
    return ((facts(run).get("device") or {}).get(key) or {}).get(span)


def _call(run):
    """One call of the cell's own traffic, made as its timed calls are."""
    from mamri_tpu_torch.perception.volume import Volume

    d = run.data
    tracker = d.get("tracker")

    def call():
        if tracker is not None:
            f = d["order"][d["pos"] % len(d["order"])]
            d["pos"] += 1
        else:
            k = d.setdefault("spans_pos", 0)
            f = d["order"][k % len(d["order"])]
            d["spans_pos"] = k + 1
        np.copyto(d["buffer"], d["scans"][f])
        vol = Volume(data=d["buffer"], spacing=d["spacing"], origin=d["origin"])
        return tracker.step(vol) if tracker is not None else run.engine.estimate_pose(vol)

    return call


def _read(run) -> dict:
    from mamri_tpu_torch.utils import trace as T

    if not hasattr(T.Tracer, "requests"):
        return {}
    call, n, eng = _call(run), run.cell.params["trace_calls"], run.engine
    kept = eng.tracer
    try:
        eng.tracer = T.Tracer()
        for _ in range(n):
            call()
        medians, requests = _host_split(eng.tracer)
        eng.tracer = T.Tracer()
        dev = _device_split(call, n, eng.tracer, run.cell.device == "cuda")
    finally:
        eng.tracer = kept
    print("program spans: " + json.dumps({"requests": requests, "host": medians, "device": dev}), file=sys.stderr)
    return {"host": medians, "device": dev}


def _host_split(tracer):
    """(medians over the `estimate_pose` requests of their spans' host ms,
    upload GB/s and attempts, the number of requests)."""
    per = defaultdict(list)
    for recs in tracer.requests().values():
        root = recs[0]
        if root.name != ROOT or root.parent != -1:
            continue
        kids = [r for r in recs if r.parent == root.index]
        per[ROOT].append(root.ms)
        per["self"].append(root.ms - sum(r.ms for r in kids))
        for name in SPANS:
            per[name].append(sum(r.ms for r in recs if r.name == name))
        upload_ns = sum(r.end_ns - r.start_ns for r in recs if r.name == "pose.upload")
        if upload_ns:
            per["upload_gbps"].append(root.counters.get("pose.upload_bytes", 0) / upload_ns)  # bytes/ns = GB/s
        per["attempts"].append(root.counters.get("pose.attempts", 0))
    return {k: float(statistics.median(v)) for k, v in per.items() if v}, len(per[ROOT])


def _device_split(call, n: int, tracer, cuda: bool):
    """Device ops and device-idle ms per request inside each span, from a
    torch.profiler session of `n` calls; None without device activity."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    if not cuda:
        return None
    labels = {WINDOW_LABEL, ROOT, *SPANS}
    for _ in range(PROFILE_TRIES):
        tracer.reset()
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(WINDOW_LABEL):
                for _ in range(n):
                    call()
                torch.cuda.synchronize()
        events = prof.profiler.kineto_results.events()
        dev = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation() and e.name() not in labels]
        if dev:
            break
    else:
        return None
    win = next(e for e in events if e.name() == WINDOW_LABEL and e.device_type() == torch.autograd.DeviceType.CPU)
    w0, w1, tid = win.start_ns(), win.start_ns() + win.duration_ns(), win.start_thread_id()
    cpu = [e for e in events if e.device_type() == torch.autograd.DeviceType.CPU and e.start_thread_id() == tid]
    spans = defaultdict(list)
    for e in cpu:
        if e.name() in labels and e.name() != WINDOW_LABEL:
            spans[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    calls = len(spans[ROOT])
    if not calls:
        return None
    # a device op's launching runtime call (cudaLaunchKernel, cudaMemcpyAsync, ...) shares its correlation id
    runtime = {e.correlation_id(): e.start_ns() for e in cpu if e.name().startswith("cu")}
    launched = [runtime.get(e.correlation_id()) for e in dev]
    joined = [t for t in launched if t is not None]
    busy = _merge((max(e.start_ns(), w0), min(e.start_ns() + e.duration_ns(), w1)) for e in dev
                  if e.start_ns() + e.duration_ns() > w0 and e.start_ns() < w1)
    idle = _complement(busy, w0, w1)
    idle_ns = sum(e - s for s, e in idle)
    ops, idle_ms, idle_pct = {}, {}, {}
    for name in (ROOT,) + SPANS:
        ivs = _merge(spans[name])
        starts = [s for s, _ in ivs]
        ops[name] = sum(_inside(ivs, starts, t) for t in joined) / calls
        inside = _overlap(idle, ivs)
        idle_ms[name] = inside / 1e6 / calls
        idle_pct[name] = 100.0 * inside / idle_ns if idle_ns else None
    return {"calls": calls, "device_ops": len(dev) / calls, "joined_ops": len(joined) / calls,
            "window_idle_pct": 100.0 * idle_ns / (w1 - w0), "ops": ops, "idle_ms": idle_ms, "idle_pct": idle_pct}


def _complement(busy, w0: int, w1: int) -> list:
    """The parts of [w0, w1] outside the sorted, disjoint `busy` intervals."""
    out, t = [], w0
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if w1 > t:
        out.append((t, w1))
    return out


def _overlap(a, b) -> int:
    """Length of the intersection of two sorted, disjoint interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, e - s)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _inside(ivs, starts, t: int) -> bool:
    """Whether `t` lies in one of the sorted, disjoint intervals `ivs`
    (`starts` their starts)."""
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= ivs[i][1]
