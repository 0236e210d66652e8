"""Lightweight tracing/profiling spans: the port's `Tracer`.

The API of `mamri_tpu/utils/trace.py` (named spans with wall-clock stats,
`span`, `stats`, `report`, `reset`, the module-level `span` and
`global_tracer`, `device_trace`) on torch: `span(..., sync=True, result=x)`
waits for the card behind `x` (a CUDA synchronization, where the reference
calls `jax.block_until_ready`), so device work is charged to the span that
launched it, and `device_trace` wraps `torch.profiler`.

Beyond the reference, an enabled tracer keeps request-scoped span trees:
each span is a `SpanRecord` (name, start and end on `time.perf_counter_ns`,
its parent's index, a request id). The outermost span opened on a tracer
starts a request, every span inside it shares its id, and `count` adds to a
counter of the open request (kept on its root record) and to a running
total. While that root span is open its tracer is the current one, so
library code that gets no tracer records into it through `current_span` /
`current_count`; outside such a span, or with the tracer disabled, those
return one shared no-op context. While a `torch.profiler` session records,
every enabled span is also a `record_function` event of its name, on the
profiler's own timeline. Records and the durations behind `stats` are kept
in bounded buffers (`MAX_RECORDS` each, the oldest dropped first and counted
in `dropped`). Inside `counts_recorded` the thread's `current_count`s go to
the dict it yields and to no tracer: a CUDA graph capture runs code that
counts what it queues, and each replay of the graph adds what was recorded.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict, deque
from contextvars import ContextVar
from functools import partial
from typing import Deque, Dict, List, NamedTuple, Optional

import torch

MAX_RECORDS = 100_000  # span records, and durations per span name, a tracer keeps


class SpanRecord(NamedTuple):
    index: int  # the span's sequence number on its tracer
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    parent: int  # the enclosing span's index; -1 for a request's root
    request: int  # shared by a root span and every span inside it
    counters: Optional[dict]  # a root's request counters; None on a child

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


_CURRENT: ContextVar[Optional["Tracer"]] = ContextVar("mamri_tpu_torch_current_tracer", default=None)
_RECORDED: ContextVar[Optional[Dict[str, float]]] = ContextVar("mamri_tpu_torch_recorded_counts", default=None)
_NOOP = contextlib.nullcontext()


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


class _Span:
    """One span of an enabled tracer, as a context manager."""

    __slots__ = ("tracer", "name", "result", "index", "parent", "request", "counters", "token", "annotation",
                 "start")

    def __init__(self, tracer: "Tracer", name: str, result):
        self.tracer, self.name, self.result = tracer, name, result

    def __enter__(self):
        t = self.tracer
        stack = t._open_stack()
        self.index = next(t._indices)
        if stack:
            top = stack[-1]
            self.parent, self.request, self.counters, self.token = top.index, top.request, None, None
        else:
            self.parent, self.request, self.counters = -1, next(t._requests), {}
            self.token = _CURRENT.set(t)
        stack.append(self)
        self.annotation = None
        if torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t = self.tracer
        try:
            if self.result is not None:
                _wait_for(self.result)
        finally:
            end = time.perf_counter_ns()
            if self.annotation is not None:
                self.annotation.__exit__(*exc)
            t._open_stack().pop()
            if self.token is not None:
                _CURRENT.reset(self.token)
            t._keep(SpanRecord(self.index, self.name, self.start, end, self.parent, self.request, self.counters))
        return False


class Tracer:
    """Collects named span durations, span records and counters;
    thread-compatible for host-side loops (each thread opens its own
    requests)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.spans: Dict[str, Deque[float]] = defaultdict(partial(deque, maxlen=MAX_RECORDS))
        self.records: Deque[SpanRecord] = deque(maxlen=MAX_RECORDS)
        self.counters: Dict[str, float] = defaultdict(int)  # running totals
        self.dropped = 0  # records dropped from the full buffer
        self._indices = itertools.count()
        self._requests = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def span(self, name: str, sync: bool = False, result=None):
        """A context that times its block as span `name`; `sync=True` with
        `result` waits for the card behind `result` before the span ends."""
        if not self.enabled:
            return _NOOP
        return _Span(self, name, result if sync else None)

    def count(self, name: str, n=1) -> None:
        """Add `n` to counter `name` of the request open on this thread (if
        any) and to its running total."""
        if not self.enabled:
            return
        stack = self._open_stack()
        with self._lock:
            self.counters[name] += n
            if stack:
                root = stack[0].counters
                root[name] = root.get(name, 0) + n

    def _open_stack(self) -> List[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, rec: SpanRecord) -> None:
        with self._lock:
            if len(self.records) == self.records.maxlen:
                self.dropped += 1
            self.records.append(rec)
            self.spans[rec.name].append((rec.end_ns - rec.start_ns) / 1e9)

    def requests(self) -> Dict[int, List[SpanRecord]]:
        """{request id: its records held in the buffer, in the order the
        spans opened (the root first)}; the request's counters are its
        root's `counters`."""
        out: Dict[int, List[SpanRecord]] = defaultdict(list)
        with self._lock:
            for rec in sorted(self.records):
                out[rec.request].append(rec)
        return dict(out)

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
        with self._lock:
            self.spans.clear()
            self.records.clear()
            self.counters.clear()
            self.dropped = 0


_GLOBAL = Tracer()


def span(name: str, **kw):
    """Module-level convenience: `with trace.span("segmentation"): ...`"""
    return _GLOBAL.span(name, **kw)


def global_tracer() -> Tracer:
    return _GLOBAL


def current_span(name: str):
    """Span `name` on the tracer of the request this code runs in (the one
    whose root span is open here), or a shared no-op context."""
    t = _CURRENT.get()
    if t is None or not t.enabled:
        return _NOOP
    return _Span(t, name, None)


def current_count(name: str, n=1) -> None:
    """`count(name, n)` on the tracer of the request this code runs in, or,
    inside `counts_recorded`, into its record."""
    recorded = _RECORDED.get()
    if recorded is not None:
        recorded[name] = recorded.get(name, 0) + n
        return
    t = _CURRENT.get()
    if t is not None and t.enabled:
        t.count(name, n)


@contextlib.contextmanager
def counts_recorded():
    """Within the block, this thread's `current_count`s add to the dict this
    yields and to no tracer (a graph capture's counts)."""
    recorded: Dict[str, float] = {}
    token = _RECORDED.set(recorded)
    try:
        yield recorded
    finally:
        _RECORDED.reset(token)


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
