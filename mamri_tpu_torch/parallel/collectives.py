"""The collectives of one mesh axis: the port's counterpart of `shard_map`
and of the `lax` collectives that `mamri_tpu/parallel/shard_seg.py` uses.

A shard program is an ordinary function of its axis, `fn(axis, *args)`,
that reads `axis.axis_size()` and `axis.axis_index()` and exchanges tensors
through `axis.ppermute`, `axis.all_gather`, `axis.psum` and `axis.pmax`,
with `lax`'s meanings: a `ppermute` target that no pair names receives
zeros, `all_gather` stacks the shards' values in shard order along a new
leading axis, and `psum` / `pmax` give every shard the same reduction.
Two implementations stand behind that interface:

- `ThreadAxis` (run by `run_threads`): the S shard programs are S threads
  of one process. A collective is a write to a shared slot, a
  `threading.Barrier`, every shard's read (a copy, enqueued before anyone
  moves on), and a second barrier. All shards of one card enqueue on its
  one current stream, so a tensor a shard enqueued before the barrier is
  ready for every read enqueued after it. This is the virtual mesh of S
  shards on one card (and, on the CPU, of the tests).
- `DistAxis`: one rank of a `torch.distributed` process group per shard,
  `isend` / `irecv` for `ppermute`, `all_gather` and `all_reduce`. The form
  for a host with several cards.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence, Tuple

import torch


def ring_perms(n_sp: int) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
    """(to the right neighbour, to the left neighbour) source -> target
    pairs of an open ring of `n_sp` shards (`shard_seg.py:75-78`)."""
    fwd = [(i, i + 1) for i in range(n_sp - 1)]
    bwd = [(i + 1, i) for i in range(n_sp - 1)]
    return fwd, bwd


class ThreadAxis:
    """One mesh axis whose shards are threads of this process; see the
    module docstring. `timeout` (seconds) bounds every barrier wait."""

    def __init__(self, size: int, timeout: Optional[float] = None):
        if size < 1:
            raise ValueError(f"axis size must be positive, got {size}")
        self.size = size
        self._barrier = threading.Barrier(size, timeout=timeout)
        self._slots: list = [None] * size
        self._local = threading.local()

    def axis_size(self) -> int:
        return self.size

    def axis_index(self) -> int:
        try:
            return self._local.index
        except AttributeError:
            raise RuntimeError("ThreadAxis collectives run only inside the shard threads of run_threads") from None

    def abort(self) -> None:
        """Break the barrier: every shard waiting in a collective, or
        reaching one later, raises `threading.BrokenBarrierError`."""
        self._barrier.abort()

    def _exchange(self, value, read):
        """Publish `value`, then `read(list of every shard's value)` before
        any shard may publish again; the result must not alias the slots."""
        self._slots[self.axis_index()] = value
        self._barrier.wait()
        out = read(list(self._slots))
        self._barrier.wait()
        return out

    def ppermute(self, x, perm: Sequence[Tuple[int, int]]):
        me = self.axis_index()
        src = [s for s, d in perm if d == me]
        if len(src) > 1:
            raise ValueError(f"ppermute: shard {me} is the target of {src}")
        return self._exchange(x, lambda vals: vals[src[0]].to(x.device, copy=True) if src else torch.zeros_like(x))

    def all_gather(self, x):
        return self._exchange(x, lambda vals: torch.stack([v.to(x.device) for v in vals]))

    def psum(self, x):
        return self._exchange(x, lambda vals: torch.stack([v.to(x.device) for v in vals]).sum(0, dtype=x.dtype))

    def pmax(self, x):
        return self._exchange(x, lambda vals: torch.stack([v.to(x.device) for v in vals]).amax(0))


def run_threads(fn: Callable, args_per_shard: Sequence[tuple], devices: Optional[Sequence] = None,
                timeout: Optional[float] = None) -> list:
    """Run `fn(axis, *args_per_shard[i])` for every shard i on a fresh
    `ThreadAxis`, each in its own thread (on `devices[i]` as the current
    CUDA device where it is a card), and return the results in shard order.

    The CUDA kernels are built (or loaded) before the first thread starts,
    so no two shards race a first-use build. An exception in one shard
    breaks the barrier, so every other shard leaves its collective; the
    first shard's own exception is raised here."""
    size = len(args_per_shard)
    devices = [torch.device("cpu")] * size if devices is None else [torch.device(d) for d in devices]
    if len(devices) != size:
        raise ValueError(f"run_threads: {size} shards, {len(devices)} devices")
    if any(d.type == "cuda" for d in devices):
        from mamri_tpu_torch import _build

        _build.library()
    axis = ThreadAxis(size, timeout=timeout)
    results: list = [None] * size
    errors: list = [None] * size

    def work(i):
        axis._local.index = i
        try:
            if devices[i].type == "cuda":
                with torch.cuda.device(devices[i]):
                    results[i] = fn(axis, *args_per_shard[i])
            else:
                results[i] = fn(axis, *args_per_shard[i])
        except BaseException as exc:  # noqa: BLE001 - handed to the caller below
            errors[i] = exc
            axis.abort()

    threads = [threading.Thread(target=work, args=(i,), name=f"shard-{i}", daemon=True) for i in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    raised = [e for e in errors if e is not None]
    if raised:  # the first shard's own error, not a barrier it broke
        raise next((e for e in raised if not isinstance(e, threading.BrokenBarrierError)), raised[0])
    return results


class DistAxis:
    """One mesh axis over a `torch.distributed` process group: this process
    is shard `group rank`. Tensors stay on the caller's device (a card with
    NCCL, the CPU with gloo); booleans travel as uint8."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self._dist = dist
        self.group = group

    def axis_size(self) -> int:
        return self._dist.get_world_size(self.group)

    def axis_index(self) -> int:
        return self._dist.get_rank(self.group)

    def _global(self, rank: int) -> int:
        return rank if self.group is None else self._dist.get_global_rank(self.group, rank)

    @staticmethod
    def _wire(x):
        return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()

    def ppermute(self, x, perm: Sequence[Tuple[int, int]]):
        me = self.axis_index()
        wire = self._wire(x)
        out = torch.zeros_like(wire)
        ops = []
        for s, d in perm:
            if s == me:
                ops.append(self._dist.P2POp(self._dist.isend, wire, self._global(d), self.group))
            if d == me:
                ops.append(self._dist.P2POp(self._dist.irecv, out, self._global(s), self.group))
        if ops:
            for req in self._dist.batch_isend_irecv(ops):
                req.wait()
        return out.to(x.dtype)

    def all_gather(self, x):
        wire = self._wire(x)
        parts = [torch.empty_like(wire) for _ in range(self.axis_size())]
        self._dist.all_gather(parts, wire, group=self.group)
        return torch.stack(parts).to(x.dtype)

    def _all_reduce(self, x, op):
        y = self._wire(x).clone()
        self._dist.all_reduce(y, op=op, group=self.group)
        return y.to(x.dtype)

    def psum(self, x):
        return self._all_reduce(x, self._dist.ReduceOp.SUM)

    def pmax(self, x):
        return self._all_reduce(x, self._dist.ReduceOp.MAX)
