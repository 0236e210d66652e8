"""One cell's context (its configuration, workload file, seed and device)
and what the drivers share: the engine built from the configuration, the
configuration's grid and scans, and the closed loop of one client."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from benchmark.lib import scenes as S
from benchmark.lib.arm import Arm


@dataclass
class Cell:
    name: str
    config: dict  # benchmark/configs/<config>.json
    workload: dict  # benchmark/workloads/<cell>.json
    seed: int
    device: str = "cuda"

    def rng(self, stream: int) -> np.random.Generator:
        """An independent generator for one use of the seed."""
        return np.random.default_rng([stream, self.seed])

    @property
    def params(self) -> dict:
        return self.workload["params"]


@dataclass
class Run:
    """A driver's state: the engine, the inputs and what the window did."""

    cell: Cell
    engine: object = None
    records: list = field(default_factory=list)
    latencies_ms: list = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    elapsed_s: float = 0.0
    facts: dict = field(default_factory=dict)
    data: dict = field(default_factory=dict)
    phases: list = field(default_factory=list)  # (set-up step, host clock at its end)

    def mark(self, step: str) -> None:
        self.phases.append((step, time.perf_counter()))

    def sync(self) -> None:
        if self.cell.device == "cuda":
            import torch

            torch.cuda.synchronize()


def make_engine(cell: Cell):
    """The program under test, at the configuration's engine settings."""
    from mamri_tpu_torch.api.engine import MamriEngine
    from mamri_tpu_torch.perception.segmentation import SegmentationParams

    eng = cell.config["engine"]
    return MamriEngine(seg_params=SegmentationParams(**cell.config["segmentation"], **eng["seg_budget"]),
                       ik_iters=eng["ik_iters"], ik_restarts=eng["ik_restarts"], match_mode=eng["match_mode"],
                       device=cell.device)


def bench_grid(cell: Cell):
    """(arm, bench scenes, spacing, origin) of the configuration's grid."""
    arm = Arm()
    scenes, box = S.bench_scenes(arm)
    spacing, origin = S.grid(box, cell.config["grid"], cell.config["cube_size"])
    return arm, scenes, spacing, origin


def render_host(cell: Cell, scene_list, spacing, origin) -> list:
    """Each scene's scan at the configuration's grid and dtype, rendered on
    the cell's device and copied to host memory once."""
    import torch

    dtype = getattr(torch, cell.config["dtype"])
    return [S.render(s.markers, tuple(cell.config["grid"]), spacing, origin, cell.device, dtype).cpu().numpy()
            for s in scene_list]


def reset_peak(cell: Cell) -> None:
    """Start the device's memory peak at what the program holds from here."""
    if cell.device == "cuda":
        import torch

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def closed_loop(run: Run, seconds: float, request) -> None:
    """One client: `request(i)` after `request(i - 1)` returned, from the
    window's start until `seconds` have passed; `request` returns the
    host-clock seconds of its timed part. `elapsed_s` runs to the end of the
    last request."""
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        run.latencies_ms.append(request(i) * 1e3)
        i += 1
    run.elapsed_s = time.perf_counter() - t0


def latency_metrics(run: Run, name: str) -> dict:
    """{name.p50, name.p90}: the median and 90th percentile of every call."""
    from benchmark.lib.common import percentile

    return {f"{name}.p50": percentile(run.latencies_ms, 50), f"{name}.p90": percentile(run.latencies_ms, 90)}


def free(run: Run) -> None:
    """Drop the program's state before the reference runs."""
    run.engine = None
    run.data.pop("tracker", None)
    if run.cell.device == "cuda":
        import torch

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
