"""Device meshes and the mesh-batched pose pipeline.

Port of `mamri_tpu/parallel/mesh.py`. A batch of volumes scales along the
two axes the workload has:

  dp - data parallel over volumes: the batch splits into dp rows of the
       mesh; the rows run one after another on the engine's stream (the
       reference's devices run them side by side).
  sp - spatial parallel over a volume's x extent: the segmentation of each
       volume runs as `segment_volume_sharded` on the sp shards of its row,
       one shard thread each on a `ThreadAxis` (`parallel/shard_seg.py`),
       and the shards' whole-volume stats feed the rest of the pipeline
       once, in the caller (matching, Kabsch and IK are not repeated S
       times).

`make_mesh` takes the CUDA devices by default and fails loudly when there
are fewer than asked for. A mesh that repeats a device (S shards on one
card, or the CPU in the tests) is the port's virtual mesh, as XLA's host
device count is the reference's: it is built only from an explicit
`devices=` list. Nothing falls back quietly.
"""

from __future__ import annotations

import logging
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

_OUT_KEYS = (
    "success", "angles", "steps", "rmse", "base_tf", "base_ok", "base_source",
    "markers_found", "num_blobs", "body_found", "num_components",
    "seg_converged", "roots_complete", "blobs_complete",
    "seg_count_ok", "seg_cand_ok", "seg_runs_ok", "seg_compact_ok",
)


class Mesh:
    """An n-d grid of `torch.device`s with named axes (the port's
    `jax.sharding.Mesh`): `devices` an object array, `shape` {axis: size}."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"a {devices.ndim}-d device grid needs {devices.ndim} axis names, got {axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(
    n_devices: Optional[int] = None,
    axes: Tuple[str, ...] = ("dp",),
    shape: Optional[Tuple[int, ...]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A mesh over the first n devices. With two axes and no explicit shape,
    the devices split evenly, favouring dp. Without `devices` it takes the
    CUDA devices and fails loudly when there are fewer than n: a virtual
    mesh must name its devices (e.g. `[torch.device("cuda")] * 4`)."""
    given = devices is not None
    if given:
        devices = [torch.device(d) for d in devices]
    else:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(count)]
    n = len(devices) if n_devices is None else n_devices
    if n < 1 or len(devices) < n:
        need = max(n, 1)
        if given:
            raise ValueError(f"need {need} devices, have {len(devices)} in `devices`")
        raise ValueError(
            f"need {need} devices, have {len(devices)} on platform 'cuda'. For "
            "virtual multi-device validation, name the devices explicitly (devices="
            f"[torch.device('cuda')] * {need} puts {need} shards on one card, "
            f"[torch.device('cpu')] * {need} on the CPU)."
        )
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    if shape is None:
        if len(axes) == 1:
            shape = (n,)
        elif len(axes) == 2:
            dp = 1
            for cand in range(int(np.sqrt(n)), 0, -1):
                if n % cand == 0:
                    dp = cand
                    break
            shape = (dp, n // dp)
        else:
            raise ValueError("give an explicit shape for >2 mesh axes")
    return Mesh(grid.reshape(shape), axes)


class BatchSharding(NamedTuple):
    """How a (B, nx, ny, nz) batch lies on a mesh: volumes over `dp_axis`
    (contiguous rows of B / dp volumes), and each volume's x extent over
    `sp_axis` when it is given."""

    mesh: Mesh
    dp_axis: str
    sp_axis: Optional[str]

    def row_devices(self, row: int) -> list:
        """The devices of dp row `row`, one per sp shard (one without sp)."""
        names = self.mesh.axis_names
        axes = [names.index(self.dp_axis)] + ([names.index(self.sp_axis)] if self.sp_axis else [])
        grid = np.moveaxis(self.mesh.devices, axes, list(range(len(axes))))
        grid = grid.reshape(grid.shape[:len(axes)] + (-1,))[..., 0]  # any other axis: its first slice
        return list(np.atleast_1d(grid[row]))


def batch_sharding(mesh: Mesh, dp_axis: str = "dp", sp_axis: Optional[str] = None) -> BatchSharding:
    """Sharding of a (B, nx, ny, nz) volume batch: the batch over dp,
    optionally the volumes' x extent over sp."""
    return BatchSharding(mesh, dp_axis, sp_axis)


def _on_device(seg, device):
    return seg._replace(**{f: getattr(seg, f).to(device) for f in seg._fields})


def sharded_batched_pipeline(
    engine,
    mesh: Mesh,
    dp_axis: str = "dp",
    sp_axis: Optional[str] = None,
    seg_params=None,
    microbatch: Optional[int] = None,
):
    """The engine's per-volume pipeline over a mesh batch.

    Returns fn(data_batch, spacing, origin, apply_correction) -> {key of
    `_OUT_KEYS`: (B, ...) host array}. The batch size must be a multiple of
    the dp extent (and nx of the sp extent when spatial sharding is on).
    `seg_params` overrides the engine's segmentation settings (the
    escalation loop `run_sharded_batched` rebuilds with stronger ones).

    `microbatch` bounds the device workspace as `estimate_pose_batch`'s
    does: the batch runs in `microbatch`-volume chunks, each uploaded,
    run and fetched before the next. It must be a multiple of the dp extent
    and divide the batch size.

    dp only: `pipeline_fn` as it is. dp x sp: `pipeline_fn(seg_fn=...)` with
    the sharded segmentation of the volume's row (`shard_seg.py`)."""
    from mamri_tpu_torch.parallel.shard_seg import segment_volume_threads

    nj = engine.model.num_joints
    dp = mesh.shape[dp_axis]
    if microbatch is not None and (microbatch < 1 or microbatch % dp):
        raise ValueError(
            f"microbatch {microbatch} must be a positive multiple of the dp extent {dp}"
        )
    sharding = batch_sharding(mesh, dp_axis, sp_axis)
    params = seg_params if seg_params is not None else engine.seg_params
    sp = mesh.shape[sp_axis] if sp_axis is not None else 1

    def seg_on(devices):
        def seg_fn(data, spacing, origin, p):
            seg = segment_volume_threads(data, spacing, origin, p, devices=devices)
            return _on_device(seg, engine.device)

        return seg_fn

    if sp_axis is None:
        pipelines = [engine.pipeline_fn(params)] * dp
    else:
        pipelines = [engine.pipeline_fn(params, seg_fn=seg_on(sharding.row_devices(i))) for i in range(dp)]

    def batched(data_batch, spacing, origin, apply_correction):
        b = int(data_batch.shape[0])
        if b % dp:
            raise ValueError(f"batch {b} must be a multiple of the dp extent {dp}")
        if int(data_batch.shape[1]) % sp:
            raise ValueError(f"volume x extent {int(data_batch.shape[1])} must be a multiple of the sp extent {sp}")
        step = b
        if microbatch is not None and microbatch < b:
            if b % microbatch:
                if sp_axis is None:
                    raise ValueError(f"microbatch {microbatch} must divide batch {b}")
                raise ValueError(
                    f"microbatch {microbatch} must divide the local batch {b // dp} (x dp {dp})"
                )
            step = microbatch
        f32 = torch.float32
        fixed = (
            engine._upload(spacing, f32),
            engine._upload(origin, f32),
            engine._upload(np.eye(4, dtype=np.float32)),
            engine._upload(False),
            engine._upload(False),
            engine._upload(bool(apply_correction)),
            engine._upload(np.zeros(nj, dtype=np.float32)),
        )
        per_row = b // dp
        parts = []
        for start in range(0, b, step):
            chunk = engine._upload(data_batch[start:start + step])
            outs = []
            for j in range(chunk.shape[0]):
                out = pipelines[(start + j) // per_row](chunk[j], *fixed)
                out.pop("body_mask")  # stays on the device; per-volume results only
                outs.append(out)
            parts.append(engine._fetch({k: torch.stack([o[k] for o in outs]) for k in _OUT_KEYS}))
        return {k: np.concatenate([p[k] for p in parts]) for k in _OUT_KEYS}

    return batched


def _host(data_batch) -> np.ndarray:
    if isinstance(data_batch, torch.Tensor):
        return data_batch.cpu().numpy()
    return np.asarray(data_batch)


def run_sharded_batched(
    engine,
    mesh: Mesh,
    data_batch,
    spacing,
    origin,
    apply_correction: bool = False,
    dp_axis: str = "dp",
    sp_axis: Optional[str] = None,
    microbatch: Optional[int] = None,
    _fn_cache: Optional[dict] = None,
):
    """The mesh-batched pipeline WITH the engine's certificate -> escalate
    -> rerun loop (the semantics `estimate_pose` has on one card): an
    uncertified segmentation (ccl_converged / roots_complete /
    blobs_complete) reruns at escalated settings until every volume
    certifies or the budgets cap out.

    Escalation is per volume, like `estimate_pose_batch`: only the failing
    volumes rerun, compacted into a sub-batch padded to dp x a power of two
    (repeats of the first failure), and the results scatter back; volumes
    certified on the first pass keep their first-pass results.
    `microbatch` chunks the first pass and sets the padding unit and the
    chunking of the reruns (escalated settings need more workspace, not
    less).

    Returns (outputs dict of host arrays, final SegmentationParams,
    certified: bool). Pipelines are cached per params in `_fn_cache` (pass a
    dict to keep it across calls)."""
    cache = _fn_cache if _fn_cache is not None else {}
    params = engine.seg_params
    dp = mesh.shape[dp_axis]
    batch_size = int(data_batch.shape[0])
    data_np = None  # host copy made only if an escalation rerun needs sub-batches

    def get_fn(p, mb):
        key = (p, dp_axis, sp_axis, mb)
        if key not in cache:
            cache[key] = sharded_batched_pipeline(
                engine, mesh, dp_axis=dp_axis, sp_axis=sp_axis, seg_params=p, microbatch=mb,
            )
        return cache[key]

    out = get_fn(params, microbatch)(data_batch, spacing, origin, apply_correction)
    certified = out["seg_converged"] & out["roots_complete"] & out["blobs_complete"]
    while not certified.all():
        fail = np.nonzero(~certified)[0]
        stronger = engine._escalate_seg_params(
            params,
            bool(out["seg_converged"][fail].all()),
            bool(out["roots_complete"][fail].all()),
            bool(out["blobs_complete"][fail].all()),
        )
        if stronger is None:
            logger.warning(
                "mesh-batched segmentation uncertified at strongest settings "
                "for volumes %s", fail.tolist(),
            )
            return out, params, False
        if data_np is None:
            data_np = _host(data_batch)
        # compact the failures and pad with repeats of the first to a
        # power-of-two number of units (the unit honours `microbatch`)
        unit = microbatch if microbatch is not None else dp
        groups = -(-len(fail) // unit)
        n_pad = unit * (1 if groups <= 1 else 1 << (groups - 1).bit_length())
        mb = microbatch if (microbatch is not None and n_pad > microbatch) else None
        sel = np.concatenate([fail, np.full(n_pad - len(fail), fail[0], fail.dtype)])
        logger.warning(
            "mesh-batched segmentation escalation for %d/%d volumes -> "
            "passes=%s max_sweeps=%d max_roots=%d max_blobs=%d exhaustive=%s",
            len(fail), batch_size, stronger.passes, stronger.max_sweeps,
            stronger.max_roots, stronger.max_blobs, stronger.exhaustive_roots,
        )
        sub = get_fn(stronger, mb)(data_np[sel], spacing, origin, apply_correction)
        for k, v in out.items():
            v[fail] = sub[k][: len(fail)]
        certified[fail] = (
            sub["seg_converged"] & sub["roots_complete"] & sub["blobs_complete"]
        )[: len(fail)]
        params = stronger
    return out, params, True
