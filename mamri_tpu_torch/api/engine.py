"""MamriEngine — mamri_tpu's facade on PyTorch: pose estimation (single,
batched, asynchronous), entry search and collision-checked planning.

Port of `_LRUCache`, `MamriEngine.__init__`, `pipeline_fn`, `clear_caches`,
`_get_pipeline`, `_escalate_seg_params`, `estimate_pose`,
`estimate_pose_async` / `_collect`, `_finish_estimate`,
`estimate_pose_batch` (mamri_tpu/api/engine.py:62-681), of the baseplate
and pose state methods (:683-711, 1241-1260), and of the body mask,
segmentation export, conversion and planning methods (:970-1238), with the
reference's tracer spans. The per-volume program
(segmentation -> triplet matching -> baseplate fit -> full-chain IK -> motor
steps) runs eagerly on the engine's device, cached per (shape, params) as the
reference caches its jitted programs; the host reads the certificates and
results with one synchronization per attempt (`_fetch`) and escalates the
segmentation budgets exactly as the reference does. A batch is a loop of
that program over its volumes on one stream, fetched once per batch (and
once per escalation round); planning builds the collision world once per
body on the engine's device and returns each result through one fetch.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from mamri_tpu_torch.api.types import PoseEstimate, TrajectoryPlan
from mamri_tpu_torch.core.robot import RobotModel, load_robot_model
from mamri_tpu_torch.core.units import angles_to_steps, angles_to_steps_host, steps_to_angles_host
from mamri_tpu_torch.ik.residuals import solve_full_chain_ik
from mamri_tpu_torch.perception.segmentation import SegmentationParams, segment_volume
from mamri_tpu_torch.perception.volume import Volume
from mamri_tpu_torch.planning.collision import build_collision_world
from mamri_tpu_torch.planning.entry import EntryPointResult, find_entry_point
from mamri_tpu_torch.planning.geometry import ArmGeometry, build_arm_geometry
from mamri_tpu_torch.planning.heuristic import check_path_collisions, heuristic_keyframes, interpolate_path
from mamri_tpu_torch.planning.trajectory import TrajectoryIKResult, solve_trajectory_ik
from mamri_tpu_torch.registration.kabsch import kabsch_rigid_transform
from mamri_tpu_torch.registration.lshape import match_l_shaped_triplets
from mamri_tpu_torch.utils.trace import Tracer

logger = logging.getLogger(__name__)

MARKER_LINKS = ("Baseplate", "Joint2", "Joint4", "Joint6")
DEFAULT_SAFETY_DISTANCE_MM = 5.0
_CERTIFICATES = (
    "seg_converged", "roots_complete", "blobs_complete",
    "seg_count_ok", "seg_cand_ok", "seg_runs_ok", "seg_compact_ok",
)


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("MamriEngine(device='cuda'): torch.cuda.is_available() is False")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


class _LRUCache:
    """Bounded insertion-ordered cache of pipelines, the port's copy of the
    reference's (mamri_tpu/api/engine.py:62-114). Thread-safe: every
    operation holds one RLock, and `get_or_set` makes lookup-or-build one
    atomic step."""

    def __init__(self, maxsize: int):
        self.maxsize = max(1, int(maxsize))
        self._d: "OrderedDict" = OrderedDict()
        self._lock = threading.RLock()

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._d

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def __getitem__(self, key):
        with self._lock:
            self._d.move_to_end(key)
            return self._d[key]

    def __setitem__(self, key, value) -> None:
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)

    def get_or_set(self, key, factory):
        """The cached value for `key`, built with `factory()` under the lock
        if absent."""
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                return self._d[key]
            value = factory()
            self[key] = value
            return value

    def clear(self) -> None:
        with self._lock:
            self._d.clear()


class MamriEngine:
    def __init__(
        self,
        config_path: Optional[str] = None,
        mesh_dir: Optional[str] = None,
        seg_params: Optional[SegmentationParams] = None,
        tracer: Optional[Tracer] = None,
        ik_iters: int = 24,
        ik_restarts: int = 2,
        match_mode: str = "best",
        jit_cache_size: int = 32,
        device="cuda",
    ):
        if match_mode == "global":
            raise NotImplementedError(
                "match_mode='global' is not ported yet: see ROADMAP.md, queue A, 'the global matcher'"
            )
        if match_mode not in ("best", "strict"):
            raise ValueError(f"match_mode must be 'best' or 'strict', got {match_mode!r}")
        self.device = _resolve_device(device)
        self.model: RobotModel = load_robot_model(config_path, device=self.device)
        # part clouds for the collision checks (STL parts from `mesh_dir` where
        # it holds them, capsules otherwise), on the engine's device
        self.geometry: ArmGeometry = build_arm_geometry(self.model, mesh_dir)
        self.mesh_dir = mesh_dir
        self._exact_parts = None  # dense hulls for validate_plan_exact, built on first use
        self._steps_per_rev = self.model.steps_per_rev.cpu().numpy()
        # the reference's defaults: a 3-half-sweep CCL schedule [yz, x, yz] +
        # the fixed-point certificate, 128 candidate roots + the completeness
        # certificates; estimate_pose escalates whatever fails
        self.seg_params = (
            seg_params if seg_params is not None
            else SegmentationParams(max_sweeps=2, passes=3, max_roots=128)
        )
        self.tracer = tracer or Tracer(enabled=False)
        self.ik_iters = ik_iters
        self.ik_restarts = ik_restarts
        self.match_mode = match_mode
        self._arm_lengths = [self.model.spec(ln).arm_lengths for ln in MARKER_LINKS]

        self.current_angles = np.zeros(self.model.num_joints, dtype=np.float32)
        self.baseplate_tf: Optional[np.ndarray] = None
        self.saved_baseplate: Optional[np.ndarray] = None
        self.last_ik_error: Optional[float] = None
        self.last_segmentation = None
        self.last_volume_geom = None
        self.last_collision_world = None
        self._body_mask_dev: Optional[torch.Tensor] = None  # uploaded with the collision world
        self.trajectory_path: Optional[np.ndarray] = None
        self.trajectory_keyframes: Optional[np.ndarray] = None
        self.last_estimated_steps: Optional[np.ndarray] = None
        self._pipeline_cache = _LRUCache(jit_cache_size)

    def load_state_from_numpy(self, baseplate_tf=None, saved_baseplate=None, current_angles=None) -> None:
        """Take over engine state from another engine (e.g. mamri_tpu's)."""
        self.baseplate_tf = None if baseplate_tf is None else np.array(baseplate_tf, np.float32)
        self.saved_baseplate = None if saved_baseplate is None else np.array(saved_baseplate, np.float32)
        if current_angles is not None:
            self.current_angles = np.array(current_angles, np.float32)

    # ---------------------------------------------------------------- state
    def save_baseplate(self, path: Optional[str] = None) -> np.ndarray:
        """Keep the current baseplate transform as the saved one, and write it
        to `path` (`.npz`) when given."""
        if self.baseplate_tf is None:
            raise RuntimeError("no baseplate transform yet; run estimate_pose first")
        self.saved_baseplate = np.asarray(self.baseplate_tf).copy()
        if path is not None:
            np.savez(path, baseplate_tf=self.saved_baseplate)
        return self.saved_baseplate

    def load_baseplate(self, path: str) -> np.ndarray:
        with np.load(path) as f:
            self.saved_baseplate = np.asarray(f["baseplate_tf"], dtype=np.float32)
        return self.saved_baseplate

    def set_pose(self, angles_rad) -> None:
        angles = np.asarray(angles_rad, dtype=np.float32).reshape(-1)
        if angles.shape[0] != self.model.num_joints:
            raise ValueError(f"expected {self.model.num_joints} angles, got {angles.shape[0]}")
        self.current_angles = angles

    def get_current_joint_angles(self) -> np.ndarray:
        return self.current_angles.copy()

    def zero_robot(self) -> None:
        self.current_angles = np.zeros_like(self.current_angles)

    def save_state(self, path: str) -> None:
        """Checkpoint the engine's scene state (baseplate, pose, saved
        baseplate) as `.npz` + `.meta.json`, in the reference's format."""
        arrays = {"current_angles": self.current_angles}
        meta = {"has_baseplate": self.baseplate_tf is not None, "has_saved": self.saved_baseplate is not None}
        if self.baseplate_tf is not None:
            arrays["baseplate_tf"] = self.baseplate_tf
        if self.saved_baseplate is not None:
            arrays["saved_baseplate"] = self.saved_baseplate
        np.savez(path, **arrays)
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)

    def load_state(self, path: str) -> None:
        with np.load(path) as f:
            self.current_angles = np.asarray(f["current_angles"], dtype=np.float32)
            if "baseplate_tf" in f:
                self.baseplate_tf = np.asarray(f["baseplate_tf"], dtype=np.float32)
            if "saved_baseplate" in f:
                self.saved_baseplate = np.asarray(f["saved_baseplate"], dtype=np.float32)

    # ---------------------------------------------------------------- compute core
    def pipeline_fn(self, seg_params: Optional[SegmentationParams] = None):
        """The per-volume program: segmentation -> matching -> baseplate ->
        full-chain IK -> steps. Takes and returns tensors on the engine's
        device (a dict with the reference's keys)."""
        model = self.model
        seg_params = seg_params if seg_params is not None else self.seg_params
        arm_lengths = self._arm_lengths
        bp_local = model.marker_local[model.link_index("Baseplate")]
        ik_iters, ik_restarts = self.ik_iters, self.ik_restarts
        strict = self.match_mode == "strict"

        def pipeline(data, spacing, origin, saved_tf, use_saved, have_saved, apply_correction, current_angles):
            seg = segment_volume(data, spacing, origin, seg_params)
            matches = match_l_shaped_triplets(
                seg.centroids_ras, seg.blob_valid, arm_lengths, strict_reference_order=strict
            )
            bp_found = matches.found[0]
            # baseplate: Y-flatten the detected markers, then the rigid fit
            bp_pts = matches.points[0]
            bp_pts = torch.stack([bp_pts[:, 0], bp_pts[:, 1].mean().expand(3), bp_pts[:, 2]], dim=1)
            detected_tf = kabsch_rigid_transform(bp_local, bp_pts)

            # priority: saved-if-requested > detected > saved fallback
            use_saved_now = use_saved & have_saved
            fallback_saved = ~bp_found & have_saved
            base_tf = torch.where(use_saved_now, saved_tf, torch.where(bp_found, detected_tf, saved_tf))
            base_ok = use_saved_now | bp_found | fallback_saved
            # 0=none 1=detected 2=saved 3=saved_fallback
            source = torch.where(
                use_saved_now, 2, torch.where(bp_found, 1, torch.where(fallback_saved, 3, 0))
            ).to(torch.int32)
            ik = solve_full_chain_ik(
                model,
                matches.points[3],
                base_tf,
                current_angles=current_angles,
                apply_correction=apply_correction,
                joint4_targets=matches.points[2],
                joint4_found=matches.found[2],
                num_iters=ik_iters,
                num_random_restarts=ik_restarts,
                joint2_targets=matches.points[1],
                joint2_found=matches.found[1],
            )
            return {
                "success": base_ok & matches.found[3],
                "angles": ik.angles,
                "steps": angles_to_steps(ik.angles, model.steps_per_rev),
                "rmse": ik.rmse,
                "base_tf": base_tf,
                "base_ok": base_ok,
                "base_source": source,
                "markers_found": matches.found,
                "num_blobs": seg.num_blobs,
                "body_mask": seg.body_mask,
                "body_found": seg.body_found,
                "num_components": seg.num_components,
                "seg_converged": seg.ccl_converged,
                "roots_complete": seg.roots_complete,
                "blobs_complete": seg.blobs_complete,
                "seg_count_ok": seg.count_ok,
                "seg_cand_ok": seg.cand_ok,
                "seg_runs_ok": seg.runs_ok,
                "seg_compact_ok": seg.compact_ok,
            }

        return pipeline

    def clear_caches(self) -> None:
        """Drop every cached pipeline."""
        self._pipeline_cache.clear()

    def _get_pipeline(self, shape, seg_params: Optional[SegmentationParams] = None):
        params = seg_params if seg_params is not None else self.seg_params
        return self._pipeline_cache.get_or_set((tuple(shape), params), lambda: self.pipeline_fn(params))

    def _fetch(self, dev_out: dict) -> dict:
        """{key: tensor on the engine's device} -> {key: numpy array}, with one
        host synchronization for all of them. On the card every copy is
        queued without a wait into pinned host memory, one event is recorded
        behind them and waited on, and the arrays are then copied out of the
        pinned buffers, so no returned array points into memory the caching
        host allocator may hand out again."""
        if self.device.type != "cuda":
            return {k: v.numpy() for k, v in dev_out.items()}
        pinned = {k: v.to("cpu", non_blocking=True) for k, v in dev_out.items()}
        copied = torch.cuda.Event()
        copied.record()
        copied.synchronize()
        return {k: v.numpy().copy() for k, v in pinned.items()}

    def _upload(self, v, dtype=None) -> torch.Tensor:
        """A host value on the engine's device, queued without a wait: a copy
        from pageable memory is staged before the call returns, so the host
        array may change after it."""
        return torch.as_tensor(v, dtype=dtype).to(self.device, non_blocking=True)

    def _pipeline_args(self, volume: Volume, use_saved_baseplate: bool, apply_correction: bool) -> tuple:
        """The pipeline's arguments for one scan and the engine's state now."""
        saved = self.saved_baseplate if self.saved_baseplate is not None else np.eye(4, dtype=np.float32)
        f32 = torch.float32
        return (
            self._upload(volume.data),
            self._upload(volume.spacing, f32),
            self._upload(volume.origin, f32),
            self._upload(saved, f32),
            self._upload(bool(use_saved_baseplate)),
            self._upload(self.saved_baseplate is not None),
            self._upload(bool(apply_correction)),
            self._upload(self.current_angles, f32),
        )

    @staticmethod
    def _escalate_seg_params(
        params: SegmentationParams,
        converged: bool,
        complete: bool,
        blobs_complete: bool = True,
        count_ok: Optional[bool] = None,
        cand_ok: Optional[bool] = None,
        runs_ok: Optional[bool] = None,
        compact_ok: Optional[bool] = None,
        jnp_path: bool = False,
    ):
        """One escalation step for an uncertified segmentation, carried over
        from mamri_tpu/api/engine.py:288-366 unchanged: each failing
        certificate grows only its own budget. None when nothing further can
        be done. `jnp_path` is True where the reference would take its jnp
        path, i.e. where `use_pallas` is False: there a failed blocked top-k
        also turns on `exhaustive_roots`; otherwise, at any closing radius,
        it raises `max_roots` only, as on the reference's accelerator."""
        new = params
        if not converged:
            if params.passes is not None:
                if params.passes < 512:
                    new = new._replace(passes=min(params.passes * 2, 512))
            elif params.max_sweeps < 256:
                new = new._replace(max_sweeps=min(params.max_sweeps * 2, 256))
        targeted = count_ok is not None
        if not complete and not targeted and not (
            params.max_roots >= 4096 and params.cand_k >= 256
            and params.run_k >= 128 and params.exhaustive_roots
        ):
            new = new._replace(
                max_roots=min(max(params.max_roots * 8, 1024), 4096),
                cand_k=min(max(params.cand_k * 8, 64), 256),
                run_k=min(max(params.run_k * 4, 64), 128),
                exhaustive_roots=True,
            )
        elif not complete and targeted:
            if not count_ok and (
                params.max_roots < 4096 or (jnp_path and not params.exhaustive_roots)
            ):
                new = new._replace(
                    max_roots=min(max(params.max_roots * 8, 1024), 4096),
                    exhaustive_roots=True if jnp_path else params.exhaustive_roots,
                )
            if cand_ok is False and params.cand_k < 256:
                new = new._replace(cand_k=min(max(params.cand_k * 8, 64), 256))
            if runs_ok is False and params.run_k < 128:
                new = new._replace(run_k=min(max(params.run_k * 2, 16), 128))
            if compact_ok is False and params.compact_stats is not False:
                new = new._replace(compact_stats=False)
        if not blobs_complete and params.max_blobs < 128:
            new = new._replace(max_blobs=min(params.max_blobs * 2, 128, new.max_roots))
        return None if new == params else new

    # ---------------------------------------------------------------- pose estimation
    def estimate_pose(
        self,
        volume: Volume,
        use_saved_baseplate: bool = False,
        apply_correction: bool = False,
        store_state: bool = True,
        keep_segmentation: bool = True,
    ) -> PoseEstimate:
        """Scan -> pose (the reference's `process()`), escalating the
        segmentation budgets until every certificate holds."""
        args = self._pipeline_args(volume, use_saved_baseplate, apply_correction)
        with self.tracer.span("estimate_pose"):
            params = self.seg_params
            while True:
                dev_out = self._get_pipeline(volume.shape, params)(*args)
                # ONE host sync per attempt: certificates and results come back
                # together; the body mask only once certification settles, and
                # only when the caller keeps the segmentation
                mask = dev_out.pop("body_mask")
                out = self._fetch(dev_out)
                certs = {k: bool(out[k]) for k in _CERTIFICATES}
                converged, complete, blobs_ok = (
                    certs["seg_converged"], certs["roots_complete"], certs["blobs_complete"]
                )
                if converged and complete and blobs_ok:
                    break
                stronger = self._escalate_seg_params(
                    params, converged, complete, blobs_ok,
                    count_ok=certs["seg_count_ok"],
                    cand_ok=certs["seg_cand_ok"],
                    runs_ok=certs["seg_runs_ok"],
                    compact_ok=certs["seg_compact_ok"],
                    jnp_path=params.use_pallas is False,
                )
                if stronger is None:
                    logger.warning(
                        "segmentation uncertified at strongest settings "
                        "(converged=%s, roots_complete=%s, blobs_complete=%s, num_components=%d)",
                        converged, complete, blobs_ok, int(out["num_components"]),
                    )
                    break
                logger.warning(
                    "segmentation escalation: converged=%s roots_complete=%s "
                    "blobs_complete=%s num_components=%d -> passes=%s "
                    "max_sweeps=%d max_roots=%d max_blobs=%d exhaustive=%s",
                    converged, complete, blobs_ok, int(out["num_components"]),
                    stronger.passes, stronger.max_sweeps, stronger.max_roots,
                    stronger.max_blobs, stronger.exhaustive_roots,
                )
                params = stronger
            if keep_segmentation:
                out.update(self._fetch({"body_mask": mask}))
        return self._finish_estimate(out, volume, store_state, keep_segmentation)

    def estimate_pose_async(
        self,
        volume: Volume,
        use_saved_baseplate: bool = False,
        apply_correction: bool = False,
    ) -> dict:
        """Dispatch one pose estimation and return a handle for
        `estimate_pose_collect` without fetching its result. The IK
        warm-starts from `current_angles` as they are at dispatch (one frame
        staler than the synchronous path). The handle holds the result's
        tensors on the device and the volume, for the synchronous fallback;
        the uploads are staged before this returns, so no host buffer of the
        scan is held in flight."""
        dev_out = self._get_pipeline(volume.shape, self.seg_params)(
            *self._pipeline_args(volume, use_saved_baseplate, apply_correction)
        )
        dev_out.pop("body_mask")  # streaming path: results only
        return {"dev": dev_out, "volume": volume, "use_saved": use_saved_baseplate, "correction": apply_correction}

    def estimate_pose_collect(self, handle: dict, store_state: bool = True) -> PoseEstimate:
        """Fetch a dispatched estimation (one host synchronization). An
        uncertified segmentation falls back to the synchronous escalating
        path on the handle's volume."""
        out = self._fetch(handle["dev"])
        if not (bool(out["seg_converged"]) and bool(out["roots_complete"]) and bool(out["blobs_complete"])):
            logger.warning("async estimation uncertified; re-running synchronously")
            return self.estimate_pose(
                handle["volume"],
                use_saved_baseplate=handle["use_saved"],
                apply_correction=handle["correction"],
                store_state=store_state,
                keep_segmentation=False,
            )
        return self._finish_estimate(out, handle["volume"], store_state, keep_segmentation=False)

    def _finish_estimate(self, out: dict, volume: Volume, store_state: bool, keep_segmentation: bool) -> PoseEstimate:
        """Host-side tail: state updates + the PoseEstimate."""
        markers_found = {ln: bool(f) for ln, f in zip(MARKER_LINKS, out["markers_found"])}
        source = ["none", "detected", "saved", "saved_fallback"][int(out["base_source"])]
        if store_state and keep_segmentation:
            self.last_segmentation = out
            self.last_volume_geom = (np.asarray(volume.spacing), np.asarray(volume.origin))
            self._drop_body_world()  # rebuilt from the new body on first use
        if not bool(out["base_ok"]):
            logger.error("baseplate transform unavailable (not detected, no saved transform)")
            return PoseEstimate(
                success=False,
                markers_found=markers_found,
                num_blobs=int(out["num_blobs"]),
                message="Pose estimation failed: baseplate not detected and no saved transform.",
            )
        if store_state:
            self.baseplate_tf = np.asarray(out["base_tf"])
        if not markers_found["Joint6"]:
            logger.info("Joint6 markers not found; cannot estimate pose")
            return PoseEstimate(
                success=False,
                baseplate_tf=np.asarray(out["base_tf"]),
                baseplate_source=source,
                markers_found=markers_found,
                num_blobs=int(out["num_blobs"]),
                message="Joint6 markers not found.",
            )
        angles = np.asarray(out["angles"])
        if store_state:
            self.current_angles = angles.astype(np.float32)
            self.last_ik_error = float(out["rmse"])
            self.last_estimated_steps = np.asarray(out["steps"])
        return PoseEstimate(
            success=True,
            angles_rad=angles,
            steps=np.asarray(out["steps"]),
            rmse_mm=float(out["rmse"]),
            baseplate_tf=np.asarray(out["base_tf"]),
            baseplate_source=source,
            markers_found=markers_found,
            num_blobs=int(out["num_blobs"]),
        )

    # ---------------------------------------------------------------- batched estimation
    def estimate_pose_batch(
        self,
        data_batch,
        spacing,
        origin,
        apply_correction: bool = False,
        donate: bool = True,
        microbatch: Optional[int] = None,
    ) -> dict:
        """Batched pose estimation: {key: (B, ...) host array} of the
        pipeline's outputs (the body mask left on the device), with no engine
        state read or written. Each volume runs the per-volume program with
        the batch's fixed state (no saved baseplate, zero current angles);
        the kernels take one volume a launch, so a batch is a loop of that
        program on one stream, fetched once.

        `microbatch` bounds how many volumes' outputs are held on the device
        before a fetch (one fetch per `microbatch` volumes); it must divide
        the batch size. `donate` is accepted for the reference's signature
        and has no effect here: the batch is uploaded once and kept until
        the call returns, since escalation reruns read its rows again.

        Escalation is per volume: an uncertified segmentation reruns only
        the failing volumes at the escalated settings (taken from the
        certificates of the failing volumes only), one fetch per round, and
        the clean rows keep their first-pass results."""
        params = self.seg_params
        data_np = np.asarray(data_batch)
        if microbatch is not None and data_np.shape[0] % microbatch:
            raise ValueError(f"microbatch {microbatch} must divide batch {data_np.shape[0]}")
        f32 = torch.float32
        data = self._upload(data_np)
        fixed = (
            self._upload(spacing, f32),
            self._upload(origin, f32),
            self._upload(np.eye(4, dtype=np.float32)),
            self._upload(False),
            self._upload(False),
            self._upload(bool(apply_correction)),
            self._upload(np.zeros(self.model.num_joints, dtype=np.float32)),
        )
        out = self._run_batch(data, np.arange(data_np.shape[0]), params, fixed, microbatch)
        certified = out["seg_converged"] & out["roots_complete"] & out["blobs_complete"]
        while not certified.all():
            fail = np.nonzero(~certified)[0]
            stronger = self._escalate_seg_params(
                params,
                bool(out["seg_converged"][fail].all()),
                bool(out["roots_complete"][fail].all()),
                bool(out["blobs_complete"][fail].all()),
                count_ok=bool(out["seg_count_ok"][fail].all()),
                cand_ok=bool(out["seg_cand_ok"][fail].all()),
                runs_ok=bool(out["seg_runs_ok"][fail].all()),
                compact_ok=bool(out["seg_compact_ok"][fail].all()),
                jnp_path=params.use_pallas is False,
            )
            if stronger is None:
                logger.warning(
                    "batched segmentation uncertified at strongest settings for volumes %s", fail.tolist()
                )
                break
            logger.warning(
                "batched segmentation escalation for %d/%d volumes -> "
                "passes=%s max_sweeps=%d max_roots=%d max_blobs=%d exhaustive=%s",
                len(fail), data_np.shape[0], stronger.passes, stronger.max_sweeps,
                stronger.max_roots, stronger.max_blobs, stronger.exhaustive_roots,
            )
            sub = self._run_batch(data, fail, stronger, fixed, None)
            for k, v in out.items():
                v[fail] = sub[k]
            certified[fail] = sub["seg_converged"] & sub["roots_complete"] & sub["blobs_complete"]
            params = stronger
        return out

    def _run_batch(self, data, rows, params, fixed, microbatch) -> dict:
        """{key: (len(rows), ...) host array}: the per-volume program on each
        of `rows` of the device batch `data`, one fetch per `microbatch` rows
        (one for all of them when None)."""
        pipeline = self._get_pipeline(data.shape[1:], params)
        step = microbatch or len(rows)
        parts = []
        for start in range(0, len(rows), step):
            outs = [pipeline(data[i], *fixed) for i in rows[start:start + step]]
            for o in outs:
                o.pop("body_mask")
            parts.append(self._fetch({k: torch.stack([o[k] for o in outs]) for k in outs[0]}))
        # a copy, written in place by the escalation rounds
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    # ---------------------------------------------------------------- body and conversions
    def target_in_base_frame(self, target_ras) -> np.ndarray:
        """A world RAS point in the robot base frame."""
        if self.baseplate_tf is None:
            raise RuntimeError("robot base unknown; run estimate_pose first")
        inv = np.linalg.inv(np.asarray(self.baseplate_tf, dtype=np.float64))
        p = np.append(np.asarray(target_ras, dtype=np.float64), 1.0)
        return (inv @ p)[:3].astype(np.float32)

    def _has_body(self) -> bool:
        return self.last_segmentation is not None and bool(self.last_segmentation["body_found"])

    def body_mask(self) -> Optional[np.ndarray]:
        """Voxel body mask from the last segmentation, or None."""
        if not self._has_body():
            return None
        return np.asarray(self.last_segmentation["body_mask"])

    def export_segmentation(self, path: str) -> str:
        """Write the last run's body segmentation as a Slicer-loadable
        `.seg.nrrd` with one "Body" segment. Requires a prior estimate with a
        body found."""
        mask = self.body_mask()
        if mask is None:
            raise RuntimeError("no body segmentation available; run estimate_pose first")
        from mamri_tpu_torch.perception.formats import save_seg_nrrd

        spacing, origin = self.last_volume_geom
        save_seg_nrrd(path, {"Body": mask.astype(bool)}, spacing, origin)
        return path

    def set_body_segmentation(self, source, spacing=None, origin=None, segment: str = "Body"):
        """Override the body mask used by entry search and collision checks.
        `source` is a `.seg.nrrd` path (the `segment`-named segment is taken,
        or the only one) or a bool (nx, ny, nz) mask with explicit `spacing`
        / `origin` (LPS). Drops the collision world built from the previous
        body."""
        if isinstance(source, (str, os.PathLike)):
            from mamri_tpu_torch.perception.formats import load_seg_nrrd

            segments, labelmap = load_seg_nrrd(os.fspath(source))
            if segment in segments:
                mask = segments[segment]
            elif len(segments) == 1:
                mask = next(iter(segments.values()))
            else:
                raise ValueError(f"{source}: no segment named {segment!r} among {sorted(segments)}")
            spacing, origin = labelmap.spacing, labelmap.origin
        elif spacing is None or origin is None:
            raise ValueError("a raw mask needs explicit spacing and origin")
        else:
            mask = source
        mask = np.array(mask, dtype=bool)  # the engine's own copy
        if mask.ndim != 3 or not mask.any():
            raise ValueError("body mask must be a non-empty 3-D boolean volume")
        seg = dict(self.last_segmentation) if self.last_segmentation is not None else {}
        seg["body_mask"] = mask
        seg["body_found"] = True
        self.last_segmentation = seg
        self.last_volume_geom = (np.asarray(spacing, dtype=np.float32), np.asarray(origin, dtype=np.float32))
        self._drop_body_world()

    def convert_angles_to_steps(self, angles_rad) -> np.ndarray:
        """Host numpy: the hardware loop converts on every control tick."""
        return angles_to_steps_host(angles_rad, self._steps_per_rev)

    def convert_steps_to_angles(self, steps) -> np.ndarray:
        return steps_to_angles_host(steps, self._steps_per_rev)

    # ---------------------------------------------------------------- planning
    def _drop_body_world(self) -> None:
        self.last_collision_world = None
        self._body_mask_dev = None

    def _require_body_mask(self) -> Optional[torch.Tensor]:
        """The body mask on the engine's device, uploaded once per body."""
        if self._body_mask_dev is None and self._has_body():
            self._body_mask_dev = self._upload(self.last_segmentation["body_mask"])
        return self._body_mask_dev

    def _require_body_world(self):
        """The collision world of the current body, built on first use."""
        if self.last_collision_world is None and self._has_body():
            spacing, origin = self.last_volume_geom
            with self.tracer.span("build_collision_world"):
                self.last_collision_world = build_collision_world(self._require_body_mask(), spacing, origin)
        return self.last_collision_world

    def find_entry_point(self, target_ras) -> EntryPointResult:
        """The skin entry point nearest the target on the voxel surface (host
        arrays, one fetch)."""
        if not self._has_body():
            raise RuntimeError("no body segmentation available; run estimate_pose first")
        spacing, origin = self.last_volume_geom
        with self.tracer.span("find_entry_point"):
            res = find_entry_point(self._require_body_mask(), spacing, origin, self._upload(target_ras, torch.float32))
            out = self._fetch(res._asdict())
        return EntryPointResult(**out)

    def _plan_args(self, target_ras, entry_ras, safety, start=None):
        if self.baseplate_tf is None:
            raise RuntimeError("robot base unknown; run estimate_pose first")
        f32 = torch.float32
        args = (
            self._upload(target_ras, f32),
            self._upload(entry_ras, f32),
            self._upload(safety, f32),
            self._upload(self.baseplate_tf, f32),
            self._upload(self.current_angles if start is None else start, f32),
            self._upload(self.current_angles, f32),
        )
        return args, self._require_body_world()

    def _solve_goal(self, target, entry, safety, base_tf, current, world) -> TrajectoryIKResult:
        return solve_trajectory_ik(
            self.model, self.geometry, target, entry, safety, base_tf, world, current_angles=current
        )

    def plan_trajectory(self, target_ras, entry_ras, safety_distance_mm: float = DEFAULT_SAFETY_DISTANCE_MM):
        """Collision-aware goal IK for the needle (host arrays, one fetch)."""
        (target, entry, safety, base_tf, _, current), world = self._plan_args(target_ras, entry_ras, safety_distance_mm)
        with self.tracer.span("plan_trajectory"):
            res = self._solve_goal(target, entry, safety, base_tf, current, world)
            out = self._fetch(res._asdict())
        return TrajectoryIKResult(**out)

    def plan_trajectory_sweep(self, target_ras, entry_ras, safety_distances_mm):
        """The goal IK for each of several safety distances, stacked (host
        arrays, one fetch): one solve a distance on the device, where the
        reference vmaps them."""
        distances = np.asarray(safety_distances_mm, dtype=np.float32)
        (target, entry, safeties, base_tf, _, current), world = self._plan_args(target_ras, entry_ras, distances)
        with self.tracer.span("plan_trajectory_sweep"):
            sols = [self._solve_goal(target, entry, d, base_tf, current, world) for d in safeties]
            stacked = {k: torch.stack([getattr(s, k) for s in sols]) for k in TrajectoryIKResult._fields}
            out = self._fetch(stacked)
        return TrajectoryIKResult(**out)

    def plan_heuristic_path(
        self,
        target_ras,
        entry_ras,
        safety_distance_mm: float = DEFAULT_SAFETY_DISTANCE_MM,
        start_pose_steps=None,
        total_steps: int = 100,
    ) -> TrajectoryPlan:
        """Up-over-down keyframes to the goal IK's pose, 25/25/50
        interpolation and the whole path's collision check on the device,
        with one host fetch."""
        if start_pose_steps is not None:
            start = self.convert_steps_to_angles(np.asarray(start_pose_steps))
        else:
            start = self.current_angles
            logger.warning("no estimated start pose provided; planning from current pose")
        (target, entry, safety, base_tf, start_t, current), world = self._plan_args(
            target_ras, entry_ras, safety_distance_mm, start=start
        )
        with self.tracer.span("plan_heuristic_path"):
            goal = self._solve_goal(target, entry, safety, base_tf, current, world)
            kf = heuristic_keyframes(start_t, goal.angles)
            path = interpolate_path(kf, total_steps)
            if world is not None:
                flags = check_path_collisions(self.model, self.geometry, path, base_tf, world)
            else:
                flags = torch.zeros(path.shape[0], dtype=torch.bool, device=self.device)
            out = self._fetch({
                "success": goal.success, "angles": goal.angles, "position_error_mm": goal.position_error_mm,
                "keyframes": kf, "path": path, "flags": flags,
            })
        if not bool(out["success"]):
            return TrajectoryPlan(success=False, message="Could not find a valid, collision-free trajectory solution.")
        if world is None:
            logger.warning("no body segmentation for path collision checking")
        collision = bool(out["flags"].any())
        plan = TrajectoryPlan(
            success=True,
            path=out["path"],
            keyframes=out["keyframes"],
            collision_detected=collision,
            goal_angles=out["angles"],
            goal_steps=self.convert_angles_to_steps(out["angles"]),
            position_error_mm=float(out["position_error_mm"]),
        )
        if collision:
            plan.message = "Warning: the generated path results in a collision."
            logger.warning(plan.message)
        self.trajectory_path = plan.path
        self.trajectory_keyframes = plan.keyframes
        return plan

    def validate_plan_exact(self, plan=None, max_edge_mm: float = 1.0) -> dict:
        """Triangle-exact host validation of a final plan
        (`planning/exact.validate_path_exact`): dense part hulls against the
        UNDILATED body voxels at every path sample. Adds
        `fast_checker_flagged` and `over_conservative` (True when the fast
        checker flagged a collision the exact check clears)."""
        from mamri_tpu_torch.planning.exact import build_exact_parts, validate_path_exact

        path = self.trajectory_path if plan is None else plan.path
        if path is None:
            raise RuntimeError("no planned path to validate; run plan_heuristic_path first")
        if not self._has_body():
            raise RuntimeError("no body segmentation available; run estimate_pose first")
        if self.baseplate_tf is None:
            raise RuntimeError("robot base unknown; run estimate_pose first")
        if self._exact_parts is None or self._exact_parts.max_edge_mm != max_edge_mm:
            self._exact_parts = build_exact_parts(self.model, mesh_dir=self.mesh_dir, max_edge_mm=max_edge_mm)
        spacing, origin = self.last_volume_geom
        with self.tracer.span("validate_plan_exact"):
            out = validate_path_exact(
                self.model, self._exact_parts, np.asarray(self.last_segmentation["body_mask"]), spacing, origin,
                self.baseplate_tf, path,
            )
        fast_flagged = bool(plan.collision_detected) if plan is not None else None
        out["fast_checker_flagged"] = fast_flagged
        out["over_conservative"] = bool(fast_flagged and out["collision_free"]) if fast_flagged is not None else None
        return out
