"""MamriEngine — the estimate path of mamri_tpu's facade, on PyTorch.

Port of `_LRUCache`, `MamriEngine.__init__`, `pipeline_fn`, `clear_caches`,
`_get_pipeline`, `_escalate_seg_params`, `estimate_pose` and
`_finish_estimate` (mamri_tpu/api/engine.py:62-536). The per-volume program
(segmentation -> triplet matching -> baseplate fit -> full-chain IK -> motor
steps) runs eagerly on the engine's device, cached per (shape, params) as the
reference caches its jitted programs; the host reads the certificates and
results with one synchronization per attempt (`_fetch`) and escalates the
segmentation budgets exactly as the reference does.
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from mamri_tpu_torch.api.types import PoseEstimate
from mamri_tpu_torch.core.robot import RobotModel, load_robot_model
from mamri_tpu_torch.core.units import angles_to_steps
from mamri_tpu_torch.ik.residuals import solve_full_chain_ik
from mamri_tpu_torch.perception.segmentation import SegmentationParams, segment_volume
from mamri_tpu_torch.perception.volume import Volume
from mamri_tpu_torch.registration.kabsch import kabsch_rigid_transform
from mamri_tpu_torch.registration.lshape import match_l_shaped_triplets

logger = logging.getLogger(__name__)

MARKER_LINKS = ("Baseplate", "Joint2", "Joint4", "Joint6")
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
        seg_params: Optional[SegmentationParams] = None,
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
        # the reference's defaults: a 3-half-sweep CCL schedule [yz, x, yz] +
        # the fixed-point certificate, 128 candidate roots + the completeness
        # certificates; estimate_pose escalates whatever fails
        self.seg_params = (
            seg_params if seg_params is not None
            else SegmentationParams(max_sweeps=2, passes=3, max_roots=128)
        )
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
        self.last_estimated_steps: Optional[np.ndarray] = None
        self._pipeline_cache = _LRUCache(jit_cache_size)

    def load_state_from_numpy(self, baseplate_tf=None, saved_baseplate=None, current_angles=None) -> None:
        """Take over engine state from another engine (e.g. mamri_tpu's)."""
        self.baseplate_tf = None if baseplate_tf is None else np.asarray(baseplate_tf, np.float32)
        self.saved_baseplate = None if saved_baseplate is None else np.asarray(saved_baseplate, np.float32)
        if current_angles is not None:
            self.current_angles = np.asarray(current_angles, np.float32).copy()

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
            )
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
        dev = self.device
        saved = self.saved_baseplate if self.saved_baseplate is not None else np.eye(4, dtype=np.float32)

        def upload(v, dtype=None):
            # queued without a wait: a copy from pageable memory is staged
            # before the call returns, so the host arrays may change after it
            return torch.as_tensor(v, dtype=dtype).to(dev, non_blocking=True)

        args = (
            upload(volume.data),
            upload(volume.spacing, torch.float32),
            upload(volume.origin, torch.float32),
            upload(saved, torch.float32),
            upload(bool(use_saved_baseplate)),
            upload(self.saved_baseplate is not None),
            upload(bool(apply_correction)),
            upload(self.current_angles, torch.float32),
        )
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

    def _finish_estimate(self, out: dict, volume: Volume, store_state: bool, keep_segmentation: bool) -> PoseEstimate:
        """Host-side tail: state updates + the PoseEstimate."""
        markers_found = {ln: bool(f) for ln, f in zip(MARKER_LINKS, out["markers_found"])}
        source = ["none", "detected", "saved", "saved_fallback"][int(out["base_source"])]
        if store_state and keep_segmentation:
            self.last_segmentation = out
            self.last_volume_geom = (np.asarray(volume.spacing), np.asarray(volume.origin))
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
