"""Streaming pose tracking: per-scan ingest -> segmentation -> IK -> re-plan.

Port of `mamri_tpu/api/streaming.py`. A `PoseTracker` wraps the engine's
pipeline with warm-started IK (the previous pose is the first restart) and
keeps per-frame latency statistics.

Two modes:
  * synchronous (default): `step` uploads, computes and fetches one frame.
  * pipelined (`pipelined=True`): `step` dispatches frame N and collects
    frame N-depth (`estimate_pose_async` / `_collect`); the IK then
    warm-starts from a pose `depth` frames old.

ROI ingest (`roi_margin_mm=`): after the first successful full frame, each
later frame is cropped on the host to a fixed-shape window around the
predicted marker bounding box (host FK of the previous pose + the margin)
before upload, so fewer bytes cross to the device. The window shape is
frozen at first use (one pipeline in the engine's cache); only its position
tracks the pose. A failed ROI frame falls back to the full frame in the same
step, so a pose jump larger than the margin costs one slow frame, never a
miss.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from mamri_tpu_torch.api.engine import MARKER_LINKS, MamriEngine
from mamri_tpu_torch.api.types import PoseEstimate
from mamri_tpu_torch.core.robot import fk_all_links_host
from mamri_tpu_torch.perception.volume import Volume
from mamri_tpu_torch.utils.trace import Tracer


class PoseTracker:
    def __init__(
        self,
        engine: MamriEngine,
        apply_correction: bool = False,
        pipelined: bool = False,
        depth: int = 1,
        target_ras=None,
        entry_ras=None,
        safety_mm: float = 5.0,
        replan_every: int = 1,
        roi_margin_mm: Optional[float] = None,
    ):
        """`target_ras` (with `entry_ras`) arms per-frame re-planning: after
        every `replan_every`-th successful estimate the tracker re-solves the
        collision-checked up-over-down path from the fresh pose (the body
        world is rebuilt from that frame's segmentation). The latest plan is
        `last_plan`; its latency is the "replan" tracer span."""
        if depth < 1:
            raise ValueError("pipeline depth must be >= 1")
        if replan_every < 1:
            raise ValueError("replan_every must be >= 1")
        if target_ras is not None and entry_ras is None:
            raise ValueError("re-planning needs entry_ras (run find_entry_point once)")
        if target_ras is not None and pipelined:
            raise ValueError(
                "per-frame re-planning requires the synchronous tracker: the "
                "collision world must come from the frame being planned, and "
                "the pipelined path does not keep segmentations"
            )
        if roi_margin_mm is not None and target_ras is not None:
            raise ValueError(
                "ROI ingest crops the body out of the frame; per-frame "
                "re-planning needs the full scan (drop roi_margin_mm or target_ras)"
            )
        if roi_margin_mm is not None and pipelined:
            raise ValueError(
                "ROI ingest needs the synchronous tracker: the window is "
                "anchored on the PREVIOUS frame's result, which the "
                "pipelined path has not retired yet (drop roi_margin_mm "
                "or pipelined)"
            )
        self.engine = engine
        self.apply_correction = apply_correction
        self.pipelined = pipelined
        self.depth = depth
        self.target_ras = target_ras
        self.entry_ras = entry_ras
        self.safety_mm = safety_mm
        self.replan_every = replan_every
        self.last_plan = None
        self.tracer = Tracer()
        self.frames = 0
        self.failures = 0
        self.last_estimate: Optional[PoseEstimate] = None
        self._inflight: List[dict] = []
        self.roi_margin_mm = roi_margin_mm
        self._roi_shape: Optional[tuple] = None  # frozen window shape (voxels)
        self.roi_frames = 0  # frames served from the cropped window
        self.roi_fallbacks = 0  # ROI attempts that re-ran the full frame

    # ------------------------------------------------------------ ROI ingest
    def _host_fk_markers(self, angles, base_tf) -> np.ndarray:
        """Marker world positions by host FK (`core.robot.fk_all_links_host`):
        the window anchor runs every frame and needs no device round trip.
        Marker locals and indices are taken to the host once."""
        if not hasattr(self, "_host_model"):
            m = self.engine.model
            self._host_model = {
                "marker_local": m.marker_local.cpu().numpy().astype(np.float64),
                "marker_idx": [m.link_index(ln) for ln in MARKER_LINKS],
            }
        hm = self._host_model
        world = fk_all_links_host(self.engine.model, angles, base_tf)
        pts = []
        for li in hm["marker_idx"]:
            tf = world[li]
            pts.append(hm["marker_local"][li] @ tf[:3, :3].T + tf[:3, 3])
        return np.concatenate(pts)

    def _marker_bbox_vox(self, volume: Volume) -> Optional[np.ndarray]:
        """Predicted marker bounding box (index coords) from the last pose."""
        est = self.last_estimate
        if est is None or not est.success or est.baseplate_tf is None:
            return None
        pts = self._host_fk_markers(est.angles_rad, est.baseplate_tf)
        return np.stack([volume.ras_to_index(p) for p in pts])

    def _crop_roi(self, volume: Volume) -> Optional[Volume]:
        """Fixed-shape window around the predicted markers, or None when no
        previous pose anchors it (first frame / after a failure)."""
        idx = self._marker_bbox_vox(volume)
        if idx is None:
            return None
        margin = np.ceil(self.roi_margin_mm / np.asarray(volume.spacing)).astype(int)
        lo = np.floor(idx.min(0)).astype(int) - margin
        hi = np.ceil(idx.max(0)).astype(int) + margin + 1
        shape = np.asarray(volume.shape)
        if self._roi_shape is None:
            # freeze the window shape on first use, rounded up to multiples of
            # 8 voxels and clamped to the full frame (the segmentation pads
            # to its kernel tiles itself)
            want = hi - lo
            want = np.minimum(-(-want // 8) * 8, shape)
            self._roi_shape = tuple(int(w) for w in want)
        want = np.asarray(self._roi_shape)
        if np.any(want > shape):
            # the frozen window no longer fits (the scanner's field of view
            # shrank mid-sequence): a clip against a negative upper bound
            # would wrap the slice, so take the full frame instead
            return None
        if np.prod(want) >= 0.9 * np.prod(shape):
            return None  # window ~ the whole frame; ROI buys nothing
        center = (lo + hi) // 2
        start = np.clip(center - want // 2, 0, shape - want)
        # a pose drift that pushes the true bbox outside the clamped window
        # is caught by the success check -> full-frame fallback
        sl = tuple(slice(int(s), int(s + w)) for s, w in zip(start, want))
        return Volume(
            data=volume.data[sl],
            spacing=volume.spacing,
            origin=volume.origin + volume.spacing * start.astype(np.float32),
        )

    def step(self, volume: Volume) -> Optional[PoseEstimate]:
        """Process one scan. Synchronous mode returns the frame's estimate;
        pipelined mode returns the estimate of the frame `depth` steps back
        (None while the pipeline fills: call `flush()` at end of stream)."""
        t0 = time.perf_counter()
        if not self.pipelined:
            keep = self.target_ras is not None
            roi = self._crop_roi(volume) if self.roi_margin_mm is not None else None
            if roi is not None:
                # ROI frames never overwrite the engine's body segmentation
                result = self.engine.estimate_pose(
                    roi, apply_correction=self.apply_correction,
                    keep_segmentation=False, store_state=True,
                )
                if result.success:
                    self.roi_frames += 1
                else:
                    self.roi_fallbacks += 1
                    result = self.engine.estimate_pose(
                        volume, apply_correction=self.apply_correction, keep_segmentation=keep
                    )
            else:
                # re-plan frames keep the segmentation: the body world used
                # for collision checking is rebuilt from THIS frame's scan
                result = self.engine.estimate_pose(
                    volume, apply_correction=self.apply_correction, keep_segmentation=keep
                )
        else:
            self._inflight.append(
                self.engine.estimate_pose_async(volume, apply_correction=self.apply_correction)
            )
            result = None
            if len(self._inflight) > self.depth:
                result = self.engine.estimate_pose_collect(self._inflight.pop(0))
        self.tracer.spans["frame"].append(time.perf_counter() - t0)
        if result is not None:
            self._count(result)
        return result

    def flush(self) -> List[PoseEstimate]:
        """Collect every in-flight frame (pipelined mode, end of stream)."""
        out = []
        while self._inflight:
            result = self.engine.estimate_pose_collect(self._inflight.pop(0))
            self._count(result)
            out.append(result)
        return out

    def _count(self, result: PoseEstimate) -> None:
        self.frames += 1
        if not result.success:
            self.failures += 1
        self.last_estimate = result
        if (
            self.target_ras is not None
            and result.success
            and (self.frames % self.replan_every) == 0
        ):
            t0 = time.perf_counter()
            # the engine dropped its collision world when this frame's
            # segmentation was kept, so the plan's world IS this frame's
            self.last_plan = self.engine.plan_heuristic_path(
                self.target_ras,
                self.entry_ras,
                self.safety_mm,
                start_pose_steps=result.steps,
            )
            self.tracer.spans["replan"].append(time.perf_counter() - t0)

    def stats(self) -> dict:
        s = self.tracer.stats("frame")
        out = {
            "frames": self.frames,
            "failures": self.failures,
            "p50_latency_ms": round(s.get("p50_s", 0.0) * 1e3, 2) if s else None,
            "max_latency_ms": round(s.get("max_s", 0.0) * 1e3, 2) if s else None,
            "interactive": bool(s and s["p50_s"] < 0.1),  # < 100 ms target
        }
        r = self.tracer.stats("replan")
        if r:
            out["replan_p50_ms"] = round(r["p50_s"] * 1e3, 2)
        if self.roi_margin_mm is not None:
            out["roi_frames"] = self.roi_frames
            out["roi_fallbacks"] = self.roi_fallbacks
            if self._roi_shape is not None:
                out["roi_shape"] = list(self._roi_shape)
        return out
