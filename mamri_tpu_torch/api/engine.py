"""MamriEngine — mamri_tpu's facade on PyTorch: pose estimation (single,
batched, asynchronous), entry search and collision-checked planning, scene
export and the hardware loop.

Port of `mamri_tpu/api/engine.py` (`_LRUCache`, `MamriEngine`,
`HardwareStack`), every public method of both, with the reference's tracer
spans and, inside the scan -> pose path, the port's own (`estimate_pose`).
The per-volume program (segmentation -> triplet matching in the
`best`, `strict` or `global` mode -> baseplate fit -> full-chain IK -> motor
steps) is three stages on the engine's device, cached per (shape, params)
as the reference caches its jitted programs; on a card `estimate_pose`
replays each stage as a CUDA graph from a key's second call (one host
launch a stage in place of hundreds of small ops), and everything else
runs the stages eagerly; the host reads the certificates
and results with one synchronization per attempt (`_fetch`) and escalates
the segmentation budgets exactly as the reference does. A batch is a loop of
that program over its volumes on one stream, fetched once per batch (and
once per escalation round); planning builds the collision world once per
body on the engine's device and returns each result through one fetch.
`link_world_transforms` and the exports run the FK on the engine's device
(a path's samples in one batched call) and fetch once; the hardware loop's
per-tick paths (`attach_hardware`'s pose callback, `HardwareStack.status`)
use the host FK and never touch the device.
"""

from __future__ import annotations

import contextlib
import gc
import json
import logging
import math
import os
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mamri_tpu_torch import _build
from mamri_tpu_torch.api.types import ActionState, PoseEstimate, TrajectoryPlan
from mamri_tpu_torch.core import transforms
from mamri_tpu_torch.core.robot import RobotModel, fk_all_links, fk_all_links_host, load_robot_model
from mamri_tpu_torch.core.units import angles_to_steps, angles_to_steps_host, steps_to_angles_host
from mamri_tpu_torch.ik.residuals import random_restart_guesses, solve_full_chain_ik
from mamri_tpu_torch.perception.segmentation import SegmentationParams, segment_volume
from mamri_tpu_torch.perception.volume import Volume
from mamri_tpu_torch.planning.collision import build_collision_world
from mamri_tpu_torch.planning.entry import EntryPointResult, find_entry_point
from mamri_tpu_torch.planning.geometry import ArmGeometry, build_arm_geometry
from mamri_tpu_torch.planning.heuristic import check_path_collisions, heuristic_keyframes, interpolate_path
from mamri_tpu_torch.planning.trajectory import TrajectoryIKResult, solve_trajectory_ik
from mamri_tpu_torch.registration.kabsch import kabsch_rigid_transform
from mamri_tpu_torch.registration.lshape import match_l_shaped_triplets, match_l_shaped_triplets_global
from mamri_tpu_torch.utils.trace import Tracer, counts_recorded, current_count, current_span

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
        raise RuntimeError(
            "MamriEngine(device='cuda'): torch.cuda.is_available() is False: no CUDA card "
            "(pass device='cpu', or --platform cpu on the command line, for the CPU)"
        )
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


# the per-volume program's arguments, in the order a pipeline takes them
PIPELINE_ARGS = (
    "data", "spacing", "origin", "saved_tf", "use_saved", "have_saved", "apply_correction", "current_angles",
)
# one CUDA graph capture at a time in a process (torch.cuda.graph's rule)
_CAPTURE_LOCK = threading.Lock()


class _Stage(NamedTuple):
    span: Optional[str]  # the tracer span around the stage; None: the root's own time
    run: Callable[[dict], dict]  # {name: tensor so far} -> the stage's new {name: tensor or tuple of them}


def _stage_span(stage: _Stage):
    return current_span(stage.span) if stage.span is not None else contextlib.nullcontext()


def _run_stages(stages: Tuple[_Stage, ...], outputs: Callable[[dict], dict], args: tuple) -> dict:
    """The stages run eagerly on `args` (`PIPELINE_ARGS`), each in its span."""
    env = dict(zip(PIPELINE_ARGS, args))
    for stage in stages:
        with _stage_span(stage):
            env.update(stage.run(env))
    return outputs(env)


class _Pipeline:
    """The per-volume program of one (shape, params) as its stages, each a
    function of the tensors the stages before it made, and `outputs`, which
    picks the result dict from them and computes nothing. Called with
    `PIPELINE_ARGS` it runs the stages eagerly, each in its span; that is
    the only code of the program, which `_StageGraphs` captures stage by
    stage. A cached pipeline keeps its graph dispatch per scan dtype, so an
    evicted entry frees its graphs and their memory pool (no reference
    cycle holds them for the garbage collector)."""

    def __init__(self, stages: Tuple[_Stage, ...], outputs: Callable[[dict], dict]):
        self.stages, self.outputs = stages, outputs
        self._graphs: Dict[torch.dtype, "_StageGraphs"] = {}
        self._graphs_lock = threading.Lock()

    def __call__(self, *args) -> dict:
        return _run_stages(self.stages, self.outputs, args)

    def stage_graphs(self, dtype: torch.dtype) -> "_StageGraphs":
        with self._graphs_lock:
            if dtype not in self._graphs:
                self._graphs[dtype] = _StageGraphs(self.stages, self.outputs)
            return self._graphs[dtype]


def _graphs_run_on(device: torch.device) -> bool:
    """Whether `estimate_pose` dispatches its pipelines as CUDA graphs on
    `device`: on a card; the CPU runs them eagerly."""
    return device.type == "cuda"


class _CudaStageGraph:
    """One stage captured as a `torch.cuda.CUDAGraph` whose memory comes
    from `pool`: `out` holds the stage's outputs, which each `replay` (on the
    current stream) writes anew from the tensors the capture read."""

    @staticmethod
    def new_pool():
        return torch.cuda.graph_pool_handle()

    def __init__(self, run: Callable[[dict], dict], env: dict, pool):
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
            self.out = run(env)

    def replay(self) -> None:
        self.graph.replay()


class _StageGraphs:
    """`estimate_pose`'s dispatch of one cached pipeline for one scan dtype
    on a card. The first call runs the stages eagerly (the warm-up a
    capture needs: every table and workspace made, in the capturing thread
    too, which runs them eagerly first where it has not); the second captures
    each stage as one graph (`_CudaStageGraph`), all in one memory pool, each
    reading the static outputs of the one before, with clones of that
    call's arguments as the static inputs; every call from then on finds
    its scan uploaded into `inputs` (or copies its arguments there) and
    replays the graphs in order, each in its stage's span. A graph runs the
    kernels its capture queued, so the answers are those of the eager
    stages. The caller holds `lock` from the copy-in until its last fetch of
    the outputs, which the next replay overwrites.

    Counters of the request (`current_count`): `pose.eager_stages` per stage
    run eagerly, `pose.graph_captures` per stage captured,
    `pose.graph_replays` per stage replayed. A replay also adds what its
    capture recorded of `_build.LAUNCHES` and of the tracer's counters
    (`ik.lm.fused_solves`, `registration.kabsch_fused`): launches that ran."""

    def __init__(self, stages: Tuple[_Stage, ...], outputs: Callable[[dict], dict]):
        self.stages, self.outputs = stages, outputs
        self.lock = threading.Lock()
        self.calls = 0
        self.inputs: Optional[tuple] = None  # the static inputs, once captured
        self._env: Optional[dict] = None  # every static tensor, by name
        self._graphs: tuple = ()  # (graph, launches, counts) per stage
        self._ran = threading.local()  # `done` in each thread that has run the stages eagerly

    def _run_eagerly(self, args: tuple) -> dict:
        current_count("pose.eager_stages", len(self.stages))
        self._ran.done = True
        return _run_stages(self.stages, self.outputs, args)

    def run(self, args: tuple) -> dict:
        """The pipeline's outputs for `args` (`PIPELINE_ARGS` on the card),
        with `lock` held."""
        if self.inputs is None:
            self.calls += 1
            if self.calls == 1:
                return self._run_eagerly(args)
            if not getattr(self._ran, "done", False):
                # what the stages make lazily per thread (cuBLAS handles and
                # workspaces) cannot be made inside a capture
                self._run_eagerly(args)
            self._capture(args)
        elif args is not self.inputs:
            for static, arg in zip(self.inputs, args):
                static.copy_(arg)
        for stage, (graph, launches, counts) in zip(self.stages, self._graphs):
            with _stage_span(stage):
                graph.replay()
            _build.add_launches(launches)
            for name, n in counts.items():
                current_count(name, n)
            current_count("pose.graph_replays")
        return self.outputs(self._env)

    def _capture(self, args: tuple) -> None:
        inputs = tuple(a.clone() for a in args)
        env = dict(zip(PIPELINE_ARGS, inputs))
        graphs = []
        with _CAPTURE_LOCK:
            # a graph destroyed in this thread during a capture ends it: free
            # the garbage first, and let no collection run inside
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            try:
                pool = _CudaStageGraph.new_pool()
                for stage in self.stages:
                    with _build.launches_recorded() as launches, counts_recorded() as counts:
                        graph = _CudaStageGraph(stage.run, env, pool)
                    env.update(graph.out)
                    graphs.append((graph, launches, counts))
                    current_count("pose.graph_captures")
            finally:
                if collecting:
                    gc.enable()
        self.inputs, self._env, self._graphs = inputs, env, tuple(graphs)


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
        if match_mode not in ("best", "strict", "global"):
            raise ValueError(
                f"match_mode must be 'best' (min-error greedy), 'strict' "
                f"(reference first-match greedy) or 'global' (exhaustive "
                f"assignment), got {match_mode!r}"
            )
        self.device = _resolve_device(device)
        self.model: RobotModel = load_robot_model(config_path, device=self.device)
        # part clouds for the collision checks (STL parts from `mesh_dir` where
        # it holds them, capsules otherwise), on the engine's device
        self.geometry: ArmGeometry = build_arm_geometry(self.model, mesh_dir)
        self.mesh_dir = mesh_dir
        self._exact_parts = None  # dense hulls for validate_plan_exact, built on first use
        self._steps_per_rev = self.model.steps_per_rev.cpu().numpy()
        self._needle_tip = self.model.needle_tip.cpu().numpy()  # the exports place the needle on the host
        self._needle_axis = self.model.needle_axis.cpu().numpy()
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
        self.hardware = None  # HardwareStack, attached on demand
        self._pipeline_cache = _LRUCache(jit_cache_size)
        self._restarts: Dict[int, torch.Tensor] = {}  # the IK's restart draws by count (`_restart_guesses`)

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

    def _base_or_eye(self) -> np.ndarray:
        return self.baseplate_tf if self.baseplate_tf is not None else np.eye(4, dtype=np.float32)

    def _link_world_transforms_dev(self, angles_rad=None) -> torch.Tensor:
        """(L, 4, 4) float32 FK of every link on the engine's device, from the
        baseplate (the identity before one is known)."""
        a = self.current_angles if angles_rad is None else np.asarray(angles_rad, dtype=np.float32)
        f32 = torch.float32
        return fk_all_links(self.model, self._upload(a, f32), self._upload(self._base_or_eye(), f32))

    def link_world_transforms(self, angles_rad=None) -> np.ndarray:
        """(L, 4, 4) world transforms of every link at the current (or given)
        angles: FK on the engine's device, one fetch."""
        return self._fetch({"tfs": self._link_world_transforms_dev(angles_rad)})["tfs"]

    def needle_tcp(self, angles_rad=None) -> np.ndarray:
        """World transform of the needle TCP."""
        return self.link_world_transforms(angles_rad)[self.model.link_index("Needle")]

    def _path_fk(self) -> Tuple[np.ndarray, np.ndarray]:
        """(S, L, 4, 4) FK of every sample of `trajectory_path` and the (S, 3)
        needle tips: one batched FK on the engine's device, one fetch."""
        f32 = torch.float32
        base = self._upload(self._base_or_eye(), f32)
        tfs = fk_all_links(self.model, self._upload(self.trajectory_path, f32), base)
        ntf = tfs[:, self.model.link_index("Needle")]
        tips = torch.einsum("sij,j->si", ntf[:, :3, :3], self.model.needle_tip) + ntf[:, :3, 3]
        out = self._fetch({"tfs": tfs, "tips": tips})
        return out["tfs"], out["tips"]

    # ---------------------------------------------------------------- scene export
    def export_posed_meshes(self, out_dir: str, mesh_dir: str, angles_rad=None) -> list:
        """Write the robot's visual meshes FK-posed at the current (or given)
        angles as binary STLs; returns the written paths. Missing mesh files
        are skipped."""
        from mamri_tpu_torch.utils.stl import load_stl, save_stl, transform_triangles

        os.makedirs(out_dir, exist_ok=True)
        tfs = self.link_world_transforms(angles_rad)
        written = []
        for i, spec in enumerate(self.model.specs):
            if not spec.visual_mesh:
                continue
            src = os.path.join(mesh_dir, spec.visual_mesh)
            if not os.path.exists(src):
                logger.info("skipping missing mesh %s", src)
                continue
            dst = os.path.join(out_dir, f"{spec.name}_posed.stl")
            save_stl(dst, transform_triangles(load_stl(src), tfs[i]))
            written.append(dst)
        return written

    def _link_meshes(self, mesh_dir: Optional[str]) -> list:
        """[(link name, link-local triangles, link index)] of every link but
        the needle: its STL from `mesh_dir` where there is one, else a
        capsule as long as the offset to its child."""
        from mamri_tpu_torch.planning.geometry import DEFAULT_PART_RADIUS_MM, MIN_PART_LENGTH_MM
        from mamri_tpu_torch.utils.scene import capsule_mesh
        from mamri_tpu_torch.utils.stl import load_stl

        meshes = []
        for i, spec in enumerate(self.model.specs):
            if spec.name == "Needle":
                continue  # a generated cylinder (the reference's Needle.STL is stripped)
            tris = None
            if mesh_dir is not None and spec.visual_mesh:
                src = os.path.join(mesh_dir, spec.visual_mesh)
                if os.path.exists(src):
                    tris = load_stl(src)
            if tris is None:
                child = next((s for s in self.model.specs if s.parent == i), None)
                length = float(np.linalg.norm(child.offset_mm)) if child is not None else 0.0
                tris = capsule_mesh(max(length, MIN_PART_LENGTH_MM), DEFAULT_PART_RADIUS_MM)
            meshes.append((spec.name, tris, i))
        return meshes

    def _body_surface(self, body_surface: str):
        """The segmented body's surface (exposed voxel faces, or "smooth":
        marching tetrahedra), or None without a body."""
        from mamri_tpu_torch.utils.scene import marching_tetrahedra_mesh, voxel_surface_mesh

        if not self._has_body():
            return None
        spacing, origin = self.last_volume_geom
        surface_fn = marching_tetrahedra_mesh if body_surface == "smooth" else voxel_surface_mesh
        return surface_fn(self.last_segmentation["body_mask"], spacing, origin)

    def _scene_objects(
        self,
        mesh_dir: Optional[str] = None,
        angles_rad=None,
        include_body: bool = True,
        include_trajectory: bool = True,
        target_ras=None,
        entry_ras=None,
        needle_length_mm: float = 100.0,
        needle_radius_mm: float = 1.5,
        body_surface: str = "voxel",
    ):
        """The 3-D scene as (named triangle soups, named polylines): the
        FK-posed links, the needle cylinder, the body surface, the planned
        path's needle-tip polyline and the entry -> target segment."""
        from mamri_tpu_torch.utils.scene import cylinder_mesh
        from mamri_tpu_torch.utils.stl import transform_triangles

        tfs = self.link_world_transforms(angles_rad)
        objects = [(name, transform_triangles(tris, tfs[i])) for name, tris, i in self._link_meshes(mesh_dir)]
        # the needle shaft from the config's tip and axis on the Needle link frame
        ntf = tfs[self.model.link_index("Needle")]
        tip = (ntf[:3, :3] @ self._needle_tip) + ntf[:3, 3]
        axis = ntf[:3, :3] @ self._needle_axis
        axis = axis / max(float(np.linalg.norm(axis)), 1e-9)
        objects.append(("Needle", cylinder_mesh(tip, tip + axis * needle_length_mm, needle_radius_mm)))
        if include_body:
            body = self._body_surface(body_surface)
            if body is not None:
                objects.append(("Body", body))

        polylines = []
        if include_trajectory and self.trajectory_path is not None:
            polylines.append(("TrajectoryTipPath", self._path_fk()[1]))
        if target_ras is not None and entry_ras is not None:
            polylines.append(
                ("InsertionSegment", np.stack([np.asarray(entry_ras), np.asarray(target_ras)]).astype(np.float32))
            )
        return objects, polylines

    def export_scene(self, path: str, **scene_kw) -> dict:
        """Write the assembled scene (`_scene_objects`) as Wavefront OBJ,
        binary glTF (`.glb`) or a self-contained WebGL viewer (`.html`).
        Returns {object name: triangle / vertex count}."""
        from mamri_tpu_torch.utils.glb import write_glb
        from mamri_tpu_torch.utils.html_viewer import write_html_scene
        from mamri_tpu_torch.utils.scene import write_obj

        objects, polylines = self._scene_objects(**scene_kw)
        lower = path.lower()
        if lower.endswith(".glb"):
            writer = write_glb
        elif lower.endswith((".html", ".htm")):
            writer = write_html_scene
        else:
            writer = write_obj
        writer(path, objects, polylines)
        summary = {name: int(len(t)) for name, t in objects}
        summary.update({name: int(len(p)) for name, p in polylines})
        return summary

    def export_trajectory_html(
        self,
        path: str,
        mesh_dir: Optional[str] = None,
        target_ras=None,
        entry_ras=None,
        needle_length_mm: float = 100.0,
        needle_radius_mm: float = 1.5,
        body_surface: str = "voxel",
        interval_ms: int = 50,
    ) -> dict:
        """Write an animated viewer of the planned trajectory: link meshes
        once in link-local frames, per-frame transforms from the FK over
        `trajectory_path`, a frame slider and play / pause at `interval_ms`."""
        from mamri_tpu_torch.utils.html_viewer import write_html_scene
        from mamri_tpu_torch.utils.scene import cylinder_mesh

        if self.trajectory_path is None:
            raise RuntimeError("no trajectory planned; run plan_heuristic_path first")
        tfs, tips = self._path_fk()
        objects = self._link_meshes(mesh_dir)
        # the needle shaft in the Needle link's local frame
        tip = self._needle_tip.astype(np.float64)
        axis = self._needle_axis.astype(np.float64)
        axis = axis / max(float(np.linalg.norm(axis)), 1e-9)
        objects.append(
            ("Needle", cylinder_mesh(tip, tip + axis * needle_length_mm, needle_radius_mm),
             self.model.link_index("Needle"))
        )
        body = self._body_surface(body_surface)
        if body is not None:
            objects.append(("Body", body))
        polylines = [("TrajectoryTipPath", tips)]
        if target_ras is not None and entry_ras is not None:
            polylines.append(
                ("InsertionSegment", np.stack([np.asarray(entry_ras), np.asarray(target_ras)]).astype(np.float32))
            )
        write_html_scene(
            path, objects, polylines,
            anim={"transforms": tfs, "interval_ms": interval_ms},
            title="mamri trajectory simulation",
        )
        summary = {name: int(len(t)) for name, t, *_ in objects}
        summary["frames"] = int(tfs.shape[0])
        return summary

    def render_scene(
        self,
        path: str,
        mesh_dir: Optional[str] = None,
        angles_rad=None,
        width: int = 960,
        height: int = 720,
        azim_deg: float = 35.0,
        elev_deg: float = 22.0,
        target_ras=None,
        entry_ras=None,
        body_surface: str = "voxel",
    ) -> Tuple[int, int]:
        """Render the assembled scene (`export_scene`'s contents) to a PNG
        with the numpy rasterizer of `utils/render.py`; returns (width,
        height)."""
        from mamri_tpu_torch.utils.render import rasterize, write_png

        objects, polylines = self._scene_objects(
            mesh_dir=mesh_dir,
            angles_rad=angles_rad,
            target_ras=target_ras,
            entry_ras=entry_ras,
            body_surface=body_surface,
        )
        img = rasterize(objects, polylines, width=width, height=height, azim_deg=azim_deg, elev_deg=elev_deg)
        write_png(path, img)
        return (width, height)

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
    def pipeline_fn(self, seg_params: Optional[SegmentationParams] = None, seg_fn=None) -> "_Pipeline":
        """The per-volume program: segmentation -> matching -> baseplate ->
        full-chain IK -> steps, as three stages over one dict of tensors
        (`_Pipeline`). Called with `PIPELINE_ARGS` on the engine's device, it
        runs the stages eagerly and returns their outputs (a dict with the
        reference's keys). It queues its work and reads nothing back, so a
        caller waits only where it fetches.

        `seg_fn` replaces the segmentation stage (the signature of
        `segment_volume`): the mesh's sharded path puts
        `segment_volume_sharded` here, and everything downstream works on
        the whole-volume blob stats unchanged."""
        model = self.model
        seg_params = seg_params if seg_params is not None else self.seg_params
        seg_fn = seg_fn if seg_fn is not None else segment_volume
        arm_lengths = self._arm_lengths
        bp_local = model.marker_local[model.link_index("Baseplate")]
        ik_iters, ik_restarts = self.ik_iters, self.ik_restarts
        restarts = self._restart_guesses(ik_restarts)
        match_mode = self.match_mode

        def segment(v):
            return {"seg": seg_fn(v["data"], v["spacing"], v["origin"], seg_params)}

        def match(v):
            seg = v["seg"]
            if match_mode == "global":
                matches = match_l_shaped_triplets_global(seg.centroids_ras, seg.blob_valid, arm_lengths)
            else:
                matches = match_l_shaped_triplets(
                    seg.centroids_ras, seg.blob_valid, arm_lengths, strict_reference_order=match_mode == "strict"
                )
            bp_found = matches.found[0]
            # baseplate: Y-flatten the detected markers, then the rigid fit
            bp_pts = matches.points[0]
            bp_pts = torch.stack([bp_pts[:, 0], bp_pts[:, 1].mean().expand(3), bp_pts[:, 2]], dim=1)
            detected_tf = kabsch_rigid_transform(bp_local, bp_pts)

            # priority: saved-if-requested > detected > saved fallback
            saved_tf, have_saved = v["saved_tf"], v["have_saved"]
            use_saved_now = v["use_saved"] & have_saved
            fallback_saved = ~bp_found & have_saved
            base_tf = torch.where(use_saved_now, saved_tf, torch.where(bp_found, detected_tf, saved_tf))
            base_ok = use_saved_now | bp_found | fallback_saved
            # 0=none 1=detected 2=saved 3=saved_fallback
            source = torch.where(
                use_saved_now, 2, torch.where(bp_found, 1, torch.where(fallback_saved, 3, 0))
            ).to(torch.int32)
            return {"matches": matches, "base_tf": base_tf, "base_ok": base_ok, "base_source": source}

        def ik(v):
            matches = v["matches"]
            ik = solve_full_chain_ik(
                model,
                matches.points[3],
                v["base_tf"],
                current_angles=v["current_angles"],
                apply_correction=v["apply_correction"],
                joint4_targets=matches.points[2],
                joint4_found=matches.found[2],
                num_iters=ik_iters,
                num_random_restarts=ik_restarts,
                joint2_targets=matches.points[1],
                joint2_found=matches.found[1],
                restart_guesses=restarts,
            )
            steps = angles_to_steps(ik.angles, model.steps_per_rev)
            return {"ik": ik, "steps": steps, "success": v["base_ok"] & matches.found[3]}

        def outputs(v):
            seg, ik = v["seg"], v["ik"]
            return {
                "success": v["success"],
                "angles": ik.angles,
                "steps": v["steps"],
                "rmse": ik.rmse,
                "base_tf": v["base_tf"],
                "base_ok": v["base_ok"],
                "base_source": v["base_source"],
                "markers_found": v["matches"].found,
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

        return _Pipeline(
            (_Stage("pose.segment", segment), _Stage(None, match), _Stage("pose.ik", ik)), outputs
        )

    def _restart_guesses(self, count: int) -> Optional[torch.Tensor]:
        """The pose IK's `count` random restarts on the engine's device,
        `random_restart_guesses(model, count, 0)` drawn once per count, so no
        pose copies them from the host; None for no restarts."""
        if count <= 0:
            return None
        guesses = self._restarts.get(count)
        if guesses is None:
            guesses = self._restarts.setdefault(count, random_restart_guesses(self.model, count, 0))
        return guesses

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

    def _upload(self, v, dtype=None, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A host value on the engine's device (in `out` where given), queued
        without a wait: a copy from pageable memory is staged before the call
        returns, so the host array may change after it."""
        host = torch.as_tensor(v, dtype=dtype)
        if out is None:
            return host.to(self.device, non_blocking=True)
        return out.copy_(host, non_blocking=True)

    def _pipeline_args(self, volume: Volume, use_saved_baseplate: bool, apply_correction: bool, into=None) -> tuple:
        """The pipeline's arguments (`PIPELINE_ARGS`) for one scan and the
        engine's state now (span `pose.upload`, counter
        `pose.upload_bytes`): new tensors, or `into` with the values copied
        in (a graph's static inputs)."""
        saved = self.saved_baseplate if self.saved_baseplate is not None else np.eye(4, dtype=np.float32)
        f32 = torch.float32
        host = (
            (volume.data, None),
            (volume.spacing, f32),
            (volume.origin, f32),
            (saved, f32),
            (bool(use_saved_baseplate), None),
            (self.saved_baseplate is not None, None),
            (bool(apply_correction), None),
            (self.current_angles, f32),
        )
        with current_span("pose.upload"):
            if into is None:
                args = tuple(self._upload(v, dtype) for v, dtype in host)
            else:
                args = tuple(self._upload(v, dtype, out) for (v, dtype), out in zip(host, into))
        current_count("pose.upload_bytes", sum(a.nbytes for a in args))
        return into if into is not None else args

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
        segmentation budgets until every certificate holds. On a card each
        cached pipeline is dispatched by its `_StageGraphs`: eager on its
        first call, replayed as CUDA graphs from its second, the scan
        uploaded straight into the graphs' static inputs. Under an enabled
        tracer the call is one request: the root span `estimate_pose` (the
        upload included), `pose.upload`, per attempt `pose.segment`,
        `pose.ik` and `pose.fetch` (and the body mask's `pose.fetch`), and
        the counters `pose.upload_bytes`, `pose.attempts`,
        `pose.eager_stages`, `pose.graph_captures` and `pose.graph_replays`."""
        with self.tracer.span("estimate_pose"):
            # the locks of the graphs whose static buffers this call uses, held until its last fetch
            with contextlib.ExitStack() as held:
                params = self.seg_params
                graphs = self._stage_graphs(volume, params, held)
                args = self._pipeline_args(
                    volume, use_saved_baseplate, apply_correction, into=graphs.inputs if graphs is not None else None
                )
                while True:
                    current_count("pose.attempts")
                    if graphs is not None:
                        dev_out = graphs.run(args)
                    else:
                        dev_out = self._get_pipeline(volume.shape, params)(*args)
                    # ONE host sync per attempt: certificates and results come back
                    # together; the body mask only once certification settles, and
                    # only when the caller keeps the segmentation
                    mask = dev_out.pop("body_mask")
                    with current_span("pose.fetch"):
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
                    graphs = self._stage_graphs(volume, params, held)
                if keep_segmentation:
                    with current_span("pose.fetch"):
                        out.update(self._fetch({"body_mask": mask}))
            return self._finish_estimate(out, volume, store_state, keep_segmentation)

    def _stage_graphs(self, volume: Volume, params: SegmentationParams, held: contextlib.ExitStack):
        """The graph dispatch (`_StageGraphs`) of the cached pipeline for
        `volume`'s shape and dtype at `params`, its lock taken into `held`;
        None off the card, where `estimate_pose` runs the pipeline eagerly."""
        if not _graphs_run_on(self.device):
            return None
        graphs = self._get_pipeline(volume.shape, params).stage_graphs(torch.as_tensor(volume.data).dtype)
        held.enter_context(graphs.lock)
        return graphs

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
        data = self._upload(data_np)
        fixed = self._batch_fixed(spacing, origin, apply_correction)
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

    def _batch_fixed(self, spacing, origin, apply_correction) -> tuple:
        """The per-volume program's arguments after the scan for every volume
        of a batch: no saved baseplate, zero current angles."""
        f32 = torch.float32
        return (
            self._upload(spacing, f32),
            self._upload(origin, f32),
            self._upload(np.eye(4, dtype=np.float32)),
            self._upload(False),
            self._upload(False),
            self._upload(bool(apply_correction)),
            self._upload(np.zeros(self.model.num_joints, dtype=np.float32)),
        )

    def _get_batch_pipeline(self, vol_shape, params: SegmentationParams, microbatch: Optional[int] = None):
        """The reference's batch hook (mamri_tpu/api/engine.py:632) over
        `_run_batch`: fn(data, spacing, origin, apply_correction) -> {key:
        (B, ...) host array} for a (B, *vol_shape) batch already on the
        engine's device, at `params` with no escalation, one fetch per
        `microbatch` volumes."""

        def batched(data, spacing, origin, apply_correction=False):
            if tuple(data.shape[1:]) != tuple(vol_shape):
                raise ValueError(f"batch of {tuple(data.shape[1:])} volumes, pipeline for {tuple(vol_shape)}")
            if microbatch is not None and data.shape[0] % microbatch:
                raise ValueError(f"microbatch {microbatch} must divide batch {data.shape[0]}")
            fixed = self._batch_fixed(spacing, origin, apply_correction)
            return self._run_batch(data, np.arange(data.shape[0]), params, fixed, microbatch)

        return batched

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

    # ---------------------------------------------------------------- observability, gating, tables
    def describe_ik_solution(self, joint6_targets, joint4_targets=None, apply_correction: bool = False) -> str:
        """Per-marker predicted-vs-target report at the current pose (the
        reference's `_log_ik_solution_details`): the markers placed by FK
        and `transforms.apply` on the engine's device, one fetch."""
        if self.baseplate_tf is None:
            return "no baseplate transform; run estimate_pose first"
        lines = ["--- IK Solution Details ---"]
        for name, angle in zip(self.model.articulated_names, np.rad2deg(self.current_angles)):
            lines.append(f"  - {name}: {angle:.2f} deg")
        if self.last_ik_error is not None:
            lines.append(f"RMSE: {self.last_ik_error:.4f} mm")
        tfs = self._link_world_transforms_dev()
        correction = self._upload(np.array([-1.0, -1.0, 1.0], dtype=np.float32))
        compared = [("Joint6", joint6_targets, apply_correction)]
        if joint4_targets is not None:
            compared.append(("Joint4", joint4_targets, False))
        predicted = {}
        for link_name, _, corrected in compared:
            idx = self.model.link_index(link_name)
            local = self.model.marker_local[idx] * correction if corrected else self.model.marker_local[idx]
            predicted[link_name] = transforms.apply(tfs[idx], local)
        predicted = self._fetch(predicted)
        for link_name, targets, _ in compared:
            lines.append(f"--- Comparison for {link_name} markers ---")
            for i, (p, t) in enumerate(zip(predicted[link_name], np.asarray(targets))):
                err = float(np.linalg.norm(p - t))
                lines.append(
                    f"  M{i+1}: target ({t[0]:.2f}, {t[1]:.2f}, {t[2]:.2f})  "
                    f"predicted ({p[0]:.2f}, {p[1]:.2f}, {p[2]:.2f})  err {err:.3f} mm"
                )
        return "\n".join(lines)

    def available_actions(
        self,
        have_volume: bool = False,
        have_target: bool = False,
        have_entry: bool = False,
    ) -> Dict[str, ActionState]:
        """The reference's button gating (`_checkAllButtons`), headless: one
        `ActionState` per user-facing action, with the reference's text as
        the reason. The caller passes what it holds (a volume, a target, an
        entry); the rest (model built, trajectory planned, connections, a
        running task) is read from the engine and its attached hardware."""
        model_built = self.baseplate_tf is not None
        planned = self.trajectory_path is not None
        hw = self.hardware
        mc = hw is not None and hw.controller.is_connected
        enc = hw is not None and hw.encoder.is_connected
        executing = hw is not None and hw.runner.is_active

        def state(enabled, on, off):
            return ActionState(bool(enabled), on if enabled else off)

        idle = state(not executing, "Ready.", "A robot task is executing.")
        return {
            "estimate_pose": state(
                have_volume,
                "Run fiducial detection and robot model rendering.",
                "Select an input volume.",
            ),
            "plan_trajectory": state(
                have_target and have_entry and model_built,
                "Plan a collision-aware trajectory.",
                "Needs a target point, an entry point, and a pose estimate.",
            ),
            "zero_robot": state(
                model_built,
                "Sets all robot joint angles to zero in the simulation only.",
                "Run 'Start robot pose estimation' first to build the model.",
            ),
            "playback": state(
                planned, "Scrub / play the planned trajectory.", "No trajectory planned."
            ),
            "connect_controller": idle,
            "refresh_ports": idle,
            "connect_encoder": idle,
            "execute_trajectory": state(
                mc and self.trajectory_keyframes is not None and not executing,
                "Execute the planned trajectory on hardware.",
                "Connect the motor controller, plan a trajectory, and stop any running task.",
            ),
            "stop_trajectory": state(
                executing, "Stop the running robot task.", "No robot task is executing."
            ),
            "return_to_zero": state(
                mc and not executing,
                "Home all joints to zero.",
                "Connect the motor controller and stop any running task.",
            ),
            "move_to_pose": state(
                mc and not executing and self.last_estimated_steps is not None,
                "Move the robot to the last estimated pose.",
                "Needs a connected motor controller, no running task, and a pose estimate.",
            ),
            "manual_control": state(
                mc and not executing,
                "Jog individual joints.",
                "Connect the motor controller and stop any running task.",
            ),
            "zero_hardware": state(
                mc and enc and not executing,
                "Zero the encoder and motor controller hardware.",
                "Connect both encoder and motor controller to enable.",
            ),
            "encoder_command": state(
                enc and not executing,
                "Sends a manual command to the encoder.",
                "Connect to the encoder and stop any running tasks to enable.",
            ),
        }

    def pose_table(self, pose_rad=None, title: str = "Pose") -> list:
        """Rows of the reference's pose tables: a header, then (joint, steps,
        degrees) per articulated joint, "..." without a pose; steps as
        str(int), degrees as %.2f."""
        names = self.model.articulated_names
        rows = [(title, "Steps", "Degrees (°)")]
        if pose_rad is None:
            rows += [(n, "...", "...") for n in names]
            return rows
        pose = np.asarray(pose_rad, dtype=np.float64)
        steps = self.convert_angles_to_steps(pose)
        rows += [(n, str(int(s)), f"{math.degrees(a):.2f}") for n, s, a in zip(names, steps, pose)]
        return rows

    def playback(self, path=None, on_pose=None):
        """A playback cursor over the planned (or given) path that pushes each
        pose to `on_pose` (`set_pose` by default)."""
        from mamri_tpu_torch.api.playback import TrajectoryPlayback

        p = path if path is not None else self.trajectory_path
        if p is None:
            raise RuntimeError("no trajectory planned; run plan_heuristic_path first")
        return TrajectoryPlayback(p, on_pose=on_pose or self.set_pose)

    # ---------------------------------------------------------------- hardware
    @staticmethod
    def available_serial_ports():
        from mamri_tpu_torch.hw.transport import list_serial_ports

        return list_serial_ports()

    def attach_hardware(self, controller_transport, encoder_transport):
        """Bind the serial (or simulated) links and build the executor stack.

        Every control tick converts the encoder's steps to angles, sets the
        engine's pose and publishes one frame on the stack's `PoseStream`;
        the needle's world position in that frame comes from the host FK
        (`fk_all_links_host`): a device FK would add a launch chain and a
        synchronization to every 150 ms tick of the control loop."""
        from mamri_tpu_torch.hw.devices import EncoderLink, MotorControllerLink
        from mamri_tpu_torch.hw.executor import RobotTaskRunner
        from mamri_tpu_torch.hw.stream import PoseStream
        from mamri_tpu_torch.hw.sync import SyncMonitor

        controller = MotorControllerLink(controller_transport, motor_letters=self.model.motor_letters)
        encoder = EncoderLink(encoder_transport, num_joints=self.model.num_joints)
        if not controller.handshake():
            raise RuntimeError("motor controller handshake failed")
        if not encoder.handshake():
            controller.disconnect()
            raise RuntimeError("encoder handshake failed")

        stream = PoseStream()
        runner = RobotTaskRunner(
            controller,
            encoder,
            angles_to_steps=lambda a: self.convert_angles_to_steps(np.asarray(a)),
        )

        def pose_cb(steps):
            angles = self.convert_steps_to_angles(np.asarray(steps))
            self.set_pose(angles)
            frame = {
                "event": "pose",
                "t": time.time(),
                "steps": [int(s) for s in np.asarray(steps)],
                "angles_deg": np.rad2deg(angles).round(3).tolist(),
            }
            st = runner.state
            if st is not None:
                frame["mode"] = st.mode
                frame["target_steps"] = [int(s) for s in st.target_steps]
                if st.keyframes is not None:
                    frame["keyframe_index"] = st.keyframe_index
                    frame["num_keyframes"] = len(st.keyframes)
            if self.baseplate_tf is not None:
                tfs = fk_all_links_host(self.model, angles, self.baseplate_tf)
                frame["tcp_world"] = tfs[self.model.link_index("Needle")][:3, 3].round(3).tolist()
            stream.publish(frame)

        def finish_cb(state):
            stream.publish(
                {
                    "event": "task_finished",
                    "t": time.time(),
                    "mode": state.mode,
                    "outcome": state.outcome.value,
                    "message": state.message,
                }
            )

        runner.pose_callback = pose_cb
        runner.finish_callback = finish_cb
        sync = SyncMonitor(controller, encoder)
        self.hardware = HardwareStack(
            controller=controller, encoder=encoder, runner=runner, sync=sync,
            engine=self, stream=stream,
        )
        return self.hardware


class HardwareStack:
    """The connected hardware bundle (controller + encoder + executor + sync
    + the live pose stream); port of the reference's, its host FK included."""

    def __init__(self, controller, encoder, runner, sync, engine=None, stream=None):
        self.controller = controller
        self.encoder = encoder
        self.runner = runner
        self.sync = sync
        self.engine = engine
        # live pose pub/sub fed by the executor's per-tick callback
        # (attach_hardware); None only for hand-built stacks
        self.stream = stream

    def status(self) -> dict:
        """Live status: encoder / controller / target steps, the needle's
        world position (host FK of the controller's steps), the IK RMSE.
        Writes a 'P' query: for the controlling thread only."""
        encoder_steps = self.encoder.latest_position if self.encoder.is_connected else None
        controller_steps = self.controller.query_positions() if self.controller.is_connected else None
        target = None
        if self.runner.state is not None:
            target = self.runner.state.target_steps.tolist()
        out = {
            "encoder_steps": encoder_steps,
            "controller_steps": controller_steps,
            "target_steps": target,
            "task_active": self.runner.is_active,
            "ik_error_mm": self.engine.last_ik_error if self.engine else None,
            "tcp_world": None,
        }
        if self.engine is not None and controller_steps is not None and self.engine.baseplate_tf is not None:
            angles = self.engine.convert_steps_to_angles(np.asarray(controller_steps))
            tfs = fk_all_links_host(self.engine.model, angles, self.engine.baseplate_tf)
            out["tcp_world"] = tfs[self.engine.model.link_index("Needle")][:3, 3].tolist()
        return out

    def passive_status(self) -> dict:
        """A status that is safe from watcher threads: reads only the
        encoder's listener state and the runner's fields, never writes the
        single-writer serial command channel."""
        st = self.runner.state
        return {
            "event": "status",
            "encoder_steps": self.encoder.latest_position if self.encoder.is_connected else None,
            "task_active": self.runner.is_active,
            "target_steps": None if st is None else [int(s) for s in st.target_steps],
            "outcome": None if st is None else st.outcome.value,
        }

    def watch(self, max_frames=None, idle_timeout_s: float = 5.0):
        """Subscribe to the live pose stream and yield its frames; the
        subscription closes when the generator does."""
        if self.stream is None:
            raise RuntimeError("this HardwareStack has no pose stream attached")
        with self.stream.subscribe() as sub:
            yield from sub.frames(max_frames=max_frames, idle_timeout_s=idle_timeout_s)

    def joint_status_table(self, st: Optional[dict] = None) -> list:
        """Rows of the reference's live joint-status table: per joint,
        encoder / controller / target steps, "..." where a source is
        unavailable. Pass a `status()` snapshot to avoid a second 'P'
        round trip."""
        if st is None:
            st = self.status()
        names = (
            self.engine.model.articulated_names
            if self.engine is not None
            else tuple(f"J{i + 1}" for i in range(6))
        )
        rows = [("Joint", "Encoder (steps)", "Controller (steps)", "Target (steps)")]

        def col(values, i):
            return "..." if values is None else str(int(values[i]))

        rows += [
            (n, col(st["encoder_steps"], i), col(st["controller_steps"], i), col(st["target_steps"], i))
            for i, n in enumerate(names)
        ]
        return rows

    def move_to_pose(self, steps, **kw):
        return self.runner.start("move_to_pose", target_steps=steps, **kw)

    def execute_trajectory(self, keyframes, **kw):
        return self.runner.start("trajectory", keyframes=keyframes, **kw)

    def return_to_zero(self, num_joints: int = 6, **kw):
        return self.runner.start("homing", target_steps=[0] * num_joints, **kw)

    def jog(self, joint_index: int, delta_steps: int, **kw):
        current = self.controller.query_positions()
        if current is None:
            raise RuntimeError("could not read current position for jog")
        target = list(current)
        target[joint_index] += delta_steps
        return self.runner.start("jog", target_steps=target, **kw)

    def stop(self):
        self.runner.request_stop()

    def zero_hardware(self):
        """'R' to the encoder + 'S0,...' to the controller."""
        if not (self.encoder.is_connected and self.controller.is_connected):
            raise RuntimeError("both encoder and controller must be connected to zero hardware")
        self.encoder.reset_counters()
        self.controller.zero_counters()

    def start_sync_loop(self, interval_s: float = 0.25):
        """Run the encoder <-> controller sync monitor on a background thread
        (the reference's 250 ms sync timer); returns a stop() callable."""
        stop = threading.Event()

        def loop():
            while not stop.is_set():
                try:
                    self.sync.step()
                except Exception:
                    logger.exception("sync step failed; continuing")
                stop.wait(interval_s)

        t = threading.Thread(target=loop, daemon=True)
        t.start()

        def stopper():
            stop.set()
            t.join(timeout=1.0)

        return stopper

    def disconnect(self):
        self.encoder.disconnect()
        self.controller.disconnect()
