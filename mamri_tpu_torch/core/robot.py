"""Robot model as tensors + forward kinematics.

Port of `mamri_tpu/core/robot.py`. The arm definition is the port's own
byte-for-byte copy of the JAX package's JSON file
(`mamri_tpu_torch/resources/mamri_arm.json`). FK walks the static parent chain:

    world(link) = world(parent) @ fixed_offset(link) @ articulation(link, angle)

written without in-place writes, so it runs under `torch.func.vmap`/`jacfwd`.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from mamri_tpu_torch.core import transforms
from mamri_tpu_torch.core.transforms import AXIS_CODE_BY_NAME, AXIS_NONE

_RESOURCE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "resources")


def default_config_path() -> str:
    return os.path.join(_RESOURCE_DIR, "mamri_arm.json")


@dataclass(frozen=True)
class LinkSpec:
    """Static metadata for one link (same fields as mamri_tpu's LinkSpec)."""

    name: str
    parent: int  # index into the link list, -1 for the root
    axis_code: int  # transforms.AXIS_*
    joint_index: int  # index into the angle vector, -1 if fixed
    has_markers: bool
    arm_lengths: Tuple[float, float]  # (l1, l2) of the L-shaped marker triplet
    motor_letter: str
    steps_per_rev: int
    visual_mesh: Optional[str]
    collision_mesh: Optional[str]
    color: Tuple[float, float, float]
    offset_mm: Tuple[float, float, float] = (0.0, 0.0, 0.0)


class RobotModel:
    """Tensors (offsets, limits, marker coordinates) + static LinkSpecs."""

    def __init__(self, fixed_offsets, limits_rad, steps_per_rev, marker_local, needle_tip, needle_axis, specs: Tuple[LinkSpec, ...]):
        self.fixed_offsets = fixed_offsets  # (L, 4, 4) f32
        self.limits_rad = limits_rad  # (J, 2) f32
        self.steps_per_rev = steps_per_rev  # (J,) f32
        self.marker_local = marker_local  # (L, 3, 3) f32, zeros where absent
        self.needle_tip = needle_tip  # (3,)
        self.needle_axis = needle_axis  # (3,)
        self.specs = specs

    @property
    def device(self) -> torch.device:
        return self.fixed_offsets.device

    @functools.cached_property
    def fixed_offsets_host(self) -> np.ndarray:
        """(L, 4, 4) float64 host copy of `fixed_offsets`, read once."""
        return self.fixed_offsets.cpu().numpy().astype(np.float64)

    @property
    def num_joints(self) -> int:
        return sum(1 for s in self.specs if s.joint_index >= 0)

    @property
    def link_names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.specs)

    def link_index(self, name: str) -> int:
        try:
            return self.link_names.index(name)
        except ValueError:
            raise KeyError(f"Unknown link {name!r}; robot links are {self.link_names}") from None

    @property
    def articulated_links(self) -> Tuple[int, ...]:
        """Link indices in joint order (Joint1..Joint6)."""
        pairs = [(s.joint_index, i) for i, s in enumerate(self.specs) if s.joint_index >= 0]
        return tuple(i for _, i in sorted(pairs))

    @property
    def articulated_names(self) -> Tuple[str, ...]:
        return tuple(self.specs[i].name for i in self.articulated_links)

    @property
    def motor_letters(self) -> Tuple[str, ...]:
        return tuple(self.specs[i].motor_letter for i in self.articulated_links)

    def spec(self, name: str) -> LinkSpec:
        return self.specs[self.link_index(name)]


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"robot model on {device}: torch.cuda.is_available() is False (pass device='cpu' for the CPU)"
        )
    return device


def load_robot_model(config_path: Optional[str] = None, device="cuda") -> RobotModel:
    """Load the arm definition from mamri_tpu's JSON schema onto `device`
    (the card unless the caller asks for the CPU; raises without one)."""
    device = _resolve_device(device)
    path = config_path or default_config_path()
    with open(path, "r") as f:
        cfg = json.load(f)
    try:
        return _build_robot_model(cfg, device)
    except (KeyError, TypeError, IndexError) as e:
        raise ValueError(f"{path}: malformed robot definition ({type(e).__name__}: {e})") from e


def _build_robot_model(cfg: Dict[str, Any], device) -> RobotModel:
    links: List[Dict[str, Any]] = cfg["links"]
    name_to_idx = {l["link"]: i for i, l in enumerate(links)}
    specs: List[LinkSpec] = []
    offsets = np.tile(np.eye(4, dtype=np.float32), (len(links), 1, 1))
    marker_local = np.zeros((len(links), 3, 3), dtype=np.float32)
    limits: List[Tuple[float, float]] = []
    steps_per_rev: List[float] = []
    needle_tip = np.zeros(3, dtype=np.float32)
    needle_axis = np.array([1.0, 0.0, 0.0], dtype=np.float32)

    joint_counter = 0
    for i, l in enumerate(links):
        axis_name = l.get("axis")
        rotational = axis_name in ("IS", "PA", "LR")
        axis_code = AXIS_CODE_BY_NAME.get(axis_name, AXIS_NONE) if rotational else AXIS_NONE
        joint_index = joint_counter if rotational else -1
        if rotational:
            lo, hi = l.get("limits_deg", [-180.0, 180.0])
            limits.append((math.radians(lo), math.radians(hi)))
            steps_per_rev.append(float(l.get("steps_per_rev", 0)))
            joint_counter += 1
        if l.get("offset_mm") is not None:
            offsets[i, :3, 3] = np.asarray(l["offset_mm"], dtype=np.float32)
        pts = l.get("marker_points_mm")
        if pts is not None:
            marker_local[i] = np.asarray(pts, dtype=np.float32)
        if l.get("needle_tip_mm") is not None:
            needle_tip = np.asarray(l["needle_tip_mm"], dtype=np.float32)
        if l.get("needle_axis") is not None:
            needle_axis = np.asarray(l["needle_axis"], dtype=np.float32)
        arms = l.get("marker_arms_mm", [0.0, 0.0])
        specs.append(
            LinkSpec(
                name=l["link"],
                parent=name_to_idx[l["parent"]] if l.get("parent") else -1,
                axis_code=axis_code,
                joint_index=joint_index,
                has_markers=pts is not None,
                arm_lengths=(float(arms[0]), float(arms[1])),
                motor_letter=l.get("motor_letter", ""),
                steps_per_rev=int(l.get("steps_per_rev", 0)),
                visual_mesh=l.get("visual_mesh"),
                collision_mesh=l.get("collision_mesh"),
                color=tuple(l.get("display_color", [0.7, 0.7, 0.7])),
                offset_mm=tuple(l.get("offset_mm") or (0.0, 0.0, 0.0)),
            )
        )
    return robot_model_from_numpy(
        offsets, np.asarray(limits), np.asarray(steps_per_rev), marker_local,
        needle_tip, needle_axis, specs, device=device,
    )


def robot_model_from_numpy(
    fixed_offsets, limits_rad, steps_per_rev, marker_local, needle_tip, needle_axis, specs, device="cuda"
) -> RobotModel:
    """Build a RobotModel from numpy arrays and LinkSpec-like objects.

    This is how parameters cross over from another implementation of the
    same model (e.g. the JAX package's RobotModel, via `np.asarray` of its
    arrays and its LinkSpecs), so two packages can be held to one model.
    The tensors land on `device`: the card unless the caller asks for the
    CPU, and an error where there is no card."""
    device = _resolve_device(device)
    fields = [f.name for f in dataclasses.fields(LinkSpec)]
    port_specs = tuple(LinkSpec(**{k: getattr(s, k) for k in fields}) for s in specs)

    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float32), device=device)

    return RobotModel(
        fixed_offsets=t(fixed_offsets),
        limits_rad=t(limits_rad),
        steps_per_rev=t(steps_per_rev),
        marker_local=t(marker_local),
        needle_tip=t(needle_tip),
        needle_axis=t(needle_axis),
        specs=port_specs,
    )


def fk_all_links(model: RobotModel, angles, base_tf=None):
    """(L, 4, 4) world transforms of every link for (J,) angles in radians;
    world = parent_world @ fixed_offset @ articulation."""
    if angles.shape != (model.num_joints,):
        raise ValueError(f"angles must have shape ({model.num_joints},), got {tuple(angles.shape)}")
    if base_tf is None:
        base_tf = torch.eye(4, dtype=angles.dtype, device=angles.device)
    world: List[torch.Tensor] = []
    for i, spec in enumerate(model.specs):
        parent_tf = base_tf if spec.parent < 0 else world[spec.parent]
        if spec.joint_index >= 0:
            art = transforms.articulation_matrix(spec.axis_code, angles[spec.joint_index])
            local = model.fixed_offsets[i] @ art
        else:
            local = model.fixed_offsets[i]
        world.append(parent_tf @ local)
    return torch.stack(world, dim=0)


def fk_all_links_host(model: RobotModel, angles, base_tf=None) -> np.ndarray:
    """Host-numpy float64 twin of `fk_all_links`, for per-tick and per-frame
    paths that must not wait on a device (port of the reference's
    `fk_all_links_host`); the articulations are those of
    `transforms.articulation_matrix`."""
    angles = np.asarray(angles, dtype=np.float64).reshape(-1)
    if angles.shape[0] != model.num_joints:
        raise ValueError(f"angles must have shape ({model.num_joints},), got {angles.shape}")
    base = np.eye(4) if base_tf is None else np.asarray(base_tf, dtype=np.float64)
    offsets = model.fixed_offsets_host
    world: List[np.ndarray] = []
    for i, spec in enumerate(model.specs):
        parent = base if spec.parent < 0 else world[spec.parent]
        local = offsets[i]
        if spec.joint_index >= 0:
            t = angles[spec.joint_index]
            c, s = np.cos(t), np.sin(t)
            art = np.eye(4)
            if spec.axis_code == transforms.AXIS_IS:  # RotZ(+t)
                art[:2, :2] = [[c, -s], [s, c]]
            elif spec.axis_code == transforms.AXIS_PA:  # RotY(-t)
                art[0, 0] = art[2, 2] = c
                art[0, 2] = -s
                art[2, 0] = s
            elif spec.axis_code == transforms.AXIS_LR:  # RotX(+t)
                art[1:3, 1:3] = [[c, -s], [s, c]]
            local = local @ art
        world.append(parent @ local)
    return np.stack(world, axis=0)


def fk_link(model: RobotModel, angles, link_name: str, base_tf=None):
    """World transform of one named link."""
    return fk_all_links(model, angles, base_tf)[model.link_index(link_name)]


def marker_world_positions(model: RobotModel, angles, link_name: str, base_tf=None, local_override=None):
    """World positions of a marker-bearing link's 3 local markers under FK."""
    tf = fk_link(model, angles, link_name, base_tf)
    local = local_override if local_override is not None else model.marker_local[model.link_index(link_name)]
    return transforms.apply(tf, local)
