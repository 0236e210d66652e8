"""The MAMRI arm as the benchmark knows it: a frozen byte copy of the arm
file (`benchmark/resources/mamri_arm.json`) and a plain forward kinematics
over it in torch, at any dtype and on any device.

World(link) = World(parent) @ Translate(offset) @ Articulation(axis, angle),
with IS -> RotZ(+t), PA -> RotY(-t), LR -> RotX(+t), as the arm file's
schema defines them. Nothing here reads the program: scenes are made from it
and the reference judges the program with it.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

ARM_FILE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "resources", "mamri_arm.json")
MARKER_LINKS = ("Baseplate", "Joint2", "Joint4", "Joint6")
ROTATIONAL = ("IS", "PA", "LR")


class Arm:
    """Links, joints, limits, motor steps and marker coordinates of the arm."""

    def __init__(self, path: str = ARM_FILE):
        with open(path) as f:
            links = json.load(f)["links"]
        self.names = [l["link"] for l in links]
        self.parent = [self.names.index(l["parent"]) if l.get("parent") else -1 for l in links]
        self.offset = np.array([l.get("offset_mm") or (0.0, 0.0, 0.0) for l in links], dtype=np.float64)
        self.offset_tf = np.tile(np.eye(4), (len(links), 1, 1))
        self.offset_tf[:, :3, 3] = self.offset
        self.axis = [l.get("axis") if l.get("axis") in ROTATIONAL else None for l in links]
        self.joint = []
        limits, spr = [], []
        for l, axis in zip(links, self.axis):
            if axis is None:
                self.joint.append(-1)
                continue
            self.joint.append(len(limits))
            lo, hi = l.get("limits_deg", (-180.0, 180.0))
            limits.append((math.radians(lo), math.radians(hi)))
            spr.append(float(l.get("steps_per_rev", 0)))
        self.limits = np.array(limits, dtype=np.float64)  # (J, 2) rad
        self.steps_per_rev = np.array(spr, dtype=np.float64)
        self.markers = {l["link"]: np.array(l["marker_points_mm"], dtype=np.float64)
                        for l in links if l.get("marker_points_mm") is not None}
        self.num_joints = len(limits)

    def index(self, name: str) -> int:
        return self.names.index(name)

    def child_offset_length(self, link: int) -> float:
        """Length of the offset to the first child of `link` (0 without one)."""
        for i, p in enumerate(self.parent):
            if p == link:
                return float(np.linalg.norm(self.offset[i]))
        return 0.0


def _articulation(axis: str, t):
    c, s = torch.cos(t), torch.sin(t)
    o, z = torch.ones_like(t), torch.zeros_like(t)
    if axis == "IS":
        rows = [[c, -s, z, z], [s, c, z, z], [z, z, o, z]]
    elif axis == "PA":  # RotY(-t)
        rows = [[c, z, -s, z], [z, o, z, z], [s, z, c, z]]
    else:  # LR
        rows = [[o, z, z, z], [z, c, -s, z], [z, s, c, z]]
    rows.append([z, z, z, o])
    return torch.stack([torch.stack(r) for r in rows])


def fk(arm: Arm, angles, base):
    """[(4, 4) world transform of each link] for (J,) `angles` and a (4, 4)
    `base`, in their dtype and on their device."""
    dtype, dev = angles.dtype, angles.device
    world = []
    for i in range(len(arm.names)):
        tf = base if arm.parent[i] < 0 else world[arm.parent[i]]
        local = torch.as_tensor(arm.offset_tf[i], dtype=dtype, device=dev)
        if arm.joint[i] >= 0:
            local = local @ _articulation(arm.axis[i], angles[arm.joint[i]])
        world.append(tf @ local)
    return world


def apply(tf, pts):
    """(N, 3) points through a (4, 4) transform."""
    return pts @ tf[:3, :3].T + tf[:3, 3]


def marker_points(arm: Arm, angles, base, links=MARKER_LINKS):
    """(3 * len(links), 3) world marker positions, link after link."""
    world = fk(arm, angles, base)
    dtype, dev = angles.dtype, angles.device
    return torch.cat([apply(world[arm.index(ln)], torch.as_tensor(arm.markers[ln], dtype=dtype, device=dev))
                      for ln in links])


def rot_x(t):
    c, s = math.cos(t), math.sin(t)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], dtype=np.float64)


def rot_z(t):
    c, s = math.cos(t), math.sin(t)
    return np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], dtype=np.float64)


def translate(v):
    m = np.eye(4)
    m[:3, 3] = v
    return m


def bed_base(yaw: float) -> np.ndarray:
    """(4, 4) the arm's baseplate upright on the bed (local +Z along world
    +Y) at (-60, -120, 0) mm, turned by `yaw` rad (bench.py's mount)."""
    return translate((-60.0, -120.0, 0.0)) @ rot_x(-math.pi / 2) @ rot_z(yaw)

