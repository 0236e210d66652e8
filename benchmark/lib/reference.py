"""The plain reference: what the program should answer for the benchmark's
scans and targets, worked out again from the inputs alone.

It imports nothing of the program (nor jax): SciPy's morphology and
labelling, NumPy and plain torch on the CPU, over the benchmark's own arm
file (`benchmark.lib.arm`). Every function takes a `dtype`: float64 is the
reference; bfloat16 is the control, the same arithmetic one precision below
the float32 that the configurations state (the linear solves and the SVD,
which torch has no bfloat16 kernel for, take bfloat16 inputs and round their
result back to it).

- `segment`: threshold [low, high], closing by a Euclidean ball (border
  voxels see background outside the grid), 6-connected components; each
  component's root is its least (z, y, x) raster index; components whose
  volume lies in the fiducial band are the blobs (root order, at most
  `max_blobs`), the largest other component is the body.
- `match`: each of the 12 true marker points takes the nearest blob
  centroid, each blob once (every scene has all 12 fiducials).
- `kabsch`: the baseplate's three points with their y levelled to their
  mean, fitted to the arm file's baseplate markers.
- `solve_ik`: bounded Levenberg-Marquardt from the true angles over the
  residual of the 9 Joint6 markers and the 9 Joint4 markers weighted 0.05.
- `EntrySearch`, `goal_errors`, `solve_goal`, `path`, `Collider`: the skin
  entry point, the needle goal's tip and direction, the up-over-down path
  and its collision flags against the body, as the planner defines them.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import scipy.ndimage as ndi
import torch
from torch.func import jacfwd

from benchmark.lib.arm import MARKER_LINKS, Arm, apply, fk

F64, BF16 = torch.float64, torch.bfloat16
JOINT4_WEIGHT = 0.05
ORIENTATION_WEIGHT = 50.0
UP_JOINT2_RAD = math.radians(-15.0)
SEARCH_RADIUS_MM = 80.0
SCORE_THRESHOLD = -0.5
PARTS = ("Joint1", "Joint2", "Joint3", "Joint4", "Joint5", "Joint6")
PART_RADIUS_MM = 22.0
MIN_PART_LENGTH_MM = 26.0
PART_POINTS = 2048


def _ball(radius: int) -> np.ndarray:
    r = range(-radius, radius + 1)
    return np.array([[[dx * dx + dy * dy + dz * dz <= radius * radius for dz in r] for dy in r] for dx in r])


def _round(x, dtype):
    """`x` (array or tensor) as a torch tensor of `dtype`."""
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x).to(dtype)


def segment(data, spacing, origin, seg: dict, dtype=F64) -> dict:
    """{"centroids_ras" (n, 3) f64, "num_blobs", "num_components",
    "body_mask" (nx, ny, nz) bool} of one scan."""
    vals = _round(data, torch.float32 if dtype == F64 else dtype)
    mask = ((vals >= seg["intensity_low"]) & (vals <= seg["intensity_high"])).numpy()
    r = int(seg["closing_radius"])
    if r > 0:
        ball, pad = _ball(r), 2 * r
        grown = ndi.binary_dilation(np.pad(mask, pad), ball)
        mask = ndi.binary_erosion(grown, ball, border_value=1)[pad:-pad, pad:-pad, pad:-pad]
    labels, n = ndi.label(mask)  # 6-connectivity
    nx, ny, nz = mask.shape
    flat = np.flatnonzero(labels)
    lab = labels.reshape(-1)[flat]
    i, j, k = flat // (ny * nz), (flat // nz) % ny, flat % nz
    index = np.arange(1, n + 1)
    roots = ndi.minimum(i + nx * (j + ny * k), labels=lab, index=index).astype(np.int64)
    counts = np.bincount(lab, minlength=n + 1)[1:].astype(np.float64)
    # the index sums in the reference's precision; a bfloat16 sum accumulates
    # in float32 and is rounded once, as torch's bfloat16 reductions do
    acc = F64 if dtype == F64 else torch.float32
    coords = torch.as_tensor(np.stack([i, j, k], 1)).to(dtype).to(acc)
    sums = torch.zeros((n + 1, 3), dtype=acc).index_add_(0, torch.as_tensor(lab), coords).to(dtype)
    voxvol = float(np.prod(np.asarray(spacing, np.float32)))
    vols = counts * voxvol
    in_band = (vols >= seg["min_volume_mm3"]) & (vols <= seg["max_volume_mm3"])
    band = np.nonzero(in_band)[0]
    band = band[np.argsort(roots[band], kind="stable")][: int(seg["max_blobs"])]
    cnt = torch.as_tensor(counts[band]).to(dtype)[:, None]
    idx = sums[1:][torch.as_tensor(band, dtype=torch.long)] / cnt
    lps = _round(origin, dtype) + _round(spacing, dtype) * idx
    ras = torch.stack([-lps[:, 0], -lps[:, 1], lps[:, 2]], 1).to(F64).numpy()
    other = np.nonzero(~in_band)[0]
    body = np.zeros(mask.shape, dtype=bool)
    if other.size:
        order = other[np.argsort(roots[other], kind="stable")]
        body = labels == index[order[np.argmax(counts[order])]]
    return {"centroids_ras": ras, "num_blobs": int(len(band)), "num_components": int(n), "body_mask": body}


def match(centroids: np.ndarray, truth: np.ndarray):
    """((4, 3, 3) points, (4,) found): the blob nearest each true marker."""
    pts = np.zeros((len(MARKER_LINKS), 3, 3))
    found = np.zeros(len(MARKER_LINKS), dtype=bool)
    if len(centroids) == 0:
        return pts, found
    d = np.linalg.norm(truth[:, None, :] - centroids[None, :, :], axis=-1)
    near = d.argmin(1)
    ok = np.bincount(near, minlength=len(centroids))[near] == 1
    for li in range(len(MARKER_LINKS)):
        sl = slice(3 * li, 3 * li + 3)
        pts[li] = centroids[near[sl]]
        found[li] = bool(ok[sl].all())
    return pts, found


def kabsch(source, target, dtype=F64) -> np.ndarray:
    """(4, 4) f64 rigid T with T @ source ~ target (equal weights)."""
    s, t = _round(source, dtype), _round(target, dtype)
    sm, tm = s.mean(0), t.mean(0)
    h = ((s - sm).T @ (t - tm)).to(F64 if dtype == F64 else torch.float32)
    u, _, vt = torch.linalg.svd(h)
    d = torch.sign(torch.linalg.det(vt.T @ u.T))
    diag = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    rot = (vt.T @ diag @ u.T).to(dtype)
    trans = tm - rot @ sm
    out = np.eye(4)
    out[:3, :3], out[:3, 3] = rot.to(F64).numpy(), trans.to(F64).numpy()
    return out


def baseplate(arm: Arm, pts: np.ndarray, dtype=F64) -> np.ndarray:
    """The base transform from the baseplate's 3 points, y levelled."""
    flat = np.array(pts, dtype=np.float64)
    flat[:, 1] = flat[:, 1].mean()
    return kabsch(arm.markers["Baseplate"], flat, dtype)


def lm(residual, x0, lower, upper, iters: int, dtype=F64):
    """Bounded Levenberg-Marquardt from `x0`: minimise 0.5 |residual(x)|^2."""
    x = torch.clamp(_round(x0, dtype), _round(lower, dtype), _round(upper, dtype))
    lo, hi = _round(lower, dtype), _round(upper, dtype)
    solve_t = F64 if dtype == F64 else torch.float32
    jac = jacfwd(residual)
    r = residual(x)
    cost = 0.5 * (r * r).sum()
    mu = 1e-3
    for _ in range(iters):
        j = jac(x).to(solve_t)
        rr = r.to(solve_t)
        h = j.T @ j
        g = j.T @ rr
        step = torch.linalg.solve(h + mu * torch.diag(torch.clamp(torch.diagonal(h), min=1e-10))
                                  + 1e-10 * torch.eye(h.shape[0], dtype=solve_t), -g)
        x_new = torch.clamp(x + step.to(dtype), lo, hi)
        r_new = residual(x_new)
        c_new = 0.5 * (r_new * r_new).sum()
        if bool(c_new < cost):
            x, r, cost, mu = x_new, r_new, c_new, max(mu * 0.35, 1e-12)
        else:
            mu = min(mu * 4.0, 1e12)
    return x


def pose_residual(arm: Arm, base, j6, j4, w4, dtype):
    b = _round(base, dtype)
    t6, t4 = _round(j6, dtype), _round(j4, dtype)
    m6, m4 = _round(arm.markers["Joint6"], dtype), _round(arm.markers["Joint4"], dtype)
    i6, i4 = arm.index("Joint6"), arm.index("Joint4")

    def residual(a):
        world = fk(arm, a, b)
        e6 = (apply(world[i6], m6) - t6).reshape(-1)
        e4 = (w4 * (apply(world[i4], m4) - t4)).reshape(-1)
        return torch.cat([e6, e4])

    return residual


def solve_ik(arm: Arm, base, pts, found, start, iters: int = 100, dtype=F64):
    """(angles (6,) f64, rmse mm over the 9 Joint6 errors)."""
    w4 = JOINT4_WEIGHT if found[2] else 0.0
    res = pose_residual(arm, base, pts[3], pts[2], w4, dtype)
    a = lm(res, start, arm.limits[:, 0], arm.limits[:, 1], iters, dtype)
    e6 = pose_residual(arm, base, pts[3], pts[2], 0.0, F64)(a.to(F64))[:9]
    return a.to(F64).numpy(), float(torch.sqrt((e6 * e6).mean()))


def steps_of(arm: Arm, angles) -> np.ndarray:
    return np.trunc(np.asarray(angles, np.float64) * arm.steps_per_rev / (2 * math.pi)).astype(np.int64)


def pose(arm: Arm, data, spacing, origin, seg: dict, scene, dtype=F64) -> dict:
    """The whole scan -> pose answer for one scan of a known scene."""
    s = segment(data, spacing, origin, seg, dtype)
    pts, found = match(s["centroids_ras"], scene.markers)
    out = dict(s, found=found, points=pts)
    if not found.all():
        return dict(out, base=None, angles=None, steps=None, rmse=None)
    base = baseplate(arm, pts[0], dtype)
    angles, rmse = solve_ik(arm, base, pts, found, scene.angles, dtype=dtype)
    return dict(out, base=base, angles=angles, steps=steps_of(arm, angles), rmse=rmse)


# ---------------------------------------------------------------- planning
def _roll(x, shift, axis):
    return torch.roll(x, shift, dims=axis)


class EntrySearch:
    """The skin entry nearest a target: surface voxels (body and not its
    6-eroded self) whose outward normal (the gradient of the twice
    box-smoothed occupancy, rolls wrapping at the border) is lateral enough
    (|n_x| - 2 |n_y| > -0.5), within 80 mm; the nearest, the first in
    C order among equals."""

    def __init__(self, body_mask, spacing, origin, dtype=F64):
        m = torch.as_tensor(body_mask)
        sp, org = _round(spacing, dtype), _round(origin, dtype)
        x = m.to(dtype)
        for _ in range(2):
            acc = x
            for ax in range(3):
                acc = acc + _roll(x, 1, ax) + _roll(x, -1, ax)
            x = acc / 7.0
        g = [(_roll(x, -1, ax) - _roll(x, 1, ax)) / (2.0 * sp[ax]) for ax in range(3)]
        norm = torch.clamp(torch.sqrt(g[0] ** 2 + g[1] ** 2 + g[2] ** 2), min=1e-9)
        nx_, ny_ = g[0] / norm, g[1] / norm
        eroded = m.clone()
        for ax in range(3):
            for sh in (1, -1):
                eroded &= _roll(m, sh, ax)
        cand = m & ~eroded & ((nx_.abs() - 2.0 * ny_.abs()) > SCORE_THRESHOLD)
        self.flat = torch.nonzero(cand.reshape(-1)).reshape(-1)
        shape = m.shape
        i = self.flat // (shape[1] * shape[2])
        j = (self.flat // shape[2]) % shape[1]
        k = self.flat % shape[2]
        self.points = torch.stack([-(org[0] + sp[0] * i.to(dtype)), -(org[1] + sp[1] * j.to(dtype)),
                                   org[2] + sp[2] * k.to(dtype)], 1)
        self.dtype = dtype

    def point(self, target) -> Optional[np.ndarray]:
        d = torch.linalg.norm(self.points - _round(target, self.dtype), dim=1)
        d = torch.where(d <= SEARCH_RADIUS_MM, d, torch.full_like(d, float("inf")))
        if d.numel() == 0 or not torch.isfinite(d.min()):
            return None
        return self.points[int(torch.argmin(d))].to(F64).numpy()


def needle_goal(target, entry, safety_mm: float):
    """(unit direction entry -> target, needle tip standoff) in f64."""
    t, e = np.asarray(target, np.float64), np.asarray(entry, np.float64)
    x = (t - e) / max(np.linalg.norm(t - e), 1e-9)
    return x, e - safety_mm * x


def needle_frame(arm: Arm, angles, base, dtype=F64):
    """(tip (3,), direction (3,)) of the needle link: its origin and -x."""
    world = fk(arm, _round(angles, dtype), _round(base, dtype))[arm.index("Needle")]
    return world[:3, 3], -world[:3, 0]


def goal_errors(arm: Arm, angles, base, target, entry, safety_mm: float):
    """(tip distance to the standoff mm, angle to the entry -> target
    direction deg) of a goal pose."""
    x, tip = needle_goal(target, entry, safety_mm)
    p, d = needle_frame(arm, angles, base)
    p, d = p.numpy(), d.numpy()
    cos = float(np.clip(np.dot(d, x) / max(np.linalg.norm(d), 1e-12), -1.0, 1.0))
    return float(np.linalg.norm(p - tip)), math.degrees(math.acos(cos))


def solve_goal(arm: Arm, base, target, entry, safety_mm: float, guesses, iters: int = 100, dtype=F64):
    """The goal pose of least tip error among LM solves from `guesses`, over
    the planner's residual (tip, and 50 x the direction)."""
    x, tip = needle_goal(target, entry, safety_mm)
    b, xt, tt = _round(base, dtype), _round(x, dtype), _round(tip, dtype)
    ni = arm.index("Needle")

    def residual(a):
        world = fk(arm, a, b)[ni]
        return torch.cat([world[:3, 3] - tt, ORIENTATION_WEIGHT * (xt + world[:3, 0])])

    best, best_err = None, float("inf")
    for g in guesses:
        a = lm(residual, g, arm.limits[:, 0], arm.limits[:, 1], iters, dtype)
        err = float(torch.linalg.norm(residual(a)[:3].to(F64)))
        if err < best_err:
            best, best_err = a.to(F64).numpy(), err
    return best


def path(start, goal, total_steps: int = 100, dtype=F64) -> np.ndarray:
    """(total_steps + 1, J): up (Joint2 to -15 deg), over (Joint1 to the
    goal's), down (to the goal), split 25/25/50 at t = j / steps, then the
    goal itself."""
    s, g = _round(start, dtype), _round(goal, dtype)
    up = s.clone()
    up[1] = UP_JOINT2_RAD
    over = up.clone()
    over[0] = g[0]
    keys = [s, up, over, g]
    rows = []
    for i, steps in enumerate((total_steps // 4, total_steps // 4, total_steps // 2)):
        t = (torch.arange(steps, dtype=dtype) / steps)[:, None]
        rows.append(keys[i][None] + t * (keys[i + 1] - keys[i])[None])
    rows.append(g[None])
    return torch.cat(rows).to(F64).numpy()


def capsule_points(length: float, radius: float, n: int, seed: int) -> np.ndarray:
    """Surface points of a capsule along local +Z from 0 to `length`: 70 %
    on the side, the rest on the two caps, from numpy's generator `seed`."""
    rng = np.random.default_rng(seed)
    n_side = int(n * 0.7)
    n_caps = n - n_side
    theta = rng.uniform(0, 2 * np.pi, n_side)
    z = rng.uniform(0.0, length, n_side)
    side = np.stack([radius * np.cos(theta), radius * np.sin(theta), z], axis=1)
    phi = rng.uniform(0, 2 * np.pi, n_caps)
    cost = rng.uniform(-1, 1, n_caps)
    sint = np.sqrt(1 - cost ** 2)
    caps = np.stack([radius * sint * np.cos(phi), radius * sint * np.sin(phi), radius * cost], axis=1)
    caps[cost >= 0, 2] += length
    return np.concatenate([side, caps]).astype(np.float32)


class Collider:
    """Does any surface point of Joint1..Joint6 (capsules, 2048 points a
    part) sample above 0.5 in the body occupancy, dilated by two
    26-neighbour shells that do not wrap, trilinearly, out of the grid 0."""

    def __init__(self, arm: Arm, body_mask, spacing, origin, dtype=F64):
        occ = torch.as_tensor(body_mask).clone()
        for _ in range(2):
            grown = occ
            for ax in range(3):
                n = grown.shape[ax]
                idx = torch.arange(n).view([n if a == ax else 1 for a in range(3)])
                grown = grown | (_roll(grown, 1, ax) & (idx >= 1)) | (_roll(grown, -1, ax) & (idx < n - 1))
            occ = grown
        self.occ = occ.to(dtype)
        self.sp, self.org, self.dtype, self.arm = _round(spacing, dtype), _round(origin, dtype), dtype, arm
        self.links = [arm.index(p) for p in PARTS]
        self.parts = [_round(capsule_points(max(arm.child_offset_length(li), MIN_PART_LENGTH_MM),
                                            PART_RADIUS_MM, PART_POINTS, li), dtype) for li in self.links]

    def collides(self, angles, base) -> bool:
        world = fk(self.arm, _round(angles, self.dtype), _round(base, self.dtype))
        pts = torch.cat([apply(world[li], p) for li, p in zip(self.links, self.parts)])
        lps = torch.stack([-pts[:, 0], -pts[:, 1], pts[:, 2]], 1)
        idx = (lps - self.org) / self.sp
        shape = torch.tensor(self.occ.shape, dtype=self.dtype)
        hi = shape - 1
        inb = ((idx >= 0) & (idx <= hi)).all(1)
        idx = torch.minimum(hi, torch.maximum(torch.zeros_like(hi), idx))
        i0 = torch.floor(idx).long()
        i1 = torch.minimum(i0 + 1, (shape - 1).long())
        f = idx - i0.to(self.dtype)
        val = torch.zeros(idx.shape[0], dtype=self.dtype)
        for cx in (0, 1):
            for cy in (0, 1):
                for cz in (0, 1):
                    w = ((f[:, 0] if cx else 1 - f[:, 0]) * (f[:, 1] if cy else 1 - f[:, 1])
                         * (f[:, 2] if cz else 1 - f[:, 2]))
                    ii = [(i1 if c else i0)[:, a] for a, c in enumerate((cx, cy, cz))]
                    val = val + w * self.occ[ii[0], ii[1], ii[2]]
        return bool(((val * inb) > 0.5).any())

