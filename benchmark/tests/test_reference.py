"""The plain reference against answers known without it."""

import math

import numpy as np
import pytest

from benchmark.lib import reference as R
from benchmark.lib import scenes as S
from benchmark.lib.arm import Arm

SEG = {"intensity_low": 65.0, "intensity_high": 65535.0, "min_volume_mm3": 50.0, "max_volume_mm3": 1500.0,
       "closing_radius": 2, "max_blobs": 32}


def test_segment_counts_roots_and_body():
    vol = np.full((40, 30, 20), 10.0, np.float32)
    vol[30:33, 20:23, 10:13] = 120.0  # 27 voxels: a blob, root (30, 20, 10)
    vol[5:8, 5:8, 2:5] = 120.0  # a blob with the smaller (z, y, x) root
    vol[14:30, 0:15, 0:20] = 90.0  # the body, touching three borders
    seg = R.segment(vol, np.ones(3, np.float32) * 2.0, np.zeros(3, np.float32), SEG)
    assert seg["num_components"] == 3 and seg["num_blobs"] == 2
    # RAS: x and y negated; the blob at z 2..4 comes first
    assert np.allclose(seg["centroids_ras"], [[-12.0, -12.0, 6.0], [-62.0, -42.0, 22.0]])
    body = np.zeros(vol.shape, bool)
    body[14:30, 0:15, 0:20] = True
    assert np.array_equal(seg["body_mask"], body)  # the closing keeps a box whole at the border


def test_pose_recovers_the_truth():
    arm = Arm()
    scenes, box = S.bench_scenes(arm)
    spacing, origin = S.grid(box, (128, 128, 128), 128)
    scene = scenes[1]
    scan = S.render(scene.markers, (128, 128, 128), spacing, origin, "cpu").numpy()
    ans = R.pose(arm, scan, spacing, origin, SEG, scene)
    assert ans["found"].all() and ans["num_blobs"] == 12
    # 3.6 mm voxels move each centroid by a few tenths of a mm: the base and
    # the Joint6 markers, which the IK fits, land within a mm (the wrist's
    # angles are nearly free at this grid, and Joint4 weighs 0.05)
    p = np.vstack([arm.markers["Baseplate"], [[0, 0, 400.0]]])
    moved = [p @ b[:3, :3].T + b[:3, 3] for b in (ans["base"], scene.base)]
    assert np.linalg.norm(moved[0] - moved[1], axis=1).max() < 1.0
    assert np.linalg.norm(S.markers(arm, ans["angles"], ans["base"]) - scene.markers, axis=1)[9:].max() < 1.0
    assert ans["rmse"] < 0.5
    assert np.array_equal(ans["steps"], np.trunc(ans["angles"] * 3332 / (2 * math.pi)).astype(np.int64))
    low = R.pose(arm, scan, spacing, origin, SEG, scene, R.BF16)
    assert np.degrees(np.abs(low["angles"] - ans["angles"])).max() > 0.1  # the control is another answer


def test_entry_is_the_nearest_lateral_surface_voxel():
    body = np.zeros((41, 41, 41), bool)
    body[10:31, 10:31, 10:31] = True
    spacing, origin = np.ones(3, np.float32), np.zeros(3, np.float32)
    search = R.EntrySearch(body, spacing, origin)
    # target at voxel (15, 20, 20), RAS (-15, -20, 20): the nearest suitable face is x = 10
    p = search.point(np.array([-15.0, -20.0, 20.0]))
    assert np.allclose(p, [-10.0, -20.0, 20.0])
    assert search.point(np.array([500.0, 500.0, 500.0])) is None


def test_path_goes_up_over_and_down():
    start, goal = np.full(6, 0.1), np.full(6, -0.2)
    path = R.path(start, goal)
    assert path.shape == (101, 6)
    assert np.allclose(path[0], start) and np.allclose(path[-1], goal)
    assert math.isclose(path[25][1], R.UP_JOINT2_RAD) and math.isclose(path[50][0], goal[0])


@pytest.mark.parametrize("inside", [True, False])
def test_collider_sees_the_body(inside):
    arm = Arm()
    body = np.full((60, 60, 60), inside)
    collider = R.Collider(arm, body, np.full(3, 10.0, np.float32), np.full(3, -300.0, np.float32))
    assert collider.collides(np.zeros(6), np.eye(4)) == inside
