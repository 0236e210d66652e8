"""The generator: the same seed gives the same inputs, and the scans put
every fiducial where the benchmark's forward kinematics says it is."""

import math

import numpy as np
import torch

from benchmark.lib import reference as R
from benchmark.lib import scenes as S
from benchmark.lib.arm import Arm, fk


def test_zero_pose_link_heights():
    world = fk(Arm(), torch.zeros(6, dtype=torch.float64), torch.eye(4, dtype=torch.float64))
    assert [float(t[2, 3]) for t in world] == [0, 20, 50, 200, 200, 355, 368, 439]


def test_bench_scenes_are_bench_pys():
    arm = Arm()
    poses = S.bench_poses(arm)
    assert len(poses) == 4 and np.allclose(poses[0][0], S.CANONICAL_ANGLES, atol=1e-7)
    again = S.bench_poses(arm)
    assert all(np.array_equal(a, b) and y == z for (a, y), (b, z) in zip(poses, again))
    assert all(abs(a[4]) >= 0.3 - 1e-6 for a, _ in poses)


def test_seeded_inputs_repeat_and_differ():
    arm = Arm()
    a0, base = np.asarray(S.CANONICAL_ANGLES), S.bed_base(S.CANONICAL_YAW)

    def drift(seed):
        return [s.angles for s in S.drift_poses(arm, a0, base, 16, 0.5, 3.0, np.random.default_rng([1, seed]))]

    big = 2 ** 31 + 12345
    assert all(np.array_equal(x, y) for x, y in zip(drift(big), drift(big)))
    assert not all(np.array_equal(x, y) for x, y in zip(drift(big), drift(big + 1)))
    steps = np.abs(np.diff(np.stack(drift(big)), axis=0))
    assert steps.max() <= math.radians(0.5) + 1e-12
    assert np.abs(np.stack(drift(big)) - a0).max() <= math.radians(3.0) + 1e-12
    t = S.targets_near(S.BODY_CENTER_RAS, 10.0, 200, np.random.default_rng([1, big]))
    assert np.array_equal(t, S.targets_near(S.BODY_CENTER_RAS, 10.0, 200, np.random.default_rng([1, big])))
    assert np.linalg.norm(t - np.asarray(S.BODY_CENTER_RAS), axis=1).max() <= 10.0 + 1e-4
    order = S.seeded_order(np.random.default_rng(big), 4, 12)
    assert all(sorted(order[i:i + 4]) == [0, 1, 2, 3] for i in (0, 4, 8))
    assert S.forth_and_back(4) == [0, 1, 2, 3, 2, 1]


def test_fiducials_render_at_the_kinematics_markers():
    arm = Arm()
    scenes, box = S.bench_scenes(arm)
    spacing, origin = S.grid(box, (128, 128, 128), 128)
    for scene in scenes[:2]:
        scan = S.render(scene.markers, (128, 128, 128), spacing, origin, "cpu").numpy()
        assert set(np.unique(scan)) == {S.FIDUCIAL, S.BODY, S.BACKGROUND}
        seg = R.segment(scan, spacing, origin, {"intensity_low": 65.0, "intensity_high": 65535.0,
                                                "min_volume_mm3": 50.0, "max_volume_mm3": 1500.0,
                                                "closing_radius": 2, "max_blobs": 32})
        assert seg["num_blobs"] == 12
        d = np.linalg.norm(seg["centroids_ras"][:, None] - scene.markers[None], axis=-1).min(0)
        assert d.max() < 0.5 * float(spacing.max())  # a sphere's voxel centroid lies within half a voxel
