"""The port's parity harness against mamri_tpu's, and the port's own copies
of what it used to take from the JAX package.

`run_parity_checks(24)` runs in both packages on the CPU (JAX in interpret
mode, the port through its twins); the reports must have the same keys and
checks, and every check must hold in the port (exact, as in JAX's report).
"""

import dataclasses
import filecmp
import os

import numpy as np

from mamri_tpu.api import types as jtypes
from mamri_tpu.perception import parity as jparity
from mamri_tpu_torch.api import types as ttypes
from mamri_tpu_torch.core import robot as trobot
from mamri_tpu_torch.perception import parity as tparity
from test_torch_engine import _one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _shape_of(report):
    """The report's key tree, with each leaf's type (bool checks vs numbers)."""
    return {k: _shape_of(v) if isinstance(v, dict) else type(v).__name__ for k, v in report.items()}


def test_parity_harness_matches_jax_report():
    want = jparity.run_parity_checks(24)
    got = tparity.run_parity_checks(24, device="cpu")
    assert _shape_of(got) == _shape_of(want)
    assert got["num_checks"] == want["num_checks"] == 34
    assert got["all_exact"] and want["all_exact"]
    assert got["segment_volume_anisotropic"]["shape"] == want["segment_volume_anisotropic"]["shape"]


def test_parity_scene_is_the_reference_scene():
    for size in (24, (56, 24, 48)):
        np.testing.assert_array_equal(tparity._scene(size), jparity._scene(size))


def test_pose_estimate_matches_jax_type():
    jf = [(f.name, f.default, f.default_factory) for f in dataclasses.fields(jtypes.PoseEstimate)]
    tf = [(f.name, f.default, f.default_factory) for f in dataclasses.fields(ttypes.PoseEstimate)]
    assert tf == jf
    assert ttypes.PoseEstimate(success=True) == ttypes.PoseEstimate(True)


def test_robot_definition_is_a_byte_copy():
    ours = trobot.default_config_path()
    assert ours == os.path.join(REPO, "mamri_tpu_torch", "resources", "mamri_arm.json")
    assert filecmp.cmp(ours, os.path.join(REPO, "mamri_tpu", "resources", "mamri_arm.json"), shallow=False)
