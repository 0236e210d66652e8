"""The Kabsch fit's plain twin, its CPU path and its kernel wrapper
(`registration/kabsch.py`), without a card.

The twin (`kabsch_rigid_transform_plain`: the fit in tensor ops with the
Jacobi eigenvector) is held to the CPU path (LAPACK's eigh) as matrices, so
q and -q agree. The CPU path launches nothing. The wrapper's checks,
broadcasting and counters run against a stand-in library that computes the
twin from the pointers it is given (`_FakeLibrary`); the kernel itself is
held to the twin on a card in tests/test_torch_cuda.py. The reference's
parity tests stay in tests/test_torch_registration.py and
tests/test_torch_mesh.py."""

import ctypes
import types

import numpy as np
import pytest
import torch

from kabsch_cases import KABSCH_CASES, WELL_POSED, assert_same_fit, kabsch_case
from mamri_tpu_torch import _build
from mamri_tpu_torch.registration import kabsch
from mamri_tpu_torch.utils.trace import Tracer
from test_torch_engine import _one_torch_thread  # noqa: F401 (autouse)

# the twin against LAPACK: the largest gaps over 200 seeds of every case are
# 7e-6 (rotation entries) and 2.9e-4 mm (translations up to 300 mm)
EIGH_ROT_ATOL, EIGH_MM_ATOL = 2e-5, 1e-3


def _array(ptr, count):
    return np.ctypeslib.as_array((ctypes.c_float * count).from_address(ptr))


class _FakeLibrary:
    """`mamri_kabsch` computed by the twin from the (problems, n, 3) inputs
    behind the pointers, as the kernel's C entry takes them."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def mamri_kabsch(self, src, tgt, problems, n, out, stream):
        self.calls.append((problems, n))
        if self.err:
            return self.err
        shape = (problems, n, 3)
        s = torch.from_numpy(_array(src, problems * n * 3).reshape(shape).copy())
        t = torch.from_numpy(_array(tgt, problems * n * 3).reshape(shape).copy())
        _array(out, problems * 16)[:] = kabsch.kabsch_rigid_transform_plain(s, t).reshape(-1).numpy()
        return 0

    def mamri_error_string(self, err):
        return b"invalid argument"


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors take the Kabsch wrapper's kernel path (and only its: the
    seam it sees calls every tensor a card's), into a `_FakeLibrary`."""
    lib = _FakeLibrary()

    class _Stream:
        cuda_stream = None

    seam = types.SimpleNamespace(on_cuda=lambda *tensors: True, check=_build.check, launch=_build.launch)
    monkeypatch.setattr(kabsch, "_build", seam)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    _build.reset_launch_counts()
    return lib


def _launched():
    """The launch counts that are not zero, by kernel."""
    return {name: n for name, n in _build.LAUNCHES.items() if n}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", WELL_POSED)
def test_twin_fit_equals_eigh_fit(case, seed):
    src, tgt = kabsch_case(case, seed)
    assert_same_fit(kabsch.kabsch_rigid_transform_plain(src, tgt), kabsch.kabsch_rigid_transform(src, tgt),
                    EIGH_ROT_ATOL, EIGH_MM_ATOL)


def test_twin_fit_of_no_spread_and_of_a_nan():
    """Zero points give the identity (the Jacobi sweeps leave the zero
    matrix and take its first column); a NaN coordinate gives NaN in the
    rotation and the translation."""
    assert torch.equal(kabsch.kabsch_rigid_transform_plain(*kabsch_case("zero")), torch.eye(4))
    got = kabsch.kabsch_rigid_transform_plain(*kabsch_case("nan"))
    assert torch.isnan(got[:3]).all() and torch.equal(got[3], torch.tensor([0.0, 0.0, 0.0, 1.0]))


def test_fit_broadcasts_the_source():
    src, tgt = kabsch_case("broadcast")
    for fit in (kabsch.kabsch_rigid_transform, kabsch.kabsch_rigid_transform_plain):
        got = fit(src, tgt)
        assert got.shape == (5, 4, 4)
        for i in range(5):
            assert_same_fit(got[i], fit(src, tgt[i]), 1e-6, 1e-4)


def test_cpu_fit_launches_nothing(monkeypatch):
    """The CPU path is eigh's: no kernel, no Jacobi sweeps, no counter."""

    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path reached the card's code")

    monkeypatch.setattr(kabsch, "_top_eigenvector", refuse)
    monkeypatch.setattr(_build, "library", refuse)
    _build.reset_launch_counts()
    tracer = Tracer()
    with tracer.span("request"):
        for case in WELL_POSED:
            kabsch.kabsch_rigid_transform(*kabsch_case(case))
    assert _launched() == {}
    assert "registration.kabsch_fused" not in tracer.counters


@pytest.mark.parametrize("bad", ["last_dim", "points_differ", "one_dim", "leading_dims", "mixed_devices",
                                 "meta_device"])
def test_fit_rejects_on_any_device(bad):
    src, tgt = kabsch_case("batch5")
    src, tgt = {
        "last_dim": (src[..., :2].contiguous(), tgt[..., :2].contiguous()),
        "points_differ": (src, tgt[:, :2].contiguous()),
        "one_dim": (src[0, 0], tgt[0, 0]),
        "leading_dims": (src, tgt[:4]),
        "mixed_devices": (src, tgt.to("meta")),
        "meta_device": (src.to("meta"), tgt.to("meta")),
    }[bad]
    with pytest.raises(ValueError):
        kabsch.kabsch_rigid_transform(src, tgt)


@pytest.mark.parametrize("bad", ["float64", "source_not_contiguous", "target_not_contiguous", "last_dim"])
def test_kernel_path_rejects(fake_card, bad):
    src, tgt = kabsch_case("batch5")
    src, tgt = {
        "float64": (src.double(), tgt.double()),
        "source_not_contiguous": (src.transpose(-1, -2).contiguous().transpose(-1, -2), tgt),
        "target_not_contiguous": (src, torch.cat([tgt, tgt], -1)[..., ::2]),
        "last_dim": (torch.cat([src, src[..., :1]], -1), torch.cat([tgt, tgt[..., :1]], -1)),
    }[bad]
    with pytest.raises((ValueError, TypeError)):
        kabsch.kabsch_rigid_transform(src, tgt)
    assert fake_card.calls == [] and _launched() == {}


@pytest.mark.parametrize("case", KABSCH_CASES)
def test_kernel_path_launches_once_a_fit(fake_card, case):
    """One launch a call, whatever the batch: the leading dimensions
    flattened (the source broadcast first where only the target has them),
    the output the twin's; the request's counter under a tracer."""
    src, tgt = kabsch_case(case)
    tracer = Tracer()
    with tracer.span("request"):
        got = kabsch.kabsch_rigid_transform(src, tgt)
    lead, n = tgt.shape[:-2], tgt.shape[-2]
    flat = (src.expand(tgt.shape).reshape(-1, n, 3), tgt.reshape(-1, n, 3))
    want = kabsch.kabsch_rigid_transform_plain(*flat).reshape(lead + (4, 4))
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert fake_card.calls == [(int(np.prod(lead)), n)]
    assert _launched() == {"kabsch": 1} and tracer.counters["registration.kabsch_fused"] == 1


def test_kernel_path_without_a_tracer_and_on_error(fake_card):
    src, tgt = kabsch_case("l_shape")
    kabsch.kabsch_rigid_transform(src, tgt)
    kabsch.kabsch_rigid_transform(src, tgt)
    assert _launched() == {"kabsch": 2}
    fake_card.err = 1
    with pytest.raises(RuntimeError, match="invalid argument"):
        kabsch.kabsch_rigid_transform(src, tgt)
    assert _launched() == {"kabsch": 2}


def test_pose_ik_fits_the_joint6_frame_by_one_launch(fake_card, monkeypatch):
    """`solve_full_chain_ik` fits the Joint6 frame once a solve: one launch
    on the kernel's path, to the angles the CPU path (eigh) finds, within
    tests/test_torch_engine.py's 1e-3 rad."""
    from lm_cases import lm_scene
    from mamri_tpu_torch.ik.residuals import solve_full_chain_ik

    model, kw = lm_scene(5, 12, False, True, "cpu")
    args = (model, kw["joint6_targets"], kw["base_tf"])
    opts = dict(joint4_targets=kw["joint4_targets"], joint4_found=kw["joint4_found"], num_iters=24,
                num_random_restarts=2)
    got = solve_full_chain_ik(*args, **opts)
    assert _launched() == {"kabsch": 1} and fake_card.calls == [(1, 3)]
    monkeypatch.undo()
    want = solve_full_chain_ik(*args, **opts)
    assert _launched() == {"kabsch": 1}
    torch.testing.assert_close(got.angles, want.angles, rtol=0, atol=1e-3)
