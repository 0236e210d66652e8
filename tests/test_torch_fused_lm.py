"""The full-chain LM of the pose IK (`mamri_tpu_torch/ik/fused_lm.py`) on the
CPU: its closed-form Jacobian against `torch.func.jacfwd` of
`full_chain_residual`, its plain twin against the generic
`ik/lm.least_squares_lm` on the same residual and guesses, a NaN guess and a
singular system rejected as the generic LM rejects them, and the wrapper's
checks. The kernel is held to the twin on a card by tests/test_torch_cuda.py;
what a pose request records is in tests/test_torch_trace.py.
"""

import pytest
import torch
from torch.func import jacfwd, vmap

from lm_cases import assert_same_answer, assert_same_in_basin, lm_scene
from mamri_tpu_torch import _build
from mamri_tpu_torch.ik import fused_lm
from mamri_tpu_torch.ik.lm import least_squares_lm
from mamri_tpu_torch.ik.residuals import full_chain_residual
from test_torch_engine import _one_torch_thread  # noqa: F401 (autouse)

FLAGS = [(False, None), (False, False), (False, True), (True, None), (True, False), (True, True)]


def _residual(model, kw):
    def res(x):
        return full_chain_residual(model, x, kw["base_tf"], kw["joint6_targets"], kw["apply_correction"],
                                   kw.get("joint4_targets"), kw.get("joint4_found"))

    return res


def _generic(model, kw, guesses, num_iters, **lm):
    return least_squares_lm(_residual(model, kw), guesses, kw["lower"], kw["upper"], num_iters=num_iters, **lm)


@pytest.mark.parametrize("apply_correction,joint4_found", FLAGS)
def test_jacobian_matches_jacfwd(apply_correction, joint4_found):
    model, kw = lm_scene(11, 12, apply_correction, joint4_found, "cpu")
    x = 0.8 * (kw["lower"] + torch.rand((16, 6), generator=torch.Generator().manual_seed(5))
               * (kw["upper"] - kw["lower"]))
    r, jac = fused_lm.full_chain_jacobian(model, x, kw["base_tf"], kw["joint6_targets"], kw["apply_correction"],
                                          kw.get("joint4_targets"), kw.get("joint4_found"))
    res = _residual(model, kw)
    want = vmap(jacfwd(res))(x)
    want_r = vmap(res)(x)
    assert (r - want_r).abs().max() <= 1e-6 * want_r.abs().max()  # one batched product against G single ones
    assert jac.shape == want.shape == (16, 18, 6)
    assert (jac - want).abs().max() <= 1e-5 * want.abs().max()
    if joint4_found is not True:
        assert not jac[:, 9:].any()  # the Joint4 block weighs nothing


@pytest.mark.parametrize("apply_correction,joint4_found", FLAGS)
def test_residual_is_the_jacobians_rows(apply_correction, joint4_found):
    """`full_chain_residual` of a (G, J) batch is `full_chain_jacobian`'s r,
    bit for bit: the 18 rows are coded once."""
    model, kw = lm_scene(3, 16, apply_correction, joint4_found, "cpu")
    args = (model, kw["guesses"], kw["base_tf"], kw["joint6_targets"], kw["apply_correction"],
            kw.get("joint4_targets"), kw.get("joint4_found"))
    got = full_chain_residual(*args)
    assert got.shape == (16, 18)
    assert torch.equal(got, fused_lm.full_chain_jacobian(*args)[0])


def _flat_residual(model, kw):
    return lambda x: fused_lm.full_chain_jacobian(model, x, kw["base_tf"], kw["joint6_targets"],
                                                  kw["apply_correction"], kw.get("joint4_targets"),
                                                  kw.get("joint4_found"), jacobian=False)[0]


LONG = [(n, c, f) for n in (24, 80) for c, f in ((False, False), (False, True), (True, False), (True, True))]


@pytest.mark.parametrize("num_iters,apply_correction,joint4_found", LONG)
def test_twin_matches_generic_lm_in_the_basin(num_iters, apply_correction, joint4_found):
    model, kw = lm_scene(7, 12, apply_correction, joint4_found, "cpu", basin=True)
    got = fused_lm.full_chain_lm_plain(model, num_iters=num_iters, **kw)
    assert got.iterations.dtype == torch.int32 and got.x.dtype == got.cost.dtype == torch.float32
    assert_same_in_basin(got, _generic(model, kw, kw["guesses"], num_iters), _flat_residual(model, kw))


@pytest.mark.parametrize("num_iters,apply_correction,joint4_found", LONG)
def test_twin_finds_the_generic_lms_answer(num_iters, apply_correction, joint4_found):
    model, kw = lm_scene(7, 12, apply_correction, joint4_found, "cpu")
    got = fused_lm.full_chain_lm_plain(model, num_iters=num_iters, **kw)
    assert_same_answer(got, _generic(model, kw, kw["guesses"], num_iters), _flat_residual(model, kw))


@pytest.mark.parametrize("num_iters", [1, 3])
@pytest.mark.parametrize("apply_correction,joint4_found", [(False, False), (False, True), (True, False), (True, True)])
def test_first_steps_accept_as_the_generic_lm(apply_correction, joint4_found, num_iters):
    """Before any guess converges every accept or reject is decisive: the
    same steps are accepted from every guess, restarts included."""
    model, kw = lm_scene(7, 12, apply_correction, joint4_found, "cpu")
    got = fused_lm.full_chain_lm_plain(model, num_iters=num_iters, **kw)
    assert torch.equal(got.iterations, _generic(model, kw, kw["guesses"], num_iters).iterations)


@pytest.mark.parametrize("jac_eps", [1e-10, 0.0])
@pytest.mark.parametrize("case", ["nan_guess", "singular"])
def test_nan_and_singular_guesses_are_rejected(case, jac_eps):
    """A NaN guess keeps its NaN, and normal equations with no rank (a base
    with no rotation part: every marker at the base's origin, J = 0) give no
    step or a NaN one; both are rejected every iteration, by the twin as by
    the generic LM."""
    model, kw = lm_scene(3, 6, False, True, "cpu")
    if case == "nan_guess":
        kw["guesses"][2, 4] = float("nan")
    else:
        kw["base_tf"] = torch.cat([torch.zeros(3, 3), kw["base_tf"][:3, 3:]], 1).contiguous()
        kw["base_tf"] = torch.cat([kw["base_tf"], torch.tensor([[0.0, 0.0, 0.0, 1.0]])]).contiguous()
    got = fused_lm.full_chain_lm_plain(model, num_iters=6, jac_eps=jac_eps, **kw)
    want = _generic(model, kw, kw["guesses"], 6, jac_eps=jac_eps)
    stuck = [2] if case == "nan_guess" else list(range(6))
    clamped = torch.clamp(kw["guesses"], kw["lower"], kw["upper"])
    for res in (got, want):
        assert res.iterations[stuck].tolist() == [0] * len(stuck)
        torch.testing.assert_close(res.x[stuck], clamped[stuck], rtol=0, atol=0, equal_nan=True)
    if case == "nan_guess":
        assert torch.isnan(got.cost[2]) and torch.isnan(want.cost[2])
        keep = [0, 1, 3, 4, 5]
        assert (got.iterations[keep] > 0).all()
    else:
        torch.testing.assert_close(got.cost, want.cost, rtol=1e-6, atol=0)


@pytest.mark.parametrize("bad", ["guess_rows", "guess_width", "guess_dtype", "bounds_shape", "base_shape",
                                 "flag_dtype", "found_shape", "meta_device", "mixed_devices", "not_contiguous"])
def test_wrapper_rejects(bad):
    model, kw = lm_scene(1, 4, False, True, "cpu")
    g = kw["guesses"]
    change = {
        "guess_rows": ("guesses", g[:0]),
        "guess_width": ("guesses", g[:, :5].contiguous()),
        "guess_dtype": ("guesses", g.double()),
        "bounds_shape": ("lower", kw["lower"][:5]),
        "base_shape": ("base_tf", kw["base_tf"][:3].contiguous()),
        "flag_dtype": ("apply_correction", kw["apply_correction"].int()),
        "found_shape": ("joint4_found", kw["joint4_found"].reshape(1)),
        "mixed_devices": ("joint6_targets", kw["joint6_targets"].to("meta")),
        "not_contiguous": ("guesses", torch.cat([g, g], 1)[:, ::2]),
    }
    if bad == "meta_device":  # every tensor on a device that is neither a card nor the CPU
        model, kw = lm_scene(1, 4, False, True, "meta")
    else:
        key, value = change[bad]
        kw[key] = value
    with pytest.raises((ValueError, TypeError)):
        fused_lm.full_chain_lm(model, num_iters=2, **kw)


def test_cpu_tensors_take_the_twin():
    model, kw = lm_scene(2, 5, True, True, "cpu")
    _build.reset_launch_counts()
    got = fused_lm.full_chain_lm(model, num_iters=4, **kw)
    want = fused_lm.full_chain_lm_plain(model, num_iters=4, **kw)
    assert not any(_build.LAUNCHES.values())
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
