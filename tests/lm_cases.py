"""Scenes and the comparison of the full-chain LM tests
(tests/test_torch_fused_lm.py on the CPU, tests/test_torch_cuda.py on a
card). Imports no jax.

Two float32 implementations of one LM agree to rounding guess by guess only
where the problem is well conditioned: from a far or ill-conditioned start a
step multiplies the rounding of J (a few 1e-7 of it) by the condition number
of the damped system, a trial whose cost ties the current one at rounding
level is accepted or not, and the paths part. The generic LM parts from
itself so when its guesses move by one rounding. So the guesses in a pose's
basin are compared one by one, and every set of guesses by the answer it
gives.
"""

import math

import torch

from mamri_tpu_torch.core import transforms
from mamri_tpu_torch.core.robot import fk_all_links, load_robot_model

def lm_scene(seed: int, g_count: int, apply_correction: bool, joint4_found, device, basin: bool = False):
    """(model, kwargs of `full_chain_lm` but `num_iters`) on `device`: an arm
    pose drawn in 0.8 x the limits, a base turned as the demo scenes are, the
    Joint6 targets of its markers (flipped under the correction, as the
    engine's detected triplet is then) and Joint4 targets, each with 0.3 mm
    of noise. `g_count` guesses: 0.9 x the pose, zero, then alternately the
    pose moved by up to 0.3 rad a joint and draws in 0.8 x the limits; with
    `basin`, every guess is the pose moved so, and the pose keeps Joint3 and
    Joint5 0.3 rad or more from zero (away from the elbow's and the wrist's
    singularities). `joint4_found` None passes neither Joint4 targets nor the
    flag."""
    model = load_robot_model(device="cpu")
    gen = torch.Generator().manual_seed(seed)
    lower, upper = model.limits_rad.T.contiguous()
    truth = 0.8 * (lower + torch.rand(6, generator=gen) * (upper - lower))
    while basin and min(abs(float(truth[2])), abs(float(truth[4]))) < 0.3:
        truth = 0.8 * (lower + torch.rand(6, generator=gen) * (upper - lower))
    base = (transforms.translate(torch.tensor([5.0, -20.0, 30.0])) @ transforms.rot_x(torch.tensor(-math.pi / 2))
            @ transforms.rot_z(torch.tensor(0.4)))
    tfs = fk_all_links(model, truth, base)
    i6, i4 = model.link_index("Joint6"), model.link_index("Joint4")
    local6 = model.marker_local[i6]
    if apply_correction:
        local6 = transforms.flip_xy(local6)
    t6 = transforms.apply(tfs[i6], local6) + 0.3 * torch.randn(3, 3, generator=gen)
    t4 = transforms.apply(tfs[i4], model.marker_local[i4]) + 0.3 * torch.randn(3, 3, generator=gen)
    guesses = [] if basin else [0.9 * truth, torch.zeros(6)]
    for k in range(g_count - len(guesses)):
        u = torch.rand(6, generator=gen)
        guesses.append(truth + 0.3 * (2 * u - 1) if basin or k % 2 == 0 else 0.8 * (lower + u * (upper - lower)))
    model = load_robot_model(device=device)
    kw = dict(guesses=torch.stack(guesses), lower=lower, upper=upper, base_tf=base, joint6_targets=t6,
              apply_correction=torch.tensor(apply_correction))
    if joint4_found is not None:
        kw.update(joint4_targets=t4, joint4_found=torch.tensor(joint4_found))
    return model, {k: v.contiguous().to(device) for k, v in kw.items()}


def assert_same_in_basin(got, want, residual):
    """Guess by guess, LMResults `got` and `want` from guesses in the basin
    of a well-conditioned pose (`lm_scene(..., basin=True)`) agree to float32
    rounding: x within 1e-3 rad, the residual at x (`residual`: (N, J) ->
    (N, 18)) within 1e-2 mm, the cost within 1e-3 of it, both gradient
    norms below 1 mm^2/rad and within 1 of each other (converged: the rest
    is rounding), the accepted steps within 8 (after convergence a trial
    ties the cost at rounding level and is accepted or not)."""
    assert (got.x - want.x).abs().max() <= 1e-3
    assert (residual(got.x) - residual(want.x)).abs().max() <= 1e-2
    assert ((got.cost - want.cost).abs() <= 1e-3 * want.cost).all()
    assert (got.grad_norm < 1).all() and (want.grad_norm < 1).all()
    assert (got.grad_norm - want.grad_norm).abs().max() <= 1
    assert (got.iterations - want.iterations).abs().max() <= 8


def assert_same_answer(got, want, residual):
    """From any guesses (restarts far from the pose included, where an
    ill-conditioned step multiplies the rounding of J by the condition number
    and the paths part), both reach the same answer: the least cost within
    1e-3 of it, and the residual at its x within 1e-2 mm."""
    a, w = int(torch.argmin(got.cost)), int(torch.argmin(want.cost))
    assert abs(float(got.cost[a] - want.cost[w])) <= 1e-3 * float(want.cost[w])
    assert (residual(got.x[a:a + 1]) - residual(want.x[w:w + 1])).abs().max() <= 1e-2
