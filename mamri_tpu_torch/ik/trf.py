"""SciPy's TRF on the port's own IK residuals (port of `mamri_tpu/ik/trf.py`).

The reference solver's configuration, run on the residuals `ik/residuals.py`
builds: the pose IK is `scipy.optimize.least_squares(method="trf", bounds=
joint limits, ftol=xtol=1e-6)` from {current pose, zero pose}, keeping the
lower cost (Mamri/Mamri.py:1425, :1430-1437); the trajectory IK uses
ftol = xtol = 1e-4 and max_nfev = 200 (Mamri/Mamri.py:925-928). The Jacobian
handed to SciPy is `torch.func.jacfwd` of the same residual the LM
differentiates, so a disagreement between this oracle and
`solve_full_chain_ik` belongs to the solver, not to the objective.

The residual and its Jacobian run in float32 on the device of the `model`
passed in; SciPy works in float64 on the host, so on a card every
evaluation is a round trip. Pass a CPU model for the oracle, as
tools/ik_oracle_torch.py does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from mamri_tpu_torch.core.robot import RobotModel
from mamri_tpu_torch.ik.residuals import full_chain_residual, trajectory_pose_residual


class TRFResult(NamedTuple):
    angles: np.ndarray  # (J,) best solution
    rmse: float  # over the 9 Joint6 errors (pose), or the position error norm in mm (trajectory)
    cost: float  # 0.5 * |r|^2 (SciPy convention)
    best_guess: int  # which initial guess won
    nfev: int  # residual evaluations summed over guesses
    per_guess: np.ndarray  # (G, J) every converged solution
    per_guess_cost: np.ndarray  # (G,)


def _host_pair(residual, device):
    """(fun, jac): float64 numpy in and out around the float32 residual on
    `device` and its forward-mode Jacobian."""
    jac_fn = torch.func.jacfwd(residual)

    def on_device(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32).to(device)

    def fun(x):
        return residual(on_device(x)).cpu().numpy().astype(np.float64)

    def jac(x):
        return jac_fn(on_device(x)).cpu().numpy().astype(np.float64)

    return fun, jac


def _limits(model: RobotModel):
    limits = model.limits_rad.cpu().numpy().astype(np.float64)
    return limits[:, 0], limits[:, 1]


def _run_trf(fun, jac, guesses, lower, upper, ftol, xtol, max_nfev):
    from scipy.optimize import least_squares

    sols, costs, nfev = [], [], 0
    for g in guesses:
        x0 = np.clip(np.asarray(g, dtype=np.float64), lower, upper)
        out = least_squares(
            fun, x0, jac=jac, bounds=(lower, upper), method="trf",
            ftol=ftol, xtol=xtol, max_nfev=max_nfev,
        )
        sols.append(out.x)
        costs.append(out.cost)
        nfev += int(out.nfev)
    costs = np.asarray(costs)
    return sols, costs, int(np.argmin(costs)), nfev


def _guesses(nj, current_angles, extra_guesses=None):
    current = np.zeros(nj) if current_angles is None else current_angles
    guesses = [np.asarray(current, dtype=np.float64), np.zeros(nj)]
    if extra_guesses is not None:
        guesses += [np.asarray(g, dtype=np.float64) for g in extra_guesses]
    return guesses


def solve_full_chain_trf(
    model: RobotModel,
    joint6_targets,
    base_tf,
    current_angles=None,
    apply_correction: bool = False,
    joint4_targets=None,
    joint4_found: bool = False,
    extra_guesses: Optional[Sequence] = None,
    ftol: float = 1e-6,
    xtol: float = 1e-6,
    max_nfev: Optional[int] = None,
) -> TRFResult:
    """The reference's pose-IK solve (Mamri.py:1410-1447) on the port's
    residual, from {current pose, zeros} plus `extra_guesses` (e.g. the
    truth, or the analytic seeds the LM polishes)."""
    dev = model.device

    def t(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float32)).to(dev)

    j6, base = t(joint6_targets), t(base_tf)
    j4 = None if joint4_targets is None else t(joint4_targets)
    corr = torch.tensor(bool(apply_correction), device=dev)
    found4 = torch.tensor(bool(joint4_found), device=dev)

    def residual(x):
        return full_chain_residual(model, x, base, j6, corr, j4, found4)

    lower, upper = _limits(model)
    fun, jac = _host_pair(residual, dev)
    guesses = _guesses(model.num_joints, current_angles, extra_guesses)
    sols, costs, best, nfev = _run_trf(fun, jac, guesses, lower, upper, ftol, xtol, max_nfev)
    e6 = fun(sols[best])[:9]
    return TRFResult(
        angles=sols[best],
        rmse=float(np.sqrt(np.mean(e6 * e6))),
        cost=float(costs[best]),
        best_guess=best,
        nfev=nfev,
        per_guess=np.stack(sols),
        per_guess_cost=costs,
    )


def solve_trajectory_trf(
    model: RobotModel,
    target_tf,
    base_tf,
    current_angles=None,
    ftol: float = 1e-4,
    xtol: float = 1e-4,
    max_nfev: int = 200,
) -> TRFResult:
    """The reference's trajectory-IK solve (Mamri.py:882-939), the pose part
    of its residual only: the reference's 1e4 collision wall has zero
    gradient and is composed outside the solver, as in planning/."""
    dev = model.device
    target = torch.as_tensor(np.asarray(target_tf, dtype=np.float32)).to(dev)
    base = torch.as_tensor(np.asarray(base_tf, dtype=np.float32)).to(dev)

    def residual(x):
        return trajectory_pose_residual(model, x, base, target)

    lower, upper = _limits(model)
    fun, jac = _host_pair(residual, dev)
    guesses = _guesses(model.num_joints, current_angles)
    sols, costs, best, nfev = _run_trf(fun, jac, guesses, lower, upper, ftol, xtol, max_nfev)
    r = fun(sols[best])
    return TRFResult(
        angles=sols[best],
        rmse=float(np.linalg.norm(r[:3])),  # position error, mm
        cost=float(costs[best]),
        best_guess=best,
        nfev=nfev,
        per_guess=np.stack(sols),
        per_guess_cost=costs,
    )
