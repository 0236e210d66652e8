"""The full-chain pose IK's Levenberg-Marquardt solve as one CUDA kernel launch.

`full_chain_lm` runs the LM of `ik/lm.least_squares_lm` on the full-chain
marker residual (`ik/residuals.full_chain_residual`) for every guess at once:
on a CUDA tensor one launch of `csrc/lm.cu` (`mamri_full_chain_lm`) does every
iteration on the card, on a CPU tensor `full_chain_lm_plain` computes the same
arithmetic in plain torch over the guess axis. There is no fallback: a CUDA
tensor reaches the kernel or an error.

Both take the Jacobian in closed form. Every joint is a revolute about its
frame's axis, so the column of joint j at a marker p on a link at or below
j's is `w * cross(omega_j, p - o_j)`: omega_j the joint's world axis with the
sign of its axis code (IS +z, PA -y, LR +x, as in
`transforms.articulation_matrix`), o_j the joint frame's world origin, w the
row's weight (1 for the Joint6 rows, that of the Joint4 block for its rows).
Above j the column is zero. Both solve the damped normal equations, which are
symmetric positive definite, by Cholesky.

The generic `least_squares_lm` (any residual, `vmap(jacfwd)` Jacobian) stays
for the trajectory IK and the reference solver; nothing is shared with it.
Under a current tracer the solve is span `ik.lm.solve` and adds one to the
request's counter `ik.lm.fused_solves`; the launch is counted in
`_build.LAUNCHES["full_chain_lm"]`.
"""

from __future__ import annotations

import ctypes

import torch

from mamri_tpu_torch import _build
from mamri_tpu_torch.core import transforms
from mamri_tpu_torch.core.robot import RobotModel, fk_all_links
from mamri_tpu_torch.ik.lm import LMResult
from mamri_tpu_torch.utils.trace import current_count, current_span

JOINT4_WEIGHT = 0.05
LM_JOINTS = 6  # csrc/lm.cu: the joints of the chain it solves
LM_MAX_LINKS = 16  # csrc/lm.cu: the links a block keeps in shared memory


def joint6_local(model: RobotModel, apply_correction):
    """(3, 3) Joint6 marker points in its local frame, turned 180 degrees
    about z where the () bool `apply_correction` holds."""
    local = model.marker_local[model.link_index("Joint6")]
    return torch.where(apply_correction, transforms.flip_xy(local), local)


def _joint_axis(frame, axis_code: int):
    """(..., 3) world axis of a joint frame, signed as `articulation_matrix` turns."""
    if axis_code == transforms.AXIS_IS:
        return frame[..., :3, 2]
    if axis_code == transforms.AXIS_PA:
        return -frame[..., :3, 1]
    return frame[..., :3, 0]


def _descends(model: RobotModel, link: int, ancestor: int) -> bool:
    while link >= 0:
        if link == ancestor:
            return True
        link = model.specs[link].parent
    return False


def full_chain_jacobian(
    model: RobotModel,
    x,
    base_tf,
    joint6_targets,
    apply_correction,
    joint4_targets=None,
    joint4_found=None,
    joint4_weight: float = JOINT4_WEIGHT,
    jacobian: bool = True,
):
    """(r (..., 18), J (..., 18, J) or None): the full-chain marker residual
    (`ik/residuals.full_chain_residual`) at x (..., J) and, where `jacobian`,
    its Jacobian in closed form. The 18 rows are 9 Joint6 marker errors (the
    Joint6 local frame turned 180 degrees about z where `apply_correction`)
    and the Joint4 block, weighted `joint4_weight` where `joint4_found` and 0
    otherwise; `joint4_targets` None and `joint4_found` None mean zeros and
    False."""
    i6, i4 = model.link_index("Joint6"), model.link_index("Joint4")
    world = fk_all_links(model, x, base_tf)
    if joint4_targets is None:
        joint4_targets = torch.zeros((3, 3), dtype=x.dtype, device=x.device)
    found4 = torch.zeros((), dtype=torch.bool, device=x.device) if joint4_found is None else joint4_found
    w4 = torch.where(found4, joint4_weight, 0.0)
    p6 = transforms.apply(world[..., i6, :, :], joint6_local(model, apply_correction))  # (..., 3, 3)
    p4 = transforms.apply(world[..., i4, :, :], model.marker_local[i4])
    r = torch.cat([(p6 - joint6_targets).flatten(-2), (w4 * (p4 - joint4_targets)).flatten(-2)], -1)
    if not jacobian:
        return r, None
    cols = []
    for link in model.articulated_links:
        frame = world[..., link, :, :]
        axis = _joint_axis(frame, model.specs[link].axis_code)[..., None, :]
        origin = frame[..., None, :3, 3]
        col = []
        for p, marker_link, w in ((p6, i6, None), (p4, i4, w4)):
            if _descends(model, marker_link, link):
                c = torch.linalg.cross(axis.expand_as(p), p - origin, dim=-1)
                col.append((c if w is None else w * c).flatten(-2))
            else:
                col.append(torch.zeros_like(p).flatten(-2))
        cols.append(torch.cat(col, -1))
    return r, torch.stack(cols, -1)


def _cholesky_step(h, diag, mu, jac_eps: float, g):
    """(G, n) solution of (h + mu diag(diag) + jac_eps I) d = -g by Cholesky,
    entry by entry in the order `csrc/lm.cu` takes (a pivot that is not
    positive gives NaN, and the step is then rejected)."""
    n = h.shape[-1]
    a = h + mu[:, None, None] * torch.diag_embed(diag) + jac_eps * torch.eye(n, dtype=h.dtype, device=h.device)
    low = [[None] * n for _ in range(n)]
    for j in range(n):
        s = a[:, j, j]
        for k in range(j):
            s = s - low[j][k] * low[j][k]
        low[j][j] = torch.sqrt(s)
        for i in range(j + 1, n):
            v = a[:, i, j]
            for k in range(j):
                v = v - low[i][k] * low[j][k]
            low[i][j] = v / low[j][j]
    y = [None] * n
    for i in range(n):
        v = -g[:, i]
        for k in range(i):
            v = v - low[i][k] * y[k]
        y[i] = v / low[i][i]
    d = [None] * n
    for i in reversed(range(n)):
        v = y[i]
        for k in range(i + 1, n):
            v = v - low[k][i] * d[k]
        d[i] = v / low[i][i]
    return torch.stack(d, -1)


def full_chain_lm_plain(
    model: RobotModel,
    guesses,
    lower,
    upper,
    base_tf,
    joint6_targets,
    apply_correction,
    joint4_targets=None,
    joint4_found=None,
    num_iters: int = 60,
    mu0: float = 1e-3,
    mu_inc: float = 4.0,
    mu_dec: float = 0.35,
    jac_eps: float = 1e-10,
    joint4_weight: float = JOINT4_WEIGHT,
) -> LMResult:
    """Plain twin of `full_chain_lm`: the kernel's arithmetic in torch over
    the guess axis; the iteration is `least_squares_lm`'s."""

    def rows(x, jacobian):
        return full_chain_jacobian(model, x, base_tf, joint6_targets, apply_correction, joint4_targets,
                                   joint4_found, joint4_weight, jacobian)

    def cost_of(x):
        r = rows(x, False)[0]
        return 0.5 * (r * r).sum(-1)

    x = torch.clamp(guesses, lower, upper)
    g_count = x.shape[0]
    mu = torch.full((g_count,), mu0, dtype=x.dtype, device=x.device)
    c = cost_of(x)
    accepted = torch.zeros((g_count,), dtype=torch.int32, device=x.device)
    for _ in range(num_iters):
        r, jac = rows(x, True)
        jt = jac.transpose(-1, -2)
        g = (jt @ r[..., None])[..., 0]
        h = jt @ jac
        diag = torch.clamp(torch.diagonal(h, dim1=-2, dim2=-1), min=jac_eps)
        x_new = torch.clamp(x + _cholesky_step(h, diag, mu, jac_eps, g), lower, upper)
        c_new = cost_of(x_new)
        improve = c_new < c
        x = torch.where(improve[:, None], x_new, x)
        c = torch.where(improve, c_new, c)
        mu = torch.clamp(torch.where(improve, mu * mu_dec, mu * mu_inc), 1e-12, 1e12)
        accepted = accepted + improve.to(torch.int32)
    r, jac = rows(x, True)
    g = (jac.transpose(-1, -2) @ r[..., None])[..., 0]
    return LMResult(x=x, cost=c, grad_norm=torch.linalg.norm(g, dim=-1), iterations=accepted)


def _check_inputs(model, guesses, lower, upper, base_tf, joint6_targets, apply_correction, joint4_targets,
                  joint4_found):
    nj = model.num_joints
    if guesses.dim() != 2 or guesses.shape[0] < 1:
        raise ValueError(f"full_chain_lm guesses: expected (G, {nj}) with G >= 1, got {tuple(guesses.shape)}")
    _build.check(guesses, "full_chain_lm guesses", torch.float32, (guesses.shape[0], nj))
    _build.check(lower, "full_chain_lm lower", torch.float32, (nj,))
    _build.check(upper, "full_chain_lm upper", torch.float32, (nj,))
    _build.check(base_tf, "full_chain_lm base_tf", torch.float32, (4, 4))
    _build.check(joint6_targets, "full_chain_lm joint6_targets", torch.float32, (3, 3))
    _build.check(apply_correction, "full_chain_lm apply_correction", torch.bool, ())
    tensors = [guesses, lower, upper, base_tf, joint6_targets, apply_correction, model.fixed_offsets,
               model.marker_local]
    if joint4_targets is not None:
        _build.check(joint4_targets, "full_chain_lm joint4_targets", torch.float32, (3, 3))
        tensors.append(joint4_targets)
    if joint4_found is not None:
        _build.check(joint4_found, "full_chain_lm joint4_found", torch.bool, ())
        tensors.append(joint4_found)
    return _build.on_cuda(*tensors)


def _launch(model, guesses, lower, upper, base_tf, joint6_targets, apply_correction, joint4_targets,
            joint4_found, num_iters, mu0, mu_inc, mu_dec, jac_eps, joint4_weight) -> LMResult:
    specs = model.specs
    if model.num_joints != LM_JOINTS or len(specs) > LM_MAX_LINKS:
        raise ValueError(f"full_chain_lm: the kernel solves chains of {LM_JOINTS} joints and at most "
                         f"{LM_MAX_LINKS} links, got {model.num_joints} joints and {len(specs)} links")

    def ints(values):
        return (ctypes.c_int * len(values))(*values)

    g_count = guesses.shape[0]
    dev = guesses.device
    x = torch.empty_like(guesses)
    cost = torch.empty(g_count, dtype=torch.float32, device=dev)
    grad_norm = torch.empty(g_count, dtype=torch.float32, device=dev)
    iterations = torch.empty(g_count, dtype=torch.int32, device=dev)
    i6, i4 = model.link_index("Joint6"), model.link_index("Joint4")
    _build.launch(
        "full_chain_lm", "mamri_full_chain_lm", dev,
        guesses.data_ptr(), g_count, lower.data_ptr(), upper.data_ptr(),
        ints([s.parent for s in specs]), ints([s.joint_index for s in specs]), ints([s.axis_code for s in specs]),
        len(specs), i6, i4, model.fixed_offsets.data_ptr(), base_tf.data_ptr(),
        joint6_targets.data_ptr(), model.marker_local[i6].data_ptr(),
        None if joint4_targets is None else joint4_targets.data_ptr(), model.marker_local[i4].data_ptr(),
        apply_correction.data_ptr(), None if joint4_found is None else joint4_found.data_ptr(), joint4_weight,
        num_iters, mu0, mu_inc, mu_dec, jac_eps,
        x.data_ptr(), cost.data_ptr(), grad_norm.data_ptr(), iterations.data_ptr(),
    )
    return LMResult(x=x, cost=cost, grad_norm=grad_norm, iterations=iterations)


def full_chain_lm(
    model: RobotModel,
    guesses,
    lower,
    upper,
    base_tf,
    joint6_targets,
    apply_correction,
    joint4_targets=None,
    joint4_found=None,
    num_iters: int = 60,
    mu0: float = 1e-3,
    mu_inc: float = 4.0,
    mu_dec: float = 0.35,
    jac_eps: float = 1e-10,
    joint4_weight: float = JOINT4_WEIGHT,
) -> LMResult:
    """`least_squares_lm` of `full_chain_residual` from each row of the
    (G, J) float32 `guesses` within [lower, upper]: one kernel launch on a
    card, `full_chain_lm_plain` on the CPU. `apply_correction` and
    `joint4_found` are 0-d bool tensors on the guesses' device, read there
    (no host wait); `joint4_targets` None and `joint4_found` None mean
    zeros and False."""
    on_cuda = _check_inputs(model, guesses, lower, upper, base_tf, joint6_targets, apply_correction,
                            joint4_targets, joint4_found)
    args = (model, guesses, lower, upper, base_tf, joint6_targets, apply_correction, joint4_targets,
            joint4_found, num_iters, mu0, mu_inc, mu_dec, jac_eps, joint4_weight)
    with current_span("ik.lm.solve"):
        result = _launch(*args) if on_cuda else full_chain_lm_plain(*args)
    current_count("ik.lm.fused_solves")
    return result
