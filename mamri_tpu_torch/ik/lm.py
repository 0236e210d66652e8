"""Bounded Levenberg-Marquardt least squares, batched over initial guesses.

Port of `mamri_tpu/ik/lm.py`: fixed `num_iters` iterations of
(J^T J + mu * diag(J^T J)) d = -J^T r, the step projected onto the box,
accepted on a cost decrease (mu shrinks) or rejected (mu grows). The JAX
version vmaps one solve over guesses; here the guess axis is the leading
batch dimension of every tensor, and the Jacobian comes from
`torch.func.vmap(torch.func.jacfwd(...))`. `torch.linalg.solve_ex` does not
check for singular systems (no host sync), like `jnp.linalg.solve`. Each
Jacobian evaluation of the host loop (`num_iters + 1` a solve) is span
`ik.lm.jacobian` of the current tracer's request, where there is one.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import jacfwd, vmap

from mamri_tpu_torch.utils.trace import current_span


class LMResult(NamedTuple):
    x: torch.Tensor  # (G, n) solutions
    cost: torch.Tensor  # (G,) final 0.5 * sum(r^2)
    grad_norm: torch.Tensor  # (G,) |J^T r| at the solution
    iterations: torch.Tensor  # (G,) accepted-step counts


def least_squares_lm(
    residual_fn: Callable,
    x0,
    lower,
    upper,
    num_iters: int = 60,
    mu0: float = 1e-3,
    mu_inc: float = 4.0,
    mu_dec: float = 0.35,
    jac_eps: float = 1e-10,
) -> LMResult:
    """Minimize 0.5*|residual_fn(x)|^2 s.t. lower <= x <= upper for each of
    the (G, n) guesses `x0`. `residual_fn` maps one (n,) point to (m,) and
    must be composable with torch.func (no in-place writes, no host reads)."""
    residuals = vmap(residual_fn)

    def with_value(x):
        r = residual_fn(x)
        return r, r

    jac_and_res = vmap(jacfwd(with_value, has_aux=True))

    def cost_of(x):
        r = residuals(x)
        return 0.5 * (r * r).sum(-1)

    x = torch.clamp(x0, lower, upper)
    g_count, n = x.shape
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    mu = torch.full((g_count,), mu0, dtype=x.dtype, device=x.device)
    c = cost_of(x)
    accepted = torch.zeros((g_count,), dtype=torch.int32, device=x.device)
    for _ in range(num_iters):
        with current_span("ik.lm.jacobian"):
            jac, r = jac_and_res(x)  # (G, m, n), (G, m)
        jt = jac.transpose(-1, -2)
        g = (jt @ r[..., None])[..., 0]
        h = jt @ jac
        diag = torch.clamp(torch.diagonal(h, dim1=-2, dim2=-1), min=jac_eps)
        h_damped = h + mu[:, None, None] * torch.diag_embed(diag) + jac_eps * eye
        delta = torch.linalg.solve_ex(h_damped, -g[..., None])[0][..., 0]
        x_new = torch.clamp(x + delta, lower, upper)
        c_new = cost_of(x_new)
        improve = c_new < c
        x = torch.where(improve[:, None], x_new, x)
        c = torch.where(improve, c_new, c)
        mu = torch.clamp(torch.where(improve, mu * mu_dec, mu * mu_inc), 1e-12, 1e12)
        accepted = accepted + improve.to(torch.int32)
    with current_span("ik.lm.jacobian"):
        jac, r = jac_and_res(x)
    g = (jac.transpose(-1, -2) @ r[..., None])[..., 0]
    return LMResult(x=x, cost=c, grad_norm=torch.linalg.norm(g, dim=-1), iterations=accepted)


def multistart_lm(residual_fn, guesses, lower, upper, **kw):
    """(LMResult of the best guess, its index): LM from each of the (G, n)
    `guesses`, the lowest final cost kept (`torch.argmin` takes the first of
    equal costs, as `jnp.argmin` does)."""
    results = least_squares_lm(residual_fn, guesses, lower, upper, **kw)
    best = torch.argmin(results.cost).reshape(1)  # index_select: no host read of the index
    return LMResult(
        x=results.x.index_select(0, best)[0],
        cost=results.cost.index_select(0, best)[0],
        grad_norm=results.grad_norm.index_select(0, best)[0],
        iterations=results.iterations.index_select(0, best)[0],
    ), best[0]
