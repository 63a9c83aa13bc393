"""l1-penalty merit function and the batched line search.

Port of ``mpcgpu_tpu/solver/merit.py``.  Every function takes trajectories
with optional leading candidate dimensions, xu (..., N, nx+nu).  Knot roles:

  * knots 0..N-2 contribute the integrator defect |x_{k+1} - f(x_k, u_k)|_1;
  * the initial-state residual |x_0 - xs|_1 enters when ``include_x0``;
  * the last knot has no control penalty.
"""

from __future__ import annotations

import torch

from mpcgpu_tpu_torch.config import CostConfig
from mpcgpu_tpu_torch.models import dynamics
from mpcgpu_tpu_torch.models.robot import RobotModel


def tracking_cost(model: RobotModel, cost: CostConfig, xu, goal):
    """Sum over knots of the tracking cost J_k, (..., N, w) -> (...):

      ee:    J_k = 1/2 |ee(q_k) - goal_k|^2 + 1/2 QD |qd_k|^2 + 1/2 R |u_k|^2
      joint: J_k = 1/2 Q |q_k - qref_k|^2 + 1/2 QD |qd_k - qdref_k|^2 + 1/2 R |u_k|^2

    with no control term at the last knot.
    """
    return torch.sum(tracking_cost_per_knot(model, cost, xu, goal), dim=-1)


def tracking_cost_per_knot(model: RobotModel, cost: CostConfig, xu, goal):
    """The terms J_k of ``tracking_cost``, (..., N, w) -> (..., N)."""
    nq = model.nq
    N = xu.shape[-2]
    q, qd, u = xu[..., :nq], xu[..., nq : 2 * nq], xu[..., 2 * nq :]
    if cost.mode == "ee":
        ee = dynamics.fk_ee_xyz(model, q)
        pos_err = torch.sum((ee - goal[..., :3]) ** 2, dim=-1)
        qd_pen = cost.qd_cost * torch.sum(qd**2, dim=-1)
    elif cost.mode == "joint":
        pos_err = cost.q_cost * torch.sum((q - goal[..., :nq]) ** 2, dim=-1)
        qd_err = qd if cost.absolute_qd_penalty else qd - goal[..., nq : 2 * nq]
        qd_pen = cost.qd_cost * torch.sum(qd_err**2, dim=-1)
    else:
        raise ValueError(f"unknown cost mode {cost.mode!r}")
    u_pen = cost.r_cost * torch.sum(u**2, dim=-1)
    u_mask = torch.arange(N, device=xu.device) < N - 1
    return 0.5 * (pos_err + qd_pen + torch.where(u_mask, u_pen, 0.0))


def constraint_l1(model: RobotModel, xu, xs, dt, include_x0: bool,
                  integrator_type: int = 0, angle_wrap: bool = False):
    """mu-free total l1 constraint violation over knots, (..., N, w) -> (...)."""
    from mpcgpu_tpu_torch.solver.kkt import integrator_step

    nx = 2 * model.nq
    x, u = xu[..., :nx], xu[..., nx:]
    xnext = integrator_step(model, x[..., :-1, :], u[..., :-1, :], dt,
                            integrator_type, angle_wrap)
    total = torch.sum(torch.sum(torch.abs(x[..., 1:, :] - xnext), dim=-1), dim=-1)
    if include_x0:
        total = total + torch.sum(torch.abs(x[..., 0, :] - xs), dim=-1)
    return total


def merit_function(model: RobotModel, cost: CostConfig, xu, xs, ee_goal, mu, dt,
                   include_x0: bool, integrator_type: int = 0,
                   angle_wrap: bool = False):
    """phi(xu) = sum_k J_k + mu * sum_k |c_k|_1."""
    return tracking_cost(model, cost, xu, ee_goal) + mu * constraint_l1(
        model, xu, xs, dt, include_x0, integrator_type, angle_wrap)


def line_search_alphas(num_alphas: int, include_zero: bool, dtype, device):
    """alpha_i = -1/2^i, i = 0..num_alphas-1, with 0 prepended if asked."""
    alphas = -1.0 / (2.0 ** torch.arange(num_alphas, dtype=dtype, device=device))
    if include_zero:
        alphas = torch.cat([torch.zeros(1, dtype=dtype, device=device), alphas])
    return alphas


def line_search_merits(model: RobotModel, cost: CostConfig, xu, dz, xs, ee_goal,
                       mu, dt, num_alphas: int = 8, integrator_type: int = 0,
                       include_zero: bool = False, angle_wrap: bool = False):
    """Merit at xu + alpha_i dz for every line-search alpha, in one batched
    pass.  With ``include_zero``, merits[0] is the merit of xu itself.

    Returns (merits (A,), alphas (A,)).
    """
    alphas = line_search_alphas(num_alphas, include_zero, xu.dtype, xu.device)
    cand = xu[None] + alphas[:, None, None] * dz[None]
    merits = merit_function(model, cost, cand, xs, ee_goal, mu, dt,
                            include_x0=True, integrator_type=integrator_type,
                            angle_wrap=angle_wrap)
    return merits, alphas


def merit_partials(model: RobotModel, cost: CostConfig, xu, dz, ee_goal, dt,
                   num_alphas: int = 8, integrator_type: int = 0,
                   include_zero: bool = True, angle_wrap: bool = False):
    """Each knot's merit terms at every candidate xu + alpha dz, alpha in
    (0, -1, -1/2, ..., -1/2^(num_alphas-1)), the 0 only with
    ``include_zero``: the cost J_k and the defect
    |x_{k+1} - f(x_k, u_k)|_1 (0 at the last knot), with the candidates
    after any leading axes of xu (..., N, w).  Returns (cost (..., A, N),
    defect (..., A, N), alphas (A,)): the plain version of K9c, which sums
    nothing, so that a knot shard's slab (its knots and its right
    neighbour's first) gives its part of the merits."""
    from mpcgpu_tpu_torch.solver.kkt import integrator_step

    nx = 2 * model.nq
    alphas = line_search_alphas(num_alphas, include_zero, xu.dtype, xu.device)
    cand = xu[..., None, :, :] + alphas[:, None, None] * dz[..., None, :, :]
    cost_k = tracking_cost_per_knot(model, cost, cand, ee_goal[..., None, :, :])
    x, u = cand[..., :nx], cand[..., nx:]
    xnext = integrator_step(model, x[..., :-1, :], u[..., :-1, :], dt,
                            integrator_type, angle_wrap)
    defect = torch.sum(torch.abs(x[..., 1:, :] - xnext), dim=-1)
    defect = torch.cat([defect, torch.zeros_like(defect[..., :1])], dim=-1)
    return cost_k, defect, alphas
