"""KKT block assembly: dynamics linearization and tracking-cost quadratics.

Port of ``mpcgpu_tpu/solver/kkt.py``, batched over the knot axis.  ``xu`` is
(N, nx+nu); the last knot's control slot is unused.  QP convention:

  min 1/2 dz^T G dz + g^T dz  s.t.  C dz + c = 0, per-knot blocks
  G = blkdiag(Q_0, R_0, ..., Q_{N-1}),  g = (q_0, r_0, ..., q_{N-1}),
  row 0: dx_0 + (x_0 - xs) = 0;
  row k+1: dx_{k+1} - A_k dx_k - B_k du_k + c_{k+1} = 0 with
  c_{k+1} = x_{k+1} - f(x_k, u_k), the integrator defect.
"""

from __future__ import annotations

import dataclasses

import torch

from mpcgpu_tpu_torch.config import CostConfig
from mpcgpu_tpu_torch.models import dynamics
from mpcgpu_tpu_torch.models.robot import RobotModel


@dataclasses.dataclass
class KKTBlocks:
    """Per-knot KKT data (all knot-leading)."""

    Q: torch.Tensor        # (N, nx, nx) state cost Hessians
    q: torch.Tensor        # (N, nx)     state cost gradients
    R: torch.Tensor        # (N-1, nu, nu) control cost Hessians
    r: torch.Tensor        # (N-1, nu)     control cost gradients
    A: torch.Tensor        # (N-1, nx, nx) dynamics state Jacobians
    B: torch.Tensor        # (N-1, nx, nu) dynamics control Jacobians
    c: torch.Tensor        # (N, nx) constraint residuals; c[0] = x0 - xs


# The reference's angleWrap uses a truncated pi literal; kept for parity.
_WRAP_PI = 3.14159


def angle_wrap(q):
    """The reference's angleWrap: a REFLECTION at +-pi, not a modular wrap —
    q > pi maps to -(q - pi), q < -pi to -(q + pi)."""
    q = torch.where(q > _WRAP_PI, -(q - _WRAP_PI), q)
    return torch.where(q < -_WRAP_PI, -(q + _WRAP_PI), q)


def _step(q, qd, qdd, dt, integrator_type: int, wrap: bool):
    if integrator_type == 0:        # explicit Euler
        qn, qdn = q + dt * qd, qd + dt * qdd
    elif integrator_type == 1:      # semi-implicit Euler
        qdn = qd + dt * qdd
        qn = q + dt * qdn
    else:
        raise ValueError(f"integrator_type {integrator_type} not in (0, 1)")
    if wrap:
        qn = angle_wrap(qn)
    return torch.cat([qn, qdn], dim=-1)


def integrator_step(model: RobotModel, x, u, dt, integrator_type: int = 0,
                    wrap: bool = False):
    """One integrator step x (..., nx), u (..., nu) -> x+ (..., nx).
    0 = explicit Euler, 1 = semi-implicit Euler; ``wrap`` reflects the
    positions at +-pi after the step."""
    nq = model.nq
    q, qd = x[..., :nq], x[..., nq:]
    qdd = dynamics.forward_dynamics_aba(model, q, qd, u)
    return _step(q, qd, qdd, dt, integrator_type, wrap)


def euler_step_and_jacobians(model: RobotModel, x, u, dt,
                             integrator_type: int = 0, wrap: bool = False):
    """One integrator step x+ and its Jacobians A = dx+/dx, B = dx+/du:

      type 0 (Euler):         A = I + dt*[[0, I], [dqdd/dq, dqdd/dqd]],
                              B = [0; dt * M^{-1}]
      type 1 (semi-implicit): A = [[I + dt^2 dq, dt I + dt^2 dqd],
                                   [dt dq,       I + dt dqd     ]],
                              B = [dt^2 M^{-1}; dt M^{-1}]

    The angle wrap changes the step value only, not the Jacobians.
    """
    nq = model.nq
    q, qd = x[..., :nq], x[..., nq:]
    qdd, dq, dqd, minv = dynamics.fd_and_gradient(model, q, qd, u)
    eye = torch.eye(nq, dtype=x.dtype, device=x.device).expand(dq.shape)
    zero = torch.zeros_like(dq)
    if integrator_type == 0:
        A = torch.cat([torch.cat([eye, dt * eye], -1),
                       torch.cat([dt * dq, eye + dt * dqd], -1)], -2)
        B = torch.cat([zero, dt * minv], -2)
    elif integrator_type == 1:
        A = torch.cat([torch.cat([eye + dt * dt * dq, dt * eye + dt * dt * dqd], -1),
                       torch.cat([dt * dq, eye + dt * dqd], -1)], -2)
        B = torch.cat([dt * dt * minv, dt * minv], -2)
    else:
        raise ValueError(f"integrator_type {integrator_type} not in (0, 1)")
    return _step(q, qd, qdd, dt, integrator_type, wrap), A, B


def tracking_cost_grad_hess(model: RobotModel, cost: CostConfig, x, u, goal):
    """Per-knot tracking-cost gradient and Hessian, batched over knots.

    ee mode:    q[:nq] = J_ee^T (ee(q) - goal_xyz);  q[nq:] = QD * qd;
                Q[:nq,:nq] = outer(q[:nq], q[:nq]) (the reference's rank-1
                Gauss-Newton block);  Q[nq:,nq:] = QD * I.
    joint mode: diagonal quadratic tracking of the (nx,) state reference.
    Both: R = R_COST * I, r = R_COST * u.
    """
    nq = model.nq
    qpos, qd = x[..., :nq], x[..., nq:]
    eyeq = torch.eye(nq, dtype=x.dtype, device=x.device)
    if cost.mode == "ee":
        ee, J = dynamics.fk_ee_xyz_and_jac(model, qpos)
        err = ee - goal[..., :3]
        gq = (J.transpose(-1, -2) @ err[..., None])[..., 0]
        grad = torch.cat([gq, cost.qd_cost * qd], dim=-1)
        zero = torch.zeros(gq.shape[:-1] + (nq, nq), dtype=x.dtype, device=x.device)
        Q = torch.cat([
            torch.cat([gq[..., :, None] * gq[..., None, :], zero], -1),
            torch.cat([zero, (cost.qd_cost * eyeq).expand(zero.shape)], -1)], -2)
    elif cost.mode == "joint":
        qd_err = qd if cost.absolute_qd_penalty else qd - goal[..., nq : 2 * nq]
        grad = torch.cat([cost.q_cost * (qpos - goal[..., :nq]),
                          cost.qd_cost * qd_err], dim=-1)
        diag = torch.cat([torch.full((nq,), cost.q_cost, dtype=x.dtype),
                          torch.full((nq,), cost.qd_cost, dtype=x.dtype)])
        Q = torch.diag(diag).to(x.device).expand(x.shape[:-1] + (2 * nq, 2 * nq))
    else:
        raise ValueError(f"unknown cost mode {cost.mode!r}")
    r = cost.r_cost * u
    R = (cost.r_cost * eyeq).expand(u.shape[:-1] + (nq, nq))
    return Q, grad, R, r


def build_kkt(model: RobotModel, cost: CostConfig, xu, xs, ee_goal, dt,
              integrator_type: int = 0, angle_wrap: bool = False) -> KKTBlocks:
    """Assemble all KKT blocks for the current iterate.

    xu (N, nx+nu); xs (nx,) measured initial state; ee_goal (N, 6) goal trace
    (or the (N, nx) state reference in joint mode).  Unless
    ``cost.terminal_at_last_state``, the terminal cost is evaluated at
    x_{N-2}, as the reference does.
    """
    nx = 2 * model.nq
    x, u = xu[:, :nx], xu[:, nx:]
    xnext, A, B = euler_step_and_jacobians(model, x[:-1], u[:-1], dt,
                                           integrator_type, angle_wrap)
    c = torch.cat([(x[0] - xs)[None], x[1:] - xnext])
    x_eval = x if cost.terminal_at_last_state else torch.cat([x[:-1], x[-2:-1]])
    Q, q, R, r = tracking_cost_grad_hess(model, cost, x_eval, u, ee_goal)
    return KKTBlocks(Q=Q, q=q, R=R[:-1], r=r[:-1], A=A, B=B, c=c)
