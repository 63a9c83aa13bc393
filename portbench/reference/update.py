"""One control update of the MPCGPU controller, plain PyTorch.

The semantics of the MPCGPU reference's SQP solve (include/pcg/sqp.cuh)
and plant (include/common/integrator.cuh::simple_simulate) as the
configuration states them, batched over a leading instance axis b:

  * KKT blocks per knot: the explicit Euler step and its Jacobians, the
    end-effector tracking cost's gradient and rank-1 Gauss-Newton Hessian;
  * the positive-definite Schur system S lam = gamma with Q + rho I and
    R + rho I, and the symmetric-stair preconditioner;
  * warm-started PCG from the previous multipliers, each instance exiting
    on |r . P^-1 r| < exit_tol or at the cap;
  * the primal step dz, the l1 merit (mu = 10) at xu + alpha dz for alpha
    in (0, -1, -1/2, ..., -1/2^7), and the Levenberg-Marquardt rho
    schedule; an instance whose rho passes rho_max gives up and is frozen;
  * the plant: n_sub + 1 Euler substeps of the forward dynamics under the
    previous plan's controls.

Shapes: xu (b, N, nx + nu), lam (b, N, nx), xs (b, nx), ee (b, N, 6), rho
(b,).  Nothing here reads the program under test.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.arith import Arith
from portbench.reference.dynamics import (Chain, ee_xyz, ee_xyz_and_jac,
                                          euler_step, fd_and_gradient,
                                          forward_dynamics)


class Settings(NamedTuple):
    """The configuration's numbers that one update reads."""

    dt: float            # trajectory timestep
    qd_cost: float
    r_cost: float
    mu: float            # l1 merit penalty
    num_alphas: int
    sqp_max_iter: int
    pcg_max_iter: int
    exit_tol: float
    rho_min: float
    rho_factor: float
    rho_max: float
    rho_reset: float


class Plan(NamedTuple):
    xu: torch.Tensor         # (b, N, nx + nu)
    lam: torch.Tensor        # (b, N, nx)
    rho: torch.Tensor        # (b,)
    merit: torch.Tensor      # (b,) the merit of xu as the last line search saw it
    alpha_idx: torch.Tensor  # (b, sqp_max_iter) the chosen alpha's index, -1 = none
    converged: torch.Tensor  # (b,) bool: every PCG solve met the exit tolerance


def kkt_schur(ch: Chain, st: Settings, xu, xs, ee, rho):
    """(S (b, N, 3, nx, nx), Pinv likewise, gamma (b, N, nx), and the dz
    inputs Qinv, A, B, q, Rinv)."""
    ar, nq = ch.ar, ch.nq
    nx = 2 * nq
    x, u = xu[..., :nx], xu[..., nx:]
    q, qd = x[..., :-1, :nq], x[..., :-1, nq:]
    qdd, d_q, d_qd, minv = fd_and_gradient(ch, q, qd, u[..., :-1, :])
    dt = st.dt
    xnext = torch.cat([q + dt * qd, qd + dt * qdd], dim=-1)
    eye_q = torch.eye(nq, dtype=xu.dtype, device=xu.device)
    eye_x = torch.eye(nx, dtype=xu.dtype, device=xu.device)
    I = eye_q.expand(d_q.shape)
    A = torch.cat([torch.cat([I, dt * I], -1),
                   torch.cat([dt * d_q, I + dt * d_qd], -1)], -2)
    B = torch.cat([torch.zeros_like(minv), dt * minv], -2)
    c = torch.cat([(x[..., 0, :] - xs)[..., None, :], x[..., 1:, :] - xnext], -2)

    ee_pos, J = ee_xyz_and_jac(ch, x[..., :nq])
    gq = ar.mtv(J, ee_pos - ee[..., :3])
    qvec = torch.cat([gq, st.qd_cost * x[..., nq:]], -1)
    Q = torch.zeros(x.shape[:-1] + (nx, nx), dtype=xu.dtype, device=xu.device)
    Q[..., :nq, :nq] = gq[..., :, None] * gq[..., None, :]
    Q[..., nq:, nq:] = st.qd_cost * eye_q
    r = st.r_cost * u[..., :-1, :]

    rho_ = rho[:, None, None, None]
    Qinv = torch.linalg.inv(Q + rho_ * eye_x)
    Rinv = (eye_q / (st.r_cost + rho_)).expand(B.shape[:-2] + (nq, nq))
    AQ = ar.mm(A, Qinv[..., :-1, :, :])
    BR = ar.mm(B, Rinv)
    theta = torch.cat([Qinv[..., :1, :, :],
                       ar.mm(AQ, A.transpose(-1, -2))
                       + ar.mm(BR, B.transpose(-1, -2)) + Qinv[..., 1:, :, :]], -3)
    gamma = torch.cat([ar.mv(Qinv[..., :1, :, :], qvec[..., :1, :]),
                       ar.mv(Qinv[..., 1:, :, :], qvec[..., 1:, :]) - c[..., 1:, :]
                       - ar.mv(AQ, qvec[..., :-1, :]) - ar.mv(BR, r)], -2)
    zero = torch.zeros_like(AQ[..., :1, :, :])
    lower = torch.cat([zero, -AQ], -3)                   # block (k, k-1)
    upper = torch.cat([-AQ.transpose(-1, -2), zero], -3)  # block (k, k+1)
    S = torch.stack([lower, theta, upper], -3)
    D = torch.linalg.inv(theta)
    left = -ar.mm(ar.mm(D[..., 1:, :, :], lower[..., 1:, :, :]), D[..., :-1, :, :])
    right = -ar.mm(ar.mm(D[..., :-1, :, :], upper[..., :-1, :, :]), D[..., 1:, :, :])
    Pinv = torch.stack([torch.cat([zero, left], -3), D,
                        torch.cat([right, zero], -3)], -3)
    return dict(S=S, Pinv=Pinv, gamma=gamma, Qinv=Qinv, A=A, B=B, q=qvec,
                r=r, Rinv=Rinv)


def btd_mv(ar: Arith, M, v):
    """Block-tridiagonal M (b, N, 3, n, n) times v (b, N, n)."""
    y = ar.mv(M[..., 1, :, :], v)
    y[..., 1:, :] += ar.mv(M[..., 1:, 0, :, :], v[..., :-1, :])
    y[..., :-1, :] += ar.mv(M[..., :-1, 2, :, :], v[..., 1:, :])
    return y


def pcg(ar: Arith, S, Pinv, gamma, lam0, max_iter: int, exit_tol: float):
    """Warm-started PCG per instance; returns (lam, iterations (b,), met the
    exit tolerance (b,))."""
    dot = lambda a, b: (a * b).sum((-1, -2))
    r = gamma - btd_mv(ar, S, lam0)
    p = btd_mv(ar, Pinv, r)
    eta = dot(r, p)
    lam = lam0
    done = eta.abs() < exit_tol
    iters = torch.zeros_like(eta, dtype=torch.int64)
    for _ in range(max_iter):
        Sp = btd_mv(ar, S, p)
        alpha = (eta / dot(p, Sp))[:, None, None]
        lam_n, r_n = lam + alpha * p, r - alpha * Sp
        z = btd_mv(ar, Pinv, r_n)
        eta_n = dot(r_n, z)
        p_n = z + (eta_n / eta)[:, None, None] * p
        go = ~done
        g3 = go[:, None, None]
        lam, r, p = (torch.where(g3, lam_n, lam), torch.where(g3, r_n, r),
                     torch.where(g3, p_n, p))
        eta = torch.where(go, eta_n, eta)
        iters = iters + go
        done = done | (go & (eta_n.abs() < exit_tol))
    return lam, iters, done


def step_dz(ar: Arith, sys, lam, nx: int):
    """dx_k = Qinv_k (q_k - lam_k + A_k^T lam_{k+1}), du_k = Rinv (r_k +
    B_k^T lam_{k+1}); no A term and no control at the last knot."""
    at = ar.mtv(sys["A"], lam[..., 1:, :])
    rhs = sys["q"] - lam + torch.cat([at, torch.zeros_like(at[..., :1, :])], -2)
    dx = ar.mv(sys["Qinv"], rhs)
    du = ar.mv(sys["Rinv"], sys["r"] + ar.mtv(sys["B"], lam[..., 1:, :]))
    du = torch.cat([du, torch.zeros_like(du[..., :1, :])], -2)
    return torch.cat([dx, du], -1)


def merit(ch: Chain, st: Settings, xu, xs, ee):
    """l1 merit of plans xu (..., N, w) against xs (..., nx), ee (..., N,
    6): sum_k 1/2 (|ee_k - goal_k|^2 + qd_cost |qd_k|^2 + r_cost |u_k|^2)
    (no control term at the last knot) + mu (|x_0 - xs|_1 + sum_k
    |x_{k+1} - f(x_k, u_k)|_1)."""
    nq = ch.nq
    nx = 2 * nq
    x, u = xu[..., :nx], xu[..., nx:]
    pos = ((ee_xyz(ch, x[..., :nq]) - ee[..., :3]) ** 2).sum(-1)
    vel = st.qd_cost * (x[..., nq:] ** 2).sum(-1)
    ctl = st.r_cost * (u[..., :-1, :] ** 2).sum(-1)
    cost = 0.5 * (pos.sum(-1) + vel.sum(-1) + ctl.sum(-1))
    defect = (x[..., 1:, :] - euler_step(ch, x[..., :-1, :], u[..., :-1, :],
                                         st.dt)).abs().sum((-1, -2))
    return cost + st.mu * (defect + (x[..., 0, :] - xs).abs().sum(-1))


def alphas(st: Settings, dtype, device):
    a = -1.0 / 2.0 ** torch.arange(st.num_alphas, dtype=dtype, device=device)
    return torch.cat([torch.zeros(1, dtype=dtype, device=device), a])


def sqp_solve(ch: Chain, st: Settings, xu, lam, xs, ee, rho) -> Plan:
    """One control update's SQP solve: the plan (xu, lam, rho) it returns."""
    nx = 2 * ch.nq
    al = alphas(st, xu.dtype, xu.device)
    drho = torch.ones_like(rho)
    stop = torch.zeros_like(rho, dtype=torch.bool)
    merit_out = torch.full_like(rho, float("inf"))
    converged = torch.ones_like(rho, dtype=torch.bool)
    alpha_idx = torch.full(rho.shape + (st.sqp_max_iter,), -1, dtype=torch.int64,
                           device=rho.device)
    for it in range(st.sqp_max_iter):
        if it and bool(stop.all()):
            break
        sys = kkt_schur(ch, st, xu, xs, ee, rho)
        lam_n, _, met = pcg(ch.ar, sys["S"], sys["Pinv"], sys["gamma"], lam,
                            st.pcg_max_iter, st.exit_tol)
        dz = step_dz(ch.ar, sys, lam_n, nx)
        cand = xu[:, None] + al[:, None, None] * dz[:, None]
        m = merit(ch, st, cand, xs[:, None], ee[:, None])
        best = 1 + torch.argmin(m[:, 1:], -1, keepdim=True)
        m_best = m.gather(-1, best)[:, 0]
        ok = m_best < m[:, 0]
        drho_fail = torch.clamp(drho * st.rho_factor, min=st.rho_factor)
        rho_fail = torch.clamp(rho * drho_fail, min=st.rho_min)
        gave_up = rho_fail > st.rho_max
        drho_ok = torch.clamp(drho / st.rho_factor, max=1.0 / st.rho_factor)
        rho_ok = torch.clamp(rho * drho_ok, min=st.rho_min)
        rho_n = torch.where(ok, rho_ok, torch.where(
            gave_up, torch.full_like(rho, st.rho_reset), rho_fail))
        live = ~stop
        converged = converged & (~live | met)
        take = (ok & live)[:, None, None]
        xu = torch.where(take, xu + al[best[:, 0]][:, None, None] * dz, xu)
        lam = torch.where(live[:, None, None], lam_n, lam)
        rho = torch.where(live, rho_n, rho)
        drho = torch.where(live, torch.where(ok, drho_ok, drho_fail), drho)
        merit_out = torch.where(live, torch.where(ok, m_best, m[:, 0]), merit_out)
        alpha_idx[:, it] = torch.where(ok & live, best[:, 0] - 1, -1)
        stop = stop | (live & ~ok & gave_up)
    return Plan(xu, lam, rho, merit_out, alpha_idx, converged)


def plant(ch: Chain, st: Settings, xs, xu_plan, t_off: float, sim_time: float,
          n_sub: int, sim_step: float):
    """The measured state after sim_time: n_sub + 1 Euler substeps, substep
    i of length clip(sim_time - i sim_step, 0, sim_step) under the control
    of the plan knot whose window holds t_off + i sim_step."""
    nq = ch.nq
    N = xu_plan.shape[-2]
    q, qd = xs[..., :nq], xs[..., nq:]
    for i in range(n_sub + 1):
        k = min(int((t_off + i * sim_step) / st.dt), N - 1)
        h = min(max(sim_time - i * sim_step, 0.0), sim_step)
        qdd = forward_dynamics(ch, q, qd, xu_plan[..., k, 2 * nq:])
        q, qd = q + h * qd, qd + h * qdd
    return torch.cat([q, qd], -1)
