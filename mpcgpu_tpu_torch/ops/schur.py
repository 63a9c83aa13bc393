"""Schur-complement condensation of the KKT system and its preconditioners.

Port of ``mpcgpu_tpu/ops/schur.py``, with the same conventions:

    S lambda = gamma,   S = C G_rho^{-1} C^T,  gamma = C G_rho^{-1} g - c

is the POSITIVE-definite Schur system (the reference stores -S, -gamma; the
CG iterates for lambda are the same).  Blocks, k = 1..N-1:

    theta_0 = Qr_0^{-1};                       gamma_0 = Qr_0^{-1} q_0
    theta_k = A Qr_{k-1}^{-1} A^T + B Rr^{-1} B^T + Qr_k^{-1}
    phi_k   = -A_{k-1} Qr_{k-1}^{-1}           (block (k, k-1))
    gamma_k = Qr_k^{-1} q_k - c_k - A Qr_{k-1}^{-1} q_{k-1} - B Rr^{-1} r_{k-1}

with Qr = Q + rho I and Rr = R + rho I.  gamma_0 leaves out the initial-state
residual c_0, as the reference does: the initial constraint acts on the step
only through the line-search merit.

The symmetric-stair preconditioner is Pinv = D^{-1} - D^{-1} T D^{-1}, with
D = blockdiag(theta_k) and T the off-diagonal part of S.
"""

from __future__ import annotations

import dataclasses

import torch

from mpcgpu_tpu_torch.ops.smallmat import gj_inverse


@dataclasses.dataclass
class SchurSystem:
    S: torch.Tensor        # (N, 3, nx, nx) positive-definite BTD Schur matrix
    Pinv: torch.Tensor     # (N, 3, nx, nx) preconditioner; (N, 5, ...) for stair2
    gamma: torch.Tensor    # (N, nx) right-hand side
    Qinv: torch.Tensor     # (N, nx, nx) (Q + rho I)^{-1}, reused by compute_dz
    Rinv: torch.Tensor     # (N-1, nu, nu) (R + rho I)^{-1}


def _pad(blocks, front: int, back: int):
    """Zero blocks before/after a stack of (k, n, n) blocks along axis 0."""
    z = torch.zeros_like(blocks[:1])
    return torch.cat([z] * front + [blocks] + [z] * back)


def form_schur_system(kkt, rho, preconditioner: str = "stair") -> SchurSystem:
    """Form (S, Pinv, gamma) from KKT blocks (``solver.kkt.KKTBlocks``)."""
    Q, q, R, r, A, B, c = kkt.Q, kkt.q, kkt.R, kkt.r, kkt.A, kkt.B, kkt.c
    nx = Q.shape[-1]
    rho = torch.as_tensor(rho, dtype=Q.dtype, device=Q.device)

    eyex = torch.eye(nx, dtype=Q.dtype, device=Q.device)
    eyeu = torch.eye(R.shape[-1], dtype=Q.dtype, device=Q.device)
    Qinv = gj_inverse(Q + rho * eyex)           # (N, nx, nx)
    Rinv = gj_inverse(R + rho * eyeu)           # (N-1, nu, nu)

    AQ = A @ Qinv[:-1]                          # A_k Qr_k^{-1}
    BR = B @ Rinv                               # B_k Rr_k^{-1}
    theta_rest = AQ @ A.transpose(-1, -2) + BR @ B.transpose(-1, -2) + Qinv[1:]
    theta = torch.cat([Qinv[:1], theta_rest])
    phi = -AQ                                   # block (k+1, k)

    gamma_0 = Qinv[0] @ q[0]
    gamma_rest = (
        torch.einsum("kij,kj->ki", Qinv[1:], q[1:])
        - c[1:]
        - torch.einsum("kij,kj->ki", AQ, q[:-1])
        - torch.einsum("kij,kj->ki", BR, r)
    )
    gamma = torch.cat([gamma_0[None], gamma_rest])

    S = torch.stack([_pad(phi, 1, 0), theta, _pad(phi.transpose(-1, -2), 0, 1)],
                    dim=1)
    L, U = S[:, 0], S[:, 2]                     # blocks (k,k-1) / (k,k+1)

    D = gj_inverse(theta)
    if preconditioner == "none":
        Pinv = torch.stack([torch.zeros_like(D), eyex.expand(D.shape),
                            torch.zeros_like(D)], dim=1)
    elif preconditioner == "jacobi":
        Pinv = torch.stack([torch.zeros_like(D), D, torch.zeros_like(D)], dim=1)
    elif preconditioner == "stair":
        left = -D[1:] @ L[1:] @ D[:-1]
        right = -D[:-1] @ U[:-1] @ D[1:]
        Pinv = torch.stack([_pad(left, 1, 0), D, _pad(right, 0, 1)], dim=1)
    elif preconditioner == "stair2":
        # one more Neumann term: D^-1 - D^-1 T D^-1 + D^-1 T D^-1 T D^-1,
        # block-pentadiagonal and unconditionally SPD
        off1_l = -D[1:] @ L[1:] @ D[:-1]
        off1_r = -D[:-1] @ U[:-1] @ D[1:]
        t_lo = L[1:] @ D[:-1] @ L[1:].transpose(-1, -2)
        t_hi = U[:-1] @ D[1:] @ U[:-1].transpose(-1, -2)
        t = _pad(t_lo, 1, 0) + _pad(t_hi, 0, 1)
        diag = D + D @ t @ D
        off2_l = D[2:] @ L[2:] @ D[1:-1] @ L[1:-1] @ D[:-2]
        off2_r = D[:-2] @ U[:-2] @ D[1:-1] @ U[1:-1] @ D[2:]
        Pinv = torch.stack([_pad(off2_l, 2, 0), _pad(off1_l, 1, 0), diag,
                            _pad(off1_r, 0, 1), _pad(off2_r, 0, 2)], dim=1)
    else:
        raise ValueError(f"unknown preconditioner {preconditioner!r}")

    return SchurSystem(S=S, Pinv=Pinv, gamma=gamma, Qinv=Qinv, Rinv=Rinv)


def compute_dz(kkt, schur: SchurSystem, lam):
    """Primal step from the costate solve:

        dx_k = Qr_k^{-1} (q_k - lam_k + A_k^T lam_{k+1})     (A term absent at N-1)
        du_k = Rr_k^{-1} (r_k + B_k^T lam_{k+1})

    Returns dz (N, nx+nu) with a zero control row at the last knot.
    """
    q, r, A, B = kkt.q, kkt.r, kkt.A, kkt.B
    at_lam = torch.einsum("kji,kj->ki", A, lam[1:])          # A_k^T lam_{k+1}
    rhs_x = q - lam + torch.cat([at_lam, torch.zeros_like(at_lam[:1])])
    dx = torch.einsum("kij,kj->ki", schur.Qinv, rhs_x)

    bt_lam = torch.einsum("kji,kj->ki", B, lam[1:])          # B_k^T lam_{k+1}
    du = torch.einsum("kij,kj->ki", schur.Rinv, r + bt_lam)
    du = torch.cat([du, torch.zeros_like(du[:1])])
    return torch.cat([dx, du], dim=-1)
