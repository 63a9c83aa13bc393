"""Preconditioned conjugate gradient on the block-tridiagonal Schur system.

Port of ``mpcgpu_tpu/ops/pcg.py``: warm-started PCG with a BTD matvec, a
block-banded preconditioner apply and two reductions per iteration, exiting
on |eta| = |r . P^{-1} r| < exit_tol ("eta") or ||r||_2 < exit_tol
("rnorm"), or at max_iter.  The loop is a host loop that reads the exit flag
once per iteration; this is the plain version that the PCG+dz kernel
(``ops/pcg_cuda.py``) is held against.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mpcgpu_tpu_torch.ops.btd import btd_matvec


class PCGResult(NamedTuple):
    lam: torch.Tensor        # (N, n) solution
    iters: torch.Tensor      # () int32 iterations taken
    converged: torch.Tensor  # () bool, True if exit_tol was reached


def pcg_solve(S, Pinv, gamma, lam0, max_iter: int = 173, exit_tol=1e-6,
              exit_criterion: str = "eta", precond_poly: int = 1) -> PCGResult:
    """Solve S lam = gamma with BTD S (N, 3, n, n) and block-banded Pinv
    (N, 2b+1, n, n), warm-started from lam0 (N, n).

    exit_tol may be a float or a 0-d tensor.  precond_poly: 1 applies Pinv
    directly; 2 applies the first-order polynomial refinement
    z = (2 Pinv - Pinv S Pinv) r (one more S and Pinv matvec per iteration;
    SPD only while lambda_max(S Pinv) < 2).  Only this plain route takes
    it, as in the JAX package, where no kernel does.
    """
    if exit_criterion not in ("eta", "rnorm"):
        raise ValueError(f"unknown exit_criterion {exit_criterion!r}")
    if precond_poly not in (1, 2):
        raise ValueError(f"precond_poly must be 1 or 2, got {precond_poly}")
    tol = torch.as_tensor(exit_tol, dtype=gamma.dtype, device=gamma.device)

    def apply_precond(r):
        z = btd_matvec(Pinv, r)
        if precond_poly == 2:
            z = 2.0 * z - btd_matvec(Pinv, btd_matvec(S, z))
        return z

    def exit_test(r, eta):
        if exit_criterion == "rnorm":
            return torch.sum(r * r) < tol * tol
        return torch.abs(eta) < tol

    r = gamma - btd_matvec(S, lam0)
    p = apply_precond(r)
    eta = torch.sum(r * p)
    lam = lam0
    done = exit_test(r, eta)
    it = 0
    # once `done` the loop stops; steps after it would be masked no-ops
    while it < max_iter and not bool(done):
        Sp = btd_matvec(S, p)
        alpha = eta / torch.sum(p * Sp)
        lam = lam + alpha * p
        r = r - alpha * Sp
        z = apply_precond(r)
        eta_new = torch.sum(r * z)
        done = exit_test(r, eta_new)
        p = z + (eta_new / eta) * p
        eta = eta_new
        it += 1
    return PCGResult(lam=lam,
                     iters=torch.tensor(it, dtype=torch.int32, device=gamma.device),
                     converged=done)
