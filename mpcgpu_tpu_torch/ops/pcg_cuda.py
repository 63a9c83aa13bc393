"""K2: warm-started stair PCG with the dz recovery as its epilogue.

Port of ``mpcgpu_tpu/ops/pcg_pallas.py::pcg_dz_solve_pallas_lanes``; the
CUDA kernel is ``csrc/pcg_dz.cu``.  Takes the K1 output dict
(``solver/kkt_cuda.py``) in knot-leading layout.  ``pcg_dz_solve`` runs the
plain version for CPU tensors and the kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.ops.pcg import pcg_solve
from mpcgpu_tpu_torch.ops.schur import SchurSystem, compute_dz
from mpcgpu_tpu_torch.solver.kkt import KKTBlocks


def pcg_dz_solve_plain(sys: dict, lam0, u, rho, r_cost: float,
                       max_iter: int = 173, exit_tol=1e-6,
                       exit_criterion: str = "eta"):
    """``pcg_solve`` on (S, Pinv, gamma), then ``compute_dz`` on the K1
    blocks, with the ee cost's control terms R = r_cost I and r = r_cost u."""
    res = pcg_solve(sys["S"], sys["Pinv"], sys["gamma"], lam0,
                    max_iter=max_iter, exit_tol=exit_tol,
                    exit_criterion=exit_criterion)
    N, nu = u.shape
    rinv = torch.eye(nu, dtype=u.dtype, device=u.device) / (r_cost + rho)
    # compute_dz reads q, r, A, B of the KKT blocks and Qinv, Rinv of the
    # Schur system; A and B drop the kernel's zero last-knot blocks
    kkt = KKTBlocks(Q=None, q=sys["q"], R=None, r=r_cost * u[:-1],
                    A=sys["A"][:-1], B=sys["B"][:-1], c=None)
    schur = SchurSystem(S=sys["S"], Pinv=sys["Pinv"], gamma=sys["gamma"],
                        Qinv=sys["Qinv"], Rinv=rinv.expand(N - 1, nu, nu))
    return res.lam, compute_dz(kkt, schur, res.lam), res.iters, res.converged


def pcg_dz_solve(sys: dict, lam0, u, rho, r_cost: float, max_iter: int = 173,
                 exit_tol=1e-6, exit_criterion: str = "eta"):
    """Solve S lam = gamma from lam0 (N, nx), then recover dz.

    u (N, nu) are the current controls (rows of unit stride, e.g.
    ``xu[:, nx:]``); rho and exit_tol may be floats or 0-d tensors.
    Returns (lam (N, nx), dz (N, nx+nu), iters () int32, converged () bool).
    """
    if exit_criterion not in ("eta", "rnorm"):
        raise ValueError(f"unknown exit_criterion {exit_criterion!r}")
    if _kernels.on_cpu(lam0):
        return pcg_dz_solve_plain(sys, lam0, u, rho, r_cost, max_iter,
                                  exit_tol, exit_criterion)
    dev = lam0.device
    N, nx = lam0.shape
    nu = u.shape[-1]
    if nx != 14 or nu != 7:
        raise ValueError("the CUDA kernels are built for nx = 14, nu = 7")
    _kernels.require_knots(N)
    for name, shape in (("S", (N, 3, nx, nx)), ("Pinv", (N, 3, nx, nx)),
                        ("gamma", (N, nx)), ("Qinv", (N, nx, nx)),
                        ("A", (N, nx, nx)), ("B", (N, nx, nu)), ("q", (N, nx))):
        _kernels.require(sys[name], name, shape, dev)
    _kernels.require(lam0, "lam0", (N, nx), dev)
    _kernels.require(u, "u", (N, nu), dev, row_major=True)
    if int(max_iter) < 0:
        raise ValueError(f"max_iter must be >= 0, got {max_iter}")
    rho_t = _kernels.scalar(rho, dev)
    tol_t = _kernels.scalar(exit_tol, dev)

    lam = torch.empty((N, nx), dtype=torch.float32, device=dev)
    dz = torch.empty((N, nx + nu), dtype=torch.float32, device=dev)
    flags = torch.empty((2,), dtype=torch.int32, device=dev)
    code = _kernels.entry("pcg_dz.cu", "pcg_dz_launch")(
        sys["S"].data_ptr(), sys["Pinv"].data_ptr(), sys["gamma"].data_ptr(),
        lam0.data_ptr(), sys["Qinv"].data_ptr(), sys["A"].data_ptr(),
        sys["B"].data_ptr(), sys["q"].data_ptr(), u.data_ptr(), u.stride(0),
        rho_t.data_ptr(), float(r_cost), int(max_iter), tol_t.data_ptr(),
        int(exit_criterion == "rnorm"), N, lam.data_ptr(), dz.data_ptr(),
        flags.data_ptr(), flags.data_ptr() + 4, _kernels.stream_ptr(dev))
    _kernels.check(code, "pcg_dz_launch")
    pcg_dz_solve.launches += 1
    return lam, dz, flags[0], flags[1].bool()


pcg_dz_solve.launches = 0
