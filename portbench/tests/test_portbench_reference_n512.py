"""The benchmark's reference held to the port at the ``iiwa14_n512``
configuration's own sizes, f64 on the CPU: N = 512, the PCG cap of 67
(every solve of these systems ends there), 2 SQP iterations, on the first
512 rows of trace 3_4 with seeded perturbations of the start, the plan and
the multipliers.  The port runs the fused route's plain versions (the kernel
wrappers on CPU tensors).  And the copied trace 3_4 against the
repository's own."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check
from portbench.reference import update as R
from portbench.reference.arith import Arith
from portbench.reference.dynamics import Chain

from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SQPConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.solver.sqp import sqp_solve

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
CFG = json.loads((HERE / "configs" / "iiwa14_n512.json").read_text())
N, CAP = CFG["knots"], CFG["pcg_max_iter"]
F64 = torch.float64


def test_the_configuration_is_the_references_n512():
    assert (N, CAP) == (512, PCGConfig.tuned_max_iter(512))
    assert CFG["r_cost"] == CostConfig.for_knots(N).r_cost
    assert CFG["sqp_max_iter"] == 2 and CFG["batch"] == 1


@pytest.fixture(scope="module")
def solved():
    """Two perturbed instances of trace 3_4's rows 0-511 (numpy seed 11:
    the plan + 0.01, the start + 0.02, lam0 1e-3 N(0, 1)), solved by the
    reference and by the port.  Every line search takes a short step
    there (alpha 1/64 or 1/128), as the cell's do, so the step is
    compared too."""
    xu_t = np.loadtxt(HERE / "traces" / "3_4_traj.csv", delimiter=",")[:N]
    ee_t = np.loadtxt(HERE / "traces" / "3_4_eepos.traj", delimiter=",")[:N]
    g = np.random.default_rng(11)
    xu = torch.tensor(xu_t[None] + 0.01 * g.standard_normal((2, N, 21)))
    ee = torch.tensor(np.broadcast_to(ee_t, (2, N, 6)).copy())
    xs = xu[:, 0, :14] + torch.tensor(0.02 * g.standard_normal((2, 14)))
    lam = torch.tensor(1e-3 * g.standard_normal((2, N, 14)))
    rho = torch.tensor([1e-3, 2.5e-3], dtype=F64)
    ch, st = Chain(Arith("f64"), "cpu"), check.settings(CFG)
    got = R.sqp_solve(ch, st, xu, lam, xs, ee, rho)
    s = R.kkt_schur(ch, st, xu, xs, ee, rho)
    _, first_iters, _ = R.pcg(ch.ar, s["S"], s["Pinv"], s["gamma"], lam, CAP,
                              st.exit_tol)
    model = iiwa14(F64, device="cpu")
    want = [sqp_solve(model, CostConfig.for_knots(N),
                      SQPConfig(max_iter=2, max_time_us=None),
                      PCGConfig(max_iter=CAP, exit_tol=CFG["pcg_exit_tol"]),
                      xu[b], lam[b], xs[b], ee[b], rho[b], CFG["dt"],
                      linsys="pcg_cuda") for b in range(2)]
    return got, want, first_iters


def _rel(a, b):
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def test_sqp_solve_matches_the_port_at_n512(solved):
    """Tolerances: the two compute each SQP iteration's Schur system and
    CG in other orders of summation; after 67 CG steps on these systems
    (preconditioned condition ~1e4) lam differs by 1.0e-14-1.3e-14 of its
    largest entry, the plan by 2.2e-15-2.4e-15 and the merit by
    2.5e-16-1.3e-15 (f64 on the CPU).  The limits sit three orders of
    magnitude above that and far below what another step length or a
    changed term would move.  The exit test and the line search's choice
    are discrete and must agree: the reference's first PCG solve also runs
    to the cap, and both take the same short steps."""
    got, want, first_iters = solved
    for b in range(2):
        assert _rel(got.lam[b], want[b].lam) <= 1e-11
        assert _rel(got.xu[b], want[b].xu) <= 1e-12
        assert _rel(got.rho[b], want[b].rho) <= 1e-14
        assert _rel(got.merit[b], want[b].merit) <= 1e-12
        assert got.alpha_idx[b].tolist() == want[b].ls_alpha_idx.tolist()
        assert min(got.alpha_idx[b].tolist()) >= 5
        assert want[b].pcg_iters.tolist() == [CAP, CAP]
        assert int(first_iters[b]) == CAP
        assert not bool(got.converged[b])


def test_the_copied_trace_equals_the_repositorys():
    for name in ("3_4_traj.csv", "3_4_eepos.traj"):
        assert (HERE / "traces" / name).read_bytes() == \
            (ROOT / "data" / "trajfiles" / name).read_bytes()
