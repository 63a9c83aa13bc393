"""The benchmark's reference (``portbench/reference/``) held to the port's
plain versions at f64 and a small horizon, on the CPU.  The test imports
the port; the reference does not."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check
from portbench.reference import update as R
from portbench.reference.arith import Arith, round_tf32
from portbench.reference.dynamics import Chain

from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SQPConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.ops.pcg import pcg_solve
from mpcgpu_tpu_torch.ops.pcg_cuda import compute_dz_plain
from mpcgpu_tpu_torch.sim.plant_cuda import simulate_plant_plain
from mpcgpu_tpu_torch.solver.kkt_cuda import build_kkt_schur_plain
from mpcgpu_tpu_torch.solver.merit import line_search_merits
from mpcgpu_tpu_torch.solver.sqp import sqp_solve

HERE = Path(__file__).resolve().parents[1]
N, DT, MU, CAP = 16, 1.0 / 64.0, 10.0, 30
F64 = torch.float64


def _cfg():
    cost = CostConfig.for_knots(N)
    return dict(dt=DT, qd_cost=cost.qd_cost, r_cost=cost.r_cost, mu=MU,
                num_alphas=8, sqp_max_iter=2, pcg_max_iter=CAP,
                pcg_exit_tol=1e-5, rho_min=1e-3, rho_factor=1.2, rho_max=10.0,
                rho_reset=1e-3)


@pytest.fixture(scope="module")
def problem():
    """Two instances from trace 0_0's rows 350 and 40, perturbed."""
    xu_t = np.loadtxt(HERE / "traces" / "0_0_traj.csv", delimiter=",")
    ee_t = np.loadtxt(HERE / "traces" / "0_0_eepos.traj", delimiter=",")
    g = np.random.default_rng(7)
    rows = (350, 40)
    xu = torch.tensor(np.stack([xu_t[r:r + N] for r in rows])
                      + 0.01 * g.standard_normal((2, N, 21)))
    ee = torch.tensor(np.stack([ee_t[r:r + N] for r in rows]))
    xs = xu[:, 0, :14] + torch.tensor(0.01 * g.standard_normal((2, 14)))
    lam = torch.tensor(0.1 * g.standard_normal((2, N, 14)))
    rho = torch.tensor([1e-3, 2.5e-3], dtype=F64)
    return dict(xu=xu, ee=ee, xs=xs, lam=lam, rho=rho,
                model=iiwa14(F64, device="cpu"), cost=CostConfig.for_knots(N),
                ch=Chain(Arith("f64"), "cpu"), st=check.settings(_cfg()))


def _close(a, b, tol=1e-11):
    assert float((a - b).abs().max()) <= tol * max(1.0, float(b.abs().max()))


def test_kkt_schur_matches_the_port(problem):
    p = problem
    sys_ref = R.kkt_schur(p["ch"], p["st"], p["xu"], p["xs"], p["ee"], p["rho"])
    for b in range(2):
        port = build_kkt_schur_plain(p["model"], p["cost"], p["xu"][b], p["xs"][b],
                                     p["ee"][b], p["rho"][b], DT)
        for key in ("S", "Pinv", "gamma", "Qinv", "q"):
            _close(sys_ref[key][b], port[key])
        _close(sys_ref["A"][b], port["A"][:-1])
        _close(sys_ref["B"][b], port["B"][:-1])


def test_pcg_and_step_match_the_port(problem):
    p = problem
    s = R.kkt_schur(p["ch"], p["st"], p["xu"], p["xs"], p["ee"], p["rho"])
    lam, iters, met = R.pcg(p["ch"].ar, s["S"], s["Pinv"], s["gamma"], p["lam"],
                            CAP, 1e-5)
    dz = R.step_dz(p["ch"].ar, s, lam, 14)
    for b in range(2):
        port = pcg_solve(s["S"][b], s["Pinv"][b], s["gamma"][b], p["lam"][b],
                         CAP, 1e-5)
        _close(lam[b], port.lam, 1e-9)
        assert int(iters[b]) == int(port.iters)
        assert bool(met[b]) == bool(port.converged)
        sys_b = {k: torch.cat([s[k][b], torch.zeros_like(s[k][b][:1])])
                 if k in ("A", "B") else s[k][b] for k in ("Qinv", "A", "B", "q")}
        _close(dz[b], compute_dz_plain(sys_b, lam[b], p["xu"][b, :, 14:],
                                       p["rho"][b], p["cost"].r_cost), 1e-9)


def test_merit_matches_the_port(problem):
    p = problem
    dz = 0.01 * torch.randn(2, N, 21, dtype=F64, generator=torch.Generator().manual_seed(3))
    al = R.alphas(p["st"], F64, "cpu")
    cand = p["xu"][:, None] + al[:, None, None] * dz[:, None]
    got = R.merit(p["ch"], p["st"], cand, p["xs"][:, None], p["ee"][:, None])
    for b in range(2):
        want, alphas = line_search_merits(p["model"], p["cost"], p["xu"][b], dz[b],
                                          p["xs"][b], p["ee"][b], MU, DT,
                                          include_zero=True)
        _close(al, alphas)
        _close(got[b], want, 1e-12)


def test_sqp_solve_matches_the_port(problem):
    p = problem
    got = R.sqp_solve(p["ch"], p["st"], p["xu"], p["lam"], p["xs"], p["ee"], p["rho"])
    for b in range(2):
        want = sqp_solve(p["model"], p["cost"], SQPConfig(max_iter=2, max_time_us=None),
                         PCGConfig(max_iter=CAP, exit_tol=1e-5), p["xu"][b],
                         p["lam"][b], p["xs"][b], p["ee"][b], p["rho"][b], DT,
                         linsys="pcg_cuda")
        _close(got.xu[b], want.xu, 1e-9)
        _close(got.lam[b], want.lam, 1e-8)
        _close(got.rho[b], want.rho)
        _close(got.merit[b], want.merit, 1e-10)
        assert got.alpha_idx[b].tolist() == want.ls_alpha_idx.tolist()


@pytest.mark.parametrize("t_off", [0.0, 0.002])
def test_plant_matches_the_port(problem, t_off):
    p = problem
    got = R.plant(p["ch"], p["st"], p["xs"], p["xu"], t_off, 0.002, 10, 2e-4)
    for b in range(2):
        want = simulate_plant_plain(p["model"], p["xs"][b], p["xu"][b], t_off, 0.002,
                                    DT, 10, 2e-4)
        _close(got[b], want, 1e-12)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 3 * 2 ** -12, -1.0 - 2 ** -12,
                      1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 3.0e-30])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, -1.0, 1.0, 1.0 + 2 ** -9, 3.0e-30])
    got = round_tf32(x)
    assert torch.allclose(got[:5], want[:5], rtol=0, atol=0)
    assert abs(float(got[5]) / 3.0e-30 - 1) < 2 ** -10


@pytest.mark.parametrize("mode", ["tf32", "bf16"])
def test_lower_arithmetic_rounds_products_only(mode):
    ar = Arith(mode)
    a = torch.randn(8, 5, 5, generator=torch.Generator().manual_seed(1))
    exact = a @ a
    got = ar.mm(a, a)
    err = float(((got - exact).abs().max() / exact.abs().max()))
    assert (1e-6 < err < 3e-3) if mode == "tf32" else (1e-4 < err < 3e-2)
    assert Arith("f32").mm(a, a).equal(exact)


def test_reference_imports_nothing_of_the_program():
    for f in sorted((HERE / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                top = n.split(".")[0]
                assert top in ("__future__", "typing", "numpy", "torch", "portbench"), (f, n)
                assert not n.startswith("portbench.") or n.startswith("portbench.reference"), (f, n)
