"""The kernel wrappers K1/K2/K3 on CPU tensors (their plain versions) against
the JAX reference's XLA functions, and the guards in front of the kernels.

On the CPU every wrapper runs its plain version; on CUDA tensors it launches
its kernel or raises.  The kernels themselves are held against these plain
versions on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.config import CostConfig as JCostConfig
from mpcgpu_tpu.models import iiwa14 as jax_iiwa14
from mpcgpu_tpu.ops import pcg as jpcg
from mpcgpu_tpu.ops import schur as jschur
from mpcgpu_tpu.solver import kkt as jkkt
from mpcgpu_tpu.solver import merit as jmerit
from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.config import CostConfig
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.ops.pcg_cuda import pcg_dz_solve
from mpcgpu_tpu_torch.solver.kkt_cuda import build_kkt_schur
from mpcgpu_tpu_torch.solver.merit_cuda import line_search_merits_fused

torch.set_num_threads(1)

N = 16
DT = 1.0 / 64.0
RHO = 1e-3
MU = 10.0
DTYPES = {"f64": (torch.float64, jnp.float64, 1e-9),
          "f32": (torch.float32, jnp.float32, 5e-5)}


def _close(got, ref, rtol, what=""):
    ref = np.asarray(ref, dtype=np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got.double().numpy(), ref, rtol=0,
                               atol=rtol * scale, err_msg=what)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    xu = load_xu_traj("0_0")[:N] + 0.01 * rng.standard_normal((N, 21))
    return xu, xu[0, :14].copy(), load_eepos_traj("0_0")[:N]


_REF = {}


def _jax_reference(problem, prec, integrator_type):
    """JAX build_kkt + form_schur_system (stair), jitted once per case."""
    key = (prec, integrator_type)
    if key not in _REF:
        xu, xs, ee = problem
        _, jdt, _ = DTYPES[prec]
        jm = jax_iiwa14(dtype=jdt)
        cost = JCostConfig.for_knots(N)

        @jax.jit
        def ref(a, b, g):
            kkt = jkkt.build_kkt(jm, cost, a, b, g, DT, integrator_type)
            return kkt, jschur.form_schur_system(kkt, RHO, "stair")

        _REF[key] = ref(*(jnp.asarray(v, jdt) for v in (xu, xs, ee)))
    return _REF[key]


def _port_inputs(problem, prec):
    tdt = DTYPES[prec][0]
    xu, xs, ee = problem
    return iiwa14(tdt, device="cpu"), tuple(torch.tensor(v, dtype=tdt) for v in (xu, xs, ee))


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("integrator_type", [0, 1])
def test_k1_build_kkt_schur_matches_jax(problem, prec, integrator_type):
    kkt, sch = _jax_reference(problem, prec, integrator_type)
    model, (xu, xs, ee) = _port_inputs(problem, prec)
    out = build_kkt_schur(model, CostConfig.for_knots(N), xu, xs, ee, RHO, DT,
                          integrator_type)
    rtol = DTYPES[prec][2]
    for name, ref in (("S", sch.S), ("Pinv", sch.Pinv), ("gamma", sch.gamma),
                      ("Qinv", sch.Qinv), ("q", kkt.q)):
        _close(out[name], ref, rtol, name)
    # A and B are the dynamics Jacobians at knots 0..N-2 and zero at N-1
    _close(out["A"][:-1], kkt.A, rtol, "A")
    _close(out["B"][:-1], kkt.B, rtol, "B")
    assert not out["A"][-1].any() and not out["B"][-1].any()


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_k2_pcg_dz_solve_matches_jax(problem, prec):
    """pcg_solve + compute_dz on the same Schur system (the JAX one, handed
    to the port).  f64: run to the exit, identical iterations.  f32: a fixed
    count of 3 steps (exit_tol = 0), so f32 rounding in the ill-conditioned
    CG cannot change the step count."""
    kkt, sch = _jax_reference(problem, prec, 0)
    tdt, jdt, rtol = DTYPES[prec]
    t = lambda a: torch.tensor(np.asarray(a), dtype=tdt)
    pad = lambda a: torch.cat([t(a), torch.zeros_like(t(a)[:1])])
    sys_ = dict(S=t(sch.S), Pinv=t(sch.Pinv), gamma=t(sch.gamma),
                Qinv=t(sch.Qinv), A=pad(kkt.A), B=pad(kkt.B), q=t(kkt.q))
    xu = torch.tensor(problem[0], dtype=tdt)
    lam0 = 0.01 * np.random.default_rng(1).standard_normal((N, 14))
    max_iter, tol = (167, 1e-5) if prec == "f64" else (3, 0.0)
    ref = jpcg.pcg_solve(sch.S, sch.Pinv, sch.gamma, jnp.asarray(lam0, jdt),
                         max_iter=max_iter, exit_tol=tol)
    dz_ref = jschur.compute_dz(kkt, sch, ref.lam)
    lam, dz, iters, conv = pcg_dz_solve(
        sys_, t(lam0), xu[:, 14:], RHO, CostConfig.for_knots(N).r_cost,
        max_iter=max_iter, exit_tol=tol)
    assert int(iters) == int(ref.iters) and bool(conv) == bool(ref.converged)
    _close(lam, ref.lam, rtol, "lam")
    _close(dz, dz_ref, rtol, "dz")


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("integrator_type", [0, 1])
def test_k3_line_search_merits_matches_jax(problem, prec, integrator_type):
    tdt, jdt, rtol = DTYPES[prec]
    xu, xs, ee = problem
    dz = 0.1 * np.random.default_rng(2).standard_normal((N, 21))
    jm = jax_iiwa14(dtype=jdt)
    cost = JCostConfig.for_knots(N)
    ref, alphas_ref = jax.jit(lambda *a: jmerit.line_search_merits(
        jm, cost, *a, MU, DT, integrator_type=integrator_type,
        include_zero=True))(*(jnp.asarray(v, jdt) for v in (xu, dz, xs, ee)))
    merits, alphas = line_search_merits_fused(
        iiwa14(tdt, device="cpu"), CostConfig.for_knots(N),
        *(torch.tensor(v, dtype=tdt) for v in (xu, dz, xs, ee)), MU, DT,
        integrator_type=integrator_type)
    assert merits.shape == alphas.shape == (9,)
    _close(merits, ref, rtol, "merits")
    _close(alphas, alphas_ref, 0, "alphas")


@pytest.mark.parametrize("include_zero,angle_wrap",
                         [(False, False), (True, True), (False, True)])
def test_k3_flags_match_jax(include_zero, angle_wrap):
    """K3's ``include_zero=`` and ``angle_wrap=`` at f64, on joint angles
    3.05 + 0.3 N(0, 1) (``tests/test_angle_wrap.py``'s states, where the
    wrap fires): the JAX ``line_search_merits`` with the same flags, the
    alphas bit for bit, the merits to rtol 1e-12.  Without the zero
    candidate the result is the default call's shifted by one index; the
    wrap changes the merits."""
    rng = np.random.default_rng(3)
    q = 3.05 + 0.3 * rng.standard_normal((N, 7))
    xu = np.concatenate([q, 0.5 * rng.standard_normal((N, 14))], axis=1)
    xs, ee = xu[0, :14].copy(), rng.standard_normal((N, 6))
    dz = 0.1 * rng.standard_normal((N, 21))
    jm = jax_iiwa14(dtype=jnp.float64)
    ref, alphas_ref = jax.jit(lambda *a: jmerit.line_search_merits(
        jm, JCostConfig.for_knots(N), *a, MU, DT, include_zero=include_zero,
        angle_wrap=angle_wrap))(*(jnp.asarray(v) for v in (xu, dz, xs, ee)))
    call = lambda **flags: line_search_merits_fused(
        iiwa14(torch.float64, device="cpu"), CostConfig.for_knots(N),
        *(torch.tensor(v) for v in (xu, dz, xs, ee)), MU, DT, **flags)
    merits, alphas = call(include_zero=include_zero, angle_wrap=angle_wrap)
    assert merits.shape == alphas.shape == (8 + include_zero,)
    np.testing.assert_array_equal(alphas.numpy(), np.asarray(alphas_ref))
    np.testing.assert_allclose(merits.numpy(), np.asarray(ref), rtol=1e-12)
    full, full_alphas = call(angle_wrap=angle_wrap)
    drop = 1 - int(include_zero)
    assert torch.equal(alphas, full_alphas[drop:])
    torch.testing.assert_close(merits, full[drop:], rtol=1e-14, atol=0)
    if angle_wrap:
        unwrapped = call(include_zero=include_zero)[0]
        assert not torch.allclose(merits, unwrapped, rtol=1e-6, atol=0)


def test_wrappers_reject_what_the_kernels_do_not_take(problem):
    model, (xu, xs, ee) = _port_inputs(problem, "f64")
    with pytest.raises(ValueError, match="ee cost mode"):
        build_kkt_schur(model, CostConfig(mode="joint"), xu, xs, ee, RHO, DT)
    with pytest.raises(ValueError, match="ee cost mode"):
        line_search_merits_fused(model, CostConfig(mode="joint"), xu, xu, xs,
                                 ee, MU, DT)
    with pytest.raises(ValueError, match="integrator_type"):
        build_kkt_schur(model, CostConfig(), xu, xs, ee, RHO, DT, 2)
    with pytest.raises(ValueError, match="exit_criterion"):
        pcg_dz_solve({}, xu[:, :14], xu[:, 14:], RHO, 1e-3, exit_criterion="x")
    # a device that is neither the CPU nor CUDA is refused, not computed on
    meta = torch.empty((N, 21), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        build_kkt_schur(model, CostConfig(), meta, xs, ee, RHO, DT)


def test_kernel_argument_checks():
    """The checks that run before a launch, on the tensors a launch gets."""
    dev = torch.device("cpu")
    good = torch.zeros((4, 14), dtype=torch.float32)
    _kernels.require(good, "x", (4, 14), dev)
    with pytest.raises(TypeError, match="float32"):
        _kernels.require(good.double(), "x", (4, 14), dev)
    with pytest.raises(ValueError, match="shape"):
        _kernels.require(good, "x", (4, 7), dev)
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.require(good.t(), "x", (14, 4), dev)
    with pytest.raises(ValueError, match="on meta"):
        _kernels.require(good.to("meta"), "x", (4, 14), dev)
    wide = torch.zeros((4, 21), dtype=torch.float32)
    _kernels.require(wide[:, 14:], "u", (4, 7), dev, row_major=True)
    with pytest.raises(ValueError, match="unit stride"):
        _kernels.require(wide.t()[:7], "u", (7, 4), dev, row_major=True)
    for n in (1, _kernels.MAX_KNOTS + 1):
        with pytest.raises(ValueError, match="knots"):
            _kernels.require_knots(n)
    _kernels.require_knots(2)
    _kernels.require_knots(_kernels.MAX_KNOTS)
    assert _kernels.check(0, "x") is None
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        _kernels.check(700, "x")


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc, no kernels: the loader raises and nothing falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.libraries()
    assert len(_kernels.source_hash()) == 16
