"""The port's direct solvers against the JAX package on the CPU: the CSC
packing, the host LDL^T binding (the same C++ compiled with the same flags,
so equal bit for bit), and the block LDL^T and PCR solves at f64 (K7's
wrapper runs its plain version ``pcr_solve_refined`` for CPU tensors).
The SQP routes, the closed loop and the tracker that use them are in
test_torch_direct_sqp.py."""

import numpy as np
import pytest
import torch

from mpcgpu_tpu import native as jnative
from mpcgpu_tpu.ops import csr as jcsr
from mpcgpu_tpu.ops import ldl as jldl
from mpcgpu_tpu.ops import pcr as jpcr
from mpcgpu_tpu_torch import native
from mpcgpu_tpu_torch.config import CostConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.ops import csr
from mpcgpu_tpu_torch.ops.btd import btd_matvec, btd_to_dense
from mpcgpu_tpu_torch.ops.ldl import btd_ldl_solve
from mpcgpu_tpu_torch.ops.pcr import pcr_solve_refined
from mpcgpu_tpu_torch.ops.pcr_cuda import pcr_solve_cuda
from mpcgpu_tpu_torch.ops.schur import form_schur_system
from mpcgpu_tpu_torch.solver.kkt import build_kkt
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

torch.set_num_threads(1)

DT = 1.0 / 64.0
RHO = 1e-3


def _schur_np(N: int):
    """The real Schur system (S, gamma) at f64: trace 0_0 (repeated past its
    666 rows) plus numpy noise, through the port's build_kkt and
    form_schur_system (held against the JAX functions in
    test_torch_schur_pcg.py); both packages then solve the same system."""
    reps = (N + 665) // 666
    xu = np.concatenate([load_xu_traj("0_0")] * reps)[:N]
    ee = np.concatenate([load_eepos_traj("0_0")] * reps)[:N]
    xu = torch.tensor(xu + 0.01 * np.random.default_rng(0).standard_normal(xu.shape))
    kkt = build_kkt(iiwa14(torch.float64, device="cpu"), CostConfig.for_knots(N),
                    xu, xu[0, :14], torch.tensor(ee), DT)
    sch = form_schur_system(kkt, RHO)
    return sch.S.numpy(), sch.gamma.numpy()


def _spd_np(N: int, n: int = 14):
    """A well-conditioned SPD block-tridiagonal system (diagonal blocks
    R R^T / n + 3.5 I, off-diagonal 0.3 N(0, 1)) and a N(0, 1) rhs."""
    rng = np.random.default_rng(N)
    R = rng.standard_normal((N, n, n))
    low = 0.3 * rng.standard_normal((N - 1, n, n))
    S = np.zeros((N, 3, n, n))
    S[:, 1] = R @ R.transpose(0, 2, 1) / n + 3.5 * np.eye(n)
    S[1:, 0], S[:-1, 2] = low, low.transpose(0, 2, 1)
    return S, rng.standard_normal((N, n))


@pytest.mark.parametrize("n,N", [(3, 1), (3, 4), (14, 5)])
def test_csr_matches_jax(n, N):
    """Patterns and values of both CSC packings equal the JAX package's."""
    S = np.random.default_rng(n * N).standard_normal((N, 3, n, n))
    for name in ("btd_lower_csc_pattern", "btd_upper_csc_pattern"):
        for got, ref in zip(getattr(csr, name)(n, N), getattr(jcsr, name)(n, N)):
            np.testing.assert_array_equal(got, ref)
            assert got.dtype == ref.dtype
    for name in ("btd_lower_csc_values", "btd_upper_csc_values"):
        np.testing.assert_array_equal(getattr(csr, name)(S), getattr(jcsr, name)(S))
    assert csr.btd_nnz_lower(n, N) == jcsr.btd_nnz_lower(n, N) \
        == len(csr.btd_lower_csc_pattern(n, N)[1])


@pytest.mark.parametrize("fn", ["qdldl_solve_schur", "qdldl_solve_schur_cached",
                                "btd_ldl_solve_cpu"])
def test_native_matches_jax_bitwise(fn):
    """The port's host binding and the JAX package's compile the same C++
    with the same flags: on one f64 N=16 Schur system the solutions are
    equal bit for bit (and solve the system)."""
    S, g = _schur_np(16)
    got = getattr(native, fn)(S, g)
    assert np.array_equal(got, getattr(jnative, fn)(S, g))
    res = btd_matvec(torch.tensor(S), torch.tensor(got)).numpy() - g
    assert np.abs(res).max() < 1e-6 * np.abs(g).max()
    # the cached symbolic factorization gives the same numbers on reuse
    assert np.array_equal(getattr(native, fn)(S, g), got)


# tolerance (max|d| / max|x|) of the port against JAX at f64: on the real
# Schur system two f64 orders differ by up to eps * cond(S), and at N = 100 the JAX package's own PCR and LDL^T already differ by
# 7.5e-11 (measured), so there the bound is 1e-9; elsewhere 1e-10
_F64_TOL = {("schur", 100): 1e-9}


@pytest.mark.parametrize("system", ["schur", "spd"])
@pytest.mark.parametrize("N", [2, 3, 16, 100])
def test_direct_solvers_match_jax_f64(N, system):
    """btd_ldl_solve and pcr_solve_refined (K7's plain version) against the
    JAX functions at f64, at non-power-of-two N too; K7's wrapper on CPU
    tensors is its plain version."""
    S, b = _schur_np(N) if system == "schur" else _spd_np(N)
    tol = _F64_TOL.get((system, N), 1e-10)
    St, bt = torch.tensor(S), torch.tensor(b)
    for got, ref in ((btd_ldl_solve(St, bt), jldl.btd_ldl_solve(S, b)),
                     (pcr_solve_refined(St, bt), jpcr.pcr_solve_refined(S, b))):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= tol * np.abs(ref).max()
    assert torch.equal(pcr_solve_cuda(St, bt), pcr_solve_refined(St, bt))


def test_pcr_f32_on_a_well_conditioned_system():
    """The plain version in f32 at N=64 on the well-conditioned system: within
    1e-5 max|x| of the f64 solve, and the refinement pass lowers the true
    residual.  (The real Schur system in f32 is in test_torch_pcr_f32.py.)"""
    S, b = _spd_np(64)
    dense = btd_to_dense(torch.tensor(S)).numpy()
    x64 = torch.tensor(np.linalg.solve(dense, b.reshape(-1)).reshape(b.shape))
    S32, b32 = torch.tensor(S, dtype=torch.float32), torch.tensor(b, dtype=torch.float32)
    res = lambda x: float((btd_matvec(S32.double(), x.double()) - b32.double()).abs().max())
    x0 = pcr_solve_refined(S32, b32, refine=0)
    x1 = pcr_solve_refined(S32, b32, refine=1)
    assert float((x1.double() - x64).abs().max()) <= 1e-5 * float(x64.abs().max())
    assert res(x1) < res(x0)
