"""The warm-started MPC chain (mpcgpu_tpu_torch.sim.mpc) against the same
chain written with the JAX package (the body of bench.py's chain)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mpcgpu_tpu.config import CostConfig as JCostConfig
from mpcgpu_tpu.config import PCGConfig as JPCGConfig
from mpcgpu_tpu.config import SQPConfig as JSQPConfig
from mpcgpu_tpu.models import iiwa14 as jax_iiwa14
from mpcgpu_tpu.sim.mpc import _shift_all as jax_shift_all
from mpcgpu_tpu.solver.sqp import sqp_solve as jax_sqp_solve
from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SQPConfig
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.sim.mpc import _shift_all, run_chain
from mpcgpu_tpu_torch.solver.sqp import sqp_solve

torch.set_num_threads(1)

N = 16
DT = 1.0 / 64.0
RHO = 1e-3
STEPS = 3


def _inputs():
    rng = np.random.default_rng(0)
    xu = load_xu_traj("0_0")[:N] + 0.01 * rng.standard_normal((N, 21))
    return xu, load_eepos_traj("0_0")


def _jax_chain(xu, ee_full, steps):
    """bench.py's chain body at f64: solve, roll xu/lam one knot (tail
    duplicated), xs = xu[1, :14], slide the goal window along the trace."""
    jm = jax_iiwa14(dtype=jnp.float64)
    cost = JCostConfig.for_knots(N)
    sqp_cfg, pcg_cfg = JSQPConfig(max_iter=1), JPCGConfig(max_iter=167, exit_tol=1e-5)
    ee_full = jnp.asarray(ee_full)

    @jax.jit
    def chain(xu0, lam0, xs0, ee0, rho0):
        def body(i, carry):
            xu_, lam_, xs_, ee_, rho_, iters, alpha_idx, step_xu = carry
            res = jax_sqp_solve(jm, cost, sqp_cfg, pcg_cfg, xu_, lam_, xs_, ee_,
                                rho_, DT, linsys="pcg")
            xu_n = jnp.roll(res.xu, -1, axis=0).at[-1].set(res.xu[-1])
            lam_n = jnp.roll(res.lam, -1, axis=0).at[-1].set(res.lam[-1])
            ee_n = jnp.roll(ee_, -1, axis=0).at[-1].set(
                ee_full[(i + N) % ee_full.shape[0]])
            return (xu_n, lam_n, res.xu[1, :14], ee_n, res.rho,
                    iters.at[i].set(res.pcg_iters[0]),
                    alpha_idx.at[i].set(res.ls_alpha_idx[0]),
                    step_xu.at[i].set(res.xu))

        init = (xu0, lam0, xs0, ee0, rho0, jnp.zeros(steps, jnp.int32),
                jnp.zeros(steps, jnp.int32), jnp.zeros((steps,) + xu0.shape))
        return jax.lax.fori_loop(0, steps, body, init)

    xu = jnp.asarray(xu)
    return chain(xu, jnp.zeros((N, 14)), xu[0, :14], ee_full[:N],
                 jnp.asarray(RHO, jnp.float64))


def test_chain_matches_jax_f64():
    """Three warm-started steps.  The PCG iteration counts and line-search
    choices must be identical at every step.  The iterates are held at
    steps 1 and 2 only: each step amplifies the previous step's rounding
    difference by ~1e5 (measured: 1.4e-12, 2.5e-7, 2e-2 at steps 1-3; the
    eta exit at 1e-5 leaves lam far from the converged solution, so the
    next solve starts from a rounding-sensitive warm start)."""
    xu, ee_full = _inputs()
    ref = _jax_chain(xu, ee_full, STEPS)
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    got = run_chain(iiwa14(torch.float64, device="cpu"), CostConfig.for_knots(N),
                    SQPConfig(max_iter=1), PCGConfig(max_iter=167, exit_tol=1e-5),
                    t(xu), torch.zeros((N, 14), dtype=torch.float64),
                    t(xu[0, :14]), t(ee_full), RHO, DT, STEPS, linsys="pcg_cuda")
    np.testing.assert_array_equal(got.pcg_iters.numpy(), np.asarray(ref[5]))
    np.testing.assert_array_equal(got.ls_alpha_idx.numpy(), np.asarray(ref[6]))
    ref_steps = np.asarray(ref[7])
    for step, atol in ((0, 1e-8), (1, 1e-5)):
        np.testing.assert_allclose(got.step_xu[step].numpy(), ref_steps[step],
                                   rtol=0, atol=atol, err_msg=f"step {step + 1}")
    np.testing.assert_array_equal(got.ee_goal.numpy(), np.asarray(ref[3]))
    np.testing.assert_allclose(float(got.rho), float(ref[4]), rtol=1e-12)
    assert got.step_xu.shape == (STEPS, N, 21)
    # the carried plan is the last solved plan shifted one knot
    assert torch.equal(got.xu[:-1], got.step_xu[-1][1:])
    assert torch.equal(got.xu[-1], got.step_xu[-1][-1])
    assert torch.equal(got.xs, got.step_xu[-1][1, :14])


def test_one_step_f32_is_finite_and_near_jax():
    """f32 through the fused path: one SQP step is finite and its merit is
    within 1e-3 of the JAX f32 solve.  Run with rho = 0.1: at the chain's
    rho = 1e-3 the capped f32 PCG is rounding-dominated and the JAX f32 and
    f64 solves themselves differ by ~1% in merit (they pick different
    line-search steps); at rho = 0.1 both f32 solves take the same step."""
    xu, ee_full = _inputs()
    rho = 0.1
    jm = jax_iiwa14(dtype=jnp.float32)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    ref = jax.jit(lambda a, g: jax_sqp_solve(
        jm, JCostConfig.for_knots(N), JSQPConfig(max_iter=1),
        JPCGConfig(max_iter=167, exit_tol=1e-5), a, jnp.zeros((N, 14), jnp.float32),
        a[0, :14], g, rho, DT, linsys="pcg"))(f32(xu), f32(ee_full[:N]))
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    got = sqp_solve(iiwa14(torch.float32, device="cpu"), CostConfig.for_knots(N),
                    SQPConfig(max_iter=1), PCGConfig(max_iter=167, exit_tol=1e-5),
                    t(xu), torch.zeros((N, 14)), t(xu[0, :14]), t(ee_full[:N]),
                    rho, DT, linsys="pcg_cuda")
    assert got.xu.dtype == torch.float32
    assert all(bool(torch.isfinite(v).all()) for v in (got.xu, got.lam, got.merit))
    assert int(got.ls_alpha_idx[0]) >= 0
    np.testing.assert_allclose(float(got.merit), float(ref.merit), rtol=1e-3)


def test_shift_all_matches_jax():
    rng = np.random.default_rng(7)
    xu, lam, ee = (rng.standard_normal((N, w)) for w in (21, 14, 6))
    bx, bg = rng.standard_normal(21), rng.standard_normal(6)
    got = _shift_all(*(torch.tensor(a) for a in (xu, lam, ee, bx, bg)))
    ref = jax_shift_all(*(jnp.asarray(a) for a in (xu, lam, ee, bx, bg)))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
