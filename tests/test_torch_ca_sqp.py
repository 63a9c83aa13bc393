"""The fused knot-sharded SQP at its default PCG method against the JAX
package on the CPU.

``sqp_solve_sharded(fused=True)`` resolves ``pcg_method="auto"`` to the
s-step ``"ca_slab"`` when a slab holds its 2s+1 halo (here 2 shards of
N = 32, L = 16), as the JAX package does; the s-step loop then reads K9a's
blocks in place.  Held to the JAX single-device ``sqp_solve(linsys="pcg")``
at f64, and in f32 at the bounds of tests/test_parallel.py's passing
test_sharded_full_sqp_ca_matches_single_device (xu within 1e-3, the first
PCG count within 4, equal line-search choices)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mpcgpu_tpu.config import CostConfig as JCostConfig
from mpcgpu_tpu.config import PCGConfig as JPCGConfig
from mpcgpu_tpu.config import SQPConfig as JSQPConfig
from mpcgpu_tpu.models import iiwa14 as jax_iiwa14
from mpcgpu_tpu.solver.sqp import sqp_solve as jax_sqp_solve
from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SQPConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.parallel import KnotMesh, sqp_solve_sharded
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

torch.set_num_threads(1)

N = 32
START = 350
DT = 1.0 / 64.0


def _sqp_inputs(rows):
    """xu, xs, ee (numpy): trace 0_0 from row 350 with numpy noise
    ("calm"), or the inputs of tests/test_parallel.py::
    test_sharded_full_sqp_ca_matches_single_device (rows 0-31 and its
    jax.random noise, "jax_test")."""
    if rows == "calm":
        rng = np.random.default_rng(0)
        xu = load_xu_traj("0_0")[START:START + N] + 0.01 * rng.standard_normal((N, 21))
        return xu, xu[0, :14], load_eepos_traj("0_0")[START:START + N]
    xu = jnp.asarray(load_xu_traj("0_0")[:N], jnp.float32)
    xu = np.asarray(xu + 0.01 * jax.random.normal(jax.random.PRNGKey(0), xu.shape,
                                                  jnp.float32))
    return xu, xu[0, :14], load_eepos_traj("0_0")[:N]


def _jax_sqp(rows, dtype):
    """The JAX single-device sqp_solve(linsys="pcg") (jitted), 2 SQP
    iterations, PCG cap 60 at 1e-7, in ``dtype``."""
    xu, xs, ee = (np.asarray(a, dtype) for a in _sqp_inputs(rows))
    jd = jnp.float32 if dtype == np.float32 else jnp.float64
    return jax.jit(lambda a, lam, b, e: jax_sqp_solve(
        jax_iiwa14(dtype=jd), JCostConfig.for_knots(N), JSQPConfig(max_iter=2),
        JPCGConfig(max_iter=60, exit_tol=1e-7), a, lam, b, e, 1e-3, DT,
        linsys="pcg"))(xu, np.zeros((N, 14), dtype), xs, ee)


def _port_sqp(rows, dtype, mesh=None, **route):
    """The port's fused sqp_solve_sharded on 2 shards (L = 16 >= 2s+1) with
    the same configuration."""
    xu, xs, ee = (np.asarray(a, dtype) for a in _sqp_inputs(rows))
    td = torch.float32 if dtype == np.float32 else torch.float64
    return sqp_solve_sharded(iiwa14(td, device="cpu"), CostConfig.for_knots(N),
                             SQPConfig(max_iter=2), PCGConfig(max_iter=60, exit_tol=1e-7),
                             torch.tensor(xu), torch.zeros((N, 14), dtype=td),
                             torch.tensor(xs), torch.tensor(ee), 1e-3, DT,
                             mesh or KnotMesh(2), fused=True, **route)


def test_fused_sqp_default_matches_jax_f64():
    """The fused sqp_solve_sharded at its default pcg_method ("auto" ->
    "ca_slab": K9a's blocks read in place by the s-step loop) at f64 on the
    calm rows against the JAX single-device solve: the same PCG counts and
    line-search choices, xu within 1e-8 (measured 6.8e-11)."""
    mesh = KnotMesh(2)
    ref, got = _jax_sqp("calm", np.float64), _port_sqp("calm", np.float64, mesh)
    assert mesh.n_psum >= 2 * 15      # ceil(60 / 4) outer steps per SQP iteration
    np.testing.assert_array_equal(got.pcg_iters.numpy(), np.asarray(ref.pcg_iters))
    np.testing.assert_array_equal(got.ls_alpha_idx.numpy(), np.asarray(ref.ls_alpha_idx))
    assert bool((got.ls_alpha_idx >= 0).all())
    np.testing.assert_allclose(got.xu.numpy(), np.asarray(ref.xu), rtol=0, atol=1e-8)


def test_fused_sqp_default_f32_on_the_jax_tests_inputs():
    """In f32 on the inputs of the JAX package's passing test, at its bounds:
    xu within 1e-3, the first PCG count within 4, equal line-search choices.
    On these rows (16-26 of trace 0_0 run away) neither solve takes a step
    (ls_alpha_idx [-1, -1]); test_fused_sqp_default_f32_calm_rows holds
    the same bounds where steps are taken."""
    ref, got = _jax_sqp("jax_test", np.float32), _port_sqp("jax_test", np.float32)
    np.testing.assert_allclose(got.xu.numpy(), np.asarray(ref.xu), rtol=0, atol=1e-3)
    assert abs(int(got.pcg_iters[0]) - int(np.asarray(ref.pcg_iters)[0])) <= 4
    np.testing.assert_array_equal(got.ls_alpha_idx.numpy(), np.asarray(ref.ls_alpha_idx))


def test_fused_sqp_default_f32_calm_rows():
    """In f32 on the calm rows, at the same bounds against the JAX
    single-device solve, and against the port's plain "ca" loop on the same
    fused blocks (the same algebra in another order: equal counts and
    choices, xu within 1e-4).  Both do the s-step algebra in f64; the JAX
    package's f32 "ca" takes other line-search choices here ([1, 6] against
    [0, 4]; xu 0.78 apart, ROADMAP.md queue 3)."""
    ref, got = _jax_sqp("calm", np.float32), _port_sqp("calm", np.float32)
    assert bool((got.ls_alpha_idx >= 0).all())
    np.testing.assert_allclose(got.xu.numpy(), np.asarray(ref.xu), rtol=0, atol=1e-3)
    assert abs(int(got.pcg_iters[0]) - int(np.asarray(ref.pcg_iters)[0])) <= 4
    np.testing.assert_array_equal(got.ls_alpha_idx.numpy(), np.asarray(ref.ls_alpha_idx))
    ca = _port_sqp("calm", np.float32, pcg_method="ca")
    assert got.pcg_iters.tolist() == ca.pcg_iters.tolist()
    assert got.ls_alpha_idx.tolist() == ca.ls_alpha_idx.tolist()
    np.testing.assert_allclose(got.xu.numpy(), ca.xu.numpy(), rtol=0, atol=1e-4)
