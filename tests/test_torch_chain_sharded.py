"""The knot-sharded SQP of a planar arm of 3 links (the chain tracker's)
against the JAX package on the CPU, at f64: N = 32 over 2 shards, fused (K9a
-> K10b and the coefficient step, or K10a -> K9b -> K9c, their plain
versions on CPU tensors), against the JAX single-device
``sqp_solve(linsys="pcg")`` within tests/test_torch_sqp_sharded.py's bounds:
the same PCG iterations, line-search choices and SQP iterations, xu and lam
within 1e-8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.config import CostConfig as JCostConfig
from mpcgpu_tpu.config import PCGConfig as JPCGConfig
from mpcgpu_tpu.config import SQPConfig as JSQPConfig
from mpcgpu_tpu.models import chain as jchain
from mpcgpu_tpu.solver.sqp import sqp_solve as jax_sqp_solve
from mpcgpu_tpu_torch import track_chain
from mpcgpu_tpu_torch.config import PCGConfig, SQPConfig
from mpcgpu_tpu_torch.parallel import make_mesh, sqp_solve_sharded

torch.set_num_threads(1)

NQ, N, SHARDS, DT = 3, 32, 2, track_chain.DT
SQP = dict(max_iter=3)
PCG = dict(max_iter=80, exit_tol=1e-7)


@pytest.fixture(scope="module")
def problem():
    model = track_chain.build_model(NQ, device="cpu", dtype=torch.float64)[0]
    xu, ee = track_chain.reference_trace(model, 2 * N)
    xu = xu[N:] + 0.01 * np.random.default_rng(0).standard_normal((N, 3 * NQ))
    jm = jchain.planar_arm(NQ, link_len=0.4, link_mass=0.8, dtype=jnp.float64)
    jc = JCostConfig(qd_cost=track_chain.COST.qd_cost, r_cost=track_chain.COST.r_cost)
    ref = jax.jit(lambda a, lam, b, g: jax_sqp_solve(
        jm, jc, JSQPConfig(**SQP), JPCGConfig(**PCG), a, lam, b, g, 1e-3, DT,
        linsys="pcg"))(jnp.asarray(xu), jnp.zeros((N, 2 * NQ)),
                       jnp.asarray(xu[0, :2 * NQ]), jnp.asarray(ee[N:]))
    args = (model, track_chain.COST, SQPConfig(**SQP), PCGConfig(**PCG),
            torch.tensor(xu), torch.zeros((N, 2 * NQ), dtype=torch.float64),
            torch.tensor(xu[0, :2 * NQ]), torch.tensor(ee[N:]), 1e-3, DT)
    return args, ref


@pytest.mark.parametrize("method", ["ca_slab", "pipelined_slab"])
def test_chain_sharded_sqp_matches_jax_f64(problem, method):
    args, ref = problem
    mesh = make_mesh(n_instance=1, n_knot=SHARDS)
    got = sqp_solve_sharded(*args, mesh, fused=True, pcg_method=method)
    assert 0 < int(np.asarray(ref.pcg_iters).min()) < PCG["max_iter"]
    np.testing.assert_array_equal(got.pcg_iters.numpy(), np.asarray(ref.pcg_iters))
    np.testing.assert_array_equal(got.ls_alpha_idx.numpy(), np.asarray(ref.ls_alpha_idx))
    assert int(got.sqp_iters) == int(ref.sqp_iters)
    for key in ("xu", "lam"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   np.asarray(getattr(ref, key)), rtol=0, atol=1e-8,
                                   err_msg=key)
    assert mesh.n_psum > 0
