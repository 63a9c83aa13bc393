"""The batched solve of planar arms of 3 and 5 links (the chain tracker's,
0.4 m and 0.8 kg a link) over the instance axis, against the JAX package on
the CPU, at f64.

``sqp_solve_batched_fused_sharded`` on ``make_mesh(n_instance=2)`` (K8a-c
and K3b over instances, their plain versions on CPU tensors) equals the
unsharded ``sqp_solve_batched_fused`` bit for bit and the vmap of the JAX
``sqp_solve(linsys="pcg")`` at test_torch_batched.py's tolerances: the same
PCG iterations and line-search choices, xu within 1e-8.  The inputs are the
tracker's own inverse-dynamics trace plus numpy noise."""

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
from mpcgpu_tpu_torch.parallel import (make_mesh, sqp_solve_batched_fused,
                                       sqp_solve_batched_fused_sharded)

torch.set_num_threads(1)

B, N, DT = 4, 16, track_chain.DT
SQP = dict(max_iter=3)
PCG = dict(max_iter=80, exit_tol=1e-8)


def _inputs(nq):
    model = track_chain.build_model(nq, device="cpu", dtype=torch.float64)[0]
    xu, ee = track_chain.reference_trace(model, 3 * N)
    rng = np.random.default_rng(nq)
    xu_b = xu[N:2 * N][None] + 0.02 * rng.standard_normal((B, N, 3 * nq))
    ee_b = np.broadcast_to(ee[N:2 * N], (B, N, 6)).copy()
    return model, (xu_b, np.zeros((B, N, 2 * nq)), xu_b[:, 0, :2 * nq].copy(),
                   ee_b, 1e-3 * (1 + np.arange(B)))


@pytest.mark.parametrize("nq", [3, 5])
def test_chain_batched_solve_over_instances_matches_jax_f64(nq):
    model, arrays = _inputs(nq)
    args = (model, track_chain.COST, SQPConfig(**SQP), PCGConfig(**PCG),
            *map(torch.tensor, arrays), DT)
    ref = sqp_solve_batched_fused(*args)
    got = sqp_solve_batched_fused_sharded(*args, make_mesh(n_instance=2))
    for f in ref._fields:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    jm = jchain.planar_arm(nq, link_len=0.4, link_mass=0.8, dtype=jnp.float64)
    jc = JCostConfig(qd_cost=track_chain.COST.qd_cost,
                     r_cost=track_chain.COST.r_cost)
    jref = jax.jit(jax.vmap(lambda xu, lam, xs, ee, rho: jax_sqp_solve(
        jm, jc, JSQPConfig(**SQP), JPCGConfig(**PCG), xu, lam, xs, ee, rho, DT,
        linsys="pcg")))(*map(jnp.asarray, arrays))
    for f in ("pcg_iters", "ls_alpha_idx", "sqp_iters", "gave_up"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(jref, f)), err_msg=f)
    assert 0 < int(got.pcg_iters[:, 0].min()) < PCG["max_iter"]
    np.testing.assert_allclose(got.xu.numpy(), np.asarray(jref.xu), rtol=0, atol=1e-8)
