"""The plain versions of the knot-sharded path's slab kernels against the
JAX XLA functions on the CPU, at f64, on a shard's interior rows.

Trace 0_0 rows 350-381 with numpy noise, N = 32 over 4 shards (L = 8), each
shard's window extended by two ring-halo knots per side as
``parallel/sqp_sharded.py`` builds it.  K9a (``build_kkt_schur_slab``) is
held to ``build_kkt`` + ``form_schur_system``, K9b (``compute_dz_slab``) to
``compute_dz``, and K9c (``line_search_merit_partials_slab``), after the
boundary corrections and the sum over shards, to
``line_search_merits(include_zero=True)``; on CPU tensors each wrapper runs
its plain version.  K9a's ``angle_wrap=`` and K9c's ``include_zero=`` /
``angle_wrap=`` are held to the same JAX functions with the same flags on
states whose joint angles lie near +-pi (as ``tests/test_angle_wrap.py``
builds them), where the wrap fires.  The kernels are held to these plain
versions on the card by chip_smoke.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.config import CostConfig as JCostConfig
from mpcgpu_tpu.models import iiwa14 as jax_iiwa14
from mpcgpu_tpu.ops import schur as jschur
from mpcgpu_tpu.solver import kkt as jkkt
from mpcgpu_tpu.solver import merit as jmerit
from mpcgpu_tpu_torch.config import CostConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.ops.pcg_cuda import compute_dz_slab
from mpcgpu_tpu_torch.solver.kkt_cuda import build_kkt_schur_slab
from mpcgpu_tpu_torch.solver.merit_cuda import line_search_merit_partials_slab
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

torch.set_num_threads(1)

N = 32
START = 350
DT = 1.0 / 64.0
RHO = 1e-3
MU = 10.0


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    xu = load_xu_traj("0_0")[START:START + N] + 0.01 * rng.standard_normal((N, 21))
    return xu, xu[0, :14].copy(), load_eepos_traj("0_0")[START:START + N]


@pytest.fixture(scope="module")
def wrap_problem():
    """Joint angles 3.05 + 0.3 N(0, 1): the integrated angles cross +-pi."""
    rng = np.random.default_rng(3)
    q = 3.05 + 0.3 * rng.standard_normal((N, 7))
    xu = np.concatenate([q, 0.5 * rng.standard_normal((N, 14))], axis=1)
    return xu, xu[0, :14].copy(), rng.standard_normal((N, 6))


SHARDS = 4
L = N // SHARDS
H = 2


def _slabs(a, halo: int):
    """(SHARDS, L + 2 halo, ...) windows of a (N, ...) array, ring-wrapped."""
    idx = (np.arange(SHARDS)[:, None] * L + np.arange(-halo, L + halo)) % N
    return torch.tensor(np.asarray(a)[idx])


def _flags():
    g = (np.arange(SHARDS)[:, None] * L + np.arange(-H, L + H)) % N
    return torch.tensor(g == 0, dtype=torch.float64), \
        torch.tensor(g == N - 1, dtype=torch.float64)


def _interior(t):
    return t[:, H:H + L].reshape(N, *t.shape[2:]).numpy()


def _check_kkt_slab(problem, integ, terminal, angle_wrap=False):
    """K9a's plain version on the halo-extended slabs: the interior rows
    are the JAX global Schur system, stair preconditioner and dz blocks;
    then K9b's plain version on them is the JAX compute_dz.  Returns K9a's
    outputs and its call."""
    xu, xs, ee = problem
    jm = jax_iiwa14(dtype=jnp.float64)
    jcost = dataclasses.replace(JCostConfig.for_knots(N),
                                terminal_at_last_state=terminal)
    kkt, sch = jax.jit(lambda a, b, g: (lambda k: (k, jschur.form_schur_system(
        k, RHO)))(jkkt.build_kkt(jm, jcost, a, b, g, DT, integ,
                                 angle_wrap=angle_wrap)))(
            jnp.asarray(xu), jnp.asarray(xs), jnp.asarray(ee))
    cost = dataclasses.replace(CostConfig.for_knots(N), terminal_at_last_state=terminal)
    first, last = _flags()
    call = lambda **flags: build_kkt_schur_slab(
        iiwa14(torch.float64, device="cpu"), cost, _slabs(xu, H), _slabs(ee, H),
        first, last, RHO, DT, integ, **flags)
    got = call(angle_wrap=angle_wrap)
    for key, ref in (("S", sch.S), ("Pinv", sch.Pinv), ("gamma", sch.gamma),
                     ("Qinv", sch.Qinv), ("q", kkt.q)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(_interior(got[key]), ref, rtol=1e-10,
                                   atol=1e-10 * np.abs(ref).max(), err_msg=key)
    for key, ref in (("A", kkt.A), ("B", kkt.B)):
        g = _interior(got[key])
        np.testing.assert_allclose(g[:-1], np.asarray(ref), rtol=1e-10, atol=1e-12)
        assert not g[-1].any()
    # K9b: dz from the interior blocks, lam_next from the next shard
    lam = np.random.default_rng(1).standard_normal((N, 14))
    ref = jschur.compute_dz(kkt, sch, jnp.asarray(lam))
    slab = {k: v[:, H:H + L] for k, v in got.items()}
    lam_s = _slabs(lam, 0)
    lam_next = _slabs(np.roll(lam, -1, axis=0), 0)
    last_s = _slabs((np.arange(N) == N - 1).astype(np.float64), 0)
    dz = compute_dz_slab(slab, lam_s, lam_next, last_s, _slabs(xu, 0)[..., 14:],
                         RHO, cost.r_cost)
    np.testing.assert_allclose(dz.reshape(N, 21).numpy(), np.asarray(ref),
                               rtol=1e-10, atol=1e-10 * np.abs(np.asarray(ref)).max())
    return got, call


@pytest.mark.parametrize("integ,terminal", [(0, True), (1, False)])
def test_kkt_slab_plain_matches_jax(problem, integ, terminal):
    _check_kkt_slab(problem, integ, terminal)


@pytest.mark.parametrize("integ,terminal", [(0, True), (1, False)])
def test_kkt_slab_plain_angle_wrap_matches_jax(wrap_problem, integ, terminal):
    """``angle_wrap=True`` against the JAX ``build_kkt(angle_wrap=True)``
    (rtol 1e-10 as above); the wrap moves the defects, so gamma differs
    from the unwrapped call's and the Jacobians do not."""
    got, call = _check_kkt_slab(wrap_problem, integ, terminal, angle_wrap=True)
    plain = call()
    assert not torch.allclose(got["gamma"], plain["gamma"], rtol=1e-6, atol=0)
    for key in ("S", "Pinv", "Qinv", "A", "B", "q"):
        assert torch.equal(got[key], plain[key]), key


_PARTIALS = {}


def _merit_partials(problem, include_zero=True, angle_wrap=False):
    key = (id(problem), include_zero, angle_wrap)
    if key not in _PARTIALS:
        _PARTIALS[key] = _merit_partials_checked(problem, include_zero, angle_wrap)
    return _PARTIALS[key]


def _merit_partials_checked(problem, include_zero, angle_wrap):
    """K9c's plain version on each shard's slab (its knots and the next
    shard's first), its halo knot dropped, corrected at the global ends and
    summed over the shards, is the JAX line_search_merits with the same
    flags: the alphas bit for bit, the merits to rtol 1e-12.  Returns the
    per-knot terms and the alphas."""
    xu, xs, ee = problem
    cost = CostConfig.for_knots(N)
    dz = 0.05 * np.random.default_rng(2).standard_normal((N, 21))
    jm, jcost = jax_iiwa14(dtype=jnp.float64), JCostConfig.for_knots(N)
    ref, ref_alphas = jax.jit(lambda a, d, b, g: jmerit.line_search_merits(
        jm, jcost, a, d, b, g, MU, DT, include_zero=include_zero,
        angle_wrap=angle_wrap))(
            jnp.asarray(xu), jnp.asarray(dz), jnp.asarray(xs), jnp.asarray(ee))
    ext = lambda a: _slabs(a, 1)[:, 1:]                   # rows 0 .. L
    out = line_search_merit_partials_slab(
        iiwa14(torch.float64, device="cpu"), cost, ext(xu), ext(dz), ext(ee), DT,
        include_zero=include_zero, angle_wrap=angle_wrap)
    cost_k, defect_k, alphas = out
    assert cost_k.shape == defect_k.shape == (SHARDS, 8 + include_zero, L + 1)
    np.testing.assert_array_equal(alphas.numpy(), np.asarray(ref_alphas))
    cost_k, defect_k = cost_k[..., :L], defect_k[..., :L]     # drop the halo
    cand_u = torch.tensor(xu[-1, 14:]) + alphas[:, None] * torch.tensor(dz[-1, 14:])
    cost_tot = cost_k.sum((0, 2)) - 0.5 * cost.r_cost * (cand_u ** 2).sum(-1)
    defect_tot = defect_k.sum((0, 2)) - defect_k[-1, :, -1]
    cand_x0 = torch.tensor(xu[0, :14]) + alphas[:, None] * torch.tensor(dz[0, :14])
    x0_res = (cand_x0 - torch.tensor(xs)).abs().sum(-1)
    merits = cost_tot + MU * (defect_tot + x0_res)
    np.testing.assert_allclose(merits.numpy(), np.asarray(ref), rtol=1e-12)
    return out


def test_merit_partials_plain_matches_jax(problem):
    _merit_partials(problem)


@pytest.mark.parametrize("include_zero", [True, False])
@pytest.mark.parametrize("angle_wrap", [False, True])
def test_merit_partials_plain_flags_match_jax(wrap_problem, include_zero, angle_wrap):
    """Each flag reaches the terms: without the zero candidate the alphas
    and terms are the default call's shifted by one index; the wrap changes
    the defects and not the costs."""
    cost_k, defect_k, alphas = _merit_partials(wrap_problem, include_zero, angle_wrap)
    full = _merit_partials(wrap_problem, True, angle_wrap)
    drop = 1 - int(include_zero)
    for got, ref in zip((cost_k, defect_k, alphas), full):
        assert torch.equal(got, ref[..., drop:, :] if got.dim() > 1 else ref[drop:])
    unwrapped = _merit_partials(wrap_problem, include_zero, False)
    assert torch.equal(cost_k, unwrapped[0])
    assert torch.equal(defect_k, unwrapped[1]) != angle_wrap
