"""The port's s-step (communication-avoiding) sharded PCG against the JAX
package on the CPU.

The coefficient-space helpers are held to the JAX functions on the same
numpy inputs; ``pcg_solve_sharded(method="ca")`` to the JAX ``ca`` on its
virtual 8-device mesh and to the JAX single-device ``pcg_solve``, at f64 on
the IIWA's Schur system at N = 32 (trace 0_0 rows 350-381 with numpy noise,
as tests/test_torch_sharded_pcg.py); ``"ca_slab"`` (K10b's and the
coefficient step's plain versions) to the port's ``"ca"``.  The fused
sharded SQP at its default (``"ca_slab"``) is held in
tests/test_torch_ca_sqp.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.config import CostConfig as JCostConfig
from mpcgpu_tpu.models import iiwa14 as jax_iiwa14
from mpcgpu_tpu.ops.pcg import pcg_solve as jax_pcg_solve
from mpcgpu_tpu.ops.schur import form_schur_system as jax_form_schur
from mpcgpu_tpu.parallel import pcg_sharded as jps
from mpcgpu_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mpcgpu_tpu.solver.kkt import build_kkt as jax_build_kkt
from mpcgpu_tpu_torch.parallel import KnotMesh, pcg_solve_sharded
from mpcgpu_tpu_torch.parallel import pcg_sharded as tps
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

torch.set_num_threads(1)

N = 32
START = 350
DT = 1.0 / 64.0
S_STEPS = 4
M = 2 * S_STEPS + 1


@pytest.fixture(scope="module")
def system():
    """(S, Pinv, gamma) as numpy f64, from the JAX functions (jitted)."""
    rng = np.random.default_rng(0)
    xu = load_xu_traj("0_0")[START:START + N] + 0.01 * rng.standard_normal((N, 21))
    ee = load_eepos_traj("0_0")[START:START + N]
    model, cost = jax_iiwa14(dtype=jnp.float64), JCostConfig.for_knots(N)
    sch = jax.jit(lambda xu, xs, ee: jax_form_schur(
        jax_build_kkt(model, cost, xu, xs, ee, DT), 1e-3))(
            jnp.asarray(xu), jnp.asarray(xu[0, :14]), jnp.asarray(ee))
    return tuple(np.asarray(a) for a in (sch.S, sch.Pinv, sch.gamma))


def _port(system, method, mesh, max_iter=300, tol=1e-12, crit="eta", s=S_STEPS,
          n=N):
    S, P, g = (torch.tensor(a[:n]) for a in system)
    return pcg_solve_sharded(S, P, g, torch.zeros((n, 14), dtype=torch.float64),
                             mesh, max_iter=max_iter, exit_tol=tol,
                             exit_criterion=crit, method=method, s_steps=s)


# ---- the coefficient-space helpers ---------------------------------------


def _krylov_gram(s, g, seed=0):
    """A Gram system as an outer step builds it, on a random SPD operator
    (n = 24, P^-1 = I) from p = z = r0: (G, b, F, f, rr0, eta) numpy f64."""
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((24, 24))
    A = Q @ Q.T / 24 + np.eye(24)
    r0 = rng.standard_normal(24)
    V, W = [r0], [r0]
    for _ in range(s):
        V.append(A @ V[-1] / g)
    for _ in range(s - 1):
        W.append(A @ W[-1] / g)
    Y = np.stack(V + W, 1)
    Yt = A @ Y
    return Y.T @ Yt, Y.T @ r0, Yt.T @ Yt, Yt.T @ r0, r0 @ r0, r0 @ r0


def _coeff_both(gram, g, it0, max_iter, tol, crit, s=S_STEPS):
    G, b, F, f, rr0, eta = gram
    test = lambda xp: (lambda e, rr: (rr < tol * tol) if crit == "rnorm"
                       else (xp.abs(e) < tol))
    ref = jps._ca_coeff_iters(
        *(jnp.asarray(a) for a in (G, b, F, f, rr0)),
        g * jps._ca_shift_matrix(s, jnp.float64), jnp.asarray(eta), jnp.int32(it0),
        jnp.bool_(False), s, max_iter, test(jnp), jnp.float64)
    got = tps._ca_coeff_iters(
        *(torch.tensor(a) for a in (G, b, F, f, rr0)),
        g * tps._ca_shift_matrix(s, torch.float64), torch.tensor(eta),
        torch.tensor(it0, dtype=torch.int32), torch.tensor(False), s, max_iter,
        test(torch))
    return [np.asarray(a) for a in ref], [a.numpy() for a in got]


@pytest.mark.parametrize("case", ["full", "done_mid_basis", "cap"])
@pytest.mark.parametrize("crit", ["eta", "rnorm"])
def test_coeff_iters_match_jax(case, crit):
    g = 1.7
    gram = _krylov_gram(S_STEPS, g)
    it0, max_iter, tol = 0, 100, 0.0
    if case == "cap":
        it0, max_iter = 98, 100
    if case == "done_mid_basis":
        # a tolerance between the values after the second and the third
        # inner iteration, so that the exit fires at the third
        after = [_coeff_both(gram, g, 0, k, 0.0, crit)[1] for k in (2, 3)]
        if crit == "eta":
            tol = float(np.sqrt(abs(after[0][3]) * abs(after[1][3])))
        else:
            G, b, F, f, rr0, _ = gram
            rr = [float(rr0 - 2 * f @ o[0] + o[0] @ F @ o[0]) for o in after]
            tol = float((rr[0] * rr[1]) ** 0.25)
    ref, got = _coeff_both(gram, g, it0, max_iter, tol, crit)
    for r, o in zip(ref, got):
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-12 * max(1.0, np.abs(r).max()))
    it, done = int(got[4]), bool(got[5])
    want = {"full": (S_STEPS, False), "done_mid_basis": (3, True),
            "cap": (100, False)}[case]
    assert (it - it0 if case != "cap" else it, done) == want


def test_shift_matrix_and_next_scale_match_jax():
    for s in (1, 2, 4):
        np.testing.assert_array_equal(tps._ca_shift_matrix(s, torch.float64).numpy(),
                                      np.asarray(jps._ca_shift_matrix(s, jnp.float64)))
    rng = np.random.default_rng(1)
    G = rng.standard_normal((M, M))
    cases = [G, G.copy(), G.copy(), G.copy()]
    cases[1][0, 0] = 0.0                     # |G00| below tiny: clipped to 1e6
    cases[2][S_STEPS, S_STEPS] = np.nan      # not finite: g kept
    cases[3][S_STEPS, S_STEPS] = 1e-40       # clipped to 1e-6
    for Gc in cases:
        for g in (1.0, 3.5):
            ref = float(jps._ca_next_scale(jnp.asarray(Gc), jnp.asarray(g), S_STEPS,
                                           jnp.float64))
            got = float(tps._ca_next_scale(torch.tensor(Gc), torch.tensor(g), S_STEPS))
            assert abs(got - ref) <= 1e-12 * abs(ref), (got, ref)


# ---- the sharded solves ---------------------------------------------------


@pytest.mark.parametrize("s,shards", [(2, 4), (4, 2)])
def test_ca_matches_jax(system, s, shards):
    """Equal iteration counts and lam within 1e-8 of the JAX "ca" on its
    virtual mesh; within 1e-7 and s iterations of the JAX single-device
    pcg_solve (the bounds of test_sharded_pcg_ca_matches_single_device)."""
    S, P, g = (jnp.asarray(a) for a in system)
    lam0 = jnp.zeros((N, 14), jnp.float64)
    kw = dict(max_iter=300, exit_tol=1e-12)
    ref = jax.jit(lambda *a: jps.pcg_solve_sharded(
        *a, jax_make_mesh(1, shards), method="ca", s_steps=s, **kw))(S, P, g, lam0)
    single = jax_pcg_solve(S, P, g, lam0, **kw)
    got = _port(system, "ca", KnotMesh(shards), s=s)
    assert bool(got.converged) and bool(ref.converged)
    assert int(got.iters) == int(ref.iters) < 300
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(ref.lam), rtol=0, atol=1e-8)
    assert abs(int(got.iters) - int(single.iters)) <= s
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(single.lam), rtol=0,
                               atol=1e-7)


def test_ca_slab_matches_ca(system):
    """The plain K10b and coefficient step drive the port's "ca" loop: 60
    fixed iterations (exit_tol 0), equal counts, lam within 1e-10."""
    ca = _port(system, "ca", KnotMesh(2), max_iter=60, tol=0.0)
    cas = _port(system, "ca_slab", KnotMesh(2), max_iter=60, tol=0.0)
    assert int(ca.iters) == int(cas.iters) == 60
    np.testing.assert_allclose(cas.lam.numpy(), ca.lam.numpy(), rtol=0, atol=1e-10)


@pytest.mark.parametrize("crit,tol", [("eta", 1e-8), ("rnorm", 1e-8)])
def test_ca_slab_exits_like_classic(system, crit, tol):
    """Both exits fire mid-basis, within s iterations of classic's count.
    eta is a direct recurrence; rnorm comes from r.r - 2 f.e + e.F e, whose
    cancellation floor makes the exit late at tight tolerances.  Measured on
    this system at f64 (s = 4, 2 shards): the same counts as classic at
    1e-4, 1e-6, 1e-8 for both exits (eta 36, 63, 96; rnorm 126, 147, 163);
    at 1e-10 rnorm never fires within 300 iterations (classic: 174)."""
    ref = _port(system, "classic", KnotMesh(2), tol=tol, crit=crit)
    got = _port(system, "ca_slab", KnotMesh(2), tol=tol, crit=crit)
    assert bool(got.converged) and bool(ref.converged)
    assert abs(int(got.iters) - int(ref.iters)) <= S_STEPS
    np.testing.assert_allclose(got.lam.numpy(), ref.lam.numpy(), rtol=0,
                               atol=1e-7 if crit == "eta" else 1e-5)


@pytest.mark.parametrize("method", ["ca", "ca_slab"])
def test_ca_collectives_per_outer_step(system, method):
    """2 sends and 1 psum per outer step (s iterations), counted by the
    mesh: the difference between caps of 8 and 16 is two outer steps."""
    counts = {}
    for cap in (8, 16):
        mesh = KnotMesh(2)
        _port(system, method, mesh, max_iter=cap, tol=0.0)
        counts[cap] = (mesh.n_send, mesh.n_psum)
    sends, psums = (b - a for a, b in zip(counts[8], counts[16]))
    assert (sends, psums) == (4, 2)


@pytest.mark.parametrize("method", ["ca", "ca_slab"])
def test_narrow_slab_falls_back_to_pipelined(system, method):
    """At L = 4 < 2s+1 (8 shards) the s-step forms run pipelined, as the JAX
    pcg_solve_sharded does: the same result bit for bit, the same
    collectives."""
    ref_mesh, mesh = KnotMesh(8), KnotMesh(8)
    ref = _port(system, "pipelined", ref_mesh, max_iter=120, tol=1e-8)
    got = _port(system, method, mesh, max_iter=120, tol=1e-8)
    assert bool(got.converged)
    assert torch.equal(got.lam, ref.lam) and int(got.iters) == int(ref.iters)
    assert (mesh.n_send, mesh.n_psum) == (ref_mesh.n_send, ref_mesh.n_psum)
