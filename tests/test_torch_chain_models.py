"""The port's serial-chain models (``mpcgpu_tpu_torch/models/chain.py``)
against the JAX package's, and the JAX tests' physics oracles on the port.

Both packages' functions get the same numpy inputs and must give the same
seven arrays (f64, atol 1e-12).  The oracles of ``tests/test_chain_models.py`` (the
closed-form two-link mass matrix, kinetic energy under zero torque, planar
forward kinematics) hold on the port's dynamics, and the SQP on the 3-link
arm at N = 16 follows the JAX ``sqp_solve(linsys="pcg")`` iterate for
iterate at f64 and to the JAX test's tolerance at f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.config import CostConfig as JCostConfig
from mpcgpu_tpu.config import PCGConfig as JPCGConfig
from mpcgpu_tpu.config import SQPConfig as JSQPConfig
from mpcgpu_tpu.models import chain as jchain
from mpcgpu_tpu.models import dynamics as jdyn
from mpcgpu_tpu.solver.sqp import sqp_solve as jax_sqp_solve
from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SQPConfig
from mpcgpu_tpu_torch.models import (dynamics, make_serial_chain, planar_arm,
                                     spatial_inertia)
from mpcgpu_tpu_torch.solver.sqp import sqp_solve

torch.set_num_threads(1)

FIELDS = ("xc", "xs", "xcos", "inertia", "hc", "hs", "hcos")


def _assert_same_model(got, want, atol=1e-12):
    assert got.nq == want.nq and got.gravity == want.gravity
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).cpu().numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=atol, err_msg=f)


def _rotation(rng):
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    return q * np.sign(np.linalg.det(q))


def _random_chain(nq, seed):
    """Rotations, offsets and inertias of a random chain, as numpy."""
    rng = np.random.default_rng(seed)
    rots = [_rotation(rng) for _ in range(nq)]
    offs = [rng.uniform(-0.3, 0.3, 3) for _ in range(nq)]
    inertias = []
    for _ in range(nq):
        A = rng.standard_normal((3, 3))
        inertias.append(spatial_inertia(rng.uniform(0.5, 2.0),
                                        rng.uniform(-0.1, 0.1, 3),
                                        A @ A.T / 10 + 0.01 * np.eye(3)))
    return rots, offs, inertias


def test_spatial_inertia_matches_jax():
    args = (1.7, [0.1, -0.2, 0.05], np.diag([0.3, 0.2, 0.1]))
    np.testing.assert_array_equal(spatial_inertia(*args),
                                  jchain.spatial_inertia(*args))


@pytest.mark.parametrize("nq", [2, 3, 5])
def test_planar_arm_matches_jax(nq):
    got = planar_arm(nq, link_len=0.4, link_mass=0.8, dtype=torch.float64,
                     device="cpu")
    want = jchain.planar_arm(nq, link_len=0.4, link_mass=0.8, dtype=jnp.float64)
    _assert_same_model(got, want)
    assert got.xc.device.type == "cpu" and got.dtype == torch.float64


@pytest.mark.parametrize("nq", [2, 3, 5])
@pytest.mark.parametrize("ee", ["none", "offset", "transform"])
def test_serial_chain_matches_jax(nq, ee):
    rots, offs, inertias = _random_chain(nq, seed=nq)
    kw = {}
    if ee == "offset":
        kw["ee_offset"] = [0.1, -0.05, 0.2]
    elif ee == "transform":
        T = np.eye(4)
        T[:3, :3] = _rotation(np.random.default_rng(9))
        T[:3, 3] = [0.05, 0.1, -0.02]
        kw["ee_transform"] = T
    got = make_serial_chain(rots, offs, inertias, gravity=-9.81,
                            dtype=torch.float64, device="cpu", **kw)
    want = jchain.make_serial_chain(rots, offs, inertias, gravity=-9.81,
                                    dtype=jnp.float64, **kw)
    _assert_same_model(got, want)


def test_serial_chain_f32_matches_jax_bit_for_bit():
    """The f64 decomposition rounds to f32 once, in both packages."""
    rots, offs, inertias = _random_chain(5, seed=1)
    got = make_serial_chain(rots, offs, inertias, ee_offset=[0.1, 0, 0],
                            device="cpu")
    want = jchain.make_serial_chain(rots, offs, inertias, ee_offset=[0.1, 0, 0])
    assert got.dtype == torch.float32
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


def test_ee_offset_and_transform_exclusive():
    rots, offs, inertias = _random_chain(2, seed=0)
    with pytest.raises(ValueError, match="not both"):
        make_serial_chain(rots, offs, inertias, ee_offset=[0, 0, 1],
                          ee_transform=np.eye(4), device="cpu")


def test_chain_models_default_to_the_card(monkeypatch):
    """planar_arm and make_serial_chain put the model on the card unless the
    caller passes another device (the device is recorded, no card needed)."""
    from mpcgpu_tpu_torch.models import robot

    seen = []
    monkeypatch.setattr(robot.RobotModel, "from_numpy", staticmethod(
        lambda obj, device="cuda", dtype=None, gravity=None: seen.append(device)))
    planar_arm(3)
    rots, offs, inertias = _random_chain(2, seed=0)
    make_serial_chain(rots, offs, inertias)
    assert seen == ["cuda", "cuda"]


def test_two_link_mass_matrix_closed_form():
    l, m = 0.7, 2.3
    model = planar_arm(nq=2, link_len=l, link_mass=m, dtype=torch.float64,
                       device="cpu")
    r = l / 2
    Izz = m * l * l / 12.0
    for q2 in (0.0, 0.4, -1.1, 2.8):
        M = dynamics.mass_matrix(model, torch.tensor([0.3, q2],
                                                     dtype=torch.float64)).numpy()
        c2 = np.cos(q2)
        M11 = Izz + Izz + m * r**2 + m * (l**2 + r**2 + 2 * l * r * c2)
        M12 = Izz + m * (r**2 + l * r * c2)
        M22 = Izz + m * r**2
        np.testing.assert_allclose(M, [[M11, M12], [M12, M22]], rtol=1e-10)


def test_energy_conservation_free_chain():
    """Zero torque, zero gravity: kinetic energy 1/2 qd' M qd is conserved
    (explicit-Euler drift ~ O(h))."""
    model = planar_arm(nq=3, dtype=torch.float64, device="cpu")
    t = lambda v: torch.tensor(v, dtype=torch.float64)
    q, qd, u = t([0.2, -0.5, 0.9]), t([0.7, -0.3, 0.4]), t([0.0, 0.0, 0.0])

    def energy(q, qd):
        return float(0.5 * qd @ dynamics.mass_matrix(model, q) @ qd)

    e0 = energy(q, qd)
    h = 1e-4
    for _ in range(2000):
        q, qd = q + h * qd, qd + h * dynamics.forward_dynamics_aba(model, q, qd, u)
    assert abs(energy(q, qd) - e0) / e0 < 1e-3


def test_fk_matches_planar_geometry():
    l = 0.5
    model = planar_arm(nq=3, link_len=l, dtype=torch.float64, device="cpu")
    q = np.array([0.3, -0.7, 1.1])
    ee = dynamics.fk_ee_xyz(model, torch.tensor(q)).numpy()
    a1, a12, a123 = q[0], q[0] + q[1], q[0] + q[1] + q[2]
    x = l * (np.cos(a1) + np.cos(a12) + np.cos(a123))
    y = l * (np.sin(a1) + np.sin(a12) + np.sin(a123))
    np.testing.assert_allclose(ee, [x, y, 0.0], atol=1e-12)


def test_fk_ee_pose_matches_jax():
    """The port's fk_ee (xyz and the RPY branch) against the JAX fk_ee, on a
    random chain with a rotated tool, batched over states."""
    rots, offs, inertias = _random_chain(5, seed=4)
    T = np.eye(4)
    T[:3, :3] = _rotation(np.random.default_rng(2))
    m = make_serial_chain(rots, offs, inertias, ee_transform=T,
                          dtype=torch.float64, device="cpu")
    jm = jchain.make_serial_chain(rots, offs, inertias, ee_transform=T,
                                  dtype=jnp.float64)
    q = np.random.default_rng(5).uniform(-2, 2, (6, 5))
    want = np.stack([np.asarray(jdyn.fk_ee(jm, jnp.asarray(row))) for row in q])
    np.testing.assert_allclose(dynamics.fk_ee(m, torch.tensor(q)).numpy(), want,
                               rtol=0, atol=1e-12)


# the JAX test's 3-link problem (tests/test_chain_models.py::
# test_full_sqp_on_three_link_arm)
N3 = 16
SQP3 = dict(max_iter=12)
PCG3 = dict(max_iter=60, exit_tol=1e-8)


def _three_link(np_dtype):
    q0 = np.asarray([0.1, 0.2, -0.1], np_dtype)
    xu = np.zeros((N3, 9), np_dtype)
    xu[:, :3] = q0
    jm = jchain.planar_arm(nq=3, dtype=jnp.float64 if np_dtype == np.float64
                           else jnp.float32)
    goal = np.asarray(jdyn.fk_ee(jm, jnp.asarray([0.5, 0.3, 0.2], np_dtype)),
                      np_dtype)
    return xu, xu[0, :6].copy(), np.broadcast_to(goal, (N3, 6)).copy()


_JAX = {}


def _jax_three_link(np_dtype):
    if np_dtype not in _JAX:
        xu, xs, ee = _three_link(np_dtype)
        jdt = jnp.float64 if np_dtype == np.float64 else jnp.float32
        jm = jchain.planar_arm(nq=3, dtype=jdt)
        solve = jax.jit(lambda a, lam, b, g: jax_sqp_solve(
            jm, JCostConfig(qd_cost=1e-3, r_cost=1e-4), JSQPConfig(**SQP3),
            JPCGConfig(**PCG3), a, lam, b, g, 1e-3, 1 / 32.0, linsys="pcg"))
        _JAX[np_dtype] = solve(jnp.asarray(xu), jnp.zeros((N3, 6), jdt),
                               jnp.asarray(xs), jnp.asarray(ee))
    return _JAX[np_dtype]


def _port_three_link(np_dtype, linsys):
    xu, xs, ee = _three_link(np_dtype)
    dt = torch.float64 if np_dtype == np.float64 else torch.float32
    t = lambda a: torch.tensor(a, dtype=dt)
    return sqp_solve(planar_arm(nq=3, dtype=dt, device="cpu"),
                     CostConfig(qd_cost=1e-3, r_cost=1e-4), SQPConfig(**SQP3),
                     PCGConfig(**PCG3), t(xu), torch.zeros((N3, 6), dtype=dt),
                     t(xs), t(ee), 1e-3, 1 / 32.0, linsys=linsys)


@pytest.mark.parametrize("linsys", ["pcg", "pcg_cuda"])
def test_three_link_sqp_matches_jax_f64(linsys):
    """The plain route and the fused route's wrappers (K1 -> K2 -> K3, their
    plain versions on CPU tensors) at f64: the JAX iterate, iteration for
    iteration."""
    ref = _jax_three_link(np.float64)
    got = _port_three_link(np.float64, linsys)
    for f in ("pcg_iters", "ls_alpha_idx", "pcg_converged", "sqp_iters",
              "gave_up"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(got.xu.numpy(), np.asarray(ref.xu), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(ref.lam), rtol=0,
                               atol=1e-9)
    # the solve moves the arm toward the goal (the JAX test's check)
    xu, _, ee = _three_link(np.float64)
    m = planar_arm(nq=3, dtype=torch.float64, device="cpu")
    err = lambda q: np.linalg.norm(ee[0, :3] - dynamics.fk_ee_xyz(
        m, torch.tensor(q)).numpy())
    assert err(got.xu[-1, :3].numpy()) < 0.85 * err(xu[0, :3])


def test_three_link_sqp_matches_jax_f32():
    """At f32 the two packages round apart over 12 iterations: the JAX
    test's tolerance (rtol 2e-3, atol 1e-3)."""
    ref = _jax_three_link(np.float32)
    got = _port_three_link(np.float32, "pcg")
    assert np.isfinite(got.xu.numpy()).all()
    np.testing.assert_allclose(got.xu.numpy(), np.asarray(ref.xu), rtol=2e-3,
                               atol=1e-3)
