"""Port dynamics (mpcgpu_tpu_torch.models) against the JAX reference at f64.

Every input is drawn with numpy from a seed and handed to both packages;
the JAX side is vmapped over the knot axis, the port is batched natively.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.models import dynamics as jdyn
from mpcgpu_tpu.models import iiwa14 as jax_iiwa14
from mpcgpu_tpu.models import spatial as jspatial
from mpcgpu_tpu_torch.models import RobotModel, dynamics, iiwa14, spatial

torch.set_num_threads(1)

N = 16
RTOL = 1e-10


@pytest.fixture(scope="module")
def states():
    rng = np.random.default_rng(0)
    return rng.normal(size=(N, 7)), rng.normal(size=(N, 7)), rng.normal(size=(N, 7))


def _close(got, ref, rtol=RTOL):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        scale = max(float(np.abs(r).max()), 1e-300)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=rtol * scale)


# name -> (number of state arguments q, qd, u/qdd it takes)
_FUNCS = {
    "fk_ee_hom": 1,
    "fk_ee_xyz": 1,
    "fk_ee_xyz_and_jac": 1,
    "rnea": 2,
    "mass_matrix": 1,
    "minv": 1,
    "forward_dynamics": 3,
    "forward_dynamics_aba": 3,
    "fd_and_gradient": 3,
}


@pytest.mark.parametrize("name", sorted(_FUNCS))
def test_dynamics_matches_jax(states, name):
    nargs = _FUNCS[name]
    args = states[:nargs]
    jm = jax_iiwa14(dtype=jnp.float64)
    ref = jax.jit(jax.vmap(lambda *a: getattr(jdyn, name)(jm, *a)))(
        *(jnp.asarray(a) for a in args))
    got = getattr(dynamics, name)(iiwa14(torch.float64, device="cpu"),
                                  *(torch.tensor(a) for a in args))
    _close(got, ref)


@pytest.mark.parametrize("name", ["rnea_qdd", "forward_dynamics_aba", "fd_and_gradient"])
def test_dynamics_with_gravity_matches_jax(states, name):
    q, qd, u = states
    jm = jax_iiwa14(dtype=jnp.float64, gravity=9.81)
    tm = iiwa14(torch.float64, gravity=9.81, device="cpu")
    fn = "rnea" if name == "rnea_qdd" else name
    ref = jax.jit(jax.vmap(lambda a, b, c: getattr(jdyn, fn)(jm, a, b, c)))(
        jnp.asarray(q), jnp.asarray(qd), jnp.asarray(u))
    got = getattr(dynamics, fn)(tm, torch.tensor(q), torch.tensor(qd), torch.tensor(u))
    _close(got, ref)


def test_spatial_matches_jax():
    rng = np.random.default_rng(1)
    v, m = rng.normal(size=(N, 6)), rng.normal(size=(N, 6))
    tv, tmv = torch.tensor(v), torch.tensor(m)
    _close(spatial.skew(tv[:, :3]), jspatial.skew(jnp.asarray(v[:, :3])))
    _close(spatial.crm(tv), jspatial.crm(jnp.asarray(v)))
    _close(spatial.crf(tv), jspatial.crf(jnp.asarray(v)))
    _close(spatial.crm_apply(tv, tmv),
           jspatial.crm_apply(jnp.asarray(v), jnp.asarray(m)))
    _close(spatial.crf_apply(tv, tmv),
           jspatial.crf_apply(jnp.asarray(v), jnp.asarray(m)))


def test_model_transforms_match_jax(states):
    q = states[0]
    jm = jax_iiwa14(dtype=jnp.float64)
    tm = iiwa14(torch.float64, device="cpu")
    _close(tm.xmats(torch.tensor(q)), jax.vmap(jm.xmats)(jnp.asarray(q)))
    _close(tm.hom_xmats(torch.tensor(q)), jax.vmap(jm.hom_xmats)(jnp.asarray(q)))


def test_from_numpy_carries_the_jax_model_across():
    """RobotModel.from_numpy(jax model) == the port's iiwa14(), field by field,
    and .to() changes dtype without changing values."""
    for gravity in (0.0, 9.81):
        carried = RobotModel.from_numpy(jax_iiwa14(dtype=jnp.float64, gravity=gravity),
                                       device="cpu")
        native = iiwa14(torch.float64, gravity=gravity, device="cpu")
        for f in ("xc", "xs", "xcos", "inertia", "hc", "hs", "hcos"):
            assert torch.equal(getattr(carried, f), getattr(native, f)), f
        assert carried.gravity == native.gravity == gravity
    f32 = native.to(dtype=torch.float32)
    assert f32.dtype == torch.float32 and f32.nq == 7
    assert torch.equal(f32.packed(), native.packed().float())
    as_dict = {f: np.asarray(getattr(native, f)) for f in
               ("xc", "xs", "xcos", "inertia", "hc", "hs", "hcos")}
    assert torch.equal(RobotModel.from_numpy(as_dict, device="cpu").inertia, native.inertia)
