"""The port's URDF loader and exporter (``mpcgpu_tpu_torch/models/urdf.py``)
against the JAX package's, each on the same XML text.

``load_urdf`` must give the JAX loader's seven arrays (f64, atol 1e-12) for
a planar chain, arbitrary joint axes, an axis written as an rpy-rotated z
joint and a massive fixed link lumped into its parent; it must refuse the
same ``ee_link`` placements and accept the supported ones;
``export_urdf(iiwa14())`` must load back into ``iiwa14()``, and the exported
text must be the JAX exporter's text.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.models import iiwa14 as jax_iiwa14
from mpcgpu_tpu.models import chain as jchain
from mpcgpu_tpu.models import urdf as jurdf
from mpcgpu_tpu_torch.models import dynamics, iiwa14, load_urdf, planar_arm
from mpcgpu_tpu_torch.models.urdf import export_urdf

torch.set_num_threads(1)

FIELDS = ("xc", "xs", "xcos", "inertia", "hc", "hs", "hcos")


def _link(name, mass=None, com="0 0 0", inertia=None, rpy="0 0 0"):
    if mass is None:
        return f'<link name="{name}"/>'
    ixx, iyy, izz, ixy, ixz, iyz = inertia
    return f"""<link name="{name}"><inertial>
      <origin xyz="{com}" rpy="{rpy}"/><mass value="{mass}"/>
      <inertia ixx="{ixx}" iyy="{iyy}" izz="{izz}" ixy="{ixy}" ixz="{ixz}" iyz="{iyz}"/>
    </inertial></link>"""


def _joint(name, jtype, parent, child, xyz="0 0 0", rpy="0 0 0", axis="0 0 1"):
    ax = f'<axis xyz="{axis}"/>' if jtype != "fixed" else ""
    return f"""<joint name="{name}" type="{jtype}">
      <origin xyz="{xyz}" rpy="{rpy}"/>{ax}
      <parent link="{parent}"/><child link="{child}"/></joint>"""


def _robot(*parts):
    return '<robot name="test">' + "".join(parts) + "</robot>"


def _planar_urdf(nq=3, L=0.5, m=1.0):
    rod = (1e-4, m * L * L / 12.0, m * L * L / 12.0, 0.0, 0.0, 0.0)
    parts = [_link("base")]
    for k in range(nq):
        parts.append(_link(f"l{k}", m, f"{L/2} 0 0", rod))
        parts.append(_joint(f"j{k}", "revolute", "base" if k == 0 else f"l{k-1}",
                            f"l{k}", xyz="0 0 0" if k == 0 else f"{L} 0 0"))
    parts.append(_link("tool"))
    parts.append(_joint("jee", "fixed", f"l{nq-1}", "tool", xyz=f"{L} 0 0"))
    return _robot(*parts)


def _axes_urdf():
    """Joints about x, -z and a skew axis, with origin rotations and a
    trailing fixed tool joint (tests/test_urdf.py's arbitrary-axes chain)."""
    rod = (1e-3, 2e-2, 2e-2, 0.0, 0.0, 0.0)
    joints = [("revolute", "1 0 0", "0 0 0.3", "0 0 0"),
              ("revolute", "0 0 -1", "0.1 0 0.2", "0.2 -0.3 0.1"),
              ("revolute", "1 1 1", "0 0.2 0.1", "0 0.4 0"),
              ("fixed", "0 0 1", "0 0 0.15", "0.1 0 0.5")]
    parts, prev = [_link("base")], "base"
    for k, (jtype, axis, xyz, rpy) in enumerate(joints):
        parts.append(_link(f"l{k}", 1.0, "0.05 0 0", rod) if jtype != "fixed"
                     else _link(f"l{k}"))
        parts.append(_joint(f"j{k}", jtype, prev, f"l{k}", xyz=xyz, rpy=rpy,
                            axis=axis))
        prev = f"l{k}"
    return _robot(*parts)


def _axis_vs_rpy_urdfs():
    """The same robot with joint 2 about +y, and as a z joint in a frame
    rotated by rpy = (-pi/2, 0, 0) (tests/test_urdf.py)."""
    m, L = 1.4, 0.6
    rod = (1e-3, m * L * L / 12.0, m * L * L / 12.0, 0.0, 0.0, 0.0)
    rodB = (1e-3, rod[2], rod[1], 0.0, 0.0, 0.0)
    tail = (_link("tool"), _joint("jee", "fixed", "l2", "tool", xyz=f"{L} 0 0"))
    a = _robot(_link("base"), _link("l1", m, f"{L/2} 0 0", rod),
               _joint("j1", "revolute", "base", "l1"),
               _link("l2", m, f"{L/2} 0 0", rod),
               _joint("j2", "revolute", "l1", "l2", xyz=f"{L} 0 0", axis="0 1 0"),
               *tail)
    b = _robot(_link("base"), _link("l1", m, f"{L/2} 0 0", rod),
               _joint("j1", "revolute", "base", "l1"),
               _link("l2", m, f"{L/2} 0 0", rodB),
               _joint("j2", "revolute", "l1", "l2", xyz=f"{L} 0 0",
                      rpy=f"{-np.pi/2} 0 0", axis="0 0 1"),
               *tail)
    return a, b


def _lumping_urdfs():
    """A massive fixed tool link on link 1, and the hand-lumped link
    (tests/test_urdf.py's parallel-axis case)."""
    m1, mt, L, d = 2.0, 0.5, 0.5, 0.2
    I1, It = np.diag([1e-3, 3e-2, 3e-2]), np.diag([2e-3, 2e-3, 2e-3])
    c1, ct = np.array([L / 2, 0.0, 0.0]), np.array([0.05, 0.0, 0.0])
    ct_in1 = np.array([d, 0.0, 0.0]) + ct
    mc = m1 + mt
    cc = (m1 * c1 + mt * ct_in1) / mc
    pa = lambda I, m, r: I + m * ((r @ r) * np.eye(3) - np.outer(r, r))
    Ic = pa(I1, m1, c1 - cc) + pa(It, mt, ct_in1 - cc)
    tup = lambda I: (I[0, 0], I[1, 1], I[2, 2], I[0, 1], I[0, 2], I[1, 2])
    with_tool = _robot(_link("base"), _link("l1", m1, f"{c1[0]} 0 0", tup(I1)),
                       _joint("j1", "revolute", "base", "l1"),
                       _link("tool", mt, f"{ct[0]} 0 0", tup(It)),
                       _joint("jt", "fixed", "l1", "tool", xyz=f"{d} 0 0"))
    lumped = _robot(_link("base"), _link("l1", mc, f"{cc[0]} {cc[1]} {cc[2]}",
                                         tup(Ic)),
                    _joint("j1", "revolute", "base", "l1"))
    return with_tool, lumped


CASES = {
    "planar": _planar_urdf(3),
    "planar5": _planar_urdf(5, L=0.4, m=0.8),
    "axes": _axes_urdf(),
    "axis_y": _axis_vs_rpy_urdfs()[0],
    "rpy_z": _axis_vs_rpy_urdfs()[1],
    "fixed_tool": _lumping_urdfs()[0],
    "lumped": _lumping_urdfs()[1],
}


def _assert_same(got, want, atol=1e-12):
    assert got.nq == want.nq
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).cpu().numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=atol, err_msg=f)


@pytest.mark.parametrize("case", sorted(CASES))
def test_load_urdf_matches_jax(case):
    text = CASES[case]
    got = load_urdf(text, dtype=torch.float64, device="cpu")
    _assert_same(got, jurdf.load_urdf(text, dtype=jnp.float64))
    assert got.dtype == torch.float64 and got.xc.device.type == "cpu"


def test_load_urdf_from_a_file(tmp_path):
    path = tmp_path / "arm.urdf"
    path.write_text(CASES["axes"])
    _assert_same(load_urdf(str(path), dtype=torch.float64, device="cpu"),
                 jurdf.load_urdf(CASES["axes"], dtype=jnp.float64))


def test_load_urdf_defaults_to_the_card(monkeypatch):
    from mpcgpu_tpu_torch.models import robot

    seen = []
    monkeypatch.setattr(robot.RobotModel, "from_numpy", staticmethod(
        lambda obj, device="cuda", dtype=None, gravity=None: seen.append(device)))
    load_urdf(CASES["planar"])
    assert seen == ["cuda"]


def test_planar_urdf_is_the_planar_arm():
    _assert_same(load_urdf(CASES["planar"], dtype=torch.float64, device="cpu"),
                 jchain.planar_arm(3, dtype=jnp.float64), atol=1e-14)
    a = load_urdf(CASES["planar5"], dtype=torch.float64, device="cpu")
    b = planar_arm(5, link_len=0.4, link_mass=0.8, dtype=torch.float64,
                   device="cpu")
    for f in FIELDS:
        torch.testing.assert_close(getattr(a, f), getattr(b, f), rtol=0,
                                   atol=1e-14)


def test_axis_vs_rpy_equivalent_dynamics():
    ma = load_urdf(CASES["axis_y"], dtype=torch.float64, device="cpu")
    mb = load_urdf(CASES["rpy_z"], dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(3)
    q, qd, qdd = (torch.tensor(rng.uniform(-1.5, 1.5, (3, 2))) for _ in range(3))
    for fn in (lambda m: dynamics.fk_ee_xyz(m, q),
               lambda m: dynamics.mass_matrix(m, q),
               lambda m: dynamics.rnea(m, q, qd, qdd)):
        torch.testing.assert_close(fn(ma), fn(mb), rtol=0, atol=1e-12)


@pytest.mark.parametrize("ee_link", ["l0", "l1"])
def test_ee_link_with_downstream_movable_joint_rejected(ee_link):
    for loader in (load_urdf, jurdf.load_urdf):
        with pytest.raises(ValueError, match="downstream"):
            loader(CASES["planar"], ee_link=ee_link)


def test_ee_link_not_on_the_chain_rejected():
    for loader in (load_urdf, jurdf.load_urdf):
        with pytest.raises(ValueError, match="not on the serial chain"):
            loader(CASES["planar"], ee_link="elsewhere")


@pytest.mark.parametrize("ee_link,x", [("l2", 1.0), ("tool", 1.5)])
def test_ee_link_supported_placements(ee_link, x):
    """The last movable link (its joint's origin) and the trailing fixed
    chain's tip, as the JAX loader places them."""
    got = load_urdf(CASES["planar"], ee_link=ee_link, dtype=torch.float64,
                    device="cpu")
    _assert_same(got, jurdf.load_urdf(CASES["planar"], ee_link=ee_link,
                                      dtype=jnp.float64))
    ee = dynamics.fk_ee(got, torch.zeros(3, dtype=torch.float64))[:3]
    torch.testing.assert_close(ee, torch.tensor([x, 0.0, 0.0], dtype=torch.float64),
                               rtol=0, atol=1e-14)


def test_unsupported_joints_and_branches_rejected():
    prismatic = CASES["planar"].replace('type="revolute"', 'type="prismatic"', 1)
    branch = CASES["planar"].replace(
        "</robot>", _link("side") + _joint("js", "revolute", "l0", "side") + "</robot>")
    for text, match in ((prismatic, "unsupported joint type"),
                        (branch, "branching chain")):
        for loader in (load_urdf, jurdf.load_urdf):
            with pytest.raises(ValueError, match=match):
                loader(text)


def test_export_import_roundtrip_iiwa14():
    """export_urdf(iiwa14()) loads back into the IIWA-14: every array
    (the baked ee transform and the 90-degree inter-joint rotations
    included) and the dynamics."""
    want = iiwa14(torch.float64, device="cpu")
    got = load_urdf(export_urdf(want, name="iiwa14"), dtype=torch.float64,
                    device="cpu")
    assert got.nq == 7
    for f in FIELDS:
        torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=0,
                                   atol=1e-12)
    rng = np.random.default_rng(11)
    q, qd = torch.tensor(rng.uniform(-2, 2, 7)), torch.tensor(rng.uniform(-1, 1, 7))
    torch.testing.assert_close(dynamics.fk_ee(got, q), dynamics.fk_ee(want, q),
                               rtol=0, atol=1e-12)
    torch.testing.assert_close(dynamics.rnea(got, q, qd, qd),
                               dynamics.rnea(want, q, qd, qd), rtol=0, atol=1e-10)


@pytest.mark.parametrize("which", ["iiwa14", "planar", "axes"])
def test_export_text_matches_jax(which):
    if which == "iiwa14":
        got, want = iiwa14(device="cpu"), jax_iiwa14()
    elif which == "planar":
        got = planar_arm(4, link_len=0.3, device="cpu")
        want = jchain.planar_arm(4, link_len=0.3)
    else:
        got = load_urdf(CASES["axes"], device="cpu")
        want = jurdf.load_urdf(CASES["axes"])
    assert export_urdf(got, name="r") == jurdf.export_urdf(want, name="r")
