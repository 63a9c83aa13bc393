"""URDF front end: load any revolute serial chain into a ``RobotModel``.

Port of ``mpcgpu_tpu/models/urdf.py``.  A URDF loads at run time into the
affine-in-(sin q, cos q) tensors of ``RobotModel`` through
``models/chain.py``; the dynamics, the kernels (built for 2 <= nq <= 7), the
solvers and the simulators take the model's nq, so the loaded robot runs
through the whole stack.

Scope: a single serial chain of revolute / continuous joints.  Handled
beyond ``make_serial_chain``:

* **arbitrary fixed joint axes**: a joint about axis ``a`` is rewritten as a
  revolute-z joint in an internally rotated child frame (``a`` aligned to z
  by a constant rotation folded into the adjacent fixed transforms and the
  link inertia), exactly;
* **fixed joints**: folded into the next joint's origin; the fixed link's
  inertia is transformed and lumped into the preceding movable link
  (flange / tool adapters);
* **trailing fixed chain**: becomes the end-effector transform.

The parsing and the frame algebra are numpy at f64 and the stdlib
``xml.etree``; the model's tensors take the requested dtype and device (the
card unless the caller asks for another).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np
import torch

from mpcgpu_tpu_torch.models.chain import make_serial_chain, spatial_inertia
from mpcgpu_tpu_torch.models.robot import RobotModel


def _vec(s, default="0 0 0"):
    return np.array([float(v) for v in (s or default).split()], float)


def _rpy_matrix(rpy):
    """URDF fixed-axis rpy -> attitude matrix R = Rz(y) @ Ry(p) @ Rx(r)."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _align_to_z(a):
    """Proper rotation M with M @ a == e_z (coordinate map that makes the
    joint axis the local z axis)."""
    a = np.asarray(a, float)
    n = np.linalg.norm(a)
    if n == 0.0:
        raise ValueError("zero joint axis")
    a = a / n
    z = np.array([0.0, 0.0, 1.0])
    c = float(a @ z)
    if c > 1.0 - 1e-12:
        return np.eye(3)
    if c < -1.0 + 1e-12:
        # pi rotation about x maps -z to z
        return np.diag([1.0, -1.0, -1.0])
    v = np.cross(a, z)
    s2 = float(v @ v)
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    # Rodrigues for the rotation taking a to z
    return np.eye(3) + vx + vx @ vx * ((1.0 - c) / s2)


def _hom(R, p):
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = p
    return T


def _spatial_motion(T_ba):
    """Featherstone motion coordinate transform X such that v_A = X v_B for
    homogeneous ``T_ba`` = B-from-A (points: x_B = T_ba x_A)."""
    R_att = T_ba[:3, :3]        # ^B R _A
    p = T_ba[:3, 3]             # A origin in B coords
    E = R_att.T                 # coordinate map B -> A
    px, py, pz = p
    skew = np.array([[0, -pz, py], [pz, 0, -px], [-py, px, 0]])
    X = np.zeros((6, 6))
    X[:3, :3] = E
    X[3:, 3:] = E
    X[3:, :3] = -E @ skew
    return X


@dataclass
class _Link:
    name: str
    mass: float = 0.0
    com: np.ndarray = field(default_factory=lambda: np.zeros(3))
    inertia_com: np.ndarray = field(default_factory=lambda: np.zeros((3, 3)))


def _parse_link(el):
    lk = _Link(name=el.get("name"))
    inertial = el.find("inertial")
    if inertial is not None:
        mass_el = inertial.find("mass")
        lk.mass = float(mass_el.get("value")) if mass_el is not None else 0.0
        origin = inertial.find("origin")
        xyz = _vec(origin.get("xyz") if origin is not None else None)
        rpy = _vec(origin.get("rpy") if origin is not None else None)
        Ri = _rpy_matrix(rpy)
        iel = inertial.find("inertia")
        if iel is not None:
            g = lambda k: float(iel.get(k, "0"))
            I = np.array([
                [g("ixx"), g("ixy"), g("ixz")],
                [g("ixy"), g("iyy"), g("iyz")],
                [g("ixz"), g("iyz"), g("izz")],
            ])
        else:
            I = np.zeros((3, 3))
        lk.com = xyz
        lk.inertia_com = Ri @ I @ Ri.T      # rotate into the link frame
    return lk


def load_urdf(source: str, gravity: float = 0.0, dtype=torch.float32,
              ee_link: str | None = None, device="cuda") -> RobotModel:
    """Parse a URDF string or file path into a ``RobotModel``.

    Args:
      source: URDF XML text, or a filesystem path to it.
      gravity: base gravitational acceleration fed to RNEA (0 in the IIWA
        model the trackers use).
      ee_link: optional link whose frame origin is the end-effector point;
        defaults to the tip of the chain (after trailing fixed joints).
        Must be the last MOVABLE link or on the trailing fixed chain —
        the ee transform rides after the last joint frame, so a link with
        movable joints downstream of it has no fixed offset from that
        frame (raises ValueError rather than silently returning the tip).
      dtype, device: the model's tensors (the card unless asked otherwise).

    Raises ValueError for branching chains or unsupported joint types
    (prismatic / floating / planar): the supported class is the serial
    revolute arm.
    """
    text = source
    if "<" not in source:
        with open(source) as f:
            text = f.read()
    root = ET.fromstring(text)

    links = {el.get("name"): _parse_link(el) for el in root.findall("link")}
    joints = []
    for el in root.findall("joint"):
        jtype = el.get("type")
        if jtype not in ("revolute", "continuous", "fixed"):
            raise ValueError(f"unsupported joint type {jtype!r} "
                             f"(joint {el.get('name')!r})")
        origin = el.find("origin")
        parent = el.find("parent").get("link")
        child = el.find("child").get("link")
        axis_el = el.find("axis")
        joints.append(dict(
            name=el.get("name"), type=jtype, parent=parent, child=child,
            xyz=_vec(origin.get("xyz") if origin is not None else None),
            rpy=_vec(origin.get("rpy") if origin is not None else None),
            axis=_vec(axis_el.get("xyz") if axis_el is not None else "1 0 0"),
        ))

    children = {}
    child_links = set()
    for j in joints:
        children.setdefault(j["parent"], []).append(j)
        child_links.add(j["child"])
    roots = [n for n in links if n not in child_links]
    if len(roots) != 1:
        raise ValueError(f"expected one root link, found {roots}")
    for n, js in children.items():
        if len(js) > 1:
            raise ValueError(f"branching chain at link {n!r}; only serial "
                             "chains are supported")

    joint_rotations, joint_offsets, inertias = [], [], []
    # T_acc: last-internal-movable-frame-from-current-frame (homogeneous);
    # before the first joint the "movable frame" is the world/root frame
    T_acc = np.eye(4)
    ee_T = None
    link = roots[0]
    while link in children:
        (j,) = children[link]
        T_acc = T_acc @ _hom(_rpy_matrix(j["rpy"]), j["xyz"])
        link = j["child"]
        if j["type"] == "fixed":
            lk = links[link]
            if lk.mass != 0.0 and inertias:
                # lump the fixed link's inertia into the preceding movable
                # link: I_A = X^T I_B X with X = B-from-A motion transform
                X = _spatial_motion(T_acc)
                inertias[-1] = inertias[-1] + X.T @ spatial_inertia(
                    lk.mass, lk.com, lk.inertia_com) @ X
            elif lk.mass != 0.0:
                raise ValueError(
                    f"massive link {link!r} before the first movable joint")
            if ee_link is not None and link == ee_link:
                ee_T = T_acc.copy()
            continue
        if ee_T is not None:
            # ee_T is captured relative to the CURRENT movable frame but is
            # applied after the LAST joint frame; a movable joint downstream
            # of ee_link would make it silently wrong
            raise ValueError(
                f"ee_link {ee_link!r} has movable joint {j['name']!r} "
                f"downstream; ee_link must be the last movable link or on "
                f"the trailing fixed chain")
        M = _align_to_z(j["axis"])
        # library convention (models/chain.py): joint_rotations[k] is the
        # coordinate map parent-frame -> fixed (pre-rotation) frame; with
        # the internal axis alignment it becomes M @ (^prev' R _F)^T
        joint_rotations.append(M @ T_acc[:3, :3].T)
        joint_offsets.append(T_acc[:3, 3].copy())
        lk = links[link]
        inertias.append(spatial_inertia(
            lk.mass, M @ lk.com, M @ lk.inertia_com @ M.T))
        # new chain base: the internal child frame C' = M-aligned child frame
        T_acc = _hom(M, np.zeros(3))        # ^{C'} T _C  (x_C' = M x_C)
        if ee_link is not None and link == ee_link:
            ee_T = T_acc.copy()

    if not joint_rotations:
        raise ValueError("no movable joints found")
    if ee_link is not None and ee_T is None:
        raise ValueError(f"ee_link {ee_link!r} not on the serial chain")
    # default ee: the tip frame after trailing fixed joints
    ee = ee_T if ee_T is not None else T_acc
    # strip the pure internal-alignment transform when it is the identity
    # rotation chain tail (keeps hc bit-identical to make_serial_chain for
    # plain z-axis chains with no trailing fixed joints)
    if np.allclose(ee, np.eye(4)):
        ee = None

    return make_serial_chain(
        joint_rotations, joint_offsets, inertias,
        gravity=gravity, dtype=dtype, ee_transform=ee, device=device)


def _rpy_from_matrix(R):
    """Inverse of :func:`_rpy_matrix` (the branch of models/dynamics.fk_ee)."""
    roll = np.arctan2(R[2, 1], R[2, 2])
    pitch = -np.arctan2(R[2, 0], np.sqrt(R[2, 1] ** 2 + R[2, 2] ** 2))
    yaw = np.arctan2(R[1, 0], R[0, 0])
    return np.array([roll, pitch, yaw])


def export_urdf(model: RobotModel, name: str = "robot") -> str:
    """Serialize a ``RobotModel`` back to URDF text (the inverse of
    :func:`load_urdf` for the revolute-z chains this framework builds).

    Joint frames come from the q=0 transforms (all joints are revolute-z in
    model coordinates, so ``axis`` is always ``0 0 1``); inertials are
    decomposed back to (mass, com, I_com); a baked end-effector transform
    is emitted as a trailing fixed tool joint.  ``load_urdf(export_urdf(m))``
    reproduces ``m``'s dynamics exactly (tests/test_torch_urdf.py, on the
    IIWA-14 model).  The text is the JAX package's ``export_urdf`` text for
    the same arrays.
    """
    f64 = lambda t: t.detach().to(device="cpu", dtype=torch.float64).numpy()
    xc = f64(model.xc)
    xcos = f64(model.xcos)
    hc = f64(model.hc)
    hcos = f64(model.hcos)
    inertia = f64(model.inertia)
    nq = model.nq

    out = [f'<robot name="{name}">', '  <link name="base"/>']
    parent = "base"
    for k in range(nq):
        X0 = xc[k] + xcos[k]                  # motion transform at q=0
        R0 = X0[:3, :3]                       # coordinate map parent -> frame
        skew_p = -R0.T @ X0[3:, :3]
        p = np.array([skew_p[2, 1], skew_p[0, 2], skew_p[1, 0]])
        R_att = R0.T
        rpy = _rpy_from_matrix(R_att)

        I6 = inertia[k]
        mass = I6[5, 5]
        link = f'  <link name="l{k}"'
        if mass > 0.0:
            C = I6[:3, 3:] / mass
            com = np.array([C[2, 1], C[0, 2], C[1, 0]])
            Ic = I6[:3, :3] - mass * (C @ C.T)
            link = (
                f'  <link name="l{k}"><inertial>\n'
                f'    <origin xyz="{com[0]:.17g} {com[1]:.17g} {com[2]:.17g}"'
                f' rpy="0 0 0"/><mass value="{mass:.17g}"/>\n'
                f'    <inertia ixx="{Ic[0,0]:.17g}" iyy="{Ic[1,1]:.17g}"'
                f' izz="{Ic[2,2]:.17g}" ixy="{Ic[0,1]:.17g}"'
                f' ixz="{Ic[0,2]:.17g}" iyz="{Ic[1,2]:.17g}"/>\n'
                f'  </inertial></link>')
        else:
            link += "/>"
        out.append(link)
        out.append(
            f'  <joint name="j{k}" type="revolute">\n'
            f'    <origin xyz="{p[0]:.17g} {p[1]:.17g} {p[2]:.17g}"'
            f' rpy="{rpy[0]:.17g} {rpy[1]:.17g} {rpy[2]:.17g}"/>\n'
            f'    <axis xyz="0 0 1"/>\n'
            f'    <parent link="{parent}"/><child link="l{k}"/></joint>')
        parent = f"l{k}"

    # baked ee transform: hom chain tail beyond the joint frame
    T0 = hc[-1] + hcos[-1]                    # parent-from-child @ ee at q=0
    X0 = xc[-1] + xcos[-1]
    R_att = X0[:3, :3].T
    skew_p = -X0[:3, :3].T @ X0[3:, :3]
    p = np.array([skew_p[2, 1], skew_p[0, 2], skew_p[1, 0]])
    Tj = _hom(R_att, p)
    ee = np.linalg.solve(Tj, T0)
    if not np.allclose(ee, np.eye(4), atol=1e-12):
        rpy = _rpy_from_matrix(ee[:3, :3])
        out.append('  <link name="tool"/>')
        out.append(
            f'  <joint name="jee" type="fixed">\n'
            f'    <origin xyz="{ee[0,3]:.17g} {ee[1,3]:.17g} {ee[2,3]:.17g}"'
            f' rpy="{rpy[0]:.17g} {rpy[1]:.17g} {rpy[2]:.17g}"/>\n'
            f'    <parent link="{parent}"/><child link="tool"/></joint>')
    out.append("</robot>")
    return "\n".join(out)
