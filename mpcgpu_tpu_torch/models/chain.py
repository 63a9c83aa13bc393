"""Serial-chain models made in code (revolute-z joints).

Port of ``mpcgpu_tpu/models/chain.py``.  Builds a ``RobotModel`` for any
serial chain of revolute-z joints from per-joint fixed tree transforms and
spatial inertias.  Every per-q spatial / homogeneous transform of such a
joint is affine in (sin q, cos q):

    X_k(q) = XJ(q) @ XT_k,   XJ = spatial rotation about local z,

so the affine decomposition (xc, xs, xcos) is recovered exactly from three
numeric evaluations (q = 0, pi/2, pi), in numpy at f64; the arrays then go
through ``RobotModel.from_numpy`` in the requested dtype, on the card unless
the caller asks for another device.  The dynamics, the kernels (built for
2 <= nq <= 7), the solvers and the simulators take the model's nq.
"""

from __future__ import annotations

import numpy as np
import torch

from mpcgpu_tpu_torch.models.robot import RobotModel


def _rotz(q):
    c, s = np.cos(q), np.sin(q)
    return np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])


def _spatial_xform(R, p):
    """Featherstone motion transform [R, 0; -R skew(p), R] (child from parent
    frame placed at p with orientation R)."""
    px, py, pz = p
    skew = np.array([[0.0, -pz, py], [pz, 0.0, -px], [-py, px, 0.0]])
    X = np.zeros((6, 6))
    X[:3, :3] = R
    X[3:, 3:] = R
    X[3:, :3] = -R @ skew
    return X


def _hom(R, p):
    """Homogeneous parent-from-child transform (for FK chaining T0 @ T1...)."""
    T = np.eye(4)
    T[:3, :3] = R.T
    T[:3, 3] = p
    return T


def _affine_decomp(f):
    """Exact (const, sin, cos) decomposition of an affine-in-(sin,cos) map."""
    f0, f90, f180 = f(0.0), f(np.pi / 2), f(np.pi)
    const = 0.5 * (f0 + f180)
    return const, f90 - const, f0 - const


def spatial_inertia(mass, com, I_com):
    """6x6 spatial inertia about the joint frame from mass, CoM offset, and
    the 3x3 rotational inertia about the CoM ([angular; linear] convention),
    as a numpy f64 array."""
    cx, cy, cz = com
    C = np.array([[0.0, -cz, cy], [cz, 0.0, -cx], [-cy, cx, 0.0]])
    I6 = np.zeros((6, 6))
    I6[:3, :3] = np.asarray(I_com) + mass * (C @ C.T)
    I6[:3, 3:] = mass * C
    I6[3:, :3] = mass * C.T
    I6[3:, 3:] = mass * np.eye(3)
    return I6


def make_serial_chain(joint_rotations, joint_offsets, inertias,
                      ee_offset=None, gravity: float = 0.0,
                      dtype=torch.float32, ee_transform=None,
                      device="cuda") -> RobotModel:
    """Build a RobotModel for a revolute-z serial chain.

    Args:
      joint_rotations: (nq, 3, 3) fixed rotation of joint k's frame relative
        to its parent's frame (applied before the joint rotation).
      joint_offsets: (nq, 3) position of joint k's origin in the parent frame.
      inertias: (nq, 6, 6) spatial inertias in each joint frame
        (see ``spatial_inertia``).
      ee_offset: optional (3,) end-effector point in the last joint frame,
        appended as the translation of the last homogeneous transform.
      ee_transform: optional (4, 4) full homogeneous last-frame-from-ee
        transform (e.g. a folded fixed tool joint, models/urdf.py); not
        together with ee_offset.
      dtype, device: the model's tensors (the card unless asked otherwise).
    """
    if ee_offset is not None and ee_transform is not None:
        raise ValueError("pass ee_offset or ee_transform, not both")
    nq = len(joint_offsets)
    xc, xs, xcos = [], [], []
    hc, hs, hcos = [], [], []
    for k in range(nq):
        R0 = np.asarray(joint_rotations[k], float)
        p = np.asarray(joint_offsets[k], float)
        XT = _spatial_xform(R0, p)

        def fx(q, XT=XT):
            return _spatial_xform(_rotz(q), np.zeros(3)) @ XT

        def fh(q, R0=R0, p=p):
            return _hom(R0, p) @ _hom(_rotz(q), np.zeros(3))

        for out, part in zip((xc, xs, xcos), _affine_decomp(fx)):
            out.append(part)
        for out, part in zip((hc, hs, hcos), _affine_decomp(fh)):
            out.append(part)

    if ee_offset is not None:
        ee_transform = np.eye(4)
        ee_transform[:3, 3] = np.asarray(ee_offset, float)
    if ee_transform is not None:
        ee = np.asarray(ee_transform, float)
        hc[-1] = hc[-1] @ ee
        hs[-1] = hs[-1] @ ee
        hcos[-1] = hcos[-1] @ ee

    return RobotModel.from_numpy(
        dict(xc=np.stack(xc), xs=np.stack(xs), xcos=np.stack(xcos),
             inertia=np.stack([np.asarray(i, float) for i in inertias]),
             hc=np.stack(hc), hs=np.stack(hs), hcos=np.stack(hcos)),
        device=device, dtype=dtype, gravity=gravity)


def planar_arm(nq: int = 3, link_len: float = 0.5, link_mass: float = 1.0,
               gravity: float = 0.0, dtype=torch.float32,
               device="cuda") -> RobotModel:
    """A simple nq-link arm: links along +x, all joints rotating about z."""
    rot = [np.eye(3)] * nq
    offs = [np.zeros(3)] + [np.array([link_len, 0.0, 0.0])] * (nq - 1)
    rod_I = np.diag([1e-4, link_mass * link_len**2 / 12.0,
                     link_mass * link_len**2 / 12.0])
    inertias = [spatial_inertia(link_mass, [link_len / 2, 0.0, 0.0], rod_I)
                for _ in range(nq)]
    return make_serial_chain(rot, offs, inertias,
                             ee_offset=[link_len, 0.0, 0.0],
                             gravity=gravity, dtype=dtype, device=device)
