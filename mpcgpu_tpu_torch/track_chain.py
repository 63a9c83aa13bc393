"""Closed-loop MPC tracking of any revolute serial chain or URDF, on the card.

Counterpart of ``examples/track_chain.py`` for the port, with its flags and
defaults.  It builds a planar arm of ``--nq`` links (``models/chain.py``) or
loads a URDF (``--urdf PATH``; ``--urdf builtin:iiwa`` round-trips the IIWA-14
through ``export_urdf`` and ``load_urdf``), makes a reference trace from the
model's own dynamics (a smooth joint path, its inverse-dynamics torques by
``dynamics.rnea`` and its end-effector poses by ``dynamics.fk_ee``), and
tracks it closed-loop: the warm-started host loop (``simulate_mpc``) or, with
``--ondevice``, the loop as device work (``simulate_mpc_ondevice``).

Both loops run ``linsys="auto"``: on the card the kernels K1 -> K2 -> K3 and
the plant K4, built for the model's nq; on the CPU (``--device cpu``) their
plain versions.  (The JAX script's host loop runs ``linsys="pcg"``, the
plain PCG.)

Usage:  python -m mpcgpu_tpu_torch.track_chain [--nq 5] [--knots 16]
        [--steps 120] [--ondevice] [--urdf PATH | builtin:iiwa]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SimConfig, SQPConfig
from mpcgpu_tpu_torch.models import dynamics, iiwa14, planar_arm
from mpcgpu_tpu_torch.models.robot import RobotModel
from mpcgpu_tpu_torch.models.urdf import export_urdf, load_urdf
from mpcgpu_tpu_torch.sim.mpc import simulate_mpc, simulate_mpc_ondevice

DT = 1.0 / 64.0
COST = CostConfig(qd_cost=1e-4, r_cost=1e-4)
PCG = PCGConfig(max_iter=120, exit_tol=1e-7)
HOST_SQP = SQPConfig(max_iter=4)
DEVICE_SQP = SQPConfig(max_iter=2)
HOST_UPDATES = 600


def build_model(nq: int = 5, urdf: str | None = None, device="cuda",
                dtype=torch.float32) -> tuple[RobotModel, str]:
    """The tracked robot and a line that says where it came from."""
    if urdf == "builtin:iiwa":
        text = export_urdf(iiwa14(dtype=dtype, device="cpu"))
        return (load_urdf(text, dtype=dtype, device=device),
                "onboarded IIWA-14 via export_urdf -> load_urdf round trip")
    if urdf is not None:
        model = load_urdf(urdf, dtype=dtype, device=device)
        return model, f"onboarded {model.nq}-joint robot from {urdf}"
    return (planar_arm(nq=nq, link_len=0.4, link_mass=0.8, dtype=dtype,
                       device=device), f"planar arm of {nq} links")


def reference_trace(model: RobotModel, steps: int, dt: float = DT):
    """A dynamically consistent (x, u) trace of ``steps`` rows and its ee
    poses: a smooth joint path (cubic blend from 0.3 to 0.3 + linspace(0.8,
    -0.6)), the torques that realize it by inverse dynamics and the ee poses
    by forward kinematics, computed in the model's dtype on its device.
    Returns numpy (steps, 3 nq) and (steps, 6) arrays in that precision."""
    nq = model.nq
    q0 = 0.3 * np.ones(nq)
    q1 = q0 + np.linspace(0.8, -0.6, nq)
    t = np.linspace(0.0, 1.0, steps)
    blend = 3 * t**2 - 2 * t**3
    q_ref = q0[None, :] + blend[:, None] * (q1 - q0)[None, :]
    qd_ref = np.gradient(q_ref, dt, axis=0)
    qdd_ref = np.gradient(qd_ref, dt, axis=0)
    dev = model.xc.device
    as_t = lambda a: torch.tensor(a, dtype=model.dtype, device=dev)
    q, qd, qdd = as_t(q_ref), as_t(qd_ref), as_t(qdd_ref)
    u_ref = dynamics.rnea(model, q, qd, qdd)
    xu = torch.cat([q, qd, u_ref], dim=1)
    ee = dynamics.fk_ee(model, q)
    return xu.cpu().numpy(), ee.cpu().numpy()


def track(model: RobotModel, xu_traj, ee_traj, knots: int, ondevice: bool = False,
          max_updates: int | None = None, **route):
    """The tracker's closed loop: the host loop (4 SQP iterations a solve, at
    most HOST_UPDATES updates) or, ``ondevice``, the device loop (2 SQP
    iterations a solve, the whole trace), linsys "auto".  Returns the host
    loop's MPCStats or the device loop's dict.  ``route`` (linsys,
    merit_impl, ...) goes to the simulator."""
    if ondevice:
        sim = SimConfig() if max_updates is None else SimConfig(
            max_control_updates=max_updates)
        return simulate_mpc_ondevice(model, xu_traj, ee_traj, knots, DT,
                                     cost=COST, sqp_cfg=DEVICE_SQP, pcg_cfg=PCG,
                                     sim_cfg=sim, **route)
    sim = SimConfig(max_control_updates=HOST_UPDATES if max_updates is None
                    else max_updates)
    return simulate_mpc(model, xu_traj, ee_traj, knot_points=knots, timestep=DT,
                        cost=COST, sqp_cfg=HOST_SQP, pcg_cfg=PCG, sim_cfg=sim,
                        **route)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nq", type=int, default=5)
    ap.add_argument("--knots", type=int, default=16)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--ondevice", action="store_true")
    ap.add_argument("--urdf", default=None,
                    help="load the robot from a URDF file instead of the "
                    "planar arm; 'builtin:iiwa' round-trips the IIWA-14 "
                    "through export_urdf -> load_urdf")
    ap.add_argument("--device", default="cuda",
                    help="where the model and the loop live (default cuda)")
    args = ap.parse_args(argv)

    model, origin = build_model(args.nq, args.urdf, torch.device(args.device))
    print(origin)
    xu_traj, ee_traj = reference_trace(model, args.steps)
    nq = model.nq
    dev = model.xc.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)

    t0 = time.perf_counter()
    out = track(model, xu_traj, ee_traj, args.knots, ondevice=args.ondevice)
    if args.ondevice:
        errs = out["tracking_errors"].double().cpu().numpy()
        final = float(out["final_tracking_error"])
        sync()
        updates = int(out["control_updates"])
        wall_us = (time.perf_counter() - t0) * 1e6 / max(updates, 1)
        print(f"nq={nq} knots={args.knots} (on-device): {updates} control "
              f"steps, avg tracking err {errs.mean():.5f}, final {final:.5f}, "
              f"{wall_us:.1f} us per update (wall, with the set-up)")
        return 0
    s = out.summary()
    print(f"nq={nq} knots={args.knots}: {s['control_updates']} control steps, "
          f"avg tracking err {s['avg_tracking_error']:.5f}, "
          f"final {s['final_tracking_error']:.5f}, "
          f"avg PCG iters {s['avg_pcg_iters']:.1f}, "
          f"avg solve {s['avg_sqp_time_us']:.1f} us")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
