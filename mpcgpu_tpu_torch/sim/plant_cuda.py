"""K4: the plant rolled through one control period in one launch; K4b: the
same over instances.

Port of ``mpcgpu_tpu/sim/plant_pallas.py::simulate_plant_pallas`` and of its
vmap over the instances of the batched closed loop
(``mpcgpu_tpu/sim/mpc.py:881-883``); the CUDA kernel is ``csrc/plant.cu``.
``simulate_plant`` runs the plain version ``simulate_plant_plain`` (the JAX
package's ``sim/mpc.py::_simulate_plant``) for CPU tensors and the kernel
for CUDA tensors; ``simulate_plant_batched`` runs ``simulate_plant_plain``
per instance for CPU tensors and the kernel over an instance grid for CUDA
tensors.  The kernel is built for the model's nq (2..7).
"""

from __future__ import annotations

import torch

from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.models import dynamics
from mpcgpu_tpu_torch.models.robot import RobotModel


def simulate_plant_plain(model: RobotModel, xs, xu_plan, time_offset_s,
                         sim_time_s, timestep, n_steps: int, sim_step: float):
    """Advance the plant from xs (nx,) by sim_time with xu_plan's controls.

    Mirrors simple_simulate (integrator.cuh:295-325): n_steps + 1 explicit
    Euler substeps; substep i applies the control of the plan knot whose
    window contains time_offset + i * sim_step and has length
    dt_i = clip(sim_time - i * sim_step, 0, sim_step), so any
    sim_time <= (n_steps + 1) * sim_step integrates exactly.  The scalars may
    be floats or 0-d tensors; nothing is read back to the host.
    """
    nq = model.nq
    N = xu_plan.shape[0]
    dev, dtype = xs.device, xs.dtype
    t_off = _kernels.scalar(time_offset_s, dev, dtype)
    sim_time = _kernels.scalar(sim_time_s, dev, dtype)
    step = _kernels.scalar(timestep, dev, dtype)
    offsets = sim_step * torch.arange(n_steps + 1, dtype=dtype, device=dev)
    idx = torch.clamp(((t_off + offsets) / step).to(torch.int64), max=N - 1)
    us = xu_plan[:, 2 * nq:].index_select(0, idx)
    dts = torch.clamp(sim_time - offsets, 0.0, sim_step)
    q, qd = xs[:nq], xs[nq:]
    for i in range(n_steps + 1):
        qdd = dynamics.forward_dynamics_aba(model, q, qd, us[i])
        q, qd = q + dts[i] * qd, qd + dts[i] * qdd
    return torch.cat([q, qd])


def _launch(model: RobotModel, xs, xu_plan, time_offset_s, sim_time_s,
            timestep, n_steps: int, sim_step: float):
    """K4 over the leading instance axis of xs (B, nx) and xu_plan (B, N,
    nx + nu); returns (B, nx)."""
    dev = xs.device
    B, N = xu_plan.shape[:2]
    nq = model.nq
    nx, w = 2 * nq, 3 * nq
    _kernels.require_nq(nq)
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    _kernels.require_knots(N)
    _kernels.require(xs, "xs", (B, nx), dev, row_major=True)
    if tuple(xu_plan.shape) != (B, N, w) or xu_plan.stride(2) != 1:
        raise ValueError(f"xu_plan: ({B}, {N}, {w}) with rows of unit stride")
    _kernels.require(xu_plan[0], "xu_plan", (N, w), dev, row_major=True)
    packed = model.packed()
    _kernels.require(packed, "model", (packed.numel(),), dev)
    scal = [_kernels.scalar(v, dev) for v in (time_offset_s, sim_time_s, timestep)]
    out = torch.empty((B, nx), dtype=torch.float32, device=dev)
    _kernels.launch(
        dev, "plant.cu", "plant_launch", nq,
        xs.data_ptr(), xs.stride(0), xu_plan.data_ptr(), xu_plan.stride(1),
        xu_plan.stride(0), N, *(t.data_ptr() for t in scal), float(sim_step),
        int(n_steps), packed.data_ptr(), float(model.gravity), out.data_ptr(), B)
    return out


def simulate_plant(model: RobotModel, xs, xu_plan, time_offset_s, sim_time_s,
                   timestep, n_steps: int, sim_step: float):
    """K4: ``simulate_plant_plain`` in one launch.  xs (nx,), xu_plan
    (N, nx+nu) with N <= 512; time_offset_s, sim_time_s and timestep may be
    floats or 0-d tensors (never read back); n_steps and sim_step are the
    static substep budget."""
    if _kernels.on_cpu(xs):
        return simulate_plant_plain(model, xs, xu_plan, time_offset_s,
                                    sim_time_s, timestep, n_steps, sim_step)
    out = _launch(model, xs[None], xu_plan[None], time_offset_s, sim_time_s,
                  timestep, n_steps, sim_step)[0]
    simulate_plant.launches += 1
    return out


def simulate_plant_batched_plain(model: RobotModel, xs_b, plans, time_offset_s,
                                 sim_time_s, timestep, n_steps: int,
                                 sim_step: float):
    """K4b's plain version: ``simulate_plant_plain`` per instance, stacked."""
    return torch.stack([simulate_plant_plain(model, xs_b[i], plans[i],
                                             time_offset_s, sim_time_s,
                                             timestep, n_steps, sim_step)
                        for i in range(xs_b.shape[0])])


def simulate_plant_batched(model: RobotModel, xs_b, plans, time_offset_s,
                           sim_time_s, timestep, n_steps: int, sim_step: float):
    """K4b: B plants rolled through the same window in one launch, each as
    K4 rolls one.  xs_b (B, nx), plans (B, N, nx+nu); the window's scalars
    as ``simulate_plant``'s, shared by the instances.  Returns (B, nx)."""
    if _kernels.on_cpu(xs_b):
        return simulate_plant_batched_plain(model, xs_b, plans, time_offset_s,
                                            sim_time_s, timestep, n_steps,
                                            sim_step)
    out = _launch(model, xs_b, plans, time_offset_s, sim_time_s, timestep,
                  n_steps, sim_step)
    simulate_plant_batched.launches += 1
    return out


simulate_plant.launches = 0
simulate_plant_batched.launches = 0
