// K4: the plant rolled through one control period in one launch.
//
// Replaces the TPU kernel mpcgpu_tpu/sim/plant_pallas.py::
// simulate_plant_pallas (_make_plant_kernel).  From the state xs it runs
// n_steps + 1 substeps; substep i (offset off_i = sim_step * i) applies the
// plan's control of knot min(int((t_off + off_i) / timestep), N - 1), runs
// articulated-body forward dynamics and takes an explicit Euler step of
// length clip(sim_time - off_i, 0, sim_step): full substeps while time
// remains, one partial step, zero-length steps after, so a window sums to
// exactly sim_time (the clip schedule of sim/mpc.py::_simulate_plant).
//
// What bounds it on an H100: latency, nothing else.  The work is one serial
// chain of ~11 ABA passes at the default 2 ms period (~20 KFLOP each at
// NQ = 7) on NX + NQ N + 3 floats of input and the model's X matrices and
// inertias (144 NQ floats); no two substeps can overlap.  Design: one warp,
// the substep loop inside the kernel, the model in shared memory, and the ABA
// spread over the warp (common.cuh::aba_warp): per substep the NQ joint
// transforms and the links' bias terms are formed once, all at once,
// instead of in each of the three passes; the articulated-inertia pass
// spreads each link's 6x6 products over the lanes (the symmetric inertia by
// its upper triangle); the velocity and acceleration chains run on one lane
// from registers; each substep's controls are loaded a substep ahead.  One
// lane per joint: any NQ < 32 (common.cuh's static_assert).  The
// whole period is one launch, and the scalars (t_off, sim_time, timestep)
// are read on the device, so the caller never synchronizes.
//
// K4b, the same kernel over instances, replaces the TPU kernel vmapped over
// the instances of the batched closed loop (mpcgpu_tpu/sim/mpc.py::
// _ondevice_scan_batched_fused, sim/mpc.py:881-883): the instance is the
// grid's axis (block b rolls instance b's state under its own plan, the
// period's scalars shared), so each instance runs K4's body on its own SM
// and equals K4 bit for bit.
#include "common.cuh"

using namespace mpc;

namespace {

__global__ void __launch_bounds__(32)
plant_kernel(const float* __restrict__ xs, int xs_bstride,
             const float* __restrict__ plan, int plan_stride, int plan_bstride,
             int N, const float* __restrict__ t_off_p,
             const float* __restrict__ sim_time_p,
             const float* __restrict__ timestep_p, float sim_step, int n_steps,
             const float* __restrict__ model, float gravity,
             float* __restrict__ out) {
  __shared__ float sm[DYN_SIZE];      // ABA reads no 4x4 transform
  __shared__ float st[3 * NQ];        // q, qd, qdd
  __shared__ AbaWarpWs ws;
  load_model(sm, model, DYN_SIZE);
  const int lane = threadIdx.x;
  xs += (size_t)blockIdx.x * xs_bstride;
  plan += (size_t)blockIdx.x * plan_bstride;
  out += (size_t)blockIdx.x * NX;
  const float t_off = *t_off_p, sim_time = *sim_time_p, timestep = *timestep_p;
  // joint `lane`'s position, velocity and the control of the substep
  // (lanes 0..NQ-1); the next substep's control is loaded a substep ahead
  const auto control = [&](int i) {
    const float off = sim_step * static_cast<float>(i);
    const int idx = min(static_cast<int>((t_off + off) / timestep), N - 1);
    return lane < NQ ? plan[(size_t)idx * plan_stride + NX + lane] : 0.f;
  };
  float q = 0.f, qd = 0.f, u = control(0);
  if (lane < NQ) {
    q = xs[lane];
    qd = xs[NQ + lane];
  }
  for (int i = 0; i <= n_steps; ++i) {
    const float off = sim_step * static_cast<float>(i);
    const float u_next = i < n_steps ? control(i + 1) : 0.f;
    if (lane < NQ) {
      st[lane] = q;
      st[NQ + lane] = qd;
    }
    __syncwarp();
    aba_warp(sm, st, st + NQ, u, gravity, st + 2 * NQ, ws);
    const float dt = fminf(fmaxf(sim_time - off, 0.f), sim_step);
    if (lane < NQ) {
      q = q + dt * qd;
      qd = qd + dt * st[2 * NQ + lane];
    }
    u = u_next;
  }
  if (lane < NQ) {
    out[lane] = q;
    out[NQ + lane] = qd;
  }
}

}  // namespace

// batch instances, one block each: instance b's state xs + b xs_bstride,
// its plan + b plan_bstride (N rows of plan_stride floats), its result at
// out + b NX; t_off, sim_time and timestep are shared device scalars
extern "C" int plant_launch(const float* xs, int xs_bstride, const float* plan,
                            int plan_stride, int plan_bstride, int N,
                            const float* t_off, const float* sim_time,
                            const float* timestep, float sim_step, int n_steps,
                            const float* model, float gravity, float* out,
                            int batch, void* stream) {
  plant_kernel<<<batch, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      xs, xs_bstride, plan, plan_stride, plan_bstride, N, t_off, sim_time,
      timestep, sim_step, n_steps, model, gravity, out);
  return static_cast<int>(cudaGetLastError());
}
