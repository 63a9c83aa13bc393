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
// chain of ~11 ABA passes at the default 2 ms period (~20 KFLOP each) on
// 14 + 7 N + 3 floats of input and the model's X matrices and inertias
// (1008 floats); no two substeps can overlap.  Design: one
// block, the substep loop inside the kernel, one thread running the ABA of
// common.cuh (one running articulated inertia) on the model in shared
// memory.  Its value is that the whole period is one launch instead of one
// per substep, and that the scalars (t_off, sim_time, timestep) are read on
// the device, so the caller never synchronizes.
#include "common.cuh"

using namespace mpc;

namespace {

__global__ void __launch_bounds__(32)
plant_kernel(const float* __restrict__ xs, const float* __restrict__ plan,
             int plan_stride, int N, const float* __restrict__ t_off_p,
             const float* __restrict__ sim_time_p,
             const float* __restrict__ timestep_p, float sim_step, int n_steps,
             const float* __restrict__ model, float gravity,
             float* __restrict__ out) {
  __shared__ float sm[DYN_SIZE];      // ABA reads no 4x4 transform
  load_model(sm, model, DYN_SIZE);
  __syncthreads();
  if (threadIdx.x != 0) return;
  const float t_off = *t_off_p, sim_time = *sim_time_p, timestep = *timestep_p;
  float q[NQ], qd[NQ], s[NQ], c[NQ], qdd[NQ];
  for (int j = 0; j < NQ; ++j) {
    q[j] = xs[j];
    qd[j] = xs[NQ + j];
  }
  for (int i = 0; i <= n_steps; ++i) {
    const float off = sim_step * static_cast<float>(i);
    const int idx = min(static_cast<int>((t_off + off) / timestep), N - 1);
    const float* u = plan + (size_t)idx * plan_stride + NX;
    for (int j = 0; j < NQ; ++j) {
      s[j] = sinf(q[j]);
      c[j] = cosf(q[j]);
    }
    aba(sm, s, c, qd, u, gravity, qdd);
    const float dt = fminf(fmaxf(sim_time - off, 0.f), sim_step);
    for (int j = 0; j < NQ; ++j) {
      q[j] = q[j] + dt * qd[j];
      qd[j] = qd[j] + dt * qdd[j];
    }
  }
  for (int j = 0; j < NQ; ++j) {
    out[j] = q[j];
    out[NQ + j] = qd[j];
  }
}

}  // namespace

extern "C" int plant_launch(const float* xs, const float* plan,
                            int plan_stride, int N, const float* t_off,
                            const float* sim_time, const float* timestep,
                            float sim_step, int n_steps, const float* model,
                            float gravity, float* out, void* stream) {
  plant_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      xs, plan, plan_stride, N, t_off, sim_time, timestep, sim_step, n_steps,
      model, gravity, out);
  return static_cast<int>(cudaGetLastError());
}
