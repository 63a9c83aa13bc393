#!/usr/bin/env python3
"""What a thread-block cluster's synchronisation costs on the card, and one
warp-parallel ABA (common.cuh::aba_warp), in SM clock cycles.

    python3 tools/torch_port_sync_microbench.py

Builds a small CUDA program with nvcc (into mpcgpu_tpu_torch/_build/) and
prints, for clusters of 1..16 CTAs of 128 and 448 threads (K2's CTA sizes
at N = 64 and N = 512), the cycles per loop iteration of: a cluster barrier
with release/acquire (``cg::cluster_group::sync``), a relaxed cluster
barrier (``barrier.cluster.arrive.relaxed`` + ``wait``), ``__syncthreads``,
one remote store plus a cluster barrier, C remote loads plus
``__syncthreads``, and a block-wide sum (warp shuffles, ``__syncthreads``,
warp 0's shuffles); then the cycles of one ``aba_warp`` call on one warp.
These are the costs that K2's round structure (csrc/pcg_dz.cu) and K4's
warp ABA (csrc/plant.cu) are designed around.  Needs nvcc and a card of
compute capability 9.0.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = r'''
#include <cooperative_groups.h>
#include <cstdio>
#include "common.cuh"
using namespace mpc;
namespace cg = cooperative_groups;

__global__ void sync_bench(int mode, int iters, long long* out) {
  extern __shared__ float sh[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = cluster.num_blocks(), rank = cluster.block_rank();
  float acc = 0.f;
  float* nb = cluster.map_shared_rank(sh, (rank + 1) % C);
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) sh[i] = 1.0f;
  cluster.sync();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    if (mode == 0) {
      cluster.sync();
    } else if (mode == 1) {
      asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    } else if (mode == 2) {
      __syncthreads();
    } else if (mode == 3) {
      if (threadIdx.x < 14) nb[threadIdx.x + 16 * (it & 1)] = acc;
      cluster.sync();
      acc += sh[threadIdx.x & 15];
    } else if (mode == 4) {
      float s = 0.f;
      for (int q = 0; q < C; ++q) s += *cluster.map_shared_rank(sh + (it & 7), q);
      acc += s;
      __syncthreads();
    } else {
      float a = acc + threadIdx.x;
      for (int o = 16; o > 0; o >>= 1) a += __shfl_down_sync(0xffffffffu, a, o);
      if ((threadIdx.x & 31) == 0) sh[1024 + (threadIdx.x >> 5)] = a;
      __syncthreads();
      if (threadIdx.x < 32) {
        a = threadIdx.x < (blockDim.x >> 5) ? sh[1024 + threadIdx.x] : 0.f;
        for (int o = 16; o > 0; o >>= 1) a += __shfl_down_sync(0xffffffffu, a, o);
        if (threadIdx.x == 0) sh[2000] = a;
      }
      __syncthreads();
      acc += sh[2000] * 1e-30f;
    }
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0 && rank == 0) out[mode] = (t1 - t0) / iters;
  if (acc == 12345.f) out[10] = 1;
  cluster.sync();
}

__global__ void aba_bench(const float* model, int iters, long long* out) {
  __shared__ float sm[DYN_SIZE];
  __shared__ float st[3 * NQ];
  __shared__ AbaWarpWs ws;
  const int lane = threadIdx.x;
  load_model(sm, model, DYN_SIZE);
  if (lane < NQ) {
    st[lane] = 0.1f * lane;
    st[NQ + lane] = 0.2f;
  }
  __syncwarp();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    aba_warp(sm, st, st + NQ, 1.0f, -9.81f, st + 2 * NQ, ws);
    if (lane < NQ) st[NQ + lane] += 1e-6f * st[2 * NQ + lane];
    __syncwarp();
  }
  if (lane == 0) out[0] = (clock64() - t0) / iters;
}

int main() {
  long long* out;
  cudaMallocManaged(&out, 64 * sizeof(long long));
  const char* names[6] = {"cluster.sync (release/acquire)", "relaxed cluster barrier",
                          "__syncthreads", "remote store + cluster.sync",
                          "C remote loads + __syncthreads", "block sum"};
  cudaFuncSetAttribute(sync_bench, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaFuncSetAttribute(sync_bench, cudaFuncAttributeMaxDynamicSharedMemorySize, 40000);
  for (int C : {1, 2, 4, 8, 16})
    for (int nth : {128, 448}) {
      for (int mode = 0; mode < 6; ++mode) {
        cudaLaunchConfig_t cfg = {};
        cudaLaunchAttribute attr[1];
        cfg.gridDim = dim3(C, 1, 1);
        cfg.blockDim = dim3(nth, 1, 1);
        cfg.dynamicSmemBytes = 40000;
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = C;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        if (cudaLaunchKernelEx(&cfg, sync_bench, mode, 2000, out) != cudaSuccess ||
            cudaDeviceSynchronize() != cudaSuccess) {
          printf("launch failed\n");
          return 1;
        }
      }
      printf("C=%2d, %3d threads: cycles per iteration:", C, nth);
      for (int mode = 0; mode < 6; ++mode) printf(" %s %lld;", names[mode], out[mode]);
      printf("\n");
    }
  float* model;
  cudaMallocManaged(&model, MODEL_SIZE * sizeof(float));
  for (int i = 0; i < MODEL_SIZE; ++i) model[i] = 0.01f * ((i * 37) % 11) + (i % 7 == 0);
  aba_bench<<<1, 32>>>(model, 200, out);
  if (cudaDeviceSynchronize() != cudaSuccess) return 1;
  int khz;
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  printf("aba_warp: %lld cycles per call (one warp); SM clock %d MHz\n", out[0], khz / 1000);
  return 0;
}
'''


def main():
    sys.path.insert(0, str(ROOT))
    from mpcgpu_tpu_torch import _kernels

    out = ROOT / "mpcgpu_tpu_torch" / "_build" / "microbench"
    out.mkdir(parents=True, exist_ok=True)
    (out / "sync_bench.cu").write_text(SRC)
    exe = out / "sync_bench"
    subprocess.run([_kernels.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-I", str(ROOT / "mpcgpu_tpu_torch" / "csrc"),
                    "-o", str(exe), str(out / "sync_bench.cu")], check=True)
    sys.exit(subprocess.run([str(exe)]).returncode)


if __name__ == "__main__":
    main()
