"""The instance axis across processes over gloo, on the CPU.

The worker processes (which import torch and never jax) build
``make_host_aligned_mesh(n_knot_per_host)``: an (instance, knot) grid,
every knot axis on a process group of its own: two processes of one knot
shard each (two instance groups), and four processes of two knot shards
each (two instance groups).  Each worker solves its instance slab of a B =
4 batch (IIWA-14, N = 16, f64) through ``sqp_solve_batched_fused_sharded``;
the slabs, gathered, equal the unsharded ``sqp_solve_batched_fused`` bit
for bit.  A knot-sharded SQP over the worker's knot axis (its own group:
ring sends to the group's ranks, psums within it) equals the same solve on
a ``KnotMesh`` of that many shards, bit for bit."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SQPConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.parallel import (KnotMesh, initialize_distributed,
                                       make_host_aligned_mesh,
                                       sqp_solve_batched_fused,
                                       sqp_solve_batched_fused_sharded,
                                       sqp_solve_sharded)
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

coord, nproc, rank, knots = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
initialize_distributed(coord, num_processes=nproc, process_id=rank, device="cpu")
mesh = make_host_aligned_mesh(n_knot_per_host=knots)
assert mesh.shape == {"instance": nproc // knots, "knot": knots}, mesh.shape
assert (mesh.instance, mesh.rank, mesh.size, mesh.backend) == (
    rank // knots, rank % knots, knots, "gloo")

B, N = 4, 16
rng = np.random.default_rng(0)
xu = load_xu_traj("0_0")[350:350 + N][None] + 0.02 * rng.standard_normal((B, N, 21))
ee = np.broadcast_to(load_eepos_traj("0_0")[350:350 + N], (B, N, 6)).copy()
t = torch.tensor
args = (iiwa14(torch.float64, device="cpu"), CostConfig.for_knots(N),
        SQPConfig(max_iter=2), PCGConfig(max_iter=60, exit_tol=1e-8), t(xu),
        torch.zeros((B, N, 14), dtype=torch.float64), t(xu[:, 0, :14].copy()),
        t(ee), t(1e-3 * (1 + np.arange(B))), 1 / 64)
local = sqp_solve_batched_fused_sharded(*args, mesh)
assert local.xu.shape[0] == B // mesh.n_instance
ref = sqp_solve_batched_fused(*args)
differ = []
for f in ref._fields:
    v = getattr(local, f).contiguous()
    parts = [torch.empty_like(v) for _ in range(nproc)]
    dist.all_gather(parts, v)          # every rank's slab, knot ranks repeat it
    if not torch.equal(torch.cat(parts[::knots]), getattr(ref, f)):
        differ.append(f)
assert not differ, differ

# each instance group's knot-sharded solve of its own first problem
i = mesh.instance * (B // mesh.n_instance)
one = (args[0], args[1], args[2], args[3], args[4][i], args[5][i], args[6][i],
       args[7][i], 1e-3, 1 / 64)
for method in ("pipelined_slab", "pipelined"):
    a = sqp_solve_sharded(*one, mesh, fused=method.endswith("slab"), pcg_method=method)
    b = sqp_solve_sharded(*one, KnotMesh(knots), fused=method.endswith("slab"),
                          pcg_method=method)
    assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in a._fields), method
assert mesh.n_psum > 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "mpcgpu_tpu"))
assert not bad, bad
dist.destroy_process_group()
print(f"proc {rank}: instance axis ok, psums {mesh.n_psum}", flush=True)
"""


@pytest.mark.parametrize("nproc,knots", [(2, 1), (4, 2)])
def test_gloo_instance_mesh(tmp_path, nproc, knots):
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{sock.getsockname()[1]}"
    sock.close()
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, str(script), coord, str(nproc),
                               str(rank), str(knots)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=env, text=True, cwd=ROOT)
             for rank in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {rank} failed:\n{out}"
        assert "instance axis ok" in out, out
