"""The knot-sharded path across two processes over gloo, on the CPU.

Two worker processes (which import torch and never jax) initialize
``torch.distributed`` through ``initialize_distributed`` and build a
``DistKnotMesh``, one shard each: ring sends by ``batch_isend_irecv``, psum
by ``all_reduce``.  Each worker solves a small SPD block-tridiagonal system
with every sharded PCG method against a dense numpy solve, then one sharded
SQP solve at N = 16, f64 (unfused, and fused through the plain slab
versions), which must equal the same solve on a ``KnotMesh(2)`` in the same
process bit for bit: every collective is the same sum or copy of the same
two shards (a sum of two terms does not depend on its order)."""

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
                                       pcg_solve_sharded, sqp_solve_sharded)
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

coord, nproc, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
initialize_distributed(coord, num_processes=nproc, process_id=rank, device="cpu")
mesh = make_host_aligned_mesh()
assert (mesh.size, mesh.rank, mesh.backend) == (nproc, rank, "gloo")

# a small SPD block-tridiagonal system, the same on every process
N, n = 8, 4
rng = np.random.default_rng(0)
theta = np.stack([a @ a.T + 4.0 * np.eye(n) for a in rng.standard_normal((N, n, n))])
phi = 0.1 * rng.standard_normal((N, n, n))
phi[0] = 0.0
S = np.zeros((N, 3, n, n))
S[:, 1], S[:, 0] = theta, phi
S[:-1, 2] = np.swapaxes(phi[1:], -1, -2)
Pinv = np.zeros_like(S)
Pinv[:, 1] = np.linalg.inv(theta)
gamma = rng.standard_normal((N, n))
dense = np.zeros((N * n, N * n))
for k in range(N):
    dense[k * n:(k + 1) * n, k * n:(k + 1) * n] = theta[k]
    if k > 0:
        dense[k * n:(k + 1) * n, (k - 1) * n:k * n] = phi[k]
        dense[(k - 1) * n:k * n, k * n:(k + 1) * n] = phi[k].T
ref = np.linalg.solve(dense, gamma.ravel()).reshape(N, n)
t = torch.tensor
for method in ("classic", "pipelined", "pipelined_slab"):
    out = pcg_solve_sharded(t(S), t(Pinv), t(gamma), torch.zeros(N, n,
                            dtype=torch.float64), mesh, max_iter=100,
                            exit_tol=1e-20, method=method)
    assert bool(out.converged), method
    np.testing.assert_allclose(out.lam.numpy(), ref, rtol=0, atol=1e-10)

# one sharded SQP solve, equal to the one-process virtual mesh's bit for bit
Nq = 16
rng = np.random.default_rng(0)
xu = t(load_xu_traj("0_0")[350:350 + Nq] + 0.01 * rng.standard_normal((Nq, 21)))
ee = t(load_eepos_traj("0_0")[350:350 + Nq])
args = (iiwa14(torch.float64, device="cpu"), CostConfig.for_knots(Nq),
        SQPConfig(max_iter=2), PCGConfig(max_iter=60, exit_tol=1e-8), xu,
        torch.zeros((Nq, 14), dtype=torch.float64), xu[0, :14].clone(), ee,
        1e-3, 1 / 64)
for fused in (False, True):
    a = sqp_solve_sharded(*args, mesh, fused=fused, pcg_method="pipelined")
    b = sqp_solve_sharded(*args, KnotMesh(nproc), fused=fused,
                          pcg_method="pipelined")
    differ = [f for f in a._fields if not torch.equal(getattr(a, f), getattr(b, f))]
    assert not differ, (fused, differ)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "mpcgpu_tpu"))
assert not bad, bad
dist.destroy_process_group()
print(f"proc {rank}: distributed ok, sends {mesh.n_send} psums {mesh.n_psum}",
      flush=True)
"""


def test_two_process_gloo_knot_mesh(tmp_path):
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{sock.getsockname()[1]}"
    sock.close()
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, str(script), coord, "2", str(rank)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=env, text=True, cwd=ROOT)
             for rank in range(2)]
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
        assert "distributed ok" in out, out


def test_initialize_distributed_defaults_to_the_card(monkeypatch):
    """The entry point's default group runs on the card (NCCL); gloo only
    when a CPU run asks for it.  On the card each process first takes its
    own card, the local rank: ``LOCAL_RANK`` where a launcher sets it, else
    the process id modulo the visible cards; it becomes the current device
    before the group starts, and the group is bound to it.  The group
    itself is not started and no card is touched: the calls are
    recorded."""
    import torch
    import torch.distributed as dist

    from mpcgpu_tpu_torch.parallel import distributed

    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda dev: calls.append(("set_device", dev)))
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    distributed.initialize_distributed("localhost:29500", num_processes=2,
                                       process_id=1)
    distributed.initialize_distributed("localhost:29500", num_processes=2,
                                       process_id=0, device="cpu")
    distributed.initialize_distributed()         # one process: nothing
    card1 = torch.device("cuda", 1)
    assert calls == [
        ("set_device", card1),
        ("nccl", dict(init_method="tcp://localhost:29500", world_size=2,
                      rank=1, device_id=card1)),
        ("gloo", dict(init_method="tcp://localhost:29500", world_size=2,
                      rank=0))]
    # the process id modulo the visible cards, 6 % 4; LOCAL_RANK wins
    calls.clear()
    distributed.initialize_distributed("localhost:29500", num_processes=8,
                                       process_id=6)
    monkeypatch.setenv("LOCAL_RANK", "3")
    distributed.initialize_distributed("localhost:29500", num_processes=8,
                                       process_id=6)
    assert [c[1] for c in calls[0::2]] == [torch.device("cuda", 2),
                                          torch.device("cuda", 3)]
    assert [c[1]["device_id"] for c in calls[1::2]] == [
        torch.device("cuda", 2), torch.device("cuda", 3)]
    assert distributed.process_group_backend("cuda:0") == "nccl"
    with pytest.raises(ValueError, match="unsupported device"):
        distributed.process_group_backend("meta")
