"""The multi-process paths of the port on the CPU, over gloo.

Two worker processes (which import torch and never jax) start
``torch.distributed`` and run what runs on four cards over NCCL, one
process per card:

* the knot-sharded closed loop, ``simulate_mpc_ondevice(knot_mesh=
  make_host_aligned_mesh())`` (N = 16 over 2 processes, f64, 16 updates),
  equal to the same loop on ``KnotMesh(2)`` in the worker bit for bit
  (every collective a sum of two terms or a copy) and held to the JAX
  package's ``simulate_mpc_ondevice(knot_mesh=make_mesh(1, 2))`` on the
  suite's virtual CPU devices within 1e-9, as tests/test_torch_mpc_sharded.py
  holds the one-process loops;
* the fleet over the instance axis,
  ``simulate_mpc_ondevice_batched(instance_mesh=make_host_aligned_mesh(1))``:
  each process's slab of B = 2 equals the same rows of the unsharded loop;
* the tracker's ``--knot-shards 2`` launched as ``torch.distributed.run``
  launches it (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT`` set): only rank 0 prints, and every rank's path equals
  the one-process tracker's over a virtual mesh of 2 bit for bit.

The PCG is capped at 20 iterations (the sharded forms enqueue their whole
cap, each iteration a gloo psum and two sends) and the JAX oracle and the
one-process runs go while the workers run, to keep each test short.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.config import PCGConfig as JPCGConfig
from mpcgpu_tpu.config import SimConfig as JSimConfig
from mpcgpu_tpu.config import SQPConfig as JSQPConfig
from mpcgpu_tpu.models import iiwa14 as jiiwa14
from mpcgpu_tpu.parallel.mesh import make_mesh as jmake_mesh
from mpcgpu_tpu.sim.mpc import simulate_mpc_ondevice as jsimulate_mpc_ondevice
from mpcgpu_tpu_torch import track_iiwa_pcg
from mpcgpu_tpu_torch.parallel import KnotMesh
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

ROOT = Path(__file__).resolve().parents[1]
N, UPDATES, ROWS, CAP = 16, 16, 80, 20
TIMEOUT = 240

_LOOP_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from mpcgpu_tpu_torch.config import PCGConfig, SimConfig, SQPConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.parallel import (KnotMesh, initialize_distributed,
                                       make_host_aligned_mesh)
from mpcgpu_tpu_torch.sim.mpc import (simulate_mpc_ondevice,
                                      simulate_mpc_ondevice_batched)
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

coord, nproc, rank, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
N, UPDATES, ROWS, CAP = (int(a) for a in sys.argv[5:9])
initialize_distributed(coord, num_processes=nproc, process_id=rank, device="cpu")
model = iiwa14(torch.float64, device="cpu")
xu, ee = load_xu_traj("0_0")[:ROWS], load_eepos_traj("0_0")[:ROWS]
kw = dict(sqp_cfg=SQPConfig(max_iter=2, max_time_us=None),
          pcg_cfg=PCGConfig(max_iter=CAP, exit_tol=1e-8),
          sim_cfg=SimConfig(max_control_updates=UPDATES))
keys = ("tracking_errors", "xs_path", "sqp_iters", "pcg_iters",
        "final_tracking_error")
mesh = make_host_aligned_mesh()
got = simulate_mpc_ondevice(model, xu, ee, N, 1 / 64, knot_mesh=mesh, **kw)
ref = simulate_mpc_ondevice(model, xu, ee, N, 1 / 64, knot_mesh=KnotMesh(nproc), **kw)
differ = [k for k in keys if not torch.equal(got[k], ref[k])]
assert not differ, differ
assert got["control_updates"] == UPDATES and mesh.n_psum > 0 and mesh.n_send > 0

# the fleet: this process's slab of B instances, no collective
B = 2
kw["sim_cfg"] = SimConfig(max_control_updates=4)
mine = simulate_mpc_ondevice_batched(model, xu, ee, N, 1 / 64, B,
                                     instance_mesh=make_host_aligned_mesh(1), **kw)
whole = simulate_mpc_ondevice_batched(model, xu, ee, N, 1 / 64, B, **kw)
rows = slice(rank * B // nproc, (rank + 1) * B // nproc)
for k in ("tracking_errors", "final_tracking_error"):
    assert torch.equal(mine[k], whole[k][rows]), k
assert torch.equal(mine["shift_mask"], whole["shift_mask"])
np.savez(out, **{k: got[k].numpy() for k in keys})
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "mpcgpu_tpu"))
assert not bad, bad
dist.destroy_process_group()
print(f"proc {rank}: multicard loop ok", flush=True)
"""

_TRACKER_WORKER = r"""
import sys
import torch

torch.set_num_threads(1)
from mpcgpu_tpu_torch import track_iiwa_pcg
from mpcgpu_tpu_torch.parallel import DistKnotMesh

track_iiwa_pcg.PCGConfig.tuned_max_iter = staticmethod(lambda knots: 10)
real, runs = track_iiwa_pcg.simulate_mpc_ondevice, []


def recording(*args, **kw):
    assert isinstance(kw["knot_mesh"], DistKnotMesh), kw["knot_mesh"]
    runs.append(real(*args, **kw))
    return runs[-1]


track_iiwa_pcg.simulate_mpc_ondevice = recording
track_iiwa_pcg.main(sys.argv[2:])
torch.save(runs[-1]["xs_path"], sys.argv[1])
"""

TRACKER_ARGS = ["--device", "cpu", "--knots", "2", "--steps", "3", "--tols",
                "1e-5", "--ondevice", "--knot-shards", "2"]


def _free_port() -> int:
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def _start(cmds, envs) -> list:
    """Start the worker commands together."""
    return [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             env=env, text=True, cwd=ROOT)
            for cmd, env in zip(cmds, envs)]


def _wait(procs) -> list:
    """Every worker must exit 0 within TIMEOUT s (all are killed
    otherwise).  Returns their outputs."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {rank} failed:\n{out}"
    return outs


def test_knot_sharded_loop_and_fleet_over_two_processes(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    script = tmp_path / "worker.py"
    script.write_text(_LOOP_WORKER)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = _start([[sys.executable, str(script), coord, "2", str(rank),
                     str(tmp_path / f"rank{rank}.npz"), str(N), str(UPDATES),
                     str(ROWS), str(CAP)] for rank in range(2)], [env, env])
    try:
        ref = jsimulate_mpc_ondevice(
            jiiwa14(jnp.float64), load_xu_traj("0_0")[:ROWS],
            load_eepos_traj("0_0")[:ROWS], N, 1.0 / 64.0,
            sqp_cfg=JSQPConfig(max_iter=2, max_time_us=None),
            pcg_cfg=JPCGConfig(max_iter=CAP, exit_tol=1e-8),
            sim_cfg=JSimConfig(max_control_updates=UPDATES), dtype=jnp.float64,
            knot_mesh=jmake_mesh(1, 2), pcg_method="pipelined")
    finally:
        outs = _wait(procs)
    assert all("multicard loop ok" in o for o in outs), outs
    got = [np.load(tmp_path / f"rank{rank}.npz") for rank in range(2)]
    for k in got[0].files:                   # every rank's path the same bits
        assert np.array_equal(got[0][k], got[1][k]), k
    assert np.array_equal(got[0]["sqp_iters"], np.asarray(ref["sqp_iters"]))
    assert len(got[0]["tracking_errors"]) == len(ref["tracking_errors"]) >= 2
    for k in ("tracking_errors", "xs_path"):
        np.testing.assert_allclose(got[0][k], np.asarray(ref[k]), rtol=0, atol=1e-9)


def test_tracker_knot_shards_under_torch_distributed_run(tmp_path, capsys,
                                                          monkeypatch):
    """--knot-shards 2 in two processes with torch.distributed.run's
    environment (the PCG cut to 10 iterations, as
    tests/test_torch_mpc_sharded.py's one-process tracker test)."""
    script = tmp_path / "tracker.py"
    script.write_text(_TRACKER_WORKER)
    port = str(_free_port())
    envs = [dict(os.environ, PYTHONPATH=str(ROOT), WORLD_SIZE="2", RANK=str(r),
                 LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
            for r in range(2)]
    procs = _start([[sys.executable, str(script), str(tmp_path / f"xs{r}.pt"),
                     *TRACKER_ARGS] for r in range(2)], envs)
    try:
        one, runs = _one_process_tracker(capsys, monkeypatch)
    finally:
        outs = _wait(procs)
    assert "tol=1e-05: 24 control steps" in outs[0], outs[0]
    assert "control steps" not in outs[1], outs[1]
    tail = lambda out: out.split("us/step), ")[1]   # the errors, not the time
    assert tail(outs[0]) == tail(one), (outs[0], one)
    for r in range(2):
        assert torch.equal(torch.load(tmp_path / f"xs{r}.pt"), runs[-1]["xs_path"])


def _one_process_tracker(capsys, monkeypatch):
    """The tracker's --knot-shards 2 in this process (a virtual mesh):
    (its output, its runs)."""
    monkeypatch.setattr(track_iiwa_pcg.PCGConfig, "tuned_max_iter",
                        staticmethod(lambda knots: 10))
    real, runs = track_iiwa_pcg.simulate_mpc_ondevice, []

    def recording(*args, **kw):
        assert isinstance(kw["knot_mesh"], KnotMesh)
        runs.append(real(*args, **kw))
        return runs[-1]

    monkeypatch.setattr(track_iiwa_pcg, "simulate_mpc_ondevice", recording)
    track_iiwa_pcg.main(TRACKER_ARGS)
    return capsys.readouterr().out, runs


def test_tracker_refuses_a_process_count_it_cannot_shard(monkeypatch):
    """Under torch.distributed.run the knot axis is the processes: any other
    --knot-shards is refused before a group starts."""
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(SystemExit):
        track_iiwa_pcg.main(TRACKER_ARGS)
