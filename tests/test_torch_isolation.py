"""The port stands on its own: it imports neither jax nor any file of the
mpcgpu_tpu package, its entry points default to the card, and its GPU smoke
test refuses to run without a CUDA device."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

# a few control updates of the closed loop on the CPU, then every loaded
# module's file is checked: none may lie under mpcgpu_tpu/ (a module loaded
# by file path under another name would pass a check of names alone)
_CLOSED_LOOP = """
import sys
from pathlib import Path
import torch
torch.set_num_threads(1)
from mpcgpu_tpu_torch.config import PCGConfig, SimConfig, SQPConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.sim.mpc import simulate_mpc
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj
stats = simulate_mpc(iiwa14(torch.float64, device="cpu"), load_xu_traj("0_0")[:20],
                     load_eepos_traj("0_0")[:20], 8, 1 / 64,
                     sqp_cfg=SQPConfig(max_iter=1), pcg_cfg=PCGConfig(max_iter=20),
                     sim_cfg=SimConfig(max_control_updates=3))
assert stats.summary()["control_updates"] == 3
# the direct solvers (the host LDL^T among them) and the batched solve
from mpcgpu_tpu_torch.config import CostConfig
from mpcgpu_tpu_torch.parallel import make_batched_sqp_solver
m = iiwa14(torch.float64, device="cpu")
xu = torch.tensor(load_xu_traj("0_0")[:4])
ee = torch.tensor(load_eepos_traj("0_0")[:4])
for linsys in ("ldl", "pcr", "pcr_cuda", "qdldl_host"):
    stats = simulate_mpc(m, load_xu_traj("0_0")[:20], load_eepos_traj("0_0")[:20],
                         4, 1 / 64, sqp_cfg=SQPConfig(max_iter=1), linsys=linsys,
                         sim_cfg=SimConfig(max_control_updates=1))
    assert stats.summary()["control_updates"] == 1
res = make_batched_sqp_solver(m, CostConfig.for_knots(4), SQPConfig(max_iter=1),
                              PCGConfig(max_iter=5), 1 / 64, fused=True)(
    xu[None], torch.zeros((1, 4, 14), dtype=torch.float64), xu[None, 0, :14],
    ee[None], torch.full((1,), 1e-3, dtype=torch.float64))
assert res.xu.shape == (1, 4, 21)
# the knot-sharded path: the closed loop over a virtual mesh through the
# slab kernels' plain versions, and the modules of the distributed mesh
from mpcgpu_tpu_torch.parallel import DistKnotMesh, KnotMesh
from mpcgpu_tpu_torch.sim.mpc import simulate_mpc_ondevice
run = simulate_mpc_ondevice(m, load_xu_traj("0_0")[:20], load_eepos_traj("0_0")[:20],
                            4, 1 / 64, sqp_cfg=SQPConfig(max_iter=1),
                            pcg_cfg=PCGConfig(max_iter=5),
                            sim_cfg=SimConfig(max_control_updates=2),
                            knot_mesh=KnotMesh(2), fused=True,
                            pcg_method="pipelined_slab")
assert run["control_updates"] == 2
# the s-step sharded PCG (K10b and the coefficient step's plain versions)
# at L = 9 >= 2s+1, and the batched closed loop (K4b's plain version)
run = simulate_mpc_ondevice(m, load_xu_traj("0_0")[:40], load_eepos_traj("0_0")[:40],
                            18, 1 / 64, sqp_cfg=SQPConfig(max_iter=1),
                            pcg_cfg=PCGConfig(max_iter=8),
                            sim_cfg=SimConfig(max_control_updates=1),
                            knot_mesh=KnotMesh(2), fused=True, pcg_method="ca_slab")
assert run["control_updates"] == 1
from mpcgpu_tpu_torch import simulate_mpc_ondevice_batched
run = simulate_mpc_ondevice_batched(m, load_xu_traj("0_0")[:20],
                                    load_eepos_traj("0_0")[:20], 4, 1 / 64, 2,
                                    sqp_cfg=SQPConfig(max_iter=1),
                                    pcg_cfg=PCGConfig(max_iter=5),
                                    sim_cfg=SimConfig(max_control_updates=2))
assert run["tracking_errors"].shape == (2, 2)
ref = (Path.cwd() / "mpcgpu_tpu").resolve()
bad = sorted(name for name, m in list(sys.modules.items())
             if name.split(".")[0] in ("jax", "jaxlib", "mpcgpu_tpu")
             or ref in Path(getattr(m, "__file__", None) or "/").resolve().parents)
print("IMPORTED", bad)
assert not bad, bad
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _CLOSED_LOOP], cwd=ROOT,
                         env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "IMPORTED []" in out.stdout


def test_port_sources_open_nothing_of_the_jax_package():
    """No port source loads a file by path or joins a path onto the JAX
    package's directory."""
    pattern = re.compile(r"load_reference_file|spec_from_file_location|"
                         r"[\"']mpcgpu_tpu[\"']|/ *[\"']mpcgpu_tpu[/\"']")
    hits = [f"{p.relative_to(ROOT)}:{i}: {line.strip()}"
            for p in sorted((ROOT / "mpcgpu_tpu_torch").rglob("*.py"))
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pattern.search(line)]
    assert not hits, hits


def test_host_build_reads_the_ports_own_sources():
    """The host LDL^T libraries are built from the C++ sources under
    mpcgpu_tpu_torch/native/ into mpcgpu_tpu_torch/_build/, and nothing is
    written beside the sources."""
    from mpcgpu_tpu_torch import native

    port = ROOT / "mpcgpu_tpu_torch"
    for src in native.SOURCES:
        path = (native._DIR / src).resolve()
        assert path.is_file() and port / "native" in path.parents, path
    for lib in native.build().values():
        assert port / "_build" in lib.resolve().parents, lib
    assert not list((port / "native").glob("*.so"))


def test_entry_points_default_to_the_card():
    """iiwa14() without a device asks for CUDA: on a machine with a card the
    model lands there; without one it raises instead of building a silent
    CPU model."""
    from mpcgpu_tpu_torch.models import iiwa14

    if torch.cuda.is_available():
        assert iiwa14().xc.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            iiwa14()
    assert iiwa14(device="cpu").xc.device.type == "cpu"


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Here there is no CUDA device: the smoke test must exit non-zero at
    once and never print its ok line, from the checkout and from a
    directory that holds nothing else of the repository."""
    assert not torch.cuda.is_available()
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (lone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             env=_env() if cwd == ROOT else None,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0, out.stdout
        assert '"ok": true' not in out.stdout


# the onboarding path: a planar arm, a URDF loaded and exported, and the
# chain tracker's host and device loops at a tiny size, then the same check
# of every loaded module
_ONBOARDING = """
import sys
from pathlib import Path
import torch
torch.set_num_threads(1)
from mpcgpu_tpu_torch.models import chain, urdf
from mpcgpu_tpu_torch import track_chain
arm = chain.planar_arm(3, dtype=torch.float64, device="cpu")
again = urdf.load_urdf(urdf.export_urdf(arm), dtype=torch.float64, device="cpu")
assert torch.allclose(again.xc, arm.xc)
for argv in (["--nq", "2", "--knots", "4", "--steps", "5"],
             ["--nq", "3", "--knots", "4", "--steps", "5", "--ondevice"]):
    assert track_chain.main(argv + ["--device", "cpu"]) == 0
ref = (Path.cwd() / "mpcgpu_tpu").resolve()
bad = sorted(name for name, m in list(sys.modules.items())
             if name.split(".")[0] in ("jax", "jaxlib", "mpcgpu_tpu")
             or ref in Path(getattr(m, "__file__", None) or "/").resolve().parents)
print("IMPORTED", bad)
assert not bad, bad
"""


def test_onboarding_modules_import_no_jax():
    """chain, urdf and track_chain import nothing of JAX or mpcgpu_tpu."""
    out = subprocess.run([sys.executable, "-c", _ONBOARDING], cwd=ROOT,
                         env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "IMPORTED []" in out.stdout


def test_onboarding_entry_points_default_to_the_card():
    """planar_arm, make_serial_chain, load_urdf and the chain tracker's
    model ask for CUDA unless the caller passes the CPU: without a card
    they raise instead of building a silent CPU model."""
    import numpy as np

    from mpcgpu_tpu_torch import track_chain
    from mpcgpu_tpu_torch.models import (load_urdf, make_serial_chain,
                                         planar_arm)
    from mpcgpu_tpu_torch.models.urdf import export_urdf

    text = export_urdf(planar_arm(2, device="cpu"))
    makers = (lambda **kw: planar_arm(3, **kw),
                lambda **kw: make_serial_chain([np.eye(3)], [np.zeros(3)],
                                               [np.eye(6)], **kw),
                lambda **kw: load_urdf(text, **kw),
                lambda **kw: track_chain.build_model(2, **kw)[0])
    for build in makers:
        if torch.cuda.is_available():
            assert build().xc.device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
                build()
        assert build(device="cpu").xc.device.type == "cpu"
