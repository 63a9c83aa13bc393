"""The port stands on its own: it imports neither jax nor the mpcgpu_tpu
package, and its GPU smoke test refuses to run without a CUDA device."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

_ONE_STEP = """
import sys
import torch
torch.set_num_threads(1)
from mpcgpu_tpu_torch.config import (CostConfig, PCGConfig, SQPConfig,
                                     load_eepos_traj, load_xu_traj)
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.solver.sqp import sqp_solve
N = 8
xu = torch.tensor(load_xu_traj("0_0")[:N], dtype=torch.float64)
ee = torch.tensor(load_eepos_traj("0_0")[:N], dtype=torch.float64)
res = sqp_solve(iiwa14(torch.float64), CostConfig(), SQPConfig(max_iter=1),
                PCGConfig(max_iter=50), xu, torch.zeros((N, 14), dtype=torch.float64),
                xu[0, :14], ee, 1e-3, 1 / 64, linsys="pcg")
assert torch.isfinite(res.xu).all() and int(res.sqp_iters) == 1
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mpcgpu_tpu"))
print("IMPORTED", bad)
assert not bad, bad
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _ONE_STEP], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "IMPORTED []" in out.stdout


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
