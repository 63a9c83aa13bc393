"""K2's cluster plan (``ops/pcg_cuda.py::k2_cluster_plan``) and what the
wrappers of K2, K2' and K8b hand the cluster launch.

The cluster kernel itself runs only on the card (``chip_smoke.py`` holds it
against its plain version there).  Here: the plan is valid for every N the
kernels take, agrees with the constants of ``csrc/pcg_dz.cu``, and the three
wrappers pass the same plan for the same N (so they split the knots, and
round, alike), and raise on N outside [2, 512] before any launch.  The
launch is replaced by a recorder, so no card is needed.
"""

import contextlib
import re
from pathlib import Path

import pytest
import torch

from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.ops import pcg_cuda
from mpcgpu_tpu_torch.ops.pcg_cuda import (K2Plan, k2_cluster_plan,
                                           k2_smem_bytes, k2_threads,
                                           pcg_dz_solve, pcg_solve_cuda)
from mpcgpu_tpu_torch.parallel.batched_cuda import pcg_solve_batched

SMEM_LIMIT = 232_448     # one block's dynamic shared memory on an H100
CSRC = Path(pcg_cuda.__file__).resolve().parents[1] / "csrc" / "pcg_dz.cu"


@pytest.mark.parametrize("lo,hi", [(2, 65), (65, 129), (129, 257), (257, 513)])
def test_plan_is_valid_for_every_knot_count(lo, hi):
    for N in range(lo, hi):
        plan = k2_cluster_plan(N)
        C, kp, smem = plan
        assert C & (C - 1) == 0 and 1 <= C <= 16, (N, plan)
        assert C * kp >= N and kp == -(-N // C), (N, plan)
        # only trailing CTAs hold fewer knots: the first one is full
        assert 2 <= kp <= N and kp <= pcg_cuda.K2_MAX_KP, (N, plan)
        assert smem == k2_smem_bytes(kp) <= SMEM_LIMIT, (N, plan)
        assert k2_cluster_plan(N) == plan    # a fixed function of N


def test_plan_at_the_main_sizes():
    assert k2_cluster_plan(64) == K2Plan(8, 8, k2_smem_bytes(8))
    # N = 512 takes the non-portable cluster of 16 CTAs of 32 knots
    assert k2_cluster_plan(512) == K2Plan(16, 32, k2_smem_bytes(32))
    assert pcg_cuda.K2_MAX_CLUSTER * pcg_cuda.K2_MAX_KP >= _kernels.MAX_KNOTS
    assert k2_smem_bytes(pcg_cuda.K2_MAX_KP) <= SMEM_LIMIT
    assert k2_threads(pcg_cuda.K2_MAX_KP) == 448


def test_plan_constants_match_the_cuda_source():
    src = CSRC.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    # the stride is derived from NX: evaluated at NX = 14 (C's integer /)
    stride = re.search(r"constexpr int KNOT_STRIDE = ([^;]+);", src).group(1)
    assert eval(stride.replace("/", "//"), {"NN": 196, "NX": 14}) \
        == pcg_cuda._KNOT_STRIDE == 590
    assert int(consts["K2_MAX_KP"]) == pcg_cuda.K2_MAX_KP
    assert int(consts["K2_MAX_CLUSTER"]) == pcg_cuda.K2_MAX_CLUSTER
    # the kernel's own count of its shared memory, evaluated here
    body = re.search(r"k2_smem_floats\(int kp\) \{(.*?)\}", src, re.S).group(1)
    terms = " ".join(re.sub(r"//[^\n]*", "", body).replace("return", "")
                     .replace(";", "").split())
    for kp in (1, 8, 32, 46):
        floats = eval(terms, {"KNOT_STRIDE": pcg_cuda._KNOT_STRIDE, "NX": 14,
                              "K2_MAX_CLUSTER": pcg_cuda.K2_MAX_CLUSTER,
                              "k2_threads": k2_threads, "kp": kp})
        assert 4 * floats == k2_smem_bytes(kp)


@pytest.fixture
def recorder(monkeypatch):
    """Every kernel entry replaced by a recorder of its arguments; CPU
    tensors taken as if they were on the card."""
    calls = []

    def entry(src, name, nq):
        assert nq == 7, (name, nq)       # the IIWA's library

        def launch(*args):
            calls.append((name, args))
            return 0
        return launch

    monkeypatch.setattr(_kernels, "on_cpu", lambda t: False)
    monkeypatch.setattr(_kernels, "require", lambda *a, **k: None)
    monkeypatch.setattr(_kernels, "entry", entry)
    monkeypatch.setattr(_kernels, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return calls


def _system(N, B=None):
    lead = () if B is None else (B,)
    z = lambda *shape: torch.zeros(lead + (N,) + shape)
    sys_ = {"S": z(3, 14, 14), "Pinv": z(3, 14, 14), "gamma": z(14),
            "Qinv": z(14, 14), "A": z(14, 14), "B": z(14, 7), "q": z(14)}
    return sys_, z(14), z(7)


def _launch_all(N):
    sys_, lam0, u = _system(N)
    pcg_dz_solve(sys_, lam0, u, 1e-3, 0.1, max_iter=5, exit_tol=1e-5)
    pcg_solve_cuda(sys_["S"], sys_["Pinv"], sys_["gamma"], lam0, max_iter=5)
    sb, lb, _ = _system(N, B=3)
    pcg_solve_batched(sb["S"], sb["Pinv"], sb["gamma"], lb, max_iter=5)


@pytest.mark.parametrize("N", [2, 37, 64, 100, 512])
def test_k2_k2p_k8b_launch_the_same_plan(recorder, N):
    _launch_all(N)
    (n1, a1), (n2, a2), (n3, a3) = recorder
    assert (n1, n2, n3) == ("pcg_dz_launch", "pcg_launch", "pcg_launch")
    # pcg_dz_launch: ..., N, cluster, kp, smem, ...; pcg_launch: ..., N,
    # cluster, kp, smem, batch, ...
    assert a1[15] == a2[7] == a3[7] == N
    plan = tuple(k2_cluster_plan(N))
    assert tuple(a1[16:19]) == tuple(a2[8:11]) == tuple(a3[8:11]) == plan
    assert a2[11] == 1 and a3[11] == 3


@pytest.mark.parametrize("N", [1, 513])
def test_wrappers_raise_outside_the_knot_range_before_any_launch(recorder, N):
    sys_, lam0, u = _system(N)
    with pytest.raises(ValueError, match="knots"):
        pcg_dz_solve(sys_, lam0, u, 1e-3, 0.1)
    with pytest.raises(ValueError, match="knots"):
        pcg_solve_cuda(sys_["S"], sys_["Pinv"], sys_["gamma"], lam0)
    sb, lb, _ = _system(N, B=2)
    with pytest.raises(ValueError, match="knots"):
        pcg_solve_batched(sb["S"], sb["Pinv"], sb["gamma"], lb)
    with pytest.raises(ValueError, match="knots"):
        k2_cluster_plan(N)
    assert recorder == []
