"""K1-K4 at every joint count the kernels are built for (nq = 2..7): the
plans and launch arguments of the wrappers against the constants of the
CUDA sources evaluated at that nq, and the gates of the kernels outside the
slice.

The kernels take nq as the compile-time ``MPC_NQ`` (``csrc/common.cuh``).
Here every file-scope ``constexpr int`` of ``common.cuh`` and of a kernel's
source is evaluated with ``MPC_NQ`` set (C's integer division), and the
Python mirrors (``kkt_window_plan``, ``k2_cluster_plan``,
``merit_team_plan``) must give the same sizes; the static_asserts of the
sources must hold.  The launches are replaced by a recorder, so no card is
needed: K1, K2, K3 and K4 must hand their entry the model's nq and the plan
of that nq, and every kernel outside the slice must raise at nq != 7, before
any launch, with a message that names its ROADMAP item.
"""

import re
from pathlib import Path

import pytest
import torch

from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.config import CostConfig
from mpcgpu_tpu_torch.models import planar_arm
from mpcgpu_tpu_torch.ops import pcg_cuda
from mpcgpu_tpu_torch.ops.pcg_ca_cuda import ca_basis_cuda, ca_coeff_step_cuda
from mpcgpu_tpu_torch.ops.pcg_cuda import (compute_dz_cuda, compute_dz_slab,
                                           k2_cluster_plan, k2_smem_bytes,
                                           k2_threads, knot_stride, pcg_dz_solve,
                                           pcg_solve_cuda)
from mpcgpu_tpu_torch.ops.pcg_slab_cuda import pcg_slab_step_cuda
from mpcgpu_tpu_torch.ops.pcr_cuda import pcr_solve_cuda
from mpcgpu_tpu_torch.parallel.batched_cuda import (build_kkt_schur_batched,
                                                    compute_dz_batched,
                                                    line_search_merits_batched,
                                                    pcg_solve_batched)
from mpcgpu_tpu_torch.sim.plant_cuda import simulate_plant, simulate_plant_batched
from mpcgpu_tpu_torch.solver import kkt_cuda, merit_cuda
from mpcgpu_tpu_torch.solver.kkt_cuda import (build_kkt_cuda, build_kkt_schur,
                                              build_kkt_schur_slab,
                                              kkt_smem_bytes, kkt_window_plan)
from mpcgpu_tpu_torch.solver.merit_cuda import (line_search_merit_partials_slab,
                                                line_search_merits_fused,
                                                merit_smem_bytes, merit_team_plan)

SMEM_LIMIT = 232_448     # one block's dynamic shared memory on an H100
CSRC = Path(kkt_cuda.__file__).resolve().parents[1] / "csrc"
NQS = (2, 3, 4, 5, 6, 7)


def _constexprs(nq: int, *names: str, **funcs) -> dict:
    """Every file-scope ``constexpr int NAME = expr;`` of common.cuh and the
    given sources, in order, with MPC_NQ = nq, C's integer division and the
    sources' constexpr functions (``funcs``, their Python mirrors)."""
    env = {"MPC_NQ": nq, **funcs}
    for name in ("common.cuh",) + names:
        for key, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                    (CSRC / name).read_text(), re.M):
            if key != "MPC_NQ":
                env[key] = int(eval(expr.replace("/", "//"), {}, dict(env)))
    return env


def _body(src: str, name: str) -> str:
    body = re.search(name + r"\([^)]*\) \{(.*?)\}", src, re.S).group(1)
    return " ".join(re.sub(r"//[^\n]*", "", body).replace("return", "")
                    .replace(";", "").split())


@pytest.mark.parametrize("nq", NQS)
def test_k1_plan_matches_the_source(nq):
    c = _constexprs(nq, "kkt_schur.cu")
    assert c["NQ"] == nq and c["MODEL_SIZE"] == 192 * nq
    assert c["KW"] == kkt_cuda.kkt_group_warps(nq)
    assert c["SLOT_FLOATS"] == kkt_cuda.kkt_slot_floats(nq)
    assert c["WS_FLOATS"] == kkt_cuda.kkt_ws_floats(nq)
    # the static_asserts of csrc/kkt_schur.cu at this nq
    assert 5 * c["KW"] >= c["NX"]
    assert 3 * (nq + 1) <= c["FKT"] == 32 * c["KW"] - 32
    assert c["WS_A"] + 2 * c["FK_BUF"] <= c["WS_QIW"]
    assert c["NX"] * 2 * c["NX"] + 3 * c["NX"] <= c["WS_FLOATS"]
    assert 2 * c["KKT_MAX_GROUPS"] <= 15
    for N in (2, 3, 16, 33, 64, 100, 512):
        plan = kkt_window_plan(N, nq=nq)
        assert plan[:2] == kkt_window_plan(N)[:2]      # windows: N alone
        for schur in (True, False):
            groups = plan.window + 3 if schur else plan.window
            floats = (c["MODEL_SIZE"] + (groups * c["SLOT_FLOATS"] if schur else 0)
                      + groups * c["WS_FLOATS"])
            assert 4 * floats == kkt_smem_bytes(plan.window, schur, nq) <= SMEM_LIMIT
        assert plan.smem_bytes == kkt_smem_bytes(plan.window, nq=nq)


def test_k1_team_bound_is_nq_7():
    """At nq = 8 the 3-warp group has 15 teams for 16 tangent directions:
    the source's static_assert fails, and the gate says 2 <= nq <= 7."""
    c = _constexprs(8, "kkt_schur.cu")
    assert 5 * c["KW"] < c["NX"]
    for nq in (1, 8):
        with pytest.raises(ValueError, match="2 <= nq <= 7.*ROADMAP"):
            _kernels.require_nq(nq)


@pytest.mark.parametrize("nq", NQS)
def test_k2_plan_matches_the_source(nq):
    nx = 2 * nq
    src = (CSRC / "pcg_dz.cu").read_text()
    c = _constexprs(nq, "pcg_dz.cu", k2_threads=lambda k: k2_threads(k, nx))
    assert c["KNOT_STRIDE"] == knot_stride(nx)
    assert c["KNOT_STRIDE"] >= 3 * nx * nx and c["KNOT_STRIDE"] % 32 == nx % 32
    assert c["K2_MAX_KP"] == pcg_cuda.K2_MAX_KP
    assert c["K2_MAX_CLUSTER"] == pcg_cuda.K2_MAX_CLUSTER
    threads = _body(src, "k2_threads")
    assert threads == "NX * kp <= 32 ? 32 : (NX * kp + 31) / 32 * 32"
    smem = _body(src, "k2_smem_floats").replace("/", "//")
    for kp in (1, 2, 8, 17, 32):
        assert k2_threads(kp, nx) == (32 if nx * kp <= 32 else (nx * kp + 31) // 32 * 32)
        floats = eval(smem, {"KNOT_STRIDE": c["KNOT_STRIDE"], "NX": nx,
                             "K2_MAX_CLUSTER": c["K2_MAX_CLUSTER"], "kp": kp,
                             "k2_threads": lambda k: k2_threads(k, nx)})
        assert 4 * floats == k2_smem_bytes(kp, nx)
    assert k2_threads(pcg_cuda.K2_MAX_KP, nx) // 32 <= 16
    for N in range(2, 513):
        plan = k2_cluster_plan(N, nx)
        assert plan[:2] == k2_cluster_plan(N)[:2]      # the split: N alone
        assert plan.smem_bytes == k2_smem_bytes(plan.knots_per_cta, nx) <= SMEM_LIMIT


def test_k2_plans_at_the_new_sizes():
    """nx = 6 and 10 at N = 64 and 512: 8 CTAs of 8 knots and 16 of 32, one
    thread per row in whole warps, the stride 32 m + nx."""
    assert (knot_stride(6), knot_stride(10), knot_stride(14)) == (134, 330, 590)
    for nx in (6, 10):
        assert k2_cluster_plan(64, nx)[:2] == (8, 8)
        assert k2_cluster_plan(512, nx)[:2] == (16, 32)
        assert k2_threads(8, nx) == -(-8 * nx // 32) * 32
        assert k2_threads(32, nx) == -(-32 * nx // 32) * 32
        assert k2_smem_bytes(32, nx) < k2_smem_bytes(32)


@pytest.mark.parametrize("nq", NQS)
def test_k3_plan_matches_the_source(nq):
    src = (CSRC / "merit.cu").read_text()
    c = _constexprs(nq, "merit.cu")
    assert c["SAMPLE_STRIDE"] == merit_cuda.merit_sample_stride(nq)
    assert c["SAMPLE_STRIDE"] % 2 == 1 and c["VEC_STRIDE"] % 2 == 1
    assert c["SAMPLE_FLOATS"] == 76 * nq + 158
    assert c["VEC_STRIDE"] == merit_cuda.merit_vec_stride(nq)
    assert _body(src, "merit_smem_floats") == (
        "MODEL_SIZE + P * (G == 1 ? VEC_STRIDE : SAMPLE_STRIDE) + 2 * N + 33")
    for N in (2, 16, 33, 64, 512):
        for samples in (9 * N, 9 * N * 256):
            G, P, smem = merit_team_plan(N, samples, nq)
            stride = c["VEC_STRIDE"] if G == 1 else c["SAMPLE_STRIDE"]
            assert smem == 4 * (c["MODEL_SIZE"] + P * stride + 2 * N + 33)
            assert smem == merit_smem_bytes(G, P, N, nq) <= SMEM_LIMIT
            assert (G, P) == merit_team_plan(N, samples)[:2]


@pytest.fixture
def recorder(monkeypatch):
    """Every kernel entry replaced by a recorder of its nq and arguments;
    CPU tensors taken as if they were on the card."""
    calls = []

    def entry(src, name, nq=7):
        def launch(*args):
            calls.append((name, nq, args))
            return 0
        return launch

    monkeypatch.setattr(_kernels, "on_cpu", lambda t: False)
    monkeypatch.setattr(_kernels, "require", lambda *a, **k: None)
    monkeypatch.setattr(_kernels, "entry", entry)
    monkeypatch.setattr(_kernels, "stream_ptr", lambda dev: 0)
    return calls


def _inputs(nq, N):
    nx, w = 2 * nq, 3 * nq
    m = planar_arm(nq, device="cpu")
    xu, ee = torch.zeros((N, w)), torch.zeros((N, 6))
    sys_ = {"S": torch.zeros((N, 3, nx, nx)), "Pinv": torch.zeros((N, 3, nx, nx)),
            "gamma": torch.zeros((N, nx)), "Qinv": torch.zeros((N, nx, nx)),
            "A": torch.zeros((N, nx, nx)), "B": torch.zeros((N, nx, nq)),
            "q": torch.zeros((N, nx))}
    return m, xu, ee, sys_


@pytest.mark.parametrize("nq", NQS)
@pytest.mark.parametrize("N", [2, 37, 64, 512])
def test_k1_to_k4_launch_the_plan_of_their_nq(recorder, nq, N):
    nx = 2 * nq
    m, xu, ee, sys_ = _inputs(nq, N)
    cost = CostConfig.for_knots(N)
    build_kkt_schur(m, cost, xu, xu[0, :nx], ee, 1e-3, 1 / 64)
    pcg_dz_solve(sys_, torch.zeros((N, nx)), xu[:, nx:], 1e-3, 0.1, max_iter=5)
    line_search_merits_fused(m, cost, xu, xu, xu[0, :nx], ee, 1.0, 1 / 64)
    simulate_plant(m, xu[0, :nx], xu, 2e-3, 2e-3, 1 / 64, 10, 2e-4)
    simulate_plant_batched(m, xu[:3, :nx].contiguous(),
                           xu.expand(3, N, 3 * nq).contiguous(), 2e-3, 2e-3,
                           1 / 64, 10, 2e-4)
    names = [(name, q) for name, q, _ in recorder]
    assert names == [("kkt_schur_launch", nq), ("pcg_dz_launch", nq),
                     ("merit_launch", nq), ("plant_launch", nq),
                     ("plant_launch", nq)]
    a1, a2, a3, a4, a4b = (args for _, _, args in recorder)
    plan = kkt_window_plan(N, nq=nq)
    assert tuple(a1[12:16]) == (N, 1, plan.window, plan.smem_bytes)
    assert a1[1] == 3 * nq                                   # xu's row stride
    assert tuple(a2[15:19]) == (N, *k2_cluster_plan(N, nx))
    assert a2[9] == 3 * nq                                   # u's row stride
    assert tuple(a3[12:18]) == (N, 9, 1, *merit_team_plan(N, 9 * N, nq))
    # plant_launch: xs, xs_bstride, plan, plan_stride, plan_bstride, N, ...,
    # out, batch, stream
    for args, B in ((a4, 1), (a4b, 3)):
        assert args[1] == nx and args[3] == 3 * nq and args[4] == N * 3 * nq
        assert args[5] == N and args[-2] == B


def _out_of_slice_calls(nq, N=16):
    """Every wrapper of a kernel outside the slice, called at nq."""
    nx = 2 * nq
    m, xu, ee, sys_ = _inputs(nq, N)
    cost = CostConfig.for_knots(N)
    z, B = torch.zeros, 3
    st = {k: z((2, N // 2, nx)) for k in ("x", "r", "p", "s", "u", "w", "z")}
    return {
        "K5": lambda: build_kkt_cuda(m, cost, xu, xu[0, :nx], ee, 1 / 64),
        "K2'": lambda: pcg_solve_cuda(sys_["S"], sys_["Pinv"], sys_["gamma"],
                                      z((N, nx))),
        "K6": lambda: compute_dz_cuda(sys_, z((N, nx)), xu[:, nx:], 1e-3, 0.1),
        "K7": lambda: pcr_solve_cuda(sys_["S"], z((N, nx))),
        "K8a": lambda: build_kkt_schur_batched(
            m, cost, xu.expand(B, N, 3 * nq), z((B, nx)), ee.expand(B, N, 6),
            z(B), 1 / 64),
        "K8b": lambda: pcg_solve_batched(z((B, N, 3, nx, nx)), z((B, N, 3, nx, nx)),
                                         z((B, N, nx)), z((B, N, nx))),
        "K8c": lambda: compute_dz_batched(
            {k: v.expand(B, *v.shape) for k, v in sys_.items()}, z((B, N, nx)),
            xu[:, nx:].expand(B, N, nq), z(B), 0.1),
        "K3b": lambda: line_search_merits_batched(
            m, cost, xu.expand(B, N, 3 * nq), xu.expand(B, N, 3 * nq), z((B, nx)),
            ee.expand(B, N, 6), 1.0, 1 / 64),
        "K9a": lambda: build_kkt_schur_slab(m, cost, xu.expand(2, N, 3 * nq),
                                            ee.expand(2, N, 6), z((2, N)),
                                            z((2, N)), 1e-3, 1 / 64),
        "K9b": lambda: compute_dz_slab(
            {k: v.expand(2, *v.shape) for k, v in sys_.items()}, z((2, N, nx)),
            z((2, N, nx)), z((2, N)), xu[:, nx:].expand(2, N, nq), 1e-3, 0.1),
        "K9c": lambda: line_search_merit_partials_slab(
            m, cost, xu.expand(2, N, 3 * nq), xu.expand(2, N, 3 * nq),
            ee.expand(2, N, 6), 1 / 64),
        "K10a": lambda: pcg_slab_step_cuda(
            dict(st, pkt=z((2, 2, 6, nx)), dots=z((2, 3))), sys_["S"], sys_["Pinv"],
            None, None, None, None, None, 5, 0.0, "eta", False),
        "K10b": lambda: ca_basis_cuda(st, sys_["S"], sys_["Pinv"], None, None,
                                      None, None, None, None, 5, 4),
        "K10b'": lambda: ca_coeff_step_cuda(st, None, 5, 0.0, "eta", 4),
    }


@pytest.mark.parametrize("nq", [3, 5])
def test_kernels_outside_the_slice_raise_at_other_nq(recorder, nq):
    for name, call in _out_of_slice_calls(nq).items():
        with pytest.raises(ValueError, match=r"nq = 7 only.*ROADMAP\.md queue 2"):
            call()
        assert recorder == [], name
