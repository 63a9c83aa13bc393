"""Every kernel at every joint count the kernels are built for (nq =
2..7): the plans and launch arguments of the wrappers against the constants
of the CUDA sources evaluated at that nq.

The kernels take nq as the compile-time ``MPC_NQ`` (``csrc/common.cuh``).
Here every file-scope ``constexpr int`` of ``common.cuh`` and of a kernel's
source is evaluated with ``MPC_NQ`` set (C's integer division), and the
Python mirrors (``kkt_window_plan``, ``kkt_batched_plan``, ``k2_cluster_plan``,
``merit_team_plan``, ``pcr_plan``, ``slab_cluster_plan``,
``ca_cluster_plan``, ``coeff_plan``) must give the same sizes; the
static_asserts of the sources must hold.  The launches are replaced by a
recorder of the (source, nq) of the library each one resolves, so no card
is needed: every wrapper must hand its entry the nq of its system (a
wrapper that resolved no nq, or another, would load another library and
read past its buffers) and the plan of that nq.
"""

import contextlib
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.config import CostConfig
from mpcgpu_tpu_torch.models import planar_arm
from mpcgpu_tpu_torch.ops import pcg_ca_cuda, pcg_cuda, pcg_slab_cuda, pcr_cuda
from mpcgpu_tpu_torch.ops.pcg_ca import WORK, n_parts
from mpcgpu_tpu_torch.ops.pcg_ca_cuda import (ca_basis_cuda, ca_cluster_plan,
                                              ca_coeff_step_cuda, ca_smem_bytes,
                                              coeff_plan)
from mpcgpu_tpu_torch.ops.pcg_cuda import (compute_dz_cuda, compute_dz_slab,
                                           dz_plan, k2_cluster_plan, k2_smem_bytes,
                                           k2_threads, knot_stride, pcg_dz_solve,
                                           pcg_solve_cuda)
from mpcgpu_tpu_torch.ops.pcg_slab_cuda import (pcg_slab_step_cuda,
                                                slab_cluster_plan, slab_knot_stride,
                                                slab_smem_bytes)
from mpcgpu_tpu_torch.ops.pcr import pcr_levels
from mpcgpu_tpu_torch.ops.pcr_cuda import (pcr_plan, pcr_slot_floats,
                                           pcr_smem_bytes, pcr_solve_cuda,
                                           pcr_warp_floats, pcr_workspace_floats)
from mpcgpu_tpu_torch.parallel import batched_cuda
from mpcgpu_tpu_torch.parallel.batched_cuda import (build_kkt_schur_batched,
                                                    compute_dz_batched,
                                                    line_search_merits_batched,
                                                    pcg_solve_batched)
from mpcgpu_tpu_torch.sim.plant_cuda import simulate_plant, simulate_plant_batched
from mpcgpu_tpu_torch.solver import kkt_cuda, merit_cuda
from mpcgpu_tpu_torch.solver.kkt_cuda import (K9A_MAX_KNOTS, build_kkt_cuda,
                                              build_kkt_schur,
                                              build_kkt_schur_slab,
                                              kkt_batched_plan, kkt_knot_stages,
                                              kkt_smem_bytes, kkt_window_plan)
from mpcgpu_tpu_torch.solver.merit_cuda import (line_search_merit_partials_slab,
                                                line_search_merits_fused,
                                                merit_smem_bytes, merit_team_plan)

SMEM_LIMIT = 232_448     # one block's dynamic shared memory on an H100
CSRC = Path(kkt_cuda.__file__).resolve().parents[1] / "csrc"
NQS = (2, 3, 4, 5, 6, 7)
H100_SMS = 132
# K8a's CTAs an SM on the H100 at every nq, window and group count of its
# plans: one (the register file; kkt_window_occupancy on the card)
one_cta_an_sm = lambda groups, smem: 1


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


@pytest.mark.parametrize("nq", NQS)
def test_k8a_k9a_windows_at_every_nq(nq):
    """K9a takes K1's windows over halo-extended slabs of up to
    K9A_MAX_KNOTS knots, the same split at every nq; K8a takes its plan,
    K1's windows at a batch of one and long windows of KKT_MAX_GROUPS
    groups at a full card; the shared memory of that nq within the
    card's."""
    for N in (2, 5, 64, 512, K9A_MAX_KNOTS):
        plan = kkt_window_plan(N, K9A_MAX_KNOTS, nq)
        assert plan[:2] == kkt_window_plan(N, K9A_MAX_KNOTS)[:2]
        assert plan.smem_bytes == kkt_smem_bytes(plan.window, nq=nq) <= SMEM_LIMIT
        assert kkt_smem_bytes(plan.window, False, nq) <= plan.smem_bytes
    for N in (2, 5, 64, 512):
        one = kkt_batched_plan(N, 1, nq, H100_SMS, one_cta_an_sm)
        k1 = kkt_window_plan(N, nq=nq)
        assert (one.window, one.groups, one.ctas, one.smem_bytes) == (
            k1.window, k1.window + 3, k1.ctas, k1.smem_bytes)
        full = kkt_batched_plan(N, 256, nq, H100_SMS, one_cta_an_sm)
        assert full.smem_bytes == kkt_smem_bytes(full.window, nq=nq,
                                                 groups=full.groups) <= SMEM_LIMIT
        assert full.groups == min(kkt_cuda.KKT_MAX_GROUPS, full.window + 3)


def _k8a_cost(plan, N, B, sms=H100_SMS):
    """waves x rounds of a K8a plan at one CTA an SM."""
    waves = -(-B * -(-N // plan.window) // sms)
    return waves * -(-(plan.window + 3) // plan.groups)


@pytest.mark.parametrize("nq", NQS)
@pytest.mark.parametrize("N", [2, 33, 64, 512])
@pytest.mark.parametrize("B", [1, 3, 33, 256])
def test_k8a_plan_covers_the_horizon(nq, N, B):
    """K8a's plan at every nq on an H100 (132 SMs, one CTA an SM): its
    windows own every knot once, the groups' turns over the slots reach
    every slot of the three stages once, with the two left and one right
    halo knots inside the horizon; the shared memory is the source's
    ``kkt_smem_floats`` (evaluated at nq) and within the card's; a batch
    whose K1 windows fit in one wave keeps K1's windows; no other window
    from K1's to N is cheaper in waves x rounds; at N = 64, nq = 7, B =
    256 the window is 32 knots."""
    c = _constexprs(nq, "kkt_schur.cu")
    plan = kkt_batched_plan(N, B, nq, H100_SMS, one_cta_an_sm)
    Kc, G = plan.window, plan.groups
    assert 1 <= G <= c["KKT_MAX_GROUPS"] and G <= Kc + 3 and 1 <= Kc <= N
    assert plan.ctas == -(-N // Kc)
    # the source's kkt_smem_floats(Kc, groups, schur), its ternary in Python
    body = _body((CSRC / "kkt_schur.cu").read_text(), "kkt_smem_floats")
    expr = re.sub(r"\((\w+) \? (.+) : (\w+)\)", r"(\2 if \1 else \3)", body)
    floats = eval(expr, {}, dict(c, Kc=Kc, groups=G, schur=True))
    assert floats == c["MODEL_SIZE"] + (Kc + 3) * c["SLOT_FLOATS"] + G * c["WS_FLOATS"]
    assert plan.smem_bytes == 4 * floats <= SMEM_LIMIT
    owned, stages = [], 0
    for w in range(plan.ctas):
        s, e = w * Kc, min(N, (w + 1) * Kc)
        owned += range(s, e)
        # the kernel's loops: stage 1 over slots 0 .. Kc + 2, stage 2 over
        # 1 .. Kc + 2, stage 3 over 2 .. Kc + 1, group gi on gi, gi + G, ...
        turns = lambda lo, hi: sorted(i for gi in range(G)
                                      for i in range(lo + gi, hi, G))
        slots1, slots2, slots3 = turns(0, Kc + 3), turns(1, Kc + 3), turns(2, Kc + 2)
        assert slots1 == list(range(Kc + 3)) and slots2 == list(range(1, Kc + 3))
        assert slots3 == list(range(2, Kc + 2))
        stage1 = [s - 2 + i for i in slots1 if 0 <= s - 2 + i < min(e + 1, N)]
        assert stage1 == list(range(max(0, s - 2), min(N, e + 1)))
        assert [s - 2 + i for i in slots3 if s - 2 + i < e] == list(range(s, e))
        stages += len(stage1)
    assert owned == list(range(N))
    assert stages == kkt_knot_stages(N, Kc)
    k1 = kkt_window_plan(N, nq=nq)
    if B * k1.ctas <= H100_SMS:
        assert (Kc, G, plan.smem_bytes) == (k1.window, k1.window + 3, k1.smem_bytes)
    cost = _k8a_cost(plan, N, B)
    for other in range(k1.window, N + 1):
        groups = min(c["KKT_MAX_GROUPS"], other + 3)
        if kkt_smem_bytes(other, nq=nq, groups=groups) > SMEM_LIMIT:
            break
        alt = kkt_cuda.KKTBatchedPlan(other, groups, -(-N // other), 0)
        assert _k8a_cost(alt, N, B) >= cost, (other, plan)
        if other < Kc:
            assert _k8a_cost(alt, N, B) > cost, (other, plan)
    if (N, nq, B) == (64, 7, 256):
        assert (Kc, G, plan.ctas, stages) == (32, 7, 2, 67)


@pytest.mark.parametrize("nq", NQS)
def test_k7_plan_matches_the_source(nq):
    """K7's slot, warp floats, shared memory and workspace at nq: the
    Gauss-Jordan's lane c < 2 NX holds column c, so one warp takes every
    nx <= 16."""
    nx = 2 * nq
    src = (CSRC / "pcr.cu").read_text()
    c = _constexprs(nq, "pcr.cu")
    assert c["SLOT"] == pcr_slot_floats(nx)
    assert c["WARP_FLOATS"] == pcr_warp_floats(nx)
    assert c["PCR_KPC"] == pcr_cuda.PCR_KPC
    assert 2 * nx <= 32
    smem = _body(src, "pcr_smem_bytes")
    assert smem == "4 * kpc * (WARP_FLOATS + cluster * 2 * SLOT)"
    for cluster in (0, 1):
        assert eval(smem, {"kpc": c["PCR_KPC"], "cluster": cluster, **c}) \
            == pcr_smem_bytes(bool(cluster), nx) <= SMEM_LIMIT
    # Work: th^{-1} (levels + 1), L, U (levels) x N x NN, two slots a knot
    for N in (2, 3, 64, 65, 512):
        lv = pcr_levels(N)
        floats = (2 * lv + 1) * N * nx * nx + lv * N * nx * nx + 2 * N * c["SLOT"]
        assert pcr_workspace_floats(N, lv, nx) == floats
        plan = pcr_plan(N, nx)
        assert plan[:2] == pcr_plan(N)[:2]                 # the split: N alone
        assert plan.smem_bytes == pcr_smem_bytes(plan.cluster, nx)


@pytest.mark.parametrize("nq", NQS)
def test_k10a_plan_matches_the_source(nq):
    """K10a's knot stride: the least >= 3 nx^2 congruent to nx^2 mod 32, a
    multiple of 4 (16-byte aligned bulk copies), 612 at nx = 14; where nq is
    odd, the rows 16 threads read as float2 fall in 16 distinct 8-byte
    banks, as at nq = 7.  The plan's threads and shared memory at nx."""
    nx = 2 * nq
    src = (CSRC / "pcg_slab.cu").read_text()
    c = _constexprs(nq, "pcg_slab.cu")
    stride = c["SLAB_KNOT_STRIDE"]
    assert stride == slab_knot_stride(nx)
    assert stride >= 3 * nx * nx and stride % 32 == nx * nx % 32 and stride % 4 == 0
    assert stride - 3 * nx * nx < 32
    if nq % 2:
        for t0 in range(0, 512 - 16, 16):
            words = {((t // nx) * stride + nx * (t % nx)) // 2 % 16
                     for t in range(t0, t0 + 16)}
            assert len(words) == 16, t0
    terms = _body(src, "slab_smem_bytes")
    for kc in (1, 2, 4, 32):
        assert eval(terms, {"NX": nx, "SLAB_KNOT_STRIDE": stride, "kc": kc,
                            "SLAB_MAX_CLUSTER": c["SLAB_MAX_CLUSTER"]}) \
            == slab_smem_bytes(kc, nx)
    for L in range(2, 513):
        plan = slab_cluster_plan(L, nx=nx)
        assert plan[:2] == slab_cluster_plan(L)[:2]        # the split: L alone
        assert plan.threads % 32 == 0 and nx * plan.knots_per_cta <= plan.threads
        assert plan.threads < nx * plan.knots_per_cta + 32
        assert plan.threads <= c["SLAB_MAX_THREADS"]
        assert plan.smem_bytes == slab_smem_bytes(plan.knots_per_cta, nx) <= SMEM_LIMIT


@pytest.mark.parametrize("nq", NQS)
def test_k10b_plans_match_the_source(nq):
    """K10b's knot stride is K2's (590 at nx = 14), its blocks load as
    whole float4s at every even nx; its cluster plan and the coefficient
    step's plan at nx pass the launches' checks for every admitted slab."""
    nx = 2 * nq
    src = (CSRC / "pcg_ca.cu").read_text()
    c = _constexprs(nq, "pcg_ca.cu")
    assert c["CA_KNOT_STRIDE"] == knot_stride(nx)
    assert 3 * c["NN"] % 4 == 0
    terms = _body(src, "ca_smem_bytes")
    for ke in (1, 6, 36):
        for s_ in (1, 4, 8):
            for blocks in (0, 1):
                assert eval(terms, {"NX": nx, "CA_KNOT_STRIDE": c["CA_KNOT_STRIDE"],
                                    "ke": ke, "s": s_, "blocks": blocks}) \
                    == ca_smem_bytes(ke, s_, bool(blocks), nx)
    for s_ in (1, 4, 8):
        h = 2 * s_ + 1
        for L in range(h, 513):
            C, ke, blocks, threads, smem = ca_cluster_plan(L, s_, nx=nx)
            assert (C, ke) == tuple(ca_cluster_plan(L, s_)[:2])
            # ca_basis_launch's checks
            assert C * ke >= L + 2 * h and nx * ke <= threads <= c["CA_MAX_THREADS"]
            assert threads % 32 == 0 and smem == ca_smem_bytes(ke, s_, blocks, nx)
            assert smem <= SMEM_LIMIT
            C, R, threads = coeff_plan(L, s_, nx=nx)
            # ca_coeff_launch's checks
            assert C * R >= L * nx and R == -(-L * nx // C)
            assert threads % 32 == 0 and 64 <= threads <= c["COEF_MAX_THREADS"]


class _Calls(list):
    """The recorded launches, and per launch the card its guard made
    current (``cards``)."""

    def __init__(self):
        super().__init__()
        self.cards = []


@pytest.fixture
def recorder(monkeypatch):
    """Every kernel entry replaced by a recorder of the (source, nq) of the
    library it resolves and its arguments; CPU tensors taken as if they were
    on the card.  The card guard ``torch.cuda.device`` is replaced by one
    that records the device it makes current, with cuda:0 current outside
    it (the caller's card), so ``cards`` shows whether each entry was
    called under its tensors' device."""
    calls = _Calls()
    current = [torch.device("cuda", 0)]

    @contextlib.contextmanager
    def card(dev):
        prev, current[0] = current[0], torch.device(dev)
        try:
            yield
        finally:
            current[0] = prev

    def entry(src, name, nq):
        def launch(*args):
            calls.append((src, name, nq, args))
            calls.cards.append(current[0])
            return 0
        return launch

    monkeypatch.setattr(_kernels, "on_cpu", lambda t: False)
    monkeypatch.setattr(_kernels, "require", lambda *a, **k: None)
    monkeypatch.setattr(_kernels, "entry", entry)
    monkeypatch.setattr(_kernels, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device", card)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0].index)
    # K8a's plan: an H100's SM count and CTAs an SM
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(multi_processor_count=H100_SMS))
    monkeypatch.setattr(batched_cuda, "kkt_window_occupancy",
                        lambda groups, smem, nq, dev: (80, 0, 1))
    monkeypatch.setattr(batched_cuda, "_K8A_PLANS", {})
    monkeypatch.setattr(batched_cuda, "_K8A_OCCUPANCY", {})
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


def _main_calls(nq, N):
    """K1-K4 and K4b, called at nq on N knots: {kernel: call}."""
    nx = 2 * nq
    m, xu, ee, sys_ = _inputs(nq, N)
    cost = CostConfig.for_knots(N)
    return {
        "K1": lambda: build_kkt_schur(m, cost, xu, xu[0, :nx], ee, 1e-3, 1 / 64),
        "K2": lambda: pcg_dz_solve(sys_, torch.zeros((N, nx)), xu[:, nx:], 1e-3,
                                   0.1, max_iter=5),
        "K3": lambda: line_search_merits_fused(m, cost, xu, xu, xu[0, :nx], ee,
                                               1.0, 1 / 64),
        "K4": lambda: simulate_plant(m, xu[0, :nx], xu, 2e-3, 2e-3, 1 / 64, 10,
                                     2e-4),
        "K4b": lambda: simulate_plant_batched(
            m, xu[:3, :nx].contiguous(), xu.expand(3, N, 3 * nq).contiguous(),
            2e-3, 2e-3, 1 / 64, 10, 2e-4),
    }


@pytest.mark.parametrize("nq", NQS)
@pytest.mark.parametrize("N", [2, 37, 64, 512])
def test_k1_to_k4_launch_the_plan_of_their_nq(recorder, nq, N):
    nx = 2 * nq
    for call in _main_calls(nq, N).values():
        call()
    names = [(src, name, q) for src, name, q, _ in recorder]
    assert names == [("kkt_schur.cu", "kkt_schur_launch", nq),
                     ("pcg_dz.cu", "pcg_dz_launch", nq),
                     ("merit.cu", "merit_launch", nq), ("plant.cu", "plant_launch", nq),
                     ("plant.cu", "plant_launch", nq)]
    a1, a2, a3, a4, a4b = (args for *_, args in recorder)
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


N_CALL, B_CALL, SHARDS, S_STEPS = 32, 3, 2, 4


def _slab_state(nq, L, n_shard=SHARDS):
    """K10a's state and inputs on n_shard slabs of L knots (zeros)."""
    nx, z = 2 * nq, torch.zeros
    st = {k: z((n_shard, L, nx)) for k in ("x", "r", "p", "s", "u", "w")}
    st.update(pkt=z((n_shard, 2, 6, nx)), dots=z((n_shard, 3)),
              scal=z((n_shard, 2)), iters=z(n_shard, dtype=torch.int32))
    blocks = z((n_shard, L, 3, nx, nx))
    return st, (blocks, blocks.clone(), z((n_shard, 6, nx)), z((n_shard, 6, nx)),
                z((n_shard, 3, nx, nx)), z((n_shard, 3, nx, nx)), z((n_shard, 3)))


def _ca_state(nq, L, s=S_STEPS, n_shard=SHARDS):
    """The s-step state and K10b's inputs on n_shard slabs of L knots."""
    nx, z, h = 2 * nq, torch.zeros, 2 * s + 1
    st = {k: z((n_shard, L, nx)) for k in ("x", "r", "z", "p")}
    st.update(Y=z((n_shard, h, L, nx), dtype=WORK), Yt=z((n_shard, h, L, nx), dtype=WORK),
              pkt=z((n_shard, 2, 2, h, nx)),
              parts=z((n_shard, n_parts(s)), dtype=WORK),
              scal=z((n_shard, 2), dtype=WORK),
              iters=z(n_shard, dtype=torch.int32), done=z(n_shard, dtype=torch.int32))
    halo = lambda: z((n_shard, h, 3, nx, nx))
    return st, (z((n_shard, L, 3, nx, nx)), z((n_shard, L, 3, nx, nx)), halo(),
                halo(), halo(), halo(), z((n_shard, 2, h, nx)), z((n_shard, 2, h, nx)))


def _kernel_calls(nq):
    """Every wrapper beside K1-K4, called at nq: (kernel, source, entry,
    call, the launch arguments it must pass as {index: value})."""
    N, B, n_sh = N_CALL, B_CALL, SHARDS
    L, nx, w = N // n_sh, 2 * nq, 3 * nq
    m, xu, ee, sys_ = _inputs(nq, N)
    cost = CostConfig.for_knots(N)
    z = torch.zeros
    rep = lambda t, b: t.expand(b, *t.shape).contiguous()
    at = lambda i, *v: dict(zip(range(i, i + len(v)), v))
    window = kkt_window_plan(N, nq=nq).window
    k7, k9a = pcr_plan(N, nx), kkt_window_plan(L + 4, K9A_MAX_KNOTS, nq)
    k8a = kkt_batched_plan(N, B, nq, H100_SMS, one_cta_an_sm)
    sys_b = {k: rep(v, B) for k, v in sys_.items()}
    sys_s = {k: v.reshape(n_sh, L, *v.shape[1:]) for k, v in sys_.items()}
    st10a, in10a = _slab_state(nq, L)
    st10b, in10b = _ca_state(nq, L)
    xu_b = rep(xu, B)
    return {
        "K5": ("kkt_schur.cu", "kkt_launch",
               lambda: build_kkt_cuda(m, cost, xu, xu[0, :nx], ee, 1 / 64),
               at(9, N, window, kkt_smem_bytes(window, False, nq))),
        "K2'": ("pcg_dz.cu", "pcg_launch",
                lambda: pcg_solve_cuda(sys_["S"], sys_["Pinv"], sys_["gamma"],
                                       z((N, nx))),
                at(7, N, *k2_cluster_plan(N, nx), 1)),
        "K6": ("pcg_dz.cu", "dz_warp_launch",
               lambda: compute_dz_cuda(sys_, z((N, nx)), xu[:, nx:], 1e-3, 0.1),
               {7: N, 9: w, 12: 0, **at(14, N, 1, *dz_plan(N, nx))}),
        "K7": ("pcr.cu", "pcr_launch",
               lambda: pcr_solve_cuda(sys_["S"], z((N, nx))),
               at(2, N, pcr_levels(N), 1, k7.ctas, int(k7.cluster), k7.smem_bytes)),
        "K8a": ("kkt_schur.cu", "kkt_schur_batched_launch",
                lambda: build_kkt_schur_batched(m, cost, xu_b, z((B, nx)),
                                                rep(ee, B), z(B), 1 / 64),
                at(12, N, B, k8a.window, k8a.groups, k8a.smem_bytes)),
        "K8b": ("pcg_dz.cu", "pcg_launch",
                lambda: pcg_solve_batched(sys_b["S"], sys_b["Pinv"], sys_b["gamma"],
                                          z((B, N, nx))),
                at(7, N, *k2_cluster_plan(N, nx), B)),
        "K8c": ("pcg_dz.cu", "dz_warp_launch",
                lambda: compute_dz_batched(sys_b, z((B, N, nx)), xu_b[..., nx:],
                                           z(B), 0.1),
                {7: N, 9: w, 10: N * w, 12: 1, **at(14, N, B, *dz_plan(N, nx))}),
        "K3b": ("merit.cu", "merit_launch",
                lambda: line_search_merits_batched(m, cost, xu_b, xu_b, z((B, nx)),
                                                   rep(ee, B), 1.0, 1 / 64),
                at(12, N, 9, B, *merit_team_plan(N, 9 * N * B, nq))),
        "K9a": ("kkt_schur.cu", "kkt_schur_slab_launch",
                lambda: build_kkt_schur_slab(m, cost, rep(xu[:L + 4], n_sh),
                                             rep(ee[:L + 4], n_sh), z((n_sh, L + 4)),
                                             z((n_sh, L + 4)), 1e-3, 1 / 64),
                at(10, L + 4, n_sh, k9a.window, k9a.smem_bytes)),
        "K9b": ("pcg_dz.cu", "dz_warp_launch",
                lambda: compute_dz_slab(sys_s, z((n_sh, L, nx)), z((n_sh, L, nx)),
                                        z((n_sh, L)),
                                        xu.reshape(n_sh, L, w)[..., nx:], 1e-3, 0.1),
                {7: L, 9: w, 10: L * w, 12: 0, **at(14, L, n_sh, *dz_plan(L, nx))}),
        "K9c": ("merit.cu", "merit_partials_launch",
                lambda: line_search_merit_partials_slab(
                    m, cost, rep(xu[:L + 1], n_sh), rep(xu[:L + 1], n_sh),
                    rep(ee[:L + 1], n_sh), 1 / 64),
                at(10, L + 1, 9, n_sh, *merit_team_plan(L + 1, 9 * (L + 1) * n_sh, nq))),
        "K10a": ("pcg_slab.cu", "pcg_slab_launch",
                 lambda: pcg_slab_step_cuda(st10a, *in10a, 5, 0.0, "eta", False),
                 at(19, L, n_sh, *slab_cluster_plan(L, nx=nx))),
        "K10b": ("pcg_ca.cu", "ca_basis_launch",
                 lambda: ca_basis_cuda(st10b, *in10b, 5, S_STEPS),
                 {**at(18, L, S_STEPS, n_sh),
                  **at(22, *(int(v) for v in ca_cluster_plan(L, S_STEPS, nx=nx)))}),
        "K10b'": ("pcg_ca.cu", "ca_coeff_launch",
                  lambda: ca_coeff_step_cuda(st10b, z((n_sh, n_parts(S_STEPS)),
                                                      dtype=WORK),
                                             5, 0.0, "eta", S_STEPS),
                  at(12, L, S_STEPS, n_sh, *coeff_plan(L, S_STEPS, nx=nx))),
    }


KERNELS = ("K5", "K2'", "K6", "K7", "K8a", "K8b", "K8c", "K3b", "K9a", "K9b",
           "K9c", "K10a", "K10b", "K10b'")


@pytest.mark.parametrize("nq", [3, 5])
@pytest.mark.parametrize("kernel", KERNELS)
def test_every_wrapper_launches_the_plan_and_library_of_its_nq(recorder, kernel, nq):
    """One launch, from the library of the kernel's source built for nq,
    with the plan of that nq (N = 32; B = 3 instances; 2 knot shards)."""
    src, name, call, want = _kernel_calls(nq)[kernel]
    call()
    assert [(s_, n_, q) for s_, n_, q, _ in recorder] == [(src, name, nq)]
    args = recorder[0][3]
    assert want and {i: args[i] for i in want} == want


@pytest.mark.parametrize("kernel", ("K1", "K2", "K3", "K4", "K4b") + KERNELS)
def test_every_wrapper_launches_under_its_tensors_card(recorder, kernel):
    """Each wrapper calls its entry inside the card guard of its tensors'
    device, whatever card the caller left current (cuda:0 in the
    recorder): one launch, made current for it the tensors' device (here
    the CPU, as the recorder takes CPU tensors for the card's)."""
    calls = {**_main_calls(5, N_CALL),
             **{k: v[2] for k, v in _kernel_calls(5).items()}}
    calls[kernel]()
    assert len(recorder) == 1
    assert recorder.cards == [torch.device("cpu")]
