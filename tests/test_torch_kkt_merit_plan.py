"""K1's window plan (``solver/kkt_cuda.py::kkt_window_plan``), K8a's
(``kkt_batched_plan``), K3's team plan
(``solver/merit_cuda.py::merit_team_plan``) and what the wrappers of K1, K5,
K8a, K9a, K3, K3b and K9c hand their launches.

The kernels run only on the card (``chip_smoke.py`` holds them against
their plain versions there).  Here: the plans are valid for every N the
kernels take and agree with the constants of ``csrc/kkt_schur.cu`` and
``csrc/merit.cu``; the wrappers pass the same plan for the same N (the
launch replaced by a recorder, so no card is needed); and K9a's plain
version, run over K1's windows with their halo knots, reproduces K1's plain
rows at f64 bit for bit, the decomposition the one-launch K1 relies on.
"""

import contextlib
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.config import CostConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.parallel import batched_cuda
from mpcgpu_tpu_torch.parallel.batched_cuda import (build_kkt_schur_batched,
                                                    line_search_merits_batched)
from mpcgpu_tpu_torch.solver import kkt_cuda, merit_cuda
from mpcgpu_tpu_torch.solver.kkt_cuda import (build_kkt_cuda, build_kkt_schur,
                                              build_kkt_schur_plain,
                                              build_kkt_schur_slab,
                                              build_kkt_schur_slab_plain,
                                              kkt_batched_plan, kkt_smem_bytes,
                                              kkt_window_plan)
from mpcgpu_tpu_torch.solver.merit_cuda import (line_search_merit_partials_slab,
                                                line_search_merits_fused,
                                                merit_smem_bytes,
                                                merit_team_plan)
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

SMEM_LIMIT = 232_448     # one block's dynamic shared memory on an H100
CSRC = Path(kkt_cuda.__file__).resolve().parents[1] / "csrc"
H100_SMS = 132
# K8a's CTAs an SM on the H100 at every nq, window and group count of its
# plans: one (the register file; kkt_window_occupancy on the card)
one_cta_an_sm = lambda groups, smem: 1


def _constexprs(*names: str) -> dict:
    """Every file-scope ``constexpr int NAME = expr;`` of the given csrc files
    (common.cuh first), evaluated in order."""
    env = {}
    for name in ("common.cuh",) + names:
        for key, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                    (CSRC / name).read_text(), re.M):
            env[key] = eval(expr, {}, dict(env))
    return env


def _function_body(src: str, name: str) -> str:
    body = re.search(name + r"\([^)]*\) \{(.*?)\}", src, re.S).group(1)
    return " ".join(re.sub(r"//[^\n]*", "", body).replace("return", "")
                    .replace(";", "").split())


@pytest.mark.parametrize("lo,hi", [(2, 65), (65, 257), (257, 513)])
def test_window_plan_is_valid_for_every_knot_count(lo, hi):
    for N in range(lo, hi):
        plan = kkt_window_plan(N)
        Kc = plan.window
        assert plan == kkt_window_plan(N), N        # a fixed function of N
        assert 1 <= Kc <= N and plan.ctas == -(-N // Kc), (N, plan)
        assert Kc + 3 <= kkt_cuda.KKT_MAX_GROUPS, (N, plan)
        assert plan.smem_bytes == kkt_smem_bytes(Kc) <= SMEM_LIMIT, (N, plan)
        assert kkt_smem_bytes(Kc, schur=False) <= SMEM_LIMIT
        owned = []
        for w in range(plan.ctas):
            s, e = w * Kc, min(N, (w + 1) * Kc)
            assert s < e, (N, w)
            owned += range(s, e)
            # stage 1 (the knot stage) runs on knots s - 2 .. e inside the
            # horizon; every neighbour the own rows' Schur blocks and stair
            # bands read (T two knots back, D one knot on each side) is in it
            stage1 = set(range(max(0, s - 2), min(N, e + 1)))
            assert len(stage1) <= Kc + 3
            for k in range(s, e):
                assert {j for j in (k - 2, k - 1, k, k + 1) if 0 <= j < N} <= stage1
        assert owned == list(range(N)), N           # the windows cover once


def test_window_plan_at_the_main_sizes():
    assert kkt_window_plan(64) == kkt_cuda.KKTPlan(4, 16, kkt_smem_bytes(4))
    assert kkt_window_plan(512).ctas == 128
    assert kkt_window_plan(68).ctas == 17       # K9a's shard at N = 512 / 8
    assert kkt_window_plan(2).window == 2
    with pytest.raises(ValueError, match="knots"):
        kkt_window_plan(513)


def test_kkt_plan_constants_match_the_cuda_source():
    consts = _constexprs("kkt_schur.cu")
    assert consts["SLOT_FLOATS"] == kkt_cuda._SLOT_FLOATS
    assert consts["WS_FLOATS"] == kkt_cuda._WS_FLOATS
    assert consts["MODEL_SIZE"] == kkt_cuda._MODEL_FLOATS
    assert consts["KKT_MAX_GROUPS"] == kkt_cuda.KKT_MAX_GROUPS
    assert 2 * consts["KKT_MAX_GROUPS"] <= 15      # named barriers 1..15
    # the kernel's own count of its shared memory, evaluated here
    terms = _function_body((CSRC / "kkt_schur.cu").read_text(), "kkt_smem_floats")
    assert terms == ("MODEL_SIZE + (schur ? (Kc + 3) * SLOT_FLOATS : 0) "
                     "+ groups * WS_FLOATS")
    for Kc in (1, 2, 4):
        for schur in (True, False):
            groups = Kc + 3 if schur else Kc
            floats = (consts["MODEL_SIZE"]
                      + ((Kc + 3) * consts["SLOT_FLOATS"] if schur else 0)
                      + groups * consts["WS_FLOATS"])
            assert 4 * floats == kkt_smem_bytes(Kc, schur)
    # K8a's long windows: fewer groups than slots
    for Kc, groups in ((32, 7), (16, 7), (49, 7), (8, 1)):
        floats = (consts["MODEL_SIZE"] + (Kc + 3) * consts["SLOT_FLOATS"]
                  + groups * consts["WS_FLOATS"])
        assert 4 * floats == kkt_smem_bytes(Kc, groups=groups)


@pytest.mark.parametrize("N", [2, 16, 33, 64, 100, 512])
@pytest.mark.parametrize("team", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("samples", [32, 64, 128])
def test_team_plan_is_valid(monkeypatch, N, team, samples):
    """The default plans and every plan the team sweep launches."""
    monkeypatch.setattr(merit_cuda, "MERIT_SMALL", (team, samples))
    monkeypatch.setattr(merit_cuda, "MERIT_LARGE", (team, samples))
    plan = merit_team_plan(N, 9 * N)
    G, P, smem = plan
    assert G == team and P <= samples, plan
    assert 32 <= P * G <= merit_cuda.merit_max_threads(G), plan
    assert (P * G) % 32 == 0 and P <= -(-N // 32) * 32, plan
    assert smem == merit_smem_bytes(G, P, N) <= SMEM_LIMIT, plan
    assert merit_team_plan(N, 9 * N) == plan


def test_team_plan_at_the_main_sizes(monkeypatch):
    # K3 at N = 64 (576 samples): teams of 16, 32 samples a block
    assert merit_team_plan(64, 9 * 64)[:2] == merit_cuda.MERIT_SMALL == (16, 32)
    # K3b at B = 256 and K3 at N = 512: a thread per sample, 64 a block
    assert merit_team_plan(64, 9 * 64 * 256)[:2] == merit_cuda.MERIT_LARGE == (1, 64)
    assert merit_team_plan(512, 9 * 512)[:2] == (1, 64)
    assert merit_team_plan(16, 9 * 16 * 256)[:2] == (1, 32)
    monkeypatch.setattr(merit_cuda, "MERIT_SMALL", (3, 64))
    with pytest.raises(ValueError, match="team"):
        merit_team_plan(64, 9 * 64)


def test_merit_plan_constants_match_the_cuda_source():
    consts = _constexprs("merit.cu")
    assert consts["SAMPLE_STRIDE"] == merit_cuda._SAMPLE_STRIDE
    assert consts["SAMPLE_STRIDE"] % 2 == 1
    assert consts["MODEL_SIZE"] == merit_cuda._MODEL_FLOATS
    assert consts["VEC_STRIDE"] == merit_cuda._VEC_STRIDE
    assert consts["MERIT_MAX_THREADS"] == merit_cuda.MERIT_MAX_THREADS
    assert consts["MERIT_MAX_THREADS_G1"] == merit_cuda.MERIT_MAX_THREADS_G1
    terms = _function_body((CSRC / "merit.cu").read_text(), "merit_smem_floats")
    assert terms == ("MODEL_SIZE + P * (G == 1 ? VEC_STRIDE : SAMPLE_STRIDE) "
                     "+ 2 * N + 33")
    for G, P, N in ((1, 64, 64), (8, 32, 64), (16, 64, 512), (4, 1, 2)):
        stride = consts["VEC_STRIDE"] if G == 1 else consts["SAMPLE_STRIDE"]
        floats = consts["MODEL_SIZE"] + P * stride + 2 * N + 33
        assert 4 * floats == merit_smem_bytes(G, P, N)


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
    # K8a's plan: an H100's SM count and CTAs an SM
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(multi_processor_count=H100_SMS))
    monkeypatch.setattr(batched_cuda, "kkt_window_occupancy",
                        lambda groups, smem, nq, dev: (80, 0, 1))
    monkeypatch.setattr(batched_cuda, "_K8A_PLANS", {})
    monkeypatch.setattr(batched_cuda, "_K8A_OCCUPANCY", {})
    return calls


@pytest.mark.parametrize("N", [2, 33, 64, 512])
def test_k1_k5_k8a_k9a_launch_the_same_windows(recorder, N):
    """K1, K5 and K9a launch K1's windows; K8a its own entry with its plan
    (Kc, G, smem), which at 3 instances is K1's windows again."""
    m = iiwa14(torch.float32, device="cpu")
    cost = CostConfig.for_knots(N)
    xu, ee = torch.zeros((N, 21)), torch.zeros((N, 6))
    build_kkt_schur(m, cost, xu, xu[0, :14], ee, 1e-3, 1 / 64)
    build_kkt_cuda(m, cost, xu, xu[0, :14], ee, 1 / 64)
    build_kkt_schur_batched(m, cost, xu.expand(3, N, 21).contiguous(),
                            torch.zeros((3, 14)), ee.expand(3, N, 6).contiguous(),
                            torch.full((3,), 1e-3), 1 / 64)
    z = torch.zeros((2, N))
    build_kkt_schur_slab(m, cost, xu.expand(2, N, 21).contiguous(),
                         ee.expand(2, N, 6).contiguous(), z, z, 1e-3, 1 / 64)
    (n1, a1), (n5, a5), (n8, a8), (n9, a9) = recorder
    assert (n1, n5, n8, n9) == ("kkt_schur_launch", "kkt_launch",
                                "kkt_schur_batched_launch", "kkt_schur_slab_launch")
    plan = kkt_window_plan(N)
    # kkt_schur_launch: ..., N, batch, Kc, smem, ...; kkt_schur_slab_launch:
    # ..., Lext, n_shard, Kc, smem, ...; kkt_launch: ..., N, Kc, smem, ...;
    # kkt_schur_batched_launch: ..., N, batch, Kc, groups, smem, ...
    assert tuple(a1[12:16]) == (N, 1, plan.window, plan.smem_bytes)
    k8a = kkt_batched_plan(N, 3, 7, H100_SMS, one_cta_an_sm)
    assert tuple(a8[12:17]) == (N, 3, k8a.window, k8a.groups, k8a.smem_bytes)
    assert (k8a.window, k8a.groups, k8a.smem_bytes) == (
        plan.window, plan.window + 3, plan.smem_bytes)
    assert tuple(a9[10:14]) == (N, 2, plan.window, plan.smem_bytes)
    assert tuple(a5[9:12]) == (N, plan.window, kkt_smem_bytes(plan.window, False))


@pytest.mark.parametrize("N", [2, 33, 64, 512])
def test_k3_k3b_k9c_launch_the_team_rule(recorder, N):
    m = iiwa14(torch.float32, device="cpu")
    cost = CostConfig.for_knots(N)
    xu, ee = torch.zeros((N, 21)), torch.zeros((N, 6))
    line_search_merits_fused(m, cost, xu, xu, xu[0, :14], ee, 1.0, 1 / 64)
    B = 256
    xb, eb = xu.expand(B, N, 21).contiguous(), ee.expand(B, N, 6).contiguous()
    line_search_merits_batched(m, cost, xb, xb, torch.zeros((B, 14)), eb, 1.0, 1 / 64)
    line_search_merit_partials_slab(m, cost, xb[:8], xb[:8], eb[:8], 1 / 64)
    (n3, a3), (nb, ab), (nc, ac) = recorder
    assert (n3, nb, nc) == ("merit_launch", "merit_launch", "merit_partials_launch")
    # merit_launch: ..., N, num_cand, batch, G, P, smem, ...;
    # merit_partials_launch: ..., N, num_cand, n_shard, G, P, smem, ...
    # one rule: the plan of the launch's sample count
    assert tuple(a3[12:18]) == (N, 9, 1, *merit_team_plan(N, 9 * N))
    assert tuple(ab[12:18]) == (N, 9, B, *merit_team_plan(N, 9 * N * B))
    assert tuple(ac[10:16]) == (N, 9, 8, *merit_team_plan(N, 9 * N * 8))


@pytest.mark.parametrize("include_zero,angle_wrap",
                         [(True, False), (False, False), (True, True), (False, True)])
def test_k3_k3b_k9a_k9c_pass_their_flags(recorder, include_zero, angle_wrap):
    """The flags reach their slots: merit_launch's wrap, zero; K3b's zero
    always 1 (the JAX batched solve's include_zero=True);
    merit_partials_launch's integrator_type, wrap, zero;
    kkt_schur_slab_launch's integrator_type, wrap, terminal_at_last.  The
    candidate count and the alphas' length follow include_zero."""
    N, B = 33, 4
    m = iiwa14(torch.float32, device="cpu")
    cost = CostConfig.for_knots(N)
    xu, ee = torch.zeros((N, 21)), torch.zeros((N, 6))
    flags = dict(include_zero=include_zero, angle_wrap=angle_wrap)
    merits, alphas = line_search_merits_fused(m, cost, xu, xu, xu[0, :14], ee,
                                              1.0, 1 / 64, 8, 1, **flags)
    xb, eb = xu.expand(B, N, 21).contiguous(), ee.expand(B, N, 6).contiguous()
    line_search_merits_batched(m, cost, xb, xb, torch.zeros((B, 14)), eb, 1.0,
                               1 / 64, angle_wrap=angle_wrap)
    pc, pd, pa = line_search_merit_partials_slab(m, cost, xb, xb, eb, 1 / 64, 8, 1,
                                                 **flags)
    z = torch.zeros((B, N))
    build_kkt_schur_slab(m, cost, xb, eb, z, z, 1e-3, 1 / 64, 1,
                         angle_wrap=angle_wrap)
    (n3, a3), (nb, ab), (nc, ac), (n9, a9) = recorder
    A = 8 + include_zero
    wrap, zero = int(angle_wrap), int(include_zero)
    # merit_launch: ..., N, num_cand, batch, G, P, smem, integrator_type,
    # wrap, zero, merits, ...
    assert tuple(a3[12:21]) == (N, A, 1, *merit_team_plan(N, A * N), 1, wrap, zero)
    assert tuple(ab[12:21]) == (N, 9, B, *merit_team_plan(N, 9 * N * B), 0, wrap, 1)
    # merit_partials_launch: ..., N, num_cand, n_shard, G, P, smem,
    # integrator_type, wrap, zero, part, ...
    assert tuple(ac[10:19]) == (N, A, B, *merit_team_plan(N, A * N * B), 1, wrap, zero)
    # kkt_schur_slab_launch: ..., Lext, n_shard, Kc, smem, integrator_type,
    # wrap, terminal_at_last, S, ...
    plan = kkt_window_plan(N, kkt_cuda.K9A_MAX_KNOTS)
    assert tuple(a9[10:17]) == (N, B, plan.window, plan.smem_bytes, 1, wrap,
                                int(cost.terminal_at_last_state))
    assert merits.shape == alphas.shape == (A,)
    assert pc.shape == pd.shape == (B, A, N) and pa.shape == (A,)


def _slab_plain(m, cost, xu, ee, knots, N):
    """K9a's plain version on the given knots of the horizon, flagged at the
    global ends."""
    return build_kkt_schur_slab_plain(m, cost, xu[knots][None], ee[knots][None],
                                      (knots == 0)[None].double(),
                                      (knots == N - 1)[None].double(), 1e-3, 1 / 64)


@pytest.mark.parametrize("N", [16, 33, 64])
def test_k9a_plain_over_the_windows_reproduces_k1_plain(N):
    """Each window of the plan, with its two halo knots on the left and one
    on the right, gives its own rows exactly as the whole horizon does: bit
    for bit against K9a's plain version over all N knots (the kernel's
    order), and against K1's plain version in every output but gamma, which
    ``build_kkt_schur_plain`` forms through ``form_schur_system`` in another
    association (the two plain versions' gamma differ by an ulp at f64)."""
    m = iiwa14(torch.float64, device="cpu")
    cost = CostConfig.for_knots(N)
    rng = np.random.default_rng(N)
    xu = torch.tensor(load_xu_traj("0_0")[:N] + 0.01 * rng.standard_normal((N, 21)))
    ee = torch.tensor(load_eepos_traj("0_0")[:N])
    k1 = build_kkt_schur_plain(m, cost, xu, xu[0, :14], ee, 1e-3, 1 / 64)
    whole = _slab_plain(m, cost, xu, ee, torch.arange(N), N)
    plan = kkt_window_plan(N)
    for w in range(plan.ctas):
        s, e = w * plan.window, min(N, (w + 1) * plan.window)
        ext = torch.arange(max(0, s - 2), min(N, e + 1))
        got = _slab_plain(m, cost, xu, ee, ext, N)
        own = slice(s - int(ext[0]), e - int(ext[0]))
        for key, ref in k1.items():
            assert torch.equal(got[key][0, own], whole[key][0, s:e]), (N, w, key)
            if key == "gamma":
                torch.testing.assert_close(got[key][0, own], ref[s:e], rtol=1e-15,
                                           atol=1e-15)
            else:
                assert torch.equal(got[key][0, own], ref[s:e]), (N, w, key)
