"""K8a's window plan on the card (marker ``card``, skipped without one).

Each instance of K8a under its plan (``solver/kkt_cuda.py::
kkt_batched_plan``: long windows whose groups take the slots in turn where
the batch fills the card) equals K1 on that instance bit for bit, at nq 7,
3 and 5; the plan reads the card's SM count and residency; and a traced
batched solve counts K8a's knot stages, which
``portbench/metrics/k8a_recompute_pct.py`` reads.  The CPU tests of the plan
are in ``test_torch_nq_plans.py`` and ``test_torch_kkt_merit_plan.py``.

On the chip: ``python3 -m pytest tests/test_torch_k8a_card.py -m card -o
addopts="" --noconftest -q`` (no JAX there).
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from mpcgpu_tpu_torch.config import CostConfig, PCGConfig, SQPConfig
from mpcgpu_tpu_torch.models import iiwa14, planar_arm
from mpcgpu_tpu_torch.parallel import batched_cuda
from mpcgpu_tpu_torch.solver.kkt_cuda import (build_kkt_schur, kkt_smem_bytes,
                                              kkt_window_occupancy, kkt_window_plan)
from mpcgpu_tpu_torch.utils import profiling
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

DT = 1.0 / 64.0


@pytest.fixture
def card():
    """The first card; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip with -m card)")
    return torch.device("cuda", 0)


def _batch(nq: int, B: int, N: int, card, seed: int = 0):
    """B instances of N knots: the IIWA on trace 0_0 plus noise (nq 7), a
    planar arm on seeded joint angles and speeds (nq 3, 5); rho cycling
    through 1e-3 x (1, 2, 3, 4)."""
    g = torch.Generator().manual_seed(seed)
    if nq == 7:
        model = iiwa14(torch.float32, device=card)
        xu = torch.tensor(load_xu_traj("0_0")[:N], dtype=torch.float32)
        xu = xu[None] + 0.01 * torch.randn((B, N, 21), generator=g)
        ee = torch.tensor(load_eepos_traj("0_0")[:N], dtype=torch.float32)
        ee = ee.expand(B, N, 6).contiguous()
    else:
        model = planar_arm(nq, device=card)
        xu = 0.3 * torch.randn((B, N, 3 * nq), generator=g)
        ee = torch.cat([0.5 * torch.rand((B, N, 3), generator=g),
                        torch.zeros((B, N, 3))], -1)
    rho = 1e-3 * (1 + torch.arange(B) % 4).float()
    to = lambda t: t.to(card).contiguous()
    return model, to(xu), to(xu[:, 0, :2 * nq]), to(ee), to(rho)


@pytest.mark.card
@pytest.mark.parametrize("nq, B, N", [(7, 256, 64), (7, 16, 512), (3, 64, 64),
                                      (5, 64, 64)])
def test_card_k8a_equals_k1_bit_for_bit(card, nq, B, N):
    """Every output of every instance of K8a under its plan equals K1's on
    that instance; the plans are long windows at these batches."""
    model, xu, xs, ee, rho = _batch(nq, B, N, card)
    cost = CostConfig.for_knots(N)
    plan = batched_cuda.k8a_plan(N, B, nq, card)
    assert plan.window > kkt_window_plan(N).window and plan.groups == 7
    got = batched_cuda.build_kkt_schur_batched(model, cost, xu, xs, ee, rho, DT)
    differ = []
    for i in range(B):
        one = build_kkt_schur(model, cost, xu[i], xs[i], ee[i], rho[i], DT)
        differ += [(i, k) for k in one if not torch.equal(one[k], got[k][i])]
    assert differ == []


@pytest.mark.card
def test_card_k8a_plan_reads_the_card(card):
    """The H100's 132 SMs hold one K8a CTA of 7 groups each, at K1's
    windows as at the long ones: 256 arms of 64 knots take windows of 32
    (2 CTAs an arm, 4 waves of 5 rounds, not 32 waves of 1); 8 arms, whose
    K1 windows fit in one wave, keep K1's."""
    assert torch.cuda.get_device_properties(card).multi_processor_count == 132
    for Kc in (4, 32):
        regs, local, ctas = kkt_window_occupancy(7, kkt_smem_bytes(Kc, groups=7), 7, card)
        assert ctas == 1 and regs <= 80, (Kc, regs, local, ctas)
    plan = batched_cuda.k8a_plan(64, 256, 7, card)
    assert tuple(plan) == (32, 7, 2, kkt_smem_bytes(32, groups=7))
    k1 = kkt_window_plan(64)
    assert tuple(batched_cuda.k8a_plan(64, 8, 7, card)) == (
        k1.window, k1.window + 3, k1.ctas, k1.smem_bytes)


@pytest.mark.card
def test_card_k8a_counters_in_a_traced_solve(card):
    """A traced batched solve of 256 arms counts, per K8a launch, 256 x 67
    knot stages and 256 x 64 knots (windows of 32: 33 + 34 stages), which
    the benchmark's reader turns into 100 x 3 / 64 %; untraced, nothing."""
    model, xu, xs, ee, rho = _batch(7, 256, 64, card)
    cost = CostConfig.for_knots(64)
    sqp_cfg = SQPConfig(max_iter=2, max_time_us=None)
    pcg_cfg = PCGConfig(max_iter=PCGConfig.tuned_max_iter(64))
    lam = torch.zeros((256, 64, 14), device=card)
    solve = lambda: batched_cuda.sqp_solve_batched_fused(
        model, cost, sqp_cfg, pcg_cfg, xu, lam, xs, ee, rho, DT)
    profiling.reset()
    solve()
    assert profiling.counters()["k8a.knots"] == 0
    launches = batched_cuda.build_kkt_schur_batched.launches
    with profiling.trace():
        solve()
    n = batched_cuda.build_kkt_schur_batched.launches - launches
    c = profiling.counters()
    assert n >= 1
    assert (c["k8a.knot_stages"], c["k8a.knots"]) == (n * 256 * 67, n * 256 * 64)
    path = Path(__file__).resolve().parents[1] / "portbench/metrics/k8a_recompute_pct.py"
    spec = importlib.util.spec_from_file_location("k8a_recompute_pct", path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    assert reader.read({"traced": {"busy_s": 1.0}}) == pytest.approx(100 * 3 / 64)
