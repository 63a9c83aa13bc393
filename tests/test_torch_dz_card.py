"""The one dz kernel (``csrc/pcg_dz.cu::dz_warp_kernel``) on the card (marker
``card``, skipped without one).

K8c, the kernel over an instance axis with a rho each (``rho_bstride`` 1),
equals K6 on each instance's blocks bit for bit, on K8a's blocks and K8b's
lam at nq 7, 3 and 5; and K6 equals K2's fused dz bit for bit (the same
device functions).  The CPU tests of its plan, its alignment rule and its
split of the work are in ``test_torch_dz_plan.py`` and
``test_torch_nq_plans.py``.

On the chip: ``python3 -m pytest tests/test_torch_dz_card.py -m card -o
addopts="" --noconftest -q`` (no JAX there).
"""

import pytest
import torch

from mpcgpu_tpu_torch.config import CostConfig, PCGConfig
from mpcgpu_tpu_torch.models import iiwa14, planar_arm
from mpcgpu_tpu_torch.ops.pcg_cuda import compute_dz_cuda, pcg_dz_solve
from mpcgpu_tpu_torch.parallel import batched_cuda
from mpcgpu_tpu_torch.solver.kkt_cuda import build_kkt_schur
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

DT = 1.0 / 64.0


@pytest.fixture
def card():
    """The first card; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip with -m card)")
    return torch.device("cuda", 0)


def _batch(nq: int, B: int, N: int, card):
    """B instances of N knots: the IIWA on trace 3_4's calm first rows plus
    noise (nq 7), a planar arm on seeded joint angles and speeds (nq 3, 5);
    rho cycling through 1e-3 x (1, 2, 3, 4)."""
    g = torch.Generator().manual_seed(1)
    if nq == 7:
        model = iiwa14(torch.float32, device=card)
        xu = torch.tensor(load_xu_traj("3_4")[:N], dtype=torch.float32)
        xu = xu[None] + 0.01 * torch.randn((B, N, 21), generator=g)
        ee = torch.tensor(load_eepos_traj("3_4")[:N], dtype=torch.float32)
        ee = ee.expand(B, N, 6)
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
def test_card_k8c_equals_k6_per_instance(card, nq, B, N):
    """K8a -> K8b -> K8c; every instance's dz equals K6's on that
    instance's blocks, lam, controls and rho."""
    model, xu, xs, ee, rho = _batch(nq, B, N, card)
    nx = 2 * nq
    cost = CostConfig.for_knots(N)
    sys_ = batched_cuda.build_kkt_schur_batched(model, cost, xu, xs, ee, rho, DT)
    lam = batched_cuda.pcg_solve_batched(
        sys_["S"], sys_["Pinv"], sys_["gamma"], torch.zeros_like(sys_["gamma"]),
        max_iter=PCGConfig.tuned_max_iter(N), exit_tol=1e-5)[0]
    dz = batched_cuda.compute_dz_batched(sys_, lam, xu[:, :, nx:], rho, cost.r_cost)
    differ = [i for i in range(B) if not torch.equal(dz[i], compute_dz_cuda(
        {k: v[i] for k, v in sys_.items()}, lam[i], xu[i, :, nx:], rho[i],
        cost.r_cost))]
    assert differ == [] and bool(torch.isfinite(dz).all())


@pytest.mark.card
@pytest.mark.parametrize("nq, N", [(7, 64), (7, 512), (3, 64), (5, 64)])
def test_card_k6_equals_k2_fused_dz(card, nq, N):
    """K1 -> K2, and K6 on K1's blocks with K2's lam: K2's dz bit for bit."""
    model, xu, xs, ee, rho = _batch(nq, 1, N, card)
    nx = 2 * nq
    cost = CostConfig.for_knots(N)
    sys_ = build_kkt_schur(model, cost, xu[0], xs[0], ee[0], rho[0], DT)
    u = xu[0, :, nx:]
    lam, dz = pcg_dz_solve(sys_, torch.zeros_like(sys_["gamma"]), u, rho[0],
                           cost.r_cost, max_iter=PCGConfig.tuned_max_iter(N),
                           exit_tol=1e-5)[:2]
    assert torch.equal(compute_dz_cuda(sys_, lam, u, rho[0], cost.r_cost), dz)
