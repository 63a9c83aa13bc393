"""K6's and K9b's kernel (``csrc/pcg_dz.cu::dz_warp_kernel``): its plan, the
alignment its staging copies need, and its split of the work.

The kernel runs only on the card (``chip_smoke.py`` holds it there to the
earlier ``dz_kernel`` bit for bit and to the plain versions).  Here: the
plan ``dz_plan(N, nx)`` against the constants of the source evaluated with
``MPC_NQ`` set (nq = 2..7); the wrappers refuse an input whose base
address the 16- and 8-byte copies cannot take, before any launch (the
launch is a recorder); and a torch emulation of the kernel's split (a
window of knots per CTA, a knot per warp, a lane per output, every input
of a knot staged before it is used, each sum in the device functions'
order) at f64 against the plain versions ``compute_dz_plain`` /
``compute_dz_slab_plain`` and the JAX ``compute_dz`` /
``compute_dz_pallas_slab`` (interpret mode) oracles.
"""

import contextlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpcgpu_tpu.ops import schur as jschur
from mpcgpu_tpu.solver import kkt as jkkt
from mpcgpu_tpu.solver.kkt_pallas import compute_dz_pallas_slab
from mpcgpu_tpu.config import CostConfig as JCostConfig
from mpcgpu_tpu.models import iiwa14 as jax_iiwa14
from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.config import CostConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.ops import pcg_cuda
from mpcgpu_tpu_torch.ops.pcg_cuda import (DZ_ALIGN, DzPlan, compute_dz_cuda,
                                           compute_dz_plain, compute_dz_slab,
                                           compute_dz_slab_plain, dz_knot_floats,
                                           dz_plan)
from mpcgpu_tpu_torch.solver.kkt_cuda import build_kkt_schur
from mpcgpu_tpu_torch.utils.trajfiles import load_eepos_traj, load_xu_traj

torch.set_num_threads(1)

CSRC = Path(pcg_cuda.__file__).resolve().parents[1] / "csrc"
NQS = (2, 3, 4, 5, 6, 7)
STATIC_SMEM = 48 * 1024     # dynamic shared memory a launch takes unasked
DT = 1.0 / 64.0
RHO = 1e-3


def _constexprs(nq: int) -> dict:
    """Every file-scope ``constexpr int`` of common.cuh and pcg_dz.cu with
    MPC_NQ = nq (C's integer division)."""
    env = {"MPC_NQ": nq, "k2_threads": lambda kp: 0}
    for name in ("common.cuh", "pcg_dz.cu"):
        for key, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                    (CSRC / name).read_text(), re.M):
            if key != "MPC_NQ":
                env[key] = int(eval(expr.replace("/", "//"), {}, dict(env)))
    return env


def _kernel_body() -> str:
    src = (CSRC / "pcg_dz.cu").read_text()
    return re.search(r"\ndz_warp_kernel\(.*?\n\}\n", src, re.S).group(0)


@pytest.mark.parametrize("N", [2, 37, 64, 512])
@pytest.mark.parametrize("nq", NQS)
def test_dz_plan_matches_the_source(nq, N):
    nx = 2 * nq
    c = _constexprs(nq)
    assert c["DZ_KNOT_FLOATS"] == dz_knot_floats(nx)
    assert c["DZ_MAX_KPC"] == pcg_cuda.DZ_MAX_KPC
    # the slot: Qinv, A on 16-byte offsets, B, q, lam, lam_{k+1} on 8-byte
    # ones, everything inside the padded slot
    assert c["DZ_A"] % 4 == 0 and c["DZ_KNOT_FLOATS"] % 4 == 0
    assert all(c[k] % 2 == 0 for k in ("DZ_B", "DZ_Q", "DZ_LAM", "DZ_LAMN"))
    assert c["DZ_LAST"] < c["DZ_KNOT_FLOATS"] and c["W"] <= 32
    plan = dz_plan(N, nx)
    kpc, ctas, smem = plan
    assert plan[:2] == dz_plan(N)[:2]               # the split: N alone
    assert 1 <= kpc <= pcg_cuda.DZ_MAX_KPC and kpc == min(pcg_cuda.DZ_KNOTS_PER_CTA, N)
    assert ctas * kpc >= N > (ctas - 1) * kpc       # every CTA has a knot
    assert smem == 4 * kpc * c["DZ_KNOT_FLOATS"] <= STATIC_SMEM


def test_dz_plan_at_the_main_sizes():
    assert dz_plan(64) == DzPlan(4, 16, 4 * 4 * 556)
    assert dz_plan(512) == DzPlan(4, 128, 4 * 4 * 556)
    assert dz_plan(2) == DzPlan(2, 1, 4 * 2 * 556)
    with pytest.raises(ValueError, match="knots"):
        dz_plan(513)


def test_alignment_rule_is_the_kernels_copies():
    """DZ_ALIGN names each input the kernel stages in 16- or 8-byte copies
    with that chunk; a knot's block, row or shard slab is a whole number of
    chunks at every even nx, so the base is all the wrapper checks."""
    body = _kernel_body()
    staged = re.findall(r"stage<(\d+), [^>]+>\(s \+ \w+, (\w+) \+", body)
    chunks = {name: int(b) for b, name in staged if int(b) > 4}
    assert chunks == DZ_ALIGN
    for nq in NQS:
        nx = 2 * nq
        assert 4 * nx * nx % 16 == 0 and 4 * nx * nq % 8 == 0 and 4 * nx % 8 == 0


def test_no_load_before_the_dependency_wait():
    """Before griddepcontrol.wait the kernel only computes indices: no
    copy, and no pointer parameter read."""
    body = _kernel_body()
    head = body[:body.index("griddep_wait();")]
    assert "cp_async" not in head and "stage<" not in head
    for name in ("lam", "lam_next", "lastm", "Qinv", "A", "B", "q", "u", "rho_p"):
        assert not re.search(rf"(?<![\w.]){name}\[|\*{name}\b", head), name


@pytest.fixture
def recorder(monkeypatch):
    """The launches replaced by a recorder; CPU tensors taken as if they
    were on the card (the shape checks stay)."""
    calls = []

    def entry(src, name, nq):
        def launch(*args):
            calls.append((name, args))
            return 0
        return launch

    monkeypatch.setattr(_kernels, "on_cpu", lambda t: False)
    real = _kernels.require
    monkeypatch.setattr(_kernels, "require",
                        lambda t, name, shape, device, **kw: real(t, name, shape, t.device, **kw))
    monkeypatch.setattr(_kernels, "entry", entry)
    monkeypatch.setattr(_kernels, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return calls


def _shifted(shape, floats: int):
    """A contiguous f32 tensor of `shape` whose base lies `floats` floats
    past an allocation's start."""
    n = int(np.prod(shape))
    return torch.zeros(n + floats)[floats:].view(shape)


def _k6_inputs(N=8, nq=7, shift=None):
    nx = 2 * nq
    shapes = {"Qinv": (N, nx, nx), "A": (N, nx, nx), "B": (N, nx, nq), "q": (N, nx),
              "lam": (N, nx)}
    t = {k: _shifted(s, 1 if k == shift else 0) for k, s in shapes.items()}
    return t, torch.zeros((N, 3 * nq))


@pytest.mark.parametrize("shift", [None, "Qinv", "A", "B", "q", "lam"])
def test_k6_refuses_a_base_its_copies_cannot_take(recorder, shift):
    t, xu = _k6_inputs(shift=shift)
    lam = t.pop("lam")
    call = lambda: compute_dz_cuda(t, lam, xu[:, 14:], RHO, 0.1)
    if shift is None:
        call()
        assert [n for n, _ in recorder] == ["dz_warp_launch"]
    else:
        with pytest.raises(ValueError, match=f"{shift}: base address .* multiple of "
                                             f"{DZ_ALIGN[shift]} bytes"):
            call()
        assert recorder == []


@pytest.mark.parametrize("shift", [None, "lam_next", "Qinv", "B"])
def test_k9b_refuses_a_base_its_copies_cannot_take(recorder, shift):
    """K9b on halo-extended slabs (two halo knots a side, as K9a writes
    them): the interior views pass, a base moved by one float does not."""
    S, L, nq = 2, 8, 7
    nx = 2 * nq
    ext = {"Qinv": (nx, nx), "A": (nx, nx), "B": (nx, nq), "q": (nx,)}
    sl = {k: _shifted((S, L + 4) + s, 1 if k == shift else 0)[:, 2:2 + L]
          for k, s in ext.items()}
    lam = torch.zeros((S, L, nx))
    lam_next = _shifted((S, L, nx), 1 if shift == "lam_next" else 0)
    u = torch.zeros((S, L, 3 * nq))[..., nx:]
    call = lambda: compute_dz_slab(sl, lam, lam_next, torch.zeros((S, L)), u, RHO, 0.1)
    if shift is None:
        call()
        (name, args), = recorder
        assert name == "dz_warp_launch" and args[7] == L + 4      # the knot stride
    else:
        with pytest.raises(ValueError, match=f"{shift}: base address"):
            call()
        assert recorder == []


def emulate_dz_warp(sys: dict, lam, lam_next, last, u, rho, r_cost: float):
    """dz_warp_kernel's work split, in torch: instances (or shards) b, CTAs
    of dz_plan(N) knots, a warp per knot; each warp stages its knot's
    inputs, then lanes 0..nx-1 form the rhs row and dx, lanes nx.. du, each
    sum from 0 in j order (dz_rhs, dz_dx, dz_du).  sys, lam, u have a
    leading instance axis; lam_next, last None for K6."""
    Bn, N, nx = lam.shape
    nu = nx // 2
    kpc, ctas, _ = dz_plan(N, nx)
    dz = torch.full((Bn, N, nx + nu), float("nan"), dtype=lam.dtype)
    written = torch.zeros((Bn, N), dtype=torch.int64)
    for b in range(Bn):
        for x in range(ctas):
            for w in range(kpc):
                k = x * kpc + w
                if k >= N:
                    continue
                slab = last is not None
                # the knot's slot: everything staged before it is read
                Qk, Ak, Bk = sys["Qinv"][b, k], sys["A"][b, k], sys["B"][b, k]
                qk, lk, uk = sys["q"][b, k], lam[b, k], u[b, k]
                if slab:
                    ln = lam_next[b, k]
                    has_next = bool(last[b, k] == 0)
                else:
                    ln = lam[b, k + 1] if k < N - 1 else torch.zeros(nx, dtype=lam.dtype)
                    has_next = k < N - 1
                rhs = torch.empty(nx, dtype=lam.dtype)
                for c in range(nx):                         # dz_rhs
                    at = torch.zeros((), dtype=lam.dtype)
                    if has_next:
                        for j in range(nx):
                            at = at + Ak[j, c] * ln[j]
                    rhs[c] = (qk[c] - lk[c]) + at
                s_r = 1.0 / (r_cost + rho)
                for c in range(nu):                         # dz_du
                    bt = torch.zeros((), dtype=lam.dtype)
                    for j in range(nx):
                        bt = bt + Bk[j, c] * ln[j]
                    dz[b, k, nx + c] = s_r * (r_cost * uk[c] + bt) if has_next else 0.0
                for c in range(nx):                         # dz_dx
                    acc = torch.zeros((), dtype=lam.dtype)
                    for j in range(nx):
                        acc = acc + Qk[c, j] * rhs[j]
                    dz[b, k, c] = acc
                written[b, k] += 1
    assert bool((written == 1).all())       # every knot once, by one warp
    return dz


@pytest.fixture(scope="module")
def problem():
    """Trace 0_0 rows 350.. + numpy noise, K1's blocks (the plain version,
    f64) and the JAX KKT blocks and Schur system at f64."""
    N = 24
    rng = np.random.default_rng(0)
    xu = load_xu_traj("0_0")[350:350 + N] + 0.01 * rng.standard_normal((N, 21))
    xs, ee = xu[0, :14].copy(), load_eepos_traj("0_0")[350:350 + N]
    t = lambda a: torch.tensor(a)
    cost = CostConfig.for_knots(N)
    sys_ = build_kkt_schur(iiwa14(torch.float64, device="cpu"), cost, t(xu), t(xs),
                           t(ee), RHO, DT)
    jm, jc = jax_iiwa14(dtype=jnp.float64), JCostConfig.for_knots(N)
    kkt, sch = jax.jit(lambda a, b, g: (lambda k: (k, jschur.form_schur_system(k, RHO)))(
        jkkt.build_kkt(jm, jc, a, b, g, DT, 0, False)))(
            jnp.asarray(xu), jnp.asarray(xs), jnp.asarray(ee))
    lam = rng.standard_normal((N, 14))
    return dict(N=N, xu=xu, sys=sys_, r_cost=cost.r_cost, kkt=kkt, sch=sch, lam=lam)


def _close(got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=rtol * float(np.abs(ref).max()))


def test_k6_split_matches_plain_and_jax(problem):
    """The emulated K6 == compute_dz_plain within 1e-15 of its scale at
    f64 (only the plain version's summation order differs) and the JAX
    compute_dz within 1e-10, as tests/test_torch_split.py holds K6's plain
    version."""
    N, xu, sys_ = problem["N"], problem["xu"], problem["sys"]
    lam = torch.tensor(problem["lam"])
    u = torch.tensor(xu)[:, 14:]
    got = emulate_dz_warp({k: sys_[k][None] for k in ("Qinv", "A", "B", "q")},
                          lam[None], None, None, u[None], RHO, problem["r_cost"])[0]
    _close(got, compute_dz_plain(sys_, lam, u, RHO, problem["r_cost"]), 1e-15)
    ref = jschur.compute_dz(problem["kkt"], problem["sch"], jnp.asarray(problem["lam"]))
    _close(got, ref, 1e-10)


@pytest.mark.parametrize("shards", [2, 3])
def test_k9b_split_matches_plain_and_jax(problem, shards):
    """The emulated K9b on each shard's rows == compute_dz_slab_plain within
    1e-15 at f64, and the JAX compute_dz_pallas_slab (interpret mode) per
    shard within 1e-10."""
    N, xu, sys_, r_cost = problem["N"], problem["xu"], problem["sys"], problem["r_cost"]
    L = N // shards
    sl = {k: sys_[k].reshape(shards, L, *sys_[k].shape[1:]) for k in ("Qinv", "A", "B", "q")}
    lam_g = torch.tensor(problem["lam"])
    lam = lam_g.reshape(shards, L, 14)
    lam_next = torch.roll(lam_g, -1, 0).reshape(shards, L, 14)
    last = (torch.arange(N) == N - 1).double().reshape(shards, L)
    u = torch.tensor(xu)[:, 14:].reshape(shards, L, 7)
    got = emulate_dz_warp(sl, lam, lam_next, last, u, RHO, r_cost)
    _close(got, compute_dz_slab_plain(sl, lam, lam_next, last, u, RHO, r_cost), 1e-15)
    lane = lambda a: jnp.asarray(np.moveaxis(a.numpy(), 0, -1))
    for b in range(shards):
        ref = compute_dz_pallas_slab(
            {k: lane(sl[k][b]) for k in ("Qinv", "A", "B", "q")},
            jnp.asarray(lam[b].numpy()), jnp.asarray(lam_next[b].numpy()),
            jnp.asarray(last[b].numpy()), jnp.asarray(u[b].numpy()), RHO, r_cost,
            interpret=True)
        _close(got[b], ref, 1e-10)


def test_k2p_exit_flag_is_cast_by_its_reader(recorder):
    """On the card K2''s uncast wrapper hands back the int32 flag K2' wrote
    (no cast enqueued behind the kernel, so K6 follows K2' on the
    fused_dz=False route); pcg_solve_cuda casts it to bool as before."""
    N, nx = 8, 14
    z = torch.zeros
    args = (z((N, 3, nx, nx)), z((N, 3, nx, nx)), z((N, nx)), z((N, nx)))
    raw = pcg_cuda.pcg_solve_cuda_uncast(*args, max_iter=5)
    res = pcg_cuda.pcg_solve_cuda(*args, max_iter=5)
    assert [n for n, _ in recorder] == ["pcg_launch", "pcg_launch"]
    assert raw.converged.dtype == torch.int32 and raw.iters.dtype == torch.int32
    assert res.converged.dtype == torch.bool and res.iters.dtype == torch.int32
