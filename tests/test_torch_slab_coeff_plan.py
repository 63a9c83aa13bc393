"""K10a's cluster plan (``ops/pcg_slab_cuda.py::slab_cluster_plan``), the
coefficient step's plan (``ops/pcg_ca_cuda.py::coeff_plan``), K9a's knot
limit, and what the wrappers of K10a, the coefficient step and K9a hand
their launches.

The kernels run only on the card (``chip_smoke.py`` holds them against
their plain versions there).  Here: the plans are valid for every slab the
wrappers admit and agree with the constants of ``csrc/pcg_slab.cu`` and
``csrc/pcg_ca.cu``; the wrappers pass their plan (the launch replaced by a
recorder, so no card is needed) and raise before any launch on a shape the
plan refuses; a torch-f64 emulation of K10a's split over the cluster (each
CTA's rows, the edge rows of r and u pushed into the neighbours' halo rows,
the partial dots summed in rank order) reproduces the plain
``pcg_slab_step``, and one of the coefficient step's split (every CTA
repeating the iterations, each recovering its own rows and packets) the
plain ``ca_coeff_step``, with some shards exited and their state unchanged.
"""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.config import CostConfig
from mpcgpu_tpu_torch.models import iiwa14
from mpcgpu_tpu_torch.ops import pcg_ca_cuda, pcg_slab_cuda
from mpcgpu_tpu_torch.ops.pcg_ca import (ca_coeff_iters, ca_coeff_step,
                                         ca_next_scale, ca_shift_matrix,
                                         ca_state, n_parts, split_parts)
from mpcgpu_tpu_torch.ops.pcg_ca_cuda import (CoeffPlan, ca_coeff_step_cuda,
                                              coeff_plan)
from mpcgpu_tpu_torch.ops.pcg_slab import (band_rows, exit_fired,
                                           pcg_slab_step, slab_state)
from mpcgpu_tpu_torch.ops.pcg_slab_cuda import (SlabPlan, pcg_slab_step_cuda,
                                                slab_cluster_plan,
                                                slab_smem_bytes)
from mpcgpu_tpu_torch.solver import kkt_cuda
from mpcgpu_tpu_torch.solver.kkt_cuda import build_kkt_schur_slab, kkt_window_plan

CSRC = Path(pcg_slab_cuda.__file__).resolve().parents[1] / "csrc"


def _constexprs(name: str) -> dict:
    """Every file-scope ``constexpr int NAME = expr;`` of common.cuh and the
    given csrc file, evaluated in order."""
    env = {}
    for src in ("common.cuh", name):
        for key, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                    (CSRC / src).read_text(), re.M):
            env[key] = eval(expr, {}, dict(env))
    return env


def _function_body(src: str, name: str) -> str:
    body = re.search(name + r"\([^)]*\) \{(.*?)\}", src, re.S).group(1)
    return " ".join(re.sub(r"//[^\n]*", "", body).replace("return", "")
                    .replace(";", "").split())


# ---- the plans ---------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [(2, 129), (129, 513)])
def test_slab_plan_is_valid_for_every_admitted_slab(lo, hi):
    for L in range(lo, hi):
        plan = slab_cluster_plan(L)
        C, kc, threads, smem = plan
        assert C & (C - 1) == 0 and 1 <= C <= pcg_slab_cuda.SLAB_MAX_CLUSTER, (L, plan)
        assert kc == -(-L // C) and C * kc >= L, (L, plan)
        # the smallest such power of two, unless capped at 16
        assert kc <= pcg_slab_cuda.SLAB_TARGET_KNOTS or C == 16, (L, plan)
        assert C == 1 or -(-L // (C // 2)) > pcg_slab_cuda.SLAB_TARGET_KNOTS, (L, plan)
        # a thread per own row, in whole warps
        assert threads % 32 == 0 and 14 * kc <= threads < 14 * kc + 32, (L, plan)
        assert threads <= pcg_slab_cuda.SLAB_MAX_THREADS
        assert smem == slab_smem_bytes(kc) <= pcg_slab_cuda.SMEM_LIMIT
        assert slab_cluster_plan(L) == plan          # a fixed function of L


def test_slab_plan_at_the_main_sizes():
    # N = 512 over 8 shards, 64 over 4, 512 on one shard
    assert slab_cluster_plan(64) == SlabPlan(16, 4, 64, slab_smem_bytes(4))
    assert slab_cluster_plan(16) == SlabPlan(4, 4, 64, slab_smem_bytes(4))
    assert slab_cluster_plan(512) == SlabPlan(16, 32, 448, slab_smem_bytes(32))
    assert slab_cluster_plan(2) == SlabPlan(1, 2, 32, slab_smem_bytes(2))
    # the sweep's layouts: C = 2..16 at L = 64 (C = 1 leaves 64 knots, 896
    # rows, to one CTA), 1..16 at L = 16
    assert [slab_cluster_plan(64, C).knots_per_cta for C in (2, 4, 8, 16)] == \
        [32, 16, 8, 4]
    assert [slab_cluster_plan(16, C).knots_per_cta for C in (1, 2, 4, 8, 16)] == \
        [16, 8, 4, 2, 1]
    with pytest.raises(ValueError, match="threads"):
        slab_cluster_plan(64, 1)
    for bad in (0, 3, 32):
        with pytest.raises(ValueError, match="power of two"):
            slab_cluster_plan(64, bad)
    for L in (1, 513):
        with pytest.raises(ValueError, match="knots"):
            slab_cluster_plan(L)


def test_slab_plan_constants_match_the_cuda_source():
    consts = _constexprs("pcg_slab.cu")
    assert consts["SLAB_MAX_CLUSTER"] == pcg_slab_cuda.SLAB_MAX_CLUSTER
    assert consts["SLAB_MAX_THREADS"] == pcg_slab_cuda.SLAB_MAX_THREADS
    assert consts["SLAB_KNOT_STRIDE"] == pcg_slab_cuda._KNOT_STRIDE
    # a knot's blocks are 16-byte aligned in shared memory (bulk copies) and
    # the rows a half-warp reads as float2 fall in distinct 8-byte banks
    stride = consts["SLAB_KNOT_STRIDE"]
    assert stride >= 3 * 196 and (4 * stride) % 16 == 0 and stride % 32 == 4
    for t0 in range(0, 448, 16):
        words = {((t // 14) * stride + 14 * (t % 14)) // 2 % 16
                 for t in range(t0, t0 + 16)}
        assert len(words) == 16, t0
    terms = _function_body((CSRC / "pcg_slab.cu").read_text(), "slab_smem_bytes")
    for kc in (1, 2, 4, 32):
        got = eval(terms, {"NX": 14, "SLAB_KNOT_STRIDE": stride, "kc": kc,
                           "SLAB_MAX_CLUSTER": consts["SLAB_MAX_CLUSTER"]})
        assert got == slab_smem_bytes(kc), kc


@pytest.mark.parametrize("s", [1, 4, 8])
def test_coeff_plan_is_valid_for_every_admitted_slab(s):
    h = 2 * s + 1
    for L in range(h, _kernels.MAX_KNOTS + 1):
        plan = coeff_plan(L, s)
        C, R, threads = plan
        n = 14 * L
        assert C & (C - 1) == 0 and 1 <= C <= pcg_ca_cuda.COEF_MAX_CLUSTER, (L, plan)
        assert R == -(-n // C) and C * R >= n, (L, plan)
        assert R <= pcg_ca_cuda.COEF_TARGET_ROWS or C == 16, (L, plan)
        assert C == 1 or -(-n // (C // 2)) > pcg_ca_cuda.COEF_TARGET_ROWS, (L, plan)
        # warp 0 for the iterations and a thread per row, up to 256
        assert threads % 32 == 0 and 64 <= threads <= pcg_ca_cuda.COEF_MAX_THREADS
        assert threads - 32 >= min(R, pcg_ca_cuda.COEF_MAX_THREADS - 32), (L, plan)
        assert threads - 32 < R + 32
        assert coeff_plan(L, s) == plan


def test_coeff_plan_at_the_main_sizes():
    assert coeff_plan(64, 4) == CoeffPlan(8, 112, 160)
    assert coeff_plan(16, 4) == CoeffPlan(2, 112, 160)
    assert coeff_plan(512, 4) == CoeffPlan(16, 448, 256)
    assert [coeff_plan(64, 4, C).rows_per_cta for C in (1, 2, 4, 8, 16)] == \
        [896, 448, 224, 112, 56]
    for bad in (0, 3, 32):
        with pytest.raises(ValueError, match="power of two"):
            coeff_plan(64, 4, bad)
    for L, s in ((8, 4), (513, 4), (64, 0), (64, 9)):
        with pytest.raises(ValueError):
            coeff_plan(L, s)


def test_coeff_plan_constants_match_the_cuda_source():
    consts = _constexprs("pcg_ca.cu")
    assert consts["COEF_MAX_CLUSTER"] == pcg_ca_cuda.COEF_MAX_CLUSTER
    assert consts["COEF_MAX_THREADS"] == pcg_ca_cuda.COEF_MAX_THREADS
    src = (CSRC / "pcg_ca.cu").read_text()
    # the launch instantiates the kernel for every s the plan admits
    assert sorted(int(k) for k in re.findall(r"COEF_CASE\((\d+)\)\n", src)) == \
        list(range(1, pcg_ca_cuda.MAX_S + 1))


def test_k9a_plan_admits_the_one_shard_slab():
    """K9a's slab holds a shard's L <= 512 knots and two halo knots per side:
    its window plan admits 516 (K1's stays at 512)."""
    assert kkt_cuda.K9A_MAX_KNOTS == _kernels.MAX_KNOTS + 4
    plan = kkt_window_plan(516, kkt_cuda.K9A_MAX_KNOTS)
    assert plan.window == kkt_cuda.KKT_WINDOW and plan.ctas == 129
    for N in (513, 516):
        with pytest.raises(ValueError, match="knots"):
            kkt_window_plan(N)
    with pytest.raises(ValueError, match="knots"):
        kkt_window_plan(517, kkt_cuda.K9A_MAX_KNOTS)


# ---- what the wrappers launch ------------------------------------------------

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


def _slab_inputs(L, n_shard=2, seed=0, dtype=torch.float32):
    """A seeded K10a state after some steps and its inputs: blocks of norm
    ~1, scalars away from 0."""
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.tensor(rng.standard_normal(shape) / 14.0 * 3.0,
                                    dtype=dtype)
    st = slab_state(t(n_shard, L, 14), t(n_shard, L, 14))
    for k in ("p", "s", "u", "w"):
        st[k].copy_(t(n_shard, L, 14))
    st["scal"].copy_(torch.tensor(rng.uniform(0.5, 2.0, (n_shard, 2)), dtype=dtype))
    st["iters"].copy_(torch.tensor(rng.integers(1, 5, n_shard), dtype=torch.int32))
    S, Pinv = t(n_shard, L, 3, 14, 14), t(n_shard, L, 3, 14, 14)
    flp, frp = t(n_shard, 6, 14), t(n_shard, 6, 14)
    PinvL, PinvR = t(n_shard, 3, 14, 14), t(n_shard, 3, 14, 14)
    tot = torch.tensor(np.stack([rng.uniform(0.5, 2.0, n_shard),
                                 rng.uniform(2.0, 4.0, n_shard),
                                 rng.uniform(0.5, 2.0, n_shard)], 1), dtype=dtype)
    return st, (S, Pinv, flp, frp, PinvL, PinvR, tot)


@pytest.mark.parametrize("L", [2, 16, 17, 64, 512])
def test_k10a_launches_its_plan(recorder, L):
    st, ins = _slab_inputs(L, n_shard=3)
    for init in (False, True):
        pcg_slab_step_cuda(st, *ins, 67, 1e-5, "rnorm", init)
    plan = slab_cluster_plan(L)
    assert [n for n, _ in recorder] == ["pcg_slab_launch"] * 2
    for init, (_, a) in zip((0, 1), recorder):
        # ..., L, n_shard, cluster, kc, threads, smem, max_iter, tol, rnorm,
        # init, stream
        assert a[19:26] == (L, 3, plan.cluster, plan.knots_per_cta, plan.threads,
                            plan.smem_bytes, 67)
        assert a[27:29] == (1, init)
        assert a[8] == ins[0].stride(0) and a[14] == ins[6].stride(0)


def test_k10a_raises_before_any_launch(recorder):
    for L in (1, 513):
        st, ins = _slab_inputs(L, n_shard=2)
        with pytest.raises(ValueError, match="knots"):
            pcg_slab_step_cuda(st, *ins, 67, 1e-5)
    st, ins = _slab_inputs(16, n_shard=2)
    flat = torch.zeros(ins[1].numel() + 1)
    misaligned = list(ins)
    misaligned[1] = flat[1:].view(ins[1].shape)     # Pinv 4 bytes off
    with pytest.raises(ValueError, match="aligned"):
        pcg_slab_step_cuda(st, *misaligned, 67, 1e-5)
    with pytest.raises(ValueError, match="exit_criterion"):
        pcg_slab_step_cuda(st, *ins, 67, 1e-5, "nope")
    assert recorder == []


def _coeff_inputs(L, s, n_shard=3, seed=0):
    """A seeded s-step state with bases Y, Ytil and summed parts from them
    (so the coefficient iterations stay finite), g != 1."""
    rng = np.random.default_rng(seed)
    m = 2 * s + 1
    f64 = lambda *shape: torch.tensor(rng.standard_normal(shape) / 14.0 * 3.0)
    r0, z0 = f64(n_shard, L, 14), f64(n_shard, L, 14)
    tot0 = torch.stack([(r0 * z0).sum((1, 2)), (r0 * r0).sum((1, 2))], 1)
    st = ca_state(f64(n_shard, L, 14), r0, z0, tot0, 0.0, "eta", s)
    st["scal"][:, 1] = torch.tensor(rng.uniform(0.5, 2.0, n_shard))
    st["Y"].copy_(f64(n_shard, m, L, 14))
    st["Yt"].copy_(st["Y"] + 0.1 * f64(n_shard, m, L, 14))
    Y, Yt, r = st["Y"], st["Yt"], st["r"]
    G = torch.einsum("salk,sblk->sab", Y, Yt)
    F = torch.einsum("salk,sblk->sab", Yt, Yt)
    parts = torch.cat([G.flatten(1), torch.einsum("salk,slk->sa", Y, r),
                       F.flatten(1), torch.einsum("salk,slk->sa", Yt, r),
                       (r * r).sum((1, 2))[:, None]], 1)
    return st, parts


@pytest.mark.parametrize("L,s", [(9, 4), (16, 4), (64, 4), (512, 4), (33, 2),
                                 (3, 1)])
def test_k10b_coeff_launches_its_plan(recorder, L, s):
    st, tot = _coeff_inputs(L, s)
    st = {k: (v.float() if k in ("x", "r", "z", "p", "pkt") else v)
          for k, v in st.items()}
    ca_coeff_step_cuda(st, tot, 167, 1e-5, "eta", s)
    ((name, a),) = recorder
    plan = coeff_plan(L, s)
    assert name == "ca_coeff_launch"
    # ..., L, s, n_shard, cluster, R, threads, max_iter, tol, rnorm, stream
    assert a[12:19] == (L, s, 3, plan.cluster, plan.rows_per_cta, plan.threads,
                        167)
    assert a[20] == 0 and a[7] == tot.stride(0)


@pytest.mark.parametrize("L,s", [(8, 4), (513, 4), (600, 1)])
def test_k10b_coeff_raises_before_any_launch(recorder, L, s):
    st, tot = _coeff_inputs(max(min(L, 512), 2 * s + 1), s)
    st = {k: (v.float() if k in ("x", "r", "z", "p", "pkt") else v)
          for k, v in st.items()}
    if L != st["x"].shape[1]:
        st = {k: (torch.zeros(v.shape[:1] + (L,) + v.shape[2:], dtype=v.dtype)
                  if k in ("x", "r", "z", "p") else v) for k, v in st.items()}
    with pytest.raises(ValueError, match="knots"):
        ca_coeff_step_cuda(st, tot, 167, 1e-5, "eta", s)
    assert recorder == []


def test_k9a_raises_above_its_limit_before_any_launch(recorder):
    """K9a's wrapper takes a halo-extended slab of 516 knots (one shard of
    512) and refuses 517 before any launch."""
    model = iiwa14(torch.float32, device="cpu")
    cost = CostConfig.for_knots(512)
    for Lext, ok in ((516, True), (517, False)):
        xu = torch.zeros((1, Lext, 21))
        ee = torch.zeros((1, Lext, 6))
        mask = torch.zeros((1, Lext))
        if ok:
            build_kkt_schur_slab(model, cost, xu, ee, mask, mask, 1e-3, 1 / 64)
        else:
            with pytest.raises(ValueError, match="knots"):
                build_kkt_schur_slab(model, cost, xu, ee, mask, mask, 1e-3, 1 / 64)
    ((name, a),) = recorder
    plan = kkt_window_plan(516, kkt_cuda.K9A_MAX_KNOTS)
    # kkt_schur_slab_launch: ..., Lext, n_shard, Kc, smem, ...
    assert name == "kkt_schur_slab_launch" and a[10:14] == (516, 1, plan.window,
                                                            plan.smem_bytes)


# ---- the splits over the cluster, emulated in f64 ----------------------------

def emulate_k10a(st, S, Pinv, flp, frp, PinvL, PinvR, tot, max_iter, exit_tol,
                 exit_criterion, init, plan):
    """One K10a step on a copy of ``st`` as the cluster forms it: CTA q owns
    knots [q kc, q kc + nk); its r rows with two halo rows on each side,
    its u rows with one; the halo rows inside the shard come only from the
    neighbours' pushes of their edge rows, the shard's outer ones from the
    packets; the partial dots of each CTA, summed in rank order."""
    out = {k: v.clone() for k, v in st.items()}
    n_shard, L, n = st["x"].shape
    C, kc = plan.cluster, plan.knots_per_cta
    if init:
        alpha = beta = torch.zeros(n_shard, dtype=tot.dtype)
        act = torch.ones(n_shard, dtype=torch.bool)
    else:
        eta, d = tot[:, 0], tot[:, 1]
        act = ~exit_fired(tot, exit_tol, exit_criterion) & (st["iters"] < max_iter)
        first_step = st["iters"] == 0
        beta = torch.where(first_step, torch.zeros_like(eta), eta / st["scal"][:, 0])
        alpha = eta / torch.where(first_step, d, d - beta * eta / st["scal"][:, 1])
    a, bb = alpha[:, None, None], beta[:, None, None]
    own = [(q * kc, max(0, min(kc, L - q * kc))) for q in range(C)]
    new = {k: torch.zeros_like(st[k]) for k in ("x", "r", "p", "s", "u", "w")}
    re = [torch.zeros((n_shard, kc + 4, n), dtype=st["x"].dtype) for _ in range(C)]
    ue = [torch.zeros((n_shard, kc + 2, n), dtype=st["x"].dtype) for _ in range(C)]
    for q, (k0, nk) in enumerate(own):
        sl = slice(k0, k0 + nk)
        p_n = st["u"][:, sl] + bb * st["p"][:, sl]
        s_n = st["w"][:, sl] + bb * st["s"][:, sl]
        new["x"][:, sl] = st["x"][:, sl] + a * p_n
        new["r"][:, sl] = st["r"][:, sl] - a * s_n
        new["p"][:, sl], new["s"][:, sl] = p_n, s_n
        re[q][:, 2:nk + 2] = new["r"][:, sl]
        if nk and k0 == 0:
            re[q][:, 0:2] = flp[:, 0:2] - a * (flp[:, 2:4] + bb * flp[:, 4:6])
        if nk and k0 + nk == L:
            re[q][:, nk + 2:nk + 4] = frp[:, 0:2] - a * (frp[:, 2:4] + bb * frp[:, 4:6])
    for q, (k0, nk) in enumerate(own):          # the r pushes
        if nk and k0 > 0:
            re[q - 1][:, kc + 2] = re[q][:, 2]
        if nk and k0 + nk < L:
            re[q + 1][:, 1] = re[q][:, nk + 1]
    for q, (k0, nk) in enumerate(own):
        if not nk:
            continue
        new["u"][:, k0:k0 + nk] = band_rows(Pinv[:, k0:k0 + nk], re[q][:, 1:nk + 1],
                                           re[q][:, 2:nk + 2], re[q][:, 3:nk + 3])
        ue[q][:, 1:nk + 1] = new["u"][:, k0:k0 + nk]
        if k0 == 0:
            ue[q][:, 0] = band_rows(PinvL, re[q][:, 0], re[q][:, 1], re[q][:, 2])
        if k0 + nk == L:
            ue[q][:, nk + 1] = band_rows(PinvR, re[q][:, nk + 1], re[q][:, nk + 2],
                                         re[q][:, nk + 3])
    for q, (k0, nk) in enumerate(own):          # the u pushes
        if nk and k0 > 0:
            ue[q - 1][:, kc + 1] = ue[q][:, 1]
        if nk and k0 + nk < L:
            ue[q + 1][:, 0] = ue[q][:, nk]
    dots = torch.zeros((n_shard, 3), dtype=st["x"].dtype)
    for q, (k0, nk) in enumerate(own):
        sl = slice(k0, k0 + nk)
        if nk:
            new["w"][:, sl] = band_rows(S[:, sl], ue[q][:, 0:nk], ue[q][:, 1:nk + 1],
                                        ue[q][:, 2:nk + 2])
        r_, u_, w_ = new["r"][:, sl], new["u"][:, sl], new["w"][:, sl]
        dots = dots + torch.stack([(r_ * u_).sum((1, 2)), (w_ * u_).sum((1, 2)),
                                   (r_ * r_).sum((1, 2))], 1)
    keep = act[:, None, None]
    for k, v in new.items():
        out[k] = torch.where(keep, v, st[k])
    rows = lambda t, k: t[:, k:k + 2]
    pkt = torch.stack([torch.cat([rows(new[v], L - 2) for v in "rws"], 1),
                       torch.cat([rows(new[v], 0) for v in "rws"], 1)], 1)
    out["pkt"] = torch.where(act[:, None, None, None], pkt, st["pkt"])
    out["dots"] = torch.where(act[:, None], dots, st["dots"])
    if not init:
        out["scal"] = torch.where(act[:, None], torch.stack([eta, alpha], 1), st["scal"])
        out["iters"] = st["iters"] + act.to(torch.int32)
    return out


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-300))


@pytest.mark.parametrize("L,C", [(2, None), (16, None), (17, None), (64, None),
                                 (512, None), (64, 2), (16, 1), (16, 16),
                                 (33, 16)])
def test_k10a_split_emulation_matches_the_plain_version(L, C):
    """L = 17 and 33 at C = 16 leave trailing CTAs without knots (as C = 16
    at L = 16 leaves none idle but one knot each); the others are the
    plan's and the sweep's layouts."""
    plan = slab_cluster_plan(L, C)
    for init, crit in ((True, "eta"), (False, "eta"), (False, "rnorm")):
        st, ins = _slab_inputs(L, n_shard=3, seed=L, dtype=torch.float64)
        ref = {k: v.clone() for k, v in st.items()}
        pcg_slab_step(ref, *ins, 100, 1e-3, crit, init)
        got = emulate_k10a(st, *ins, 100, 1e-3, crit, init, plan)
        for k in ("x", "r", "p", "s", "u", "w", "pkt", "dots", "scal"):
            assert _rel(got[k], ref[k]) <= 1e-13, (L, C, init, k)
        assert torch.equal(got["iters"], ref["iters"])


@pytest.mark.parametrize("crit", ["eta", "rnorm"])
def test_k10a_exited_shards_keep_their_state(crit):
    """Shards whose exit fired (shard 0) or that reached the cap (shard 2)
    keep their state bit for bit, in the plain step and in the emulation,
    while shard 1 steps."""
    L = 64
    st, (S, Pinv, flp, frp, PinvL, PinvR, tot) = _slab_inputs(L, n_shard=3, seed=5)
    tot = tot.clone()
    tot[0] = 0.0                                  # |eta| < tol and r.r < tol^2
    st["iters"][2] = 7
    ins = (S, Pinv, flp, frp, PinvL, PinvR, tot)
    ref = {k: v.clone() for k, v in st.items()}
    pcg_slab_step(ref, *ins, 7, 1e-3, crit)
    got = emulate_k10a({k: v.double() if v.is_floating_point() else v
                        for k, v in st.items()},
                       *(t.double() for t in ins), 7, 1e-3, crit, False,
                       slab_cluster_plan(L))
    for out in (ref, got):
        for k, v in st.items():
            for b in (0, 2):
                assert torch.equal(out[k][b].to(v.dtype), v[b]), (k, b)
        assert not torch.equal(out["x"][1].to(st["x"].dtype), st["x"][1])
    assert ref["iters"].tolist() == [st["iters"][0], st["iters"][1] + 1, 7]


def emulate_coeff(st, tot, max_iter, exit_tol, exit_criterion, s, plan):
    """The coefficient step on a copy of ``st`` as the cluster forms it: every
    CTA runs the s iterations from the same inputs (and gets the same
    coefficients), then recovers its own R rows of the shard and writes
    the packet entries of those rows; rank 0 writes the scalars."""
    out = {k: v.clone() for k, v in st.items()}
    n_shard, L, nx = st["x"].shape
    h = 2 * s + 1
    n = L * nx
    run = (st["done"] == 0) & (st["iters"] < max_iter)
    G, b, F, f, rr0 = split_parts(tot, s)
    eta, g = st["scal"][:, 0], st["scal"][:, 1]

    def exit_test(eta_n, rr_n):
        if exit_criterion == "rnorm":
            return rr_n < exit_tol * exit_tol
        return torch.abs(eta_n) < exit_tol

    T = ca_shift_matrix(s, torch.float64)
    coef = [ca_coeff_iters(G, b, F, f, rr0, g[:, None, None] * T, eta,
                           st["iters"], st["done"] != 0, s, max_iter, exit_test)
            for _ in range(plan.cluster)]
    for other in coef[1:]:
        assert all(torch.equal(x_, y_) for x_, y_ in zip(other, coef[0]))
    flat = {k: out[k].view(n_shard, n) for k in ("x", "r", "z", "p")}
    Yf, Ytf = st["Y"].reshape(n_shard, -1, n), st["Yt"].reshape(n_shard, -1, n)
    pkt = out["pkt"].view(n_shard, 2, 2, h * nx)
    for q in range(plan.cluster):
        e, a, c, eta_n, it_n, done_n = coef[q]
        lo, hi = q * plan.rows_per_cta, min(n, (q + 1) * plan.rows_per_cta)
        if lo >= hi:
            continue
        comb = lambda w, B: torch.einsum("sa,sai->si", w, B[:, :, lo:hi])
        dt = st["x"].dtype
        new = dict(x=(st["x"].view(n_shard, n)[:, lo:hi] + comb(e, Yf)).to(dt),
                   r=(st["r"].view(n_shard, n)[:, lo:hi] - comb(e, Ytf)).to(dt),
                   z=comb(c, Yf).to(dt), p=comb(a, Yf).to(dt))
        keep = run[:, None]
        for k, v in new.items():
            flat[k][:, lo:hi] = torch.where(keep, v, flat[k][:, lo:hi])
        for i in range(lo, hi):
            k = i // nx
            for side, k_lo in ((0, L - h), (1, 0)):
                if k_lo <= k < k_lo + h:
                    j = (k - k_lo) * nx + i % nx
                    for v, name in enumerate(("p", "z")):
                        pkt[:, side, v, j] = torch.where(run, flat[name][:, i],
                                                         pkt[:, side, v, j])
    e, a, c, eta_n, it_n, done_n = coef[0]
    scal = torch.stack([eta_n, ca_next_scale(G, g, s)], 1)
    out["scal"] = torch.where(run[:, None], scal, st["scal"])
    out["iters"] = it_n
    out["done"] = done_n.to(torch.int32)
    return out


@pytest.mark.parametrize("L,s,C", [(16, 4, None), (64, 4, None), (512, 4, None),
                                   (9, 4, 16), (64, 4, 1), (33, 2, None)])
def test_coeff_split_emulation_matches_the_plain_version(L, s, C):
    plan = coeff_plan(L, s, C)
    st, tot = _coeff_inputs(L, s, seed=L + s)
    st["done"][1] = 1                       # an exited shard keeps its state
    ref = {k: v.clone() for k, v in st.items()}
    ca_coeff_step(ref, tot, 10 ** 6, 1e-12, "eta", s)
    got = emulate_coeff(st, tot, 10 ** 6, 1e-12, "eta", s, plan)
    # the plain version's einsum over all rows and the emulation's over
    # each CTA's may round differently: 1e-13 relative
    for k in ("x", "r", "z", "p", "pkt", "scal"):
        assert _rel(got[k], ref[k]) <= 1e-13, (L, s, C, k)
    for k in ("x", "r", "z", "p", "pkt", "scal", "iters", "done"):
        assert torch.equal(got[k][1], st[k][1]) and torch.equal(ref[k][1], st[k][1]), k
    assert torch.equal(got["iters"], ref["iters"]) and torch.equal(got["done"], ref["done"])


def test_coeff_exited_and_capped_shards_keep_their_state():
    """Shard 0 has exited, shard 2 reached the cap; shard 1 steps."""
    s, L = 4, 64
    st, tot = _coeff_inputs(L, s, seed=3)
    st = {k: (v.float() if k in ("x", "r", "z", "p", "pkt") else v)
          for k, v in st.items()}
    st["done"][0] = 1
    st["iters"][2] = 67
    ref = {k: v.clone() for k, v in st.items()}
    ca_coeff_step(ref, tot, 67, 1e-12, "eta", s)
    for k, v in st.items():
        for b in (0, 2):
            assert torch.equal(ref[k][b], v[b]), (k, b)
    assert not torch.equal(ref["x"][1], st["x"][1]) and int(ref["iters"][1]) == s
    assert n_parts(s) == tot.shape[1]
