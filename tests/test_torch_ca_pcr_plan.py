"""K10b's cluster plan (``ops/pcg_ca_cuda.py::ca_cluster_plan``), K7's plan
(``ops/pcr_cuda.py::pcr_plan``) and what the wrappers of K10b and K7 hand
their launches.

The kernels run only on the card (``chip_smoke.py`` holds them against
their plain versions there).  Here: the plans are valid for every shape the
wrappers admit and agree with the constants of ``csrc/pcg_ca.cu`` and
``csrc/pcr.cu``; the wrappers pass their plan (the launch replaced by a
recorder, so no card is needed), K7 as one launch per solve, and raise
before any launch on a shape the plan refuses; and a torch-f64 emulation of
K10b's partition over the cluster (each CTA's products on its own knots
with the edge rows pushed into the neighbours' halo rows, each CTA's Gram
partials over its local rows summed in rank order) reproduces the plain
``ca_basis``.
"""

import contextlib
import ctypes
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.ops import pcg_ca_cuda, pcr_cuda
from mpcgpu_tpu_torch.ops.pcg_ca import ca_basis, ca_state, gram_parts, n_parts
from mpcgpu_tpu_torch.ops.pcg_ca_cuda import (CAPlan, ca_basis_cuda,
                                              ca_cluster_plan, ca_smem_bytes)
from mpcgpu_tpu_torch.ops.pcg_slab import band_rows
from mpcgpu_tpu_torch.ops.pcr import pcr_levels
from mpcgpu_tpu_torch.ops.pcr_cuda import (PcrPlan, pcr_plan, pcr_smem_bytes,
                                           pcr_solve_cuda, pcr_workspace_floats)

CSRC = Path(pcr_cuda.__file__).resolve().parents[1] / "csrc"


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


@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_ca_plan_is_valid_for_every_admitted_slab(s):
    h = 2 * s + 1
    for L in range(h, _kernels.MAX_KNOTS + 1):
        plan = ca_cluster_plan(L, s)
        C, ke, blocks, threads, smem = plan
        Le = L + 2 * h
        assert C & (C - 1) == 0 and 1 <= C <= pcg_ca_cuda.CA_MAX_CLUSTER, (L, plan)
        assert ke == -(-Le // C) and C * ke >= Le, (L, plan)
        # the smallest such power of two, unless capped at 16
        assert ke <= pcg_ca_cuda.CA_TARGET_KNOTS or C == 16, (L, plan)
        assert C == 1 or -(-Le // (C // 2)) > pcg_ca_cuda.CA_TARGET_KNOTS, (L, plan)
        assert threads % 32 == 0 and 14 * ke <= threads <= 512, (L, plan)
        # two threads a row (the V and W chains) wherever they fit
        assert threads >= 28 * ke or 28 * ke > 512, (L, plan)
        assert threads >= min(512, n_parts(s)), (L, plan)
        assert smem == ca_smem_bytes(ke, s, blocks) <= pcg_ca_cuda.SMEM_LIMIT
        # S and Pinv in shared memory wherever they fit
        assert blocks == (ca_smem_bytes(ke, s, True) <= pcg_ca_cuda.SMEM_LIMIT)
        assert ca_cluster_plan(L, s) == plan        # a fixed function of (L, s)


def test_ca_plan_at_the_main_sizes():
    # N = 512 over 8 shards and N = 64 over 4 at s = 4
    assert ca_cluster_plan(64, 4) == CAPlan(16, 6, True, 192,
                                            ca_smem_bytes(6, 4, True))
    assert ca_cluster_plan(16, 4) == CAPlan(16, 3, True, 192,
                                            ca_smem_bytes(3, 4, True))
    # N = 512 on one shard: the blocks stay in L2, 16 CTAs of 34 knots
    plan = ca_cluster_plan(512, 4)
    assert plan.cluster == 16 and plan.knots_per_cta == 34 and not plan.blocks_in_smem
    # the sweep's choices: C = 4..16 at L = 64 (C = 2 leaves 41 knots, 574
    # rows, to a CTA), 1..16 at L = 16
    assert [ca_cluster_plan(64, 4, C).knots_per_cta for C in (4, 8, 16)] == [21, 11, 6]
    assert [ca_cluster_plan(16, 4, C).knots_per_cta for C in (1, 2, 16)] == [34, 17, 3]
    for bad in (0, 3, 32):
        with pytest.raises(ValueError, match="power of two"):
            ca_cluster_plan(64, 4, bad)
    for C in (1, 2):
        with pytest.raises(ValueError, match="threads"):
            ca_cluster_plan(64, 4, C)
    for L, s in ((8, 4), (513, 4), (64, 0), (64, 9)):
        with pytest.raises(ValueError):
            ca_cluster_plan(L, s)


def test_ca_plan_constants_match_the_cuda_source():
    consts = _constexprs("pcg_ca.cu")
    assert consts["MAX_S"] == pcg_ca_cuda.MAX_S
    assert consts["CA_MAX_CLUSTER"] == pcg_ca_cuda.CA_MAX_CLUSTER
    assert consts["CA_MAX_THREADS"] == pcg_ca_cuda.CA_MAX_THREADS
    assert consts["CA_KNOT_STRIDE"] == pcg_ca_cuda._KNOT_STRIDE
    terms = _function_body((CSRC / "pcg_ca.cu").read_text(), "ca_smem_bytes")
    for ke in (1, 6, 11, 34, 36):
        for s in (1, 4, 8):
            for blocks in (0, 1):
                got = eval(terms, {"NX": 14, "CA_KNOT_STRIDE": consts["CA_KNOT_STRIDE"],
                                   "ke": ke, "s": s, "blocks": blocks})
                assert got == ca_smem_bytes(ke, s, bool(blocks)), (ke, s, blocks)


@pytest.mark.parametrize("lo,hi", [(2, 65), (65, 257), (257, 513)])
def test_pcr_plan_is_valid_for_every_knot_count(lo, hi):
    for N in range(lo, hi):
        plan = pcr_plan(N)
        assert plan.ctas == -(-N // pcr_cuda.PCR_KPC), (N, plan)
        assert plan.ctas * pcr_cuda.PCR_KPC >= N > (plan.ctas - 1) * pcr_cuda.PCR_KPC
        # a cluster barrier where every CTA fits in one cluster of <= 16
        assert plan.cluster == (plan.ctas <= pcr_cuda.PCR_MAX_CLUSTER), (N, plan)
        assert plan.smem_bytes == pcr_smem_bytes(plan.cluster) <= 232_448
        assert pcr_plan(N) == plan


def test_pcr_plan_at_the_main_sizes():
    assert pcr_plan(64) == PcrPlan(16, True, pcr_smem_bytes(True))
    assert pcr_plan(512) == PcrPlan(128, False, pcr_smem_bytes(False))
    assert pcr_plan(2) == PcrPlan(1, True, pcr_smem_bytes(True))
    for N in (1, 513):
        with pytest.raises(ValueError, match="knots"):
            pcr_plan(N)


def test_pcr_plan_constants_match_the_cuda_source():
    src = (CSRC / "pcr.cu").read_text()
    consts = _constexprs("pcr.cu")
    assert consts["PCR_KPC"] == pcr_cuda.PCR_KPC
    assert consts["PCR_MAX_CLUSTER"] == pcr_cuda.PCR_MAX_CLUSTER
    assert consts["SLOT"] == pcr_cuda._SLOT
    assert consts["WARP_FLOATS"] == pcr_cuda._WARP_FLOATS
    terms = _function_body(src, "pcr_smem_bytes")
    for cluster in (0, 1):
        got = eval(terms, {"kpc": consts["PCR_KPC"], "cluster": cluster,
                           "WARP_FLOATS": consts["WARP_FLOATS"],
                           "SLOT": consts["SLOT"]})
        assert got == pcr_smem_bytes(bool(cluster))
    # the workspace (struct Work): th^{-1} of levels + 1 levels, L and U of
    # levels, and two slots per knot
    for N in (2, 64, 512):
        levels = pcr_levels(N)
        nn = 14 * 14
        assert pcr_workspace_floats(N, levels) == (
            (levels + 1) * N * nn + 2 * levels * N * nn + 2 * N * consts["SLOT"])


class _Calls(list):
    """The recorded (entry name, arguments); K7's occupancy query answers
    per_sm CTAs per SM."""
    per_sm = 1


@pytest.fixture
def recorder(monkeypatch):
    """Every kernel entry replaced by a recorder of its arguments; CPU
    tensors taken as if they were on the card (of 132 SMs)."""
    calls = _Calls()

    def entry(src, name, nq):
        assert nq == 7, (name, nq)       # the IIWA's library

        def launch(*args):
            calls.append((name, args))
            if name == "pcr_coop_occupancy":
                ctypes.c_int.from_address(args[1]).value = calls.per_sm
            return 0
        return launch

    monkeypatch.setattr(_kernels, "on_cpu", lambda t: False)
    monkeypatch.setattr(_kernels, "require", lambda *a, **k: None)
    monkeypatch.setattr(_kernels, "entry", entry)
    monkeypatch.setattr(_kernels, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(multi_processor_count=132))
    pcr_cuda.resident_ctas.cache_clear()
    yield calls
    pcr_cuda.resident_ctas.cache_clear()


def _pcr_system(N):
    return torch.zeros((N, 3, 14, 14)), torch.zeros((N, 14))


@pytest.mark.parametrize("N", [2, 37, 64, 65, 100, 512])
def test_k7_is_one_launch_of_its_plan(recorder, N):
    S, b = _pcr_system(N)
    before = pcr_solve_cuda.launches
    for refine in (0, 1, 2):
        pcr_solve_cuda(S, b, refine=refine)
    plan = pcr_plan(N)
    launches = [a for name, a in recorder if name == "pcr_launch"]
    # one kernel per solve, counted once by the wrapper
    assert len(launches) == 3 and pcr_solve_cuda.launches - before == 3
    assert [n for n, _ in recorder if n != "pcr_launch"] == \
        ([] if plan.cluster else ["pcr_coop_occupancy"])     # asked once
    for refine, a in enumerate(launches):
        # pcr_launch: S, b, N, levels, refine, ctas, cluster, smem, ws, x, stream
        assert a[2:8] == (N, pcr_levels(N), refine, plan.ctas, int(plan.cluster),
                          plan.smem_bytes)
    # a cooperative launch whose CTAs are not all resident raises first
    if not plan.cluster:
        recorder.per_sm = 0
        pcr_cuda.resident_ctas.cache_clear()
        recorder.clear()
        with pytest.raises(ValueError, match="resident"):
            pcr_solve_cuda(S, b)
        assert [n for n, _ in recorder] == ["pcr_coop_occupancy"]


def test_k7_raises_before_any_launch(recorder):
    for N in (1, 513):
        S, b = _pcr_system(N)
        with pytest.raises(ValueError, match="knots"):
            pcr_solve_cuda(S, b)
    S, b = _pcr_system(8)
    with pytest.raises(ValueError, match="refine"):
        pcr_solve_cuda(S, b, refine=-1)
    assert recorder == []


def _ca_inputs(L, s, n_shard=2, seed=0):
    """A seeded s-step state and K10b's inputs: blocks of norm ~1 (so the
    chains stay O(1) over 2s+1 products), a basis scale g != 1."""
    rng = np.random.default_rng(seed)
    h = 2 * s + 1
    f64 = lambda *shape: torch.tensor(rng.standard_normal(shape) / 14.0 * 3.0)
    r0, z0 = f64(n_shard, L, 14), f64(n_shard, L, 14)
    tot0 = torch.stack([(r0 * z0).sum((1, 2)), (r0 * r0).sum((1, 2))], 1)
    st = ca_state(torch.zeros_like(r0), r0, z0, tot0, 0.0, "eta", s)
    st["p"].copy_(f64(n_shard, L, 14))
    st["scal"][:, 1] = torch.tensor(rng.uniform(0.5, 2.0, n_shard))
    blocks = [f64(n_shard, n, 3, 14, 14) for n in (L, L, h, h, h, h)]
    packets = [f64(n_shard, 2, h, 14), f64(n_shard, 2, h, 14)]
    return st, blocks + packets


def emulate_k10b(st, S, Pinv, SL, SR, PL, PR, fl, fr, s, plan):
    """(Y, Yt, parts) as K10b's cluster forms them, in f64: CTA q owns the
    extended knots [q ke, q ke + nk) with one halo row on each side; each
    phase's product reads only the CTA's own rows and halo rows, and the
    halo rows change only by the neighbours' pushes of their edge rows (V's
    up to phase 2s-1, W's up to 2s-3); each CTA's Gram partials over its
    local rows, then the C partials in rank order."""
    n_shard, L, n = st["x"].shape
    h = m = 2 * s + 1
    Le = L + 2 * h
    C, ke = plan.cluster, plan.knots_per_cta
    w = lambda *ts: torch.cat(ts, 1).double()
    S_ext, P_ext = w(SL, S, SR), w(PL, Pinv, PR)
    vec = {"v": w(fl[:, 0], st["p"], fr[:, 0]), "w": w(fl[:, 1], st["z"], fr[:, 1])}
    ginv = (1 / st["scal"][:, 1].double())[:, None, None]
    own = [(q * ke, max(0, min(ke, Le - q * ke))) for q in range(C)]
    # per CTA and array: (n_shard, ke + 2, n), rows halo, own, halo
    arr = {(q, a): torch.zeros((n_shard, ke + 2, n), dtype=torch.float64)
           for q in range(C) for a in ("xv", "tv", "xw", "tw")}
    for q, (k0, nk) in enumerate(own):
        for a, src in (("xv", vec["v"]), ("xw", vec["w"])):
            for e in range(nk + 2):
                if nk > 0 and 0 <= k0 - 1 + e < Le:
                    arr[q, a][:, e] = src[:, k0 - 1 + e]
    Y = torch.zeros((n_shard, m, L, n), dtype=torch.float64)
    Yt = torch.zeros_like(Y)
    for t in range(2 * s + 1):
        odd, two, j = t % 2 == 1, t <= 2 * s - 2, t // 2
        chains = (("v", 0), ("w", s + 1)) if two else (("v", 0),)
        for q, (k0, nk) in enumerate(own):
            if nk == 0:
                continue
            M = (P_ext if odd else S_ext)[:, k0:k0 + nk]
            for c, off in chains:
                ia = arr[q, ("t" if odd else "x") + c]
                prev, cur, nxt = ia[:, :nk].clone(), ia[:, 1:nk + 1], ia[:, 2:nk + 2].clone()
                if k0 == 0:
                    prev[:, 0] = 0             # the extended slab's zero ends
                if k0 + nk == Le:
                    nxt[:, -1] = 0
                y = band_rows(M, prev, cur, nxt)
                if odd:
                    y = y * ginv
                arr[q, ("x" if odd else "t") + c][:, 1:nk + 1] = y
                if not odd:
                    for kk in range(nk):
                        k = k0 + kk
                        if h <= k < h + L:
                            Y[:, off + j, k - h] = cur[:, kk]
                            Yt[:, off + j, k - h] = y[:, kk]
        # the pushes of phase t's edge rows into the neighbours' halo rows
        pushed = [c for c, go in (("v", t < 2 * s), ("w", t <= 2 * s - 3)) if go]
        for q, (k0, nk) in enumerate(own):
            for c in pushed:
                oa = ("x" if odd else "t") + c
                if nk > 0 and k0 > 0:
                    arr[q - 1, oa][:, ke + 1] = arr[q, oa][:, 1]
                if nk > 0 and k0 + nk < Le:
                    arr[q + 1, oa][:, 0] = arr[q, oa][:, nk]
    r = st["r"].double()
    total = None
    for k0, nk in own:
        lo, hi = max(k0, h), min(k0 + nk, h + L)
        part = (gram_parts(Y[:, :, lo - h:hi - h], Yt[:, :, lo - h:hi - h],
                           r[:, lo - h:hi - h]) if hi > lo else
                torch.zeros((n_shard, n_parts(s)), dtype=torch.float64))
        total = part if total is None else total + part
    return Y, Yt, total


@pytest.mark.parametrize("s", [1, 2, 3, 4])
@pytest.mark.parametrize("L", ["2s+1", 16, 64, 512])
def test_k10b_partition_emulation_matches_the_plain_version(s, L):
    L = 2 * s + 1 if L == "2s+1" else L
    st, ins = _ca_inputs(L, s)
    ref = {k: v.clone() for k, v in st.items()}
    ca_basis(ref, *ins, 10 ** 6, s)
    Y, Yt, parts = emulate_k10b(st, *ins, s, ca_cluster_plan(L, s))
    for name, got in (("Y", Y), ("Yt", Yt), ("parts", parts)):
        want = ref[name]
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= 1e-13, (name, err)


@pytest.mark.parametrize("L,C", [(31, None), (100, None), (64, 4), (64, 16),
                                 (16, 1), (16, 2), (16, 16)])
def test_k10b_partition_with_empty_and_swept_ctas(L, C):
    """L = 31 and 100 at s = 4 leave the last CTA without knots, as C = 16
    at L = 16 leaves four; the others are the cluster sweep's layouts."""
    s = 4
    st, ins = _ca_inputs(L, s, seed=1)
    ref = {k: v.clone() for k, v in st.items()}
    ca_basis(ref, *ins, 10 ** 6, s)
    plan = ca_cluster_plan(L, s, C)
    Le, ke = L + 2 * (2 * s + 1), plan.knots_per_cta
    if C is None or (L, C) == (16, 16):
        assert (plan.cluster - 1) * ke >= Le       # an empty CTA
    Y, Yt, parts = emulate_k10b(st, *ins, s, plan)
    for name, got in (("Y", Y), ("Yt", Yt), ("parts", parts)):
        want = ref[name]
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-13, name


@pytest.mark.parametrize("L,s", [(9, 4), (16, 4), (64, 4), (512, 4), (512, 1),
                                 (33, 2)])
def test_k10b_launches_its_plan(recorder, L, s):
    st, ins = _ca_inputs(L, s, n_shard=3)
    st = {k: (v.float() if v.dtype == torch.float64 and k in ("x", "r", "z", "p",
                                                              "pkt") else v)
          for k, v in st.items()}
    ins = [t.float() for t in ins]
    ca_basis_cuda(st, *ins, 167, s)
    ((name, a),) = recorder
    plan = ca_cluster_plan(L, s)
    assert name == "ca_basis_launch"
    # ..., L, s, n_shard, max_iter, cluster, ke, blocks, threads, smem, stream
    assert a[18:27] == (L, s, 3, 167, plan.cluster, plan.knots_per_cta,
                        int(plan.blocks_in_smem), plan.threads, plan.smem_bytes)
    assert a[5] == ins[0].stride(0)


@pytest.mark.parametrize("L,s", [(8, 4), (513, 4), (600, 1)])
def test_k10b_raises_before_any_launch(recorder, L, s):
    st, ins = _ca_inputs(max(L, 2 * s + 1), s, n_shard=2)
    if L < 2 * s + 1:
        st = {k: (v[:, :, :L] if k in ("Y", "Yt") else
                  v[:, :L] if k in ("x", "r", "z", "p") else v) for k, v in st.items()}
    st = {k: (v.float() if k in ("x", "r", "z", "p", "pkt") else v)
          for k, v in st.items()}
    with pytest.raises(ValueError, match="knots"):
        ca_basis_cuda(st, *[t.float() for t in ins], 167, s)
    assert recorder == []


def test_k10b_raises_on_misaligned_blocks(recorder):
    """K10b reads the blocks by 16-byte loads: a slab that does not start on
    16 bytes raises before any launch."""
    L, s = 16, 4
    st, ins = _ca_inputs(L, s, n_shard=2)
    st = {k: (v.float() if k in ("x", "r", "z", "p", "pkt") else v)
          for k, v in st.items()}
    ins = [t.float() for t in ins]
    flat = torch.zeros(ins[0].numel() + 1)
    ins[0] = flat[1:].view(ins[0].shape)          # 4 bytes off
    with pytest.raises(ValueError, match="aligned"):
        ca_basis_cuda(st, *ins, 167, s)
    assert recorder == []
