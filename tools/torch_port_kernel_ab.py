#!/usr/bin/env python3
"""Device times, and outputs for a bitwise A/B, of the port's kernels for one
source tree.

    python3 tools/torch_port_kernel_ab.py TREE [--save FILE]
    python3 tools/torch_port_kernel_ab.py --compare FILE_A FILE_B
    python3 tools/torch_port_kernel_ab.py . --window-sweep --team-sweep --cluster-sweep
    python3 tools/torch_port_kernel_ab.py --turns PARENT_TREE SAVE_DIR [flags]

TREE is the root of a checkout (this one: ``.``; an earlier commit unpacked
with ``git archive <commit> | tar -x -C devscratch/parent``).  The script
imports that tree's ``mpcgpu_tpu_torch`` and ``chip_smoke``, builds its
kernels (into TREE's own ``_build/<hash>``) and prints each kernel's device
time (a CUDA graph of 20 calls, ``chip_smoke.graph_ms``) at the main path's
shapes, one line per group:

  * K1 at N = 64 and 512, K5 at 64, K8a at B = 256, K9a and K9b at N = 512
    over 8 shards and 64 over 4 (windows of L + 4 knots; K9b on K9a's
    interior blocks and a seeded lam), on trace 0_0 + noise;
  * K3 at N = 64 and 512, K3b at B = 256, K9c at 512 / 8 and 64 / 4, on a
    seeded numpy step dz;
  * K2 / K2' at N = 64 on the real Schur system from a cold start (PCG cap
    167, exit_tol 1e-5), K4 one 2 ms period at a 2 ms offset, K8b / K4b at
    B = 256, K6 on K2's lam and K8c on K8b's;
  * K7 at N = 64 and 512 on ``chip_smoke.synthetic_btd`` and on a calm
    window of a trace (0_0 from row 350 at N = 64; 3_4 from row 0 at
    N = 512: 0_0 has 316 rows from row 350), beside the dense Cholesky solve
    of the same system (``torch.linalg.cholesky_ex`` + ``cholesky_solve``);
    K10b at N = 512 over 8 shards and 64 over 4 (s = 4), on chip_smoke's
    phase 2c inputs: the real system's second outer step;
  * K10a and the coefficient step K10b' at N = 512 over 8 shards, 64 over 4
    and 512 on one shard, each working and exited (K10a: the exit test
    fires at once, max_iter = 0; K10b': every shard done), on trace 0_0 +
    noise: K10a from the state after the plain init step and one plain step
    (its next step's inputs), K10b' on the plain K10b's state at the second
    outer step, so both trees see the same inputs;
  * the dz group: K6 at N = 64 and 512 and K9b at 512 over 8 and 64 over 4
    (on halo-extended slabs) at nq = 7, 3 and 5 on seeded blocks, K8c at B =
    256, and the pairs on their routes: K2' (from K2's lam, with no CG step:
    r0, z0 and the exit test) then K6, and the sharded step's halo glue
    then K9b.

Every input is made from a seed, so two trees see the same inputs; --save
writes every output of every group: K1, K5, K8a, K9a, K9b, K3, K3b, K9c,
K7, K10b, K10a, K10b', and K2, K2', K4, K8b, K4b, K6, K8c (one working call
each; CPU tensors, ``torch.save``): all 19 rows of the kernel table,
and --compare prints, per kernel and output, "bitwise equal" or the largest
difference.  To compare two trees on one card, run them in turns in one chip
call (parent, change, change, parent) and compare the saved outputs:

    python3 tools/torch_port_kernel_ab.py devscratch/parent --save devscratch/ab/parent.pt
    python3 tools/torch_port_kernel_ab.py . --save devscratch/ab/change.pt
    python3 tools/torch_port_kernel_ab.py .
    python3 tools/torch_port_kernel_ab.py devscratch/parent
    python3 tools/torch_port_kernel_ab.py --compare devscratch/ab/parent.pt devscratch/ab/change.pt

(The saved outputs at B = 256 take ~100 MB.)

``--window-sweep`` times K1 (N = 64, 512) with windows of 2, 3 and 4 knots
(``solver/kkt_cuda.py::KKT_WINDOW``) and K8a (B = 256) with windows of 4 to
49 knots and 7 groups (its plan, ``kkt_batched_plan``, takes 32 there; a
tree without that plan times K8a at the windows of 2, 3 and 4), ``--team-sweep`` K3
(N = 64) and K3b (B = 256) with teams of 1..32 lanes and 32, 64 or 128
samples a block (``solver/merit_cuda.py::merit_team_plan``); both print whether each
result equals the default plan's bit for bit.  ``--cluster-sweep`` times K2'
at N = 64 launched by hand with clusters of 2, 4, 8 and 16 CTAs, the choice
that ``ops/pcg_cuda.py::k2_cluster_plan`` fixes at 8.  ``--ca-cluster-sweep``
times K10b at both shard cases with every cluster size that
``ops/pcg_ca_cuda.py::ca_cluster_plan(L, s, C)`` admits (C = 4, 8, 16 at L =
64; 1..16 at L = 16), launched by hand, and prints whether Y and Ytil equal
the default plan's bit for bit and how far the parts are.
``--slab-cluster-sweep`` times K10a's working call at the three shard cases
with every cluster size ``ops/pcg_slab_cuda.py::slab_cluster_plan(L, C)``
admits, ``--coeff-cluster-sweep`` K10b''s with every one
``ops/pcg_ca_cuda.py::coeff_plan(L, s, C)`` admits, both launched by hand,
and print whether the outputs equal the default plan's bit for bit (K10a's
dots: how far).  ``--ca-pcr`` runs only the K7 / K10b group and
``--slab-coeff`` only the K10a / K10b' group, ``--dz`` only the dz group
(``--dz-sweep`` adds K6 / K9b at 1..8 knots per CTA, launched by hand).
The sweeps need a tree of the slice that added them or later.

``--turns PARENT_TREE SAVE_DIR [flags]`` runs the A/B of this tree against
PARENT_TREE in one call, one process per run: parent (saving), this tree
(saving), this tree, parent, then ``--compare`` of the saved outputs, e.g.
``--turns devscratch/parent devscratch/ab --dz``.

Needs a CUDA card; imports nothing of JAX.
"""

import sys
from pathlib import Path

FLAGS = ("--cluster-sweep", "--window-sweep", "--team-sweep",
         "--ca-cluster-sweep", "--ca-pcr", "--slab-cluster-sweep",
         "--coeff-cluster-sweep", "--slab-coeff", "--dz", "--dz-sweep")


def turns(parent: str, save_dir: str, flags: list) -> None:
    """The A/B in one call: this script on the parent tree, this tree, this
    tree and the parent tree, one process each (each builds its tree's
    kernels), the first two saving their outputs under save_dir; then
    --compare of the two."""
    import subprocess

    here = str(Path(__file__).resolve())
    saved = {"parent": f"{save_dir}/parent.pt", "change": f"{save_dir}/change.pt"}
    for tree, save in ((parent, saved["parent"]), (".", saved["change"]),
                       (".", None), (parent, None)):
        cmd = [sys.executable, here, tree, *flags] + (["--save", save] if save else [])
        print(f"== {' '.join(cmd[1:])}", flush=True)
        subprocess.run(cmd, check=True)
    subprocess.run([sys.executable, here, "--compare", saved["parent"],
                    saved["change"]], check=True)


def compare(path_a: str, path_b: str) -> None:
    import torch

    a, b = torch.load(path_a), torch.load(path_b)
    print(f"compare {path_a} (reference) with {path_b}:")
    for key in a:
        x, y = a[key].double(), b[key].double()
        if torch.equal(a[key], b[key]):
            print(f"  {key}: bitwise equal")
            continue
        d = (x - y).abs()
        rel = float(d.max()) / max(float(x.abs().max()), 1e-30)
        print(f"  {key}: largest difference {float(d.max()):.3e} = {rel:.3e} "
              f"max|ref| ({int((d > 0).sum())} of {d.numel()} entries differ)")


def ca_pcr(tree, c, torch, dev, keep, sweep: bool) -> None:
    """K7 and K10b of the tree: outputs kept, device times printed; with
    ``sweep`` K10b at every cluster size its plan admits."""
    from mpcgpu_tpu_torch import _kernels
    from mpcgpu_tpu_torch.config import CostConfig
    from mpcgpu_tpu_torch.models import iiwa14
    from mpcgpu_tpu_torch.ops.btd import btd_to_dense
    from mpcgpu_tpu_torch.ops.pcg_ca import ca_basis, ca_coeff_step, ca_state
    from mpcgpu_tpu_torch.ops.pcg_ca_cuda import ca_basis_cuda
    from mpcgpu_tpu_torch.ops.pcr_cuda import pcr_solve_cuda
    from mpcgpu_tpu_torch.parallel import KnotMesh
    from mpcgpu_tpu_torch.parallel.pcg_sharded import _ca_halo_blocks, _ca_init
    from mpcgpu_tpu_torch.solver.kkt_cuda import build_kkt_schur

    m = iiwa14(torch.float32, device=dev)
    rho = torch.full((), c.RHO0, device=dev)
    times = {}
    for N, trace, start in ((c.N_MAIN, "0_0", c.CALM_ROW), (c.N_BIG, "3_4", 0)):
        xu, xs, ee, _ = c.problem(N, torch, dev, 0, start, trace)
        k1 = build_kkt_schur(m, CostConfig.for_knots(N), xu, xs, ee, rho, c.DT, 0)
        S_syn, _, b_syn = c.synthetic_btd(N, torch, dev)
        for label, (S7, b7) in (("synthetic", (S_syn, b_syn)),
                                (f"{trace} row {start}", (k1["S"], k1["gamma"]))):
            keep(f"K7 N={N} {label}", pcr_solve_cuda(S7, b7))
        times[f"K7 N={N}"] = c.graph_ms(torch, lambda: pcr_solve_cuda(S_syn, b_syn))
        dense, rhs = btd_to_dense(S_syn), b_syn.reshape(-1, 1)
        times[f"Cholesky N={N}"] = c.time_ms(torch, lambda: torch.cholesky_solve(
            rhs, torch.linalg.cholesky_ex(dense).L), 5)
    s_, cap, tol0 = c.CA_S, c.CA_CAP, _kernels.scalar(0.0, dev)
    cases = {}
    for N, S in c.SHARD_CASES:
        xu, xs, ee, _ = c.problem(N, torch, dev)
        k1 = build_kkt_schur(m, CostConfig.for_knots(N), xu, xs, ee, rho, c.DT, 0)
        mesh = KnotMesh(S)
        sc = lambda t: t.reshape(S, N // S, *t.shape[1:])
        S_l, P_l, g_l = sc(k1["S"]), sc(k1["Pinv"]), sc(k1["gamma"])
        h = 2 * s_ + 1
        blocks = (S_l, P_l, *_ca_halo_blocks(S_l, h, mesh),
                  *_ca_halo_blocks(P_l, h, mesh))
        lam0 = torch.zeros_like(g_l)
        st = ca_state(lam0, *_ca_init(S_l, P_l, g_l, lam0, mesh), tol0, "eta", s_)
        packets = lambda: (mesh.send_right(st["pkt"][:, 0]),
                           mesh.send_left(st["pkt"][:, 1]))
        ca_basis(st, *blocks, *packets(), cap, s_)
        ca_coeff_step(st, mesh.psum(st["parts"]), cap, tol0, "eta", s_)
        ins = blocks + packets()
        got = {k: v.clone() for k, v in st.items()}
        ca_basis_cuda(got, *ins, cap, s_)
        keep(f"K10b N={N}/{S}", {k: got[k] for k in ("Y", "Yt", "parts")})
        st_k = {k: v.clone() for k, v in st.items()}
        times[f"K10b N={N}/{S}"] = c.graph_ms(
            torch, lambda: ca_basis_cuda(st_k, *ins, cap, s_))
        cases[N, S] = (st, ins, got)
    print(f"{tree.name or tree}: " + ", ".join(
        f"{k} {v * 1e3:.1f} us" for k, v in times.items()) + f"; {c.card_line()}",
          flush=True)
    if not sweep:
        return
    from mpcgpu_tpu_torch.ops.pcg_ca_cuda import ca_cluster_plan

    launch = _kernels.entry("pcg_ca.cu", "ca_basis_launch", nq=7)
    for (N, S), (st, ins, want) in cases.items():
        L = N // S
        for C in (1, 2, 4, 8, 16):
            try:
                plan = ca_cluster_plan(L, s_, C)
            except ValueError as exc:
                print(f"  K10b N={N}/{S} C={C}: not admitted ({exc})", flush=True)
                continue
            st_c = {k: v.clone() for k, v in st.items()}
            Sx = ins[0]

            def k10b_at(plan=plan, st_c=st_c):
                _kernels.check(launch(
                    st_c["p"].data_ptr(), st_c["z"].data_ptr(), st_c["r"].data_ptr(),
                    Sx.data_ptr(), ins[1].data_ptr(), Sx.stride(0),
                    *(t.data_ptr() for t in ins[2:]), st_c["scal"].data_ptr(),
                    st_c["iters"].data_ptr(), st_c["done"].data_ptr(),
                    st_c["Y"].data_ptr(), st_c["Yt"].data_ptr(),
                    st_c["parts"].data_ptr(), L, s_, S, cap, plan.cluster,
                    plan.knots_per_cta, int(plan.blocks_in_smem), plan.threads,
                    plan.smem_bytes, _kernels.stream_ptr(dev)), "ca_basis_launch")

            k10b_at()
            torch.cuda.synchronize()
            same = all(torch.equal(st_c[k], want[k]) for k in ("Y", "Yt"))
            d = float(((st_c["parts"] - want["parts"]).abs().max()
                       / want["parts"].abs().max()))
            ms = c.graph_ms(torch, k10b_at)
            print(f"  K10b N={N}/{S} C={C} x {plan.knots_per_cta} knots "
                  f"({plan.threads} threads, S and Pinv in shared memory "
                  f"{plan.blocks_in_smem}): {ms * 1e3:.1f} us; Y, Ytil equal to "
                  f"the default plan's {same}, parts {d:.3e} max|parts| apart",
                  flush=True)


def slab_coeff(tree, c, torch, dev, keep, slab_sweep: bool,
               coeff_sweep: bool) -> None:
    """K10a and K10b' of the tree at the three shard cases, working and
    exited: outputs of one working call kept, device times printed; with
    the sweeps each at every cluster size its plan admits."""
    from mpcgpu_tpu_torch import _kernels
    from mpcgpu_tpu_torch.config import CostConfig
    from mpcgpu_tpu_torch.models import iiwa14
    from mpcgpu_tpu_torch.ops.pcg_ca import ca_basis, ca_coeff_step, ca_state
    from mpcgpu_tpu_torch.ops.pcg_ca_cuda import ca_coeff_step_cuda
    from mpcgpu_tpu_torch.ops.pcg_slab import pcg_slab_step, slab_state
    from mpcgpu_tpu_torch.ops.pcg_slab_cuda import pcg_slab_step_cuda
    from mpcgpu_tpu_torch.parallel import KnotMesh
    from mpcgpu_tpu_torch.parallel.pcg_sharded import (_ca_halo_blocks, _ca_init,
                                                       btd_matvec_halo)
    from mpcgpu_tpu_torch.solver.kkt_cuda import build_kkt_schur

    m = iiwa14(torch.float32, device=dev)
    rho = torch.full((), c.RHO0, device=dev)
    s_, cap, tol0 = c.CA_S, c.CA_CAP, _kernels.scalar(0.0, dev)
    clone = lambda st: {k: v.clone() for k, v in st.items()}
    times, cases = {}, {}
    for N, S in c.SHARD_CASES + ((c.N_BIG, 1),):
        L = N // S
        xu, xs, ee, _ = c.problem(N, torch, dev)
        k1 = build_kkt_schur(m, CostConfig.for_knots(N), xu, xs, ee, rho, c.DT, 0)
        mesh = KnotMesh(S)
        sc = lambda t: t.reshape(S, L, *t.shape[1:])
        S_l, P_l, g_l = sc(k1["S"]), sc(k1["Pinv"]), sc(k1["gamma"])
        # K10a: the state after the plain init step and one plain step
        PL, PR = mesh.send_right(P_l[:, -1]), mesh.send_left(P_l[:, 0])
        lam0 = torch.zeros_like(g_l)
        st = slab_state(lam0, g_l - btd_matvec_halo(S_l, lam0, mesh))
        pk = lambda: (mesh.send_right(st["pkt"][:, 0]), mesh.send_left(st["pkt"][:, 1]))
        pcg_slab_step(st, S_l, P_l, *pk(), PL, PR, st["dots"], cap, tol0, "eta", True)
        pcg_slab_step(st, S_l, P_l, *pk(), PL, PR, mesh.psum(st["dots"]), cap, tol0,
                      "eta", False)
        ins = (S_l, P_l, *pk(), PL, PR, mesh.psum(st["dots"]))
        got = clone(st)
        pcg_slab_step_cuda(got, *ins, cap, tol0, "eta", False)
        keep(f"K10a N={N}/{S}", {k: got[k] for k in
                                 ("x", "r", "p", "s", "u", "w", "pkt", "dots",
                                  "scal", "iters")})
        st_k, st_x = clone(st), clone(st)
        times[f"K10a N={N}/{S}"] = c.graph_ms(
            torch, lambda: pcg_slab_step_cuda(st_k, *ins, cap, tol0, "eta", False))
        times[f"K10a exited N={N}/{S}"] = c.graph_ms(
            torch, lambda: pcg_slab_step_cuda(st_x, *ins, 0, tol0, "eta", False))
        # K10b': the plain K10b's state at the second outer step
        h = 2 * s_ + 1
        blocks = (S_l, P_l, *_ca_halo_blocks(S_l, h, mesh),
                  *_ca_halo_blocks(P_l, h, mesh))
        cst = ca_state(lam0, *_ca_init(S_l, P_l, g_l, lam0, mesh), tol0, "eta", s_)
        pkc = lambda: (mesh.send_right(cst["pkt"][:, 0]),
                       mesh.send_left(cst["pkt"][:, 1]))
        ca_basis(cst, *blocks, *pkc(), cap, s_)
        ca_coeff_step(cst, mesh.psum(cst["parts"]), cap, tol0, "eta", s_)
        ca_basis(cst, *blocks, *pkc(), cap, s_)
        tot = mesh.psum(cst["parts"])
        coef = clone(cst)
        ca_coeff_step_cuda(coef, tot, cap, tol0, "eta", s_)
        keep(f"K10b' N={N}/{S}", {k: coef[k] for k in
                                  ("x", "r", "z", "p", "pkt", "scal", "iters", "done")})
        cs_k, cs_x = clone(cst), clone(cst)
        cs_x["done"].fill_(1)
        times[f"K10b' N={N}/{S}"] = c.graph_ms(
            torch, lambda: ca_coeff_step_cuda(cs_k, tot, cap, tol0, "eta", s_))
        times[f"K10b' exited N={N}/{S}"] = c.graph_ms(
            torch, lambda: ca_coeff_step_cuda(cs_x, tot, cap, tol0, "eta", s_))
        cases[N, S] = (st, ins, got, cst, tot, coef)
    print(f"{tree.name or tree}: " + ", ".join(
        f"{k} {v * 1e3:.2f} us" for k, v in times.items()) + f"; {c.card_line()}",
          flush=True)
    if slab_sweep:
        from mpcgpu_tpu_torch.ops.pcg_slab_cuda import slab_cluster_plan

        launch = _kernels.entry("pcg_slab.cu", "pcg_slab_launch", nq=7)
        for (N, S), (st, ins, want, *_) in cases.items():
            for C in (1, 2, 4, 8, 16):
                try:
                    plan = slab_cluster_plan(N // S, C)
                except ValueError as exc:
                    print(f"  K10a N={N}/{S} C={C}: not admitted ({exc})", flush=True)
                    continue
                st_c = clone(st)

                def k10a_at(plan=plan, st_c=st_c, S=S, N=N, ins=ins, cap=cap):
                    _kernels.check(launch(
                        *(st_c[k].data_ptr() for k in ("x", "r", "p", "s", "u", "w")),
                        ins[0].data_ptr(), ins[1].data_ptr(), ins[0].stride(0),
                        *(t.data_ptr() for t in ins[2:6]), ins[6].data_ptr(),
                        ins[6].stride(0), st_c["scal"].data_ptr(),
                        st_c["iters"].data_ptr(), st_c["dots"].data_ptr(),
                        st_c["pkt"].data_ptr(), N // S, S, *plan, cap,
                        tol0.data_ptr(), 0, 0, _kernels.stream_ptr(dev)),
                        "pcg_slab_launch")

                k10a_at()
                torch.cuda.synchronize()
                same = all(torch.equal(st_c[k], want[k]) for k in
                           ("x", "r", "p", "s", "u", "w", "pkt", "scal", "iters"))
                d = float((st_c["dots"] - want["dots"]).abs().max()
                          / want["dots"].abs().max())
                st_c.update(clone(st))
                ms = c.graph_ms(torch, k10a_at)
                ms_x = c.graph_ms(torch, lambda k=k10a_at: k(cap=0))
                print(f"  K10a N={N}/{S} C={C} x {plan.knots_per_cta} knots "
                      f"({plan.threads} threads): {ms * 1e3:.2f} us, exited "
                      f"{ms_x * 1e3:.2f} us; vectors and packets equal to the "
                      f"default plan's {same}, dots {d:.3e} max|dots| apart",
                      flush=True)
    if coeff_sweep:
        from mpcgpu_tpu_torch.ops.pcg_ca_cuda import coeff_plan

        launch = _kernels.entry("pcg_ca.cu", "ca_coeff_launch", nq=7)
        for (N, S), (*_, cst, tot, want) in cases.items():
            for C in (1, 2, 4, 8, 16):
                plan = coeff_plan(N // S, s_, C)
                cs_c = clone(cst)

                def coeff_at(plan=plan, cs_c=cs_c, S=S, N=N, tot=tot):
                    _kernels.check(launch(
                        *(cs_c[k].data_ptr() for k in ("x", "r", "z", "p", "Y", "Yt")),
                        tot.data_ptr(), tot.stride(0), cs_c["scal"].data_ptr(),
                        cs_c["iters"].data_ptr(), cs_c["done"].data_ptr(),
                        cs_c["pkt"].data_ptr(), N // S, s_, S, *plan, cap,
                        tol0.data_ptr(), 0, _kernels.stream_ptr(dev)),
                        "ca_coeff_launch")

                coeff_at()
                torch.cuda.synchronize()
                same = all(torch.equal(cs_c[k], want[k]) for k in
                           ("x", "r", "z", "p", "pkt", "scal", "iters", "done"))
                cs_c.update(clone(cst))
                ms = c.graph_ms(torch, coeff_at)
                cs_c["done"].fill_(1)
                ms_x = c.graph_ms(torch, coeff_at)
                print(f"  K10b' N={N}/{S} C={C} x {plan.rows_per_cta} rows "
                      f"({plan.threads} threads): {ms * 1e3:.2f} us, exited "
                      f"{ms_x * 1e3:.2f} us; equal to the default plan's {same}",
                      flush=True)


def dz_launch_raw(plan, args: tuple, dz):
    """dz_warp_launch by hand on a plan; args are the wrapper's arguments up
    to the batch (lam .. N, batch)."""
    from mpcgpu_tpu_torch import _kernels

    nq = dz.shape[-1] // 3
    _kernels.check(_kernels.entry("pcg_dz.cu", "dz_warp_launch", nq=nq)(
        *args, *plan, dz.data_ptr(), _kernels.stream_ptr(dz.device)),
        "dz_warp_launch")
    return dz


def dz_group(tree, c, torch, dev, keep, sweep: bool) -> None:
    """K6 (N = 64, 512) and K9b (512 over 8, 64 over 4 shards, on
    halo-extended slabs of L + 4 knots) at nq = 7, 3 and 5 on seeded blocks,
    and K8c at B = 256: outputs kept, device times printed; the pairs on
    their routes: K2' (from K2's lam on the real system at N = 64, with no
    CG step: max_iter = 0) then K6, and the sharded step's halo glue then
    K9b; with ``sweep`` K6 / K9b at every number of knots per CTA its
    kernel takes, launched by hand (a tree whose ``dz_warp_launch`` takes
    ``rho_bstride``)."""
    import numpy as np

    from mpcgpu_tpu_torch.config import CostConfig
    from mpcgpu_tpu_torch.models import iiwa14
    from mpcgpu_tpu_torch.ops import pcg_cuda
    from mpcgpu_tpu_torch.parallel import KnotMesh
    from mpcgpu_tpu_torch.parallel.batched_cuda import compute_dz_batched
    from mpcgpu_tpu_torch.parallel.sqp_sharded import _next
    from mpcgpu_tpu_torch.solver.kkt_cuda import build_kkt_schur

    rng = np.random.default_rng(11)
    T = lambda *shape: torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                                    device=dev)
    rho = torch.full((), c.RHO0, device=dev)
    times, raw = {}, {}
    for nq in (7, 3, 5):
        nx, w = 2 * nq, 3 * nq
        for N in (c.N_MAIN, c.N_BIG):
            sys_ = {"Qinv": T(N, nx, nx), "A": T(N, nx, nx), "B": T(N, nx, nq),
                    "q": T(N, nx)}
            lam, u = T(N, nx), T(N, w)[:, nx:]
            name = f"K6 nq={nq} N={N}"
            fn = lambda sys_=sys_, lam=lam, u=u: pcg_cuda.compute_dz_cuda(
                sys_, lam, u, rho, 0.1)
            keep(name, fn())
            times[name] = c.graph_ms(torch, fn)
            raw[name] = (N, 1, (lam.data_ptr(), None, None,
                                *(sys_[k].data_ptr() for k in ("Qinv", "A", "B", "q")),
                                N, u.data_ptr(), u.stride(0), 0, rho.data_ptr(), 0,
                                0.1, N, 1), nq, (sys_, lam, u))
        for N, S in c.SHARD_CASES:
            L = N // S
            ext = {"Qinv": T(S, L + 4, nx, nx), "A": T(S, L + 4, nx, nx),
                   "B": T(S, L + 4, nx, nq), "q": T(S, L + 4, nx)}
            sl = {k: v[:, 2:2 + L] for k, v in ext.items()}
            lam_s = T(S, L, nx)
            lam_n = torch.roll(lam_s.reshape(N, nx), -1, 0).reshape(S, L, nx)
            last_s = (torch.arange(N, device=dev) == N - 1).float().reshape(S, L)
            u_s = T(S, L, w)[..., nx:]
            name = f"K9b nq={nq} N={N}/{S}"
            fn = lambda a=(sl, lam_s, lam_n, last_s, u_s): pcg_cuda.compute_dz_slab(
                *a, rho, 0.1)
            keep(name, fn())
            times[name] = c.graph_ms(torch, fn)
            raw[name] = (L, S, (lam_s.data_ptr(), lam_n.data_ptr(), last_s.data_ptr(),
                                *(sl[k].data_ptr() for k in ("Qinv", "A", "B", "q")),
                                L + 4, u_s.data_ptr(), u_s.stride(1), u_s.stride(0),
                                rho.data_ptr(), 0, 0.1, L, S), nq,
                         (ext, lam_s, lam_n, last_s, u_s))
    # K8c at B = 256 on seeded blocks
    B, N = c.B_MAIN, c.N_MAIN
    sb = {"Qinv": T(B, N, 14, 14), "A": T(B, N, 14, 14), "B": T(B, N, 14, 7),
          "q": T(B, N, 14)}
    lam_b, u_b, rho_b = T(B, N, 14), T(B, N, 21)[..., 14:], torch.full((B,), c.RHO0,
                                                                      device=dev)
    k8c = lambda: compute_dz_batched(sb, lam_b, u_b, rho_b, 0.1)
    keep(f"dz K8c B={B}", k8c())
    times[f"K8c B={B}"] = c.graph_ms(torch, k8c)
    # the pairs: K2' (no CG step: r0, z0 and the exit test) then K6 on the
    # real system, the halo glue then K9b
    m = iiwa14(torch.float32, device=dev)
    cost = CostConfig.for_knots(N)
    xu, xs, ee, _ = c.problem(N, torch, dev)
    s = build_kkt_schur(m, cost, xu, xs, ee, rho, c.DT, 0)
    lam2 = pcg_cuda.pcg_dz_solve(s, torch.zeros_like(s["gamma"]), xu[:, 14:], rho,
                                 cost.r_cost, max_iter=167, exit_tol=1e-5)[0]
    solve = getattr(pcg_cuda, "pcg_solve_cuda_uncast", pcg_cuda.pcg_solve_cuda)
    pair6 = lambda: pcg_cuda.compute_dz_cuda(
        s, solve(s["S"], s["Pinv"], s["gamma"], lam2, max_iter=0).lam, xu[:, 14:],
        rho, cost.r_cost)
    keep("dz pair K2' -> K6", pair6())
    times[f"pair K2' -> K6 N={N}"] = c.graph_ms(torch, pair6)
    N9, S9 = c.SHARD_CASES[0]
    L9 = N9 // S9
    mesh = KnotMesh(S9)
    sl9 = {k: T(S9, L9 + 4, *shape)[:, 2:2 + L9]
           for k, shape in (("Qinv", (14, 14)), ("A", (14, 14)), ("B", (14, 7)),
                            ("q", (14,)))}
    lam9, u9 = T(S9, L9, 14), T(S9, L9, 21)[..., 14:]
    last9 = (torch.arange(N9, device=dev) == N9 - 1).float().reshape(S9, L9)
    pair9 = lambda: pcg_cuda.compute_dz_slab(
        sl9, lam9, _next(lam9, mesh.send_left(lam9[:, 0])), last9, u9, rho, 0.1)
    keep("dz pair glue -> K9b", pair9())
    times[f"pair glue -> K9b N={N9}/{S9}"] = c.graph_ms(torch, pair9)
    print(f"{tree.name or tree}: " + ", ".join(
        f"{k} {v * 1e3:.3f} us" for k, v in times.items()) + f"; {c.card_line()}",
          flush=True)
    if not sweep:
        return
    for name in ("K6 nq=7 N=64", "K6 nq=7 N=512", "K9b nq=7 N=512/8", "K9b nq=7 N=64/4"):
        n, batch, args, nq, _ = raw[name]
        out = torch.empty((batch * n, 3 * nq), device=dev)
        ref = None
        for kpc in range(1, pcg_cuda.DZ_MAX_KPC + 1):
            plan = pcg_cuda.DzPlan(kpc, -(-n // kpc), 4 * kpc * pcg_cuda.dz_knot_floats(14))
            fn = lambda plan=plan: dz_launch_raw(plan, args, out)
            fn()
            torch.cuda.synchronize()
            ref = out.clone() if ref is None else ref
            print(f"  dz sweep {name}: {kpc} knots per CTA ({plan.ctas} CTAs per "
                  f"instance): {c.graph_ms(torch, fn) * 1e3:.3f} us; equal to 1 knot "
                  f"per CTA bit for bit {torch.equal(out, ref)}", flush=True)


def main():
    args = sys.argv[1:]
    if args[:1] == ["--compare"]:
        compare(args[1], args[2])
        return
    if args[:1] == ["--turns"]:
        turns(args[1], args[2], args[3:])
        return
    save = None
    if "--save" in args:
        i = args.index("--save")
        save = args[i + 1]
        del args[i:i + 2]
    pos = [a for a in args if a not in FLAGS]
    tree = Path(pos[0] if pos else ".").resolve()
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import chip_smoke as c
    from mpcgpu_tpu_torch.config import CostConfig
    from mpcgpu_tpu_torch.models import iiwa14
    from mpcgpu_tpu_torch.ops.pcg_cuda import (compute_dz_cuda, compute_dz_slab,
                                               pcg_dz_solve, pcg_solve_cuda)
    from mpcgpu_tpu_torch.parallel.batched_cuda import (build_kkt_schur_batched,
                                                        compute_dz_batched,
                                                        line_search_merits_batched,
                                                        pcg_solve_batched)
    from mpcgpu_tpu_torch.sim.plant_cuda import (simulate_plant,
                                                 simulate_plant_batched)
    from mpcgpu_tpu_torch.solver.kkt_cuda import (build_kkt_cuda, build_kkt_schur,
                                                  build_kkt_schur_slab)
    from mpcgpu_tpu_torch.solver.merit_cuda import (line_search_merit_partials_slab,
                                                    line_search_merits_fused)

    if not torch.cuda.is_available():
        sys.exit("torch_port_kernel_ab: needs a CUDA device")
    dev = torch.device("cuda", 0)
    N, B = c.N_MAIN, c.B_MAIN
    m = iiwa14(torch.float32, device=dev)
    mu = 1.0
    rng = np.random.default_rng(2)
    on_dev = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    outs = {}

    def keep(name, res):
        if isinstance(res, dict):
            for k, v in res.items():
                outs[f"{name} {k}"] = v.detach().cpu()
        elif isinstance(res, (tuple, list)):
            for i, v in enumerate(res):
                outs[f"{name} [{i}]"] = v.detach().cpu()
        else:
            outs[name] = res.detach().cpu()

    group = [f for f in ("--ca-pcr", "--slab-coeff", "--dz") if f in sys.argv]
    if group:
        if "--dz" in group:
            dz_group(tree, c, torch, dev, keep, "--dz-sweep" in sys.argv)
        if "--ca-pcr" in group:
            ca_pcr(tree, c, torch, dev, keep, "--ca-cluster-sweep" in sys.argv)
        if "--slab-coeff" in group:
            slab_coeff(tree, c, torch, dev, keep, "--slab-cluster-sweep" in sys.argv,
                       "--coeff-cluster-sweep" in sys.argv)
        if save is not None:
            Path(save).parent.mkdir(parents=True, exist_ok=True)
            torch.save(outs, save)
        return

    def windows(n, S, lo, hi):
        L = n // S
        return torch.tensor((np.arange(S)[:, None] * L + np.arange(lo, L + hi)) % n,
                            device=dev)

    # the KKT kernels
    inputs = {}
    for n in (N, c.N_BIG):
        cost = CostConfig.for_knots(n)
        xu, xs, ee, _ = c.problem(n, torch, dev)
        dz = on_dev(0.05 * rng.standard_normal((n, 21)))
        inputs[n] = (cost, xu, xs, ee, dz)
    rho = torch.full((), c.RHO0, device=dev)
    times = {}
    for n in (N, c.N_BIG):
        cost, xu, xs, ee, _ = inputs[n]
        k1 = lambda: build_kkt_schur(m, cost, xu, xs, ee, rho, c.DT, 0)
        keep(f"K1 N={n}", k1())
        times[f"K1 N={n}"] = c.graph_ms(torch, k1)
    cost, xu, xs, ee, dz = inputs[N]
    k5 = lambda: build_kkt_cuda(m, cost, xu, xs, ee, c.DT, 0)
    keep(f"K5 N={N}", {k: getattr(k5(), k) for k in ("Q", "q", "A", "B", "c")})
    times[f"K5 N={N}"] = c.graph_ms(torch, k5)
    xu_b, xs_b, ee_b, rho_b = c.batch_problem(B, N, torch, dev)
    k8a = lambda: build_kkt_schur_batched(m, cost, xu_b, xs_b, ee_b, rho_b, c.DT)
    keep(f"K8a B={B}", k8a())
    times[f"K8a B={B}"] = c.graph_ms(torch, k8a, calls=5)
    for n, S in c.SHARD_CASES:
        cost_n, xu_n, _, ee_n, dz_n = inputs[n]
        w = windows(n, S, -2, 2)
        first, last = (w == 0).float(), (w == n - 1).float()
        xe, ee_x = xu_n[w].contiguous(), ee_n[w].contiguous()
        k9a = lambda: build_kkt_schur_slab(m, cost_n, xe, ee_x, first, last, rho, c.DT)
        keep(f"K9a N={n}/{S}", k9a())
        times[f"K9a N={n}/{S}"] = c.graph_ms(torch, k9a)
        # K9b on K9a's interior blocks and a seeded lam (its own generator,
        # so the other groups' inputs stay as they were)
        L = n // S
        sl = {k: v[:, 2:2 + L] for k, v in k9a().items()}
        lam_s = on_dev(0.1 * np.random.default_rng(7).standard_normal((S, L, 14)))
        lam_n = torch.roll(lam_s.reshape(n, 14), -1, 0).reshape(S, L, 14)
        last_s = (torch.arange(n, device=dev) == n - 1).float().reshape(S, L)
        u_s = xu_n.reshape(S, L, 21)[..., 14:]
        k9b = lambda: compute_dz_slab(sl, lam_s, lam_n, last_s, u_s, rho,
                                      cost_n.r_cost)
        keep(f"K9b N={n}/{S}", k9b())
        times[f"K9b N={n}/{S}"] = c.graph_ms(torch, k9b)
    print(f"{tree.name or tree}: " + ", ".join(
        f"{k} {v * 1e3:.1f} us" for k, v in times.items()) + f"; {c.card_line()}",
          flush=True)

    # the merit kernels
    times = {}
    for n in (N, c.N_BIG):
        cost_n, xu_n, xs_n, ee_n, dz_n = inputs[n]
        k3 = lambda: line_search_merits_fused(m, cost_n, xu_n, dz_n, xs_n, ee_n, mu, c.DT)
        keep(f"K3 N={n}", k3())
        times[f"K3 N={n}"] = c.graph_ms(torch, k3)
    dz_b = on_dev(0.05 * rng.standard_normal((B, N, 21)))
    k3b = lambda: line_search_merits_batched(m, cost, xu_b, dz_b, xs_b, ee_b, mu, c.DT)
    keep(f"K3b B={B}", k3b())
    times[f"K3b B={B}"] = c.graph_ms(torch, k3b)
    for n, S in c.SHARD_CASES:
        cost_n, xu_n, _, ee_n, dz_n = inputs[n]
        w1 = windows(n, S, 0, 1)
        x1, z1, e1 = xu_n[w1].contiguous(), dz_n[w1].contiguous(), ee_n[w1].contiguous()
        k9c = lambda: line_search_merit_partials_slab(m, cost_n, x1, z1, e1, c.DT)
        keep(f"K9c N={n}/{S}", k9c())
        times[f"K9c N={n}/{S}"] = c.graph_ms(torch, k9c)
    print(f"{tree.name or tree}: " + ", ".join(
        f"{k} {v * 1e3:.1f} us" for k, v in times.items()) + f"; {c.card_line()}",
          flush=True)
    ca_pcr(tree, c, torch, dev, keep, "--ca-cluster-sweep" in sys.argv)
    slab_coeff(tree, c, torch, dev, keep, "--slab-cluster-sweep" in sys.argv,
               "--coeff-cluster-sweep" in sys.argv)
    dz_group(tree, c, torch, dev, keep, "--dz-sweep" in sys.argv)

    # K2, K2', K4, K8b, K4b
    s = build_kkt_schur(m, cost, xu, xs, ee, rho, c.DT, 0)
    lam = torch.zeros_like(s["gamma"])
    kw = dict(max_iter=167, exit_tol=1e-5)
    k2 = c.graph_ms(torch, lambda: pcg_dz_solve(s, lam, xu[:, 14:], rho,
                                                cost.r_cost, **kw))
    k2p = c.graph_ms(torch, lambda: pcg_solve_cuda(s["S"], s["Pinv"],
                                                   s["gamma"], lam, **kw))
    it = int(pcg_dz_solve(s, lam, xu[:, 14:], rho, cost.r_cost, **kw)[2])
    xs4 = xs + 0.01 * torch.tensor(np.random.default_rng(1).standard_normal(14),
                                   dtype=torch.float32, device=dev)
    k4 = c.graph_ms(torch, lambda: simulate_plant(m, xs4, xu, 2e-3, 2e-3, c.DT,
                                                  10, 2e-4))
    sb = build_kkt_schur_batched(m, cost, xu_b, xs_b, ee_b, rho_b, c.DT)
    l0 = torch.zeros((B, N, 14), device=dev)
    k8b = c.graph_ms(torch, lambda: pcg_solve_batched(
        sb["S"], sb["Pinv"], sb["gamma"], l0, **kw), calls=5)
    itb = pcg_solve_batched(sb["S"], sb["Pinv"], sb["gamma"], l0, **kw)[1]
    k4b = c.graph_ms(torch, lambda: simulate_plant_batched(
        m, xs_b, xu_b, 2e-3, 2e-3, c.DT, 10, 2e-4))
    keep("K2", pcg_dz_solve(s, lam, xu[:, 14:], rho, cost.r_cost, **kw))
    keep("K2'", tuple(pcg_solve_cuda(s["S"], s["Pinv"], s["gamma"], lam, **kw)))
    keep("K4", simulate_plant(m, xs4, xu, 2e-3, 2e-3, c.DT, 10, 2e-4))
    keep(f"K8b B={B}", tuple(pcg_solve_batched(sb["S"], sb["Pinv"], sb["gamma"],
                                               l0, **kw)))
    keep(f"K4b B={B}", simulate_plant_batched(m, xs_b, xu_b, 2e-3, 2e-3, c.DT,
                                              10, 2e-4))
    # K6 on K2's lam, K8c on K8b's
    lam2 = pcg_dz_solve(s, lam, xu[:, 14:], rho, cost.r_cost, **kw)[0]
    lamb = pcg_solve_batched(sb["S"], sb["Pinv"], sb["gamma"], l0, **kw)[0]
    k6f = lambda: compute_dz_cuda(s, lam2, xu[:, 14:], rho, cost.r_cost)
    k8cf = lambda: compute_dz_batched(sb, lamb, xu_b[:, :, 14:], rho_b, cost.r_cost)
    keep("K6", k6f())
    keep(f"K8c B={B}", k8cf())
    k6, k8c = c.graph_ms(torch, k6f), c.graph_ms(torch, k8cf)
    if save is not None:
        Path(save).parent.mkdir(parents=True, exist_ok=True)
        torch.save(outs, save)
    print(f"{tree.name or tree}: K2 {k2 * 1e3:.1f} us ({it} iterations, "
          f"{k2 * 1e3 / max(it, 1):.3f} us each), K2' {k2p * 1e3:.1f} us, K4 "
          f"{k4 * 1e3:.1f} us, K8b {k8b * 1e3:.1f} us (B={B}, iterations "
          f"{int(itb.min())}..{int(itb.max())}, {int(itb.sum())} in all), K4b "
          f"{k4b * 1e3:.1f} us, K6 {k6 * 1e3:.2f} us, K8c {k8c * 1e3:.1f} us; "
          f"{c.card_line()}", flush=True)

    if "--window-sweep" in sys.argv:
        from mpcgpu_tpu_torch.solver import kkt_cuda

        default = kkt_cuda.KKT_WINDOW
        cases = {f"K1 N={n}": (lambda n=n: build_kkt_schur(
            m, inputs[n][0], inputs[n][1], inputs[n][2], inputs[n][3], rho, c.DT, 0))
            for n in (N, c.N_BIG)}
        if hasattr(kkt_cuda, "kkt_batched_plan"):
            from mpcgpu_tpu_torch.parallel import batched_cuda

            planned = batched_cuda.k8a_plan
            for Kc in (4, 8, 16, 24, 32, 40, 49):
                plan = kkt_cuda.KKTBatchedPlan(Kc, 7, -(-N // Kc),
                                               kkt_cuda.kkt_smem_bytes(Kc, groups=7))
                batched_cuda.k8a_plan = lambda *a, plan=plan: plan
                try:
                    res = k8a()
                    same = all(torch.equal(v.cpu(), outs[f"K8a B={B} {k}"])
                               for k, v in res.items())
                    ms = c.graph_ms(torch, k8a, calls=5)
                finally:
                    batched_cuda.k8a_plan = planned
                print(f"  window sweep K8a B={B} Kc={Kc}, 7 groups: {ms * 1e3:.1f} us "
                      f"({plan.ctas} CTAs per instance, {plan.smem_bytes} B shared "
                      f"memory each); bitwise equal to the plan's: {same}", flush=True)
        else:
            cases[f"K8a B={B}"] = k8a
        for Kc in (2, 3, 4):
            kkt_cuda.KKT_WINDOW = Kc
            for name, fn in cases.items():
                res = fn()
                same = all(torch.equal(v.cpu(), outs[f"{name} {k}"]) for k, v in res.items())
                ms = c.graph_ms(torch, fn, calls=5 if name.startswith("K8a") else 20)
                plan = kkt_cuda.kkt_window_plan(int(name.split("=")[1]) if "N=" in name else N)
                print(f"  window sweep {name} Kc={Kc}: {ms * 1e3:.1f} us ({plan.ctas} "
                      f"CTAs per instance, {plan.smem_bytes} B shared memory each); "
                      f"bitwise equal to Kc={default}: {same}", flush=True)
        kkt_cuda.KKT_WINDOW = default
    if "--team-sweep" in sys.argv:
        from mpcgpu_tpu_torch.solver import merit_cuda

        default = merit_cuda.MERIT_SMALL, merit_cuda.MERIT_LARGE
        cases = {f"K3 N={N}": lambda: line_search_merits_fused(
            m, cost, xu, inputs[N][4], xs, ee, mu, c.DT), f"K3b B={B}": k3b}
        for g in merit_cuda.MERIT_TEAMS:
            for P in (32, 64, 128):
                if P * g > merit_cuda.merit_max_threads(g):
                    continue
                merit_cuda.MERIT_SMALL = merit_cuda.MERIT_LARGE = (g, P)
                for name, fn in cases.items():
                    res = fn()
                    same = all(torch.equal(v.cpu(), outs[f"{name} [{i}]"])
                               for i, v in enumerate(res))
                    ms = c.graph_ms(torch, fn)
                    print(f"  team sweep {name} G={g} P={P}: {ms * 1e3:.1f} us; "
                          f"bitwise equal to the default plan: {same}", flush=True)
        merit_cuda.MERIT_SMALL, merit_cuda.MERIT_LARGE = default
    if "--cluster-sweep" in sys.argv:
        from mpcgpu_tpu_torch import _kernels
        from mpcgpu_tpu_torch.ops.pcg_cuda import k2_smem_bytes

        launch = _kernels.entry("pcg_dz.cu", "pcg_launch", nq=7)
        tol = torch.full((), 1e-5, device=dev)
        out = torch.empty_like(lam)
        flags = torch.empty(2, dtype=torch.int32, device=dev)
        for C in (2, 4, 8, 16):
            kp = -(-N // C)

            def k2p_at(C=C, kp=kp):
                _kernels.check(launch(
                    s["S"].data_ptr(), s["Pinv"].data_ptr(), s["gamma"].data_ptr(),
                    lam.data_ptr(), 167, tol.data_ptr(), 0, N, C, kp,
                    k2_smem_bytes(kp), 1, out.data_ptr(), flags.data_ptr(),
                    flags.data_ptr() + 4, _kernels.stream_ptr(dev)), "pcg_launch")

            ms = c.graph_ms(torch, k2p_at)
            print(f"  K2' N={N}, {C} CTAs x {kp} knots: {ms * 1e3:.1f} us, "
                  f"{ms * 1e3 / max(int(flags[0]), 1):.3f} us per CG iteration",
                  flush=True)


if __name__ == "__main__":
    main()
