"""Knot-sharded PCG: the BTD Schur system row-partitioned over knot shards.

Port of ``mpcgpu_tpu/parallel/pcg_sharded.py``.  Each shard owns a
contiguous slab of L knot block-rows; per iteration the BTD matvec and the
stair preconditioner need only each neighbour's boundary rows (ring sends)
and the CG dot products a psum (``parallel/mesh.py``).  The per-shard bodies
take local tensors with a leading shard axis, S and Pinv (n_local, L, 3, n,
n), gamma and lam (n_local, L, n), and return (lam, iters (n_local,),
converged (n_local,)), the same on every shard:

  * ``"classic"``: textbook PCG, two dependent psums (three for rnorm) and
    four sends per iteration;
  * ``"pipelined"``: Chronopoulos-Gear, ONE psum of (r.u, w.u, r.r) and one
    two-way exchange of two-row packets per iteration: since Pinv and S are
    both block-tridiagonal, u = Pinv r on rows -1 .. L needs r rows
    -2 .. L+1, after which w = S u is local; the neighbours' boundary Pinv
    rows are exchanged once per solve;
  * ``"pipelined_slab"``: the same collectives, with each iteration's
    per-shard compute in K10a (``ops/pcg_slab_cuda.py``): the packets carry
    the boundary rows of (r, w, s) BEFORE the step, from which the receiver
    rebuilds the neighbour's new residual rows once the CG scalars are
    known, so both collectives follow the kernel.

Exit semantics are the JAX loops': |eta| < tol ("eta") or ||r||^2 < tol^2
("rnorm"), tested once before any step, a step's state kept only until the
exit fires.  The loop runs its ``max_iter`` iterations with a device ``done``
flag that masks the steps after the exit, so a solve reads nothing back to
the host.  The pipelined forms need L >= 2 (two-row packets) and fall back to
classic below it.

  * ``"ca"``: the communication-avoiding s-step CG, s iterations per outer
    step of ONE wide exchange (2 sends of (2, h, n) packets: the p and z
    rows, h = 2s+1 deep) and ONE psum of the packed Gram parts; the h-deep
    S / Pinv halo blocks are exchanged once per solve.  The bases are built
    on the slab extended by h knots per side with zero ends (the error at
    the ends moves one knot inward per application and never reaches the
    local knots), and at the global ends the ring-wrap rows meet the zero
    corner blocks as above.  The s iterations then run in 2s+1-dimensional
    coefficient space on every shard alike (``ops/pcg_ca.py``).  The s-step
    algebra (bases, Gram parts, coefficient iterations, the recovery's
    sums) runs in f64 whatever the system's precision, where the JAX
    package's runs in f32: in f32 the monomial basis loses the relations the
    recurrences assume, and the solve drifts far from CG's (``csrc/
    pcg_ca.cu``, ROADMAP.md queue 3);
  * ``"ca_slab"``: the same algebra with each outer step's per-shard
    compute in two launches: K10b (the bases and the Gram parts,
    ``ops/pcg_ca_cuda.py``), the psum, then the coefficient step (the s
    iterations, the recovery, the next scale and the next packets), so the
    scalars stay on the device.

The s-step forms need L >= 2s+1 and fall back to pipelined below it.  All
forms enqueue their whole cap: ``max_iter`` iterations, or ceil(max_iter /
s) outer steps.
"""

from __future__ import annotations

import math
from functools import partial

import torch

from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.ops.pcg import PCGResult
from mpcgpu_tpu_torch.ops.pcg_ca import (WORK, basis_chains, ca_state,
                                         gram_parts, split_parts)
from mpcgpu_tpu_torch.ops.pcg_ca import ca_coeff_iters as _ca_coeff_iters
from mpcgpu_tpu_torch.ops.pcg_ca import ca_next_scale as _ca_next_scale
from mpcgpu_tpu_torch.ops.pcg_ca import ca_shift_matrix as _ca_shift_matrix
from mpcgpu_tpu_torch.ops.pcg_ca_cuda import ca_basis_cuda, ca_coeff_step_cuda
from mpcgpu_tpu_torch.ops.pcg_slab import band_rows, exit_fired, slab_state
from mpcgpu_tpu_torch.ops.pcg_slab_cuda import pcg_slab_step_cuda
from mpcgpu_tpu_torch.parallel.mesh import KnotMesh


def _halo_rows(x_loc, mesh):
    """(from_left, from_right): the left neighbour's LAST row and the right
    neighbour's FIRST row.  The ring-wrap rows at the global edges meet the
    structurally zero corner blocks S[0, 0] and S[N-1, 2]."""
    return mesh.send_right(x_loc[:, -1]), mesh.send_left(x_loc[:, 0])


def btd_matvec_halo(S_loc, x_loc, mesh):
    """The local slabs of y = S x, with one halo row from each neighbour."""
    fl, fr = _halo_rows(x_loc, mesh)
    x_prev = torch.cat([fl[:, None], x_loc[:, :-1]], dim=1)
    x_next = torch.cat([x_loc[:, 1:], fr[:, None]], dim=1)
    return band_rows(S_loc, x_prev, x_loc, x_next)


def _per_shard(fn, *xs):
    """fn(*xs) for each local shard alone (its slab with a leading axis of
    1), joined along the shard axis (each tensor of a tuple result).
    PyTorch's CUDA reductions and batched products split their work by the
    whole tensor's shape, so per-shard sums taken over all the shards of a
    virtual mesh at once round apart from the same sums of one process's
    single shard; taken shard by shard, a body's arithmetic is the same
    wherever its shards live, and a one-card mesh reproduces a run across
    processes bit for bit."""
    n = xs[0].shape[0]
    if n == 1:
        return fn(*xs)
    outs = [fn(*(x[i:i + 1] for x in xs)) for i in range(n)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def _pdot(a, b, mesh):
    return mesh.psum(_per_shard(lambda a, b: (a * b).sum(dim=(1, 2)), a, b))


def _keep(act, new, old):
    """new where the shard's step ran, old where its exit had fired."""
    return torch.where(act.reshape(act.shape + (1,) * (new.dim() - 1)), new, old)


def _pcg_local(S_loc, Pinv_loc, gamma_loc, lam_loc, max_iter: int, exit_tol,
               mesh, exit_criterion: str = "eta"):
    """Classic PCG (module docstring)."""
    def exit_test(r, eta):
        if exit_criterion == "rnorm":
            return _pdot(r, r, mesh) < exit_tol * exit_tol
        return torch.abs(eta) < exit_tol

    r = gamma_loc - btd_matvec_halo(S_loc, lam_loc, mesh)
    p = btd_matvec_halo(Pinv_loc, r, mesh)
    eta = _pdot(r, p, mesh)
    lam, done = lam_loc, exit_test(r, eta)
    it = torch.zeros_like(done, dtype=torch.int32)
    for _ in range(max_iter):
        act = ~done
        Sp = btd_matvec_halo(S_loc, p, mesh)
        alpha = (eta / _pdot(p, Sp, mesh))[:, None, None]
        lam_n = lam + alpha * p
        r_n = r - alpha * Sp
        z = btd_matvec_halo(Pinv_loc, r_n, mesh)
        eta_n = _pdot(r_n, z, mesh)
        done_n = exit_test(r_n, eta_n)
        p_n = z + (eta_n / eta)[:, None, None] * p
        lam, r, p = _keep(act, lam_n, lam), _keep(act, r_n, r), _keep(act, p_n, p)
        eta = _keep(act, eta_n, eta)
        it = it + act.to(torch.int32)
        done = done | (act & done_n)
    return lam, it, done


def _pcg_local_pipelined(S_loc, Pinv_loc, gamma_loc, lam_loc, max_iter: int,
                         exit_tol, mesh, exit_criterion: str = "eta"):
    """Chronopoulos-Gear PCG: 1 psum + 1 two-way exchange of two-row
    packets per iteration (module docstring)."""
    L = gamma_loc.shape[1]
    # loop-invariant: the neighbours' boundary Pinv rows, for u_{-1}, u_L
    PinvL = mesh.send_right(Pinv_loc[:, -1])
    PinvR = mesh.send_left(Pinv_loc[:, 0])

    def dual_apply(r):
        """u = Pinv r on the slab and w = S u, with ONE halo exchange."""
        fl = mesh.send_right(r[:, -2:])           # left neighbour's last two
        fr = mesh.send_left(r[:, :2])             # right neighbour's first two
        re = torch.cat([fl, r, fr], dim=1)        # rows -2 .. L+1
        u = band_rows(Pinv_loc, re[:, 1:L + 1], r, re[:, 3:L + 3])
        # the off-slab rows u_{-1}, u_L from the neighbours' Pinv rows
        u_m1 = band_rows(PinvL, re[:, 0], re[:, 1], re[:, 2])
        u_L = band_rows(PinvR, re[:, L + 1], re[:, L + 2], re[:, L + 3])
        ue = torch.cat([u_m1[:, None], u, u_L[:, None]], dim=1)
        return u, band_rows(S_loc, ue[:, :L], u, ue[:, 2:])

    def reduce3(r, u, w):
        """ONE psum: (eta = r.u, d = w.u, rr = r.r)."""
        return mesh.psum(_per_shard(lambda r, u, w: torch.stack(
            [(r * u).sum((1, 2)), (w * u).sum((1, 2)), (r * r).sum((1, 2))],
            dim=1), r, u, w))

    x, r = lam_loc, gamma_loc - btd_matvec_halo(S_loc, lam_loc, mesh)
    u, w = dual_apply(r)
    tot = reduce3(r, u, w)
    eta, d = tot[:, 0], tot[:, 1]
    eta_prev = alpha_prev = torch.ones_like(eta)
    p = s = torch.zeros_like(r)
    it = torch.zeros_like(eta, dtype=torch.int32)
    done = exit_fired(tot, exit_tol, exit_criterion)
    for _ in range(max_iter):
        act = ~done
        first = it == 0
        beta = torch.where(first, torch.zeros_like(eta), eta / eta_prev)
        alpha = eta / torch.where(first, d, d - beta * eta / alpha_prev)
        p_n = u + beta[:, None, None] * p
        s_n = w + beta[:, None, None] * s
        x_n = x + alpha[:, None, None] * p_n
        r_n = r - alpha[:, None, None] * s_n
        u_n, w_n = dual_apply(r_n)
        tot = reduce3(r_n, u_n, w_n)
        x, r, p, s = (_keep(act, a, b) for a, b in
                      ((x_n, x), (r_n, r), (p_n, p), (s_n, s)))
        u, w = _keep(act, u_n, u), _keep(act, w_n, w)
        eta_prev, alpha_prev = _keep(act, eta, eta_prev), _keep(act, alpha, alpha_prev)
        eta, d = _keep(act, tot[:, 0], eta), _keep(act, tot[:, 1], d)
        it = it + act.to(torch.int32)
        done = done | (act & exit_fired(tot, exit_tol, exit_criterion))
    return x, it, done


def _pcg_local_pipelined_slab(S_loc, Pinv_loc, gamma_loc, lam_loc,
                              max_iter: int, exit_tol, mesh,
                              exit_criterion: str = "eta",
                              step=pcg_slab_step_cuda):
    """The pipelined PCG with each iteration's per-shard compute in ONE K10a
    launch, then the psum of its dots and the exchange of its packets.
    ``step`` is the step's wrapper (``ops/pcg_slab.py::pcg_slab_step``
    drives the same loop with the plain step on any device)."""
    PinvL = mesh.send_right(Pinv_loc[:, -1])
    PinvR = mesh.send_left(Pinv_loc[:, 0])
    st = slab_state(lam_loc, gamma_loc - btd_matvec_halo(S_loc, lam_loc, mesh))
    tot = st["dots"]
    for i in range(max_iter + 1):
        flp = mesh.send_right(st["pkt"][:, 0])
        frp = mesh.send_left(st["pkt"][:, 1])
        step(st, S_loc, Pinv_loc, flp, frp, PinvL, PinvR, tot, max_iter,
             exit_tol, exit_criterion, init=i == 0)
        tot = mesh.psum(st["dots"])
    return st["x"], st["iters"], exit_fired(tot, exit_tol, exit_criterion)


def _ca_halo_blocks(M, h: int, mesh):
    """The h rows of M (n_local, L, ...) of the left and of the right
    neighbour: the loop-invariant halo of the s-step forms."""
    return mesh.send_right(M[:, -h:]), mesh.send_left(M[:, :h])


def _ca_init(S_loc, Pinv_loc, gamma_loc, lam_loc, mesh):
    """The true r0 and z0 = Pinv r0 through one-row halos and the summed
    (r0.z0, r0.r0), as the other forms' init (the exit test before any
    iteration)."""
    r0 = gamma_loc - btd_matvec_halo(S_loc, lam_loc, mesh)
    z0 = btd_matvec_halo(Pinv_loc, r0, mesh)
    tot0 = mesh.psum(_per_shard(lambda r, z: torch.stack(
        [(r * z).sum((1, 2)), (r * r).sum((1, 2))], 1), r0, z0))
    return r0, z0, tot0


def _pcg_local_ca(S_loc, Pinv_loc, gamma_loc, lam_loc, max_iter: int, exit_tol,
                  mesh, exit_criterion: str = "eta", s_steps: int = 4):
    """The s-step CG in plain torch (module docstring): per outer step 2 sends
    of (2, h, n) packets, the basis chains on the extended slab, 1 psum of
    the Gram parts, the coefficient iterations and the recovery."""
    s = s_steps
    h = 2 * s + 1
    L = gamma_loc.shape[1]
    dt = gamma_loc.dtype
    SL, SR = _ca_halo_blocks(S_loc, h, mesh)
    PL, PR = _ca_halo_blocks(Pinv_loc, h, mesh)
    S_ext = torch.cat([SL, S_loc, SR], 1).to(WORK)
    P_ext = torch.cat([PL, Pinv_loc, PR], 1).to(WORK)
    T = _ca_shift_matrix(s, WORK, gamma_loc.device)

    def exit_test(eta, rr):
        if exit_criterion == "rnorm":
            return rr < exit_tol * exit_tol
        return torch.abs(eta) < exit_tol

    def bases(S_ext, P_ext, p, z, fl, fr, g, r):
        """The shard's bases on its extended slab and its Gram parts."""
        p_ext = torch.cat([fl[:, 0], p, fr[:, 0]], 1).to(WORK)
        z_ext = torch.cat([fl[:, 1], z, fr[:, 1]], 1).to(WORK)
        Ys, Yts = basis_chains(S_ext, P_ext, p_ext, z_ext, (1 / g)[:, None, None], s)
        Y = torch.stack(Ys, 1)[:, :, h:h + L]
        Yt = torch.stack(Yts, 1)[:, :, h:h + L]
        return Y, Yt, gram_parts(Y, Yt, r.to(WORK))

    def step(tot, g, eta, it, done, x, r, z, p, Y, Yt):
        """The s iterations in coefficient space and the recovery."""
        run = ~done & (it < max_iter)
        G, b, F, f, rr0 = split_parts(tot, s)
        e, a, c, eta, it, done = _ca_coeff_iters(
            G, b, F, f, rr0, g[:, None, None] * T, eta, it, done, s, max_iter,
            exit_test)
        comb = lambda w, B: torch.einsum("sa,salk->slk", w, B)
        x = _keep(run, (x + comb(e, Y)).to(dt), x)
        r = _keep(run, (r - comb(e, Yt)).to(dt), r)
        z, p = _keep(run, comb(c, Y).to(dt), z), _keep(run, comb(a, Y).to(dt), p)
        return x, r, z, p, _keep(run, _ca_next_scale(G, g, s), g), eta, it, done

    r, z, tot0 = _ca_init(S_loc, Pinv_loc, gamma_loc, lam_loc, mesh)
    x, p = lam_loc, z
    eta = tot0[:, 0].to(WORK)
    g = torch.ones_like(eta)
    it = torch.zeros_like(eta, dtype=torch.int32)
    done = exit_test(tot0[:, 0], tot0[:, 1])
    for _ in range(math.ceil(max_iter / s)):
        fl = mesh.send_right(torch.stack([p[:, L - h:], z[:, L - h:]], 1))
        fr = mesh.send_left(torch.stack([p[:, :h], z[:, :h]], 1))
        Y, Yt, parts = _per_shard(bases, S_ext, P_ext, p, z, fl, fr, g, r)
        x, r, z, p, g, eta, it, done = _per_shard(
            step, mesh.psum(parts), g, eta, it, done, x, r, z, p, Y, Yt)
    return x, it, done


def _pcg_local_ca_slab(S_loc, Pinv_loc, gamma_loc, lam_loc, max_iter: int,
                       exit_tol, mesh, exit_criterion: str = "eta",
                       s_steps: int = 4, basis=ca_basis_cuda,
                       coeff=ca_coeff_step_cuda):
    """The s-step CG with each outer step's per-shard compute in K10b and the
    coefficient step: 2 sends, one K10b launch, 1 psum, one coefficient-step
    launch.  S_loc and Pinv_loc may be slabs of a larger tensor (K9a's
    output, read in place).  ``basis`` and ``coeff`` are the steps' wrappers
    (``ops/pcg_ca.py::ca_basis`` and ``ca_coeff_step`` drive the same loop
    with the plain steps on any device)."""
    s = s_steps
    h = 2 * s + 1
    SL, SR = _ca_halo_blocks(S_loc, h, mesh)
    PL, PR = _ca_halo_blocks(Pinv_loc, h, mesh)
    r0, z0, tot0 = _ca_init(S_loc, Pinv_loc, gamma_loc, lam_loc, mesh)
    st = ca_state(lam_loc, r0, z0, tot0, exit_tol, exit_criterion, s)
    for _ in range(math.ceil(max_iter / s)):
        fl = mesh.send_right(st["pkt"][:, 0])
        fr = mesh.send_left(st["pkt"][:, 1])
        basis(st, S_loc, Pinv_loc, SL, SR, PL, PR, fl, fr, max_iter, s)
        coeff(st, mesh.psum(st["parts"]), max_iter, exit_tol, exit_criterion, s)
    return st["x"], st["iters"], st["done"] != 0


_IMPLS = {"classic": _pcg_local, "pipelined": _pcg_local_pipelined,
          "pipelined_slab": _pcg_local_pipelined_slab, "ca": _pcg_local_ca,
          "ca_slab": _pcg_local_ca_slab}


def local_pcg(method: str, L: int, s_steps: int = 4):
    """The per-shard body of ``method`` for slabs of L knots, as the JAX
    package routes it: the s-step forms fall back to pipelined at
    L < 2 s_steps + 1 (their packets are 2s+1 rows deep), the pipelined
    forms to classic at L < 2."""
    if method not in _IMPLS:
        raise ValueError(f"unknown pcg method {method!r}")
    if s_steps < 1:
        raise ValueError(f"s_steps must be >= 1, got {s_steps}")
    if method.startswith("ca") and L < 2 * s_steps + 1:
        method = "pipelined"
    if method.startswith("pipelined") and L < 2:
        method = "classic"
    if method.startswith("ca"):
        return partial(_IMPLS[method], s_steps=s_steps)
    return _IMPLS[method]


def pcg_solve_sharded(S, Pinv, gamma, lam0, mesh, max_iter: int = 173,
                      exit_tol=1e-6, knot_axis: str = "knot",
                      exit_criterion: str = "eta", method: str = "pipelined",
                      s_steps: int = 4) -> PCGResult:
    """Solve S lam = gamma with the knot blocks split over ``mesh``'s shards.

    Shapes as in ``ops/pcg.py`` (full (N, ...) arrays, N divisible by the
    mesh's size; on a ``DistKnotMesh`` every process passes the full arrays
    and gets the full result).  method: "pipelined" (default),
    "pipelined_slab" (K10a on CUDA tensors), "classic", "ca" or "ca_slab"
    (the s-step forms with s = ``s_steps``; "ca_slab" through K10b and the
    coefficient step on CUDA tensors).  exit_tol may be a float or a 0-d
    tensor."""
    if knot_axis != "knot":
        raise ValueError(f"the knot meshes have one axis, 'knot'; got {knot_axis!r}")
    if exit_criterion not in ("eta", "rnorm"):
        raise ValueError(f"unknown exit_criterion {exit_criterion!r}")
    N = gamma.shape[0]
    if N % mesh.size:
        raise ValueError(f"N={N} not divisible by {mesh.size} knot shards")
    impl = local_pcg(method, N // mesh.size, s_steps)
    tol = _kernels.scalar(exit_tol, gamma.device, gamma.dtype)
    lam, iters, done = impl(mesh.scatter(S), mesh.scatter(Pinv),
                            mesh.scatter(gamma), mesh.scatter(lam0), max_iter,
                            tol, mesh, exit_criterion)
    return PCGResult(lam=mesh.gather(lam), iters=iters[0], converged=done[0])


def pcg_solve_two_slab(S, Pinv, gamma, lam0, max_iter: int = 173,
                       exit_tol=1e-6, exit_criterion: str = "eta") -> PCGResult:
    """``method="pipelined_slab"`` on two shards of one device: the port of
    the JAX package's single-device two-slab emulation (K10a with non-trivial
    neighbours on one card)."""
    if gamma.shape[0] % 2:
        raise ValueError("two-slab emulation needs even N")
    return pcg_solve_sharded(S, Pinv, gamma, lam0, KnotMesh(2), max_iter,
                             exit_tol, exit_criterion=exit_criterion,
                             method="pipelined_slab")
