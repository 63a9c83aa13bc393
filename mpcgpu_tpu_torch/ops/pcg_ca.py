"""The s-step (communication-avoiding) CG on every knot shard's slab: the
coefficient-space algebra and the plain versions of K10b (the basis and
Gram kernel) and of the coefficient step (``ops/pcg_ca_cuda.py``,
``csrc/pcg_ca.cu``).

Port of ``mpcgpu_tpu/ops/pcg_pallas.py::pcg_ca_basis_pallas`` and of the XLA
work around it in ``mpcgpu_tpu/parallel/pcg_sharded.py::_pcg_local_ca_slab``
(the helpers ``_ca_shift_matrix``, ``_ca_coeff_iters``, ``_ca_next_scale``
and the recovery), in the kernels' order.  One outer step of the solve
advances s CG iterations:

  * the basis (K10b): on the slab extended by h = 2s+1 knots per side, the
    monomial bases V = [p, (P^-1 S) p / g, ...] (s+1 vectors) and
    W = [z, ...] (s vectors), their exact S-images (the 1/g rides the P^-1
    step), Y = [V | W] and Ytil = S Y on the local knots, and the shard's
    Gram parts [G = Y.Ytil (m^2) | b = Y.r (m) | F = Ytil.Ytil (m^2) |
    f = Ytil.r (m) | r.r (1)], m = 2s+1;
  * the mesh's psum of the parts (outside: it is the collective);
  * the coefficient step: s masked exact-CG iterations in m dimensions from
    the summed parts (``ca_coeff_iters``), the recovery x += Y e,
    r -= Ytil e, z = Y c, p = Y a, the next basis scale
    (``ca_next_scale``), and the packets the shard sends next.

Both steps do the s-step algebra (the bases, their Gram parts, the
coefficient iterations and the recovery's sums) in f64 (``WORK``) whatever
the state's precision, and round only the state they write.  The JAX
package does it in f32 on the TPU, where the monomial basis loses the
relations v_{j+1} = (P^-1 S v_j) / g that the recurrences assume and an f32
solve drifts far from CG's (``csrc/pcg_ca.cu``); at f64 the two agree.

The state of a solve is a dict of tensors with a leading shard axis,
updated in place by every step:

  x, r, z, p   (n_shard, L, n)          iterate, residual, preconditioned
                                         residual, search direction
  pkt          (n_shard, 2, 2, h, n)    the packets the shard sends next:
                                         [its last h rows, its first h rows]
                                         x [p, z]
  Y, Yt        (n_shard, m, L, n) f64   the bases on the local knots
  parts        (n_shard, P) f64         the shard's Gram parts, P = 2m^2+2m+1
  scal         (n_shard, 2) f64         eta and the basis scale g
  iters, done  (n_shard,) int32         iterations taken, exit fired

A shard whose exit fired, or that reached the cap, skips both steps and
keeps its state.
"""

from __future__ import annotations

import torch

from mpcgpu_tpu_torch.ops.pcg_slab import band_rows

# The working precision of the s-step algebra in K10b and the coefficient
# step (the bases, their Gram parts, the coefficient iterations and the
# recovery's sums), whatever the state's: see the module docstring.
WORK = torch.float64


def n_parts(s: int) -> int:
    """The number of Gram parts of one shard, 2m^2 + 2m + 1 with m = 2s+1."""
    m = 2 * s + 1
    return 2 * m * m + 2 * m + 1


def ca_shift_matrix(s: int, dtype, device=None):
    """The coefficient-space image T of one P^-1 S application on the basis
    [v_0..v_s, w_0..w_{s-1}]: T e_{v_j} = e_{v_{j+1}}, T e_{w_j} = e_{w_{j+1}}
    (rows v_0, w_0 stay empty; the recurrences never leave the basis)."""
    m = 2 * s + 1
    T = torch.zeros((m, m), dtype=dtype, device=device)
    for j in range(s):
        T[j + 1, j] = 1
    for j in range(s - 1):
        T[s + 2 + j, s + 1 + j] = 1
    return T


def _mv(M, v):
    return torch.einsum("...ij,...j->...i", M, v)


def _dot(u, v):
    return (u * v).sum(-1)


def ca_coeff_iters(G, b, F, f, rr0, gT, eta, it, done, s: int, max_iter: int,
                   exit_test):
    """The s masked exact-CG iterations in (2s+1)-dim coefficient space, from
    the summed Gram parts G, F (..., m, m), b, f (..., m), rr0 (...), the
    scaled shift gT (..., m, m), eta (...), it (...) and done (...) bool.
    Each inner iteration runs where the exit has not fired and it < max_iter;
    the exit latches.  exit_test(eta, rr) -> bool tensor.  Returns (e, a, c,
    eta, it, done): the coefficients of x - x_0, p and z in Y."""
    e = G.new_zeros(G.shape[:-1])
    a = e.clone()
    a[..., 0] = 1                       # p = v_0
    c = e.clone()
    c[..., s + 1] = 1                   # z = w_0
    one = torch.ones_like(eta)
    for _ in range(s):
        act = ~done & (it < max_iter)
        denom = _dot(a, _mv(G, a))
        alpha = eta / torch.where(denom == 0, one, denom)
        e_n = e + alpha[..., None] * a
        c_n = c - alpha[..., None] * _mv(gT, a)
        eta_n = _dot(b, c_n) - _dot(e_n, _mv(G, c_n))
        rr_n = (rr0 - 2 * _dot(f, e_n)) + _dot(e_n, _mv(F, e_n))
        beta = eta_n / torch.where(eta == 0, one, eta)
        a_n = c_n + beta[..., None] * a
        done_n = exit_test(eta_n, rr_n)
        vec = act[..., None]
        e, c, a = (torch.where(vec, new, old) for new, old in
                   ((e_n, e), (c_n, c), (a_n, a)))
        eta = torch.where(act, eta_n, eta)
        it = it + act.to(it.dtype)
        done = done | (act & done_n)
    return e, a, c, eta, it, done


def ca_next_scale(G, g, s: int):
    """The next basis scale from the summed Gram G (..., m, m): the measured
    per-application growth of the scaled v-chain, g (|G[s,s]| / |G[0,0]|)^
    (1/2s), clipped to [1e-6, 1e6]; g where that is not finite."""
    den = torch.clamp(G[..., 0, 0].abs(), min=torch.finfo(G.dtype).tiny)
    g_n = torch.clamp(g * (G[..., s, s].abs() / den) ** (1.0 / (2 * s)), 1e-6, 1e6)
    return torch.where(torch.isfinite(g_n), g_n, g)


def split_parts(tot, s: int):
    """(G, b, F, f, rr0) from summed parts (..., P)."""
    m = 2 * s + 1
    mm = m * m
    return (tot[..., :mm].unflatten(-1, (m, m)), tot[..., mm:mm + m],
            tot[..., mm + m:2 * mm + m].unflatten(-1, (m, m)),
            tot[..., 2 * mm + m:2 * mm + 2 * m], tot[..., 2 * mm + 2 * m])


def gram_parts(Y, Yt, r):
    """The shard's parts [G | b | F | f | r.r] (n_shard, P) of its local
    bases Y, Yt (n_shard, m, L, n) and residual r (n_shard, L, n)."""
    G = torch.einsum("salk,sblk->sab", Y, Yt)
    b = torch.einsum("salk,slk->sa", Y, r)
    F = torch.einsum("salk,sblk->sab", Yt, Yt)
    f = torch.einsum("salk,slk->sa", Yt, r)
    rr = (r * r).sum((1, 2))
    return torch.cat([G.flatten(1), b, F.flatten(1), f, rr[:, None]], dim=1)


def matvec_ext(M_ext, x_ext):
    """Block-tridiagonal rows on an extended slab with zero (not ring) ends:
    M_ext (n_shard, Le, 3, n, n), x_ext (n_shard, Le, n).  The end knots are
    wrong by construction and the error moves one knot inward per
    application; the extension is deeper than the applications."""
    zero = torch.zeros_like(x_ext[:, :1])
    return band_rows(M_ext, torch.cat([zero, x_ext[:, :-1]], 1), x_ext,
                     torch.cat([x_ext[:, 1:], zero], 1))


def basis_chains(S_ext, P_ext, p_ext, z_ext, ginv, s: int):
    """The bases V, W and their S-images on the extended slab, each vector
    scaled by ginv (n_shard, 1, 1) at its P^-1 step.  Returns (V + W,
    Vt + Wt), lists of m tensors (n_shard, Le, n)."""
    V, Vt = [p_ext], []
    for _ in range(s):
        Vt.append(matvec_ext(S_ext, V[-1]))
        V.append(matvec_ext(P_ext, Vt[-1]) * ginv)
    Vt.append(matvec_ext(S_ext, V[-1]))
    W, Wt = [z_ext], []
    for _ in range(s - 1):
        Wt.append(matvec_ext(S_ext, W[-1]))
        W.append(matvec_ext(P_ext, Wt[-1]) * ginv)
    Wt.append(matvec_ext(S_ext, W[-1]))
    return V + W, Vt + Wt


def ca_state(lam0, r0, z0, tot0, exit_tol, exit_criterion: str, s: int):
    """The state of a solve from lam0 with residual r0 and z0 = Pinv r0
    (n_shard, L, n) and the summed init dots tot0 (n_shard, 2) = (r0.z0,
    r0.r0): p = z = z0, eta = r0.z0, g = 1, the exit tested once."""
    n_shard, L, n = r0.shape
    h = m = 2 * s + 1
    done = (tot0[:, 1] < exit_tol * exit_tol) if exit_criterion == "rnorm" \
        else (torch.abs(tot0[:, 0]) < exit_tol)
    wk = dict(dtype=WORK, device=r0.device)
    st = dict(x=lam0.contiguous().clone(), r=r0.contiguous().clone(),
              z=z0.contiguous().clone(), p=z0.contiguous().clone(),
              pkt=r0.new_empty((n_shard, 2, 2, h, n)),
              Y=torch.zeros((n_shard, m, L, n), **wk),
              Yt=torch.zeros((n_shard, m, L, n), **wk),
              parts=torch.zeros((n_shard, n_parts(s)), **wk),
              scal=torch.stack([tot0[:, 0], torch.ones_like(tot0[:, 0])], 1).to(WORK),
              iters=torch.zeros((n_shard,), dtype=torch.int32, device=r0.device),
              done=done.to(torch.int32))
    st["pkt"][:, 0] = torch.stack([z0[:, L - h:], z0[:, L - h:]], 1)
    st["pkt"][:, 1] = torch.stack([z0[:, :h], z0[:, :h]], 1)
    return st


def _running(st, max_iter: int):
    return (st["done"] == 0) & (st["iters"] < max_iter)


def ca_basis(st: dict, S, Pinv, SL, SR, PL, PR, fl, fr, max_iter: int,
             s: int) -> None:
    """K10b's plain version, in place on ``st``: S, Pinv (n_shard, L, 3, n,
    n) the shards' rows; SL, SR, PL, PR (n_shard, h, 3, n, n) the h rows of
    S and Pinv of the left and the right neighbour; fl, fr (n_shard, 2, h,
    n) the p and z packets received from the left and the right."""
    h = 2 * s + 1
    L = st["x"].shape[1]
    run = _running(st, max_iter)
    w = lambda *ts: torch.cat(ts, 1).to(WORK)
    S_ext, P_ext = w(SL, S, SR), w(PL, Pinv, PR)
    p_ext = w(fl[:, 0], st["p"], fr[:, 0])
    z_ext = w(fl[:, 1], st["z"], fr[:, 1])
    ginv = (1 / st["scal"][:, 1])[:, None, None]
    Ys, Yts = basis_chains(S_ext, P_ext, p_ext, z_ext, ginv, s)
    Y = torch.stack(Ys, 1)[:, :, h:h + L]
    Yt = torch.stack(Yts, 1)[:, :, h:h + L]
    parts = gram_parts(Y, Yt, st["r"].to(WORK))
    keep = run[:, None, None, None]
    st["Y"].copy_(torch.where(keep, Y, st["Y"]))
    st["Yt"].copy_(torch.where(keep, Yt, st["Yt"]))
    st["parts"].copy_(torch.where(run[:, None], parts, st["parts"]))


def ca_coeff_step(st: dict, tot, max_iter: int, exit_tol,
                  exit_criterion: str, s: int) -> None:
    """The coefficient step's plain version, in place on ``st``: tot
    (n_shard, P) the summed parts of this outer step."""
    h = 2 * s + 1
    L = st["x"].shape[1]
    run = _running(st, max_iter)
    G, b, F, f, rr0 = split_parts(tot, s)
    eta, g = st["scal"][:, 0], st["scal"][:, 1]

    def exit_test(eta_n, rr_n):
        if exit_criterion == "rnorm":
            return rr_n < exit_tol * exit_tol
        return torch.abs(eta_n) < exit_tol

    T = ca_shift_matrix(s, WORK, G.device)
    e, a, c, eta_n, it_n, done_n = ca_coeff_iters(
        G, b, F, f, rr0, g[:, None, None] * T, eta, st["iters"], st["done"] != 0,
        s, max_iter, exit_test)
    comb = lambda w, B: torch.einsum("sa,salk->slk", w, B)
    Y, Yt, dt = st["Y"], st["Yt"], st["x"].dtype
    new = dict(x=(st["x"] + comb(e, Y)).to(dt), r=(st["r"] - comb(e, Yt)).to(dt),
               z=comb(c, Y).to(dt), p=comb(a, Y).to(dt))
    pkt = torch.stack([torch.stack([new["p"][:, L - h:], new["z"][:, L - h:]], 1),
                       torch.stack([new["p"][:, :h], new["z"][:, :h]], 1)], 1)
    keep = run[:, None, None]
    for k, v in new.items():
        st[k].copy_(torch.where(keep, v, st[k]))
    st["pkt"].copy_(torch.where(run[:, None, None, None, None], pkt, st["pkt"]))
    scal = torch.stack([eta_n, ca_next_scale(G, g, s)], 1)
    st["scal"].copy_(torch.where(run[:, None], scal, st["scal"]))
    st["iters"].copy_(it_n)
    st["done"].copy_(done_n.to(torch.int32))

