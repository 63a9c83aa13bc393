"""One pipelined (Chronopoulos-Gear) CG step on every knot shard's slab: the
plain version of K10a (``ops/pcg_slab_cuda.py``, ``csrc/pcg_slab.cu``).

Port of ``mpcgpu_tpu/ops/pcg_pallas.py::pcg_slab_step_pallas`` together with
the XLA work around it in ``mpcgpu_tpu/parallel/pcg_sharded.py::
_pcg_local_pipelined_slab`` (the CG scalars, the neighbours' residual rows
rebuilt from their packets, the off-slab rows u_{-1} and u_L), in the
kernel's order.  The state of a solve is a dict of tensors with a leading
shard axis, updated in place by every step:

  x, r, p, s, u, w   (n_shard, L, n)   iterate, residual, and the recurrence
                                        vectors (u = Pinv r, w = S u)
  pkt                (n_shard, 2, 6, n) the packets the shard sends next:
                                        [r, w, s] x [second, edge] rows, its
                                        last two rows, then its first two
  dots               (n_shard, 3)       this shard's r.u, w.u, r.r
  scal               (n_shard, 2)       eta and alpha of the last step taken
  iters              (n_shard,) int32   steps taken

A step reads the summed dots of the previous step (tot, the mesh's psum),
tests the exit (|eta| < tol, or r.r < tol^2 for "rnorm") and the cap, forms
beta = eta / eta_prev and alpha = eta / (d - beta eta / alpha_prev)
(alpha = eta / d at the first step), and a shard whose exit fired keeps its
state.  The init step runs with alpha = beta = 0 and touches no scalar.
"""

from __future__ import annotations

import torch


def block_mv(M, v):
    """Block products over leading axes: M (..., n, n), v (..., n)."""
    return torch.einsum("...ij,...j->...i", M, v)


def band_rows(M, prev, cur, nxt):
    """Rows of a block-tridiagonal product, (centre + left) + right: M
    (..., 3, n, n) the rows' blocks (k, k-1), (k, k), (k, k+1) and prev,
    cur, nxt (..., n) the vector's rows k-1, k, k+1."""
    return (block_mv(M[..., 1, :, :], cur) + block_mv(M[..., 0, :, :], prev)) \
        + block_mv(M[..., 2, :, :], nxt)


def slab_state(lam0, r0):
    """The state of a solve from lam0 with residual r0 (n_shard, L, n),
    ready for the init step: zero recurrence vectors, scalars (1, 1), and
    the packets of (r0, 0, 0) that the init step's neighbours read."""
    n_shard, L, n = r0.shape
    zero = torch.zeros_like(r0)
    st = dict(x=lam0.contiguous().clone(), r=r0.contiguous().clone(), p=zero,
              s=zero.clone(), u=zero.clone(), w=zero.clone(),
              pkt=r0.new_zeros((n_shard, 2, 6, n)), dots=r0.new_zeros((n_shard, 3)),
              scal=r0.new_ones((n_shard, 2)),
              iters=torch.zeros((n_shard,), dtype=torch.int32, device=r0.device))
    st["pkt"][:, 0, 0:2] = r0[:, -2:]
    st["pkt"][:, 1, 0:2] = r0[:, :2]
    return st


def exit_fired(tot, exit_tol, exit_criterion: str):
    """The exit test on summed dots tot (..., 3) = (eta, d, r.r)."""
    if exit_criterion == "rnorm":
        return tot[..., 2] < exit_tol * exit_tol
    return torch.abs(tot[..., 0]) < exit_tol


def pcg_slab_step(st: dict, S, Pinv, flp, frp, PinvL, PinvR, tot, max_iter: int,
                  exit_tol, exit_criterion: str = "eta", init: bool = False):
    """One step of every shard, in place on the state ``st`` (module
    docstring).  S, Pinv (n_shard, L, 3, n, n) the shards' rows of the
    system; flp, frp (n_shard, 6, n) the packets received from the left and
    the right neighbour; PinvL, PinvR (n_shard, 3, n, n) the neighbours'
    boundary Pinv rows; tot (n_shard, 3) the previous step's summed dots.
    exit_tol may be a float or a 0-d tensor."""
    x, r, p, s, u, w = (st[k] for k in ("x", "r", "p", "s", "u", "w"))
    if init:
        zero = torch.zeros_like(tot[:, 0])
        alpha, beta = zero, zero
        act = torch.ones_like(zero, dtype=torch.bool)
    else:
        eta, d = tot[:, 0], tot[:, 1]
        it = st["iters"]
        act = ~exit_fired(tot, exit_tol, exit_criterion) & (it < max_iter)
        first = it == 0
        eta_prev, alpha_prev = st["scal"][:, 0], st["scal"][:, 1]
        beta = torch.where(first, torch.zeros_like(eta), eta / eta_prev)
        alpha = eta / torch.where(first, d, d - beta * eta / alpha_prev)
    a, b = alpha[:, None, None], beta[:, None, None]
    p_n = u + b * p
    s_n = w + b * s
    x_n = x + a * p_n
    r_n = r - a * s_n
    # the neighbours' rows -2, -1 (left) and L, L+1 (right) after the step
    fl = flp[:, 0:2] - a * (flp[:, 2:4] + b * flp[:, 4:6])
    fr = frp[:, 0:2] - a * (frp[:, 2:4] + b * frp[:, 4:6])
    re = torch.cat([fl, r_n, fr], dim=1)                  # rows -2 .. L+1
    L = r.shape[1]
    u_n = band_rows(Pinv, re[:, 1:L + 1], r_n, re[:, 3:L + 3])
    u_m1 = band_rows(PinvL, re[:, 0], re[:, 1], re[:, 2])
    u_L = band_rows(PinvR, re[:, L + 1], re[:, L + 2], re[:, L + 3])
    ue = torch.cat([u_m1[:, None], u_n, u_L[:, None]], dim=1)  # rows -1 .. L
    w_n = band_rows(S, ue[:, :L], u_n, ue[:, 2:])
    dots = torch.stack([(r_n * u_n).sum((1, 2)), (w_n * u_n).sum((1, 2)),
                        (r_n * r_n).sum((1, 2))], dim=1)
    rows = lambda t, k: t[:, k:k + 2]
    pkt = torch.stack([torch.cat([rows(v, L - 2) for v in (r_n, w_n, s_n)], 1),
                       torch.cat([rows(v, 0) for v in (r_n, w_n, s_n)], 1)], 1)
    keep = act[:, None, None]
    for name, new in (("x", x_n), ("r", r_n), ("p", p_n), ("s", s_n),
                      ("u", u_n), ("w", w_n)):
        st[name].copy_(torch.where(keep, new, st[name]))
    st["pkt"].copy_(torch.where(act[:, None, None, None], pkt, st["pkt"]))
    st["dots"].copy_(torch.where(act[:, None], dots, st["dots"]))
    if not init:
        st["scal"].copy_(torch.where(act[:, None], torch.stack([eta, alpha], 1),
                                     st["scal"]))
        st["iters"].add_(act.to(st["iters"].dtype))
