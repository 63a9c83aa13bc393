"""K8a, the batched KKT assembly and Schur condensation
(``csrc/kkt_schur.cu``, ``kkt_window_kernel<true>`` over instances): one
call's operations and 4-byte words for B instances.  Operations: B N
times the KKT blocks and the Schur block of a knot; words: each
instance's plan, goal and rho read once, S, Pinv, gamma, Qinv, A, B, q
written once, the packed model read once."""

from portbench.counts._ops import kkt_knot, model_floats, schur_knot

KERNEL = "kkt_window_kernel<true>"


def work(N: int, nq: int, B: int):
    nx, w = 2 * nq, 3 * nq
    nn = nx * nx
    k1_out = N * (2 * 3 * nn + nx + nn + nn + nx * nq + nx)
    flops = B * N * (kkt_knot(nq) + schur_knot(nq))
    return flops, B * (N * (w + 3) + 1 + k1_out) + model_floats(nq)
