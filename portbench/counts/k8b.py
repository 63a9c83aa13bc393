"""K8b, the batched PCG (``csrc/pcg_dz.cu``, ``pcg_dz_kernel<false,
true>``, one cluster per instance): one call's operations and 4-byte
words for B instances.  Operations: the CG steps the instances took
(``steps`` = the sum over instances of their iterations + 1); words:
each instance's S, Pinv, gamma and lam0 read once, lam written once, the
exit flags."""

from portbench.counts._ops import pcg_iter_knot

KERNEL = "pcg_dz_kernel<false, true>"


def work(N: int, nq: int, B: int, steps: int):
    nx = 2 * nq
    pcg_in = N * (2 * 3 * nx * nx + nx + nx)
    return N * pcg_iter_knot(nq) * steps, B * (pcg_in + N * nx + 2)
