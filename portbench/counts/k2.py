"""K2, the single instance's PCG and dz recovery (``csrc/pcg_dz.cu``,
``pcg_dz_kernel<true, false>``): one call's operations and 4-byte words.
Operations: the CG iterations the solve took plus the initial residual,
and the dz recovery; words: S, Pinv, gamma, lam0 and dz's inputs (Qinv,
A, B, q, u) read once, lam and dz written once, the exit flags."""

from portbench.counts._ops import dz_knot, pcg_iter_knot

KERNEL = "pcg_dz_kernel<true, false>"


def work(N: int, nq: int, iters: int):
    nx, w = 2 * nq, 3 * nq
    nn = nx * nx
    pcg_in = N * (2 * 3 * nn + nx + nx)
    dz_in = N * (nn + nn + nx * nq + nx + nq)
    flops = N * (pcg_iter_knot(nq) * (iters + 1) + dz_knot(nq))
    return flops, pcg_in + dz_in + 1 + N * (nx + w) + 2
