"""Operation and byte counts shared by the kernels' counts, frozen from the
port's bring-up gate (``chip_smoke.py``, ``kernel_bounds`` and
``batched_bounds``) as it stood when the benchmark was defined.

Operation counts are per knot or per iteration of the algorithm, counted
from its products, for a chain of nq links (nx = 2 nq):

  * mv6 (6x6 by 6) 72, a 6x6 product 432, mm4 128 FLOP;
  * rnea_dual: per link 4 mv6 forward, 3 more for I v, I a and their
    tangents, 3 crf products (~30 each), 2 mv6t backward: ~780 per link;
  * aba: per link 2 mv6 + crf forward, Ia and two 6x6 products backward
    (nq - 1 links), one mv6 in the last pass;
  * fk: nq - 1 mm4 and nq affine 4x4 transforms;
  * the KKT blocks per knot: 2 nq + 1 rnea_dual (bias + 2 nq tangents),
    CRBA (nq - 1 pairs of 6x6 products), Gauss-Jordan nq x 2 nq, M^-1 dID
    (nq x nq x nx), FK with nq tangents;
  * the Schur block per knot: A Qinv and T (2 nx^3 + nx^2 nq 2), the
    block's Gauss-Jordan nx x 2 nx and the stair bands (4 nx^3 2);
  * PCG per iteration and knot: two block-tridiagonal matvecs (2 x 3 x nx^2
    x 2), two dots and three axpys over nx; the dz recovery ~1000 per
    knot at nq = 7, scaled by 2 nx^2 + nx nq.

Bytes: each input read once and each output written once, 4 bytes a
float.  The least time is the larger of operations over the f32 peak and
bytes over the memory rate.
"""

from __future__ import annotations

MV6, M66, MM4 = 72, 432, 128


def rnea_dual(nq: int) -> int:
    return nq * (7 * MV6 + 3 * 30 + 2 * MV6)


def aba(nq: int) -> int:
    return nq * (2 * MV6 + 30) + (nq - 1) * (72 + 2 * M66 + 2 * MV6) + nq * MV6


def fk(nq: int) -> int:
    return (nq - 1) * MM4 + nq * 48


def kkt_knot(nq: int) -> int:
    nx = 2 * nq
    return ((2 * nq + 1) * rnea_dual(nq) + (nq - 1) * 2 * M66
            + 2 * (nq * nq * nx * 2) + nq * fk(nq))


def schur_knot(nq: int) -> int:
    nx = 2 * nq
    return 2 * nx ** 3 * 2 + nx * nx * nq * 2 + nx * nx * 2 * nx * 2 + 4 * nx ** 3 * 2


def pcg_iter_knot(nq: int) -> int:
    nx = 2 * nq
    return 2 * 3 * nx * nx * 2 + 2 * 2 * nx + 3 * 2 * nx


def dz_knot(nq: int) -> float:
    nx = 2 * nq
    return 1000 * (2 * nx * nx + nx * nq) / 490


def model_floats(nq: int) -> int:
    """The packed model the kernels read: 4 nq 6x6 and 3 nq 4x4 matrices."""
    return 192 * nq


def least_s(flops: float, floats: float, peaks: dict) -> float:
    """The least time (s) for ``flops`` operations on ``floats`` 4-byte
    words at the card's peaks (``peaks.json``)."""
    return max(flops / peaks["f32_flops_per_s"], 4 * floats / peaks["bytes_per_s"])
