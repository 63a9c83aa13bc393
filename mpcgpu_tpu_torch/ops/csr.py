"""CSC packing of the block-tridiagonal Schur matrix for the sparse LDL^T.

Port of ``mpcgpu_tpu/ops/csr.py`` (numpy, as there): the reference's CSR
utilities (include/utils/csr.cuh:10-74: ``prep_csr`` builds the sparsity
pattern once, ``store_block_csr_lowertri`` scatters blocks into value order)
feed qdldl, which consumes the UPPER triangle in CSC form == the lower
triangle in CSR form.

The lower triangle by columns of the symmetric BTD matrix: column j in
block-column k holds the diagonal block's rows j..(k+1)n-1 followed by the
sub-diagonal block phi_{k+1}'s column.  nnz = (N-1) n^2 + N n(n+1)/2
(qdldl/sqp.cuh:148).
"""

from __future__ import annotations

import numpy as np


def btd_lower_csc_pattern(n: int, N: int):
    """(col_ptr (N*n+1,), row_ind (nnz,)) of the BTD lower triangle."""
    col_ptr = [0]
    row_ind = []
    for k in range(N):
        for j in range(n):
            col = k * n + j
            # diagonal block rows j..n-1
            row_ind.extend(range(col, k * n + n))
            # sub-diagonal block (k+1, k): all n rows
            if k < N - 1:
                row_ind.extend(range((k + 1) * n, (k + 2) * n))
            col_ptr.append(len(row_ind))
    return np.asarray(col_ptr, np.int32), np.asarray(row_ind, np.int32)


def btd_lower_csc_values(S) -> np.ndarray:
    """Pack BTD (N,3,n,n) values into the pattern's value order."""
    S = np.asarray(S)
    N, _, n, _ = S.shape
    vals = []
    for k in range(N):
        for j in range(n):
            vals.extend(S[k, 1, j:, j])          # diag block column, lower part
            if k < N - 1:
                vals.extend(S[k + 1, 0, :, j])   # sub-diagonal block column
    return np.asarray(vals, S.dtype)


def btd_nnz_lower(n: int, N: int) -> int:
    return (N - 1) * n * n + N * (n * (n + 1) // 2)


def btd_upper_csc_pattern(n: int, N: int):
    """(col_ptr, row_ind) of the BTD UPPER triangle in CSC order — the
    orientation qdldl consumes (upper CSC == the reference's lower CSR,
    csr.cuh:40-74).  Column col = k*n + j holds the super-diagonal block
    phi_k^T's column (all n rows of block (k-1, k)) followed by the diagonal
    block's rows 0..j."""
    col_ptr = [0]
    row_ind = []
    for k in range(N):
        for j in range(n):
            col = k * n + j
            if k > 0:
                row_ind.extend(range((k - 1) * n, k * n))
            row_ind.extend(range(k * n, col + 1))
            col_ptr.append(len(row_ind))
    return np.asarray(col_ptr, np.int64), np.asarray(row_ind, np.int64)


def btd_upper_csc_values(S) -> np.ndarray:
    """Pack BTD (N,3,n,n) values into btd_upper_csc_pattern's value order.

    Block (k-1, k) of the symmetric S is S[k-1, 2] (= phi_k^T); its column j
    contributes rows (k-1)*n..k*n-1 of matrix column k*n+j."""
    S = np.asarray(S)
    N, _, n, _ = S.shape
    vals = []
    for k in range(N):
        for j in range(n):
            if k > 0:
                vals.extend(S[k - 1, 2][:, j])
            vals.extend(S[k, 1][: j + 1, j])
    return np.asarray(vals, S.dtype)
