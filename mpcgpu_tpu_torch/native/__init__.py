"""The host's direct solvers of the Schur system, in C++ through ctypes.

Port of ``mpcgpu_tpu/native/__init__.py`` with its own copies of the C++
sources (``btd_ldl.cpp``, ``sparse_ldl.cpp``, the same code and the same C
signatures):

  * ``SparseLDL`` — elimination-tree sparse LDL^T with a cached symbolic
    factorization (QDLDL_etree / QDLDL_factor / QDLDL_solve, the reference's
    host-side direct solver, include/qdldl/sqp.cuh:22-49);
  * ``qdldl_solve_schur`` / ``qdldl_solve_schur_cached`` — one BTD Schur
    solve through it (the cached form keeps the symbolic pass per (n, N));
  * ``btd_ldl_solve_cpu`` — the block LDL^T of the BTD structure.

The libraries are built on first use with ``g++ -O3 -march=native -shared
-fPIC`` (the JAX package's flags, so that both compile the same code the
same way) into ``mpcgpu_tpu_torch/_build/<hash of sources and flags>/``.  A
missing compiler or a failed build raises.  Everything here is numpy f64 on
the host.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from mpcgpu_tpu_torch.ops.csr import btd_upper_csc_pattern, btd_upper_csc_values

_DIR = Path(__file__).resolve().parent
_BUILD = _DIR.parent / "_build"
SOURCES = ("btd_ldl.cpp", "sparse_ldl.cpp")
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

# argument types of each C entry point (see the .cpp signatures)
_SIGNATURES = {
    "btd_ldl.cpp": {
        "btd_ldl_solve": (ctypes.c_int, [ctypes.c_int, ctypes.c_int,
                                         _f64p, _f64p, _f64p, _f64p]),
    },
    "sparse_ldl.cpp": {
        "sldl_etree": (ctypes.c_int64, [ctypes.c_int64, _i64p, _i64p, _i64p,
                                        _i64p, _i64p]),
        "sldl_factor": (ctypes.c_int64, [ctypes.c_int64, _i64p, _i64p, _f64p,
                                         _i64p, _i64p, _f64p, _f64p, _f64p,
                                         _i64p, _i64p, _i64p, _i64p, _f64p]),
        "sldl_solve": (None, [ctypes.c_int64, _i64p, _i64p, _f64p, _f64p,
                              _f64p]),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] | None = None


def source_hash() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.encode())
        h.update((_DIR / src).read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> dict[str, Path]:
    """Compile every source that has no library yet; returns the paths."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the host LDL solvers of "
                           "mpcgpu_tpu_torch.native cannot be built")
    out_dir = _BUILD / f"native-{source_hash()}"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {src: out_dir / f"lib{Path(src).stem}.so" for src in SOURCES}
    for src, lib in libs.items():
        if lib.is_file():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        out = subprocess.run([gxx, *GXX_FLAGS, str(_DIR / src), "-o", str(tmp)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed for {src} (exit {out.returncode}):\n"
                               f"{out.stdout}{out.stderr}")
        os.replace(tmp, lib)
    return libs


def libraries() -> dict[str, ctypes.CDLL]:
    """The loaded libraries, building them on first use."""
    global _libs
    with _lock:
        if _libs is None:
            loaded = {}
            for src, path in build().items():
                lib = ctypes.CDLL(str(path))
                for name, (restype, argtypes) in _SIGNATURES[src].items():
                    fn = getattr(lib, name)
                    fn.restype = restype
                    fn.argtypes = argtypes
                loaded[src] = lib
            _libs = loaded
        return _libs


def btd_ldl_solve_cpu(S: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Solve S x = b on the host for a BTD matrix in (N, 3, n, n) layout, by
    the block LDL^T in f64."""
    S = np.asarray(S, np.float64)
    b = np.ascontiguousarray(np.asarray(b, np.float64))
    N, _, n, _ = S.shape
    theta = np.ascontiguousarray(S[:, 1])
    phi = np.ascontiguousarray(S[1:, 0]) if N > 1 else np.zeros((0, n, n))
    x = np.zeros((N, n), np.float64)
    rc = libraries()["btd_ldl.cpp"].btd_ldl_solve(n, N, theta, phi, b, x)
    if rc != 0:
        raise RuntimeError("btd_ldl_solve: singular diagonal block")
    return x


class SparseLDL:
    """Elimination-tree sparse LDL^T with a cached symbolic factorization:
    pattern prepped once (prep_csr, qdldl/sqp.cuh:164-166), numeric factor
    and solve per SQP iteration (:193, :271).

    Consumes upper-triangular CSC (``ops/csr.py::btd_upper_csc_pattern``
    orientation): per column, ascending row indices with the diagonal
    present and last.
    """

    def __init__(self, col_ptr: np.ndarray, row_ind: np.ndarray):
        self.Ap = np.ascontiguousarray(col_ptr, np.int64)
        self.Ai = np.ascontiguousarray(row_ind, np.int64)
        self.n = n = len(self.Ap) - 1
        self._lib = libraries()["sparse_ldl.cpp"]
        self.Lnz = np.zeros(n, np.int64)
        self.etree = np.zeros(n, np.int64)
        nnz_l = self._lib.sldl_etree(n, self.Ap, self.Ai, np.zeros(n, np.int64),
                                     self.Lnz, self.etree)
        if nnz_l < 0:
            raise ValueError("pattern is not upper-triangular CSC with diagonal")
        self.nnz_l = int(nnz_l)
        self.Lp = np.zeros(n + 1, np.int64)
        self.Li = np.zeros(self.nnz_l, np.int64)
        self.Lx = np.zeros(self.nnz_l, np.float64)
        self.D = np.zeros(n, np.float64)
        self.Dinv = np.zeros(n, np.float64)
        self._iwork = np.zeros(3 * n, np.int64)
        self._bwork = np.zeros(n, np.int64)
        self._fwork = np.zeros(n, np.float64)

    def factor(self, values: np.ndarray) -> int:
        """Numeric factorization; returns the count of positive pivots."""
        vals = np.ascontiguousarray(values, np.float64)
        rc = self._lib.sldl_factor(
            self.n, self.Ap, self.Ai, vals, self.Lp, self.Li, self.Lx,
            self.D, self.Dinv, self.Lnz, self.etree, self._iwork,
            self._bwork, self._fwork)
        if rc < 0:
            raise RuntimeError("sparse LDL^T: zero pivot")
        return int(rc)

    def solve(self, b: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(b, np.float64).copy()
        self._lib.sldl_solve(self.n, self.Lp, self.Li, self.Lx, self.Dinv, x)
        return x


def _solve_with(fac: SparseLDL, S: np.ndarray, gamma) -> np.ndarray:
    N, _, n, _ = S.shape
    fac.factor(btd_upper_csc_values(S))
    return fac.solve(np.asarray(gamma, np.float64).reshape(N * n)).reshape(N, n)


def qdldl_solve_schur(S: np.ndarray, gamma: np.ndarray) -> np.ndarray:
    """One direct solve of the BTD Schur system through the sparse LDL^T
    (qdldl_solve_schur, qdldl/sqp.cuh:22-49).  S (N,3,n,n), gamma (N,n);
    returns lambda (N,n) in f64."""
    S = np.asarray(S, np.float64)
    N, _, n, _ = S.shape
    return _solve_with(SparseLDL(*btd_upper_csc_pattern(n, N)), S, gamma)


_SLDL_CACHE: dict = {}


def qdldl_solve_schur_cached(S: np.ndarray, gamma: np.ndarray) -> np.ndarray:
    """qdldl_solve_schur with the symbolic factorization cached per (n, N),
    as the reference uses it: the host end of ``linsys="qdldl_host"``."""
    S = np.asarray(S, np.float64)
    N, _, n, _ = S.shape
    fac = _SLDL_CACHE.get((n, N))
    if fac is None:
        fac = _SLDL_CACHE[(n, N)] = SparseLDL(*btd_upper_csc_pattern(n, N))
    return _solve_with(fac, S, gamma)
