"""Build and bind the CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

under ``mpcgpu_tpu_torch/_build/<hash of all sources>/`` and loaded with
``ctypes``.  The build runs on first use and is reused while the sources are
unchanged.  A missing ``nvcc`` or a failed build raises; nothing falls back.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "_build"
SOURCES = ("kkt_schur.cu", "pcg_dz.cu", "merit.cu", "plant.cu", "pcr.cu",
           "pcg_slab.cu", "pcg_ca.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# argument types of each C entry point (see the csrc/*.cu signatures)
_SIGNATURES = {
    "kkt_schur.cu": {
        "kkt_schur_launch": [P, I, I, P, I, I, P, F, P, F, F, F,
                             I, I, I, I, I, I, I, P, P, P, P, P, P, P, P],
        "kkt_launch": [P, I, P, I, P, F, P, F, F, I, I, I, I, I, I,
                       P, P, P, P, P, P],
        "kkt_schur_slab_launch": [P, P, I, P, P, F, P, F, F, F, I, I, I, I,
                                  I, I, P, P, P, P, P, P, P, P],
    },
    "pcg_dz.cu": {
        "pcg_dz_launch": [P, P, P, P, P, P, P, P, P, I, P, F,
                          I, P, I, I, I, I, I, P, P, P, P, P],
        "pcg_launch": [P, P, P, P, I, P, I, I, I, I, I, I, P, P, P, P],
        "pcg_cluster_occupancy": [I, I, I, I, P],
        "dz_launch": [P, P, P, P, P, P, I, I, P, F, I, I, P, P],
        "dz_slab_launch": [P, P, P, P, P, P, P, I, P, I, I, P, F, I, I, P, P],
    },
    "merit.cu": {
        "merit_launch": [P, P, P, P, I, I, P, F, F, F, F, F,
                         I, I, I, I, I, I, I, I, P, P, P, P, P],
        "merit_partials_launch": [P, P, P, I, I, P, F, F, F, F, I, I, I, I, I,
                                  I, I, P, P, P],
    },
    "plant.cu": {
        "plant_launch": [P, I, P, I, I, I, P, P, P, F, I, P, F, P, I, P],
    },
    "pcr.cu": {
        "pcr_launch": [P, P, I, I, I, I, I, I, P, P, P],
        "pcr_coop_occupancy": [I, P],
    },
    "pcg_slab.cu": {
        "pcg_slab_launch": [P, P, P, P, P, P, P, P, I, P, P, P, P, P, I, P, P,
                            P, P, I, I, I, I, I, I, I, P, I, I, P],
    },
    "pcg_ca.cu": {
        "ca_basis_launch": [P, P, P, P, P, I, P, P, P, P, P, P, P, P, P, P, P,
                            P, I, I, I, I, I, I, I, I, I, P],
        "ca_coeff_launch": [P, P, P, P, P, P, P, I, P, P, P, P, I, I, I, I, I,
                            I, I, P, I, P],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] | None = None
build_log: dict[str, str] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
            or "/usr/local/cuda"
        cand = Path(home) / "bin" / "nvcc"
        nvcc = str(cand) if cand.is_file() else None
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME): the CUDA kernels of "
            "mpcgpu_tpu_torch cannot be built")
    return nvcc


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(_CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> dict[str, Path]:
    """Compile every source that has no library yet; returns the paths."""
    nvcc = find_nvcc()
    out_dir = _BUILD / source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {src: out_dir / (Path(src).stem + ".so") for src in SOURCES}
    procs = {}
    for src, lib in libs.items():
        if lib.is_file():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
               str(_CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, lib)
    failed = []
    for src, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        build_log[src] = out
        if proc.returncode != 0:
            failed.append(f"{src} (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


def libraries() -> dict[str, ctypes.CDLL]:
    """The loaded kernel libraries, building them on first use."""
    global _libs
    with _lock:
        if _libs is None:
            loaded = {}
            for src, path in build().items():
                lib = ctypes.CDLL(str(path))
                for name, argtypes in _SIGNATURES[src].items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                loaded[src] = lib
            _libs = loaded
        return _libs


def entry(src: str, name: str):
    return getattr(libraries()[src], name)


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


MAX_KNOTS = 512


def on_cpu(t) -> bool:
    """True for a CPU tensor (the wrapper then runs the plain version);
    False for a CUDA tensor; anything else raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {t.device}")


def require(t, name: str, shape: tuple, device, row_major: bool = False,
            slabs: bool = False, dtype=None):
    """Raise unless t is a CUDA tensor of `dtype` (default f32) on `device`
    of `shape` that the kernel can read: contiguous, or (row_major) rows of
    unit stride, or (slabs) each index of the leading axis a contiguous
    block, the blocks t.stride(0) elements apart."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}; the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if row_major:
        if t.dim() != 2 or t.stride(1) != 1:
            raise ValueError(f"{name}: rows must have unit stride")
    elif slabs:
        if not t[0].is_contiguous():
            raise ValueError(f"{name}: each slab must be contiguous")
    elif not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def require_knots(N: int) -> None:
    if not 2 <= N <= MAX_KNOTS:
        raise ValueError(f"N = {N} knots; the CUDA kernels take 2 <= N <= {MAX_KNOTS}")


def scalar(x, device, dtype=None):
    """A 0-d tensor on `device` of `dtype` (default f32); a tensor is moved
    and cast.  A Python number becomes a fill on the device, not a host-to-
    device copy, which would synchronize the stream."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).reshape(())
    return torch.full((), float(x), dtype=dtype, device=device)
