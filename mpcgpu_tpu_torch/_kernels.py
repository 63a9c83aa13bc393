"""Build and bind the CUDA kernels of ``csrc/``.

The joint count is a compile-time value: each ``csrc/*.cu`` is compiled for
one nq (``-DMPC_NQ=<nq>``, csrc/common.cuh) by its own ``nvcc`` process (the
sources a call asks for all started together) into a shared library with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

under ``mpcgpu_tpu_torch/_build/<hash of all sources and flags>/nq<nq>/``
and loaded with ``ctypes``.  A library is built on first use, only for the
source and nq an entry asks for, and reused while the sources are unchanged.
A missing ``nvcc`` or a failed build raises; nothing falls back.

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
                                  I, I, I, P, P, P, P, P, P, P, P],
    },
    "pcg_dz.cu": {
        "pcg_dz_launch": [P, P, P, P, P, P, P, P, P, I, P, F,
                          I, P, I, I, I, I, I, P, P, P, P, P],
        "pcg_launch": [P, P, P, P, I, P, I, I, I, I, I, I, P, P, P, P],
        "pcg_cluster_occupancy": [I, I, I, I, P],
        "dz_launch": [P, P, P, P, P, P, I, I, P, F, I, I, P, P],
        "dz_slab_launch": [P, P, P, P, P, P, P, I, P, I, I, P, F, I, I, P, P],
        "dz_warp_launch": [P, P, P, P, P, P, P, I, P, I, I, P, F, I, I, I, I, I,
                           I, P, P],
        "dz_empty_launch": [I, I, I, I, I, P],
    },
    "merit.cu": {
        "merit_launch": [P, P, P, P, I, I, P, F, F, F, F, F,
                         I, I, I, I, I, I, I, I, I, P, P, P, P, P],
        "merit_partials_launch": [P, P, P, I, I, P, F, F, F, F, I, I, I, I, I,
                                  I, I, I, I, P, P, P],
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

# the joint counts the kernels are built for: the IIWA's 7 and the chains
# of the JAX package's tests and example scripts (2, 3, 5); csrc/kkt_schur.cu's
# knot group holds at most 15 teams of 6 lanes, one per tangent direction
# of the 2 nq, so 7 is also the most its lane mapping takes
NQ_DEFAULT = 7
NQ_MIN, NQ_MAX = 2, 7

_lock = threading.Lock()
_libs: dict[tuple[str, int], ctypes.CDLL] = {}
# nvcc's output (ptxas -v) per (source, nq) built by this process
build_log: dict[tuple[str, int], str] = {}


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


def require_nq(nq: int) -> None:
    """Raise unless the kernels are built for nq joints."""
    if not NQ_MIN <= nq <= NQ_MAX:
        raise ValueError(
            f"nq = {nq}: the CUDA kernels are built for {NQ_MIN} <= nq <= "
            f"{NQ_MAX} (K1's knot group holds one team of 6 lanes per tangent "
            "direction, at most 15); see ROADMAP.md queue 2, 'Kernels at any nq'")


def model_floats(nq: int) -> int:
    """MODEL_SIZE of csrc/common.cuh: the packed model of nq joints
    (RobotModel.packed(): 4 nq 6x6 and 3 nq 4x4 matrices)."""
    return 192 * nq


def build(targets) -> dict[tuple[str, int], Path]:
    """Compile every (source, nq) of ``targets`` that has no library yet,
    all nvcc processes started together; returns the paths."""
    targets = list(dict.fromkeys(targets))
    for src, nq in targets:
        if src not in _SIGNATURES:
            raise ValueError(f"unknown kernel source {src!r}")
        require_nq(nq)
    nvcc = find_nvcc()
    out_dir = _BUILD / source_hash()
    paths = {(src, nq): out_dir / f"nq{nq}" / (Path(src).stem + ".so")
             for src, nq in targets}
    procs = {}
    for (src, nq), lib in paths.items():
        if lib.is_file():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, f"-DMPC_NQ={nq}", "-I", str(_CSRC), "-o",
               str(tmp), str(_CSRC / src)]
        procs[src, nq] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True),
                          tmp, lib)
    failed = []
    for (src, nq), (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        build_log[src, nq] = out
        if proc.returncode != 0:
            failed.append(f"{src} at nq = {nq} (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(targets) -> dict[tuple[str, int], ctypes.CDLL]:
    """The libraries of the (source, nq) ``targets``, building the missing
    ones (in parallel) on first use."""
    targets = list(dict.fromkeys(targets))
    with _lock:
        missing = [t for t in targets if t not in _libs]
        if missing:
            for (src, nq), path in build(missing).items():
                lib = ctypes.CDLL(str(path))
                for name, argtypes in _SIGNATURES[src].items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _libs[src, nq] = lib
        return {t: _libs[t] for t in targets}


def libraries() -> dict[str, ctypes.CDLL]:
    """Every kernel library at nq = 7, keyed by source, building them on
    first use."""
    return {src: lib for (src, _), lib in
            load((s, NQ_DEFAULT) for s in SOURCES).items()}


def entry(src: str, name: str, nq: int):
    """The C entry point ``name`` of ``src`` built for nq joints (every
    wrapper passes its system's nq: no library is taken by default)."""
    return getattr(load([(src, nq)])[src, nq], name)


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def launch(device, src: str, name: str, nq: int, *args) -> None:
    """Call the C entry point ``name`` of ``src`` built for nq joints with
    ``args`` and the current stream of ``device``, with ``device`` the
    current card for the call, and raise on its error code.  An entry
    launches in the current device's context (kkt_schur.cu and merit.cu
    also size their grids from it), so a wrapper that launches here
    launches on its tensors' card whichever card its caller left current.
    The guard (``torch.cuda.device``, ~3.5 us of host time on an H100's
    host) is entered only when another card is current; a device that is
    not a card raises."""
    import torch

    fn = entry(src, name, nq)
    if torch.cuda.current_device() == device.index:
        check(fn(*args, stream_ptr(device)), name)
        return
    with torch.cuda.device(device):
        check(fn(*args, stream_ptr(device)), name)


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
