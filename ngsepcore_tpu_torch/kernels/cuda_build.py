"""Build and bind the hand-written CUDA kernels of csrc/.

All `csrc/*.cu` sources compile with nvcc into ONE shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), loaded
with ctypes.  The build runs at first use into `ngsepcore_tpu_torch/_build/`,
keyed by a hash of the sources and flags, so a fresh checkout builds it on
its first CUDA call.  Nothing here runs at import time: CPU-only
installations import the package without nvcc.

Each C entry point launches on the stream it is given and returns
cudaGetLastError(); `check` turns a nonzero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: name -> argtypes (every entry returns int cudaError_t)
_SIGNATURES = {
    "gotoh_forward_launch": [
        _P, _P, _P, _P,  # query, qlen, subject, slen
        _P, _P, _P, _P,  # plane, score, end_j, start_k
        _I, _I, _I,  # B, Lq, Ls
        _I, _I, _I, _I,  # match, mismatch, open_gap, ext_gap
        _I, _I,  # free_start2, free_end2
        _P,  # stream
    ],
    "shear_hist_launch": [
        _P, _I, _I, _I,  # stage_t, S, w0s, window
        _I, _I,  # nq, lanes
        _P,  # out
        _P,  # stream
    ],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_info: dict = {}  # seconds, library path and ptxas report of the build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(CSRC.glob("*.cu"))
        digest = hashlib.sha256()
        for src in sources + sorted(CSRC.glob("*.cuh")):
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        so = BUILD_DIR / f"libngsep_kernels_{digest.hexdigest()[:16]}.so"
        t0 = time.perf_counter()
        report = ""
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
                )
            report = proc.stderr
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        build_info.update(
            seconds=time.perf_counter() - t0, path=str(so), ptxas=report
        )
        _lib = lib
        return lib


def check(name: str, rc: int) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError_t {rc}")
