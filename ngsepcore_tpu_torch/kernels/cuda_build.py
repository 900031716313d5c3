"""Build and bind the hand-written CUDA kernels of csrc/.

All `csrc/*.cu` sources compile with nvcc, one process a source, all
started together, and link into ONE shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), loaded with
ctypes.  The build runs at first use into `ngsepcore_tpu_torch/_build/`,
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: name -> argtypes (every entry returns int cudaError_t)
_SIGNATURES = {
    "gotoh_forward_launch": [
        _P, _P, _P, _P,  # query, qlen, subject, slen
        _P, _P, _P, _P, _P,  # plane, score, end_i, end_j, start_k
        _I, _I, _I,  # B, Lq, Ls
        _I, _I, _I, _I,  # match, mismatch, open_gap, ext_gap
        _I, _I, _I, _I,  # free_start1, free_end1, free_start2, free_end2
        _I,  # kernel: 0 by shape, 1 seg, 2 wide, 3 | blocks << 8 cluster
        _P,  # scratch of the wide kernel
        _P,  # stream
    ],
    "gotoh_cluster_occupancy": [
        _I, _I, _I,  # blocks a cluster, warps a block, columns a lane
        _I, _I,  # free_start1, free_end1
        _P,  # out: clusters held at once
    ],
    "shear_hist_launch": [
        _P, _I, _I, _I,  # stage_t, S, w0s, window
        _I, _I,  # nq, lanes
        _P,  # out
        _P,  # stream
    ],
    "viterbi_launch": [
        _P, _P, _P,  # log_start, log_trans, log_emit
        _P,  # offsets (hmm.ragged_layout)
        _I, _I, _I,  # n_seq, S, per_step
        _P, _P, _P,  # back, path, best
        _P,  # stream
    ],
    "forward_backward_launch": [
        _P, _P, _P,  # log_start, log_trans, log_emit
        _I, _I, _I, _I, _I,  # n, T, S, per_step, samples a block
        _P, _P,  # post, ll
        _P,  # stream
    ],
    "fb_prepare_launch": [
        _P, _P, _P,  # log_start, log_trans, log_emit
        _I, _I, _I, _I,  # n, T, S, matrices
        _P, _P, _P, _P,  # P, gmax, scaled emissions, stats
        _P,  # stream
    ],
    "fb_product_launch": [
        _P, _P, _P, _P, _P,  # log_start, P, gmax, scaled emissions, log_emit
        _I, _I, _I, _I, _I,  # n, T, S, per_step, m8 tiles a block
        _P, _P,  # post, ll
        _P,  # stream
    ],
    "run_walk_launch": [
        _P, _P, _P, _P,  # plane, end_i, end_j, start_k
        _P, _P, _P,  # score, query, subject
        _I, _I, _I, _I, _I, _I,  # B, Lq, Ls, R, free_start2, mode
        _P, _P, _P, _P, _P, _P,  # rop, rlen, n_runs, n_ops, start_j, walk_ok
        _P, _P, _P, _P,  # mism, rle, has_gap, la_fallback
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


def build(sources: list[Path], stem: str = "libngsep_kernels") -> tuple[ctypes.CDLL, dict]:
    """Compile `sources` into one shared library under BUILD_DIR (skipped
    when a library of the same sources and flags is there), load it and
    declare the entry points of _SIGNATURES it exports.  Returns the
    library and {seconds, path, ptxas}."""
    digest = hashlib.sha256()
    for src in list(sources) + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"{stem}_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    report = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
        procs = [
            subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for src, obj in zip(sources, objs)
        ]
        try:
            outs = [p.communicate() for p in procs]
            for p, (out, err) in zip(procs, outs):
                if p.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({p.returncode}):\n{out}\n{err}")
            link = subprocess.run(
                [_nvcc(), "-shared", *NVCC_FLAGS[:2], "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True,
            )
            if link.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}"
                )
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
        report = "".join(err for _, err in outs)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib, dict(seconds=time.perf_counter() - t0, path=str(so), ptxas=report)


def library() -> ctypes.CDLL:
    """The loaded kernel library of csrc/*.cu, building it first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib, info = build(sorted(CSRC.glob("*.cu")))
            for name in _SIGNATURES:
                getattr(lib, name)  # every kernel of the package is there
            build_info.update(info)
            _lib = lib
        return _lib


def check(name: str, rc: int) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError_t {rc}")
