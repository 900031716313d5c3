"""Check and time Viterbi kernel sources against each other on one GPU.

    python3 viterbi_bench.py [variant.cu ...]

Each source (first: ngsepcore_tpu_torch/csrc/viterbi.cu; a variant exports
the same `viterbi_launch` with the same scratch layout) is built alone with
the package's nvcc flags, held bit for bit (path and best score) against
the plain PyTorch loop, and timed at the read-depth callers' shape (S = 5,
T = 46,000: a 4.6 Mbp sequence in 100 bp bins) and at S = 32.  The package's
source is also built with each of its two ablation macros, which take the
backtrace, or the backtrace and the back-pointer stores, out of the
launch: the differences say where the kernel's time goes (only the best
score of an ablated build is checked).  All builds are timed in one process,
in rounds A B .. B A, so that two versions are compared on one card under
one power limit.  Prints ptxas' registers and spills, the median times with
the bound, and the card's name and power limit.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from chip_smoke import _poisson_hmm, _random_hmm, fail, nvidia_smi, viterbi_bound
from gotoh_bench import event_ms
from ngsepcore_tpu_torch.kernels import cuda_build
from ngsepcore_tpu_torch.kernels.hmm import back_pointer_scratch, viterbi_log_ref

ABLATIONS = ("VITERBI_SKIP_BACKTRACE", "VITERBI_SKIP_BACK_STORES")


def run(lib, args):
    """One launch of lib's viterbi_launch on one sequence: (path, best)."""
    start, trans, emit = args
    T, S = emit.shape
    back = back_pointer_scratch(T, S, emit.device)
    path = torch.empty(T, dtype=torch.int32, device=emit.device)
    best = torch.empty((), dtype=torch.float64, device=emit.device)
    rc = lib.viterbi_launch(
        start.data_ptr(), trans.data_ptr(), emit.data_ptr(), 1, T, S,
        int(trans.shape[0] != 1), back.data_ptr(), path.data_ptr(), best.data_ptr(),
        torch.cuda.current_stream().cuda_stream,
    )
    cuda_build.check("viterbi_log", rc)
    return path, best


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    print(nvidia_smi(), flush=True)
    package = cuda_build.CSRC / "viterbi.cu"
    builds = [(package, str(package), True)] + [
        (Path(a), a, True) for a in sys.argv[1:]]
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for macro in ABLATIONS:
        src = cuda_build.BUILD_DIR / f"viterbi_{macro.lower()}.cu"
        src.write_text(f"#define {macro}\n" + package.read_text())
        builds.append((src, f"{package} with {macro}", False))
    libs = []
    for src, label, whole in builds:
        lib, info = cuda_build.build([src], stem=f"libviterbi_{src.stem}")
        print(f"{label}: built in {info['seconds']:.1f}s", flush=True)
        for line in info["ptxas"].splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print("  ptxas:", line.strip(), flush=True)
        libs.append((label, lib, whole))

    rng = np.random.default_rng(0)
    to_dev = lambda arrays: [
        torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64)).cuda() for a in arrays]
    shapes = [
        ("Poisson S=5 T=46000", to_dev(_poisson_hmm(rng, 46_000))),
        ("random S=32 T=46000", to_dev(_random_hmm(rng, 46_000, 32))),
    ]
    checks = shapes + [
        (f"Poisson S=5 T={T}", to_dev(_poisson_hmm(rng, T))) for T in (1, 2, 8, 9, 10, 130)
    ] + [
        ("random S=8 T=1000", to_dev(_random_hmm(rng, 1000, 8))),
        ("random S=9 T=1000", to_dev(_random_hmm(rng, 1000, 9))),
        ("per-step S=5 T=3000", to_dev(_random_hmm(rng, 3000, 5, per_step=True))),
        ("per-step -inf S=32 T=300",
         to_dev(_random_hmm(rng, 300, 32, per_step=True, neg_inf=True))),
        ("-inf S=6 T=3000", to_dev(_random_hmm(rng, 3000, 6, neg_inf=True))),
        ("tie S=4 T=500", to_dev((np.zeros(4), np.zeros((1, 4, 4)), -np.ones((500, 4))))),
    ]
    for name, args in checks:
        want_path, want_best = viterbi_log_ref(*args)
        for label, lib, whole in libs:
            path, best = run(lib, args)
            torch.cuda.synchronize()
            bad = int((path != want_path).sum()) if whole else 0
            if bad or not bool(best.view(torch.int64) == want_best.view(torch.int64)):
                fail(f"{label} disagrees on {name}: {bad} path entries, best "
                     f"{float(best)!r} against {float(want_best)!r}")
    print(f"{len(checks)} cases x {len(libs)} builds: bit-exact", flush=True)

    order = list(range(len(libs)))
    order += order[::-1]
    for name, args in shapes:
        T, S = args[2].shape
        b_ms, b_by, t_bytes, t_chain = viterbi_bound(T, S)
        times = {i: [] for i in range(len(libs))}
        for _round in range(3):
            for i in order:
                fn = lambda: run(libs[i][1], args)
                fn()
                times[i].append(event_ms(fn, 20))
        for i, (label, _, _) in enumerate(libs):
            ms = np.median(times[i])
            print(f"{name} {label}: kernel {ms:.4f} ms (runs {min(times[i]):.4f}-"
                  f"{max(times[i]):.4f}); bound {b_ms:.4f} ms by {b_by} (chain "
                  f"{t_chain:.4f}, bytes {t_bytes:.6f}): {100 * b_ms / ms:.1f}%", flush=True)
    print(nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
