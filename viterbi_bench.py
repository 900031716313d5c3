"""Check and time Viterbi kernel sources against each other on one GPU.

    python3 viterbi_bench.py [earlier.cu ...]

First the latency microbenchmark (chip_smoke.viterbi_latencies): the cycles
a link of each chain a step is built from (DADD, f64 fmax and the SASS
ptxas makes of it, a compare-select of a double with and without an int
beside it, an f64 shuffle, a shared-memory round trip), and the chain of
the shortest exact step that chip_smoke.py takes as the kernel's bound.

Then each source is built alone with the package's nvcc flags (all builds
at once): ngsepcore_tpu_torch/csrc/viterbi.cu as it is, with each ablation
macro (no backtrace; no back-pointer stores and no backtrace), and every
source named on the command line.  A source whose viterbi_launch takes offsets is driven
through the ragged entry (a batch of one); an earlier one through its own
(batch, T) entry, e.g. the first CUDA Viterbi kernel, of commit c00a5c1:

    git show c00a5c1:ngsepcore_tpu_torch/csrc/viterbi.cu > .chipcheck/viterbi_c00a5c1.cu
    python3 viterbi_bench.py .chipcheck/viterbi_c00a5c1.cu

Every whole build is held bit for bit (path and best score) against the
plain PyTorch loop on edge cases (T = 1 to 46,000, S = 1 to 32, per-step
and -inf transitions, ties, signed zeros; ragged batches for the ragged
entry); an ablated build only on its best score, and a source named on
the command line only on its path where the inputs are signed zeros (an
earlier kernel may keep the first maximum's -0.0 where the plain loop, as
the JAX package, gives +0.0).  All builds are timed in
one process at the read-depth callers' shape (S = 5, T = 46,000: a 4.6 Mbp
sequence in 100 bp bins) and at S = 32, in rounds A B .. B A, so that two
versions are compared on one card under one power limit.  Prints ptxas'
registers and spills, the median times, the ns and cycles (at 1.98 GHz) a
step, the measured chain bound and the share of it, the forward / stores /
backtrace split of the package's source, and the card's name and power
limit.
"""
from __future__ import annotations

import ctypes
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from chip_smoke import (
    SM_CLOCK_HZ, _poisson_hmm, _random_hmm, _signed_zero_hmm, fail, nvidia_smi, viterbi_bound,
    viterbi_chain_cycles, viterbi_latencies,
)
from gotoh_bench import event_ms
from ngsepcore_tpu_torch.kernels import cuda_build
from ngsepcore_tpu_torch.kernels.hmm import ragged_layout, viterbi_log_ref

VARIANTS = (("", "as it is"), ("#define VITERBI_SKIP_BACKTRACE\n", "without backtrace"),
            ("#define VITERBI_SKIP_BACK_STORES\n", "without stores and backtrace"))
_P, _I = ctypes.c_void_p, ctypes.c_int
EARLIER_SIGNATURE = [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P]
_LAYOUTS = {}  # (lengths, S) -> (offsets on the card, back-pointer words)


def run(build, start, trans, emit, lengths):
    """One launch of a build's viterbi_launch: (paths, best)."""
    lib, ragged = build["lib"], build["ragged"]
    S, n = emit.shape[1], len(lengths)
    dev = emit.device
    path = torch.empty(emit.shape[0], dtype=torch.int32, device=dev)
    best = torch.empty(n, dtype=torch.float64, device=dev)
    per_step = int(trans.shape[0] != n)
    stream = torch.cuda.current_stream().cuda_stream
    if ragged:
        key = (tuple(lengths), S)
        if key not in _LAYOUTS:
            layout = ragged_layout(lengths, S)
            _LAYOUTS[key] = (layout.to(dev), int(layout[1, -1]))
        offsets, n_words = _LAYOUTS[key]
        back = torch.empty(n_words, dtype=torch.int64, device=dev)
        rc = lib.viterbi_launch(start.data_ptr(), trans.data_ptr(), emit.data_ptr(),
                                offsets.data_ptr(), n, S, per_step, back.data_ptr(),
                                path.data_ptr(), best.data_ptr(), stream)
    else:  # (batch, T) entry: sequences of one T only
        T = lengths[0]
        if any(L != T for L in lengths):
            raise ValueError("the earlier entry takes sequences of one T")
        back = torch.empty((n * ((T + 6) // 8), S), dtype=torch.int64, device=dev)
        rc = lib.viterbi_launch(start.data_ptr(), trans.data_ptr(), emit.data_ptr(), n, T, S,
                                per_step, back.data_ptr(), path.data_ptr(), best.data_ptr(),
                                stream)
    cuda_build.check("viterbi_launch", rc)
    return path, best


def ptxas_lines(report: str) -> list:
    out, name = [], ""
    for line in report.splitlines():
        if "Compiling entry" in line:
            name = line.split("'")[1][:60] if "'" in line else line.strip()
        elif "registers" in line or "spill" in line:
            out.append(f"{name}: {line.strip()}")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = nvidia_smi()
    print(smi, flush=True)
    lat = viterbi_latencies()
    print(f"latencies, cycles a link ({smi}): " + ", ".join(
        f"{k} {lat[k]:.2f}" for k in ("dadd", "fmax", "select", "select_int", "shfl", "smem")),
        flush=True)
    print(f"  SASS of the fmax chain: {lat['fmax_ops']}", flush=True)
    print(f"  SASS of the compare-select chain: {lat['select_ops']}", flush=True)
    for S in (1, 2, 5, 8, 32):
        print(f"  chain of the shortest exact step, S={S}: "
              f"{viterbi_chain_cycles(lat, S):.2f} cycles ({smi})", flush=True)

    package = cuda_build.CSRC / "viterbi.cu"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = []
    for n, (prefix, label) in enumerate(VARIANTS):
        src = package
        if prefix:
            src = cuda_build.BUILD_DIR / f"viterbi_variant{n}.cu"
            src.write_text(prefix + package.read_text())
        sources.append((src, f"package ({label})", not prefix, False))
    sources += [(Path(a), a, True, True) for a in sys.argv[1:]]
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(
            lambda s: cuda_build.build([s[0]], stem=f"libviterbi_{s[0].stem}"), sources))
    builds = []
    for (src, label, whole, earlier), (lib, info) in zip(sources, built):
        ragged = "offsets" in src.read_text().split("extern \"C\" int viterbi_launch")[-1][:400]
        if not ragged:
            lib.viterbi_launch.argtypes = EARLIER_SIGNATURE
            lib.viterbi_launch.restype = ctypes.c_int
        print(f"{label}: built in {info['seconds']:.1f}s "
              f"({'ragged' if ragged else '(batch, T)'} entry)", flush=True)
        for line in ptxas_lines(info["ptxas"]):
            print("  ptxas:", line, flush=True)
        builds.append(dict(label=label, lib=lib, whole=whole, ragged=ragged, earlier=earlier))

    rng = np.random.default_rng(0)
    to_dev = lambda arrays: [
        torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64)).cuda() for a in arrays]
    shapes = [
        ("Poisson S=5 T=46000", to_dev(_poisson_hmm(rng, 46_000))),
        ("random S=32 T=46000", to_dev(_random_hmm(rng, 46_000, 32))),
    ]
    z = np.zeros
    checks = shapes + [
        (f"Poisson S=5 T={T}", to_dev(_poisson_hmm(rng, T))) for T in (1, 2, 8, 9, 10, 130, 600)
    ] + [(f"random S={S} T=1000", to_dev(_random_hmm(rng, 1000, S))) for S in range(1, 10)] + [
        ("random S=31 T=700", to_dev(_random_hmm(rng, 700, 31))),
        ("per-step S=5 T=3000", to_dev(_random_hmm(rng, 3000, 5, per_step=True))),
        ("per-step S=8 T=300", to_dev(_random_hmm(rng, 300, 8, per_step=True))),
        ("per-step -inf S=32 T=300",
         to_dev(_random_hmm(rng, 300, 32, per_step=True, neg_inf=True))),
        ("-inf S=6 T=3000", to_dev(_random_hmm(rng, 3000, 6, neg_inf=True))),
        ("tie S=4 T=500", to_dev((z(4), z((1, 4, 4)), -np.ones((500, 4))))),
        ("signed zeros S=3 T=40", to_dev(_signed_zero_hmm(rng, 40, 3))),
        ("signed zeros S=5 T=300", to_dev(_signed_zero_hmm(rng, 300, 5))),
    ]
    for name, (start, trans, emit) in checks:
        want_path, want_best = viterbi_log_ref(start, trans, emit)
        for b in builds:
            path, best = run(b, start[None], trans, emit, [emit.shape[0]])
            torch.cuda.synchronize()
            bad = int((path != want_path).sum()) if b["whole"] else 0
            if b["earlier"] and name.startswith("signed zeros"):
                best = want_best[None]
            if bad or not bool(best[0].view(torch.int64) == want_best.view(torch.int64)):
                fail(f"{b['label']} disagrees on {name}: {bad} path entries, best "
                     f"{float(best[0])!r} against {float(want_best)!r}")
    # ragged batches for the ragged entry: every sequence against its own loop
    for S, lengths in ((5, [1, 2, 33, 257, 1, 4000]), (32, [3, 1, 130]), (1, [7, 1, 2])):
        hmms = [_random_hmm(rng, T, S) for T in lengths]
        start, trans, emit = to_dev((np.stack([h[0] for h in hmms]),
                                     np.concatenate([h[1] for h in hmms]),
                                     np.concatenate([h[2] for h in hmms])))
        for b in builds:
            if not (b["ragged"] and b["whole"]):
                continue
            path, best = run(b, start, trans, emit, lengths)
            torch.cuda.synchronize()
            r0 = 0
            for k, (T, h) in enumerate(zip(lengths, hmms)):
                want_path, want_best = viterbi_log_ref(*to_dev(h))
                if not (torch.equal(path[r0 : r0 + T], want_path)
                        and bool(best[k].view(torch.int64) == want_best.view(torch.int64))):
                    fail(f"{b['label']} disagrees on ragged S={S} {lengths}, sequence {k}")
                r0 += T
    print(f"{len(checks)} cases x {len(builds)} builds and 3 ragged batches: bit-exact",
          flush=True)

    order = list(range(len(builds)))
    order += order[::-1]
    for name, (start, trans, emit) in shapes:
        T, S = emit.shape
        chain = viterbi_chain_cycles(lat, S)
        b_ms, b_by, t_bytes, t_chain = viterbi_bound(T, S, chain)
        times = {i: [] for i in order}
        for _round in range(3):
            for i in order:
                fn = lambda: run(builds[i], start[None], trans, emit, [T])
                fn()
                times[i].append(event_ms(fn, 20))
        med = {i: float(np.median(times[i])) for i in times}
        for i, b in enumerate(builds):
            ns = med[i] * 1e6 / T
            print(f"{name} {b['label']}: {med[i]:.4f} ms (runs {min(times[i]):.4f}-"
                  f"{max(times[i]):.4f}), {ns:.2f} ns = {ns * SM_CLOCK_HZ / 1e9:.1f} cycles a "
                  f"step; bound {b_ms:.4f} ms by {b_by} (chain {chain:.2f} cycles a step = "
                  f"{t_chain:.4f} ms, bytes {t_bytes:.6f}): {100 * b_ms / med[i]:.1f}% ({smi})",
                  flush=True)
        full, no_bt, fwd = med[0], med[1], med[2]
        print(f"{name} package split: forward {fwd:.4f} ms, back-pointer stores "
              f"{no_bt - fwd:.4f}, backtrace {full - no_bt:.4f} ({smi})", flush=True)
    print(nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
