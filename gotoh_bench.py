"""Check and time Gotoh-forward kernel sources against each other on one GPU.

    python3 gotoh_bench.py [variant.cu ...]

Each source (default: ngsepcore_tpu_torch/csrc/gotoh_forward.cu; a variant
exports the same `gotoh_forward_launch`, for example an earlier commit's
copy of the file) is built alone with the package's nvcc flags, held bit
for bit against the plain PyTorch version on ragged inputs in the five
free-end configurations (free subject ends for tier 3, free query ends for
the tier-2 STR flanks), by shape and with kernel code 1 forced at the narrow
widths, and timed by shape at the widths the fused and classic tier-3
paths, the tier-2 flanks and the long-read segments use.  All sources are
timed in one process, in rounds A B .. B A, so that two versions are
compared on one card under one power limit: 20 back-to-back calls timed
with CUDA events, and the same 20 calls in one CUDA graph.  Prints ptxas'
registers and spills, the median times with their bounds, and the card's
name and power limit.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from chip_smoke import (
    TIER2_LEFT,
    TIER2_RIGHT,
    LONG_READ_CFGS,
    _GOTOH_CFGS,
    _bench_chunk,
    _classic_chunk,
    _gotoh_mismatches,
    _long_read_chunk,
    _noisy,
    _tier2_chunk,
    fail,
    gotoh_bound,
    graph_ms,
    nvidia_smi,
)
from ngsepcore_tpu_torch.kernels import cuda_build
from ngsepcore_tpu_torch.kernels.pairwise_cuda import (
    WIDE_FIELDS,
    gotoh_forward_plane_ref,
    wide_layout,
)


def run(lib, args, cfg, kernel=0):
    """One launch of lib's gotoh_forward_launch (`kernel` 0: by shape, 1:
    the source's second kernel): (plane, score, end_i, end_j, start_k).
    Subjects wider than 1,024 columns get the wide kernel's scratch, which
    sources that launch another kernel there ignore."""
    q, ql, s, sl = args
    B, Lq = q.shape
    Ls = s.shape[1]
    plane = torch.empty((Lq, B, Ls), dtype=torch.int32, device=q.device)
    fin = torch.empty((4, B), dtype=torch.int32, device=q.device)
    scratch = None
    if Ls > 1024:
        C, threads = wide_layout(Ls)
        scratch = torch.empty(B * WIDE_FIELDS * C * threads, dtype=torch.int32,
                              device=q.device)
    rc = lib.gotoh_forward_launch(
        q.data_ptr(), ql.data_ptr(), s.data_ptr(), sl.data_ptr(),
        plane.data_ptr(), *(f.data_ptr() for f in fin),
        B, Lq, Ls, 1, 1, 3, 1,
        int(cfg.get("free_start1", False)), int(cfg.get("free_end1", False)),
        int(cfg.get("free_start2", True)), int(cfg.get("free_end2", True)),
        kernel, None if scratch is None else scratch.data_ptr(),
        torch.cuda.current_stream().cuda_stream,
    )
    cuda_build.check("gotoh_forward", rc)
    # the kernels write end_i only with a free query end; else it is qlen
    return plane, fin[0], fin[1] if cfg.get("free_end1") else ql, fin[2], fin[3]


def event_ms(fn, reps):
    """CUDA-event time of `reps` back-to-back calls, per call."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    print(nvidia_smi(), flush=True)
    sources = [Path(a) for a in sys.argv[1:]] or [cuda_build.CSRC / "gotoh_forward.cu"]
    libs = []
    for n, src in enumerate(sources):
        lib, info = cuda_build.build([src], stem=f"libgotoh_{n}_{src.stem}")
        print(f"{src}: built in {info['seconds']:.1f}s", flush=True)
        for line in info["ptxas"].splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print("  ptxas:", line.strip(), flush=True)
        libs.append((str(src), lib))

    rng = np.random.default_rng(0)
    to_dev = lambda data: [torch.from_numpy(a).cuda() for a in data]
    checks = [(f"ragged {cfg}", to_dev(_noisy(rng, 301, 64, Ls)), cfg)
              for Ls in (33, 160, 200, 256, 288, 512, 1664) for cfg in _GOTOH_CFGS]
    shapes = [
        ("2048x192x192", to_dev(_classic_chunk(rng, 2048)), {}),
        ("2048x160x160", to_dev(_bench_chunk(rng, 2048, 160, 160)), {}),
        ("2048x160x256", to_dev(_bench_chunk(rng, 2048, 160, 256)), {}),
        ("256x192x192", to_dev(_classic_chunk(rng, 256)), {}),
        ("256x160x224 tier-2 left", to_dev(_tier2_chunk(rng, 256, "left")), TIER2_LEFT),
        ("256x160x224 tier-2 right", to_dev(_tier2_chunk(rng, 256, "right")), TIER2_RIGHT),
        # the known-STR path's full chunks and its flanks over a ~1,500 bp
        # STR, wider than 256 columns
        ("256x160x384 tier-2 left", to_dev(_tier2_chunk(rng, 256, "left", 160, 384)),
         TIER2_LEFT),
        ("256x160x352 tier-2 right", to_dev(_tier2_chunk(rng, 256, "right", 160, 352)),
         TIER2_RIGHT),
        ("256x160x1664 tier-2 left", to_dev(_tier2_chunk(rng, 256, "left", 160, 1664)),
         TIER2_LEFT),
        ("256x160x1664 tier-2 right", to_dev(_tier2_chunk(rng, 256, "right", 160, 1664)),
         TIER2_RIGHT),
    ] + [
        (f"512x512x512 long reads {kind}", to_dev(_long_read_chunk(rng, 512, 512, kind)),
         cfg) for kind, cfg in LONG_READ_CFGS.items()
    ]
    checks += shapes
    for name, args, cfg in checks:
        ref = gotoh_forward_plane_ref(*args, **cfg)
        for src, lib in libs:
            for kernel in (0, 1) if args[2].shape[1] <= 256 else (0,):
                full, vec_bad, _ = _gotoh_mismatches(run(lib, args, cfg, kernel), ref)
                if full or any(vec_bad):
                    fail(f"{src} (kernel {kernel}) disagrees on {name} "
                         f"Ls={args[2].shape[1]}: {full} cells, {vec_bad}")
    print(f"{len(checks)} cases x {len(libs)} sources: bit-exact, full plane (kernel "
          "code 1 too up to 256 columns)", flush=True)

    order = list(range(len(libs)))
    order += order[::-1]
    for name, args, cfg in shapes:
        B, Lq, Ls = args[0].shape[0], args[0].shape[1], args[2].shape[1]
        b_ms, b_by = gotoh_bound(B, Lq, Ls)
        times = {i: ([], []) for i in range(len(libs))}
        for _round in range(3):
            for i in order:
                fn = lambda: run(libs[i][1], args, cfg)
                fn()
                times[i][0].append(event_ms(fn, 20))
                times[i][1].append(graph_ms(fn, reps=1))
        for i, (src, _) in enumerate(libs):
            ev, gr = times[i]
            ms, g_ms = np.median(ev), np.median(gr)
            print(f"{name} {src}: kernel {ms:.4f} ms (runs {min(ev):.4f}-{max(ev):.4f}), "
                  f"graph {g_ms:.4f} ms (runs {min(gr):.4f}-{max(gr):.4f}); bound "
                  f"{b_ms:.4f} ms by {b_by}: {100 * b_ms / ms:.1f}%, graph "
                  f"{100 * b_ms / g_ms:.1f}%", flush=True)
    print(nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
