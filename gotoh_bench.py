"""Check and time Gotoh-forward kernel sources against each other on one GPU.

    python3 gotoh_bench.py [variant.cu ...]
    python3 gotoh_bench.py --kernels

--kernels builds the package's source alone and compares its kernels on
one card instead: the cluster kernel against the wide kernel (and against
the seg kernel where that takes the width) at the MSA's 69x3936x3936 and
93x3392x3392 (unit costs, free subject ends), the tier-2 flanks at
256x160x1664 and 37x160x4096 / 8192 / 16384, each of the last and
69x3936x3936 also at every cluster size that has a layout there (1-8); every variant bit for bit
against the plain version first, then timed in rounds A B .. B A, with
cudaOccupancyMaxActiveClusters of each cluster layout.

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

import ctypes
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
    cluster_layout,
    cluster_shape,
    gotoh_forward_plane_ref,
    kernel_for,
    wide_layout,
)

MSA = dict(match=1, mismatch=1, open_gap=1, ext_gap=1)  # clustering/msa.py's costs


def run(lib, args, cfg, kernel=0):
    """One launch of lib's gotoh_forward_launch (`kernel` 0: by shape, 1:
    the source's second kernel, 2 the wide kernel, 3 | N << 8 the cluster
    kernel in clusters of N blocks): (plane, score, end_i, end_j, start_k).
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
        B, Lq, Ls, cfg.get("match", 1), cfg.get("mismatch", 1), cfg.get("open_gap", 3),
        cfg.get("ext_gap", 1),
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


def _msa_pairs(rng, B, L):
    """Pairs of one length at an MSA's 92-99% identity (substitutions only),
    full lengths."""
    s = rng.integers(0, 4, (B, L)).astype(np.int8)
    q = np.where(rng.random((B, L)) < 0.04, rng.integers(0, 4, (B, L)), s).astype(np.int8)
    full = np.full(B, L, np.int32)
    return q, full, s, full.copy()


def timed_rounds(variants, reps=20, rounds=3):
    """{label: (event ms list, graph ms list)} of fn() for (label, fn) in
    rounds A B .. B A: `reps` back-to-back calls timed with CUDA events,
    and min(reps, 5) calls in one CUDA graph (2 for calls of 4 GB planes)."""
    order = list(range(len(variants)))
    order += order[::-1]
    times = {label: ([], []) for label, _ in variants}
    for _round in range(rounds):
        for i in order:
            label, fn = variants[i]
            fn()
            times[label][0].append(event_ms(fn, reps))
            times[label][1].append(graph_ms(fn, reps=1, calls=2 if reps < 20 else 5))
    return times


def kernels_main(lib, n_sms) -> None:
    """The package's kernels against each other on one card (--kernels)."""
    rng = np.random.default_rng(16)
    to_dev = lambda data: [torch.from_numpy(a).cuda() for a in data]
    cluster = lambda n: 3 | (n << 8)
    left, right = dict(TIER2_LEFT), dict(TIER2_RIGHT)

    def held(cfg):  # clusters this card holds at once, from the source's own entry
        def clusters(n, W, K):
            out = ctypes.c_int(0)
            cuda_build.check("gotoh_cluster_occupancy", lib.gotoh_cluster_occupancy(
                n, W, K, int(cfg.get("free_start1", False)), int(cfg.get("free_end1", False)),
                ctypes.addressof(out)))
            return out.value
        return clusters

    def layout(B, Ls, cfg, **kw):  # gotoh_forward_launch's choice on this card
        return cluster_layout(B, Ls, cfg.get("free_end1", False), n_sms, held=held(cfg), **kw)

    def forced(B, Ls, cfg):  # the forced wrapper's choice: two blocks or more
        return cluster(layout(B, Ls, cfg, min_ctas=2)[0])

    def sizes(Ls, cfg):  # every cluster size with a layout at Ls
        return [(f"cluster N {n}", cluster(n)) for n in range(1, 9)
                if cluster_shape(Ls, cfg.get("free_end1", False), n)]

    cases = [
        ("69x3936x3936 MSA", _msa_pairs(rng, 69, 3936), MSA,
         [("by shape", 0)] + sizes(3936, MSA) + [("wide", 2)]),
        ("93x3392x3392 MSA", _msa_pairs(rng, 93, 3392), MSA,
         [("by shape", 0), ("cluster forced", forced(93, 3392, MSA))]),
        ("256x160x1664 tier-2 left", _tier2_chunk(rng, 256, "left", 160, 1664), left,
         [("by shape", 0), ("cluster forced", forced(256, 1664, left)), ("wide", 2)]),
        ("256x160x1664 tier-2 right", _tier2_chunk(rng, 256, "right", 160, 1664), right,
         [("by shape", 0), ("cluster forced", forced(256, 1664, right)), ("wide", 2)]),
    ] + [
        (f"37x160x{Ls} tier-2 {side}", _tier2_chunk(rng, 37, side, 160, Ls), cfg,
         [("by shape", 0)] + sizes(Ls, cfg) + [("wide", 2)])
        for Ls in (4096, 8192, 16384) for side, cfg in (("left", left), ("right", right))
    ]
    for name, data, cfg, variants in cases:
        args = to_dev(data)
        B, Lq, Ls = args[0].shape[0], args[0].shape[1], args[2].shape[1]
        ref = gotoh_forward_plane_ref(*args, **cfg)
        for label, code in variants:
            full, vec_bad, _ = _gotoh_mismatches(run(lib, args, cfg, code), ref)
            torch.cuda.synchronize()
            if full or any(vec_bad):
                fail(f"{label} disagrees on {name}: {full} cells, {vec_bad}")
        del ref
        torch.cuda.empty_cache()
        layouts = {}
        for label, code in variants:
            if code & 0xFF == 3 or (code == 0 and kernel_for(Ls) == "cluster"):
                N, W, K = layout(B, Ls, cfg, ctas=code >> 8 or None)
                layouts[label] = (f"cluster N {N} W {W} K {K}, {held(cfg)(N, W, K)} "
                                  f"clusters held at once for {B}")
            else:
                layouts[label] = kernel_for(Ls) if code == 0 else {1: "seg", 2: "wide"}[code]
        b_ms, b_by = gotoh_bound(B, Lq, Ls)
        reps = 20 if B * Lq * Ls < 2e8 else 5
        times = timed_rounds([(label, lambda code=code: run(lib, args, cfg, code))
                              for label, code in variants], reps=reps)
        for label, _ in variants:
            ev, gr = times[label]
            ms, g_ms = np.median(ev), np.median(gr)
            print(f"{name} {label} ({layouts[label]}): kernel {ms:.4f} ms (runs "
                  f"{min(ev):.4f}-{max(ev):.4f}), graph {g_ms:.4f} ms (runs "
                  f"{min(gr):.4f}-{max(gr):.4f}); bound {b_ms:.4f} ms by {b_by}: "
                  f"{100 * b_ms / ms:.1f}%, graph {100 * b_ms / g_ms:.1f}%", flush=True)
        del args
        torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    print(nvidia_smi(), flush=True)
    if sys.argv[1:] == ["--kernels"]:
        src = cuda_build.CSRC / "gotoh_forward.cu"
        lib, info = cuda_build.build([src], stem=f"libgotoh_k_{src.stem}")
        print(f"{src}: built in {info['seconds']:.1f}s", flush=True)
        for line in info["ptxas"].splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print("  ptxas:", line.strip(), flush=True)
        kernels_main(lib, torch.cuda.get_device_properties(0).multi_processor_count)
        print(nvidia_smi(), flush=True)
        return
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
