"""Same-card A/B of the run-jump walk kernel's epilogues on one GPU.

    python3 walk_bench.py PARENT_RUN_WALK_CU [--e2e PARENT_TREE] [--out FILE]

Kernels: the parent's csrc/run_walk.cu (PARENT_RUN_WALK_CU, for example an
earlier commit's copy of the file, which exports the walk alone as
`run_walk_launch(plane, end_i, end_j, start_k, B, Ls, R, free_start2, rop,
rlen, n_runs, n_ops, start_j, walk_ok, stream)`) is built alone with the
package's nvcc flags.  At the walk shapes of the main paths (the fused and
classic tier-3 chunks, the long-read segments at 128 and 512 columns) the
script holds this package's kernel bit for bit against the parent's walk
(runs mode) and against the parent's walk followed by the plain post-pass
(tier3 mode: dp_stats_runs; hamming mode: dp_stats_runs_hamming), then
times, in rounds A B B A: the parent's walk alone, what the new mode
replaces (the parent's walk and the plain post-pass), the new mode, and
the new runs mode; each as 20 calls from Python (5 for the post-pass) and
in one CUDA graph, CUDA events, medians.

End to end (--e2e): phases 5 (fused), 8 (its ReadsAligner CLI run), 15
(long reads) and 17 (assembly, 100 kb) of each tree's own chip_smoke.py,
in child processes, in the order parent, this tree, this tree, parent:
each phase's stage seconds (the profiling ledger, or the CLI's --profile
table) and wall time; last, each child runs phase 5's fused pipeline once
more under torch.profiler and counts its CUDA kernel launches and device
busy time.  PARENT_TREE is an
unpacked earlier commit (git archive), with its own kernel build.

Prints every number, the card's name and power limit, and writes them as
JSON to --out (default .bench_cache/walk_bench.json, which git ignores).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def _kernel_ab(parent_src: Path) -> dict:
    import torch

    from chip_smoke import (
        LONG_READ_CFGS,
        _bench_chunk,
        _classic_chunk,
        _long_read_chunk,
        cuda_ms,
        fail,
        graph_ms,
        walk_bound,
        walk_code_reads,
        walk_loads,
    )
    from ngsepcore_tpu_torch.kernels import cuda_build, pairwise
    from ngsepcore_tpu_torch.kernels.pairwise_cuda import gotoh_forward_plane

    lib, info = cuda_build.build([parent_src], stem="parent_run_walk")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.run_walk_launch.argtypes = [P] * 4 + [I] * 4 + [P] * 6 + [P]
    lib.run_walk_launch.restype = ctypes.c_int
    print(f"parent walk built in {info['seconds']:.1f}s; ptxas:\n{info['ptxas']}", flush=True)

    def parent_walk(plane, score, end_i, end_j, start_k, B, R, fs2):
        """The parent's walk launch and its wrapper's outputs."""
        dev = plane.device
        rop = torch.empty((B, R), dtype=torch.int32, device=dev)
        rlen = torch.empty((B, R), dtype=torch.int32, device=dev)
        fin = torch.empty((3, B), dtype=torch.int32, device=dev)
        walk_ok = torch.empty(B, dtype=torch.bool, device=dev)
        rc = lib.run_walk_launch(
            plane.data_ptr(), end_i.data_ptr(), end_j.data_ptr(), start_k.data_ptr(),
            B, plane.shape[2], R, int(fs2), rop.data_ptr(), rlen.data_ptr(),
            fin[0].data_ptr(), fin[1].data_ptr(), fin[2].data_ptr(), walk_ok.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        cuda_build.check("parent run_walk", rc)
        return {"score": score, "rop": rop, "rlen": rlen, "n_runs": fin[0],
                "n_ops": fin[1], "start_j": fin[2], "end_j": end_j, "end_i": end_i,
                "walk_ok": walk_ok}

    rng = np.random.default_rng(10)
    tier3 = pairwise._walk_runs_for
    shapes = [
        ("fused tier 3 2048x160x160", _bench_chunk(rng, 2048, 160, 160), {}, "tier3"),
        ("classic tier 3 2048x192x192", _classic_chunk(rng, 2048), {}, "tier3"),
    ] + [
        (f"long reads {kind} 512x{W}x{W}", _long_read_chunk(rng, 512, W, kind), cfg,
         "hamming")
        for W in (128, 512) for kind, cfg in LONG_READ_CFGS.items()
    ]
    results = {}
    for name, data, cfg, mode in shapes:
        q, ql, s, sl = [torch.from_numpy(a).cuda() for a in data]
        plane, score, end_i, end_j, start_k = gotoh_forward_plane(q, ql, s, sl, **cfg)
        B, Lq, Ls = plane.shape[1], plane.shape[0], plane.shape[2]
        R = tier3(Lq)
        fs2 = cfg.get("free_start2", True)
        wargs = (plane, score, end_i, end_j, start_k, B, R, fs2)
        post = ((lambda out: pairwise.dp_stats_runs(out, q, s)) if mode == "tier3"
                else pairwise.dp_stats_runs_hamming)
        new = ((lambda: pairwise.tier3_walk_stats(*wargs[:7], q, s, free_start2=fs2))
               if mode == "tier3" else (lambda: pairwise.segment_walk_stats(*wargs)))
        fns = {
            "parent walk": lambda: parent_walk(*wargs),
            "replaced": lambda: post(parent_walk(*wargs)),
            mode: new,
            "runs": lambda: pairwise._runs_from_plane(*wargs),
        }
        old, runs = fns["parent walk"](), fns["runs"]()
        want, got = post(old), new()
        bad = {k: int((old[k] != runs[k]).sum()) for k in old}
        bad.update({f"{mode} {k}": int((got[k] != want[k]).sum()) for k in want})
        if any(bad.values()):
            fail(f"walk_bench: {name}: the kernel differs from the parent's composite: {bad}")
        t = {k: {"ms": [], "graph_ms": []} for k in fns}
        for label in ("parent walk", "replaced", mode, "runs", "runs", mode, "replaced",
                      "parent walk"):
            calls = 5 if label == "replaced" else 20
            t[label]["ms"].append(cuda_ms(fns[label], calls=calls))
            t[label]["graph_ms"].append(graph_ms(fns[label], calls=calls))
        loads = walk_loads(plane, end_i, end_j, start_k, R)
        reads = walk_code_reads(runs, q, s) if mode == "tier3" else 0
        b_ms, b_by = walk_bound(B, R, loads, mode, reads)
        r = {k: {m: float(np.median(v)) for m, v in d.items()} for k, d in t.items()}
        r.update(mode=mode, shape=f"{B}x{Lq}x{Ls} R {R}", bound_ms=b_ms, bound_by=b_by,
                 longest_chain=int(loads.max()), plane_words=int(loads.sum()),
                 code_reads=reads)
        results[name] = r
        print(f"{name} R {R}, {mode}: equal to the parent's composite; " + "; ".join(
            f"{k} {r[k]['ms']:.4f} ms, graph {r[k]['graph_ms']:.4f}" for k in fns)
            + f"; bound {b_ms:.4f} ms by {b_by} (chain {int(loads.max())}, codes read "
            f"{reads}), the mode at "
            f"{100 * b_ms / r[mode]['graph_ms']:.1f}% of it in a graph", flush=True)
        del plane
    return results


def _stage_seconds(lines) -> dict:
    """{stage: seconds} from the stage table that the CLI's --profile
    prints (utils/profiling.report: "  name  1.234s  x5  (...)")."""
    out = {}
    for line in lines:
        name, secs = line.split()[:2]
        out[name] = float(secs.rstrip("s"))
    return out


def _child(tree: str) -> None:
    """Phases 5, 8 (its ReadsAligner CLI run) 15 and 17 of `tree`'s
    chip_smoke.py, then the fused pipeline once more under torch.profiler
    (last, so that the profiler's cost does not reach the stages); prints
    a JSON line of the numbers.  The stage seconds come from the profiling
    ledger of this process, or from the CLI's --profile table."""
    os.chdir(tree)
    sys.path.insert(0, tree)
    import tempfile

    import torch

    import chip_smoke as c
    from ngsepcore_tpu_torch.kernels.pairwise import _runs_from_plane as run_walk
    from ngsepcore_tpu_torch.kernels.pairwise_cuda import gotoh_forward_plane
    from ngsepcore_tpu_torch.kernels.shear_pileup import shear_hist
    from ngsepcore_tpu_torch.utils import profiling

    c.phase_device()
    c.phase_build()
    counters = (gotoh_forward_plane, run_walk, shear_hist)
    out = {"tree": tree}
    launches, dt, records, genome, reads, truth, table, _, _ = c.phase_real_size(counters)
    out["5"] = {"seconds": dt, "launches": launches,
                "stages": {k: v[0] for k, v in profiling._stages.items()}}
    with tempfile.TemporaryDirectory() as d:
        c._write_inputs(d, genome, reads)
        g, fq = os.path.join(d, "genome.fa"), os.path.join(d, "reads.fastq")
        t_al, prof, _ = c._cli(["ReadsAligner", "-r", g, "-o", os.path.join(d, "alns.sam"),
                                "-s", "s1", fq], 900)
        out["8"] = {"aligner_s": t_al, "align_stages": _stage_seconds(prof)}
    torch.cuda.empty_cache()
    lr_counters = (gotoh_forward_plane, run_walk)
    for p, fn in (("15", c.phase_long_reads_real_size), ("17", c.phase_assembly_real_size)):
        profiling.reset()
        t0 = time.perf_counter()
        fn(lr_counters)
        out[p] = {"phase_s": time.perf_counter() - t0, "walk_launches": run_walk.launches,
                  "stages": {k: v[0] for k, v in profiling._stages.items()}}
        torch.cuda.empty_cache()
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        c._run_pipeline(genome, reads, "cuda", 65536, table=table)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = prof.events()
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in dev if "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower()]
    launch_calls = sum(1 for e in events if e.name in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    out["5 profile"] = {"wall_s": wall, "device_kernels": len(kernels),
                        "device_events": len(dev), "launch_calls": launch_calls,
                        "kernel_busy_s": busy_us / 1e6}
    print(f"profiled fused run: {wall:.3f}s under the profiler; {len(kernels)} device "
          f"kernels ({len(dev)} device events), {launch_calls} launch calls, kernels "
          f"busy {busy_us / 1e6:.3f}s = {100 * busy_us / 1e6 / wall:.2f}% of the wall",
          flush=True)
    print("E2E " + json.dumps(out), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent_src", type=Path, nargs="?")
    ap.add_argument("--e2e", metavar="PARENT_TREE")
    ap.add_argument("--child", metavar="TREE", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=str(ROOT / ".bench_cache" / "walk_bench.json"))
    args = ap.parse_args()
    if args.child:
        _child(args.child)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("walk_bench.py needs a CUDA card")
    from chip_smoke import nvidia_smi

    smi = nvidia_smi()
    print(smi, flush=True)
    result = {"card": smi}
    if args.parent_src:
        result["kernels"] = _kernel_ab(args.parent_src)
    if args.e2e:
        torch.cuda.empty_cache()
        runs = []
        for tree in (args.e2e, str(ROOT), str(ROOT), args.e2e):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                                   str(Path(tree).resolve())],
                                  capture_output=True, text=True, timeout=1800)
            print(proc.stdout[-6000:], proc.stderr[-3000:], flush=True)
            if proc.returncode != 0:
                sys.exit(f"the child on {tree} exited {proc.returncode}")
            line = [l for l in proc.stdout.splitlines() if l.startswith("E2E ")][-1]
            runs.append(json.loads(line[4:]))
            print(f"child {tree}: {time.perf_counter() - t0:.1f}s", flush=True)
        result["e2e"] = runs
    result["card_after"] = nvidia_smi()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(result["card_after"], flush=True)


if __name__ == "__main__":
    main()
