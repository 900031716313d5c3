"""CLI entry: python -m ngsepcore_tpu_torch [--device cuda|cpu] [--profile]
<Command> [options] <args>

Ref: src/ngsep/main/NGSEPcore.java:35-67 — command dispatch by id with
legacy-id redirect and a grouped help listing.

Global flags (any position): --device names where every tensor of the run
lives (default cuda; there is no fallback: without a usable CUDA device
the command exits nonzero), --profile prints the per-stage wall-clock
ledger (utils/profiling.py: each stage's total, calls, self time without
its child stages and the collector's pauses inside it, then the
collector's passes and seconds by generation) and the CUDA kernels'
launch counts at exit.
"""
from __future__ import annotations

import sys


def print_help() -> None:
    from . import __version__
    from .cli import commands  # noqa: F401 (registers commands)
    from .cli.registry import all_commands

    print(f"ngsepcore_tpu_torch {__version__} — NGS analysis on PyTorch + CUDA")
    print(
        "Usage: python -m ngsepcore_tpu_torch [--device cuda|cpu] [--profile] "
        "<Command> [options] <args>\n"
    )
    groups: dict[str, list] = {}
    for c in all_commands():
        if not c.hidden:
            groups.setdefault(c.group, []).append(c)
    for g in ("Reads", "Discovery", "Genomes", "VariantsDownstream", "Benchmark"):
        cmds = groups.get(g, [])
        if not cmds:
            continue
        print(f"[{g}]")
        for c in sorted(cmds, key=lambda c: c.id):
            print(f"  {c.id:<36} {c.description}")
        print()


def _open_device(name: str):
    """The run's torch device.  On CUDA, TF32 goes off for the whole
    process: the genotypers' float32 screens decide which positions reach
    the exact stage and refuse to run with TF32 matmuls."""
    import torch

    try:
        device = torch.device(name)
    except RuntimeError as e:
        raise SystemExit(f"--device {name}: {e}") from None
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(
                f"--device {name}: no usable CUDA device "
                "(torch.cuda.is_available() is false)"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    elif device.type != "cpu":
        raise SystemExit(f"--device {name}: only cuda and cpu are supported")
    return device


def _log_parameters(cmd, opts: dict, pos: list[str], device) -> None:
    """Log the full effective parameter set at command start (ref:
    every engine's logParameters, e.g. ReadsAligner.java:345-366)."""
    lines = [f"Running {cmd.id} on {device}"]
    for o in cmd.options:
        if o.attr in opts:
            lines.append(f"  -{o.flag} ({o.attr}): {opts[o.attr]}")
    if pos:
        lines.append(f"  positional: {' '.join(pos)}")
    print("\n".join(lines), file=sys.stderr, flush=True)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    profile = False
    while "--profile" in argv:
        argv.remove("--profile")
        profile = True
    device_name = "cuda"
    while "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            raise SystemExit("--device requires a value (cuda or cpu)")
        device_name = argv[i + 1]
        del argv[i : i + 2]
    if not argv or argv[0] in ("-h", "--help", "help"):
        print_help()
        return 0
    from .cli import commands  # noqa: F401
    from .cli.registry import get_command, parse_args

    cmd = get_command(argv[0])
    if cmd is None:
        print(f"Unknown command: {argv[0]}\n", file=sys.stderr)
        print_help()
        return 1
    device = _open_device(device_name)
    from .utils import profiling

    if profile:
        profiling.enable()
    opts, pos = parse_args(cmd, argv[1:])
    # fill defaults for typed options
    for o in cmd.options:
        if o.attr not in opts and o.default is not None:
            opts[o.attr] = o.default
    _log_parameters(cmd, opts, pos, device)
    try:
        cmd.runner(opts, pos, device)
    finally:
        if profile:
            profiling.report()
            from .kernels.hmm import posterior_log_batch, viterbi_log
            from .kernels.pairwise import _runs_from_plane
            from .kernels.pairwise_cuda import gotoh_forward_plane
            from .kernels.shear_pileup import shear_hist

            print(
                f"kernel launches: gotoh_forward_plane={gotoh_forward_plane.launches} "
                f"run_walk={_runs_from_plane.launches} "
                f"shear_hist={shear_hist.launches} viterbi_log={viterbi_log.launches} "
                f"forward_backward={posterior_log_batch.launches}",
                file=sys.stderr, flush=True,
            )
            from .genome.transposons import find_repeats_by_library
            from .graphs.mcl import mcl_cluster

            print(
                f"device calls: mcl_cluster={mcl_cluster.calls} "
                f"(iterations {mcl_cluster.iterations}) "
                f"te_extractions={find_repeats_by_library.extractions}",
                file=sys.stderr, flush=True,
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
