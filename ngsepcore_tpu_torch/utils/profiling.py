"""In-framework stage profiling.

Ref: the reference logs ad-hoc wall-clock lines inside run() methods
(Assembler.java:346-352 "Time(s) ... Memory (Gbp)", ReadsAligner.java:
271,307-309) and the GBS module keeps a ProcessInfo time ledger
(KmerPrefixReadsClusteringAlgorithm.java:962-1002).  This replaces those
with one reusable ledger: `with stage("align.seed"): ...` accumulates
wall-clock + call counts per stage name, commands expose `--profile` to
dump the table, and NGSEP_TPU_PROFILE=1 enables it globally (zero
overhead when disabled beyond one truthiness check).
"""
from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager

_enabled = bool(os.environ.get("NGSEP_TPU_PROFILE"))
_stages: dict[str, list] = {}  # name -> [total_s, calls]


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


def reset() -> None:
    _stages.clear()


@contextmanager
def stage(name: str):
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        acc = _stages.get(name)
        if acc is None:
            _stages[name] = [dt, 1]
        else:
            acc[0] += dt
            acc[1] += 1


def add(name: str, seconds: float, calls: int = 1) -> None:
    """Record externally-measured time under a stage name."""
    if not _enabled:
        return
    acc = _stages.get(name)
    if acc is None:
        _stages[name] = [seconds, calls]
    else:
        acc[0] += seconds
        acc[1] += calls


def report(fh=None, reset_after: bool = False) -> str:
    """Stage table sorted by total time (also returned as a string)."""
    fh = fh or sys.stderr
    lines = ["stage profile (wall-clock)"]
    width = max([len(n) for n in _stages] + [5])
    for name, (total, calls) in sorted(
        _stages.items(), key=lambda kv: -kv[1][0]
    ):
        lines.append(
            f"  {name:<{width}}  {total:9.3f}s  x{calls}"
            f"  ({total / calls * 1000:8.2f} ms/call)"
        )
    text = "\n".join(lines)
    print(text, file=fh, flush=True)
    if reset_after:
        reset()
    return text
