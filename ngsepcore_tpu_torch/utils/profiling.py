"""In-framework stage profiling.

Ref: the reference logs ad-hoc wall-clock lines inside run() methods
(Assembler.java:346-352 "Time(s) ... Memory (Gbp)", ReadsAligner.java:
271,307-309) and the GBS module keeps a ProcessInfo time ledger
(KmerPrefixReadsClusteringAlgorithm.java:962-1002).  This replaces those
with one reusable ledger: `with stage("align.seed"): ...` accumulates
wall-clock + call counts per stage name, commands expose `--profile` to
dump the table, and NGSEP_TPU_PROFILE=1 enables it globally (zero
overhead when disabled beyond one truthiness check).

While the ledger is on it also keeps, in memory:

- a span for every `stage()`: its id, the id of the innermost span open on
  the same thread when it started (its parent), the request it belongs to,
  its name, its start and end in nanoseconds of `time.time_ns()` (the
  clock torch.profiler stamps device events with), and the nanoseconds
  the collector paused inside it;
- a request for every `request()` block (one unit of work, such as one
  sample through AlignCallPipeline.run_reads): its id, start and end.  A
  request is not a stage and does not enter the stage table;
- counters: `count(name, n)` from the program, and from a hook on
  `gc.callbacks` the collector's passes and nanoseconds by generation
  (`gc.gen<g>.passes`, `gc.gen<g>.ns`) and its nanoseconds while a
  request is open (`gc.ns_in_request`).  Each pause is also charged to the
  innermost span open on the collecting thread (or, on a thread with no
  span open, on the thread that opened the request).

`enable(False)` stops recording and removes the hook but keeps every
record; only `reset()` clears them.  Spans, requests and counters are
read with `spans()`, `requests()` and `counters()`.
"""
from __future__ import annotations

import gc
import itertools
import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import NamedTuple


class Span(NamedTuple):
    id: int
    parent: int | None
    request: int | None
    name: str
    start_ns: int
    end_ns: int
    gc_ns: int


class Request(NamedTuple):
    id: int
    start_ns: int
    end_ns: int


_enabled = False
_stages: dict[str, list] = {}  # name -> [total_s, calls]
_spans: list[Span] = []
_requests: list[Request] = []
_counters: dict[str, int] = {}
_ids = itertools.count(1)
_local = threading.local()  # .stack: open span records of this thread
_open_requests: list[list] = []  # [id, start_ns, opening thread's stack]
_offset_ns = 0  # time.time_ns() - time.perf_counter_ns()
_gc_t0 = 0


def _now_ns() -> int:
    return time.perf_counter_ns() + _offset_ns


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _bump(name: str, n: int) -> None:
    _counters[name] = _counters.get(name, 0) + n


def _on_gc(phase: str, info: dict) -> None:
    global _gc_t0
    if phase == "start":
        _gc_t0 = time.perf_counter_ns()
        return
    dt = time.perf_counter_ns() - _gc_t0
    g = info["generation"]
    _bump(f"gc.gen{g}.passes", 1)
    _bump(f"gc.gen{g}.ns", dt)
    st = _stack()
    if _open_requests:
        _bump("gc.ns_in_request", dt)
        if not st:
            st = _open_requests[-1][2]
    if st:
        st[-1][6] += dt


def enable(on: bool = True) -> None:
    global _enabled, _offset_ns
    if on and not _enabled:
        # the midpoint of two monotonic readings around one wall reading
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        _offset_ns = w - (a + b) // 2
    if on and _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)
    elif not on and _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)
    _enabled = on


def enabled() -> bool:
    return _enabled


def reset() -> None:
    _stages.clear()
    _spans.clear()
    _requests.clear()
    _counters.clear()


@contextmanager
def stage(name: str):
    if not _enabled:
        yield
        return
    st = _stack()
    parent = st[-1][0] if st else None
    req = _open_requests[-1][0] if _open_requests else None
    rec = [next(_ids), parent, req, name, 0, 0, 0]
    st.append(rec)
    t0 = time.perf_counter_ns()
    rec[4] = t0 + _offset_ns
    try:
        yield
    finally:
        t1 = time.perf_counter_ns()
        st.remove(rec)
        rec[5] = t1 + _offset_ns
        _spans.append(Span(*rec))
        dt = (t1 - t0) * 1e-9
        acc = _stages.get(name)
        if acc is None:
            _stages[name] = [dt, 1]
        else:
            acc[0] += dt
            acc[1] += 1


@contextmanager
def request():
    """One unit of work (a sample); spans opened inside carry its id."""
    if not _enabled:
        yield None
        return
    rec = [next(_ids), _now_ns(), _stack()]
    _open_requests.append(rec)
    try:
        yield rec[0]
    finally:
        _open_requests.remove(rec)
        _requests.append(Request(rec[0], rec[1], _now_ns()))


def count(name: str, n: int = 1) -> None:
    """Add `n` to a work counter (nothing while the ledger is off)."""
    if _enabled:
        _bump(name, int(n))


def spans() -> list[Span]:
    return list(_spans)


def requests() -> list[Request]:
    return list(_requests)


def counters() -> dict[str, int]:
    return dict(_counters)


def _self_and_gc() -> dict[str, tuple[float, float]]:
    """name -> (self seconds: span durations minus their child spans',
    collector seconds charged to the stage)."""
    child_ns: dict[int, int] = {}
    for s in _spans:
        if s.parent is not None:
            child_ns[s.parent] = child_ns.get(s.parent, 0) + s.end_ns - s.start_ns
    out: dict[str, list] = {}
    for s in _spans:
        acc = out.setdefault(s.name, [0, 0])
        acc[0] += s.end_ns - s.start_ns - child_ns.get(s.id, 0)
        acc[1] += s.gc_ns
    return {k: (a * 1e-9, b * 1e-9) for k, (a, b) in out.items()}


def report(fh=None, reset_after: bool = False) -> str:
    """Stage table sorted by total time, with each stage's self time and
    collector time, then the collector's passes by generation (also
    returned as a string)."""
    fh = fh or sys.stderr
    lines = ["stage profile (wall-clock; self = minus child stages; gc = collector pauses inside)"]
    width = max([len(n) for n in _stages] + [5])
    own = _self_and_gc()
    for name, (total, calls) in sorted(
        _stages.items(), key=lambda kv: -kv[1][0]
    ):
        self_s, gc_s = own.get(name, (total, 0.0))
        lines.append(
            f"  {name:<{width}}  {total:9.3f}s  x{calls}"
            f"  ({total / calls * 1000:8.2f} ms/call)"
            f"  self {self_s:9.3f}s  gc {gc_s:8.3f}s"
        )
    gens = [
        f"gen{g} {_counters[f'gc.gen{g}.passes']} passes "
        f"{_counters[f'gc.gen{g}.ns'] * 1e-9:.3f}s"
        for g in range(3) if f"gc.gen{g}.passes" in _counters
    ]
    if gens:
        lines.append("collector: " + ", ".join(gens))
    text = "\n".join(lines)
    print(text, file=fh, flush=True)
    if reset_after:
        reset()
    return text


if os.environ.get("NGSEP_TPU_PROFILE"):
    enable(True)
