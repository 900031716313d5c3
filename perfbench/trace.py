"""What a `--trace 1` run records, and the arithmetic that reads it.

During the window of a traced run:
- the program's stage ledger (ngsepcore_tpu_torch.utils.profiling) is on;
- `torch.profiler` records the device's kernels, copies and sets (CUDA
  activity only, so host code runs at its untraced speed);
- a thread samples the main thread's stack every few milliseconds and keeps
  the innermost frame of the program, which names what the host was doing
  while the device sat idle;
- the Gotoh launch counter (its padded launch shapes) is read, and the
  calls into the shear histogram are counted with their sizes.

Everything stays in memory; the result line carries only the summary.
"""
from __future__ import annotations

import bisect
import sys
import threading
import time
from collections import Counter
from dataclasses import dataclass, field

PROGRAM = "ngsepcore_tpu_torch"
SAMPLE_EVERY_S = 0.004


@dataclass
class Trace:
    """The readings of one traced window (times in ns of the wall clock
    that torch.profiler stamps its events with)."""

    window: tuple[int, int] = (0, 0)
    samples: int = 0
    sample_walls: list = field(default_factory=list)  # seconds a sample
    stages: dict = field(default_factory=dict)  # name -> [total_s, calls]
    nested: dict = field(default_factory=dict)  # inner stage -> outer stage
    device_events: list = field(default_factory=list)  # (name, start_ns, end_ns)
    host_samples: list = field(default_factory=list)  # (ns, label)
    gotoh_shapes: Counter = field(default_factory=Counter)  # (B, Lq, Ls) -> launches
    shear_calls: Counter = field(default_factory=Counter)  # (window, lanes) -> calls

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9


def stage_total(tr: Trace, names) -> float | None:
    """Seconds a sample in the given stages, summed; None when no sample
    ran or none of the stages was entered."""
    if not tr.samples or not any(n in tr.stages for n in names):
        return None
    return sum(tr.stages[n][0] for n in names if n in tr.stages) / tr.samples


def unstaged(tr: Trace) -> float | None:
    """Seconds a sample outside every outermost stage."""
    if not tr.samples or not tr.stages:
        return None
    outer = sum(t for n, (t, _) in tr.stages.items() if n not in tr.nested)
    return (sum(tr.sample_walls) - outer) / tr.samples


def merge(intervals) -> list[tuple[int, int]]:
    """Union of (start, end) intervals, sorted and disjoint."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, lo: int, hi: int):
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def busy_ns(tr: Trace) -> int:
    """Nanoseconds of the window in which some device operation ran."""
    busy = merge(clip([(a, b) for _, a, b in tr.device_events], *tr.window))
    return sum(b - a for a, b in busy)


def idle_pct(tr: Trace) -> float | None:
    if not tr.device_events or tr.window[1] <= tr.window[0]:
        return None
    return 100.0 * (1.0 - busy_ns(tr) / (tr.window[1] - tr.window[0]))


def gaps(tr: Trace) -> list[tuple[int, int]]:
    """The window's idle intervals on the device."""
    lo, hi = tr.window
    busy = merge(clip([(a, b) for _, a, b in tr.device_events], lo, hi))
    out, at = [], lo
    for a, b in busy:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def idle_by_host(tr: Trace, top: int = 10) -> list[list]:
    """Idle device seconds by what the host was doing: each idle gap is
    shared among the labels sampled inside it, in proportion to their
    samples ("unsampled" takes a gap that fell between two samples)."""
    times = [t for t, _ in tr.host_samples]
    labels = [lab for _, lab in tr.host_samples]
    acc: Counter = Counter()
    for a, b in gaps(tr):
        i, j = bisect.bisect_left(times, a), bisect.bisect_right(times, b)
        inside = Counter(labels[i:j]) or Counter({"unsampled": 1})
        n = sum(inside.values())
        for name, k in inside.items():
            acc[name] += (b - a) * 1e-9 * k / n
    return [[n, s] for n, s in acc.most_common(top)]


def device_ops(tr: Trace, top: int = 10) -> list[list]:
    """Device seconds by operation name, largest first."""
    acc: Counter = Counter()
    lo, hi = tr.window
    for name, a, b in tr.device_events:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            acc[short_name(name)] += (b - a) * 1e-9
    return [[n, s] for n, s in acc.most_common(top)]


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list (other
    device operations, such as copies, keep theirs)."""
    if not (name.startswith("void ") and name.endswith(")")):
        return name
    depth = 0
    for k in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[k], 0)
        if depth == 0:
            return name[5:k]
    return name


def kernel_seconds(tr: Trace, fragment: str) -> float:
    """Device seconds of the kernels whose name holds `fragment`."""
    return sum((b - a) * 1e-9 for name, a, b in tr.device_events if fragment in name)


class HostSampler:
    """Samples the main thread's innermost program frame every
    SAMPLE_EVERY_S until stopped."""

    def __init__(self, out: list):
        self.out = out
        self.main = threading.main_thread().ident
        self.stop_flag = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)

    def _label(self, frame) -> str:
        f = frame
        while f is not None:
            path = f.f_code.co_filename
            k = path.rfind(PROGRAM + "/")
            if k >= 0:
                mod = path[k:].removesuffix(".py").replace("/", ".")
                return f"{mod}:{f.f_code.co_name}"
            f = f.f_back
        return "outside_program"

    def _loop(self) -> None:
        while not self.stop_flag.is_set():
            frame = sys._current_frames().get(self.main)
            if frame is not None:
                self.out.append((time.time_ns(), self._label(frame)))
            del frame
            self.stop_flag.wait(SAMPLE_EVERY_S)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop_flag.set()
        self.thread.join(timeout=10)
        return False


def read_device_events(prof) -> list[tuple[str, int, int]]:
    """(name, start_ns, end_ns) of every device-side event of a finished
    torch.profiler session."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            out.append((e.name(), int(e.start_ns()), int(e.end_ns())))
    return out
