"""What the program's stage ledger (ngsepcore_tpu_torch.utils.profiling)
kept of a traced window beyond its stage table: spans with their times on
the clock of the trace's window and device events, requests (one a
sample) and counters.  The harness turns the ledger off after the window
and resets it only when the next window starts, so the readers find the
records there.  A program whose ledger keeps no spans gives None."""
from __future__ import annotations

from .trace import clip, merge


def program_ledger():
    """The program's ledger module, or None where it keeps no spans."""
    from ngsepcore_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "spans") else None


def counters() -> dict | None:
    led = program_ledger()
    return None if led is None else led.counters()


def intersect(a, b) -> list[tuple[int, int]]:
    """Intersection of two sorted, disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a, b) -> list[tuple[int, int]]:
    """The parts of sorted, disjoint `a` outside sorted, disjoint `b`."""
    out = []
    j = 0
    for lo, hi in a:
        while j < len(b) and b[j][1] <= lo:
            j += 1
        k, at = j, lo
        while k < len(b) and b[k][0] < hi:
            if b[k][0] > at:
                out.append((at, b[k][0]))
            at = max(at, b[k][1])
            k += 1
        if at < hi:
            out.append((at, hi))
    return out


def idle_outside_spans_ns(gaps, requests, spans, window) -> int:
    """Nanoseconds of the device's idle gaps that lie inside a request and
    outside every span."""
    req = merge(clip([(r.start_ns, r.end_ns) for r in requests], *window))
    sp = merge(clip([(s.start_ns, s.end_ns) for s in spans], *window))
    return sum(b - a for a, b in subtract(intersect(gaps, req), sp))
