"""Progress notification + cooperative cancellation.

Ref: src/ngsep/main/ProgressNotifier.java:29 — engines poll
`keepRunning(progress)` inside their run() loops; a False return requests
a cooperative stop (ThreadPoolManager.setCancelled is the reference's
pool-side counterpart).  Here long-running engines accept a
`progress_notifier` and poll it at batch/window boundaries; when it
returns False they stop early and raise CancelledByNotifier so callers
can distinguish a cancel from completion.
"""
from __future__ import annotations

import sys


class CancelledByNotifier(RuntimeError):
    """Raised by engines when the notifier requests a stop."""


class ProgressNotifier:
    """Base notifier: always keep running (subclass to observe/cancel)."""

    def keep_running(self, progress: int) -> bool:
        return True


class PrintProgressNotifier(ProgressNotifier):
    """Logs progress ticks to stderr (the reference's %N==0 log lines,
    AlignmentsPileupGenerator.java:326)."""

    def __init__(self, label: str = "progress", every: int = 1):
        self.label = label
        self.every = max(1, every)
        self._n = 0

    def keep_running(self, progress: int) -> bool:
        self._n += 1
        if self._n % self.every == 0:
            print(f"[{self.label}] {progress}", file=sys.stderr, flush=True)
        return True


def check(notifier: ProgressNotifier | None, progress: int) -> None:
    """Poll helper: raises CancelledByNotifier when the notifier says stop."""
    if notifier is not None and not notifier.keep_running(progress):
        raise CancelledByNotifier(f"cancelled at progress {progress}")
