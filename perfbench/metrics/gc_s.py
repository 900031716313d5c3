"""Host runtime (Python's collector, seen through the program's hook on
gc.callbacks): seconds a sample the collector paused the program while a
sample's request was open (counter gc.ns_in_request)."""
from perfbench.ledger import counters


def read(tr):
    c = counters()
    if c is None or not tr.samples:
        return None
    return c.get("gc.ns_in_request", 0) * 1e-9 / tr.samples
