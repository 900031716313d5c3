"""Candidate selection (the pipeline's _select_batch): percent of the
window's reads whose winning placement became a host ReadAlignment, off the
fused device path (counters align.host_alns over align.reads)."""
from perfbench.ledger import counters


def read(tr):
    c = counters()
    if not c or not c.get("align.reads"):
        return None
    return 100.0 * c.get("align.host_alns", 0) / c["align.reads"]
