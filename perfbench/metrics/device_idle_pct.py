"""The device: percent of the traced window in which no kernel, copy or
set ran on it (100 minus the union of their intervals)."""
from perfbench.trace import idle_pct


def read(tr):
    return idle_pct(tr)
