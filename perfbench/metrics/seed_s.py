"""Seeding (index/minimizer_table.py, kernels/seeding.py): host seconds a sample
in the seeding dispatch and the fetch of its results."""
from perfbench.trace import stage_total

STAGES = ("align.seed_dispatch", "align.seed_fetch")


def read(tr):
    return stage_total(tr, STAGES)
