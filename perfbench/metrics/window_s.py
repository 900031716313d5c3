"""Pileup and genotype (kernels/shear_pileup.py, the window stage): host
seconds a sample in the window dispatch and the resolve that waits for it."""
from perfbench.trace import stage_total

STAGES = ("call.window_dispatch", "call.window_resolve")


def read(tr):
    return stage_total(tr, STAGES)
