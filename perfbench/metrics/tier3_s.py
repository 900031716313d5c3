"""Tier-3 gapped DP (kernels/pairwise.py, kernels/pairwise_cuda.py): host
seconds a sample in its dispatch, fetch and decode."""
from perfbench.trace import stage_total

STAGES = ("align.tier3_dp",)


def read(tr):
    return stage_total(tr, STAGES)
