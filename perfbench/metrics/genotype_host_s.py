"""Pileup and genotype, host side (call/fused_pipeline.py's _genotype_hist
and _genotype_span): host seconds a sample compacting the fused reads,
fetching the window bounds, building the stage of each chunk, preparing
each window, and building the records."""
from perfbench.ledger import program_ledger
from perfbench.trace import stage_total

STAGES = ("call.compact_fused", "call.window_bounds", "call.stage_build",
          "call.window_prep", "call.build_records")


def read(tr):
    if program_ledger() is None:
        return None
    return stage_total(tr, STAGES)
