"""Candidate selection (align/reads_aligner.py through the pipeline's
_classify_batch and _select_batch): host seconds a sample."""
from perfbench.trace import stage_total

STAGES = ("align.classify", "align.select_final")


def read(tr):
    return stage_total(tr, STAGES)
