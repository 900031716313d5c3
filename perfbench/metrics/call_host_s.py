"""Host call stages (call/realigner.py, call/aln_table.py, call/indel_batch.py
through single_sample._call_indels): host seconds a sample."""
from perfbench.trace import stage_total

STAGES = ("call.realign", "call.aln_table", "call.indel_genotype")


def read(tr):
    return stage_total(tr, STAGES)
