"""Host call stages around the realigner and the indel genotyper
(call/fused_pipeline.py's _call): host seconds a sample gathering the host
alignments, building the indel neighborhoods, the joint per-start cap, the
trim registry and the device expansion of the host calls."""
from perfbench.ledger import program_ledger
from perfbench.trace import stage_total

STAGES = ("call.gather_host", "call.indel_neighborhoods", "call.joint_cap",
          "call.trim_registry", "call.expand_host_calls")


def read(tr):
    if program_ledger() is None:
        return None
    return stage_total(tr, STAGES)
