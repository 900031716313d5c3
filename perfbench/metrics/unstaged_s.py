"""Pipeline orchestration (call/fused_pipeline.py): seconds a sample outside
every outermost stage (an inner stage, named in nested_stages*.json, counts
once, in its outer one)."""
from perfbench.trace import unstaged


def read(tr):
    return unstaged(tr)
