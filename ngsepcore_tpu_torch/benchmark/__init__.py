"""Benchmark tools: gold-standard, family and SV comparisons (host numpy)."""
from .gold_standard import VCFGoldStandardComparator
