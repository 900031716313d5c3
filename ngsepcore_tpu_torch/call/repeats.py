"""Repeat regions from multi-mapping reads.

Ref: src/ngsep/discovery/MultipleMappingRegionsCalculator.java:25-128 —
chain non-unique alignments with gaps <= 5 bp into candidate regions;
a region with >= 5 non-unique alignments is a repeat call with genotype
quality phred(uniqueAlns / (nonUnique + unique)).  Runs as stage 1 of
SingleSampleVariantsDetector (findRepeats :607-612).
"""
from __future__ import annotations

from ..align.read_alignment import ReadAlignment
from ..math.phred import phred_score
from ..variants.model import CalledGenomicVariant, TYPE_REPEAT

SOURCE_MULTIPLE_ALNS = "MultiAlns"
DEF_MIN_MQ_UNIQUE = 20  # ref: ReadAlignment.DEF_MIN_MQ_UNIQUE_ALIGNMENT


class MultipleMappingRegionsCalculator:
    def __init__(self, min_mq: int = DEF_MIN_MQ_UNIQUE):
        self.min_mq = min_mq

    def calculate_multiple_mapping_regions(
        self, alns: list[ReadAlignment]
    ) -> list[CalledGenomicVariant]:
        out: list[CalledGenomicVariant] = []
        by_seq: dict[str, list[ReadAlignment]] = {}
        min_read_length = None
        for a in alns:
            if a.is_unmapped or a.is_secondary:
                continue
            if min_read_length is None or a.read_length < min_read_length:
                min_read_length = a.read_length
            by_seq.setdefault(a.sequence_name, []).append(a)
        for seq in sorted(by_seq):
            seq_alns = sorted(by_seq[seq], key=lambda a: a.first)
            region = None  # [first, last, non_unique]
            unique_starts: list[int] = []
            for a in seq_alns:
                if region is not None and region[1] < a.first - 5:
                    call = self._make_call(seq, region, unique_starts, min_read_length)
                    if call is not None:
                        out.append(call)
                    region = None
                if a.alignment_quality < self.min_mq:  # non-unique
                    if region is None:
                        region = [a.first, a.last, 1]
                    else:
                        region[2] += 1
                        region[1] = max(region[1], a.last)
                else:
                    unique_starts.append(a.first)
            if region is not None:
                call = self._make_call(seq, region, unique_starts, min_read_length)
                if call is not None:
                    out.append(call)
        return out

    @staticmethod
    def _make_call(seq, region, unique_starts, min_read_length):
        first, last, non_unique = region
        if non_unique < 5:
            return None
        rl = min_read_length or 0
        unique = sum(1 for s in unique_starts if first <= s and s + rl - 1 <= last)
        p = (
            unique / (non_unique + unique)
            if unique > 0
            else 1.0 / (1.0 + non_unique)
        )
        return CalledGenomicVariant(
            sequence_name=seq,
            first=first,
            alleles=["N"],
            variant_type=TYPE_REPEAT,
            last_=last,
            genotype_quality=phred_score(p),
            total_read_depth=non_unique + unique,
            indexes_called_alleles=[0],
        )
