"""Structural-variant callset comparison and gold-standard builders.

Ref: src/ngsep/benchmark/ —
- VCFDirectSVComparison.java:40-387 (match test SVs against gold SVs of
  the same type by overlap; per-event intersection lengths feed
  nucleotide-level TP/FP/FN estimates)
- GoldStandardGVCFBuilder.java (merge a truth VCF with confidently
  homozygous-reference regions into a gVCF-style gold standard)
- BiparentalHaploidGoldStandardBuilder.java (derive a gold standard from
  two haploid parental VCFs: sites where both parents are confidently
  called; disagreeing sites become the truth variant set)
- AssembliesAlignedTranscriptStatistics.java (complete/fragmented/missing
  counts of transcripts aligned to an assembly)

A copy of ngsepcore_tpu/benchmark/sv_comparison.py (host code).
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class SVComparisonStats:
    gold_total: int = 0
    test_total: int = 0
    true_positives: int = 0
    false_positives: int = 0
    false_negatives: int = 0
    intersection_bp: int = 0

    @property
    def sensitivity(self) -> float:
        return self.true_positives / self.gold_total if self.gold_total else 0.0

    @property
    def precision(self) -> float:
        return self.true_positives / self.test_total if self.test_total else 0.0


class VCFDirectSVComparison:
    """Overlap-based SV comparison (VCFDirectSVComparison.java): a test SV
    is a true positive when a gold SV of the same type overlaps it with
    reciprocal overlap >= min_reciprocal."""

    def __init__(self, min_reciprocal: float = 0.5):
        self.min_reciprocal = min_reciprocal

    def compare(self, gold, test) -> SVComparisonStats:
        stats = SVComparisonStats(gold_total=len(gold), test_total=len(test))
        matched_gold: set[int] = set()
        for t in test:
            t_len = t.last - t.first + 1
            best = -1
            best_inter = 0
            for gi, g in enumerate(gold):
                if gi in matched_gold:
                    continue
                if g.sequence_name != t.sequence_name:
                    continue
                if getattr(g, "variant_type", None) != getattr(t, "variant_type", None):
                    continue
                inter = min(g.last, t.last) - max(g.first, t.first) + 1
                if inter <= 0:
                    continue
                g_len = g.last - g.first + 1
                if inter >= self.min_reciprocal * max(g_len, t_len):
                    if inter > best_inter:
                        best, best_inter = gi, inter
            if best >= 0:
                matched_gold.add(best)
                stats.true_positives += 1
                stats.intersection_bp += best_inter
            else:
                stats.false_positives += 1
        stats.false_negatives = stats.gold_total - len(matched_gold)
        return stats


class BiparentalHaploidGoldStandardBuilder:
    """Build a truth set from two haploid parental VCFs (ref:
    BiparentalHaploidGoldStandardBuilder.java): positions where both
    parents are confidently called and disagree are heterozygous truth
    variants of the F1; agreeing non-reference sites are homozygous-alt
    truth; everything else is confident reference."""

    def build(self, records_p1, records_p2):
        by_pos1 = {(r.variant.sequence_name, r.variant.first): r for r in records_p1}
        by_pos2 = {(r.variant.sequence_name, r.variant.first): r for r in records_p2}
        truth = []
        for key in sorted(set(by_pos1) | set(by_pos2)):
            r1 = by_pos1.get(key)
            r2 = by_pos2.get(key)
            a1 = self._allele(r1)
            a2 = self._allele(r2)
            if a1 is None and a2 is None:
                continue
            v = (r1 or r2).variant
            ref = v.alleles[0]
            al1 = a1 if a1 is not None else ref
            al2 = a2 if a2 is not None else ref
            if al1 == ref and al2 == ref:
                continue
            truth.append((key[0], key[1], ref, sorted({al1, al2})))
        return truth

    @staticmethod
    def _allele(rec):
        if rec is None or not rec.calls or rec.calls[0].is_undecided:
            return None
        call = rec.calls[0]
        idx = call.indexes_called_alleles[0] if call.indexes_called_alleles else 0
        return rec.variant.alleles[idx]


class GoldStandardGVCFBuilder:
    """Combine truth variants with confidently-covered reference regions
    into gVCF-style (variant + ref-block) records (ref:
    GoldStandardGVCFBuilder.java)."""

    def __init__(self, min_depth: int = 10):
        self.min_depth = min_depth

    def build(self, truth_records, covered_regions):
        """covered_regions: list of (seq, first, last) confidently-called
        reference spans; returns (variants, ref_blocks minus variant spans)."""
        out_blocks = []
        var_spans: dict[str, list[tuple[int, int]]] = {}
        for r in truth_records:
            v = r.variant
            var_spans.setdefault(v.sequence_name, []).append((v.first, v.last))
        for seq, first, last in covered_regions:
            spans = sorted(var_spans.get(seq, []))
            cur = first
            for f, l in spans:
                if l < cur or f > last:
                    continue
                if f > cur:
                    out_blocks.append((seq, cur, f - 1))
                cur = max(cur, l + 1)
            if cur <= last:
                out_blocks.append((seq, cur, last))
        return list(truth_records), out_blocks


class AssembliesAlignedTranscriptStatistics:
    """Transcript representation in an assembly (ref:
    AssembliesAlignedTranscriptStatistics.java): each transcript aligned
    to the assembly is complete (>=95% aligned in one piece), fragmented
    (aligned via multiple pieces), or missing."""

    def __init__(self, min_complete_fraction: float = 0.95):
        self.min_complete_fraction = min_complete_fraction
        self.complete = 0
        self.fragmented = 0
        self.missing = 0

    def process(self, transcript_alignments: dict[str, list[tuple[int, int]]],
                transcript_lengths: dict[str, int]) -> None:
        """transcript_alignments: tid -> list of (aligned_start, aligned_end)
        read-coordinate spans over the assembly."""
        for tid, length in transcript_lengths.items():
            spans = transcript_alignments.get(tid, [])
            if not spans:
                self.missing += 1
                continue
            best = max(e - s + 1 for s, e in spans)
            if best >= self.min_complete_fraction * length:
                self.complete += 1
            else:
                covered = set()
                for s, e in spans:
                    covered.update(range(s, e + 1))
                if len(covered) >= self.min_complete_fraction * length:
                    self.fragmented += 1
                else:
                    self.missing += 1
