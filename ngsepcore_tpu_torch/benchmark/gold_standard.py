"""Gold-standard VCF comparison: genotype-aware TP/FP/FN per quality bin.

Ref: src/ngsep/benchmark/VCFGoldStandardComparator.java:180-717 (command
`VCFGoldStandardComparator`) — classifies each test call against the gold
standard by position and genotype, accumulating TP/FP/FN per genotype
class (het / homo-alt) binned by genotype quality, and reports
precision/recall per minimum-quality threshold.  A copy of
ngsepcore_tpu/benchmark/gold_standard.py (host numpy).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..vcf.io import VCFRecord

N_BINS = 256  # quality bins 0..255


@dataclass
class ComparisonCounts:
    tp_het: np.ndarray = field(default_factory=lambda: np.zeros(N_BINS, np.int64))
    tp_hom: np.ndarray = field(default_factory=lambda: np.zeros(N_BINS, np.int64))
    fp_het: np.ndarray = field(default_factory=lambda: np.zeros(N_BINS, np.int64))
    fp_hom: np.ndarray = field(default_factory=lambda: np.zeros(N_BINS, np.int64))
    fn_het: int = 0
    fn_hom: int = 0
    genotype_errors: int = 0

    def stats_at(self, min_quality: int) -> dict:
        tp = int(self.tp_het[min_quality:].sum() + self.tp_hom[min_quality:].sum())
        fp = int(self.fp_het[min_quality:].sum() + self.fp_hom[min_quality:].sum())
        fn_from_low = int(
            self.tp_het[:min_quality].sum() + self.tp_hom[:min_quality].sum()
        )
        fn = self.fn_het + self.fn_hom + fn_from_low
        precision = tp / (tp + fp) if tp + fp else 0.0
        recall = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
        return {
            "tp": tp, "fp": fp, "fn": fn,
            "precision": precision, "recall": recall, "f1": f1,
        }


class VCFGoldStandardComparator:
    def __init__(self, position_tolerance: int = 0):
        self.position_tolerance = position_tolerance
        self.counts = ComparisonCounts()

    def compare(
        self, gold: list[VCFRecord], test: list[VCFRecord]
    ) -> ComparisonCounts:
        c = ComparisonCounts()
        gold_idx: dict[tuple[str, int], VCFRecord] = {}
        for r in gold:
            gold_idx[(r.variant.sequence_name, r.variant.first)] = r
        matched: set[tuple[str, int]] = set()
        for r in test:
            call = r.calls[0] if r.calls else None
            if call is None or call.is_undecided or call.is_homozygous_reference:
                continue
            q = min(255, max(0, call.genotype_quality))
            het = call.is_heterozygous
            key = self._match(gold_idx, r)
            if key is None:
                (c.fp_het if het else c.fp_hom)[q] += 1
                continue
            matched.add(key)
            g = gold_idx[key].calls[0]
            same_alleles = sorted(call.called_alleles()) == sorted(g.called_alleles())
            if same_alleles:
                (c.tp_het if het else c.tp_hom)[q] += 1
            else:
                c.genotype_errors += 1
                (c.fp_het if het else c.fp_hom)[q] += 1
        for key, r in gold_idx.items():
            if key in matched:
                continue
            g = r.calls[0] if r.calls else None
            if g is None or g.is_undecided or g.is_homozygous_reference:
                continue
            if g.is_heterozygous:
                c.fn_het += 1
            else:
                c.fn_hom += 1
        self.counts = c
        return c

    def _match(self, gold_idx, r) -> tuple[str, int] | None:
        name, pos = r.variant.sequence_name, r.variant.first
        if (name, pos) in gold_idx:
            return (name, pos)
        for d in range(1, self.position_tolerance + 1):
            for p in (pos - d, pos + d):
                if (name, p) in gold_idx:
                    return (name, p)
        return None

    def print_report(self, fh, thresholds=(0, 20, 40, 60, 80, 100)) -> None:
        fh.write("MinGQ\tTP\tFP\tFN\tPrecision\tRecall\tF1\n")
        for t in thresholds:
            s = self.counts.stats_at(t)
            fh.write(
                f"{t}\t{s['tp']}\t{s['fp']}\t{s['fn']}\t"
                f"{s['precision']:.4f}\t{s['recall']:.4f}\t{s['f1']:.4f}\n"
            )
        fh.write(f"Genotype errors\t{self.counts.genotype_errors}\n")
