"""Family-based and simulation-based quality statistics.

Ref: src/ngsep/benchmark/ —
- QualityStatisticsInbredBiparentalFamilies.java:25-205 (variants of an
  inbred biparental family classified by MAF/observed-heterozygosity into
  monomorphic / homozygous-contrast / other; parent and progeny genotype
  errors per category)
- QualityStatisticsOutbredF1Families.java (Mendelian consistency of F1
  progeny against two outbred parents)
- QualityStatisticsTetraploidF1Families.java (dosage consistency for
  tetraploid F1s)
- QualityStatisticsAlignmentSimulatedReads.java:38-110 (mapping accuracy
  against the position encoded in simulated read names)
- KmerBasedSwitchErrorsFinder.java (phasing switch errors vs truth)

A copy of ngsepcore_tpu/benchmark/quality_stats.py (host numpy).
"""
from __future__ import annotations

import numpy as np

from ..math.distribution import Distribution

GENOTYPE_UNDECIDED = -1
GENOTYPE_HOMOREF = 0
GENOTYPE_HETERO = 1
GENOTYPE_HOMOALT = 2


def _genotype(call) -> int:
    if call is None or call.is_undecided:
        return GENOTYPE_UNDECIDED
    if call.is_homozygous_reference:
        return GENOTYPE_HOMOREF
    if call.is_heterozygous:
        return GENOTYPE_HETERO
    return GENOTYPE_HOMOALT


class QualityStatisticsInbredBiparentalFamilies:
    """Port of QualityStatisticsInbredBiparentalFamilies (:25-205)."""

    def __init__(self, conservative: bool = False):
        self.conservative = conservative
        self.oh_dist = Distribution(0, 1, 0.01)
        self.maf_dist = Distribution(0, 0.51, 0.01)
        self.parent_errors = [0, 0, 0]
        self.progeny_errors = [0, 0, 0]
        self.vars_per_category = [0, 0, 0]
        self.datapoints_per_category = [0, 0, 0]
        self.total_vars = 0
        self.total_datapoints = 0

    def process(self, records, samples, parent1=None, parent2=None) -> None:
        idx1 = samples.index(parent1) if parent1 in (samples or []) else -1
        idx2 = samples.index(parent2) if parent2 in (samples or []) else -1
        for rec in records:
            v = rec.variant
            if len(v.alleles) != 2:
                continue
            calls = rec.calls
            n00 = n01 = n11 = n0 = n1 = n = nc = nc0 = nc1 = 0.0
            g_p1 = g_p2 = GENOTYPE_UNDECIDED
            for i, call in enumerate(calls):
                g = _genotype(call)
                if i == idx1:
                    g_p1 = g
                if i == idx2:
                    g_p2 = g
                if g == GENOTYPE_UNDECIDED:
                    continue
                is_parent = i in (idx1, idx2)
                nc += 1
                if not is_parent:
                    n += 1
                if g == GENOTYPE_HOMOREF:
                    nc0 += 2
                    if not is_parent:
                        n00 += 1
                        n0 += 2
                elif g == GENOTYPE_HETERO:
                    nc0 += 1
                    nc1 += 1
                    if not is_parent:
                        n01 += 1
                        n0 += 1
                        n1 += 1
                else:
                    nc1 += 2
                    if not is_parent:
                        n11 += 1
                        n1 += 2
            if n == 0:
                continue
            self.total_vars += 1
            self.total_datapoints += nc
            oh = n01 / n
            min_af = min(n0, n1)
            max_homo = GENOTYPE_HOMOREF if n00 >= n11 else GENOTYPE_HOMOALT
            maf = min_af / (n0 + n1) if (n0 + n1) > 0 else 0.0
            self.maf_dist.process_datapoint(maf)
            self.oh_dist.process_datapoint(oh)
            if maf < 0.1:
                if not self.conservative or (g_p1 == g_p2 == max_homo):
                    self.vars_per_category[0] += 1
                    self.datapoints_per_category[0] += nc
                    if g_p1 not in (GENOTYPE_UNDECIDED, max_homo):
                        self.parent_errors[0] += 1
                    if g_p2 not in (GENOTYPE_UNDECIDED, max_homo):
                        self.parent_errors[0] += 1
                    self.progeny_errors[0] += n01 + min(n00, n11)
            elif oh < 0.1:
                if not self.conservative or (
                    g_p1 != GENOTYPE_UNDECIDED
                    and g_p2 != GENOTYPE_UNDECIDED
                    and abs(g_p1 - g_p2) == 2
                ):
                    self.vars_per_category[1] += 1
                    self.datapoints_per_category[1] += nc
                    if g_p1 == GENOTYPE_HETERO:
                        self.parent_errors[1] += 1
                    if g_p2 == GENOTYPE_HETERO:
                        self.parent_errors[1] += 1
                    self.progeny_errors[1] += n01
                    if (
                        GENOTYPE_UNDECIDED not in (g_p1, g_p2)
                        and GENOTYPE_HETERO not in (g_p1, g_p2)
                        and g_p1 == g_p2
                    ):
                        self.parent_errors[1] += 1
            else:
                self.vars_per_category[2] += 1
                self.datapoints_per_category[2] += nc
                if g_p1 == GENOTYPE_HETERO:
                    self.parent_errors[2] += 1
                if g_p2 == GENOTYPE_HETERO:
                    self.parent_errors[2] += 1
                self.progeny_errors[2] += n01

    def print_statistics(self, out) -> None:
        line = f"SUMMARY COUNTS\t{self.total_vars}\t{self.total_datapoints:.0f}"
        for i in range(3):
            line += (
                f"\t{self.vars_per_category[i]}\t{self.datapoints_per_category[i]:.0f}"
                f"\t{self.parent_errors[i]}\t{self.progeny_errors[i]:.0f}"
            )
        print(line, file=out)
        print("MAF distribution", file=out)
        self.maf_dist.print_distribution(out)
        print("", file=out)
        print("Observed heterozygosity distribution", file=out)
        self.oh_dist.print_distribution(out)


class QualityStatisticsOutbredF1Families:
    """Mendelian consistency for an outbred F1 family (ref:
    QualityStatisticsOutbredF1Families.java): for each biallelic variant
    the progeny genotype set must be producible from the two parent
    genotypes; inconsistent datapoints count as errors."""

    _POSSIBLE = {
        (0, 0): {0},
        (0, 1): {0, 1},
        (1, 0): {0, 1},
        (0, 2): {1},
        (2, 0): {1},
        (1, 1): {0, 1, 2},
        (1, 2): {1, 2},
        (2, 1): {1, 2},
        (2, 2): {2},
    }

    def __init__(self):
        self.total_vars = 0
        self.inconsistent_datapoints = 0
        self.total_datapoints = 0

    def process(self, records, samples, parent1, parent2) -> None:
        idx1 = samples.index(parent1)
        idx2 = samples.index(parent2)
        for rec in records:
            if len(rec.variant.alleles) != 2:
                continue
            g1 = _genotype(rec.calls[idx1]) if idx1 < len(rec.calls) else -1
            g2 = _genotype(rec.calls[idx2]) if idx2 < len(rec.calls) else -1
            if g1 == GENOTYPE_UNDECIDED or g2 == GENOTYPE_UNDECIDED:
                continue
            allowed = self._POSSIBLE.get((g1, g2), {0, 1, 2})
            self.total_vars += 1
            for i, call in enumerate(rec.calls):
                if i in (idx1, idx2):
                    continue
                g = _genotype(call)
                if g == GENOTYPE_UNDECIDED:
                    continue
                self.total_datapoints += 1
                if g not in allowed:
                    self.inconsistent_datapoints += 1


class QualityStatisticsTetraploidF1Families:
    """MAF x minor-allele-dosage histogram for tetraploid F1s (ref:
    QualityStatisticsTetraploidF1Families.java:44-108): for each biallelic
    polymorphic site, row = round(100*MAF) (0..50) and each genotype call
    adds 1 to the column equal to its minor-allele copy number (0..4).
    Error interpretation happens by reading the histogram (e.g. OH<0.2
    rows should hold only dosage-0 calls)."""

    NUM_ROWS = 51

    def __init__(self):
        # rows: MAF percent bins; columns: minor-allele dosage 0..4
        self.counts_minor_allele_dosage = [
            [0] * 5 for _ in range(self.NUM_ROWS)
        ]

    def process(self, records, samples=None, parent1=None, parent2=None) -> None:
        from ..vcf.analytics import site_diversity

        for rec in records:
            if len(rec.variant.alleles) != 2:
                continue
            stats = site_diversity(rec)
            counts = stats.allele_counts
            total = sum(counts)
            if total == 0 or stats.n_alleles_called < 2:
                continue  # not polymorphic
            minor_idx = min(range(len(counts)), key=lambda i: counts[i])
            row = int(round(100 * stats.maf))
            if not (0 <= row < self.NUM_ROWS):
                continue
            for call in rec.calls:
                if call.is_undecided:
                    continue
                acn = call.allele_copy_numbers
                if acn and minor_idx < len(acn):
                    dosage = int(acn[minor_idx])
                else:
                    # derive dosage from called alleles at ploidy 4
                    idxs = call.indexes_called_alleles
                    if not idxs:
                        continue
                    if len(idxs) == 1:
                        dosage = 4 if idxs[0] == minor_idx else 0
                    else:
                        dosage = 2 if minor_idx in idxs else 0
                if 0 <= dosage <= 4:
                    self.counts_minor_allele_dosage[row][dosage] += 1

    def print_statistics(self, out) -> None:
        print(
            "MAF\tHomozygous major\tMinor1\tMinor2\tMinor3\tHomozygous minor",
            file=out,
        )
        for i, row in enumerate(self.counts_minor_allele_dosage):
            print(
                f"{i / 100.0}\t" + "\t".join(str(c) for c in row), file=out
            )


class QualityStatisticsAlignmentSimulatedReads:
    """Mapping accuracy vs simulated truth (ref:
    QualityStatisticsAlignmentSimulatedReads.java:38-110).  Read names
    encode `..._start_end_...`; an alignment is correct when its start is
    within 5 bp of the expected start."""

    def __init__(self, min_alignment_quality: int = 20):
        self.min_alignment_quality = min_alignment_quality
        self.aligned_reads = 0
        self.unaligned_reads = 0
        self.aligned_reads_pass_mq = 0
        self.aligned_reads_below_mq = 0
        self.correct = 0
        self.squared_error = 0.0
        self.proper_pairs = 0

    def process(self, alignments) -> None:
        for aln in alignments:
            if aln.is_secondary:
                continue
            if aln.is_unmapped:
                self.unaligned_reads += 1
                continue
            self.aligned_reads += 1
            if aln.is_proper_pair:
                self.proper_pairs += 1
            if aln.alignment_quality < self.min_alignment_quality:
                self.aligned_reads_below_mq += 1
                continue
            self.aligned_reads_pass_mq += 1
            items = aln.read_name.split("_")
            nums = [int(x) for x in items if x.lstrip("-").isdigit()]
            if not nums:
                continue
            read_len = aln.read_length
            expected = nums[0]
            diff = expected - aln.first
            if abs(diff) <= 2 * read_len:
                self.squared_error += diff * diff
                if abs(diff) <= 5:
                    self.correct += 1

    def stats(self) -> dict:
        n = max(self.aligned_reads_pass_mq, 1)
        return {
            "aligned": self.aligned_reads,
            "unaligned": self.unaligned_reads,
            "pass_mq": self.aligned_reads_pass_mq,
            "below_mq": self.aligned_reads_below_mq,
            "correct": self.correct,
            "accuracy": self.correct / n,
            "rmse": float(np.sqrt(self.squared_error / n)),
            "proper_pairs": self.proper_pairs,
        }


class KmerBasedSwitchErrorsFinder:
    """Phasing switch errors between inferred and truth haplotypes (ref:
    KmerBasedSwitchErrorsFinder.java).  At each consecutive pair of phased
    het sites, the inferred phase either preserves or switches the truth
    linkage; every change of orientation is one switch error."""

    def count_switch_errors(
        self, inferred: np.ndarray, truth: np.ndarray
    ) -> tuple[int, int]:
        """inferred/truth: (V,) 0/1 allele of haplotype 0 per phased het
        site (same site order).  Returns (switches, comparisons)."""
        orient = np.where(inferred == truth, 0, 1)
        if len(orient) < 2:
            return 0, 0
        switches = int((np.diff(orient) != 0).sum())
        return switches, len(orient) - 1


class VCFAddADGTField:
    """Derive the standard AD (allele depth) FORMAT field from NGSEP's
    BSDP/ACN count vectors (ref: VCFAddADGTField.java:20-70)."""

    def transform(self, records) -> None:
        for rec in records:
            for call in rec.calls:
                if call is None:
                    continue
                if getattr(call, "allele_depths", None):
                    continue
                acgt = getattr(call, "acgt_depths", None)
                if acgt:
                    bases = "ACGT"
                    call.allele_depths = [
                        int(acgt[bases.index(a)]) if len(a) == 1 and a in bases else 0
                        for a in rec.variant.alleles
                    ]
