"""Coverage and per-read-position quality statistics.

Ref: src/ngsep/discovery/CoverageStatisticsCalculator.java (command
`CoverageStats`: genome-wide coverage histogram) and
src/ngsep/alignments/BasePairQualityStatisticsCalculator.java (command
`BasePairQualStats`: per-read-position mismatch rates vs the genome).

Host numpy, as in the JAX package: coverage accumulates with one bincount over expanded
alignment positions; per-position mismatch rates come from the same dense
(ref_pos, read_idx) expansion compared against gathered reference bases.
"""
from __future__ import annotations

import numpy as np

from ..align.read_alignment import ReadAlignment
from ..core.genome import ReferenceGenome
from ..core.sequences import encode_dna
from ..math.distribution import Distribution
from .pileup import expand_alignment_calls


class CoverageStatisticsCalculator:
    def __init__(self, genome: ReferenceGenome, max_coverage: int = 500):
        self.genome = genome
        self.max_coverage = max_coverage
        self._per_seq: dict[str, np.ndarray] = {}

    def process_alignments(self, alns: list[ReadAlignment]) -> None:
        for a in alns:
            if a.is_unmapped:
                continue
            cov = self._per_seq.get(a.sequence_name)
            if cov is None:
                idx = self.genome.index_of(a.sequence_name)
                if idx < 0:
                    continue
                cov = np.zeros(self.genome.sequence_length(idx), np.int32)
                self._per_seq[a.sequence_name] = cov
            rp, _, _, _ = expand_alignment_calls(a)
            np.add.at(cov, rp - 1, 1)

    def coverage_distribution(self) -> Distribution:
        d = Distribution(0, self.max_coverage, 1)
        for si in range(self.genome.num_sequences):
            name = self.genome.sequence_name(si)
            cov = self._per_seq.get(name)
            if cov is None:
                cov = np.zeros(self.genome.sequence_length(si), np.int32)
            d.process_array(cov.astype(np.float64))
        return d

    def print_report(self, fh) -> None:
        d = self.coverage_distribution()
        fh.write("Coverage\tCount\n")
        d.print_distribution(fh)
        fh.write(f"Average\t{d.average:.4f}\n")
        fh.write(f"StdDev\t{d.std_dev:.4f}\n")


class BasePairQualityStatisticsCalculator:
    """Per-read-position mismatch rate vs the reference genome."""

    def __init__(self, genome: ReferenceGenome, read_length: int = 500):
        self.genome = genome
        self.mismatches = np.zeros(read_length, np.int64)
        self.totals = np.zeros(read_length, np.int64)

    def process_alignments(self, alns: list[ReadAlignment]) -> None:
        for a in alns:
            if a.is_unmapped or not a.read_chars:
                continue
            seq_idx = self.genome.index_of(a.sequence_name)
            if seq_idx < 0:
                continue
            rp, codes, _, _ = expand_alignment_calls(a)
            if len(rp) == 0:
                continue
            off = int(self.genome.offsets[seq_idx])
            ref = self.genome.concat[off + rp - 1]
            read_codes = encode_dna(a.read_chars)
            # read position index per call (5' orientation of the original read)
            # reconstruct read indexes by re-walking the cigar
            ridx = []
            r = 0
            for l, op in a.cigar:
                if op in "M=X":
                    ridx.append(np.arange(r, r + l))
                    r += l
                elif op in "IS":
                    r += l
            ridx = np.concatenate(ridx) if ridx else np.empty(0, int)
            if a.is_negative_strand:
                ridx = len(read_codes) - 1 - ridx
            mism = codes != ref
            L = len(self.totals)
            ok = ridx < L
            np.add.at(self.totals, ridx[ok], 1)
            np.add.at(self.mismatches, ridx[ok], mism[ok])

    def print_report(self, fh) -> None:
        fh.write("Position\tTotal\tMismatches\tRate\n")
        for i in range(len(self.totals)):
            if self.totals[i] == 0:
                continue
            rate = self.mismatches[i] / self.totals[i]
            fh.write(f"{i + 1}\t{self.totals[i]}\t{self.mismatches[i]}\t{rate:.6f}\n")
