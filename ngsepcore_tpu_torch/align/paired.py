"""Paired-end alignment orchestration.

Ref: src/ngsep/alignments/PairedReadsAligner.java:83-335 — align both ends,
pair candidates on the same subject with proper F/R orientation and insert
length within [minInsertLength, maxInsertLength] (defaults 0/1000,
ReadsAligner.java:64-65), preferring the insert closest to the middle of
the range (:330-345 pickBestPairPosition); halve the mapping quality of
>=50-quality alignments whose mate is unmapped (:115-117).
"""
from __future__ import annotations



from ..core.sequences import RawRead
from .read_alignment import (
    FLAG_FIRST_OF_PAIR,
    FLAG_MATE_REVERSE,
    FLAG_MATE_UNMAPPED,
    FLAG_PAIRED,
    FLAG_PROPER,
    FLAG_SECOND_OF_PAIR,
    ReadAlignment,
)
from .reads_aligner import ReadsAligner

DEF_MIN_INSERT_LENGTH = 0  # ref: ReadsAligner.java:64
DEF_MAX_INSERT_LENGTH = 1000  # ref: ReadsAligner.java:65


class PairedReadsAligner:
    def __init__(
        self,
        aligner: ReadsAligner,
        min_insert_length: int = DEF_MIN_INSERT_LENGTH,
        max_insert_length: int = DEF_MAX_INSERT_LENGTH,
    ):
        self.aligner = aligner
        self.min_insert_length = min_insert_length
        self.max_insert_length = max_insert_length
        self.proper_pairs = 0
        self.pairs = 0

    # ------------------------------------------------------------------
    def align_batch(
        self, reads1: list[RawRead], reads2: list[RawRead]
    ) -> list[list[ReadAlignment]]:
        """Returns one alignment list per pair (both ends' records)."""
        assert len(reads1) == len(reads2)
        saved_cap = self.aligner.max_alns_per_read
        self.aligner.max_alns_per_read = max(3, saved_cap)
        try:
            alns_all = self.aligner.align_batch(reads1 + reads2)
        finally:
            self.aligner.max_alns_per_read = saved_cap
        n = len(reads1)
        out: list[list[ReadAlignment]] = []
        for i in range(n):
            self.pairs += 1
            out.append(
                self._pair(reads1[i], reads2[i], alns_all[i], alns_all[n + i])
            )
        return out

    # ------------------------------------------------------------------
    def _pair(self, read1, read2, alns1, alns2) -> list[ReadAlignment]:
        best = None
        best_score = None
        mid = (self.max_insert_length + self.min_insert_length) / 2
        for a1 in alns1:
            for a2 in alns2:
                ins = self._insert_length(a1, a2)
                if ins is None:
                    continue
                score = (
                    a1.alignment_quality + a2.alignment_quality,
                    -abs(ins - mid),
                )
                if best_score is None or score > best_score:
                    best_score = score
                    best = (a1, a2, ins)
        if best is not None:
            a1, a2, ins = best
            self.proper_pairs += 1
            for a, first in ((a1, True), (a2, False)):
                a.flags |= FLAG_PAIRED | FLAG_PROPER
                a.flags |= FLAG_FIRST_OF_PAIR if first else FLAG_SECOND_OF_PAIR
                a.set_secondary(False)
            self._set_mate_info(a1, a2)
            self._set_mate_info(a2, a1)
            sign = 1 if a1.first <= a2.first else -1
            a1.inferred_insert_size = sign * ins
            a2.inferred_insert_size = -sign * ins
            return [a1, a2]
        # no proper pair: emit best single records with mate info
        out = []
        b1 = alns1[0] if alns1 else None
        b2 = alns2[0] if alns2 else None
        for a, mate, first in ((b1, b2, True), (b2, b1, False)):
            if a is None:
                continue
            a.flags |= FLAG_PAIRED
            a.flags |= FLAG_FIRST_OF_PAIR if first else FLAG_SECOND_OF_PAIR
            if mate is None:
                a.flags |= FLAG_MATE_UNMAPPED
                if a.alignment_quality >= 50:
                    a.alignment_quality = int(round(0.5 * a.alignment_quality))
            else:
                self._set_mate_info(a, mate)
            out.append(a)
        return out

    # ------------------------------------------------------------------
    def _insert_length(self, a1: ReadAlignment, a2: ReadAlignment) -> int | None:
        """Valid proper-pair insert length or None (ref: isValidPair:318-335)."""
        if a1.sequence_name != a2.sequence_name:
            return None
        r1, r2 = a1.is_negative_strand, a2.is_negative_strand
        if a1.first < a2.last:
            insert = a2.last - a1.first + 1
            proper = (not r1) and r2
        else:
            insert = a1.last - a2.first + 1
            proper = (not r2) and r1
        if not proper:
            return None
        if not (self.min_insert_length <= insert <= self.max_insert_length):
            return None
        return insert

    @staticmethod
    def _set_mate_info(a: ReadAlignment, mate: ReadAlignment) -> None:
        a.mate_sequence_name = mate.sequence_name
        a.mate_first = mate.first
        if mate.is_negative_strand:
            a.flags |= FLAG_MATE_REVERSE
