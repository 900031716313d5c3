"""Indel realignment across reads spanning the same event.

Ref: src/ngsep/discovery/IndelRealignerPileupListener.java:85-579.  The
reference runs as pileup listener #1: at each position it predicts the
indel-event span from the spanning reads' CIGARs, votes for a consistent
event start, moves each read's indel to the winning start
(moveIndelStarts:274), detects new short tandem repeats from
mono-nucleotide runs (checkMonoNucleotide:345-380), and trims read ends
that land inside an event without enough anchoring bases
(processEndsOfAlignments:420-530).

TPU redesign: realignment is a sparse host-side pass — indel sites are
rare (~1e-3/bp), so instead of firing a listener at every reference
position we scan only the sorted indel-event positions, mutate the
affected CIGARs in place, and emit the conciliated event sites that the
device genotyping pass consumes.  Dense per-base work stays on device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..align.read_alignment import ReadAlignment

MIN_BP_GOOD_REF_ALN = 5  # ref: minBPForGoodRefAln (IndelRealignerPileupListener.java:46)


@dataclass
class IndelSite:
    """A conciliated indel event: genotype as a spanning call over
    [first, first+span-1]."""

    first: int  # last reference base before the event (1-based)
    span: int  # reference span of the spanning call
    is_str: bool = False
    is_new_str: bool = False


def check_mono_nucleotide(seq: str) -> int:
    """Length of a mono-nucleotide run (>=5bp, at most one off-base) at the
    start of seq — ref: checkMonoNucleotide (IndelRealignerPileupListener
    .java:352-378)."""
    bases = "ACGT"
    counts = [0, 0, 0, 0]
    min_length = 5
    n = len(seq)
    i = 0
    while i < n and i < min_length:
        j = bases.find(seq[i])
        if j >= 0:
            counts[j] += 1
        i += 1
    base_idx = -1
    for j in range(4):
        if counts[j] >= i - 1:
            base_idx = j
            break
    if base_idx == -1 or i < min_length:
        return 0
    while i < n and counts[base_idx] >= i - 1:
        j = bases.find(seq[i])
        if j >= 0:
            counts[j] += 1
        i += 1
    i -= 1
    if i >= 1 and bases.find(seq[i - 1]) != base_idx:
        return i - 1
    return i


def check_tandem_repeat(seq: str) -> int:
    """Mono-nucleotide check only: the reference's dinucleotide check is an
    unimplemented stub returning 0 (checkDinucleotide:380-383)."""
    return check_mono_nucleotide(seq.upper())


class IndelRealigner:
    """Conciliates indel placements across the alignments of one reference
    sequence and returns the event sites to genotype as spanning calls."""

    def __init__(self, genome, seq_idx: int, known_strs=None):
        self.genome = genome
        self.seq_idx = seq_idx
        self.seq_name = genome.sequence_name(seq_idx)
        self.seq_len = genome.sequence_length(seq_idx)
        # known STR/variant regions to genotype at fixed spans
        self.known_strs = sorted(known_strs or [], key=lambda r: r.first)
        # optional registry of gapless device-path reads spanning indel
        # neighborhoods (fused_pipeline._ArrayReads); they never vote but
        # their ends are trimmed exactly like host objects
        self.array_reads = None

    # ------------------------------------------------------------------
    def realign(
        self, alns: list[ReadAlignment], array_reads=None
    ) -> list[IndelSite]:
        """Mutates `alns` (CIGARs moved, end bases marked to ignore) and
        returns conciliated indel sites sorted by position.  `array_reads`
        optionally carries gapless device-path reads whose end-trims are
        applied through the registry instead of object mutation."""
        self.array_reads = array_reads
        # alignments sorted by start; index by interval for spanning queries
        firsts = np.array([a.first for a in alns], dtype=np.int64)
        lasts = np.array([a.last for a in alns], dtype=np.int64)
        order = np.argsort(firsts, kind="stable")
        firsts_s = firsts[order]
        max_span = int((lasts - firsts).max() + 1) if len(alns) else 0

        def spanning(first: int, last: int) -> list[ReadAlignment]:
            """Alignments overlapping [first,last] (pileup membership).
            Only starts within one max read span can overlap, so the scan
            is O(coverage), not O(all alignments left of the site)."""
            lo = np.searchsorted(firsts_s, first - max_span, side="left")
            hi = np.searchsorted(firsts_s, last, side="right")
            out = []
            for oi in order[lo:hi]:
                a = alns[oi]
                if a.last >= first:
                    out.append(a)
            return out

        sites: list[IndelSite] = []
        # candidate positions: all indel-call starts (re-checked after moves)
        pending = sorted({c[0] for a in alns for c in a.indel_calls()})
        # fixed sites from known STRs (ref: intersectWithVariants + STR spans)
        known_firsts = {r.first: r for r in self.known_strs}
        processed: set[int] = set()
        qi = 0
        while qi < len(pending):
            pos = pending[qi]
            qi += 1
            if pos in processed or pos < 1:
                continue
            processed.add(pos)
            region = spanning(pos, pos)
            # event span prediction (onPileup:100-118)
            max_len = 0
            max_ispan = 0
            for a in region:
                c = a.indel_call_at(pos)
                if c is not None:
                    max_len = max(max_len, c[2])
                    max_ispan = max(max_ispan, c[1] - c[0] + 1)
            if max_len == 0:
                continue
            event_end = pos + max(max_len, max_ispan) + 1
            new_sites, moved_to = self._conciliate(pos, event_end, region)
            sites.extend(new_sites)
            if moved_to is not None and moved_to not in processed:
                # indels moved to a later start: revisit that position
                import bisect

                bisect.insort(pending, moved_to)
        # known STR regions become fixed sites even with no indel evidence
        for r in self.known_strs:
            f = r.first - 1
            if not any(s.first == f for s in sites):
                sites.append(IndelSite(first=f, span=r.last - r.first + 3, is_str=True))
            else:
                for s in sites:
                    if s.first == f:
                        s.is_str = True
                        s.span = max(s.span, r.last - r.first + 3)
        sites.sort(key=lambda s: s.first)
        # drop sites fully inside an earlier site's span (lastIndelEnd logic)
        out: list[IndelSite] = []
        last_end = 0
        for s in sites:
            if s.first <= last_end:
                continue
            out.append(s)
            last_end = s.first + s.span - 1
        return out

    # ------------------------------------------------------------------
    def _conciliate(
        self, pos: int, event_end: int, region: list[ReadAlignment]
    ) -> tuple[list[IndelSite], int | None]:
        """conciliateIndels (:165-220): vote for the consensus event start,
        move reads' indels there, detect new STRs, trim read ends."""
        lengths: set[int] = set()
        indel_alns: list[tuple[ReadAlignment, tuple[int, int, int]]] = []
        votes = np.zeros(event_end - pos + 1, dtype=np.int64)
        for a in region:
            for c in a.indel_calls():
                if c[1] >= pos and c[0] <= event_end:
                    lengths.add(c[2])
                    i = c[0] - pos
                    if 0 <= i < len(votes):
                        votes[i] += 1
                    indel_alns.append((a, c))
                    break
        if not lengths:
            return [], None
        max_length = max(lengths)
        max_i = int(np.argmax(votes))
        is_str = False
        new_str = False
        span = 0
        fixed = False
        if len(lengths) > 1:
            new_span = self._look_for_new_str(pos, indel_alns, max_length)
            if new_span > 1:
                max_i = 0
                span = new_span
                event_end = pos + span - 1
                fixed = True
                is_str = new_str = True
        # move indel starts to the winning position (moveIndelStarts:274)
        new_event_end = pos + 1
        for a, c in indel_alns:
            a.move_indel_start(c[0], pos + max_i)
            # recompute this read's furthest related indel end
            aln_ref_last = pos
            for c2 in a.indel_calls():
                if pos <= c2[0] <= aln_ref_last + max_length:
                    aln_ref_last = c2[1]
            new_event_end = max(new_event_end, aln_ref_last)
        if max_i > 0:
            # event re-starts later; revisit at the moved position
            return [], pos + max_i
        if not fixed and new_event_end != event_end:
            event_end = new_event_end
            span = event_end - pos + 1
        if span == 0:
            span = event_end - pos + 1
        self._trim_ends(region, pos, event_end)
        if self.array_reads is not None:
            self.array_reads.trim(pos, event_end)
        return [IndelSite(first=pos, span=span, is_str=is_str, is_new_str=new_str)], None

    # ------------------------------------------------------------------
    def _look_for_new_str(self, pos: int, indel_alns, max_length: int) -> int:
        """lookForNewSTR (:315-350): tandem run in the reference right after
        the event, else in a read carrying the longest indel."""
        if not indel_alns:
            return 0
        last = max(a.last for a, _ in indel_alns)
        if pos + 1 <= self.seq_len:
            ref = self.genome.reference_string(
                self.seq_idx, pos + 1, min(last, self.seq_len)
            )
            length_ref = check_tandem_repeat(ref)
            if length_ref > 0:
                return length_ref + 2
        for a, c in indel_alns:
            if c[2] != max_length or c[0] != pos:
                continue
            read_first = a.read_position_at(pos)
            if read_first < 0:
                continue
            length_tr = check_tandem_repeat(a.read_chars[read_first + 1 :])
            if length_tr > 0:
                ispan = c[1] - c[0] + 1
                if c[2] >= ispan:
                    return c[2] + 2
                return length_tr + ispan
        return 0

    # ------------------------------------------------------------------
    def _trim_ends(self, region: list[ReadAlignment], first: int, last: int) -> None:
        """processEndsOfAlignments (:420-530), trim branch: reads whose
        alignment starts/ends inside the event without MIN_BP_GOOD_REF_ALN
        anchoring bases get their in-event bases excluded from pileups."""
        for a in region:
            has_before = a.has_indel_calls(a.first, first - 1)
            has_after = a.has_indel_calls(last + 1, a.last)
            if first - a.first < MIN_BP_GOOD_REF_ALN and not has_before:
                ignore = last - a.first + 1 + a.soft_clip_start
                a.bases_to_ignore_start = max(a.bases_to_ignore_start, ignore)
            if a.last - last < MIN_BP_GOOD_REF_ALN and not has_after:
                ignore = a.last - first + 1 + a.soft_clip_end
                a.bases_to_ignore_end = max(a.bases_to_ignore_end, ignore)
