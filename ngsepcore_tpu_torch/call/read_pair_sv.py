"""Read-pair structural variant detection.

Ref: src/ngsep/discovery/ReadPairAnalyzer.java:155-196 (`findVariants`
step order: insert-length distributions per read group -> distribute
abnormal pairs -> deletions -> insertions -> SPLIT-READ indels
(analyzeSplitReads:678-784: breakpoint refinement of the pair-derived
events + new indels from partial alignments alone) -> inversions ->
coordinate sort).

Vectorized: insert lengths of all proper-orientation pairs in one array;
abnormal pairs cluster by position into candidate SV intervals; split-read
tail seeds search the local reference with numpy sliding-window compares.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..align.read_alignment import ReadAlignment
from ..variants.model import (
    CalledGenomicVariant,
    TYPE_INVERSION,
    TYPE_LARGEDEL,
    TYPE_LARGEINS,
)

DEF_MAX_LEN_DELETION = 1_000_000  # ref: ReadPairAnalyzer.DEF_MAX_LEN_DELETION
SPLIT_READ_SEED = 8  # ref: ReadPairAnalyzer.DEF_SPLIT_READ_SEED


@dataclass
class InsertStats:
    mean: float
    std: float


def insert_length_stats(alns: list[ReadAlignment]) -> InsertStats:
    lens = np.array(
        [
            abs(a.inferred_insert_size)
            for a in alns
            if a.is_proper_pair and a.inferred_insert_size > 0
        ],
        np.float64,
    )
    if len(lens) < 10:
        return InsertStats(0.0, 0.0)
    med = np.median(lens)
    keep = lens[np.abs(lens - med) < 5 * max(1.0, np.std(lens))]
    return InsertStats(float(np.mean(keep)), float(np.std(keep)))


class ReadPairAnalyzer:
    def __init__(
        self,
        n_std: float = 5.0,
        min_pairs: int = 4,
        genome=None,
        seed_size: int = SPLIT_READ_SEED,
        min_split_reads: int = 3,
    ):
        self.n_std = n_std
        self.min_pairs = min_pairs
        self.genome = genome  # enables the split-read step
        self.seed_size = seed_size
        self.min_split_reads = min_split_reads

    def find_variants(self, alns: list[ReadAlignment]) -> list[CalledGenomicVariant]:
        stats = insert_length_stats(alns)
        if stats.mean <= 0 and self.genome is None:
            return []
        out: list[CalledGenomicVariant] = []
        if stats.mean <= 0:
            # single-end data: split-read indels are still detectable
            out = self.analyze_split_reads(alns, [])
            out.sort(key=lambda c: (c.sequence_name, c.first))
            return out
        threshold_high = stats.mean + self.n_std * max(stats.std, 10.0)
        threshold_low = max(0.0, stats.mean - self.n_std * max(stats.std, 10.0))
        # first-of-pair records carry the pair info once
        pairs = [
            a
            for a in alns
            if a.is_paired
            and a.flags & 64  # first of pair
            and a.mate_sequence_name == a.sequence_name
            and not a.is_unmapped
        ]
        long_pairs = []  # deletion signal
        short_pairs = []  # insertion signal
        inverted = []  # inversion signal: same-strand mates
        for a in pairs:
            ins = abs(a.inferred_insert_size) if a.inferred_insert_size else abs(
                a.mate_first - a.first
            )
            same_strand = bool(a.flags & 16) == bool(a.flags & 32)
            if same_strand:
                inverted.append(a)
            elif ins > threshold_high and ins < DEF_MAX_LEN_DELETION:
                long_pairs.append((a, ins))
            elif ins < threshold_low and ins > 0:
                short_pairs.append((a, ins))
        out.extend(
            self._cluster(long_pairs, TYPE_LARGEDEL, stats)
        )
        out.extend(self._cluster(short_pairs, TYPE_LARGEINS, stats))
        # split-read step between insertions and inversions (ref order,
        # ReadPairAnalyzer.findVariants:170-178): refine breakpoints of
        # the pair-derived indels and find new indels from split reads
        if self.genome is not None:
            out.extend(self.analyze_split_reads(alns, list(out)))
        out.extend(self._cluster([(a, 0) for a in inverted], TYPE_INVERSION, stats))
        out.sort(key=lambda c: (c.sequence_name, c.first))
        return out

    # ------------------------------------------------------------------
    # split-read analysis (ref: analyzeSplitReads:678-784,
    # findBreakpoint:844-908, align seeds :917-1008)
    # ------------------------------------------------------------------
    def _partial_alignments(self, alns: list[ReadAlignment]):
        """Partial (soft-clipped) unique primary alignments — the split-
        read signal (ref isPartialAlignment(2*seedSize+1) gate :769)."""
        min_clip = 2 * self.seed_size + 1
        out = []
        for a in alns:
            if a.is_unmapped or a.is_secondary:
                continue
            cig = a.cigar
            if not cig:
                continue
            left = cig[0][0] if cig[0][1] == "S" else 0
            right = cig[-1][0] if cig[-1][1] == "S" else 0
            if max(left, right) >= min_clip:
                out.append((a, left, right))
        return out

    def analyze_split_reads(
        self, alns: list[ReadAlignment], events: list[CalledGenomicVariant]
    ) -> list[CalledGenomicVariant]:
        """Refine existing DEL/INS breakpoints with split reads, then call
        NEW indels supported only by split reads."""
        partials = self._partial_alignments(alns)
        if not partials:
            return []
        # --- breakpoint refinement of pair-derived events ---------------
        ev_by_seq: dict[str, list[CalledGenomicVariant]] = {}
        for ev in events:
            if ev.variant_type in (TYPE_LARGEDEL, TYPE_LARGEINS):
                ev_by_seq.setdefault(ev.sequence_name, []).append(ev)
        in_event = set()
        for i, (a, lclip, rclip) in enumerate(partials):
            for ev in ev_by_seq.get(a.sequence_name, []):
                if a.first - 100 <= ev.last and ev.first <= a.last + 100:
                    in_event.add(i)
        for seq, evs in ev_by_seq.items():
            cands = [
                partials[i]
                for i in in_event
                if partials[i][0].sequence_name == seq
            ]
            for ev in evs:
                self._refine_breakpoint(ev, cands)
        # --- new indels from split reads outside any event --------------
        free = [p for i, p in enumerate(partials) if i not in in_event]
        return self._split_read_indels(free)

    def _seq_codes(self, name: str):
        g = self.genome
        return g.sequences[g.index_of(name)].codes

    @staticmethod
    def _find_seed(hay: np.ndarray, needle: np.ndarray) -> int:
        """First exact match offset of `needle` in `hay` (-1 if absent)."""
        n, m = len(hay), len(needle)
        if m == 0 or n < m:
            return -1
        win = np.lib.stride_tricks.sliding_window_view(hay, m)
        hit = np.nonzero((win == needle).all(axis=1))[0]
        return int(hit[0]) if len(hit) else -1

    def _refine_breakpoint(self, ev, cands) -> None:
        """Tighten the event span using split reads whose clipped tails
        relocate across the event (ref findBreakpoint:844-908: the split
        alignment's left-side end and right-side start become the new
        event limits; numSplitReads recorded)."""
        n_split = 0
        new_first, new_last = ev.first, ev.last
        for a, lclip, rclip in cands:
            res = self._split_read_candidate(a, lclip, rclip)
            if res is None:
                continue
            kind, first, last, _length = res
            if kind != ("DEL" if ev.variant_type == TYPE_LARGEDEL else "INS"):
                continue
            if not (ev.first - 150 <= first <= ev.last + 150):
                continue
            n_split += 1
            new_first, new_last = first, max(first + 1, last)
        if n_split:
            ev.first = new_first
            ev.last_ = new_last
            ev.total_read_depth += n_split
            ev.genotype_quality = min(255, ev.genotype_quality + 10 * n_split)
            ev.quality = ev.genotype_quality

    def _split_read_candidate(self, a, lclip, rclip):
        """One partial alignment -> (kind, first, last, length) or None.

        The clipped tail reseeds against the local reference downstream
        (right clips) or upstream (left clips); a relocated match means a
        deletion of the skipped span, a tail whose seed lands back at the
        breakpoint after skipping novel bases means an insertion."""
        seed = self.seed_size
        codes = getattr(a, "_read_codes", None)
        if codes is None or a.read_chars is None:
            return None
        codes = np.asarray(codes)
        seq = self._seq_codes(a.sequence_name)
        window = 2000
        if rclip >= 2 * seed + 1:
            tail = codes[len(codes) - rclip :]
            e = a.last  # 1-based last aligned reference position
            hay = seq[e : min(len(seq), e + window)]
            off = self._find_seed(hay, tail[5 : 5 + seed])
            if off >= 0:
                d = off - 5  # deletion length implied by the relocation
                if d >= 10:
                    return ("DEL", e + 1, e + d, d)
                if d <= -1:
                    return None
            # insertion: the END of the tail maps right after the
            # breakpoint, the head of the tail is novel sequence
            last_seed = tail[-seed:]
            off2 = self._find_seed(hay, last_seed)
            if off2 >= 0:
                ins_len = rclip - (off2 + seed)
                if ins_len >= 10:
                    return ("INS", e, e + 1, ins_len)
            return None
        if lclip >= 2 * seed + 1:
            head = codes[:lclip]
            s0 = a.first - 1  # 0-based first aligned position
            lo = max(0, s0 - window)
            hay = seq[lo:s0]
            # seed near the head start; unbroken it sits at s0 - lclip + 5
            off = self._find_seed(hay, head[5 : 5 + seed])
            if off >= 0:
                m = lo + off  # actual 0-based seed position
                d = (s0 - lclip + 5) - m  # deletion length implied
                if d >= 10:
                    # head occupies [m-5, m-5+lclip); deletion follows it
                    first0 = m - 5 + lclip  # 0-based deletion start
                    return ("DEL", first0 + 1, s0, d)
            return None
        return None

    def _split_read_indels(self, free) -> list[CalledGenomicVariant]:
        """Cluster split-read candidates into NEW indel calls (ref
        buildSplitReadIndels; support >= min_split_reads)."""
        cands: dict[str, list] = {}
        for a, lclip, rclip in free:
            res = self._split_read_candidate(a, lclip, rclip)
            if res is None:
                continue
            cands.setdefault(a.sequence_name, []).append(res)
        out = []
        for seq, items in cands.items():
            items.sort(key=lambda r: r[1])
            cluster: list = []
            for it in items:
                if cluster and (
                    it[0] != cluster[-1][0] or it[1] - cluster[-1][1] > 20
                ):
                    out.extend(self._emit_split_cluster(seq, cluster))
                    cluster = []
                cluster.append(it)
            out.extend(self._emit_split_cluster(seq, cluster))
        return out

    def _emit_split_cluster(self, seq, cluster) -> list[CalledGenomicVariant]:
        if len(cluster) < self.min_split_reads:
            return []
        kind = cluster[0][0]
        firsts = np.array([c[1] for c in cluster])
        lasts = np.array([c[2] for c in cluster])
        first = int(np.median(firsts))
        last = int(np.median(lasts))
        call = CalledGenomicVariant(
            sequence_name=seq,
            first=first,
            alleles=["N"],
            variant_type=TYPE_LARGEDEL if kind == "DEL" else TYPE_LARGEINS,
            quality=min(255, 10 * len(cluster)),
            last_=max(first + 1, last),
            genotype_quality=min(255, 10 * len(cluster)),
            total_read_depth=len(cluster),
            indexes_called_alleles=[0],
        )
        return [call]

    def _cluster(self, pairs, vtype, stats) -> list[CalledGenomicVariant]:
        """Group supporting pairs by predicted event interval."""
        if len(pairs) < self.min_pairs:
            return []
        by_seq: dict[str, list] = {}
        for a, ins in pairs:
            by_seq.setdefault(a.sequence_name, []).append((a, ins))
        out = []
        for seq, items in by_seq.items():
            # event interval per pair: inside the pair's gap
            intervals = []
            for a, ins in items:
                left = min(a.last, a.mate_first)
                right = max(a.first, a.mate_first)
                intervals.append((left + 1, max(left + 2, right - 1), ins))
            intervals.sort()
            cluster: list[tuple[int, int, int]] = []
            for iv in intervals:
                if cluster and iv[0] > max(c[1] for c in cluster):
                    out.extend(self._emit(seq, cluster, vtype, stats))
                    cluster = []
                cluster.append(iv)
            out.extend(self._emit(seq, cluster, vtype, stats))
        return out

    def _emit(self, seq, cluster, vtype, stats) -> list[CalledGenomicVariant]:
        if len(cluster) < self.min_pairs:
            return []
        firsts = np.array([c[0] for c in cluster])
        lasts = np.array([c[1] for c in cluster])
        inss = np.array([c[2] for c in cluster])
        first = int(np.median(firsts))
        last = int(np.median(lasts))
        if vtype == TYPE_LARGEDEL:
            svlen = int(np.median(inss) - stats.mean)
            last = first + max(50, svlen)
        call = CalledGenomicVariant(
            sequence_name=seq,
            first=first,
            alleles=["N"],
            variant_type=vtype,
            quality=min(255, 10 * len(cluster)),
            last_=last,
            genotype_quality=min(255, 10 * len(cluster)),
            total_read_depth=len(cluster),
            indexes_called_alleles=[0],
        )
        return [call]
