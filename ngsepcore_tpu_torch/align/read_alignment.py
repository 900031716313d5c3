"""Read alignment record — the SAM-equivalent model.

Ref: src/ngsep/alignments/ReadAlignment.java (flags bitmask :43-58, CIGAR
int codes, clipBorders :1509-1553, per-reference-pos allele calls :989-1101).
CIGAR is a list of (length, op) tuples with SAM op chars; soft clips are the
reference's SKIPFROMREAD.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# SAM flags (ref: ReadAlignment.java:43-58)
FLAG_PAIRED = 1
FLAG_PROPER = 2
FLAG_READ_UNMAPPED = 4
FLAG_MATE_UNMAPPED = 8
FLAG_READ_REVERSE = 16
FLAG_MATE_REVERSE = 32
FLAG_FIRST_OF_PAIR = 64
FLAG_SECOND_OF_PAIR = 128
FLAG_SECONDARY = 256
FLAG_FAILS_QC = 512
FLAG_DUPLICATE = 1024
FLAG_SUPPLEMENTARY = 2048

_CONSUMES_READ = set("MIS=X")
_CONSUMES_REF = set("MDN=X")


@dataclass
class ReadAlignment:
    sequence_name: str | None  # None = unmapped
    first: int  # 1-based leftmost mapped ref position
    cigar: list[tuple[int, str]] = field(default_factory=list)
    flags: int = 0
    read_name: str = ""
    read_chars: str = ""  # as aligned (already revcomp'd if negative strand)
    qualities: str | None = None
    alignment_quality: int = 0  # MAPQ
    num_mismatches: int = 0
    mate_sequence_name: str | None = None
    mate_first: int = 0
    inferred_insert_size: int = 0
    read_group: str | None = None
    # read bases excluded from pileup calls at each end, mirrors
    # ReadAlignment.basesToIgnore5P/3P set by the indel realigner
    # (IndelRealignerPileupListener.java:478-486,520-526)
    bases_to_ignore_start: int = 0
    bases_to_ignore_end: int = 0
    # cached int8 codes of read_chars (as aligned); set by the aligner so
    # downstream pileup expansion skips re-encoding strings
    _read_codes: np.ndarray | None = field(default=None, repr=False, compare=False)
    # CIGAR-derived caches (the realigner + pileup walk these hundreds of
    # thousands of times per run); invalidated on CIGAR mutation
    _ref_span: int | None = field(default=None, repr=False, compare=False)
    _indel_calls: list | None = field(default=None, repr=False, compare=False)
    _m_runs: tuple | None = field(default=None, repr=False, compare=False)

    def _invalidate_cigar_cache(self) -> None:
        self._ref_span = None
        self._indel_calls = None
        self._m_runs = None

    def m_runs(self) -> tuple:
        """(ref_start, read_start, length) per M/=/X run — the per-base
        expansion's input, cached (pileup expansion re-walks every gapped
        CIGAR per run otherwise)."""
        if self._m_runs is None:
            ref = self.first
            ridx = 0
            out = []
            for l, op in self.cigar:
                if op in ("M", "=", "X"):
                    out.append((ref, ridx, l))
                    ref += l
                    ridx += l
                elif op == "I":
                    ridx += l
                elif op in ("D", "N"):
                    ref += l
                elif op == "S":
                    ridx += l
            self._m_runs = tuple(out)
        return self._m_runs

    @property
    def read_codes(self) -> np.ndarray:
        from ..core.sequences import encode_dna

        if self._read_codes is None or len(self._read_codes) != len(self.read_chars):
            self._read_codes = encode_dna(self.read_chars)
        return self._read_codes

    # ---- flags -----------------------------------------------------------
    @property
    def is_unmapped(self) -> bool:
        return bool(self.flags & FLAG_READ_UNMAPPED) or self.sequence_name is None

    @property
    def is_negative_strand(self) -> bool:
        return bool(self.flags & FLAG_READ_REVERSE)

    def set_negative_strand(self, v: bool) -> None:
        if v:
            self.flags |= FLAG_READ_REVERSE
        else:
            self.flags &= ~FLAG_READ_REVERSE

    @property
    def is_secondary(self) -> bool:
        return bool(self.flags & FLAG_SECONDARY)

    def set_secondary(self, v: bool) -> None:
        if v:
            self.flags |= FLAG_SECONDARY
        else:
            self.flags &= ~FLAG_SECONDARY

    @property
    def is_paired(self) -> bool:
        return bool(self.flags & FLAG_PAIRED)

    @property
    def is_proper_pair(self) -> bool:
        return bool(self.flags & FLAG_PROPER)

    # ---- CIGAR -----------------------------------------------------------
    @property
    def cigar_string(self) -> str:
        if not self.cigar:
            return "*"
        return "".join(f"{l}{op}" for l, op in self.cigar)

    @property
    def read_length(self) -> int:
        return sum(l for l, op in self.cigar if op in _CONSUMES_READ) or len(
            self.read_chars
        )

    @property
    def reference_span(self) -> int:
        if self._ref_span is None:
            self._ref_span = sum(
                l for l, op in self.cigar if op in _CONSUMES_REF
            )
        return self._ref_span

    @property
    def last(self) -> int:
        """1-based inclusive rightmost mapped reference position."""
        return self.first + self.reference_span - 1

    @property
    def soft_clip_start(self) -> int:
        return self.cigar[0][0] if self.cigar and self.cigar[0][1] == "S" else 0

    @property
    def soft_clip_end(self) -> int:
        return self.cigar[-1][0] if self.cigar and self.cigar[-1][1] == "S" else 0

    def clip_borders(self, min_match_length: int) -> bool:
        """Soft-clip unreliable CIGAR borders.

        Ref: ReadAlignment.clipBorders (ReadAlignment.java:1509-1553):
        walk in from each end until a match run of length>=min_match_length;
        everything outside becomes one soft-clip run.  Returns False if no
        such anchor exists.
        """
        cig = self.cigar
        i = 0
        rm_ref_start = rm_read_start = 0
        while i < len(cig):
            l, op = cig[i]
            if l >= min_match_length and op == "M":
                break
            if op in _CONSUMES_READ:
                rm_read_start += l
            if op in _CONSUMES_REF:
                rm_ref_start += l
            i += 1
        j = len(cig) - 1
        rm_ref_end = rm_read_end = 0
        while j >= 0:
            l, op = cig[j]
            if l >= min_match_length and op == "M":
                break
            if op in _CONSUMES_READ:
                rm_read_end += l
            if op in _CONSUMES_REF:
                rm_ref_end += l
            j -= 1
        if i > j:
            return False
        new_cigar: list[tuple[int, str]] = []
        if rm_read_start > 0:
            new_cigar.append((rm_read_start, "S"))
        new_cigar.extend(cig[i : j + 1])
        if rm_read_end > 0:
            new_cigar.append((rm_read_end, "S"))
        self.first += rm_ref_start
        self.cigar = new_cigar
        self._invalidate_cigar_cache()
        return True

    # ---- per-position access (pileup support) -----------------------------
    def read_position_at(self, ref_pos: int) -> int:
        """0-based read index aligned to 1-based ref_pos, or -1 (cached
        M-run walk: positions inside D/N gaps or outside the alignment
        return -1, same as the op-by-op scan)."""
        for ref, ridx, l in self.m_runs():
            if ref_pos < ref:
                return -1
            if ref_pos < ref + l:
                return ridx + (ref_pos - ref)
        return -1

    def indel_calls(self) -> list[tuple[int, int, int]]:
        """All indels as (first, last, length) with the reference's event
        coordinates (ReadAlignment.getIndelCalls, ReadAlignment.java:1050):
        `first` = last reference base before the event, `last` = first
        reference base after it (so a deletion of d bases spans d+2 and an
        insertion spans 2), `length` = inserted/deleted base count.
        Border I/D runs (no M on both sides) are not calls.
        """
        if self._indel_calls is not None:
            return self._indel_calls
        out: list[tuple[int, int, int]] = []
        cig = self.cigar
        # most alignments are gapless S/M/S — return the cached empty list
        # without walking (hot: realigner + pileup call this per alignment)
        if not any(op in ("I", "D", "N") for _, op in cig):
            self._indel_calls = out
            return out
        pos = self.first
        last_m = -1
        for k in range(len(cig) - 1, -1, -1):
            if cig[k][1] == "M":
                last_m = k
                break
        seen_m = False
        for k, (l, op) in enumerate(cig):
            if op in ("I", "D", "N"):
                interior = seen_m and k < last_m
                if op == "I":
                    if interior:
                        out.append((pos - 1, pos, l))
                else:
                    if interior:
                        out.append((pos - 1, pos + l, l))
                    pos += l
            elif op in _CONSUMES_REF:
                pos += l
                if op == "M":
                    seen_m = True
        self._indel_calls = out
        return out

    def indel_call_at(self, ref_pos: int) -> tuple[int, int, int] | None:
        """Indel call whose event start equals ref_pos (getIndelCall)."""
        for c in self.indel_calls():
            if c[0] == ref_pos:
                return c
        return None

    def has_indel_calls(self, first: int, last: int) -> bool:
        return any(first <= c[0] <= last for c in self.indel_calls())

    def move_indel_start(self, indel_first: int, new_first: int) -> bool:
        """Move the indel whose call-start is `indel_first` so it starts at
        `new_first`, transferring matched bases across the event
        (ReadAlignment.moveIndelStart semantics).  Returns False if the move
        is not possible (not enough M bases on the shrinking side).
        """
        if new_first == indel_first:
            return True
        shift = new_first - indel_first
        pos = self.first
        for k, (l, op) in enumerate(self.cigar):
            if op in ("I", "D", "N") and k > 0 and k + 1 < len(self.cigar):
                if pos - 1 == indel_first:
                    prev_l, prev_op = self.cigar[k - 1]
                    next_l, next_op = self.cigar[k + 1]
                    if prev_op != "M" or next_op != "M":
                        return False
                    if shift > 0:
                        if next_l <= shift:
                            return False
                        self.cigar[k - 1] = (prev_l + shift, "M")
                        self.cigar[k + 1] = (next_l - shift, "M")
                    else:
                        if prev_l <= -shift:
                            return False
                        self.cigar[k - 1] = (prev_l + shift, "M")
                        self.cigar[k + 1] = (next_l - shift, "M")
                    self._invalidate_cigar_cache()
                    return True
            if op in _CONSUMES_REF:
                pos += l
        return False

    def to_sam_fields(self) -> list[str]:
        seq = self.read_chars or "*"
        qual = self.qualities or "*"
        rname = self.sequence_name or "*"
        pos = self.first if self.sequence_name else 0
        rnext = "*"
        if self.mate_sequence_name:
            rnext = (
                "="
                if self.mate_sequence_name == self.sequence_name
                else self.mate_sequence_name
            )
        fields = [
            self.read_name,
            str(self.flags),
            rname,
            str(pos),
            str(self.alignment_quality),
            self.cigar_string if self.sequence_name else "*",
            rnext,
            str(self.mate_first),
            str(self.inferred_insert_size),
            seq,
            qual,
        ]
        tags = [f"NM:i:{self.num_mismatches}"]
        if self.read_group:
            tags.append(f"RG:Z:{self.read_group}")
        return fields + tags


def left_align_indels(
    cigar: list[tuple[int, str]],
    read_codes,
    ref_codes,
    ref_offset: int = 0,
) -> list[tuple[int, str]]:
    """Shift I/D runs to their leftmost equivalent placement.

    The reference realigns indels across reads so all reads place the same
    event at the same (leftmost) position
    (IndelRealignerPileupListener.moveIndelStarts:274); normalizing each
    CIGAR at alignment time achieves the same consistency.  ref_codes is
    the subject window; ref_offset is where the alignment starts inside it.

    The shift distance of each gap run is computed in closed form: a run
    of length l at cursor p shifts k steps iff x[p-1-j] == x[p+l-1-j] for
    all j < k (x = read for I, subject for D; the underlying sequence
    never changes, so the per-step conditions are independent), bounded by
    the preceding M run.  One left-to-right pass replaces the
    restart-on-every-shift scan (~1.1s of a 35s bench run at ~96k gapped
    alignments; homopolymer runs shift 10+ steps each).
    """
    read_codes = np.asarray(read_codes)
    ref_codes = np.asarray(ref_codes)
    # pre-merge adjacent equal ops: the shift bound below reads only the
    # immediately preceding run, while the restart-scan walks through
    # consecutive M runs one by one
    runs: list[list] = []
    for l, op in cigar:
        if runs and runs[-1][1] == op:
            runs[-1][0] += l
        else:
            runs.append([l, op])
    qi = 0
    sj = ref_offset
    i = 0
    while i < len(runs):
        l, op = runs[i]
        if (
            op in ("I", "D")
            and l > 0
            and i > 0
            and runs[i - 1][1] == "M"
            and runs[i - 1][0] > 0
        ):
            x = read_codes if op == "I" else ref_codes
            p = qi if op == "I" else sj
            kmax = min(runs[i - 1][0], p)
            if kmax > 0 and p + l <= len(x):
                a = x[p - kmax : p][::-1]
                b = x[p + l - kmax : p + l][::-1]
                neq = np.flatnonzero(a != b)
                k = int(neq[0]) if len(neq) else kmax
            else:
                k = 0
            if k > 0:
                runs[i - 1][0] -= k
                if i + 1 < len(runs) and runs[i + 1][1] == "M":
                    runs[i + 1][0] += k
                else:
                    runs.insert(i + 1, [k, "M"])
                # the preceding M shrank by k: it consumed k less of BOTH
                # query and subject, so both cursors sit k earlier here
                qi -= k
                sj -= k
                if runs[i - 1][0] == 0:
                    del runs[i - 1]
                    i -= 1
        l, op = runs[i]
        if op in ("M", "=", "X"):
            qi += l
            sj += l
        elif op in ("I", "S"):
            qi += l
        elif op in ("D", "N"):
            sj += l
        i += 1
    # merge adjacent equal ops
    merged: list[tuple[int, str]] = []
    for l, op in runs:
        if l == 0:
            continue
        if merged and merged[-1][1] == op:
            merged[-1] = (merged[-1][0] + l, op)
        else:
            merged.append((l, op))
    return merged


def cigar_from_string(s: str) -> list[tuple[int, str]]:
    if s == "*" or not s:
        return []
    out = []
    num = 0
    for ch in s:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            out.append((num, ch))
            num = 0
    return out
