"""Pileup construction: alignments -> dense per-position call tensors.

Ref: src/ngsep/discovery/AlignmentsPileupGenerator.java:38-515 (streams
sorted alignments, caps 5 alns per start pos per read group, advances a
pileup cursor firing per-position listeners) and PileupRecord.java:104-126
(per-read allele calls).

TPU redesign: instead of an event bus firing one listener call per (read,
position) pair, each batch of alignments is expanded (host, vectorized)
into flat (ref_pos, allele, quality, strand) arrays and scatter-added on
device into (window, allele, qbin) count tensors
(kernels/genotyping.scatter_allele_counts).  Indel-spanning calls are
extracted separately as string events for host-side clustering.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..align.read_alignment import ReadAlignment
from ..core.sequences import encode_dna, qualities_to_phred

MAX_ALNS_PER_START_POS = 5  # ref: AlignmentsPileupGenerator.java:40


@dataclass
class IndelEvent:
    """An indel observed inside one read (for indel-candidate discovery)."""

    ref_pos: int  # 1-based position of the last reference base before event
    length: int  # ref bases consumed (deletion length; 0 for insertion)
    inserted: str  # inserted read bases ("" for deletion)
    read_name: str


def cap_alignments_per_start(
    alns: list[ReadAlignment], max_per_start: int = MAX_ALNS_PER_START_POS
) -> list[ReadAlignment]:
    """Cap alignments sharing (read group, start) — ref :415-420."""
    out = []
    count: dict[tuple, int] = {}
    for a in alns:
        key = (a.read_group, a.sequence_name, a.first)
        c = count.get(key, 0)
        if c < max_per_start:
            out.append(a)
            count[key] = c + 1
    return out


def expand_alignment_calls(
    aln: ReadAlignment,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, list[IndelEvent]]:
    """One alignment -> (ref_positions 1-based, allele codes, phred quals)
    for match segments, plus indel events.

    Missing qualities default to '+' (q=10) like ReadAlignment.java:1025.
    """
    codes = aln.read_codes
    if aln.qualities:
        quals = qualities_to_phred(aln.qualities)
    else:
        quals = np.full(len(codes), 10, dtype=np.int8)
    ref_pos_list = []
    read_idx_list = []
    indels: list[IndelEvent] = []
    ref = aln.first
    ridx = 0
    for l, op in aln.cigar:
        if op == "M" or op == "=" or op == "X":
            ref_pos_list.append(np.arange(ref, ref + l, dtype=np.int64))
            read_idx_list.append(np.arange(ridx, ridx + l, dtype=np.int64))
            ref += l
            ridx += l
        elif op == "I":
            indels.append(
                IndelEvent(
                    ref_pos=ref - 1,
                    length=0,
                    inserted=aln.read_chars[ridx : ridx + l],
                    read_name=aln.read_name,
                )
            )
            ridx += l
        elif op == "D" or op == "N":
            indels.append(
                IndelEvent(ref_pos=ref - 1, length=l, inserted="", read_name=aln.read_name)
            )
            ref += l
        elif op == "S":
            ridx += l
        elif op == "H" or op == "P":
            pass
    if ref_pos_list:
        rp = np.concatenate(ref_pos_list)
        ri = np.concatenate(read_idx_list)
    else:
        rp = np.empty(0, np.int64)
        ri = np.empty(0, np.int64)
    # exclude read-end bases marked by the indel realigner (ref:
    # ReadAlignment.getAlleleCall honors basesToIgnore5P/3P)
    if aln.bases_to_ignore_start or aln.bases_to_ignore_end:
        n = len(codes)
        keep = (ri >= aln.bases_to_ignore_start) & (
            ri < n - aln.bases_to_ignore_end
        )
        rp, ri = rp[keep], ri[keep]
    return rp, codes[ri], quals[ri], indels


_SIMPLE_OPS = frozenset("SM=X")


def _expand_complex_calls(
    alns: list[ReadAlignment],
    collect_indels: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, list[IndelEvent]]:
    """Batched expansion for gapped alignments.

    One Python pass per CIGAR run collects (alignment, ref start, read
    start, length) integer lists plus IndelEvents; the per-base expansion
    of every M run across the whole batch is then one repeat/arange pass —
    the per-alignment numpy allocations of expand_alignment_calls were the
    dominant host cost per gapped read (tandem-array reads make those
    common on real genomes).  `collect_indels=False` skips IndelEvent
    construction for callers that discard it (the variant callers take
    indel evidence from the realigner instead)."""
    A = len(alns)
    m_aid: list[int] = []
    m_ref: list[int] = []
    m_read: list[int] = []
    m_len: list[int] = []
    indels: list[IndelEvent] = []
    lens = np.empty(A, np.int64)
    ig5 = np.empty(A, np.int64)
    ig3 = np.empty(A, np.int64)
    strand_a = np.empty(A, np.int8)
    codes_parts = []
    qual_parts = []
    ap_aid = m_aid.append
    ap_ref = m_ref.append
    ap_read = m_read.append
    ap_len = m_len.append
    for i, a in enumerate(alns):
        codes = a.read_codes
        n = len(codes)
        lens[i] = n
        ig5[i] = a.bases_to_ignore_start
        ig3[i] = a.bases_to_ignore_end
        strand_a[i] = 1 if a.flags & 16 else 0
        codes_parts.append(codes)
        qual_parts.append(a.qualities if a.qualities else "+" * n)
        if not collect_indels:
            # fast path: cached (ref, read, len) M-runs, no per-op walk
            for ref, ridx, l in a.m_runs():
                ap_aid(i)
                ap_ref(ref)
                ap_read(ridx)
                ap_len(l)
            continue
        ref = a.first
        ridx = 0
        for l, op in a.cigar:
            if op == "M" or op == "=" or op == "X":
                ap_aid(i)
                ap_ref(ref)
                ap_read(ridx)
                ap_len(l)
                ref += l
                ridx += l
            elif op == "I":
                indels.append(
                    IndelEvent(
                        ref_pos=ref - 1,
                        length=0,
                        inserted=a.read_chars[ridx : ridx + l],
                        read_name=a.read_name,
                    )
                )
                ridx += l
            elif op == "D" or op == "N":
                indels.append(
                    IndelEvent(
                        ref_pos=ref - 1, length=l, inserted="",
                        read_name=a.read_name,
                    )
                )
                ref += l
            elif op == "S":
                ridx += l
    codes_flat = (
        np.concatenate(codes_parts) if codes_parts else np.empty(0, np.int8)
    )
    qflat = (
        np.frombuffer("".join(qual_parts).encode("ascii"), np.uint8).astype(
            np.int16
        )
        - 33
    ).astype(np.int8)
    offsets = np.zeros(A, np.int64)
    np.cumsum(lens[:-1], out=offsets[1:])
    rlen = np.asarray(m_len, np.int64)
    R = len(rlen)
    if R == 0:
        z = np.empty(0, np.int64)
        return z, z.astype(np.int8), z.astype(np.int8), z.astype(np.int8), indels
    rid = np.repeat(np.arange(R), rlen)
    cum_excl = np.zeros(R, np.int64)
    np.cumsum(rlen[:-1], out=cum_excl[1:])
    off = np.arange(int(rlen.sum()), dtype=np.int64) - cum_excl[rid]
    aid = np.asarray(m_aid, np.int64)[rid]
    pos = np.asarray(m_ref, np.int64)[rid] + off
    ri = np.asarray(m_read, np.int64)[rid] + off
    # read-end bases flagged by the indel realigner contribute no calls
    # (ref: ReadAlignment.getAlleleCall honors basesToIgnore5P/3P)
    keep = (ri >= ig5[aid]) & (ri < lens[aid] - ig3[aid])
    pos, ri, aid = pos[keep], ri[keep], aid[keep]
    src = offsets[aid] + ri
    return pos, codes_flat[src], qflat[src], strand_a[aid], indels


def _expand_simple_calls(
    alns: list[ReadAlignment],
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized expansion for gap-free alignments (CIGAR of S/M/=/X only).

    Because S occurs only at the ends and M/=/X consume read and reference
    in lockstep, each alignment contributes one contiguous run: read index
    j in [max(clip_start, ignore5), len - max(clip_end, ignore3)) maps to
    reference position first + (j - clip_start).  The whole batch expands
    with repeat/arange index math — no per-alignment Python loops (the
    reference fires a listener per (read, position) pair instead;
    AlignmentsPileupGenerator.java:377-403)."""
    A = len(alns)
    first = np.empty(A, np.int64)
    cs = np.empty(A, np.int64)
    win_start = np.empty(A, np.int64)
    win_end = np.empty(A, np.int64)
    lens = np.empty(A, np.int64)
    strand_a = np.empty(A, np.int8)
    codes_parts = []
    qual_parts = []
    for i, a in enumerate(alns):
        codes = a.read_codes
        n = len(codes)
        c0 = a.cigar[0]
        tcs = c0[0] if c0[1] == "S" else 0
        cl = a.cigar[-1]
        tce = cl[0] if len(a.cigar) > 1 and cl[1] == "S" else 0
        first[i] = a.first
        cs[i] = tcs
        win_start[i] = max(tcs, a.bases_to_ignore_start)
        win_end[i] = min(n - tce, n - a.bases_to_ignore_end)
        lens[i] = n
        strand_a[i] = 1 if a.is_negative_strand else 0
        codes_parts.append(codes)
        qual_parts.append(a.qualities if a.qualities else "+" * n)
    codes_flat = np.concatenate(codes_parts) if codes_parts else np.empty(0, np.int8)
    qflat = (
        np.frombuffer("".join(qual_parts).encode("ascii"), np.uint8).astype(np.int16)
        - 33
    ).astype(np.int8)
    offsets = np.zeros(A, np.int64)
    np.cumsum(lens[:-1], out=offsets[1:])
    cnt = np.maximum(win_end - win_start, 0)
    tot = int(cnt.sum())
    aid = np.repeat(np.arange(A), cnt)
    cum_excl = np.zeros(A, np.int64)
    np.cumsum(cnt[:-1], out=cum_excl[1:])
    j = win_start[aid] + (np.arange(tot) - cum_excl[aid])
    src = offsets[aid] + j
    pos = first[aid] + (j - cs[aid])
    return pos, codes_flat[src], qflat[src], strand_a[aid]


def expand_batch_calls(
    alns: list[ReadAlignment],
    collect_indels: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, list[IndelEvent]]:
    """Batch expansion -> flat (ref_pos, allele, qual, strand) arrays.

    Gap-free alignments (the overwhelming majority) expand through one
    vectorized pass; alignments with indels fall back to the per-alignment
    path, which also yields their IndelEvents (skipped when
    collect_indels=False — the variant callers discard them)."""
    simple: list[ReadAlignment] = []
    complex_: list[ReadAlignment] = []
    for a in alns:
        cig = a.cigar
        if cig and all(op in _SIMPLE_OPS for _, op in cig):
            simple.append(a)
        else:
            complex_.append(a)
    pos_l, al_l, q_l, s_l = [], [], [], []
    if simple:
        sp, sa, sq, ss = _expand_simple_calls(simple)
        pos_l.append(sp)
        al_l.append(sa)
        q_l.append(sq)
        s_l.append(ss)
    indels: list[IndelEvent] = []
    if complex_:
        cp, ca, cq, cs, indels = _expand_complex_calls(
            complex_, collect_indels
        )
        pos_l.append(cp)
        al_l.append(ca)
        q_l.append(cq)
        s_l.append(cs)
    if not pos_l:
        return (
            np.empty(0, np.int64),
            np.empty(0, np.int8),
            np.empty(0, np.int8),
            np.empty(0, np.int8),
            indels,
        )
    return (
        np.concatenate(pos_l),
        np.concatenate(al_l),
        np.concatenate(q_l),
        np.concatenate(s_l),
        indels,
    )
