"""Consensus polishing + contig post-processing (end merge, circularization).

Ref: src/ngsep/assembly/ConsensusBuilderBidirectionalWithPolishing.java:82+
(align reads to the draft backbone, correct consensus from aligned-read
calls), AlignmentBasedIndelErrorsCorrector.java (indel error correction
from alignments), ContigEndsMerger.java (merge contigs with overlapping
ends), CircularSequencesProcessor.java (detect + trim circular overlaps).

Polishing re-uses the genotyping scatter at assembly scale: reads are
aligned back to the draft with the batched long-read aligner on the
caller's device, every matched base lands in one scatter-add on that
device into a (contig_pos, allele, qbin) tensor, and the corrected
consensus is the per-position argmax.  Indel corrections are host-side
sparse edits collected from the same alignments.  Same results as
ngsepcore_tpu/assembly/polishing.py.
"""
from __future__ import annotations

import numpy as np
import torch

from ..call.pileup import IndelEvent, expand_batch_calls
from ..core.genome import ReferenceGenome
from ..core.sequences import (
    QualifiedSequence,
    QualifiedSequenceList,
    encode_dna,
)
from ..kernels.genotyping import scatter_allele_counts


def polish_contigs(
    contigs: list[np.ndarray],
    reads: list,
    rounds: int = 1,
    min_indel_fraction: float = 0.5,
    min_depth: int = 2,
    *,
    device,
) -> tuple[list[np.ndarray], int]:
    """Polish draft contigs against the read set.

    Returns (polished contigs, number of corrections applied).
    reads: list of RawRead.  Alignment and the count scatter run on
    `device`.
    """
    from ..align.long_reads import LongReadsAligner

    total_corrections = 0
    # the extra iteration is a substitution-only stabilization pass:
    # indel edits re-jitter the read alignments, so a handful of sites
    # can oscillate between rounds — a final pass that applies only the
    # (stable) base-majority leaves the contig at the clean fixed point
    for round_i in range(rounds + 1):
        subs_only = round_i == rounds
        seqs = QualifiedSequenceList()
        for i, c in enumerate(contigs):
            seqs.add(QualifiedSequence(name=f"c{i}", codes=c))
        genome = ReferenceGenome(seqs)
        aligner = LongReadsAligner(genome, device=device)
        per_contig: dict[str, list] = {}
        B = 256
        for b0 in range(0, len(reads), B):
            for group in aligner.align_batch(reads[b0 : b0 + B]):
                for a in group:
                    per_contig.setdefault(a.sequence_name, []).append(a)
        new_contigs: list[np.ndarray] = []
        corrections = 0
        for i, draft in enumerate(contigs):
            alns = per_contig.get(f"c{i}", [])
            if not alns:
                new_contigs.append(draft)
                continue
            pos, allele, qual, strand, indels = expand_batch_calls(alns)
            L = len(draft)
            counts, _, _, total = scatter_allele_counts(
                *(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                  for a in ((pos - 1).astype(np.int32), allele, qual, strand)),
                out_size=L,
            )
            base_counts = counts.sum(dim=2).cpu().numpy()  # (L, 4)
            depth = total.cpu().numpy()
            majority = base_counts.argmax(axis=1).astype(np.int8)
            support = base_counts.max(axis=1)
            use = (depth >= min_depth) & (support * 2 > depth)
            polished = np.where(use, majority, draft).astype(np.int8)
            corrections += int(np.count_nonzero(polished != draft))
            if subs_only:
                new_contigs.append(polished)
                continue
            # indel corrections: votes for the SAME event scatter over
            # nearby placements when the supporting reads carry their own
            # errors (left-alignment lands on slightly different spots),
            # so events cluster by (net length change, position +-3)
            # before the majority test; the cluster's best-supported
            # exact event is the applied edit
            events: dict[tuple[int, int, str], int] = {}
            for ev in indels:
                key = (ev.ref_pos, ev.length, ev.inserted.upper())
                events[key] = events.get(key, 0) + 1
            items = sorted(
                events.items(),
                key=lambda kv: (len(kv[0][2]) - kv[0][1], kv[0][0]),
            )
            clusters: list[dict] = []
            for (rp, dlen, ins), n in items:
                if rp < 1 or rp > L:
                    continue
                net = len(ins) - dlen
                if (
                    clusters
                    and clusters[-1]["net"] == net
                    and rp - clusters[-1]["last_rp"] <= 3
                ):
                    c = clusters[-1]
                    c["votes"] += n
                    c["last_rp"] = rp
                    if n > c["best_n"]:
                        c["best_n"] = n
                        c["best"] = (rp, dlen, ins)
                else:
                    clusters.append(
                        {
                            "net": net, "votes": n, "last_rp": rp,
                            "best_n": n, "best": (rp, dlen, ins),
                        }
                    )
            edits = []
            for c in clusters:
                rp, dlen, ins = c["best"]
                d = depth[rp - 1]
                if d < min_depth or c["votes"] < min_indel_fraction * d:
                    continue
                edits.append((rp, dlen, ins, c["votes"]))
            # best-supported event per position, non-overlapping
            edits.sort(key=lambda e: (e[0], -e[3]))
            chosen = []
            prev_end = -1
            for e in edits:
                if e[0] > prev_end:
                    chosen.append(e)
                    prev_end = e[0] + e[1]
            pieces = []
            prev = 0
            for rp, dlen, ins, _ in chosen:
                # event sits after 1-based position rp
                pieces.append(polished[prev:rp])
                if ins:
                    pieces.append(encode_dna(ins))
                prev = rp + dlen
                corrections += 1
            pieces.append(polished[prev:])
            new_contigs.append(np.concatenate(pieces).astype(np.int8))
        contigs = new_contigs
        total_corrections += corrections
        if corrections == 0:
            break
    return contigs, total_corrections


# ---------------------------------------------------------------------------
def detect_end_overlap(
    a: np.ndarray,
    b: np.ndarray,
    k: int = 15,
    max_window: int = 30000,
    min_overlap: int = 500,
    max_divergence: float = 0.15,
) -> int | None:
    """Overlap length if the suffix of `a` matches the prefix of `b`.

    K-mer anchored diagonal voting over the end windows + identity check
    (ref: ContigEndsMerger's end-window FM/k-mer search)."""
    wa = a[-min(len(a), max_window) :]
    wb = b[: min(len(b), max_window)]
    if len(wa) < k or len(wb) < k:
        return None
    codes_a = _kmer_code_array(wa, k)
    codes_b = _kmer_code_array(wb, k)
    ia = {}
    for i, c in enumerate(codes_a):
        if c >= 0:
            ia.setdefault(c, []).append(i)
    diag_list: list[int] = []
    match_i: list[int] = []
    match_j: list[int] = []
    for j, c in enumerate(codes_b):
        if c < 0:
            continue
        for i in ia.get(c, ())[:4]:
            diag_list.append(i - j)  # offset of wb start inside wa
            match_i.append(i)
            match_j.append(j)
    if len(diag_list) < 6:
        return None
    # drift-tolerant chain (indel drift in noisy consensus breaks a fixed
    # modal diagonal): seed at the modal 64-bin, extend both ways letting
    # the corridor follow the drift (same scheme as find_containment)
    order = np.lexsort((np.array(diag_list), np.array(match_j)))
    js = np.array(match_j, np.int64)[order]
    is_ = np.array(match_i, np.int64)[order]
    ds = np.array(diag_list, np.int64)[order]
    bins = ds // 64
    vals, counts = np.unique(bins, return_counts=True)
    seed_bin = int(vals[counts.argmax()])
    if counts.max() < 6:
        return None
    seed_idx = np.nonzero(bins == seed_bin)[0]
    s = int(seed_idx[len(seed_idx) // 2])
    chain = 1
    last_d, last_j = int(ds[s]), int(js[s])
    jr, ir = int(js[s]), int(is_[s])
    for t in range(s + 1, len(js)):
        if js[t] <= last_j or abs(int(ds[t]) - last_d) > 64:
            continue
        chain += 1
        last_d, last_j = int(ds[t]), int(js[t])
        jr, ir = last_j, int(is_[t])
    last_d, last_j = int(ds[s]), int(js[s])
    jl, il = int(js[s]), int(is_[s])
    for t in range(s - 1, -1, -1):
        if js[t] >= last_j or abs(int(ds[t]) - last_d) > 64:
            continue
        chain += 1
        last_d, last_j = int(ds[t]), int(js[t])
        jl, il = last_j, int(is_[t])
    # the chain must span from near wb's start to near wa's end (a true
    # suffix-prefix overlap); junction via the RIGHTMOST anchor so the
    # splice is exact at that anchor (no modal-offset rounding).  Contig
    # ENDS stay noisy after polishing (coverage tapers), so the slack is
    # generous; the post-merge polish round cleans the junction
    slack = max(4 * k, 256)
    if jl > slack or (len(wa) - (ir + k)) > slack:
        return None
    if il - jl < 0:
        return None
    overlap = jr + (len(wa) - ir)
    if overlap < min_overlap or overlap > len(wb):
        return None
    min_density = 0.35 * (1.0 - max_divergence) ** k
    if chain < min_density * max(1, overlap - k + 1):
        return None
    return overlap


def circularize(
    contig: np.ndarray, min_overlap: int = 1000, max_window: int = 30000, **kw
) -> tuple[np.ndarray, bool]:
    """Trim the duplicated start from the end of a circular contig
    (ref: CircularSequencesProcessor).  The end windows compared are
    disjoint thirds so the contig's trivial self-diagonal cannot vote."""
    if len(contig) < 4 * min_overlap:
        return contig, False
    w = min(len(contig) // 3, max_window)
    ov = detect_end_overlap(
        contig[-w:], contig[:w], min_overlap=min_overlap, max_window=w, **kw
    )
    if ov is None or ov >= len(contig) // 2:
        return contig, False
    return contig[:-ov], True


def merge_contig_ends(
    contigs: list[np.ndarray], min_overlap: int = 500, **kw
) -> list[np.ndarray]:
    """Greedy merge of contigs whose ends overlap (both orientations)
    (ref: ContigEndsMerger)."""
    from ..core.sequences import reverse_complement_codes

    contigs = sorted(contigs, key=len, reverse=True)
    merged = True
    while merged and len(contigs) > 1:
        merged = False
        n = len(contigs)
        for i in range(n):
            if merged:
                break
            for j in range(n):
                if i == j:
                    continue
                # orientation configs per ordered pair: (+,+), (+,-),
                # (-,+).  (-,-) is the reverse complement of (+,+) with
                # the pair order swapped, which this double loop already
                # enumerates; without the (-,+) config the rc(A)+B
                # junction class was unreachable
                for flip_i, flip_j in ((False, False), (False, True), (True, False)):
                    a = (
                        contigs[i]
                        if not flip_i
                        else reverse_complement_codes(contigs[i])
                    )
                    b = (
                        contigs[j]
                        if not flip_j
                        else reverse_complement_codes(contigs[j])
                    )
                    ov = detect_end_overlap(
                        a, b, min_overlap=min_overlap, **kw
                    )
                    if ov is not None:
                        joined = np.concatenate([a, b[ov:]])
                        keep = [
                            contigs[x] for x in range(n) if x not in (i, j)
                        ]
                        contigs = sorted(keep + [joined], key=len, reverse=True)
                        merged = True
                        break
                if merged:
                    break
    return contigs


def _kmer_code_array(codes: np.ndarray, k: int) -> np.ndarray:
    """Rolling 2-bit k-mer codes; -1 where the window contains N."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.empty(0, np.int64)
    valid = codes < 4
    c = np.where(valid, codes, 0).astype(np.int64)
    out = np.zeros(n, np.int64)
    ok = np.ones(n, bool)
    for i in range(k):
        out = out | (c[i : i + n] << (2 * (k - 1 - i)))
        ok &= valid[i : i + n]
    return np.where(ok, out, -1)


def find_containment(
    a: np.ndarray,
    b: np.ndarray,
    k: int = 15,
    min_cover: float = 0.75,
    max_divergence: float = 0.15,
) -> bool:
    """True if contig `b` lies (mostly) inside contig `a`.

    Same k-mer diagonal-vote machinery as detect_end_overlap but over the
    whole of `a`: redundant layout paths produce contigs contained in a
    longer contig rather than end-overlapping it (ref: the graph-level
    embedded-relationship filter, AssemblySequencesRelationshipFilter;
    this is the contig-level analog applied at post-processing)."""
    if len(b) < k or len(b) > len(a):
        return False
    codes_a = _kmer_code_array(a, k)
    codes_b = _kmer_code_array(b, k)
    ia: dict[int, list[int]] = {}
    for i, c in enumerate(codes_a):
        if c >= 0:
            ia.setdefault(int(c), []).append(i)
    diag_list: list[int] = []
    match_j: list[int] = []
    for j in range(0, len(codes_b)):
        c = codes_b[j]
        if c < 0:
            continue
        for i in ia.get(int(c), ())[:4]:
            diag_list.append(i - j)
            match_j.append(j)
    if len(diag_list) < 6:
        return False
    # drift-tolerant monotonic anchor chain: consensus indel errors make
    # the true alignment's diagonal wander, so a fixed-diagonal window
    # misses most of the span; chain anchors left-to-right allowing the
    # diagonal to drift by <=64 per step
    order = np.lexsort((np.array(diag_list), np.array(match_j)))
    js = np.array(match_j, np.int64)[order]
    ds = np.array(diag_list, np.int64)[order]
    # seed from the modal diagonal (coarse bins), then walk outward in
    # both directions letting the corridor follow the drift
    bins = ds // 64
    vals, counts = np.unique(bins, return_counts=True)
    seed_bin = int(vals[counts.argmax()])
    seed_idx = np.nonzero(bins == seed_bin)[0]
    if not len(seed_idx):
        return False
    s = int(seed_idx[len(seed_idx) // 2])
    chain = 1
    j_min = j_max = int(js[s])
    last_d = int(ds[s])
    last_j = int(js[s])
    for t in range(s + 1, len(js)):  # rightward
        if js[t] <= last_j or abs(int(ds[t]) - last_d) > 64:
            continue
        chain += 1
        last_d = int(ds[t])
        last_j = int(js[t])
        j_max = last_j
    last_d = int(ds[s])
    last_j = int(js[s])
    for t in range(s - 1, -1, -1):  # leftward
        if js[t] >= last_j or abs(int(ds[t]) - last_d) > 64:
            continue
        chain += 1
        last_d = int(ds[t])
        last_j = int(js[t])
        j_min = last_j
    best_chain = chain
    best_span = j_max - j_min + k
    if best_span < min_cover * len(b):
        return False
    # identity via anchor density: exact k-mer match probability at
    # divergence d is ~(1-d)^k; require the chain to beat the
    # max_divergence floor with margin
    min_density = 0.35 * (1.0 - max_divergence) ** k
    return best_chain >= min_density * max(1, len(b) - k + 1)


def drop_contained_contigs(
    contigs: list[np.ndarray], **kw
) -> list[np.ndarray]:
    """Remove contigs contained in a longer kept contig (either strand)."""
    from ..core.sequences import reverse_complement_codes

    contigs = sorted(contigs, key=len, reverse=True)
    kept: list[np.ndarray] = []
    for c in contigs:
        rc = reverse_complement_codes(c)
        contained = any(
            find_containment(kc, c, **kw) or find_containment(kc, rc, **kw)
            for kc in kept
        )
        if not contained:
            kept.append(c)
    return kept
