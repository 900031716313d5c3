"""Alignment-based indel error correction of reads against a draft
assembly.

Ref: src/ngsep/assembly/AlignmentBasedIndelErrorsCorrector.java (used by
the error-correction rounds at Assembler.java:415): reads are aligned to
the draft contigs and their indel errors — insertions absent from the
consensus and deletions of consensus bases — are corrected toward the
consensus, while substitutions are LEFT UNTOUCHED so heterozygous SNV
signal survives for phasing.

The batched long-read aligner produces the alignments on the caller's
device; the correction itself is a sparse per-read CIGAR walk (indels are
rare), so it stays host-side.  Same results as
ngsepcore_tpu/assembly/read_correction.py.
"""
from __future__ import annotations

import numpy as np

from ..core.genome import ReferenceGenome
from ..core.sequences import (
    QualifiedSequence,
    QualifiedSequenceList,
)


def correct_reads_indels(
    contigs: list[np.ndarray], reads: list[np.ndarray], batch: int = 256, *, device
) -> tuple[list[np.ndarray], int]:
    """Correct indel errors in `reads` (code arrays) against the draft.

    Returns (corrected reads — aligned orientation for aligned reads,
    originals for unaligned —, number of indel events corrected).
    Orientation is irrelevant downstream: graph construction uses
    canonical-strand minimizers."""
    from ..align.long_reads import LongReadsAligner
    from ..core.sequences import RawRead, decode_dna

    seqs = QualifiedSequenceList()
    for i, c in enumerate(contigs):
        seqs.add(QualifiedSequence(name=f"c{i}", codes=c))
    genome = ReferenceGenome(seqs)
    aligner = LongReadsAligner(genome, device=device)
    name_to_contig = {f"c{i}": c for i, c in enumerate(contigs)}
    raw = [
        RawRead(name=str(i), sequence=decode_dna(r), _codes=r)
        for i, r in enumerate(reads)
    ]
    out = list(reads)
    n_events = 0
    for b0 in range(0, len(raw), batch):
        for group in aligner.align_batch(raw[b0 : b0 + batch]):
            for a in group:
                if a.is_unmapped or a.is_secondary:
                    continue
                cig = a.cigar
                if not any(op in ("I", "D", "N") for _, op in cig):
                    continue
                contig = name_to_contig[a.sequence_name]
                rc = a.read_codes
                pieces = []
                ridx = 0
                ref = a.first - 1  # 0-based contig cursor
                events = 0
                for l, op in cig:
                    if op in ("M", "=", "X", "S"):
                        pieces.append(rc[ridx : ridx + l])
                        ridx += l
                        if op != "S":
                            ref += l
                    elif op == "I":
                        ridx += l  # spurious insertion: drop
                        events += 1
                    elif op in ("D", "N"):
                        pieces.append(contig[ref : ref + l])  # restore
                        ref += l
                        events += 1
                if events:
                    idx = int(a.read_name)
                    out[idx] = np.ascontiguousarray(
                        np.concatenate(pieces).astype(np.int8)
                    )
                    n_events += events
                break  # primary only
    return out, n_events
