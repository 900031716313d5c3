"""GFF3 gene-model reader.

Ref: src/ngsep/transcriptome/io/GFF3TranscriptomeHandler.java (+ the
genome-level GFF3Loader).  Supports the usual gene -> mRNA -> exon/CDS/
five_prime_UTR/three_prime_UTR hierarchy.  A copy of
ngsepcore_tpu/transcriptome/gff3.py.
"""
from __future__ import annotations

from ..io.fasta import _open_text
from .model import (
    CODING,
    NONCODING,
    UTR3,
    UTR5,
    Gene,
    Transcript,
    TranscriptSegment,
    Transcriptome,
)

_TRANSCRIPT_TYPES = {
    "mRNA", "transcript", "tRNA", "rRNA", "ncRNA", "lnc_RNA", "snoRNA",
    "snRNA", "miRNA", "pseudogenic_transcript",
}


def _attrs(field: str) -> dict[str, str]:
    out = {}
    for item in field.split(";"):
        if "=" in item:
            k, v = item.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def load_transcriptome_gff3(path: str) -> Transcriptome:
    t = Transcriptome()
    pending_segments: list[tuple[str, TranscriptSegment]] = []
    with _open_text(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 9:
                continue
            seq, _, ftype, first, last, _, strand, _, attrs_s = f[:9]
            first, last = int(first), int(last)
            neg = strand == "-"
            attrs = _attrs(attrs_s)
            fid = attrs.get("ID")
            parent = attrs.get("Parent")
            if ftype == "gene":
                t.add_gene(
                    Gene(
                        gene_id=fid or f"gene_{seq}_{first}",
                        name=attrs.get("Name"),
                        sequence_name=seq,
                        first=first,
                        last=last,
                        negative_strand=neg,
                    )
                )
            elif ftype in _TRANSCRIPT_TYPES:
                t.add_transcript(
                    Transcript(
                        transcript_id=fid or f"t_{seq}_{first}",
                        sequence_name=seq,
                        first=first,
                        last=last,
                        negative_strand=neg,
                        gene_id=parent,
                    )
                )
            elif ftype in ("exon", "CDS", "five_prime_UTR", "three_prime_UTR"):
                status = {
                    "CDS": CODING,
                    "five_prime_UTR": UTR5,
                    "three_prime_UTR": UTR3,
                    "exon": NONCODING,
                }[ftype]
                for pid in (parent or "").split(","):
                    pending_segments.append(
                        (pid, TranscriptSegment(seq, first, last, neg, status=status))
                    )
    # attach segments; CDS overrides plain exon intervals
    for pid, seg in pending_segments:
        tr = t.transcripts.get(pid)
        if tr is None:
            continue
        if seg.status == NONCODING:
            # skip exon records fully covered by a CDS/UTR record later
            tr.segments.append(seg)
        else:
            # remove overlapped noncoding exon placeholders
            tr.segments = [
                s
                for s in tr.segments
                if not (s.status == NONCODING and s.first <= seg.last and seg.first <= s.last)
            ]
            tr.segments.append(seg)
    return t
