"""Additional transcriptome formats: GTF2, UCSC table, CCDS table, GFF3
writer and annotation combiner.

Ref: src/ngsep/transcriptome/io/ — GTF2TranscriptomeHandler.java (GTF2
`key "value";` attributes, transcript/exon/CDS features keyed by gene_id +
transcript_id), UCSCTranscriptomeHandler.java (knownGene-style table with
0-based starts, exonStarts/exonEnds comma lists, cdsStart/cdsEnd),
CCDSTranscriptomeHandler.java (CCDS current table, `chr` name prefix,
"Withdrawn" rows skipped, [start-end, ...] exon list),
GFF3TranscriptomeWriter.java and GFF3CombineAnnotations.java.  A copy of
ngsepcore_tpu/transcriptome/io_formats.py; the GFF3 writer names
ngsepcore_tpu_torch in its source column.
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


def _gtf_attrs(parts: list[str]) -> dict[str, str]:
    out = {}
    for item in parts:
        item = item.strip()
        if not item:
            continue
        if " " in item:
            k, v = item.split(" ", 1)
            out[k.strip()] = v.strip().strip('"')
    return out


def load_transcriptome_gtf2(path: str) -> Transcriptome:
    """GTF2 reader (GTF2TranscriptomeHandler.loadMap)."""
    t = Transcriptome()
    exons: dict[str, list[tuple[int, int, str]]] = {}
    meta: dict[str, tuple[str, bool, str]] = {}  # tid -> (seq, neg, gene_id)
    with _open_text(path) as fh:
        for line in fh:
            if not line.strip() or line.startswith("#"):
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 9:
                continue
            seq, _, ftype, first_s, last_s, _, strand, _, attrs_s = fields[:9]
            if strand == ".":
                continue
            first, last = int(first_s), int(last_s)
            neg = strand == "-"
            attrs = _gtf_attrs(attrs_s.split(";"))
            gid = attrs.get("gene_id")
            tid = attrs.get("transcript_id")
            if not gid or not tid:
                continue
            gname = attrs.get("ref_gene_name") or gid
            if ftype == "transcript":
                meta[tid] = (seq, neg, gid)
                if gid not in t.genes:
                    t.add_gene(Gene(gid, gname, seq, first, last, neg))
                else:
                    g = t.genes[gid]
                    g.first = min(g.first, first)
                    g.last = max(g.last, last)
            elif ftype in ("exon", "CDS", "5UTR", "3UTR", "start_codon", "stop_codon"):
                meta.setdefault(tid, (seq, neg, gid))
                status = {
                    "exon": NONCODING,
                    "CDS": CODING,
                    "start_codon": CODING,
                    "stop_codon": CODING,
                    "5UTR": UTR5,
                    "3UTR": UTR3,
                }[ftype]
                exons.setdefault(tid, []).append((first, last, status))
    for tid, segs in exons.items():
        seq, neg, gid = meta[tid]
        segs.sort()
        first = min(s[0] for s in segs)
        last = max(s[1] for s in segs)
        tr = Transcript(tid, seq, first, last, neg, gene_id=gid)
        _attach_segments(tr, segs)
        t.add_transcript(tr)
        if gid not in t.genes:
            t.add_gene(Gene(gid, gid, seq, first, last, neg))
    return t


def _attach_segments(tr: Transcript, segs: list[tuple[int, int, str]]) -> None:
    """Coding segments override overlapped plain-exon intervals."""
    for first, last, status in segs:
        if status == NONCODING:
            tr.segments.append(
                TranscriptSegment(tr.sequence_name, first, last, tr.negative_strand,
                                  status=status)
            )
        else:
            tr.segments = [
                s
                for s in tr.segments
                if not (s.status == NONCODING and s.first <= last and first <= s.last)
            ]
            tr.segments.append(
                TranscriptSegment(tr.sequence_name, first, last, tr.negative_strand,
                                  status=status)
            )


def load_transcriptome_ucsc(path: str) -> Transcriptome:
    """UCSC knownGene-style table (UCSCTranscriptomeHandler.loadMap):
    name chrom strand txStart txEnd cdsStart cdsEnd exonCount exonStarts
    exonEnds [proteinID]; starts are 0-based half-open."""
    t = Transcriptome()
    with _open_text(path) as fh:
        for line in fh:
            if not line.strip() or line.startswith("#"):
                continue
            items = line.rstrip("\n").split("\t")
            if len(items) < 10:
                continue
            tid = items[0]
            seq = items[1]
            neg = items[2].startswith("-")
            first = int(items[3]) + 1
            last = int(items[4])
            cds_first = int(items[5]) + 1
            cds_last = int(items[6])
            coding = cds_last >= cds_first
            gid = items[0]
            if len(items) > 10 and items[10] and items[10] != "n/a":
                gid = items[10]
            g = t.genes.get(gid)
            if g is None:
                t.add_gene(Gene(gid, gid, seq, first, last, neg))
            else:
                g.first = min(g.first, first)
                g.last = max(g.last, last)
            tr = Transcript(tid, seq, first, last, neg, gene_id=gid)
            starts = [int(x) + 1 for x in items[8].rstrip(",").split(",") if x]
            ends = [int(x) for x in items[9].rstrip(",").split(",") if x]
            for es, ee in zip(starts, ends):
                if not coding:
                    segs = [(es, ee, NONCODING)]
                else:
                    segs = []
                    if es < cds_first:
                        utr = UTR3 if neg else UTR5
                        segs.append((es, min(ee, cds_first - 1), utr))
                    cs, ce = max(es, cds_first), min(ee, cds_last)
                    if cs <= ce:
                        segs.append((cs, ce, CODING))
                    if ee > cds_last:
                        utr = UTR5 if neg else UTR3
                        segs.append((max(es, cds_last + 1), ee, utr))
                for f_, l_, st in segs:
                    tr.segments.append(TranscriptSegment(seq, f_, l_, neg, status=st))
            t.add_transcript(tr)
    return t


def load_transcriptome_ccds(path: str, seq_name_prefix: str = "chr") -> Transcriptome:
    """CCDS current table (CCDSTranscriptomeHandler.loadMap): skips
    Withdrawn rows and '-' locations; exon list is '[from-to, ...]' of
    0-based coordinates."""
    t = Transcriptome()
    with _open_text(path) as fh:
        for line in fh:
            if not line.strip() or line.startswith("#"):
                continue
            items = line.rstrip("\n").split("\t")
            if len(items) < 10:
                continue
            if items[5].startswith("Withdrawn") or items[7] == "-":
                continue
            seq = seq_name_prefix + items[0]
            neg = items[6].startswith("-")
            first = int(items[7]) + 1
            last = int(items[8]) + 1
            gid, gname, tid = items[3], items[2], items[4]
            g = t.genes.get(gid)
            if g is None:
                t.add_gene(Gene(gid, gname, seq, first, last, neg))
            else:
                g.first = min(g.first, first)
                g.last = max(g.last, last)
            tr = Transcript(tid, seq, first, last, neg, gene_id=gid)
            for part in items[9].strip("[]").split(","):
                part = part.strip()
                if not part or "-" not in part:
                    continue
                a, b = part.split("-", 1)
                tr.segments.append(
                    TranscriptSegment(seq, int(a) + 1, int(b) + 1, neg, status=CODING)
                )
            t.add_transcript(tr)
    return t


def write_transcriptome_gff3(t: Transcriptome, path: str) -> None:
    """GFF3 writer (GFF3TranscriptomeWriter.java)."""
    type_of = {CODING: "CDS", UTR5: "five_prime_UTR", UTR3: "three_prime_UTR",
               NONCODING: "exon"}
    with open(path, "w") as out:
        out.write("##gff-version 3\n")
        for g in t.genes.values():
            strand = "-" if g.negative_strand else "+"
            out.write(
                f"{g.sequence_name}\tngsepcore_tpu_torch\tgene\t{g.first}\t{g.last}\t.\t"
                f"{strand}\t.\tID={g.gene_id};Name={g.name or g.gene_id}\n"
            )
        for tr in t.transcripts.values():
            strand = "-" if tr.negative_strand else "+"
            parent = f";Parent={tr.gene_id}" if tr.gene_id else ""
            out.write(
                f"{tr.sequence_name}\tngsepcore_tpu_torch\tmRNA\t{tr.first}\t{tr.last}\t.\t"
                f"{strand}\t.\tID={tr.transcript_id}{parent}\n"
            )
            for s in tr.exons_sorted():
                out.write(
                    f"{s.sequence_name}\tngsepcore_tpu_torch\t{type_of[s.status]}\t"
                    f"{s.first}\t{s.last}\t.\t{strand}\t.\t"
                    f"Parent={tr.transcript_id}\n"
                )


def combine_annotations(base: Transcriptome, extra: Transcriptome) -> Transcriptome:
    """Merge two transcriptomes; `extra` transcripts are added where their
    id is absent (GFF3CombineAnnotations.java)."""
    for gid, g in extra.genes.items():
        if gid not in base.genes:
            base.add_gene(g)
    for tid, tr in extra.transcripts.items():
        if tid not in base.transcripts:
            base.add_transcript(tr)
    return base


def load_transcriptome(path: str, fmt: str | None = None) -> Transcriptome:
    """Format dispatch by extension: .gff/.gff3 -> GFF3, .gtf -> GTF2,
    else UCSC/CCDS via fmt."""
    from .gff3 import load_transcriptome_gff3

    low = path.lower()
    fmt = (fmt or "").lower()
    if fmt == "gff3" or low.endswith((".gff", ".gff3", ".gff.gz", ".gff3.gz")):
        return load_transcriptome_gff3(path)
    if fmt == "gtf2" or low.endswith((".gtf", ".gtf.gz")):
        return load_transcriptome_gtf2(path)
    if fmt == "ucsc":
        return load_transcriptome_ucsc(path)
    if fmt == "ccds":
        return load_transcriptome_ccds(path)
    return load_transcriptome_gff3(path)
