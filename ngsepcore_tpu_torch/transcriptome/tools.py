"""Transcriptome filtering and mutated peptide extraction.

Ref: src/ngsep/transcriptome/TranscriptomeFilter.java (command
`TranscriptomeFilter`: filter/convert gene annotations) and
MutatedPeptidesExtractor.java (hidden command `MutatedPeptidesExtractor`:
mutated peptides from variants + gene models).

A copy of ngsepcore_tpu/transcriptome/tools.py (host code).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.genome import ReferenceGenome
from ..core.regions import GenomicRegion
from ..core.sequences import reverse_complement
from ..variants.model import GenomicVariant
from .annotator import VariantFunctionalAnnotator
from .model import CODING, Transcript, Transcriptome
from .protein import ProteinTranslator


def filter_transcriptome(
    transcriptome: Transcriptome,
    regions: list[GenomicRegion] | None = None,
    only_coding: bool = False,
    min_length: int = 0,
    gene_ids: set[str] | None = None,
) -> Transcriptome:
    out = Transcriptome()
    for g in transcriptome.genes.values():
        out.add_gene(g)
    for t in transcriptome.transcripts.values():
        if only_coding and not t.coding:
            continue
        if t.last - t.first + 1 < min_length:
            continue
        if gene_ids is not None and t.gene_id not in gene_ids:
            continue
        if regions is not None:
            hit = any(
                r.sequence_name == t.sequence_name
                and r.first <= t.last
                and t.first <= r.last
                for r in regions
            )
            if not hit:
                continue
        out.add_transcript(t)
    return out


def write_transcriptome_gff3(transcriptome: Transcriptome, path: str) -> None:
    with open(path, "w") as fh:
        fh.write("##gff-version 3\n")
        written_genes = set()
        for t in transcriptome.transcripts.values():
            strand = "-" if t.negative_strand else "+"
            if t.gene_id and t.gene_id in transcriptome.genes and t.gene_id not in written_genes:
                g = transcriptome.genes[t.gene_id]
                fh.write(
                    f"{g.sequence_name}\t.\tgene\t{g.first}\t{g.last}\t.\t"
                    f"{'-' if g.negative_strand else '+'}\t.\tID={g.gene_id}\n"
                )
                written_genes.add(t.gene_id)
            parent = f";Parent={t.gene_id}" if t.gene_id else ""
            fh.write(
                f"{t.sequence_name}\t.\tmRNA\t{t.first}\t{t.last}\t.\t{strand}\t.\t"
                f"ID={t.transcript_id}{parent}\n"
            )
            for s in t.exons_sorted():
                ftype = "CDS" if s.status == CODING else "exon"
                fh.write(
                    f"{t.sequence_name}\t.\t{ftype}\t{s.first}\t{s.last}\t.\t{strand}"
                    f"\t.\tParent={t.transcript_id}\n"
                )


@dataclass
class MutatedPeptide:
    transcript_id: str
    variant_pos: int
    aa_change: str
    peptide: str


def extract_mutated_peptides(
    genome: ReferenceGenome,
    transcriptome: Transcriptome,
    variants: list[GenomicVariant],
    flank_aa: int = 12,
) -> list[MutatedPeptide]:
    """Peptide windows around missense changes (ref: MutatedPeptidesExtractor)."""
    annotator = VariantFunctionalAnnotator(genome, transcriptome)
    translator = ProteinTranslator()
    out: list[MutatedPeptide] = []
    for v in variants:
        ann = annotator.annotate(v)
        if ann.annotation != "missense_variant" or not ann.transcript_id:
            continue
        t = transcriptome.transcripts[ann.transcript_id]
        cds = t.cds_genomic_positions()
        si = genome.index_of(t.sequence_name)
        dna = "".join(genome.reference_string(si, p, p) for p in cds)
        if t.negative_strand:
            dna = "".join(
                reverse_complement(genome.reference_string(si, p, p)) for p in cds
            )
        try:
            idx = cds.index(v.first)
        except ValueError:
            continue
        alt = v.alleles[1][0]
        if t.negative_strand:
            alt = reverse_complement(alt)
        mutated = dna[:idx] + alt + dna[idx + 1 :]
        prot = translator.translate(mutated, trim_at_stop=False)
        codon_idx = idx // 3
        lo = max(0, codon_idx - flank_aa)
        hi = min(len(prot), codon_idx + flank_aa + 1)
        out.append(
            MutatedPeptide(
                transcript_id=t.transcript_id,
                variant_pos=v.first,
                aa_change=ann.aa_change or "",
                peptide=prot[lo:hi],
            )
        )
    return out
