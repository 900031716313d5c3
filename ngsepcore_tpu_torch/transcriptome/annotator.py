"""Variant functional annotation (SO consequence terms).

Ref: src/ngsep/transcriptome/VariantFunctionalAnnotator.java (engine behind
the `VCFAnnotate` command, overlap logic at VCFFunctionalAnnotator.java:
213-273) and VariantFunctionalAnnotationType.java:35-120 (term hierarchy).
Offsets: upstream 1000, downstream 300, splice donor/acceptor 2, splice
region 10 intronic bases (VariantAnnotationParameters.java:4-8).

For each variant the most severe consequence across overlapping
transcripts is reported as TA/TID/TGN INFO fields, exactly the surface the
reference's annotated VCFs carry.

A copy of ngsepcore_tpu/transcriptome/annotator.py (host code).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.genome import ReferenceGenome
from ..core.sequences import reverse_complement
from ..variants.model import GenomicVariant
from ..vcf.io import VCFRecord
from .model import CODING, UTR3, UTR5, Transcript, Transcriptome
from .protein import ProteinTranslator

# offsets (ref: VariantAnnotationParameters.java:4-8)
DEF_UPSTREAM = 1000
DEF_DOWNSTREAM = 300
DEF_SPLICE_DONOR = 2
DEF_SPLICE_ACCEPTOR = 2
DEF_SPLICE_REGION_INTRON = 10

# consequence terms ordered most-severe-first
# (ref: VariantFunctionalAnnotationType.java:35-101)
SEVERITY_ORDER = [
    "splice_donor_variant",
    "splice_acceptor_variant",
    "frameshift_variant",
    "stop_gained",
    "start_lost",
    "stop_lost",
    "missense_variant",
    "inframe_deletion",
    "inframe_insertion",
    "splice_region_variant",
    "synonymous_variant",
    "coding_sequence_variant",
    "5_prime_UTR_variant",
    "3_prime_UTR_variant",
    "non_coding_transcript_exon_variant",
    "intron_variant",
    "upstream_transcript_variant",
    "downstream_transcript_variant",
    "intergenic_variant",
]
_RANK = {t: i for i, t in enumerate(SEVERITY_ORDER)}


@dataclass
class FunctionalAnnotation:
    annotation: str
    transcript_id: str | None = None
    gene_id: str | None = None
    codon: float | None = None
    aa_change: str | None = None


class VariantFunctionalAnnotator:
    def __init__(self, genome: ReferenceGenome, transcriptome: Transcriptome):
        self.genome = genome
        self.transcriptome = transcriptome
        self.translator = ProteinTranslator()

    # ------------------------------------------------------------------
    def annotate(self, variant: GenomicVariant) -> FunctionalAnnotation:
        candidates: list[FunctionalAnnotation] = []
        window = max(DEF_UPSTREAM, DEF_DOWNSTREAM)
        overlapping = self.transcriptome.transcripts_overlapping(
            variant.sequence_name, variant.first - window, variant.last + window
        )
        for t in overlapping:
            ann = self._annotate_transcript(variant, t)
            if ann is not None:
                candidates.append(ann)
        if not candidates:
            return FunctionalAnnotation("intergenic_variant")
        return min(candidates, key=lambda a: _RANK.get(a.annotation, 99))

    # ------------------------------------------------------------------
    def _annotate_transcript(
        self, v: GenomicVariant, t: Transcript
    ) -> FunctionalAnnotation | None:
        pos = v.first
        neg = t.negative_strand
        if pos < t.first or pos > t.last:
            # upstream/downstream by strand
            if not neg:
                before = pos < t.first
            else:
                before = pos > t.last
            dist = min(abs(pos - t.first), abs(pos - t.last))
            if before and dist <= DEF_UPSTREAM:
                return FunctionalAnnotation(
                    "upstream_transcript_variant", t.transcript_id, t.gene_id
                )
            if not before and dist <= DEF_DOWNSTREAM:
                return FunctionalAnnotation(
                    "downstream_transcript_variant", t.transcript_id, t.gene_id
                )
            return None
        seg = t.position_in_exon(pos)
        if seg is None:
            # intronic: check splice sites relative to flanking exons
            exons = t.exons_sorted()
            for e in exons:
                # donor = exon end side toward transcription direction
                d_don = pos - e.last if not neg else e.first - pos
                d_acc = e.first - pos if not neg else pos - e.last
                if 1 <= d_don <= DEF_SPLICE_DONOR:
                    return FunctionalAnnotation(
                        "splice_donor_variant", t.transcript_id, t.gene_id
                    )
                if 1 <= d_acc <= DEF_SPLICE_ACCEPTOR:
                    return FunctionalAnnotation(
                        "splice_acceptor_variant", t.transcript_id, t.gene_id
                    )
                if 1 <= min(abs(pos - e.last), abs(e.first - pos)) <= DEF_SPLICE_REGION_INTRON:
                    return FunctionalAnnotation(
                        "splice_region_variant", t.transcript_id, t.gene_id
                    )
            return FunctionalAnnotation("intron_variant", t.transcript_id, t.gene_id)
        if seg.status == UTR5:
            return FunctionalAnnotation("5_prime_UTR_variant", t.transcript_id, t.gene_id)
        if seg.status == UTR3:
            return FunctionalAnnotation("3_prime_UTR_variant", t.transcript_id, t.gene_id)
        if seg.status != CODING:
            return FunctionalAnnotation(
                "non_coding_transcript_exon_variant", t.transcript_id, t.gene_id
            )
        return self._annotate_coding(v, t)

    # ------------------------------------------------------------------
    def _annotate_coding(self, v: GenomicVariant, t: Transcript) -> FunctionalAnnotation:
        ref, alt = v.alleles[0], v.alleles[1] if len(v.alleles) > 1 else v.alleles[0]
        if len(ref) != len(alt):
            diff = abs(len(ref) - len(alt))
            if diff % 3 != 0:
                return FunctionalAnnotation(
                    "frameshift_variant", t.transcript_id, t.gene_id
                )
            term = "inframe_deletion" if len(ref) > len(alt) else "inframe_insertion"
            return FunctionalAnnotation(term, t.transcript_id, t.gene_id)
        cds = t.cds_genomic_positions()
        try:
            idx = cds.index(v.first)
        except ValueError:
            return FunctionalAnnotation(
                "coding_sequence_variant", t.transcript_id, t.gene_id
            )
        codon_idx = idx // 3
        codon_off = idx % 3
        codon_pos = cds[codon_idx * 3 : codon_idx * 3 + 3]
        if len(codon_pos) < 3:
            return FunctionalAnnotation(
                "coding_sequence_variant", t.transcript_id, t.gene_id
            )
        si = self.genome.index_of(t.sequence_name)
        bases = [self.genome.reference_string(si, p, p) for p in codon_pos]
        if t.negative_strand:
            bases = [reverse_complement(b) for b in bases]
        ref_codon = "".join(bases)
        alt_base = alt[0] if not t.negative_strand else reverse_complement(alt[0])
        alt_codon = (
            ref_codon[:codon_off] + alt_base + ref_codon[codon_off + 1 :]
        )
        ref_aa = self.translator.translate_codon(ref_codon)
        alt_aa = self.translator.translate_codon(alt_codon)
        codon_number = codon_idx + 1
        aa_change = f"{ref_aa}{codon_number}{alt_aa}"
        if ref_aa == alt_aa:
            term = "synonymous_variant"
        elif alt_aa == "*":
            term = "stop_gained"
        elif ref_aa == "*":
            term = "stop_lost"
        elif codon_number == 1 and ref_aa == "M":
            term = "start_lost"
        else:
            term = "missense_variant"
        return FunctionalAnnotation(
            term, t.transcript_id, t.gene_id,
            codon=codon_number + codon_off / 10.0, aa_change=aa_change,
        )

    # ------------------------------------------------------------------
    def annotate_records(self, records: list[VCFRecord]) -> None:
        """Set TA/TID/TGN/TCO/TACH INFO fields (ref annotated-VCF surface)."""
        for r in records:
            ann = self.annotate(r.variant)
            r.info["TA"] = ann.annotation
            if ann.transcript_id:
                r.info["TID"] = ann.transcript_id
            if ann.gene_id:
                r.info["TGN"] = ann.gene_id
            if ann.codon is not None:
                r.info["TCO"] = f"{ann.codon:.1f}"
            if ann.aa_change:
                r.info["TACH"] = ann.aa_change
