"""UNEAK (TASSEL) HapMap -> VCF converter.

Converts the HapMap genotype table + tag-pair consensus FASTA that the
UNEAK GBS pipeline emits into an NGSEP-convention VCF plus a per-site
consensus FASTA (one sequence per SNP, named by the site, usable as a
pseudo-reference for the VCF coordinates).

Ref: src/ngsep/gbs/UneakToVCFConverter.java:31-101 —
- samples are HapMap columns 12+ (0-based index 11+);
- each HapMap data row corresponds to a PAIR of consecutive consensus
  sequences (query/hit tags); the SNP position is the first offset where
  tag1 carries allele1 and tag2 carries allele2 (1-based; 0 if absent);
- genotype letters: 'N' -> undecided, ref letter -> 0/0, alt letter ->
  1/1, anything else (IUPAC het code) -> 0/1;
- output VCF uses the minimal GT-only FORMAT (DEF_FORMAT_ARRAY_MINIMAL,
  VCFRecord.java:116).

A copy of ngsepcore_tpu/gbs/uneak.py (host code).
"""
from __future__ import annotations

from ..core.sequences import QualifiedSequence, QualifiedSequenceList, decode_dna
from ..io.fasta import load_fasta, save_fasta
from ..variants.model import (
    CalledGenomicVariant,
    GenomicVariant,
    TYPE_BIALLELIC_SNV,
)
from ..vcf.io import VCFFileWriter, VCFRecord


def _site_position(a1: str, a2: str, s1: str, s2: str) -> int:
    """First 1-based offset where tag1==a1 and tag2==a2 (ref :86-93)."""
    for i, (c1, c2) in enumerate(zip(s1, s2)):
        if c1 == a1 and c2 == a2:
            return i + 1
    return 0


def _make_call(variant: GenomicVariant, genotype: str, sample_id: str
               ) -> CalledGenomicVariant:
    """Genotype letter -> called SNV (ref makeCalledSNV :95-101)."""
    g = genotype[0] if genotype else "N"
    if g == "N":
        idx: list[int] = []
    elif g == variant.alleles[0]:
        idx = [0, 0]
    elif g == variant.alleles[1]:
        idx = [1, 1]
    else:  # IUPAC heterozygous code
        idx = [0, 1]
    call = CalledGenomicVariant(
        sequence_name=variant.sequence_name,
        first=variant.first,
        alleles=variant.alleles,
        variant_type=variant.variant_type,
        indexes_called_alleles=idx,
    )
    call.sample_id = sample_id
    return call


def convert_uneak(hapmap_file: str, consensus_file: str, out_prefix: str
                  ) -> tuple[int, int]:
    """Convert UNEAK output; writes <prefix>.vcf and <prefix>_consensus.fa.

    Returns (n_sites, n_samples)."""
    seqs = load_fasta(consensus_file)
    consensus = QualifiedSequenceList()
    records: list[VCFRecord] = []
    sample_ids: list[str] = []
    with open(hapmap_file) as fh:
        header = fh.readline().rstrip("\n")
        sample_ids = header.split("\t")[11:]
        pair = 0
        for line in fh:
            items = line.rstrip("\n").split("\t")
            if len(items) < 12:
                continue
            a1, a2 = items[1][0], items[1][2]
            s1 = decode_dna(seqs[pair].codes)
            s2 = decode_dna(seqs[pair + 1].codes)
            pair += 2
            seq_name = items[0]
            pos = _site_position(a1, a2, s1, s2)
            consensus.add(QualifiedSequence(name=seq_name,
                                            codes=seqs[pair - 2].codes))
            variant = GenomicVariant(
                sequence_name=seq_name, first=pos, alleles=[a1, a2],
                variant_type=TYPE_BIALLELIC_SNV,
            )
            calls = [
                _make_call(variant, items[11 + j], sid)
                for j, sid in enumerate(sample_ids)
            ]
            records.append(
                VCFRecord(variant=variant, calls=calls, format_str="GT")
            )
    save_fasta(consensus, out_prefix + "_consensus.fa", line_length=100)
    with VCFFileWriter(out_prefix + ".vcf", sample_ids) as writer:
        for rec in records:
            writer.write(rec)
    return len(records), len(sample_ids)
