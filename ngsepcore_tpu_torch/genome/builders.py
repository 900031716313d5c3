"""Genome construction/masking utilities.

Ref: src/ngsep/vcf/VCFIndividualGenomeBuilder.java (command
`IndividualGenomeBuilder`: apply VCF variants to a genome FASTA) and
src/ngsep/genome/GenomeAssemblyMask.java (command `GenomeAssemblyMask`:
mask regions with N or lowercase), and the 3-column region files that
SingleSampleVariantsDetector's -knownSTRs and -knownRepeats, VCFFilter's
-frs/-srs and GenomeAssemblyMask read.  A copy of
ngsepcore_tpu/genome/builders.py (host numpy).
"""
from __future__ import annotations

import numpy as np

from ..core.genome import ReferenceGenome
from ..core.regions import GenomicRegion
from ..core.sequences import (
    QualifiedSequence,
    QualifiedSequenceList,
    encode_dna,
)
from ..vcf.io import VCFRecord


def build_individual_genome(
    genome: ReferenceGenome, records: list[VCFRecord], haplotype: int = 0
) -> QualifiedSequenceList:
    """Apply each record's called allele to the genome.

    Heterozygous calls apply the allele of the requested haplotype slot
    (ref applies called alleles building a pseudo-haplotype genome).
    """
    per_seq: dict[str, list[tuple[int, str, str]]] = {}
    for r in records:
        if not r.calls or r.calls[0].is_undecided:
            continue
        call = r.calls[0]
        idxs = call.indexes_called_alleles
        allele_idx = idxs[haplotype % len(idxs)]
        if allele_idx == 0:
            continue
        v = r.variant
        per_seq.setdefault(v.sequence_name, []).append(
            (v.first, v.alleles[0], v.alleles[allele_idx])
        )
    out = QualifiedSequenceList()
    for si in range(genome.num_sequences):
        name = genome.sequence_name(si)
        seq = genome.sequences[si].codes
        variants = sorted(per_seq.get(name, []))
        pieces: list[np.ndarray] = []
        cursor = 0
        for first, ref, alt in variants:
            p0 = first - 1
            if p0 < cursor:
                continue
            pieces.append(seq[cursor:p0])
            pieces.append(encode_dna(alt))
            cursor = p0 + len(ref)
        pieces.append(seq[cursor:])
        out.add(QualifiedSequence(name=name, codes=np.concatenate(pieces)))
    return out


def mask_genome_regions(
    genome: ReferenceGenome, regions: list[GenomicRegion], hard: bool = True
) -> QualifiedSequenceList:
    """Mask regions with N (hard) — soft masking (lowercase) requires the
    string layer, so soft mode returns strings via the FASTA writer path.

    Ref: GenomeAssemblyMask.java.
    """
    out = QualifiedSequenceList()
    by_seq: dict[str, list[GenomicRegion]] = {}
    for r in regions:
        by_seq.setdefault(r.sequence_name, []).append(r)
    for si in range(genome.num_sequences):
        name = genome.sequence_name(si)
        codes = genome.sequences[si].codes.copy()
        for r in by_seq.get(name, []):
            a = max(0, r.first - 1)
            b = min(len(codes), r.last)
            codes[a:b] = 4  # N
        out.add(QualifiedSequence(name=name, codes=codes))
    return out


def load_regions_file(path: str) -> list[GenomicRegion]:
    """3-column text regions (ref: SimpleGenomicRegionFileHandler)."""
    out = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            f = line.split()
            out.append(GenomicRegion(f[0], int(f[1]), int(f[2])))
    return out
