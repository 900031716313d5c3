"""Individual genome simulator — mutate a reference into a diploid (or
arbitrary-ploidy) individual with a truth VCF.

Ref: src/ngsep/simulation/SingleIndividualSimulator.java (command
`SingleIndividualSimulator`): plants SNVs/indels/STR mutations at the given
rates, assigns genotypes by ploidy, and emits the mutated genome FASTA plus
the truth VCF.
"""
from __future__ import annotations


import numpy as np

from ..core.genome import ReferenceGenome
from ..core.sequences import (
    QualifiedSequence,
    QualifiedSequenceList,
    decode_dna,
    encode_dna,
)
from ..variants.model import CalledGenomicVariant, TYPE_BIALLELIC_SNV, TYPE_INDEL
from ..vcf.io import VCFFileWriter, VCFRecord


class SingleIndividualSimulator:
    def __init__(
        self,
        genome: ReferenceGenome,
        snv_rate: float = 0.001,  # ref default DEF_SNV_RATE
        indel_rate: float = 0.0001,
        ploidy: int = 2,
        het_fraction: float = 0.5,
        seed: int = 1,
        sample_id: str = "simulated",
    ):
        self.genome = genome
        self.snv_rate = snv_rate
        self.indel_rate = indel_rate
        self.ploidy = ploidy
        self.het_fraction = het_fraction
        self.rng = np.random.default_rng(seed)
        self.sample_id = sample_id
        self.calls: list[CalledGenomicVariant] = []

    def simulate(self) -> None:
        """Plant variants; populates self.calls (sorted by position)."""
        self.calls = []
        g = self.genome
        for si in range(g.num_sequences):
            seq = g.sequences[si].codes
            L = len(seq)
            n_snv = self.rng.poisson(self.snv_rate * L)
            n_ind = self.rng.poisson(self.indel_rate * L)
            pos_snv = self.rng.choice(L, size=min(n_snv, L), replace=False)
            used = set(int(p) for p in pos_snv)
            for p in sorted(int(x) for x in pos_snv):
                ref_code = int(seq[p])
                if ref_code >= 4:
                    continue
                alt_code = (ref_code + int(self.rng.integers(1, 4))) % 4
                ref, alt = "ACGT"[ref_code], "ACGT"[alt_code]
                het = self.rng.random() < self.het_fraction
                idxs = [0, 1] if het else [1, 1]
                self.calls.append(
                    CalledGenomicVariant(
                        sequence_name=g.sequence_name(si),
                        first=p + 1,
                        alleles=[ref, alt],
                        variant_type=TYPE_BIALLELIC_SNV,
                        sample_id=self.sample_id,
                        indexes_called_alleles=idxs,
                        genotype_quality=255,
                        quality=255,
                    )
                )
            # indels (small, 1-3 bp), avoiding SNV positions and seq borders
            tries = 0
            planted = 0
            while planted < n_ind and tries < 10 * n_ind + 10:
                tries += 1
                p = int(self.rng.integers(10, max(11, L - 10)))
                if any((p + d) in used for d in range(-4, 5)):
                    continue
                ref_code = seq[p : p + 4]
                if np.any(ref_code >= 4):
                    continue
                ilen = int(self.rng.integers(1, 4))
                if self.rng.random() < 0.5:  # deletion of ilen bases after anchor
                    ref = decode_dna(seq[p : p + 1 + ilen])
                    alt = ref[0]
                else:  # insertion after anchor
                    ins = "".join(self.rng.choice(list("ACGT"), size=ilen))
                    ref = decode_dna(seq[p : p + 1])
                    alt = ref + ins
                het = self.rng.random() < self.het_fraction
                idxs = [0, 1] if het else [1, 1]
                for d in range(-4, len(ref) + 4):
                    used.add(p + d)
                self.calls.append(
                    CalledGenomicVariant(
                        sequence_name=g.sequence_name(si),
                        first=p + 1,
                        alleles=[ref, alt],
                        variant_type=TYPE_INDEL,
                        sample_id=self.sample_id,
                        indexes_called_alleles=idxs,
                        genotype_quality=255,
                        quality=255,
                    )
                )
        self.calls.sort(
            key=lambda c: (self.genome.index_of(c.sequence_name), c.first)
        )

    def build_haplotype_genomes(self) -> list[ReferenceGenome]:
        """Apply planted variants per haplotype -> list of ploidy genomes."""
        out = []
        for h in range(self.ploidy):
            seqs = QualifiedSequenceList()
            for si in range(self.genome.num_sequences):
                name = self.genome.sequence_name(si)
                seq = self.genome.sequences[si].codes
                pieces: list[np.ndarray] = []
                cursor = 0  # 0-based
                for c in self.calls:
                    if c.sequence_name != name:
                        continue
                    allele_idx = c.indexes_called_alleles[
                        h % len(c.indexes_called_alleles)
                    ]
                    if allele_idx == 0:
                        continue
                    p0 = c.first - 1
                    if p0 < cursor:
                        continue
                    pieces.append(seq[cursor:p0])
                    pieces.append(encode_dna(c.alleles[allele_idx]))
                    cursor = p0 + len(c.alleles[0])
                pieces.append(seq[cursor:])
                seqs.add(
                    QualifiedSequence(name=name, codes=np.concatenate(pieces))
                )
            out.append(ReferenceGenome(seqs))
        return out

    def write_truth_vcf(self, path: str) -> None:
        with VCFFileWriter(path, [self.sample_id]) as w:
            for c in self.calls:
                w.write(VCFRecord(variant=c, calls=[c]))
