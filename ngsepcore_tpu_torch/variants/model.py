"""Variant model.

Ref: src/ngsep/variants/GenomicVariant.java (interface + type constants),
GenomicVariantImpl.java, SNV.java, CalledGenomicVariant.java:1-165,
CalledGenomicVariantImpl.java, CalledSNV.java.  Collapsed into two
dataclasses: a GenomicVariant (site + alleles) and a CalledGenomicVariant
(variant + one sample's genotype call with depths/likelihood evidence).
"""
from __future__ import annotations

from dataclasses import dataclass, field

# variant types (ref: GenomicVariant.java TYPENAME_* constants)
TYPE_BIALLELIC_SNV = "SNV"
TYPE_MULTIALLELIC_SNV = "MULTISNV"
TYPE_EMBEDDED = "EMBEDDED"
TYPE_INDEL = "INDEL"
TYPE_STR = "STR"
TYPE_CNV = "CNV"
TYPE_REPEAT = "REPEAT"
TYPE_LARGEDEL = "DEL"
TYPE_LARGEINS = "INS"
TYPE_DUPLICATION = "DUP"
TYPE_INVERSION = "INV"
TYPE_UNDETERMINED = "UNDETERMINED"

# genotype states (ref: CalledGenomicVariant.java GENOTYPE_* constants)
GENOTYPE_UNDECIDED = -1
GENOTYPE_HOMOREF = 0
GENOTYPE_HETERO = 1
GENOTYPE_HOMOALT = 2


@dataclass
class GenomicVariant:
    sequence_name: str
    first: int  # 1-based
    alleles: list[str]  # reference allele first
    variant_type: str = TYPE_BIALLELIC_SNV
    quality: int = 0  # phred-scaled variant QS
    var_id: str | None = None
    last_: int | None = None  # explicit end for SVs
    length_: int | None = None  # explicit event length (e.g. insertions,
    # where last==first+1 but the inserted span is longer; ref:
    # GenomicVariantImpl.setLength)

    @property
    def last(self) -> int:
        if self.last_ is not None:
            return self.last_
        return self.first + len(self.alleles[0]) - 1

    @property
    def reference(self) -> str:
        return self.alleles[0]

    @property
    def is_snv(self) -> bool:
        return all(len(a) == 1 for a in self.alleles)

    @property
    def is_biallelic(self) -> bool:
        return len(self.alleles) == 2

    def length(self) -> int:
        if self.length_ is not None:
            return self.length_
        return self.last - self.first + 1


@dataclass
class CalledGenomicVariant(GenomicVariant):
    """A genotype call for one sample.

    indexes_called_alleles: indices into `alleles` (empty = undecided).
    Ref: CalledGenomicVariantImpl.java.
    """

    sample_id: str | None = None
    indexes_called_alleles: list[int] = field(default_factory=list)
    genotype_quality: int = 0
    total_read_depth: int = 0
    allele_depths: list[int] = field(default_factory=list)  # per allele (ADP)
    acgt_depths: list[int] = field(default_factory=list)  # BSDP for SNVs
    genotype_likelihoods: list[int] = field(default_factory=list)  # phred PL
    copy_number: int = 2
    allele_copy_numbers: list[int] = field(default_factory=list)
    phased: bool = False

    @property
    def is_undecided(self) -> bool:
        return len(self.indexes_called_alleles) == 0

    @property
    def is_homozygous(self) -> bool:
        return len(set(self.indexes_called_alleles)) == 1 and not self.is_undecided

    @property
    def is_homozygous_reference(self) -> bool:
        return self.is_homozygous and self.indexes_called_alleles[0] == 0

    @property
    def is_heterozygous(self) -> bool:
        return len(set(self.indexes_called_alleles)) > 1

    @property
    def genotype_state(self) -> int:
        if self.is_undecided:
            return GENOTYPE_UNDECIDED
        if self.is_heterozygous:
            return GENOTYPE_HETERO
        if self.indexes_called_alleles[0] == 0:
            return GENOTYPE_HOMOREF
        return GENOTYPE_HOMOALT

    def called_alleles(self) -> list[str]:
        return [self.alleles[i] for i in self.indexes_called_alleles]
