"""VCF reading/writing.

Ref: src/ngsep/vcf/VCFFileReader.java:54-118 (iterator, load modes, static
loaders :585-623), VCFFileWriter.java:37-70 (record serialization order),
VCFRecord.java:42-120 (NGSEP FORMAT fields; default FORMAT vectors — SNV
records GT:PL:GQ:DP:BSDP:ACN, non-SNV GT:PL:GQ:DP:ADP:ACN at :119-120),
VCFFileHeader.java:48-70 (default INFO/FORMAT header lines).
"""
from __future__ import annotations

import io
from dataclasses import dataclass, field
from typing import Iterator

from ..io.fasta import _open_text, _open_write
from ..variants.model import CalledGenomicVariant, GenomicVariant, TYPE_BIALLELIC_SNV

DEFAULT_FORMAT_SNV = "GT:PL:GQ:DP:BSDP:ACN"  # ref: VCFRecord.java:119
DEFAULT_FORMAT_NON_SNV = "GT:PL:GQ:DP:ADP:ACN"  # ref: VCFRecord.java:120

_DEFAULT_HEADER_LINES = [
    '##INFO=<ID=CNV,Number=1,Type=Integer,Description="Number of samples with CNVs around this variant">',
    '##INFO=<ID=TA,Number=1,Type=String,Description="Variant annotation based on a gene model">',
    '##INFO=<ID=TID,Number=1,Type=String,Description="Id of the transcript related to the variant annotation">',
    '##INFO=<ID=TGN,Number=1,Type=String,Description="Name of the gene related to the variant annotation">',
    '##INFO=<ID=TCO,Number=1,Type=Float,Description="One based codon position of the start of the variant. The decimal is the codon position">',
    '##INFO=<ID=TACH,Number=1,Type=String,Description="Description of the aminoacid change produced by a non-synonymous mutation. String encoded as reference aminoacid, position and mutated aminoacid">',
    '##INFO=<ID=NS,Number=1,Type=Integer,Description="Number of samples genotyped">',
    '##INFO=<ID=MAF,Number=1,Type=Float,Description="Minor allele frequency">',
    '##INFO=<ID=OH,Number=1,Type=Float,Description="Observed heterozygosity">',
    '##INFO=<ID=NA,Number=1,Type=Integer,Description="Number of alleles in called genotypes">',
    '##INFO=<ID=AFS,Number=R,Type=Integer,Description="Allele counts over the population for all alleles, including the reference">',
    '##INFO=<ID=TYPE,Number=1,Type=String,Description="Type of variant">',
    '##INFO=<ID=FS,Number=1,Type=Float,Description="Phred-scaled p-value using Fisher\'s exact test to detect strand bias">',
    '##INFO=<ID=END,Number=1,Type=Integer,Description="End position of the structural variant">',
    '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of SV:DEL=Deletion, INS=Insertion, DUP=Duplication, INV=Inversion">',
    '##INFO=<ID=SVLEN,Number=1,Type=Integer,Description="Difference in length between REF and ALT alleles">',
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
    '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Phred-scaled genotype likelihoods rounded to the closest integer">',
    '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">',
    '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth">',
    '##FORMAT=<ID=ADP,Number=R,Type=Integer,Description="Counts for observed alleles, including the reference allele">',
    '##FORMAT=<ID=BSDP,Number=4,Type=Integer,Description="Number of base calls (depth) for the 4 nucleotides in called SNVs sorted as A,C,G,T">',
    '##FORMAT=<ID=ACN,Number=R,Type=Integer,Description="Predicted copy number of each allele taking into account the prediction of number of copies of the region surrounding the variant">',
]


@dataclass
class VCFRecord:
    variant: GenomicVariant
    calls: list[CalledGenomicVariant] = field(default_factory=list)
    info: dict = field(default_factory=dict)
    filters: list[str] = field(default_factory=list)
    format_str: str | None = None

    def default_format(self) -> str:
        if self.variant.is_snv and self.variant.variant_type in (
            TYPE_BIALLELIC_SNV,
            "MULTISNV",
        ):
            return DEFAULT_FORMAT_SNV
        return DEFAULT_FORMAT_NON_SNV


class VCFFileWriter:
    def __init__(
        self,
        path_or_fh,
        sample_ids: list[str],
        extra_header_lines: list[str] | None = None,
    ):
        self._own = isinstance(path_or_fh, str)
        self.fh = _open_write(path_or_fh) if self._own else path_or_fh
        self.sample_ids = sample_ids
        self.fh.write("##fileformat=VCFv4.2\n")
        for line in _DEFAULT_HEADER_LINES:
            self.fh.write(line + "\n")
        if extra_header_lines:
            for line in extra_header_lines:
                self.fh.write(line + "\n")
        cols = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO", "FORMAT"]
        cols.extend(sample_ids)
        self.fh.write("\t".join(cols) + "\n")

    def write(self, record: VCFRecord) -> None:
        v = record.variant
        alts = v.alleles[1:]
        info = dict(record.info)
        if not v.is_snv or v.variant_type not in ("SNV",):
            info.setdefault("TYPE", v.variant_type)
        info_str = (
            ";".join(f"{k}={vv}" if vv is not None else k for k, vv in info.items())
            or "."
        )
        fmt = record.format_str or record.default_format()
        fields = [
            v.sequence_name,
            str(v.first),
            v.var_id or ".",
            v.alleles[0],
            ",".join(alts) if alts else ".",
            str(v.quality) if v.quality > 0 else ".",
            ";".join(record.filters) if record.filters else ".",
            info_str,
            fmt,
        ]
        for call in record.calls:
            fields.append(self._format_call(call, fmt))
        self.fh.write("\t".join(fields) + "\n")

    @staticmethod
    def _format_call(c: CalledGenomicVariant, fmt: str) -> str:
        parts = []
        for key in fmt.split(":"):
            if key == "GT":
                if c.is_undecided:
                    parts.append("./.")
                else:
                    idxs = sorted(c.indexes_called_alleles)
                    # a homozygous call stored as one allele prints at ploidy
                    if len(idxs) == 1 and c.copy_number >= 2:
                        idxs = idxs * c.copy_number
                    parts.append("/".join(str(i) for i in idxs))
            elif key == "PL":
                parts.append(
                    ",".join(str(x) for x in c.genotype_likelihoods)
                    if c.genotype_likelihoods
                    else "."
                )
            elif key == "GQ":
                parts.append(str(c.genotype_quality) if not c.is_undecided else ".")
            elif key == "DP":
                parts.append(str(c.total_read_depth))
            elif key == "BSDP":
                parts.append(
                    ",".join(str(x) for x in c.acgt_depths) if c.acgt_depths else "."
                )
            elif key == "ADP":
                parts.append(
                    ",".join(str(x) for x in c.allele_depths) if c.allele_depths else "."
                )
            elif key == "ACN":
                acns = c.allele_copy_numbers
                if not acns and not c.is_undecided:
                    # distribute the region copy number over called alleles
                    # (ref: CalledGenomicVariant.updateAllelesCopyNumberFromCounts)
                    acns = [0] * len(c.alleles)
                    called = sorted(set(c.indexes_called_alleles))
                    share = c.copy_number // len(called)
                    for i in called:
                        acns[i] = share
                    acns[called[0]] += c.copy_number - share * len(called)
                parts.append(",".join(str(x) for x in acns) if acns else ".")
            else:
                parts.append(".")
        return ":".join(parts)

    def close(self) -> None:
        if self._own:
            self.fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class VCFFileReader:
    def __init__(self, path: str):
        self.path = path
        self.sample_ids: list[str] = []
        self.header_lines: list[str] = []

    def __iter__(self) -> Iterator[VCFRecord]:
        with _open_text(self.path) as fh:
            for line in fh:
                line = line.rstrip("\n")
                if not line:
                    continue
                if line.startswith("##"):
                    self.header_lines.append(line)
                    continue
                if line.startswith("#CHROM"):
                    cols = line.split("\t")
                    self.sample_ids = cols[9:] if len(cols) > 9 else []
                    continue
                rec = parse_vcf_line(line, self.sample_ids)
                if rec is not None:
                    yield rec

    def load_all(self) -> list[VCFRecord]:
        return list(self)


def parse_vcf_line(line: str, sample_ids: list[str]) -> VCFRecord | None:
    f = line.split("\t")
    if len(f) < 8:
        return None
    alleles = [f[3]]
    if f[4] != ".":
        alleles.extend(f[4].split(","))
    info: dict = {}
    if f[7] != ".":
        for item in f[7].split(";"):
            if "=" in item:
                k, v = item.split("=", 1)
                info[k] = v
            else:
                info[item] = None
    vtype = info.get("TYPE")
    if vtype is None:
        vtype = "SNV" if all(len(a) == 1 for a in alleles) else "INDEL"
    quality = 0
    if f[5] not in (".", ""):
        quality = int(round(float(f[5])))
    variant = GenomicVariant(
        sequence_name=f[0],
        first=int(f[1]),
        alleles=alleles,
        variant_type=vtype,
        quality=quality,
        var_id=None if f[2] == "." else f[2],
    )
    if "END" in info:
        variant.last_ = int(info["END"])
    filters = [] if f[6] in (".", "PASS") else f[6].split(";")
    calls: list[CalledGenomicVariant] = []
    if len(f) > 9:
        fmt_keys = f[8].split(":")
        for si, sample_field in enumerate(f[9:]):
            call = _parse_call(variant, sample_field, fmt_keys)
            call.sample_id = sample_ids[si] if si < len(sample_ids) else str(si)
            calls.append(call)
    return VCFRecord(variant=variant, calls=calls, info=info, filters=filters, format_str=f[8] if len(f) > 8 else None)


def _parse_call(
    variant: GenomicVariant, field_str: str, fmt_keys: list[str]
) -> CalledGenomicVariant:
    call = CalledGenomicVariant(
        sequence_name=variant.sequence_name,
        first=variant.first,
        alleles=variant.alleles,
        variant_type=variant.variant_type,
        quality=variant.quality,
    )
    values = field_str.split(":")
    for k, v in zip(fmt_keys, values):
        if v == ".":
            continue
        if k == "GT":
            gt = v.replace("|", "/")
            call.phased = "|" in v
            if "." not in gt:
                call.indexes_called_alleles = [int(x) for x in gt.split("/")]
        elif k == "GQ":
            call.genotype_quality = int(v)
        elif k == "DP":
            call.total_read_depth = int(v)
        elif k == "PL":
            call.genotype_likelihoods = [int(x) for x in v.split(",") if x != "."]
        elif k == "BSDP":
            call.acgt_depths = [int(x) for x in v.split(",")]
        elif k in ("ADP", "AD"):
            call.allele_depths = [int(x) for x in v.split(",")]
        elif k == "ACN":
            call.allele_copy_numbers = [int(x) for x in v.split(",")]
    return call
