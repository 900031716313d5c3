"""Translate de-novo GBS cluster variant coordinates to reference coords.

Ref: src/ngsep/gbs/VCFRelativeCoordinatesTranslator.java:204-448 (command
`VCFRelativeCoordinatesTranslator`): SNV records called on cluster
consensus sequences map to genome coordinates through alignments of the
consensus sequences; the reference base is RE-FETCHED from the genome at
the translated position and the allele set is rebuilt around it
(ref/alt swap when the consensus carried the alternative), strand-flipped
alleles and ACGT depths on reverse alignments, triallelic results counted
and dropped (the reference emits calls only for biallelic SNVs), and a
statistics report mirroring printStatistics (:248-280).

Deviation noted: ReadAlignment.getReferencePositionReverse in the
reference walks the CIGAR with an arithmetic bug for gapped alignments
(`currentRefPos - readPos - currentReadPos`); this implementation maps
the consensus position through the aligned orientation exactly (position
p in consensus orientation = aligned-read position len-1-p on reverse
alignments), which agrees with the reference on gapless alignments.

A copy of ngsepcore_tpu/gbs/translator.py (host code).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..core.sequences import reverse_complement
from ..variants.model import (
    CalledGenomicVariant,
    TYPE_BIALLELIC_SNV,
    TYPE_MULTIALLELIC_SNV,
)
from ..vcf.io import VCFRecord

_DNA = set("ACGT")


@dataclass
class TranslationStats:
    """Counters mirroring VCFRelativeCoordinatesTranslator.printStatistics."""

    total: int = 0
    translated: int = 0
    biallelic: int = 0
    triallelic: int = 0
    not_snv: int = 0
    record_without_align: int = 0
    untranslated: int = 0
    ref_seq_less0: int = 0
    not_dna: int = 0
    non_variant: int = 0
    ref_not_in_alleles: int = 0
    true_calls_null: int = 0
    extra: dict = field(default_factory=dict)

    def report(self) -> str:
        lines = [
            f"Total number of records in relative VCF: {self.total}",
            f"Number of translated records: {self.translated}",
            f"Number of translated biallelic variants: {self.biallelic}",
            "------ Issues with translation ------",
            f"Number of records without an alignment: "
            f"{self.record_without_align}",
            f"Number of records not translated even though they had an "
            f"alignment: {self.untranslated}",
            f"Number of records that are triallelic variants: "
            f"{self.triallelic}",
            f"Number of records where matching reference sequence is not "
            f"DNA: {self.not_dna}",
            f"Number of records that are not SNV: {self.not_snv}",
            f"Number of records where reference sequence does not exist "
            f"(-1): {self.ref_seq_less0}",
            f"Number of records where no calls found: "
            f"{self.true_calls_null}",
            f"Number of records where the consensus reference was not in "
            f"the alleles: {self.ref_not_in_alleles}",
        ]
        return "\n".join(lines)


def reference_position(aln, read_pos: int) -> int:
    """1-based reference position aligned to 0-based `read_pos` given in
    the ORIGINAL consensus orientation; -1 when the position falls in a
    gap or outside the alignment (ref: ReadAlignment.getReferencePosition
    :920-927)."""
    n = len(aln.read_chars) if aln.read_chars else aln.reference_span
    if aln.is_negative_strand:
        read_pos = n - 1 - read_pos
    if read_pos < 0:
        return -1
    pos = aln.first
    ridx = 0
    for l, op in aln.cigar:
        c_read = op in "MIS=X"
        c_ref = op in "MDN=X"
        if c_read and c_ref:
            if read_pos < ridx:
                return -1
            if ridx + l > read_pos:
                return pos + (read_pos - ridx)
        if c_read:
            ridx += l
        if c_ref:
            pos += l
    return -1


def translate_records(
    records: list[VCFRecord],
    consensus_alignments: dict,
    genome=None,
) -> tuple[list[VCFRecord], TranslationStats]:
    """Returns (translated records sorted in genome order, stats).

    Each record's sequence_name is a cluster id; consensus_alignments
    maps cluster id -> alignment of its consensus to the reference.
    `genome` (ReferenceGenome) enables the refbase reconciliation; when
    None, the base carried by the consensus allele 0 stands in (legacy
    behavior, reference parity requires the genome)."""
    stats = TranslationStats()
    out: list[VCFRecord] = []
    name_to_idx = {}
    if genome is not None:
        name_to_idx = {
            genome.sequence_name(i): i for i in range(genome.num_sequences)
        }
    for r in records:
        stats.total += 1
        aln = consensus_alignments.get(r.variant.sequence_name)
        if aln is None or aln.is_unmapped:
            stats.record_without_align += 1
            continue
        if not r.variant.is_snv:
            stats.not_snv += 1
            stats.untranslated += 1
            continue
        tr = _translate_record(r, aln, genome, stats)
        if tr is None:
            stats.untranslated += 1
            continue
        stats.translated += 1
        out.append(tr)
    if name_to_idx:
        out.sort(
            key=lambda r: (
                name_to_idx.get(r.variant.sequence_name, 1 << 30),
                r.variant.first,
            )
        )
    else:
        out.sort(key=lambda r: (r.variant.sequence_name, r.variant.first))
    return out, stats


def _translate_record(r, aln, genome, stats) -> VCFRecord | None:
    v = r.variant
    true_pos = reference_position(aln, v.first - 1)
    if true_pos <= 0:
        stats.ref_seq_less0 += 1
        return None
    seq_name = aln.sequence_name
    if genome is not None:
        try:
            seq_idx = next(
                i
                for i in range(genome.num_sequences)
                if genome.sequence_name(i) == seq_name
            )
        except StopIteration:
            stats.ref_seq_less0 += 1
            return None
        true_ref = genome.reference_string(seq_idx, true_pos, true_pos)
    else:
        # legacy: trust the consensus allele 0 (strand-flipped)
        a0 = v.alleles[0]
        true_ref = (
            reverse_complement(a0) if aln.is_negative_strand else a0
        )[0]
    true_ref = true_ref.upper()
    if true_ref not in _DNA:
        stats.not_dna += 1
        return None

    # rebuild the allele set around the TRUE reference base (ref/alt swap
    # when the consensus carried the alternative at this site)
    rel_alleles = list(v.alleles)
    ref_based = [true_ref]
    trans_pos: dict[str, int] = {}
    ref_in_alleles = False
    for a in rel_alleles:
        if set(a.upper()) - _DNA:
            continue
        al = a.upper()
        if aln.is_negative_strand:
            al = reverse_complement(al)
        if al[0] == true_ref:
            ref_in_alleles = True
            trans_pos[al] = 0
        elif al not in ref_based:
            trans_pos[al] = len(ref_based)
            ref_based.append(al)
    if len(ref_based) == 2:
        vtype = TYPE_BIALLELIC_SNV
        stats.biallelic += 1
    elif len(ref_based) >= 3:
        stats.triallelic += 1
        # the reference emits calls only for biallelic SNVs; triallelic
        # results therefore never produce a record (:411 instanceof SNV)
        stats.true_calls_null += 1
        return None
    else:
        stats.non_variant += 1
        return None
    if not ref_in_alleles:
        stats.ref_not_in_alleles += 1

    true_calls = []
    for call in r.calls:
        called = [
            (
                reverse_complement(a.upper())
                if aln.is_negative_strand
                else a.upper()
            )
            for a in call.called_alleles()
        ]
        acgt = list(call.acgt_depths) if call.acgt_depths else None
        if aln.is_negative_strand and acgt:
            acgt = [acgt[3], acgt[2], acgt[1], acgt[0]]
        total_cn = call.copy_number
        rel_acn = call.allele_copy_numbers or []
        acn = [0] * len(ref_based)
        for i, a in enumerate(called):
            p = trans_pos.get(a)
            rel_idx = None
            for j, ra in enumerate(rel_alleles):
                rau = (
                    reverse_complement(ra.upper())
                    if aln.is_negative_strand
                    else ra.upper()
                )
                if rau == a:
                    rel_idx = j
                    break
            if p is not None and rel_idx is not None and p < len(acn):
                acn[p] = (
                    rel_acn[rel_idx] if rel_idx < len(rel_acn) else 0
                )
        if len(called) == 2:
            idxs = [0, 1]
        elif len(called) == 1:
            if called[0][0] != true_ref:
                idxs = [1]
                acn[0], acn[1] = 0, total_cn
            else:
                idxs = [0]
                acn[0] = total_cn
                if len(acn) > 1:
                    acn[1] = 0
        else:
            idxs = []
        true_calls.append(
            CalledGenomicVariant(
                sequence_name=seq_name,
                first=true_pos,
                alleles=list(ref_based),
                variant_type=vtype,
                quality=v.quality,
                sample_id=call.sample_id,
                indexes_called_alleles=idxs,
                genotype_quality=call.genotype_quality,
                total_read_depth=call.total_read_depth,
                acgt_depths=acgt or [],
                allele_copy_numbers=acn,
                copy_number=total_cn,
            )
        )
    if not true_calls:
        stats.true_calls_null += 1
        return None
    variant = CalledGenomicVariant(
        sequence_name=seq_name,
        first=true_pos,
        alleles=list(ref_based),
        variant_type=vtype,
        quality=v.quality,
    )
    info = {
        "DENOVOCLUSTER": v.sequence_name,
        "DENOVOCLUSTERPOS": v.first,
        "DENOVOCLUSTERCONSENSUS": v.alleles[0],
    }
    return VCFRecord(variant=variant, calls=true_calls, info=info)
