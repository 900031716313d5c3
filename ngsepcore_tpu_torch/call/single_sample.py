"""Single-sample variant detector: the members the fused align+call
pipeline reads (call/fused_pipeline.py).

Ref: src/ngsep/discovery/SingleSampleVariantsDetector.java:62-931,
SingleSampleVariantPileupListener.java:147-331 (discovery mode, minQuality
40 default at :50, keep only non-homoref decided calls),
VariantDiscoverySNVQAlgorithm.java:100-265 (discoverSNV incl. triallelic).

The classic BAM-driven flow (`run`, `find_variants`), CNV/SV/repeat
analyses and known-STR loading are not part of this slice; see
ROADMAP.md Queue 1.
"""
from __future__ import annotations

import numpy as np

from ..kernels.genotyping import HET_RATE_DIPLOID, snv_contribution_table
from ..math.fisher import fisher_exact_2x2
from ..math.phred import phred_score
from ..variants.model import (
    CalledGenomicVariant,
    TYPE_BIALLELIC_SNV,
    TYPE_MULTIALLELIC_SNV,
)
from ..vcf.io import VCFRecord

DEF_MIN_QUALITY = 40  # ref: SingleSampleVariantPileupListener.java:50
DEF_MIN_MQ = 20  # ref: ReadAlignment.DEF_MIN_MQ_UNIQUE_ALIGNMENT
# largest genotyping window; short sequences use a smaller power of two
WINDOW = 1 << 20


def merge_indel_records(
    snv_records: list, indel_records: list
) -> list:
    """Drop SNV-site records inside any indel record's span, append the
    indel records, sort by position (lastIndelEnd suppression semantics,
    SingleSampleVariantPileupListener.java:147-160).  Vectorized: the
    record x span membership test is a searchsorted over span starts with
    a cummax over ends (the naive any() scan was quadratic-ish at bench
    scale)."""
    out = snv_records
    if indel_records:
        f = np.array([r.variant.first for r in indel_records], np.int64)
        l = np.array([r.variant.last for r in indel_records], np.int64)
        o = np.argsort(f, kind="stable")
        f = f[o]
        lmax = np.maximum.accumulate(l[o])
        if out:
            p = np.array([rec.variant.first for rec in out], np.int64)
            k = np.searchsorted(f, p, side="right") - 1
            inside = (k >= 0) & (lmax[np.clip(k, 0, None)] >= p)
            out = [rec for rec, drop in zip(out, inside) if not drop]
        out = out + indel_records
    out.sort(key=lambda r: r.variant.first)
    return out


def _window_for(seq_len: int) -> int:
    w = 1 << 16
    while w < seq_len and w < WINDOW:
        w <<= 1
    return w


class SingleSampleVariantsDetector:
    def __init__(
        self,
        genome,
        sample_id: str = "Sample",
        heterozygosity_rate: float = HET_RATE_DIPLOID,
        min_quality: int = DEF_MIN_QUALITY,
        min_mq: int = DEF_MIN_MQ,
        ploidy: int = 2,
        calc_strand_bias: bool = False,
        max_alns_per_start: int = 5,
    ):
        self.genome = genome
        self.sample_id = sample_id
        self.heterozygosity_rate = heterozygosity_rate
        self.min_quality = min_quality
        self.min_mq = min_mq
        self.ploidy = ploidy
        self.calc_strand_bias = calc_strand_bias
        self.max_alns_per_start = max_alns_per_start
        # known STRs (tier-2 alignment + STR realignment) are not part of
        # this slice; the fused pipeline refuses a non-empty dict
        self.known_strs: dict[str, list] = {}
        self._contribution = snv_contribution_table(4, 0.5)

    def find_variants(self, alignments):
        raise NotImplementedError(
            "classic alignments -> variants flow: ROADMAP.md Queue 1, "
            "\"Classic two-stage path\""
        )

    # ------------------------------------------------------------------
    def _call_indels(
        self,
        seq_idx: int,
        seq_name: str,
        alns: list[ReadAlignment],
        sites,
        gorder=None,
        array_reads=None,
        table=None,
    ) -> list[VCFRecord]:
        """Genotype the realigner's conciliated indel sites as spanning
        calls (SingleSampleVariantPileupListener indel path).

        `array_reads` optionally contributes spanning calls from gapless
        device-path reads (fused_pipeline._ArrayReads); `gorder` gives the
        host alignments' global arrival ranks so the merged call order
        matches the classic single-list flow exactly.

        Dispatches to call/indel_batch.py — all sites of the sequence in
        one flat numpy pass (the per-site loop below, kept as the
        `_call_indels_scalar` reference/bail-out path, was ~8s of a 35s
        bench run; tests/test_indel_batch.py asserts record equality)."""
        from .indel_batch import call_indels_batched

        if not sites:
            return []
        sites_t = [(s.first, s.span, s.is_str) for s in sites]
        return call_indels_batched(
            self, seq_idx, seq_name, alns, sites_t,
            gorder=gorder, array_reads=array_reads, table=table,
        )

    # ------------------------------------------------------------------
    def _call_indels_scalar(
        self,
        seq_idx: int,
        seq_name: str,
        alns: list[ReadAlignment],
        sites,
        gorder=None,
        array_reads=None,
        table=None,  # unused: object-walk path needs no columnar table
    ) -> list[VCFRecord]:
        """Reference per-site loop (see _call_indels); `sites` here is the
        (first, span, is_str) tuple list."""
        from .indels import call_indel, cluster_allele_calls, spanning_call_for

        if not sites:
            return []
        if sites and not isinstance(sites[0], tuple):
            sites = [(s.first, s.span, s.is_str) for s in sites]
        seq_len = self.genome.sequence_length(seq_idx)
        # interval lookup over alignments
        firsts = np.array([a.first for a in alns])
        lasts = np.array([a.last for a in alns])
        if gorder is None:
            gorder = np.arange(len(alns), dtype=np.int64)
        order = np.argsort(firsts, kind="stable")
        firsts_s = firsts[order]
        max_span = int((lasts - firsts).max() + 1) if len(alns) else 0
        records: list[VCFRecord] = []
        last_indel_end = 0
        for first, span, is_str in sites:
            if first < 1 or first + span - 1 > seq_len or first <= last_indel_end:
                continue
            last = first + span - 1
            reference = self.genome.reference_string(seq_idx, first, last)
            # candidate spanning reads: only starts within one max read
            # span of the site can span it — O(coverage) per site instead
            # of O(all alignments left of it)
            lo = np.searchsorted(firsts_s, first - max_span, side="left")
            hi = np.searchsorted(firsts_s, first, side="right")
            cand = []
            for oi in order[lo:hi]:
                if alns[oi].last < last:
                    continue
                c = spanning_call_for(alns[oi], first, last)
                if c is not None:
                    cand.append((int(firsts[oi]), int(gorder[oi]), c))
            if array_reads is not None:
                cand.extend(array_reads.spanning_calls(first, last))
            if len(cand) == 0:
                continue
            # plain tuple sort: (first, gorder) is unique per entry, so the
            # SpanningCall third element is never compared (the key lambda
            # was ~1s/run at 110k entries)
            cand.sort(key=None)
            calls = [t[2] for t in cand]
            alleles = cluster_allele_calls(calls, reference)
            called = call_indel(
                seq_name, first, calls, alleles, self.heterozygosity_rate,
                is_str=is_str,
            )
            if (
                called is None
                or called.is_undecided
                or called.is_homozygous_reference
                or called.genotype_quality < self.min_quality
            ):
                continue
            called.sample_id = self.sample_id
            called.copy_number = self.ploidy
            last_indel_end = called.last
            records.append(VCFRecord(variant=called, calls=[called]))
        return records

    # ------------------------------------------------------------------
    def _build_record(
        self,
        seq_name: str,
        position: int,
        ref_idx: int,
        bi: int,
        bj: int,
        gq: int,
        ref_prob: float,
        base_counts: np.ndarray,
        total: int,
        logcond: np.ndarray,
        strand_counts: np.ndarray,
    ) -> VCFRecord | None:
        bases = "ACGT"
        variant_qs = phred_score(ref_prob)
        # triallelic / both alleles non-ref (ref: discoverSNV:128-177)
        if bi != bj and bi != ref_idx and bj != ref_idx:
            # order alt alleles by homozygous posterior margin (+0.01)
            alleles = [bases[ref_idx], bases[bi], bases[bj]]
            idxs = [ref_idx, bi, bj]
            called = [1, 2]
            vtype = TYPE_MULTIALLELIC_SNV
        elif bi == bj and bi != ref_idx:
            alleles = [bases[ref_idx], bases[bi]]
            idxs = [ref_idx, bi]
            called = [1, 1]
            vtype = TYPE_BIALLELIC_SNV
        else:  # hetero with ref
            alt = bi if bi != ref_idx else bj
            alleles = [bases[ref_idx], bases[alt]]
            idxs = [ref_idx, alt]
            called = [0, 1]
            vtype = TYPE_BIALLELIC_SNV
        call = CalledGenomicVariant(
            sequence_name=seq_name,
            first=position,
            alleles=alleles,
            variant_type=vtype,
            quality=variant_qs,
            sample_id=self.sample_id,
            indexes_called_alleles=called,
            genotype_quality=gq,
            total_read_depth=total,
            acgt_depths=[int(x) for x in base_counts],
            allele_depths=[int(base_counts[i]) for i in idxs],
            copy_number=self.ploidy,
            genotype_likelihoods=self._pl(logcond, idxs),
        )
        info = {}
        if self.calc_strand_bias and called != [0, 0]:
            a, b = idxs[0], idxs[1]
            p = fisher_exact_2x2(
                int(strand_counts[a][0]),
                int(strand_counts[a][1]),
                int(strand_counts[b][0]),
                int(strand_counts[b][1]),
            )
            info["FS"] = phred_score(p)
        rec = VCFRecord(variant=call, calls=[call], info=info)
        return rec

    @staticmethod
    def _pl(logcond: np.ndarray, idxs: list[int]) -> list[int]:
        """Phred-scaled genotype likelihoods for genotypes over `idxs`
        in VCF order (0/0, 0/1, 1/1, [0/2, 1/2, 2/2]...)."""
        gls = []
        k = len(idxs)
        for j in range(k):
            for i in range(j + 1):
                a, b = idxs[i], idxs[j]
                if a == b:
                    gls.append(logcond[a][a])
                else:
                    gls.append(logcond[a][b])
        gls = np.array(gls)
        pl = np.round(-10.0 * (gls - gls.max())).astype(np.int64)
        return [int(min(x, 255)) for x in pl]
