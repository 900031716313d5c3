"""Single-sample variant detector — SNV and indel discovery/genotyping.

Ref: src/ngsep/discovery/SingleSampleVariantsDetector.java:62-931 (command
`SingleSampleVariantsDetector`, orchestration at :589-656),
SingleSampleVariantPileupListener.java:147-331 (discovery mode, minQuality
40 default at :50, keep only non-homoref decided calls),
VariantDiscoverySNVQAlgorithm.java:100-265 (discoverSNV incl. triallelic).

The reference's per-position listener chain becomes, per genome window,
one scatter-add of packed base calls into a (window, allele, qbin) count
tensor on the detector's device plus one screened genotyping pass over all
positions (kernels/genotyping.py); only interesting sites come back to
the host to become VCF records.  Indel sites come from the realigner and
are genotyped on the host (call/indel_batch.py).

A known-STR catalogue (-knownSTRs) feeds the realigner's STR conciliation
and, through the fused pipeline, the aligner's tier-2 split alignment.
Read-depth CNVs (-cnvs, call/read_depth.py; the HMM callers decode on the
detector's device) and read-pair SVs (-svs, call/read_pair_sv.py) join the
VCF with END/SVTYPE/SVLEN and land in a GFF next to it.  Long-read SVs
(-runLongReadSVs, call/long_read_sv.py) go to a VCF of their own,
`<output>_SVsLongReads.vcf`, and to the GFF.
"""
from __future__ import annotations

import numpy as np
import torch

from ..align.read_alignment import ReadAlignment
from ..io.sam import ReadAlignmentFileReader
from ..kernels.genotyping import (
    HET_RATE_DIPLOID,
    MAX_BASE_QS,
    snv_contribution_table,
)
from ..math.fisher import fisher_exact_2x2
from ..math.phred import phred_score
from ..utils.profiling import stage
from ..variants.model import (
    CalledGenomicVariant,
    TYPE_BIALLELIC_SNV,
    TYPE_MULTIALLELIC_SNV,
)
from ..vcf.io import VCFFileWriter, VCFRecord
from .pileup import cap_alignments_per_start

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
        find_cnvs: bool = False,
        find_svs: bool = False,
        run_long_read_svs: bool = False,
        min_sv_quality: int = 0,
        known_strs_file: str | None = None,
        alg_cnv: str = "CNVnator",  # ref: DEF_ALGORITHM_CNV (:75), comma list
        find_repeats: bool = False,
        known_repeats_file: str | None = None,
        query_seq: str | None = None,  # ref: -querySeq/-first/-last region
        query_first: int = 0,  # restriction (AlignmentsPileupGenerator
        query_last: int = 0,  # .java:310-321 via indexed BAM reads)
        *,
        device=None,  # where find_variants/run genotype; the fused
        # pipeline genotypes on its own device and needs none here
    ):
        self.find_cnvs = find_cnvs
        self.find_svs = find_svs
        self.run_long_read_svs = run_long_read_svs
        self.device = None if device is None else torch.device(device)
        self.query_seq = query_seq
        self.query_first = int(query_first or 0)
        self.query_last = int(query_last or 0)
        self.alg_cnv = alg_cnv
        self.find_repeats = find_repeats
        self.known_repeats_file = known_repeats_file
        self.genome = genome
        self.sample_id = sample_id
        self.heterozygosity_rate = heterozygosity_rate
        self.min_quality = min_quality
        self.min_mq = min_mq
        self.ploidy = ploidy
        self.calc_strand_bias = calc_strand_bias
        self.max_alns_per_start = max_alns_per_start
        self.min_sv_quality = min_sv_quality
        # cooperative cancel hook (ref: SingleSampleVariantsDetector polls
        # progressNotifier.keepRunning at :600,614,624,641)
        self.progress_notifier = None
        self.known_strs: dict[str, list] = {}
        if known_strs_file:
            from ..genome.builders import load_regions_file

            for r in load_regions_file(known_strs_file):
                self.known_strs.setdefault(r.sequence_name, []).append(r)
            for lst in self.known_strs.values():
                lst.sort(key=lambda r: r.first)
        self._contribution = snv_contribution_table(4, 0.5)

    # ------------------------------------------------------------------
    def run(self, alignments_file: str, output_vcf: str) -> int:
        """Orchestration mirrors SingleSampleVariantsDetector.run
        (:589-656): SNV/indel pileup genotyping, repeat masking
        (optional), read-pair SVs and read-depth CNVs (optional); SVs
        additionally land in a GFF next to the VCF."""
        region = None
        if self.query_seq:
            first = self.query_first or 1
            last = self.query_last or self.genome.sequence_length(
                self.query_seq
            )
            region = (self.query_seq, first, last)
        reader = ReadAlignmentFileReader(
            alignments_file, min_mq=self.min_mq, skip_secondary=True,
            region=region,
        )
        with stage("call.read_alignments"):
            alns = list(reader)
        records = self.find_variants(alns)
        if region is not None:
            # evidence from reads overlapping the region can support
            # variants hanging past its edges; the deliverable is the
            # records INSIDE the region (identical to the full run's
            # records there)
            records = [
                r
                for r in records
                if r.variant.sequence_name == region[0]
                and region[1] <= r.variant.first <= region[2]
            ]
        svs = []
        # ref findRepeats :607-612: repeat regions from multi-mapping reads
        # (or a known-repeats file) mask variant calls
        repeat_regions = []
        if self.known_repeats_file:
            from ..genome.builders import load_regions_file

            repeat_regions = [
                (r.sequence_name, r.first, r.last)
                for r in load_regions_file(self.known_repeats_file)
            ]
        elif self.find_repeats:
            from .repeats import MultipleMappingRegionsCalculator

            reps = MultipleMappingRegionsCalculator(
                min_mq=self.min_mq
            ).calculate_multiple_mapping_regions(alns)
            for c in reps:
                c.sample_id = self.sample_id
            svs.extend(reps)
            repeat_regions = [(c.sequence_name, c.first, c.last) for c in reps]
        if repeat_regions:
            by_seq: dict[str, list[tuple[int, int]]] = {}
            for s, f, l in repeat_regions:
                by_seq.setdefault(s, []).append((f, l))
            records = [
                r
                for r in records
                if not any(
                    f <= r.variant.first <= l
                    for f, l in by_seq.get(r.variant.sequence_name, [])
                )
            ]
        if self.find_svs:
            from .read_pair_sv import ReadPairAnalyzer

            with stage("call.read_pair_svs"):
                pair_svs = ReadPairAnalyzer(genome=self.genome).find_variants(alns)
            for c in pair_svs:
                c.sample_id = self.sample_id
                svs.append(c)
                records.append(
                    VCFRecord(
                        variant=c,
                        calls=[c],
                        info={
                            "END": c.last,
                            "SVTYPE": c.variant_type,
                            "SVLEN": c.length(),
                        },
                    )
                )
        if self.run_long_read_svs:
            # ref: runLongReadSVAnalysis (SingleSampleVariantsDetector
            # .java:1061-1069): a VCF of its own next to the main one
            from .long_read_sv import LongReadStructuralVariantDetector

            with stage("call.long_read_svs"):
                lr_svs = [
                    v
                    for v in LongReadStructuralVariantDetector(
                        self.genome, min_mq=self.min_mq
                    ).find_variants(alns)
                    if v.genotype_quality >= self.min_sv_quality
                ]
            with VCFFileWriter(
                output_vcf.rsplit(".", 1)[0] + "_SVsLongReads.vcf", [self.sample_id]
            ) as w:
                for v in lr_svs:
                    v.sample_id = self.sample_id
                    w.write(VCFRecord(variant=v, calls=[v], info={
                        "END": v.last,
                        "SVTYPE": v.variant_type,
                        "SVLEN": v.length(),
                    }))
            svs.extend(lr_svs)
        if self.find_cnvs:
            with stage("call.read_depth_cnvs"):
                cnvs = self.find_cnv_calls(alns)
            svs.extend(cnvs)
            for c in cnvs:
                c.sample_id = self.sample_id
                records.append(VCFRecord(variant=c, calls=[c], info={
                    "END": c.last,
                    "SVTYPE": "DUP" if c.copy_number > self.ploidy else "DEL",
                    "SVLEN": c.length(),
                }))
        if svs:
            records.sort(key=lambda r: (r.variant.sequence_name, r.variant.first))
        with stage("call.write_vcf"), VCFFileWriter(
            output_vcf, [self.sample_id]
        ) as w:
            for r in records:
                w.write(r)
        if svs:
            from ..io.gff_sv import write_sv_gff

            write_sv_gff(svs, output_vcf.rsplit(".", 1)[0] + "_SV.gff")
        return len(records)

    # ------------------------------------------------------------------
    def find_cnv_calls(self, alns: list[ReadAlignment]):
        """Read-depth CNV analysis (ref: runRDAnalysis :615-623; algorithm
        list parsed from algCNV like :739).  The HMM algorithms decode on
        the detector's device."""
        from .read_depth import (
            CNV_ALGORITHMS,
            PoissonHMMReadDepthAlgorithm,
            ReadDepthDistribution,
        )

        by_lower = {k.lower(): v for k, v in CNV_ALGORITHMS.items()}
        algorithms = []
        for alg in self.alg_cnv.split(","):
            cls = by_lower.get(alg.strip().lower())
            if cls is None:
                raise ValueError(
                    f"Unknown CNV algorithm {alg!r}; options: "
                    + ", ".join(CNV_ALGORITHMS)
                )
            if issubclass(cls, PoissonHMMReadDepthAlgorithm):
                if self.device is None:
                    raise ValueError(
                        f"CNV algorithm {alg.strip()} needs the detector's device="
                    )
                algorithms.append(cls(normal_ploidy=self.ploidy, device=self.device))
            else:
                algorithms.append(cls(normal_ploidy=self.ploidy))
        dist = ReadDepthDistribution(self.genome)
        dist.process_alignments(alns)
        dist.correct_depth_by_gc_content()
        dist.fit()
        calls = []
        for algorithm in algorithms:
            with stage("cnv." + type(algorithm).__name__):
                calls.extend(algorithm.call_cnvs(dist))
        return calls

    # ------------------------------------------------------------------
    def find_variants(self, alignments: list[ReadAlignment]) -> list[VCFRecord]:
        by_seq: dict[str, list[ReadAlignment]] = {}
        for a in alignments:
            if a.is_unmapped or a.alignment_quality < self.min_mq:
                continue
            by_seq.setdefault(a.sequence_name, []).append(a)
        from ..utils.progress import check as _progress_check

        records: list[VCFRecord] = []
        for si in range(self.genome.num_sequences):
            _progress_check(self.progress_notifier, si)
            name = self.genome.sequence_name(si)
            alns = by_seq.get(name)
            if not alns:
                continue
            with stage("call.sort_cap"):
                alns.sort(key=lambda a: a.first)
                alns = cap_alignments_per_start(alns, self.max_alns_per_start)
            records.extend(self._process_sequence(si, name, alns))
        return records

    # ------------------------------------------------------------------
    def _process_sequence(
        self, seq_idx: int, seq_name: str, alns: list[ReadAlignment]
    ) -> list[VCFRecord]:
        from ..kernels.genotyping import (
            accumulate_allele_counts_packed,
            genotype_window_hist_resolve_batch,
            genotype_window_sparse,
            init_count_tensors_flat,
        )
        from .aln_table import AlnTable
        from .realigner import IndelRealigner

        if self.device is None:
            raise ValueError(
                "SingleSampleVariantsDetector needs device= to genotype "
                "(find_variants, run)"
            )
        # listener #1: conciliate indel placements across reads and derive
        # the spanning-call sites (IndelRealignerPileupListener analog)
        with stage("call.realign"):
            sites = IndelRealigner(
                self.genome, seq_idx, self.known_strs.get(seq_name)
            ).realign(alns)
        with stage("call.aln_table"):
            table = AlnTable(alns)
            pos, allele, qual, strand = table.expand_calls()
        if len(pos) == 0:
            return []
        with stage("call.indel_genotype"):
            indel_records = self._call_indels(
                seq_idx, seq_name, alns, sites, table=table
            )
        with stage("call.sort_calls"):
            order = np.argsort(pos, kind="stable")
            pos, allele, qual, strand = (
                pos[order], allele[order], qual[order], strand[order],
            )
        dev = self.device
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        seq_len = self.genome.sequence_length(seq_idx)
        ref_codes = self.genome.sequences[seq_idx].codes
        contribution = up(np.asarray(self._contribution))
        het = float(self.heterozygosity_rate)
        minq = int(self.min_quality)
        window = _window_for(seq_len)
        # one int32 per call (rel pos | qual << 20 | allele << 25 |
        # strand << 28), one upload per window
        qual_p = np.clip(qual, 0, MAX_BASE_QS).astype(np.int32)
        al_p = allele.astype(np.int32)
        st_p = strand.astype(np.int32)
        pending = []
        meta = []
        for w0 in range(1, seq_len + 1, window):
            w1 = min(seq_len, w0 + window - 1)
            lo = np.searchsorted(pos, w0, side="left")
            hi = np.searchsorted(pos, w1, side="right")
            if hi <= lo:
                continue
            with stage("call.window_dispatch"):
                pk_win = (
                    (pos[lo:hi] - w0).astype(np.int32)
                    | (qual_p[lo:hi] << 20)
                    | (al_p[lo:hi] << 25)
                    | (st_p[lo:hi] << 28)
                )
                pk_win = np.where(al_p[lo:hi] >= 0, pk_win, -1)
                counts, strand_counts, _low_qual, total = (
                    accumulate_allele_counts_packed(
                        *init_count_tensors_flat(window, device=dev),
                        up(pk_win),
                    )
                )
                ref_win = np.full(window, 4, dtype=np.int8)
                ref_win[: w1 - w0 + 1] = ref_codes[w0 - 1 : w1]
                pending.append(
                    genotype_window_sparse(
                        counts, strand_counts, total, up(ref_win),
                        contribution, het, minq,
                    )
                )
            meta.append((w0, ref_win))
        with stage("call.window_resolve"):
            resolved = genotype_window_hist_resolve_batch(pending)
        out: list[VCFRecord] = []
        with stage("call.build_records"):
            for (w0, ref_win), res in zip(meta, resolved):
                out.extend(self._window_records(seq_name, w0, ref_win, res))
        # merge indel calls and suppress embedded SNVs (lastIndelEnd
        # semantics, SingleSampleVariantPileupListener.java:147-160)
        return merge_indel_records(out, indel_records)

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
    def _window_records(self, seq_name: str, w0: int, ref_win, res) -> list:
        """VCF records of one genotyped window: `res` is a window
        genotyper's result on the host (kernels/genotyping
        .genotype_window_hist_resolve_batch), the window starts at 1-based w0."""
        return [
            self._build_record(
                seq_name,
                w0 + int(p),
                int(ref_win[p]),
                int(res["bi"][i]),
                int(res["bj"][i]),
                int(res["gq"][i]),
                float(res["ref_prob"][i]),
                res["depths"][i],
                int(res["total"][i]),
                res["logcond"][i],
                res["strand_counts"][i],
            )
            for i, p in enumerate(res["site_idx"][: int(res["n_sites"])])
        ]

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
    ) -> VCFRecord:
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
