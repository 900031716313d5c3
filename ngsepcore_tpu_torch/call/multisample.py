"""Multisample joint variant detection.

Ref: src/ngsep/discovery/MultisampleVariantsDetector.java — samples
auto-discovered from alignment read groups (:492-516); per pileup a
population variant is discovered from pooled calls and each sample is then
genotyped from its read-group partition (:522-560, :664-691); the variant
QS is the max genotype quality among decided non-homoref sample calls
(:680-691); records stream per site.

Per sample and genome window, the position-sorted base calls expanded on
the detector's device (aln_table.device_calls) scatter into a (window,
allele, quality) count tensor and every position is genotyped in float64
(kernels/genotyping.genotype_window_from_counts); the population site set
is the union of the samples' flagged sites; per-sample genotype data at
union sites come from gathers of the full per-position arrays — no
per-position listener bus.  Indels are conciliated over the pooled reads
and genotyped per sample on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..align.read_alignment import ReadAlignment
from ..core.genome import ReferenceGenome
from ..io.sam import ReadAlignmentFileReader
from ..kernels.genotyping import (
    HET_RATE_DIPLOID,
    accumulate_sorted_calls,
    genotype_window_from_counts,
    init_count_tensors,
    snv_contribution_table,
)
from ..utils.profiling import stage
from ..variants.model import (
    CalledGenomicVariant,
    TYPE_BIALLELIC_SNV,
    TYPE_INDEL,
    TYPE_MULTIALLELIC_SNV,
    TYPE_STR,
)
from ..vcf.io import VCFFileWriter, VCFRecord
from .aln_table import AlnTable
from .indels import cluster_allele_calls, genotype_indel_site, spanning_call_for
from .pileup import cap_alignments_per_start
from .realigner import IndelRealigner
from .single_sample import (
    DEF_MIN_MQ,
    DEF_MIN_QUALITY,
    _window_for,
    merge_indel_records,
)


class MultisampleVariantsDetector:
    def __init__(
        self,
        genome: ReferenceGenome,
        heterozygosity_rate: float = HET_RATE_DIPLOID,
        min_quality: int = DEF_MIN_QUALITY,
        min_mq: int = DEF_MIN_MQ,
        ploidy: int = 2,
        max_alns_per_start: int = 5,
        *,
        device,  # where the samples' calls are expanded, counted and genotyped
    ):
        self.device = torch.device(device)
        self.genome = genome
        self.heterozygosity_rate = heterozygosity_rate
        self.min_quality = min_quality
        self.min_mq = min_mq
        self.ploidy = ploidy
        self.max_alns_per_start = max_alns_per_start
        self._contribution = snv_contribution_table(4, 0.5)

    # ------------------------------------------------------------------
    def run(self, alignment_files: list[str], output_vcf: str) -> int:
        """Samples come from read groups; files without RG use filename."""
        per_sample: dict[str, list[ReadAlignment]] = {}
        for path in alignment_files:
            reader = ReadAlignmentFileReader(path, min_mq=self.min_mq)
            default_sample = path.rsplit("/", 1)[-1].split(".")[0]
            for a in reader:
                sample = (
                    reader.read_groups.get(a.read_group, a.read_group)
                    if a.read_group
                    else default_sample
                )
                per_sample.setdefault(sample, []).append(a)
        samples = sorted(per_sample)
        records = self.find_variants([per_sample[s] for s in samples], samples)
        with VCFFileWriter(output_vcf, samples) as w:
            for r in records:
                w.write(r)
        return len(records)

    # ------------------------------------------------------------------
    def find_variants(
        self, alignments_per_sample: list[list[ReadAlignment]], samples: list[str]
    ) -> list[VCFRecord]:
        records: list[VCFRecord] = []
        for si in range(self.genome.num_sequences):
            name = self.genome.sequence_name(si)
            per_sample = []
            for alns in alignments_per_sample:
                sel = [
                    a
                    for a in alns
                    if a.sequence_name == name
                    and not a.is_unmapped
                    and a.alignment_quality >= self.min_mq
                ]
                sel.sort(key=lambda a: a.first)
                per_sample.append(cap_alignments_per_start(sel, self.max_alns_per_start))
            if not any(per_sample):
                continue
            records.extend(self._process_sequence(si, name, per_sample, samples))
        return records

    # ------------------------------------------------------------------
    def _process_sequence(self, seq_idx, seq_name, per_sample, samples):
        dev = self.device
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        # conciliate indels across ALL samples jointly (the reference wires
        # one IndelRealignerPileupListener on the shared pileup bus, :449)
        with stage("multi.realign"):
            pooled = [a for alns in per_sample for a in alns]
            sites = IndelRealigner(self.genome, seq_idx).realign(pooled)
        with stage("multi.indel_genotype"):
            indel_records = self._call_indels(
                seq_idx, seq_name, per_sample, samples, sites
            )
        seq_len = self.genome.sequence_length(seq_idx)
        ref_codes = self.genome.sequences[seq_idx].codes
        contribution = up(np.asarray(self._contribution))
        het = float(self.heterozygosity_rate)
        minq = int(self.min_quality)
        out: list[VCFRecord] = []
        window = _window_for(seq_len)
        w_starts = list(range(1, seq_len + 1, window))
        # per-sample expansion on the device: the run table + flat
        # codes/quals upload once per sample; expansion, packing and the
        # position sort happen there, and every sample's calls stay resident
        devcs = []
        bounds = []
        with stage("multi.device_calls"):
            edges = up(np.array(w_starts + [seq_len + 1], np.int32))
            for alns in per_sample:
                devc = AlnTable(alns).device_calls(dev) if alns else None
                devcs.append(devc)
                bounds.append(
                    None if devc is None
                    else torch.searchsorted(devc["pos"], edges).cpu().numpy()
                )
        for wi, w0 in enumerate(w_starts):
            w1 = min(seq_len, w0 + window - 1)
            ref_win = np.full(window, 4, dtype=np.int8)
            ref_win[: w1 - w0 + 1] = ref_codes[w0 - 1 : w1]
            ref_win_dev = up(ref_win)
            results = []
            with stage("multi.scatter_genotype"):
                for devc, bound in zip(devcs, bounds):
                    if devc is None or bound[wi + 1] <= bound[wi]:
                        results.append(None)
                        continue
                    lo, hi = int(bound[wi]), int(bound[wi + 1])
                    counts, strand_counts, low_qual, total = accumulate_sorted_calls(
                        *init_count_tensors(window, device=dev),
                        devc["pos"], devc["attr"], lo, w0, hi - lo,
                    )
                    results.append(
                        genotype_window_from_counts(
                            counts, strand_counts, total, ref_win_dev,
                            contribution, het, minq,
                        )
                    )
                    # the window's counts go before the next sample's come
                    del counts, strand_counts, low_qual, total
            # union of flagged sites across samples
            with stage("multi.fetch_sites"):
                flagged = [
                    res["site_idx"] for res in results
                    if res is not None and res["n_sites"]
                ]
                if not flagged:
                    continue
                sites_dev = torch.unique(torch.cat(flagged).to(torch.int64))
                sites = sites_dev.cpu().numpy()
                # per-sample genotype data at the union sites
                gathered = [
                    None if res is None else {
                        k: res[k + "_full"][sites_dev].cpu().numpy()
                        for k in ("bi", "bj", "gq", "total", "depths", "ref_prob")
                    }
                    for res in results
                ]
            with stage("multi.build_records"):
                for k, p in enumerate(sites):
                    rec = self._build_population_record(
                        seq_name, w0 + int(p), int(ref_win[p]), gathered, samples, k
                    )
                    if rec is not None:
                        out.append(rec)
        # suppress SNVs inside indel spans, then merge (listener semantics)
        return merge_indel_records(out, indel_records)

    # ------------------------------------------------------------------
    def _call_indels(self, seq_idx, seq_name, per_sample, samples, sites):
        """Population indel genotyping: the allele set is clustered from the
        POOLED spanning calls, then each sample is genotyped against it
        (MultisampleVariantsDetector.java:522-560 indel path)."""
        if not sites:
            return []
        seq_len = self.genome.sequence_length(seq_idx)
        # per-sample interval index: only alignments starting within one
        # max read span of a site can span it — O(coverage) candidates per
        # site instead of O(all alignments) (same windowing as
        # single_sample._call_indels_scalar; the naive scan was 50M+
        # spanning_call_for calls on a 3-sample 400 kb probe)
        idx = []
        for alns in per_sample:
            firsts = np.fromiter((a.first for a in alns), np.int64, len(alns))
            lasts = np.fromiter((a.last for a in alns), np.int64, len(alns))
            order = np.argsort(firsts, kind="stable")
            max_span = int((lasts - firsts).max() + 1) if len(alns) else 0
            idx.append((firsts[order], order, max_span))
        records: list[VCFRecord] = []
        for site in sites:
            first, span = site.first, site.span
            last = first + span - 1
            if first < 1 or last > seq_len:
                continue
            reference = self.genome.reference_string(seq_idx, first, last)
            calls_by_sample: list[list] = []
            pooled = []
            for alns, (firsts_s, order, max_span) in zip(per_sample, idx):
                cs = []
                lo = np.searchsorted(firsts_s, first - max_span, side="left")
                hi = np.searchsorted(firsts_s, first, side="right")
                for oi in order[lo:hi]:
                    a = alns[oi]
                    if a.last < last:
                        continue
                    c = spanning_call_for(a, first, last)
                    if c is not None:
                        cs.append(c)
                calls_by_sample.append(cs)
                pooled.extend(cs)
            if not pooled:
                continue
            alleles = cluster_allele_calls(pooled, reference)
            if len(alleles) < 2 and not site.is_str:
                continue
            ref_len = len(reference)
            length_change = any(len(a) != ref_len for a in alleles)
            if not length_change and not site.is_str:
                continue
            variant_qs = 0
            genos = []
            for cs in calls_by_sample:
                g = genotype_indel_site(cs, alleles, self.heterozygosity_rate)
                genos.append(g)
                if g is not None and (g[0], g[1]) != (0, 0):
                    variant_qs = max(variant_qs, g[2])
            if variant_qs < self.min_quality:
                continue
            vtype = TYPE_STR if site.is_str else TYPE_INDEL
            calls = []
            for s, g in enumerate(genos):
                call = CalledGenomicVariant(
                    sequence_name=seq_name,
                    first=first,
                    alleles=alleles,
                    variant_type=vtype,
                    quality=variant_qs,
                    sample_id=samples[s],
                    copy_number=self.ploidy,
                )
                if g is not None:
                    bi, bj, gq, _, helper = g
                    call.indexes_called_alleles = sorted({bi, bj})
                    call.genotype_quality = gq
                    call.total_read_depth = helper.total
                    call.allele_depths = [int(x) for x in helper.counts]
                calls.append(call)
            variant = CalledGenomicVariant(
                sequence_name=seq_name,
                first=first,
                alleles=alleles,
                variant_type=vtype,
                quality=variant_qs,
            )
            info = {"NS": sum(1 for c in calls if not c.is_undecided)}
            records.append(VCFRecord(variant=variant, calls=calls, info=info))
        return records

    # ------------------------------------------------------------------
    def _build_population_record(
        self, seq_name, position, ref_idx, gathered, samples, k
    ) -> VCFRecord | None:
        bases = "ACGT"
        if ref_idx >= 4:
            return None
        # allele set: reference first, then alt alleles in called order
        alleles = [bases[ref_idx]]
        allele_index: dict[int, int] = {ref_idx: 0}
        sample_calls: list[CalledGenomicVariant] = []
        variant_qs = 0
        for s, g in enumerate(gathered):
            if g is None or int(g["total"][k]) == 0:
                sample_calls.append((s, None, 0, 0, None))
                continue
            bi, bj = int(g["bi"][k]), int(g["bj"][k])
            gq = int(g["gq"][k])
            for a in (bi, bj):
                if a not in allele_index:
                    allele_index[a] = len(alleles)
                    alleles.append(bases[a])
            sample_calls.append((s, (bi, bj), gq, int(g["total"][k]), g["depths"][k]))
            if (bi, bj) != (ref_idx, ref_idx) and gq > variant_qs:
                variant_qs = gq
        if variant_qs == 0 or variant_qs < self.min_quality or len(alleles) < 2:
            return None
        vtype = TYPE_BIALLELIC_SNV if len(alleles) == 2 else TYPE_MULTIALLELIC_SNV
        calls = []
        for s, genotype, gq, total, depths in sample_calls:
            call = CalledGenomicVariant(
                sequence_name=seq_name,
                first=position,
                alleles=alleles,
                variant_type=vtype,
                quality=variant_qs,
                sample_id=samples[s],
                genotype_quality=gq,
                total_read_depth=total,
                copy_number=self.ploidy,
            )
            if genotype is not None:
                call.indexes_called_alleles = sorted(
                    {allele_index[genotype[0]], allele_index[genotype[1]]}
                )
                call.acgt_depths = [int(x) for x in depths]
                call.allele_depths = [
                    int(depths[bases.index(a)]) for a in alleles
                ]
            calls.append(call)
        variant = CalledGenomicVariant(
            sequence_name=seq_name,
            first=position,
            alleles=alleles,
            variant_type=vtype,
            quality=variant_qs,
        )
        info = {"NS": sum(1 for c in calls if not c.is_undecided)}
        return VCFRecord(variant=variant, calls=calls, info=info)
