"""VCF downstream analytics: filter, summary stats, diversity, density,
distance matrix, comparator, merge.

Ref: src/ngsep/vcf/VCFFilter.java (26 options: quality/depth/MAF/het/regions/
samples filters), VCFSummaryStatisticsCalculator.java,
VCFDiversityCalculator.java (per-site MAF, observed/expected heterozygosity,
Wright F), VCFVariantDensityCalculator.java, VCFDistanceMatrixCalculator.java,
VCFComparator.java (genotype concordance), IndividualSampleVariantsMerge /
ConsistentVCFFilesMerge (population merge).

Counterpart of ngsepcore_tpu/vcf/analytics.py: the population genotype
matrix (sites x samples, dosage-coded) drives all of these, on the host;
the distance matrix is computed on the caller's device as one-hot float32
matrix products — the per-pair scalar loops of the reference collapse into
(samples, sites) @ (sites, samples) products.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.regions import GenomicRegionSortedCollection
from ..variants.model import CalledGenomicVariant, GenomicVariant
from .io import VCFFileReader, VCFFileWriter, VCFRecord


def dosage_matrix(records: list[VCFRecord]) -> tuple[np.ndarray, list[str]]:
    """(sites, samples) int8 dosage matrix: 0/1/2 alt-allele dose, -1 missing.

    Multi-allelic records use the first alternative allele.
    """
    n_samples = len(records[0].calls) if records else 0
    out = np.full((len(records), n_samples), -1, np.int8)
    for i, r in enumerate(records):
        for s, c in enumerate(r.calls):
            if c.is_undecided:
                continue
            idxs = c.indexes_called_alleles
            if len(idxs) == 1:
                idxs = idxs * 2
            out[i, s] = sum(1 for a in idxs if a != 0)
    return out, [c.sample_id or str(i) for i, c in enumerate(records[0].calls)]


# --------------------------------------------------------------------------
@dataclass
class VCFFilter:
    """Site and genotype filters — the reference's full 26-option surface
    (ref: vcf/VCFFilter.java:65-92 fields, CommandsDescriptor.xml VCFFilter
    entry: i,o,frs,srs,d,q,minRD,s,fi,fir,fia,minI,m,minC,minMAF,maxMAF,
    minOH,maxOH,g,minGC,maxGC,maxCNVs,gene,a,saf,fs).

    Processing order mirrors the reference (processVariantsFile:516-551):
    distance filter over the record stream, then sample/genotype filtering
    (filterSamplesAndGenotypes:677-698 — genotype calls below GQ/DP become
    undecided; here a COPY is modified, input records are never mutated),
    then the site filters in passFilters order (:567-617), then diversity
    INFO fields are recomputed on the surviving records
    (VCFRecord.updateDiversityStatistics:288-301)."""

    # genotype filters (ref :71-72)
    min_genotype_quality: int = 0
    min_depth: int = 0  # ref minReadDepth (-minRD)
    # variant context filters (ref :73,90-92,83-84,86-87)
    min_distance: int = 0
    regions_to_filter: GenomicRegionSortedCollection | None = None
    regions_to_select: GenomicRegionSortedCollection | None = None
    genome: object | None = None  # ReferenceGenome for GC content (-g)
    min_gc_content: float = 0.0
    max_gc_content: float = 100.0
    gene_id: str | None = None  # matches TID or TGN INFO (-gene)
    annotations: set | None = None  # matches TA INFO values (-a)
    # population filters (ref :74-82,85)
    min_samples_genotyped: int = 0
    filter_invariant: bool = False
    filter_invariant_reference: bool = False
    filter_invariant_alternative: bool = False
    keep_biallelic_snvs: bool = False  # ref keepBiallelicSNVs (-s)
    min_maf: float = 0.0
    max_maf: float = 0.5
    min_oh: float = 0.0
    max_oh: float = 1.0
    max_samples_cnvs: int = -1  # -1 = no filter (-maxCNVs, INFO CNV)
    # sample selection (ref :88-89)
    sample_ids: list[str] | None = None
    filter_samples: bool = False  # -fs: remove instead of select
    # extensions kept from round 1 (not in the reference surface)
    min_quality: int = 0  # variant QS gate
    keep_only_snvs: bool = False
    keep_only_biallelic: bool = False
    regions: GenomicRegionSortedCollection | None = None  # legacy alias
    invert_regions: bool = False
    max_sites: int | None = None

    def __post_init__(self):
        # legacy alias: `regions` selects; with invert_regions it filters
        if self.regions is not None:
            if self.invert_regions:
                if self.regions_to_filter is None:
                    self.regions_to_filter = self.regions
            elif self.regions_to_select is None:
                self.regions_to_select = self.regions

    # ---- stage 1: sample selection + genotype filtering (copy-on-write) --
    def _filter_samples_and_genotypes(self, r: VCFRecord) -> VCFRecord:
        import dataclasses

        keep = None
        if self.sample_ids:
            sel = set(self.sample_ids)
            keep = lambda c: (c.sample_id in sel) != self.filter_samples
        calls = []
        changed = keep is not None
        for c in r.calls:
            if keep is not None and not keep(c):
                continue
            if not c.is_undecided and (
                c.genotype_quality < self.min_genotype_quality
                or c.total_read_depth < self.min_depth
            ):
                c = dataclasses.replace(c, indexes_called_alleles=[])
                changed = True
            calls.append(c)
        if not changed:
            return r
        return VCFRecord(
            variant=r.variant, calls=calls, info=dict(r.info),
            filters=r.filters, format_str=r.format_str,
        )

    # ---- stage 3: site filters (ref passFilters order) -------------------
    def _pass_filters(self, r: VCFRecord | None) -> bool:
        if r is None:
            return False
        v = r.variant
        if self.keep_biallelic_snvs and not (v.is_snv and v.is_biallelic):
            return False
        if self.keep_only_snvs and not v.is_snv:
            return False
        if self.keep_only_biallelic and not v.is_biallelic:
            return False
        if v.quality < self.min_quality:
            return False
        if self.max_samples_cnvs >= 0:
            try:
                n_cnvs = int(r.info.get("CNV", 0) or 0)
            except (TypeError, ValueError):
                n_cnvs = 0
            if n_cnvs > self.max_samples_cnvs:
                return False
        if self.gene_id is not None and not (
            r.info.get("TID") == self.gene_id or r.info.get("TGN") == self.gene_id
        ):
            return False
        if self.annotations is not None and r.info.get("TA") not in self.annotations:
            return False
        stats = site_diversity(r) if r.calls else SiteDiversity()
        if r.calls:
            counts = stats.allele_counts
            if self.filter_invariant and stats.n_alleles_called < 2:
                return False
            if (
                self.filter_invariant_reference
                and stats.n_alleles_called == 1
                and counts and counts[0] > 0
            ):
                return False
            if (
                self.filter_invariant_alternative
                and stats.n_alleles_called == 1
                and counts and counts[0] == 0
            ):
                return False
            if stats.genotyped < self.min_samples_genotyped:
                return False
            if not (self.min_maf <= stats.maf <= self.max_maf):
                return False
            if not (self.min_oh <= stats.observed_het <= self.max_oh):
                return False
        if self.regions_to_filter is not None and self.regions_to_filter.find_spanning(
            v.sequence_name, v.first, v.last
        ):
            return False
        if self.regions_to_select is not None and not self.regions_to_select.find_spanning(
            v.sequence_name, v.first, v.last
        ):
            return False
        if self.genome is not None and self._filter_gc_content(v):
            return False
        if r.calls:
            _update_diversity_info(r, stats)
        return True

    def _filter_gc_content(self, v) -> bool:
        """GC%% of the +-100bp region (ref filterGCContent:650-675); regions
        extending past the sequence bounds are filtered like the reference's
        null getReference result."""
        g = self.genome
        try:
            si = g.index_of(v.sequence_name)
        except (KeyError, ValueError):
            return True
        codes = g.sequences[si].codes
        lo = v.first - 100 - 1
        hi = v.last + 100
        if lo < 0 or hi > len(codes):
            return True
        seg = codes[lo:hi]
        acgt = int(np.count_nonzero(seg < 4))
        if acgt == 0:
            gc = 0.0
        else:
            gc = (
                int(np.count_nonzero((seg == 1) | (seg == 2))) * 100.0 / acgt
            )
        return gc < self.min_gc_content or gc > self.max_gc_content

    # ---- main loop: distance filter over the stream (ref :516-551) -------
    def apply(self, records: list[VCFRecord]) -> list[VCFRecord]:
        out: list[VCFRecord] = []
        last: VCFRecord | None = None
        last_seq: str | None = None
        last_pos = -self.min_distance
        for rec in records:
            vr = self._filter_samples_and_genotypes(rec)
            gv = vr.variant
            if gv.sequence_name != last_seq:
                if self._pass_filters(last):
                    out.append(last)
                last = vr
                last_seq = gv.sequence_name
                last_pos = gv.last
                continue
            if self.min_distance <= 0 or gv.first - last_pos > self.min_distance:
                if self._pass_filters(last):
                    out.append(last)
                last = vr
            else:
                last = None
            last_seq = gv.sequence_name
            last_pos = gv.last
        if self._pass_filters(last):
            out.append(last)
        if self.max_sites is not None:
            out = out[: self.max_sites]
        return out


def _update_diversity_info(r: VCFRecord, stats: "SiteDiversity") -> None:
    """Recompute the population INFO fields on a record that passed filters
    (ref: VCFRecord.updateDiversityStatistics:288-301 — NS, AN, AFS, OH and,
    for biallelic variants, MAF)."""
    r.info["NS"] = str(stats.genotyped)
    r.info["AN"] = str(stats.n_alleles_called)
    r.info["AFS"] = ",".join(str(c) for c in stats.allele_counts)
    r.info["OH"] = _jformat(stats.observed_het)
    if r.variant.is_biallelic:
        r.info["MAF"] = _jformat(stats.maf)


def _jformat(x: float) -> str:
    """Float formatting matching Java's Double.toString for the common
    cases (0.5 -> '0.5', 0.0 -> '0.0')."""
    s = repr(float(x))
    return s


# --------------------------------------------------------------------------
@dataclass
class SiteDiversity:
    genotyped: int = 0
    n_alleles_called: int = 0
    maf: float = 0.0
    observed_het: float = 0.0
    expected_het: float = 0.0
    f: float = 0.0
    allele_counts: list[int] = field(default_factory=list)


def site_diversity(record: VCFRecord) -> SiteDiversity:
    """Per-site diversity (ref: VCFDiversityCalculator / DiversityStatistics)."""
    n_alleles = len(record.variant.alleles)
    counts = [0] * n_alleles
    genotyped = 0
    het = 0
    for c in record.calls:
        if c.is_undecided:
            continue
        genotyped += 1
        idxs = c.indexes_called_alleles
        if len(idxs) == 1:
            idxs = idxs * 2
        for a in idxs:
            if 0 <= a < n_alleles:
                counts[a] += 1
        if len(set(idxs)) > 1:
            het += 1
    total = sum(counts)
    sd = SiteDiversity(genotyped=genotyped, allele_counts=counts)
    if genotyped == 0 or total == 0:
        return sd
    freqs = [c / total for c in counts]
    sorted_f = sorted(freqs, reverse=True)
    sd.maf = sorted_f[1] if len(sorted_f) > 1 else 0.0
    sd.observed_het = het / genotyped
    sd.expected_het = 1.0 - sum(f * f for f in freqs)
    if sd.expected_het > 0:
        sd.f = 1.0 - sd.observed_het / sd.expected_het
    sd.n_alleles_called = sum(1 for c in counts if c > 0)
    return sd


class VCFSummaryStatisticsCalculator:
    """Variant counts report by category (ref: VCFSummaryStatisticsCalculator)."""

    def __init__(self):
        self.counts: dict[str, int] = {}
        self.genotype_calls = 0
        self.homozygous_alt = 0
        self.heterozygous = 0
        self.undecided = 0
        self.transitions = 0
        self.transversions = 0

    def process(self, record: VCFRecord) -> None:
        v = record.variant
        key = v.variant_type
        self.counts[key] = self.counts.get(key, 0) + 1
        if v.is_snv and v.is_biallelic:
            pair = {v.alleles[0], v.alleles[1]}
            if pair in ({"A", "G"}, {"C", "T"}):
                self.transitions += 1
            else:
                self.transversions += 1
        for c in record.calls:
            if c.is_undecided:
                self.undecided += 1
            else:
                self.genotype_calls += 1
                if c.is_heterozygous:
                    self.heterozygous += 1
                elif not c.is_homozygous_reference:
                    self.homozygous_alt += 1

    def print_report(self, fh) -> None:
        fh.write("Variant counts by type\n")
        for k, v in sorted(self.counts.items()):
            fh.write(f"{k}\t{v}\n")
        if self.transversions > 0:
            fh.write(f"Ts/Tv\t{self.transitions / self.transversions:.4f}\n")
        fh.write(f"Genotype calls\t{self.genotype_calls}\n")
        fh.write(f"Heterozygous\t{self.heterozygous}\n")
        fh.write(f"Homozygous alternative\t{self.homozygous_alt}\n")
        fh.write(f"Undecided\t{self.undecided}\n")


def variant_density(
    records: list[VCFRecord], window: int = 100000
) -> list[tuple[str, int, int]]:
    """Variant counts in genomic windows (ref: VCFVariantDensityCalculator)."""
    counts: dict[tuple[str, int], int] = {}
    order: list[tuple[str, int]] = []
    for r in records:
        key = (r.variant.sequence_name, (r.variant.first - 1) // window)
        if key not in counts:
            counts[key] = 0
            order.append(key)
        counts[key] += 1
    return [(seq, w * window + 1, counts[(seq, w)]) for seq, w in order]


# --------------------------------------------------------------------------
def distance_matrix(records: list[VCFRecord], *, device) -> tuple[np.ndarray, list[str]]:
    """Genetic distance matrix from genotype dosages, (N, N) float32.

    Ref: VCFDistanceMatrixCalculator (default IBS-style distance: average
    |dosage_i - dosage_j| / 2 over shared genotyped sites).  Runs as
    one-hot float32 matrix products on `device` instead of per-pair loops.
    Every product sums 0/1 terms, so its counts are exact integers below
    2^24 sites, in any order of summation: the matrix equals the JAX
    package's bit for bit there.
    """
    dos, samples = dosage_matrix(records)
    d = torch.from_numpy(dos).to(device)
    valid = (d >= 0).float()  # (T, N)
    shared = valid.T @ valid  # (N, N) sites genotyped in both
    onehot = torch.stack([(d == g).float() for g in (0, 1, 2)], 0)  # (3,T,N)
    # sum over sites of |di-dj|: |0-1|=1,|0-2|=2,|1-2|=1
    cross = torch.einsum("gtn,htm->ghnm", onehot, onehot)
    absdiff = torch.zeros_like(shared)
    for g in range(3):
        for h in range(3):
            absdiff = absdiff + abs(g - h) * cross[g, h]
    dist = (absdiff / torch.clamp(shared, min=1.0) / 2.0).cpu().numpy()
    np.fill_diagonal(dist, 0.0)
    return dist, samples


def write_distance_matrix(dist: np.ndarray, samples: list[str], fh) -> None:
    """Generic/PHYLIP-like matrix output (ref: DistanceMatrix print)."""
    fh.write(f"{len(samples)}\n")
    for i, s in enumerate(samples):
        fh.write(s + " " + " ".join(f"{x:.6f}" for x in dist[i]) + "\n")


def load_distance_matrix(fh) -> tuple[np.ndarray, list[str]]:
    n = int(fh.readline().strip())
    names = []
    rows = []
    for _ in range(n):
        parts = fh.readline().split()
        names.append(parts[0])
        rows.append([float(x) for x in parts[1:]])
    return np.array(rows), names


# --------------------------------------------------------------------------
@dataclass
class GenotypeComparisonResult:
    both_genotyped: int = 0
    concordant: int = 0
    only_first: int = 0
    only_second: int = 0

    @property
    def concordance(self) -> float:
        return self.concordant / self.both_genotyped if self.both_genotyped else 0.0


def compare_vcfs(
    records1: list[VCFRecord], records2: list[VCFRecord]
) -> GenotypeComparisonResult:
    """Genotype concordance between two VCFs on shared sites/samples.

    Ref: VCFComparator.java.
    """
    res = GenotypeComparisonResult()
    idx2 = {
        (r.variant.sequence_name, r.variant.first): r for r in records2
    }
    keys1 = {(r.variant.sequence_name, r.variant.first) for r in records1}
    res.only_second += sum(1 for k in idx2 if k not in keys1)
    for r1 in records1:
        key = (r1.variant.sequence_name, r1.variant.first)
        r2 = idx2.get(key)
        if r2 is None:
            res.only_first += 1
            continue
        calls2 = {c.sample_id: c for c in r2.calls}
        # positional fallback when sample ids don't match (e.g. comparing a
        # single-sample callset against a differently-named truth set)
        positional = not any(c.sample_id in calls2 for c in r1.calls)
        for ci, c1 in enumerate(r1.calls):
            if positional:
                c2 = r2.calls[ci] if ci < len(r2.calls) else None
            else:
                c2 = calls2.get(c1.sample_id)
            if c2 is None:
                continue
            g1 = None if c1.is_undecided else sorted(c1.called_alleles())
            g2 = None if c2.is_undecided else sorted(c2.called_alleles())
            if g1 is not None and g2 is not None:
                res.both_genotyped += 1
                if g1 == g2:
                    res.concordant += 1
            elif g1 is not None:
                res.only_first += 1
            elif g2 is not None:
                res.only_second += 1
    return res


# --------------------------------------------------------------------------
def merge_vcfs(record_lists: list[list[VCFRecord]], sample_ids: list[str]) -> list[VCFRecord]:
    """Merge per-sample VCFs into one population VCF.

    Ref: IndividualSampleVariantsMerge / ConsistentVCFFilesMerge — union of
    sites; samples without a call at a site get an undecided genotype.
    """
    sites: dict[tuple[str, int, tuple[str, ...]], GenomicVariant] = {}
    per_sample: list[dict[tuple, CalledGenomicVariant]] = []
    for records in record_lists:
        m = {}
        for r in records:
            key = (r.variant.sequence_name, r.variant.first, tuple(r.variant.alleles))
            if key not in sites:
                sites[key] = r.variant
            else:
                v = sites[key]
                v.quality = max(v.quality, r.variant.quality)
            if r.calls:
                m[key] = r.calls[0]
        per_sample.append(m)
    out = []
    for key in sorted(sites.keys(), key=lambda k: (k[0], k[1])):
        v = sites[key]
        calls = []
        for si, m in enumerate(per_sample):
            c = m.get(key)
            if c is None:
                c = CalledGenomicVariant(
                    sequence_name=v.sequence_name,
                    first=v.first,
                    alleles=list(v.alleles),
                    variant_type=v.variant_type,
                    sample_id=sample_ids[si],
                )
            else:
                c.sample_id = sample_ids[si]
            calls.append(c)
        out.append(VCFRecord(variant=v, calls=calls))
    return out
