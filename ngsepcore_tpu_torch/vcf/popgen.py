"""Population-genetics analyses over VCF genotype matrices.

Ref: src/ngsep/vcf/VCFLDCalculator.java (pairwise linkage disequilibrium),
VCFAlleleSharingStatisticsCalculator.java (window/gene allele-sharing
diversity), VCFWindowIntrogressionAnalysis.java (window-based haplotype
introgression detection given population assignments),
discovery/RelativeAlleleCountsCalculator.java (relative allele-count
distributions for ploidy/contamination QC).

Counterpart of ngsepcore_tpu/vcf/popgen.py.  All operate on the dense
(sites, samples) dosage matrix on the host; pairwise LD is a correlation
matrix whose two float64 products run on the caller's device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .analytics import dosage_matrix
from .io import VCFRecord


@dataclass
class LDResult:
    pos1: int
    pos2: int
    r2: float
    d_prime: float


def ld_matrix(records: list[VCFRecord], *, device) -> tuple[np.ndarray, list[int]]:
    """r^2 between all biallelic SNV pairs (one correlation matmul on
    `device`, f64: its sums may take another order than the JAX
    package's XLA:CPU product, so r^2 agrees with it to rounding)."""
    recs = [r for r in records if r.variant.is_snv and r.variant.is_biallelic]
    dos, _ = dosage_matrix(recs)
    positions = [r.variant.first for r in recs]
    d = dos.astype(np.float64)
    d[dos < 0] = np.nan
    mean = np.nanmean(d, axis=1, keepdims=True)
    centered = np.nan_to_num(d - mean, nan=0.0)
    c = torch.from_numpy(centered).to(device)
    cov = (c @ c.T).cpu().numpy()
    var = np.nansum((d - mean) ** 2, axis=1)
    denom = np.sqrt(np.outer(var, var))
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(denom > 0, cov / denom, 0.0)
    r2 = np.clip(r * r, 0.0, 1.0)
    np.fill_diagonal(r2, 1.0)
    return r2, positions


def ld_pairs(
    records: list[VCFRecord], max_distance: int = 100000, min_r2: float = 0.0, *, device
) -> list[LDResult]:
    r2, positions = ld_matrix(records, device=device)
    out = []
    n = len(positions)
    for i in range(n):
        for j in range(i + 1, n):
            if positions[j] - positions[i] > max_distance:
                break
            if r2[i, j] >= min_r2:
                out.append(LDResult(positions[i], positions[j], float(r2[i, j]), 0.0))
    return out


def allele_sharing_stats(
    records: list[VCFRecord],
    groups: dict[str, str],
    window: int = 100000,
) -> list[dict]:
    """Window allele-sharing diversity within/between sample groups.

    Ref: VCFAlleleSharingStatisticsCalculator — average pairwise genotype
    distance within and between the two groups per window.
    """
    recs = [r for r in records if r.variant.is_snv and r.variant.is_biallelic]
    if not recs:
        return []
    dos, samples = dosage_matrix(recs)
    gnames = sorted(set(groups.values()))
    idx_a = [i for i, s in enumerate(samples) if groups.get(s) == gnames[0]]
    idx_b = [i for i, s in enumerate(samples) if groups.get(s) == (gnames[1] if len(gnames) > 1 else None)]
    out = []
    by_window: dict[tuple[str, int], list[int]] = {}
    for i, r in enumerate(recs):
        key = (r.variant.sequence_name, (r.variant.first - 1) // window)
        by_window.setdefault(key, []).append(i)
    for (seq, w), rows in sorted(by_window.items()):
        sub = dos[rows]

        def avg_dist(ii, jj):
            tot = cnt = 0
            for a in ii:
                for b in jj:
                    if a == b:
                        continue
                    ok = (sub[:, a] >= 0) & (sub[:, b] >= 0)
                    if ok.sum() == 0:
                        continue
                    tot += np.abs(sub[ok, a] - sub[ok, b]).mean() / 2
                    cnt += 1
            return tot / cnt if cnt else 0.0

        out.append(
            {
                "sequence": seq,
                "first": w * window + 1,
                "sites": len(rows),
                "within_a": avg_dist(idx_a, idx_a),
                "within_b": avg_dist(idx_b, idx_b),
                "between": avg_dist(idx_a, idx_b),
            }
        )
    return out


def introgression_analysis(
    records: list[VCFRecord],
    groups: dict[str, str],
    window: int = 100000,
    min_diff_af: float = 0.8,
) -> list[dict]:
    """Window-based introgression detection.

    Ref: VCFWindowIntrogressionAnalysis — find diagnostic sites (allele
    frequency difference >= min_diff_af between the two groups), then per
    sample per window score the fraction of diagnostic alleles matching
    the *other* group.
    """
    recs = [r for r in records if r.variant.is_snv and r.variant.is_biallelic]
    if not recs:
        return []
    dos, samples = dosage_matrix(recs)
    gnames = sorted(set(groups.values()))
    if len(gnames) < 2:
        return []
    idx = {g: [i for i, s in enumerate(samples) if groups.get(s) == g] for g in gnames}
    a, b = gnames[0], gnames[1]

    def af(rows, cols):
        sub = dos[np.ix_(rows, cols)].astype(np.float64)
        sub[sub < 0] = np.nan
        with np.errstate(invalid="ignore"):
            return np.nanmean(sub, axis=1) / 2.0

    site_rows = np.arange(len(recs))
    af_a = af(site_rows, idx[a])
    af_b = af(site_rows, idx[b])
    diagnostic = np.abs(np.nan_to_num(af_a, nan=0.5) - np.nan_to_num(af_b, nan=0.5)) >= min_diff_af
    out = []
    by_window: dict[tuple[str, int], list[int]] = {}
    for i, r in enumerate(recs):
        if diagnostic[i]:
            key = (r.variant.sequence_name, (r.variant.first - 1) // window)
            by_window.setdefault(key, []).append(i)
    for (seq, w), rows in sorted(by_window.items()):
        for si, sample in enumerate(samples):
            own = groups.get(sample)
            if own not in (a, b):
                continue
            other_af = af_b if own == a else af_a
            d = dos[rows, si].astype(np.float64)
            ok = d >= 0
            if ok.sum() < 3:
                continue
            # fraction of the sample's alleles matching the other group's allele
            other_allele = (other_af[rows] > 0.5).astype(np.float64)
            match = np.where(
                other_allele[ok] > 0.5, d[ok] / 2.0, 1.0 - d[ok] / 2.0
            ).mean()
            if match > 0.8:
                out.append(
                    {
                        "sample": sample,
                        "sequence": seq,
                        "first": w * window + 1,
                        "score": float(match),
                        "sites": int(ok.sum()),
                    }
                )
    return out


def relative_allele_counts(
    allele_depths: list[tuple[int, int]], n_bins: int = 20
) -> np.ndarray:
    """Distribution of minor-allele fraction at biallelic sites.

    Ref: RelativeAlleleCountsCalculator — used to detect ploidy anomalies
    and contamination from the shape of the relative allele count
    distribution.
    """
    hist = np.zeros(n_bins + 1, np.int64)
    for a, b in allele_depths:
        t = a + b
        if t < 2:
            continue
        frac = min(a, b) / t
        hist[int(round(frac * n_bins))] += 1
    return hist
