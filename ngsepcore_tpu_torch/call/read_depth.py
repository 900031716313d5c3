"""Read-depth CNV detection.

Ref: src/ngsep/discovery/rd/ — ReadDepthDistribution.java (genome bins of
100bp default, GC correction :223, depth distribution fit :286-357),
SingleSampleReadDepthAlgorithm.java:26-47 (algorithm interface),
PoissonHMMReadDepthAlgorithm.java + AbstractHMMReadDepthAlgorithm (HMM over
bins with copy-number states and Poisson-like emissions), CNVseqAlgorithm
(`ReadDepthComparator` command: case-control CNV from depth ratios).

Depth binning is one bincount; GC correction is a vectorized per-GC-bin
renormalization; both stay on the host in numpy, as do the EWT and
CNVnator callers and the emissions of the two HMM callers (math.lgamma,
so that they equal the JAX package's bit for bit and no Viterbi tie falls
the other way).  Only the copy-number recursion over all bins runs on the
callers' device: every sequence of a call in one launch
(kernels/hmm.viterbi_log_batch).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..align.read_alignment import ReadAlignment
from ..core.genome import ReferenceGenome
from ..kernels.hmm import viterbi_log_batch
from ..math.phred import phred_score
from ..variants.model import CalledGenomicVariant, TYPE_CNV

DEFAULT_BIN_SIZE = 100  # ref: ReadDepthDistribution.java:45


class ReadDepthDistribution:
    """Genome-binned read depth with GC correction."""

    def __init__(self, genome: ReferenceGenome, bin_size: int = DEFAULT_BIN_SIZE):
        self.genome = genome
        self.bin_size = bin_size
        self.bins_per_seq: list[np.ndarray] = []
        self.gc_per_seq: list[np.ndarray] = []
        for si in range(genome.num_sequences):
            L = genome.sequence_length(si)
            nbins = (L + bin_size - 1) // bin_size
            self.bins_per_seq.append(np.zeros(nbins, np.float64))
            codes = genome.sequences[si].codes
            pad = nbins * bin_size - L
            padded = np.concatenate([codes, np.full(pad, 4, np.int8)])
            mat = padded.reshape(nbins, bin_size)
            gc = np.mean((mat == 1) | (mat == 2), axis=1)
            valid = np.mean(mat < 4, axis=1)
            gc = np.where(valid > 0.5, gc / np.maximum(valid, 1e-9), np.nan)
            self.gc_per_seq.append(gc)
        self.mean_read_depth = 0.0
        self.sigma_read_depth = 0.0

    def process_alignments(self, alns: list[ReadAlignment]) -> None:
        """Count read midpoints per bin (vectorized per sequence)."""
        by_seq: dict[str, list[int]] = {}
        for a in alns:
            if a.is_unmapped:
                continue
            mid = (a.first + a.last) // 2
            by_seq.setdefault(a.sequence_name, []).append(mid)
        for name, mids in by_seq.items():
            si = self.genome.index_of(name)
            if si < 0:
                continue
            idx = (np.array(mids, np.int64) - 1) // self.bin_size
            nbins = len(self.bins_per_seq[si])
            idx = idx[(idx >= 0) & (idx < nbins)]
            self.bins_per_seq[si] += np.bincount(idx, minlength=nbins)

    def correct_depth_by_gc_content(self) -> None:
        """Scale each bin's depth so all GC classes share the global mean.

        Ref: ReadDepthDistribution.correctDepthByGCContent (:223).
        """
        all_depth = np.concatenate(self.bins_per_seq)
        all_gc = np.concatenate(self.gc_per_seq)
        ok = ~np.isnan(all_gc)
        global_mean = all_depth[ok].mean() if ok.any() else 0.0
        gc_bins = np.clip((np.nan_to_num(all_gc, nan=-1) * 100).astype(int), -1, 100)
        means = np.zeros(101)
        for g in range(101):
            sel = ok & (gc_bins == g)
            if sel.sum() >= 10:
                means[g] = all_depth[sel].mean()
        for si in range(len(self.bins_per_seq)):
            gc = self.gc_per_seq[si]
            gb = np.clip((np.nan_to_num(gc, nan=-1) * 100).astype(int), -1, 100)
            m = np.where((gb >= 0), means[np.maximum(gb, 0)], 0.0)
            factor = np.where(m > 0, global_mean / np.maximum(m, 1e-9), 1.0)
            self.bins_per_seq[si] = self.bins_per_seq[si] * factor

    def fit(self) -> None:
        all_depth = np.concatenate(self.bins_per_seq)
        ok = all_depth > 0
        if ok.sum() == 0:
            return
        self.mean_read_depth = float(np.median(all_depth[ok]))
        self.sigma_read_depth = float(all_depth[ok].std())


class PoissonHMMReadDepthAlgorithm:
    """Copy-number HMM over depth bins with Poisson emissions.

    Ref: PoissonHMMReadDepthAlgorithm.java — states are copy numbers
    0..2*normal_ploidy, emission = Poisson(bin depth | cn/ploidy * mean),
    sticky transitions; CNV calls are maximal runs of non-normal states.
    """

    def __init__(
        self,
        normal_ploidy: int = 2,
        max_copies: int = 4,
        change_probability: float = 0.001,
        min_cnv_bins: int = 5,
        *,
        device,  # where the Viterbi recursion runs
    ):
        self.device = torch.device(device)
        self.normal_ploidy = normal_ploidy
        self.n_states = max_copies + 1  # copy numbers 0..max_copies
        self.change_probability = change_probability
        self.min_cnv_bins = min_cnv_bins

    def _viterbi_paths(self, log_start, log_trans, emits: list) -> list:
        """Most likely copy-number path of each sequence's host float64
        emissions (T_b, S), all decoded in one launch on the algorithm's
        device: concatenated on the host, uploaded once, fetched once."""
        if not emits:
            return []
        n = len(emits)
        lengths = [len(e) for e in emits]
        up = lambda a: torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.float64)
        ).to(self.device)
        paths, _ = viterbi_log_batch(
            up(np.repeat(log_start[None], n, axis=0)),
            up(np.repeat(log_trans, n, axis=0)),
            up(np.concatenate(emits)),
            lengths,
        )
        return np.split(paths.cpu().numpy(), np.cumsum(lengths)[:-1])

    def call_cnvs(
        self, distribution: ReadDepthDistribution
    ) -> list[CalledGenomicVariant]:
        mean = distribution.mean_read_depth
        if mean <= 0:
            return []
        S = self.n_states
        p = self.change_probability
        trans = np.full((S, S), p / (S - 1))
        np.fill_diagonal(trans, 1 - p)
        log_trans = np.log10(trans)[None]
        log_start = np.full(S, -math.log10(S))
        # Poisson log10 emissions per copy-number state; cn=0 keeps a small
        # residual rate (mismapped reads)
        lam = np.maximum(
            mean * np.arange(S)[None, :] / self.normal_ploidy, mean * 0.05
        )  # (1, S)
        kept, emits = [], []
        for si in range(distribution.genome.num_sequences):
            depth = distribution.bins_per_seq[si]
            if len(depth) < 2 or depth.sum() == 0:
                continue
            kept.append(si)
            emits.append(_poisson_log10(np.round(depth)[:, None], lam))
        paths = self._viterbi_paths(log_start, log_trans, emits)
        out: list[CalledGenomicVariant] = []
        for si, path in zip(kept, paths):
            depth = distribution.bins_per_seq[si]
            # extract maximal runs of non-normal copy number
            seq_name = distribution.genome.sequence_name(si)
            bs = distribution.bin_size
            t = 0
            T = len(path)
            while t < T:
                cn = int(path[t])
                if cn == self.normal_ploidy:
                    t += 1
                    continue
                start = t
                while t < T and int(path[t]) == cn:
                    t += 1
                if t - start < self.min_cnv_bins:
                    continue
                seg_depth = depth[start:t].mean()
                # quality: Poisson LR of called cn vs normal ploidy on segment
                lr = float(
                    np.sum(
                        _poisson_log10(np.round(depth[start:t])[:, None], lam[:, [cn]])
                        - _poisson_log10(
                            np.round(depth[start:t])[:, None],
                            lam[:, [self.normal_ploidy]],
                        )
                    )
                )
                qual = min(255, max(0, int(round(10 * lr))))
                call = CalledGenomicVariant(
                    sequence_name=seq_name,
                    first=start * bs + 1,
                    alleles=["N"],
                    variant_type=TYPE_CNV,
                    quality=qual,
                    last_=min(t * bs, distribution.genome.sequence_length(si)),
                    copy_number=cn,
                    genotype_quality=qual,
                    total_read_depth=int(round(seg_depth)),
                    indexes_called_alleles=[0],
                )
                out.append(call)
        return out


def _poisson_log10(d: np.ndarray, lam: np.ndarray) -> np.ndarray:
    """log10 Poisson pmf, vectorized (d (T,1), lam (1,S))."""
    from math import lgamma

    lg = np.vectorize(lgamma)
    ln = d * np.log(lam) - lam - lg(d + 1.0)
    return ln / math.log(10.0)


class EWTReadDepthAlgorithm:
    """Event-wise testing CNV caller.

    Ref: discovery/rd/EWTReadDepthAlgorithm.java:137-340 — per-bin z-scores
    of GC-corrected depth, upper/lower tail normal probabilities; for every
    interval length l while significance = (FPR/(numBins/l))^(1/l) < 0.5,
    non-overlapping l-bin intervals whose max tail probability beats the
    significance are events; events filter by |median - mean| and merge when
    adjacent with the same direction (:248-292).

    Vectorized: per l the bins reshape to (n_intervals, l) and the interval
    max/median/mean reduce along axis 1 — no per-interval objects.
    """

    SOURCE = "EWT"

    def __init__(self, normal_ploidy: int = 2, false_positive_rate: float = 0.05,
                 merge: bool = True, filter: bool = True):
        self.normal_ploidy = normal_ploidy
        self.false_positive_rate = false_positive_rate
        self.merge = merge
        self.filter = filter

    def call_cnvs(self, dist: ReadDepthDistribution) -> list[CalledGenomicVariant]:
        from math import erf, sqrt

        mean = dist.mean_read_depth
        sigma = max(dist.sigma_read_depth, 1e-9)
        if mean <= 0:
            return []
        out: list[CalledGenomicVariant] = []
        for si in range(dist.genome.num_sequences):
            depth = dist.bins_per_seq[si]
            n = len(depth)
            if n < 4:
                continue
            z = (depth - mean) / sigma
            # Φ(z) via erf — lower tail; upper = 1 - Φ
            lower = 0.5 * (1.0 + np.vectorize(erf)(z / sqrt(2.0)))
            upper = 1.0 - lower
            events: list[tuple[int, int, float, bool]] = []  # (b0, b1, p, is_dup)
            l = 2
            while True:
                significance = (self.false_positive_rate / max(n / l, 1.0)) ** (1.0 / l)
                if significance >= 0.5:
                    break
                m = (n // l) * l
                if m >= l:
                    up = upper[:m].reshape(-1, l).max(axis=1)
                    lo = lower[:m].reshape(-1, l).max(axis=1)
                    for i in np.nonzero(up < significance)[0]:
                        events.append((i * l, i * l + l, float(up[i]), True))
                    for i in np.nonzero((lo < significance) & ~(up < significance))[0]:
                        events.append((i * l, i * l + l, float(lo[i]), False))
                l += 1
            if not events:
                continue
            events.sort()
            if self.filter:
                events = [
                    e
                    for e in events
                    if np.median(depth[e[0] : e[1]]) > 1.25 * mean
                    or np.median(depth[e[0] : e[1]]) < 0.75 * mean
                ]
            if self.merge:
                merged: list[list] = []
                for e in events:
                    if (
                        merged
                        and e[0] <= merged[-1][1]
                        and e[3] == merged[-1][3]
                    ):
                        merged[-1][1] = max(merged[-1][1], e[1])
                        merged[-1][2] = min(merged[-1][2], e[2])
                    else:
                        merged.append(list(e))
                events = [tuple(e) for e in merged]
            name = dist.genome.sequence_name(si)
            bs = dist.bin_size
            for b0, b1, p, is_dup in events:
                seg = depth[b0:b1]
                copies = self.normal_ploidy * float(seg.mean()) / mean
                out.append(
                    CalledGenomicVariant(
                        sequence_name=name,
                        first=b0 * bs + 1,
                        alleles=["N"],
                        variant_type=TYPE_CNV,
                        quality=phred_score(p),
                        last_=min(b1 * bs, dist.genome.sequence_length(si)),
                        copy_number=max(0, int(round(copies))),
                        genotype_quality=phred_score(p),
                        total_read_depth=int(round(seg.sum())),
                        indexes_called_alleles=[0],
                    )
                )
        return out


class CNVnatorReadDepthAlgorithm:
    """Mean-shift partition CNV caller (CNVnator family).

    Ref: discovery/rd/CNVnatorReadDepthAlgorithm.java:145-705 — multi-band
    mean-shift smoothing of bin depths (calcLevels :186), partition into
    level regions, per-region normal-tail p-values vs the genome depth
    distribution, calls where p < cut and |level - mean| is large enough.

    Vectorized mean-shift: per band h the gradient sign at bin i is the sum
    over neighbor offsets d in [-3h, 3h] of sign(d) * exp(-d^2/(2h^2)) *
    exp(-(depth[i+d]-depth[i])^2 / (2 sigma^2)); bins between a +→-
    gradient-sign change form one segment whose depth is replaced by its
    mean — each band is a stack of shifted array ops, no per-bin loops.
    """

    SOURCE = "CNVnator"

    def __init__(self, normal_ploidy: int = 2, cut_pvalue: float = 0.05,
                 max_band: int = 128, min_cnv_bins: int = 3):
        self.normal_ploidy = normal_ploidy
        self.cut_pvalue = cut_pvalue
        self.max_band = max_band
        self.min_cnv_bins = min_cnv_bins

    def _mean_shift_partition(
        self, depth: np.ndarray, mean: float
    ) -> tuple[np.ndarray, np.ndarray]:
        """Multi-band edge-preserving mean shift with mask-and-freeze.

        The range kernel uses the Poisson noise scale sqrt(mean) (the
        reference scales per-bin sigma with sqrt(level/mean) the same way);
        after each band, segments whose level is significantly away from
        the genome mean freeze (CNVnator's updateMask/skipMasked :255-276)
        so larger bands cannot smooth real events back into the background.
        Returns (levels, mask)."""
        from math import erf, sqrt

        levels = depth.astype(np.float64).copy()
        n = len(levels)
        mask = np.zeros(n, bool)
        sigma_r = max(sqrt(max(mean, 1.0)), 1e-9)
        inv2s2 = 1.0 / (2.0 * sigma_r * sigma_r)
        band = 2
        while band <= self.max_band and band < n:
            inv2h2 = 1.0 / (2.0 * band * band)
            for _ in range(3):
                num = levels.copy()
                den = np.ones(n)
                for d in range(1, 3 * band + 1):
                    w = math.exp(-d * d * inv2h2)
                    for sgn in (1, -1):
                        sh = np.roll(levels, sgn * d)
                        shm = np.roll(mask, sgn * d)
                        if sgn > 0:
                            sh[:d] = levels[0]
                            shm[:d] = True
                        else:
                            sh[-d:] = levels[-1]
                            shm[-d:] = True
                        ww = w * np.exp(-((sh - levels) ** 2) * inv2s2) * (~shm)
                        num += ww * sh
                        den += ww
                levels = np.where(mask, levels, num / den)
            # freeze significant segments at this band
            jump = np.abs(np.diff(levels)) > sigma_r / 2
            bounds = np.concatenate(
                [[0], np.nonzero(jump | (np.diff(mask.astype(np.int8)) != 0))[0] + 1,
                 [n]]
            )
            for a, b in zip(bounds[:-1], bounds[1:]):
                if mask[a]:
                    continue
                lv = levels[a:b].mean()
                z = (lv - mean) / (sigma_r / sqrt(b - a))
                p = 0.5 * (1.0 - erf(abs(z) / sqrt(2.0)))
                if p < self.cut_pvalue and abs(lv - mean) > sigma_r:
                    mask[a:b] = True
                    levels[a:b] = lv
            band *= 2
        return levels, mask

    def call_cnvs(self, dist: ReadDepthDistribution) -> list[CalledGenomicVariant]:
        from math import erf, sqrt

        mean = dist.mean_read_depth
        if mean <= 0:
            return []
        sigma_r = max(math.sqrt(max(mean, 1.0)), 1e-9)
        out: list[CalledGenomicVariant] = []
        for si in range(dist.genome.num_sequences):
            depth = dist.bins_per_seq[si]
            n = len(depth)
            if n < 2 * self.min_cnv_bins:
                continue
            levels, mask = self._mean_shift_partition(depth, mean)
            # regions = maximal masked runs of equal level
            brk = np.nonzero(
                (np.diff(levels) != 0) | (np.diff(mask.astype(np.int8)) != 0)
            )[0] + 1
            bounds = np.concatenate([[0], brk, [n]])
            name = dist.genome.sequence_name(si)
            bs = dist.bin_size
            for a, b in zip(bounds[:-1], bounds[1:]):
                if b - a < self.min_cnv_bins or not mask[a]:
                    continue
                level = levels[a]
                zr = (level - mean) / (sigma_r / sqrt(b - a))
                p = 0.5 * (1.0 - erf(abs(zr) / sqrt(2.0)))
                if p >= self.cut_pvalue:
                    continue
                copies = self.normal_ploidy * level / mean
                cn = max(0, int(round(copies)))
                if cn == self.normal_ploidy:
                    continue
                out.append(
                    CalledGenomicVariant(
                        sequence_name=name,
                        first=int(a) * bs + 1,
                        alleles=["N"],
                        variant_type=TYPE_CNV,
                        quality=phred_score(max(p, 1e-30)),
                        last_=min(int(b) * bs, dist.genome.sequence_length(si)),
                        copy_number=cn,
                        genotype_quality=phred_score(max(p, 1e-30)),
                        total_read_depth=int(round(depth[a:b].sum())),
                        indexes_called_alleles=[0],
                    )
                )
        return out


class MaximumLikelihoodReadDepthAlgorithm(PoissonHMMReadDepthAlgorithm):
    """Copy-number HMM with Gaussian emissions.

    Ref: discovery/rd/MaximumLikelihoodReadDepthAlgorithm.java:90-140 —
    same state/transition layout as the Poisson HMM (change probability
    0.01) but each copy-number state emits the bin depth under a normal
    density centered at cn/ploidy * mean.
    """

    SOURCE = "MAXIMUMLIKELIHOOD"

    def __init__(self, normal_ploidy: int = 2, max_copies: int = 4,
                 change_probability: float = 0.01, min_cnv_bins: int = 5,
                 *, device):
        super().__init__(normal_ploidy, max_copies, change_probability,
                         min_cnv_bins, device=device)

    def call_cnvs(self, distribution: ReadDepthDistribution):
        mean = distribution.mean_read_depth
        sigma = max(distribution.sigma_read_depth, 1e-9)
        if mean <= 0:
            return []
        S = self.n_states
        p = self.change_probability
        trans = np.full((S, S), p / (S - 1))
        np.fill_diagonal(trans, 1 - p)
        log_trans = np.log10(trans)[None]
        log_start = np.full(S, -math.log10(S))
        mu = np.maximum(mean * np.arange(S) / self.normal_ploidy, mean * 0.05)
        # per-state sigma scales with sqrt of the expected copies
        sd = sigma * np.sqrt(np.maximum(np.arange(S), 0.25) / self.normal_ploidy)
        kept, emits = [], []
        for si in range(distribution.genome.num_sequences):
            depth = distribution.bins_per_seq[si]
            if len(depth) < 2 or depth.sum() == 0:
                continue
            kept.append(si)
            emits.append((
                -0.5 * ((depth[:, None] - mu[None, :]) / sd[None, :]) ** 2
                - np.log(sd[None, :] * math.sqrt(2 * math.pi))
            ) / math.log(10.0))
        paths = self._viterbi_paths(log_start, log_trans, emits)
        out = []
        for si, path in zip(kept, paths):
            out.extend(self._calls_from_path(
                distribution, si, path, distribution.bins_per_seq[si], mu))
        return out

    def _calls_from_path(self, distribution, si, path, depth, mu):
        seq_name = distribution.genome.sequence_name(si)
        bs = distribution.bin_size
        out = []
        t, T = 0, len(path)
        while t < T:
            cn = int(path[t])
            if cn == self.normal_ploidy:
                t += 1
                continue
            start = t
            while t < T and int(path[t]) == cn:
                t += 1
            if t - start < self.min_cnv_bins:
                continue
            seg = depth[start:t]
            z = abs(seg.mean() - mu[self.normal_ploidy]) / max(
                mu[self.normal_ploidy], 1e-9
            )
            qual = min(255, max(0, int(round(40 * z * math.sqrt(t - start)))))
            out.append(
                CalledGenomicVariant(
                    sequence_name=seq_name,
                    first=start * bs + 1,
                    alleles=["N"],
                    variant_type=TYPE_CNV,
                    quality=qual,
                    last_=min(t * bs, distribution.genome.sequence_length(si)),
                    copy_number=cn,
                    genotype_quality=qual,
                    total_read_depth=int(round(seg.sum())),
                    indexes_called_alleles=[0],
                )
            )
        return out


CNV_ALGORITHMS = {
    "CNVnator": CNVnatorReadDepthAlgorithm,
    "EWT": EWTReadDepthAlgorithm,
    "PoissonHMM": PoissonHMMReadDepthAlgorithm,
    "MAXIMUMLIKELIHOOD": MaximumLikelihoodReadDepthAlgorithm,
}


def cnv_seq_compare(
    genome: ReferenceGenome,
    case_alns: list[ReadAlignment],
    control_alns: list[ReadAlignment],
    bin_size: int = DEFAULT_BIN_SIZE,
    min_ratio: float = 2.0,
    min_bins: int = 5,
) -> list[CalledGenomicVariant]:
    """Case-control CNV detection from depth ratios.

    Ref: discovery/rd/CNVseqAlgorithm.java (`ReadDepthComparator` command):
    per-bin depth ratio case/control normalized by totals, merged runs of
    extreme ratios become CNV calls.
    """
    case = ReadDepthDistribution(genome, bin_size)
    case.process_alignments(case_alns)
    control = ReadDepthDistribution(genome, bin_size)
    control.process_alignments(control_alns)
    tot_case = sum(b.sum() for b in case.bins_per_seq) or 1.0
    tot_ctrl = sum(b.sum() for b in control.bins_per_seq) or 1.0
    out: list[CalledGenomicVariant] = []
    for si in range(genome.num_sequences):
        c = case.bins_per_seq[si] / tot_case
        k = control.bins_per_seq[si] / tot_ctrl
        ratio = (c + 1e-9) / (k + 1e-9)
        extreme = (ratio >= min_ratio) | (ratio <= 1.0 / min_ratio)
        extreme &= (case.bins_per_seq[si] + control.bins_per_seq[si]) >= 5
        t = 0
        T = len(ratio)
        name = genome.sequence_name(si)
        while t < T:
            if not extreme[t]:
                t += 1
                continue
            up = ratio[t] > 1
            start = t
            while t < T and extreme[t] and (ratio[t] > 1) == up:
                t += 1
            if t - start < min_bins:
                continue
            seg_ratio = float(np.mean(ratio[start:t]))
            cn = max(0, int(round(2 * seg_ratio)))
            out.append(
                CalledGenomicVariant(
                    sequence_name=name,
                    first=start * bin_size + 1,
                    alleles=["N"],
                    variant_type=TYPE_CNV,
                    quality=int(min(255, 10 * abs(np.log2(seg_ratio)) * (t - start))),
                    last_=min(t * bin_size, genome.sequence_length(si)),
                    copy_number=cn,
                    indexes_called_alleles=[0],
                )
            )
    return out
