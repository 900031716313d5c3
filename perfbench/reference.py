"""Plain reference of what a single-sample run must produce (numpy only).

Two parts, each independent of the program:

- `truth_pileup`: the allele counts a correct aligner gives at chosen
  reference positions.  Every read's bases are placed where the simulator
  took them from (its haplotype start, strand and the haplotype's map to
  the reference), so seeding, candidate selection and gapped alignment are
  replaced by what they must find in unique sequence.
- `genotype`: NGSEP's diploid SNV genotype model on allele counts
  (CountsHelper: one base quality clamped to 30, heterozygous allele
  frequency 250/500, the homozygous and heterozygous log priors, the 1e-20
  truncation, the +0.01 decision margin, GQ, QUAL = phred of the
  homozygous-reference posterior, phred-scaled likelihoods over the called
  alleles), computed in the float type it is given.  The configuration
  states float64; the control runs it in float32.
"""
from __future__ import annotations

import numpy as np

N_ALLELES = 4
NUM_FREQ = 501
MAX_BASE_QS = 30
MIN_BASE_QS = 3
MAX_PHRED = 255
# pairs (i <= j) in the order the decision visits them
PAIRS = [(i, j) for i in range(N_ALLELES) for j in range(i, N_ALLELES)]


def contribution(base_quality: int, dtype) -> np.ndarray:
    """(4, 16) table: C[a, 4 i + j] is the log10 probability of one read
    base `a` under the ordered genotype (i, j)."""
    q = dtype(min(base_quality, MAX_BASE_QS))
    if q <= MIN_BASE_QS:
        return np.zeros((N_ALLELES, N_ALLELES * N_ALLELES), dtype)
    ten, tenth, three = dtype(10.0), dtype(-0.1), dtype(N_ALLELES - 1)
    err = ten ** (tenth * q)
    log_err_n = tenth * q - np.log10(three)
    success = dtype(1.0) - err
    f = np.floor(0.5 * (NUM_FREQ - 1) + 0.5)
    af = dtype(f / (NUM_FREQ - 1))
    log_gt0 = np.log10(success)
    log_het = np.log10(af * success + (dtype(1.0) - af) * err / three)
    C = np.empty((N_ALLELES, N_ALLELES, N_ALLELES), dtype)
    for a in range(N_ALLELES):
        for i in range(N_ALLELES):
            for j in range(N_ALLELES):
                if i == j:
                    C[a, i, j] = log_gt0 if i == a else log_err_n
                elif a in (i, j):
                    C[a, i, j] = log_het
                else:
                    C[a, i, j] = log_err_n
    return C.reshape(N_ALLELES, -1)


def genotype(depths: np.ndarray, ref: np.ndarray, *, base_quality: int, het_rate: float,
             min_quality: int, dtype=np.float64) -> dict:
    """The model's call at m positions from (m, 4) allele counts and the
    (m,) reference codes.  Returns the call (`emit`, `bi`, `bj`, `gq`,
    `qual`, `logcond` (m, 4, 4)) and the unrounded GQ and QUAL with the
    closest decision margin, which say where a rounding tie may go either
    way."""
    dtype = np.dtype(dtype).type
    m = depths.shape[0]
    n = N_ALLELES
    logcond = depths.astype(dtype) @ contribution(base_quality, dtype)
    eye = np.eye(n, dtype=bool).reshape(-1)
    prior = np.where(
        eye, np.log10(dtype((1 - het_rate) / n)), np.log10(dtype(het_rate / (n * (n - 1))))
    ).astype(dtype)
    ev = logcond + prior[None, :]
    rel = ev - ev.max(axis=1, keepdims=True)
    with np.errstate(under="ignore"):
        p = np.where(rel < dtype(-20.0), dtype(0.0), dtype(10.0) ** rel).astype(dtype)
    post = (p / p.sum(axis=1, keepdims=True)).reshape(m, n, n)
    rows = np.arange(m)
    best = post[rows, ref, ref]
    bi = ref.astype(np.int64).copy()
    bj = bi.copy()
    margin = np.full(m, np.inf)
    for i, j in PAIRS:
        prob = post[:, i, j] + (post[:, j, i] if i != j else dtype(0.0))
        gap = prob - (best + dtype(0.01))
        margin = np.minimum(margin, np.abs(gap.astype(np.float64)))
        upd = gap > 0
        best = np.where(upd, prob, best)
        bi = np.where(upd, i, bi)
        bj = np.where(upd, j, bj)
    one_minus = dtype(1.0) - best
    with np.errstate(divide="ignore"):
        gq_raw = -10.0 * np.log10(np.maximum(one_minus, dtype(1e-30)))
    gq = np.where(one_minus <= 0, MAX_PHRED, np.minimum(np.rint(gq_raw), MAX_PHRED))
    ref_prob = post[rows, ref, ref]
    with np.errstate(divide="ignore"):
        qual_raw = -10.0 * np.log10(np.where(ref_prob > 0, ref_prob, dtype(1.0)))
    qual = np.where(
        ref_prob <= 0, MAX_PHRED,
        np.where(ref_prob >= 1, 0, np.minimum(np.rint(qual_raw), MAX_PHRED)),
    )
    total = depths.sum(axis=1)
    emit = ((bi != ref) | (bj != ref)) & (gq >= min_quality) & (gq > 0) & (total > 0)
    return dict(
        emit=emit, bi=bi, bj=bj, gq=gq.astype(np.int64), qual=qual.astype(np.int64),
        logcond=logcond.reshape(m, n, n), gq_raw=gq_raw.astype(np.float64),
        qual_raw=qual_raw.astype(np.float64), margin=margin,
    )


def called_alleles(ref: int, bi: int, bj: int):
    """(allele codes, GT indexes) of a call (the detector's record)."""
    if bi != bj and bi != ref and bj != ref:
        return (ref, bi, bj), (1, 2)
    if bi == bj and bi != ref:
        return (ref, bi), (1, 1)
    return (ref, bi if bi != ref else bj), (0, 1)


def phred_likelihoods(logcond: np.ndarray, idxs) -> tuple[list[int], list[float]]:
    """VCF-ordered phred-scaled likelihoods over `idxs` (0/0, 0/1, 1/1,
    0/2, ...), rounded and unrounded."""
    gls = [logcond[idxs[i], idxs[j]] for j in range(len(idxs)) for i in range(j + 1)]
    gls = np.array(gls, dtype=np.float64)
    raw = -10.0 * (gls - gls.max())
    return [int(min(x, MAX_PHRED)) for x in np.rint(raw)], list(raw)


def reverse_complement(codes: np.ndarray) -> np.ndarray:
    flipped = codes[..., ::-1]
    return np.where(flipped < 4, 3 - flipped, flipped).astype(codes.dtype)


def end_clip(m: np.ndarray) -> np.ndarray:
    """(n,) bases soft-clipped at the start of each row of a (n, L)
    mismatch mask, by NGSEP's ungapped rule (ShortReadsUngappedSearchHits
    ClusterAligner.countMismatches): walking in, the clip ends at the first
    matching position i with fewer than i - 3 mismatches before it, and
    takes everything up to the last mismatch before i."""
    n, L = m.shape
    idx = np.arange(L)[None, :]
    before = np.cumsum(m, axis=1) - m
    fire = ~m & (before + 3 < idx)
    has = fire.any(axis=1)
    first = np.argmax(fire, axis=1)
    last_mm = np.maximum.accumulate(np.where(m, idx, -1), axis=1)
    prev = np.where(first > 0, last_mm[np.arange(n), np.maximum(first - 1, 0)], -1)
    return np.where(has, prev + 1, 0)


# a clip needs a mismatch among a row's first CLIP_REACH bases: without
# one, the walk stops at base 4 with nothing to clip
CLIP_REACH = 5


def truth_pileup(sample, si: int, seq: np.ndarray, sites: np.ndarray,
                 chunk: int = 65536) -> np.ndarray:
    """(len(sites), 4) counts of each base that the sample's reads of
    sequence `si` place on its 0-based positions `sites` (`seq` is that
    sequence), every read at its true origin.  A read that lies on the
    reference without a gap loses the ends that NGSEP's ungapped aligner
    soft-clips (end_clip); a read across an indel keeps every base."""
    sites = np.asarray(sites, np.int64)
    index = np.full(len(seq), -1, np.int64)
    index[sites] = np.arange(len(sites))
    counts = np.zeros(len(sites) * N_ALLELES, np.int64)
    L = int(sample.lengths.max())
    cols = np.arange(L, dtype=np.int64)[None, :]
    ends = np.r_[0:CLIP_REACH, L - CLIP_REACH:L]
    for h, (_hap, hmap) in enumerate(sample.haps[si]):
        rows = np.nonzero((sample.seq_of == si) & (sample.hap_of == h))[0]
        for a in range(0, len(rows), chunk):
            r = rows[a : a + chunk]
            codes = sample.codes[r, :L]
            codes = np.where(sample.reverse[r, None], reverse_complement(codes), codes)
            refpos = hmap[sample.start[r, None] + cols]
            keep = (refpos >= 0) & (codes < 4)
            gapless = (refpos[:, -1] - refpos[:, 0] == L - 1) & (refpos[:, 0] >= 0)
            near_end = (codes[:, ends] != seq[np.maximum(refpos[:, ends], 0)]).any(axis=1)
            clip = np.nonzero(gapless & near_end)[0]
            if len(clip):
                m = codes[clip] != seq[refpos[clip]]
                cs, ce = end_clip(m), end_clip(m[:, ::-1])
                keep[clip] &= (cols >= cs[:, None]) & (cols < L - ce[:, None])
            at = np.where(keep, index[np.maximum(refpos, 0)], -1)
            keep &= at >= 0
            counts += np.bincount(
                at[keep] * N_ALLELES + codes[keep], minlength=len(counts)
            )
    return counts.reshape(-1, N_ALLELES)
