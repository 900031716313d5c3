"""Indel discovery: allele-call clustering + indel genotype likelihoods.

Ref:
- AlleleCallClustersBuilder.java:41-270 — cluster spanning allele strings
  by length (min relative proportion 0.2 when >2 length groups), Hamming
  consensus per length, optional split by heterozygous variant sites
  (het posterior >= 0.51), reference always allele 0.
- CountsHelper.updateCountsIndel (CountsHelper.java:253-304) — per-allele
  log-conditional = max(log10(1e-4), sum of per-base phred match/mismatch)
  for same-length alleles, else log10(1e-4); off-diagonal genotype mixes
  via logSum with allele frequency 0.5.
- VariantDiscoverySNVQAlgorithm.callIndel (:265-360) — genotype decision;
  no call when all decided alleles have the reference length.

Indel sites are sparse (<<1% of positions), so this path runs host-side in
numpy over the candidate sites that the dense SNV kernel cannot express;
the per-base likelihood sums are vectorized across calls per site.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.sequences import decode_dna, encode_dna
from ..math.logmath import log10_sum
from ..math.phred import phred_score
from ..variants.model import CalledGenomicVariant, TYPE_INDEL, TYPE_STR
from .pileup import IndelEvent

def _log10_sum_arr(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise mirror of math.logmath.log10_sum (incl. the diff<-20
    truncation) so the batched helper reproduces the scalar path exactly."""
    hi = np.maximum(a, b)
    diff = np.minimum(a, b) - hi
    small = diff < -20
    return np.where(
        small, hi, hi + np.log10(1.0 + 10.0 ** np.where(small, -20.0, diff))
    )


_SEL_LUTS: dict[int, np.ndarray] = {}


def lik_sel_lut(max_bq: int) -> np.ndarray:
    """Fused per-base log-likelihood table indexed by
    `q | match << 5 | ok << 6` (q integer in [0, max_bq], max_bq <= 31).

    Entries are computed with the exact inline expressions of the
    likelihood passes (10.0 ** (-0.1 * q), np.log10, float64), so a LUT
    gather is bit-identical to evaluating them per base — it just removes
    ~10M pow/log10 calls per bench run from the hot indel path:
      value(ok=0)          = 0.0
      value(ok=1, match=1) = log10(1 - 10^(-q/10))
      value(ok=1, match=0) = -q/10 - log10(3)
    """
    assert 0 < max_bq <= 31, max_bq
    lut = _SEL_LUTS.get(max_bq)
    if lut is None:
        q = np.arange(32, dtype=np.int64)
        with np.errstate(divide="ignore"):
            m = np.log10(1.0 - 10.0 ** (-0.1 * q))
        s = -0.1 * q - np.log10(3.0)
        lut = np.zeros(128, np.float64)
        lut[64:96] = s  # ok, mismatch
        lut[96:128] = m  # ok, match
        lut[96 + np.minimum(max_bq, 31) + 1 :] = 0.0
        lut[64 + np.minimum(max_bq, 31) + 1 : 96] = 0.0
        _SEL_LUTS[max_bq] = lut
    return lut


MIN_RELATIVE_PROPORTION = 0.2  # ref: AlleleCallClustersBuilder.java:41
MIN_HET_POSTERIOR = 0.51  # ref: :42
LOG_ERROR_PROB_INDEL = float(np.log10(1e-4))
NUM_FREQ = 501
MIN_BASE_QS = 3
LOG_HALF = float(np.log10(0.5))


@dataclass
class SpanningCall:
    """One read's spanning allele observation, carried as int8 codes (the
    string round trip was the hottest indel-path cost at bench scale:
    ~250k decode+encode pairs per run)."""

    codes: np.ndarray  # int8 allele codes (N=4)
    qualities: np.ndarray  # phred per base
    negative_strand: bool

    @property
    def allele(self) -> str:
        return decode_dna(self.codes)


def cluster_allele_calls(
    calls: list[SpanningCall], reference: str, max_base_qs: int = 30
) -> list[str]:
    """Port of clusterAlleleCalls: returns alleles with reference first."""
    by_length: dict[int, list[SpanningCall]] = {}
    for c in calls:
        by_length.setdefault(len(c.codes), []).append(c)
    # filter severe length imbalances only when >2 length clusters (:148-156)
    if len(by_length) >= 3:
        min_count = MIN_RELATIVE_PROPORTION * len(calls)
        by_length = {l: v for l, v in by_length.items() if len(v) >= min_count}
    alleles_set: set[str] = set()
    for l, calls_l in sorted(by_length.items()):
        suggested: set[str] = set()
        if l == len(reference):
            suggested.add(reference)
        if len(calls_l) < 5 * len(suggested):
            length_alleles = set(suggested)
        else:
            mat = np.stack([c.codes for c in calls_l])
            consensus = _hamming_consensus_str(mat)
            suggested.add(consensus)
            if l < 4 or len(calls_l) < 10:
                length_alleles = set(suggested)
            else:
                length_alleles = _split_by_variant_sites(calls_l, consensus, max_base_qs)
        alleles_set.update(length_alleles)
    alleles_set.add(reference)
    out = [reference] + sorted(a for a in alleles_set if a != reference)
    return out


def _hamming_consensus_str(mat: np.ndarray) -> str:
    counts = np.zeros((mat.shape[1], 5), dtype=np.int32)
    for c in range(5):
        counts[:, c] = (mat == c).sum(axis=0)
    return decode_dna(np.argmax(counts, axis=1).astype(np.int8))


def _split_by_variant_sites(
    calls: list[SpanningCall], consensus: str, max_base_qs: int
) -> set[str]:
    """Port of splitAllelesByVariantSites (:165-222)."""
    from ..kernels.genotyping import HET_RATE_DIPLOID, snv_contribution_table

    cons_codes = encode_dna(consensus)
    mat = np.stack([c.codes for c in calls])
    quals = np.stack([np.minimum(c.qualities, max_base_qs) for c in calls])
    n, m = mat.shape
    C = snv_contribution_table(4, 0.5)
    # all columns at once: logcond[i] = sum over valid rows of C[a, q]
    valid = (mat < 4) & (quals > MIN_BASE_QS)
    a_ = np.where(valid, mat, 0).astype(np.int64)
    q_ = np.minimum(np.where(valid, quals, 0), 30).astype(np.int64)
    contribs = C[a_, q_]  # (n, m, 4, 4)
    contribs[~valid] = 0.0
    logcond = contribs.sum(axis=0)  # (m, 4, 4)
    het_rate = HET_RATE_DIPLOID
    prior = np.where(
        np.eye(4, dtype=bool),
        np.log10((1 - het_rate) / 4),
        np.log10(het_rate / 12),
    )
    ev = logcond + prior[None]
    rel = ev - ev.reshape(m, -1).max(axis=1)[:, None, None]
    p = np.where(rel < -20, 0.0, 10.0 ** rel)
    post = p / p.reshape(m, -1).sum(axis=1)[:, None, None]
    cc_ = np.clip(cons_codes[:m], 0, 3).astype(np.int64)
    ar = np.arange(m)
    pair = post[ar, cc_, :] + post[ar, :, cc_]  # (m, 4): het vs base k
    pair[ar, cc_] = 0.0  # k == consensus excluded (best starts at 0)
    het_post = pair.max(axis=1)
    skip = (cons_codes[:m] >= 4) | np.all(mat == cons_codes[None, :m], axis=0)
    het_post[skip] = 0.0
    var_sites = np.nonzero(het_post >= MIN_HET_POSTERIOR)[0]
    if len(var_sites) == 0:
        return {consensus}
    # cluster by haplotype over variant sites, keep top haplotypes
    haps = [mat[r, var_sites].tobytes() for r in range(mat.shape[0])]
    from collections import Counter

    max_haps = 2 if len(var_sites) <= 3 else min(10, len(var_sites) // 2 + 1)
    top = [h for h, _ in Counter(haps).most_common(max_haps)]
    out: set[str] = set()
    for h in top:
        rows = [r for r in range(mat.shape[0]) if haps[r] == h]
        if rows:
            out.add(_hamming_consensus_str(mat[rows]))
    return out


def spanning_call_for(a, first: int, last: int) -> SpanningCall | None:
    """Spanning allele call of one alignment over [first,last], or None if
    the read does not reliably span it (soft-clip borders, realigner-trimmed
    ends — ref: ReadAlignment.getAlleleCall:1008-1016 ignore handling)."""
    from ..core.sequences import qualities_to_phred

    if a.first > first or a.last < last:
        return None
    rp_f = a.read_position_at(first)
    rp_l = a.read_position_at(last)
    if rp_f < 0 or rp_l < 0 or rp_l < rp_f:
        return None
    if a.soft_clip_start and rp_f <= a.soft_clip_start + 2:
        return None
    if a.soft_clip_end and rp_l >= len(a.read_chars) - a.soft_clip_end - 3:
        return None
    if rp_f < a.bases_to_ignore_start:
        return None
    if rp_l >= len(a.read_chars) - a.bases_to_ignore_end:
        return None
    codes = a.read_codes[rp_f : rp_l + 1]
    if not len(codes):
        return None
    if a.qualities:
        # full-read phred array cached on the alignment: alignments span
        # several sites each, and re-decoding a quality substring per
        # spanning call was a visible cost at ~80k calls/run
        qp = getattr(a, "_quals_phred", None)
        if qp is None or len(qp) != len(a.qualities):
            qp = qualities_to_phred(a.qualities)
            a._quals_phred = qp
        q = qp[rp_f : rp_l + 1]
    else:
        q = np.full(len(codes), 10, dtype=np.int8)
    return SpanningCall(
        codes=codes, qualities=q, negative_strand=a.is_negative_strand
    )


def genotype_indel_site(
    calls: list[SpanningCall],
    alleles: list[str],
    het_rate: float,
    max_base_qs: int = 30,
) -> tuple[int, int, int, int, IndelCountsHelper] | None:
    """Genotype one sample's calls against a fixed allele set.
    Returns (bi, bj, gq, variant_qs_phred, helper) or None if no calls."""
    helper = IndelCountsHelper(alleles, 0.5, max_base_qs)
    helper.update_batch(calls)
    if helper.total == 0:
        return None
    post = helper.posteriors(het_rate)
    n = len(alleles)
    bi = bj = 0
    best = post[0][0]
    for i in range(n):
        for j in range(i, n):
            prob = post[i][j] + (post[j][i] if i != j else 0.0)
            if prob > best + 0.01:
                best, bi, bj = prob, i, j
    gq = phred_score(max(0.0, 1.0 - best))
    return bi, bj, gq, phred_score(post[0][0]), helper


class IndelCountsHelper:
    """Port of the indel side of CountsHelper (updateCountsIndel)."""

    def __init__(self, alleles: list[str], het_proportion: float = 0.5, max_base_qs: int = 30):
        self.alleles = list(alleles)
        n = len(alleles)
        self.n = n
        self.counts = np.zeros(n, dtype=np.int64)
        self.strand_counts = np.zeros((n, 2), dtype=np.int64)
        self.logcond = np.zeros((n, n))
        self.total = 0
        self.max_base_qs = max_base_qs
        # ref: updateCountsIndel uses Math.round(het*DEF_NUM_FREQUENCIES)
        # (note: 501 not 500 here, mirroring the reference exactly; Java
        # Math.round is half-up, not banker's rounding)
        f = int(np.floor(het_proportion * NUM_FREQ + 0.5))
        af = f / (NUM_FREQ - 1)
        af = min(af, 1.0)
        self.log_af = float(np.log10(af)) if af > 0 else -np.inf
        self.log_1maf = float(np.log10(1 - af)) if af < 1 else -np.inf
        self._allele_codes = [encode_dna(a) for a in alleles]
        self._lengths = np.array([len(a) for a in alleles])

    def update_batch(self, calls: list[SpanningCall]) -> None:
        """Vectorized equivalent of sequential update() over all calls of
        one site: the per-base likelihood sums run as one numpy pass per
        allele-length group and the logcond accumulation collapses to
        per-allele reductions.  This is the entry both the classic and
        fused flows use (10k+ sites per bench run made per-call numpy the
        hottest indel-path cost)."""
        m = len(calls)
        if m == 0:
            return
        self.total += m
        n = self.n
        lca = np.full((m, n), LOG_ERROR_PROB_INDEL)
        by_len_calls: dict[int, list[int]] = {}
        for ci, c in enumerate(calls):
            by_len_calls.setdefault(len(c.codes), []).append(ci)
        by_len_alleles: dict[int, list[int]] = {}
        for ai, L in enumerate(self._lengths):
            by_len_alleles.setdefault(int(L), []).append(ai)
        for L, cidx in by_len_calls.items():
            aidx = by_len_alleles.get(L)
            if not aidx:
                continue
            cmat = np.stack([calls[ci].codes for ci in cidx])
            qmat = np.stack(
                [
                    np.minimum(calls[ci].qualities, self.max_base_qs)
                    for ci in cidx
                ]
            ).astype(np.int64)
            amat = np.stack([self._allele_codes[ai] for ai in aidx])
            ok = qmat >= MIN_BASE_QS  # (mc, L)
            # fused LUT gather == the inline where(ok, where(match,
            # log10(1-10^(-q/10)), -q/10-log10 3), 0) bit-for-bit
            sel = lik_sel_lut(self.max_base_qs)
            qsel = (qmat | (ok.astype(np.int64) << 6))[:, None, :]
            match = cmat[:, None, :] == amat[None, :, :]  # (mc, na, L)
            lc = sel[qsel | (match.astype(np.int64) << 5)].sum(axis=2)
            lc = np.maximum(LOG_ERROR_PROB_INDEL, lc)
            lca[np.asarray(cidx)[:, None], np.asarray(aidx)[None, :]] = lc
        # per-call assigned allele index (exact match reconciled with the
        # best-likelihood allele, mirroring sequential update)
        exact = {}
        for ai, ac in enumerate(self._allele_codes):
            exact.setdefault(ac.tobytes(), ai)
        above = lca > LOG_ERROR_PROB_INDEL
        best = np.where(above.any(axis=1), np.argmax(lca, axis=1), -1)
        index = np.empty(m, np.int64)
        for ci, c in enumerate(calls):
            ix = exact.get(c.codes.tobytes(), -1)
            b = int(best[ci])
            if ix >= 0 and b >= 0 and b != ix:
                ix = min(ix, b)
            elif ix < 0 and b >= 0:
                ix = b
            index[ci] = ix
        idxed = index >= 0
        if idxed.any():
            np.add.at(self.counts, index[idxed], 1)
            neg = np.array(
                [c.negative_strand for c in calls], dtype=bool
            )
            np.add.at(
                self.strand_counts,
                (index[idxed], np.where(neg[idxed], 0, 1)),
                1,
            )
        # logcond: diagonal += column sums of lca; off-diagonal (i, j):
        #   calls with k=j add logSum(af + lca[c,j], 1-af + ERR) -> S1[j]
        #   calls with k=i add logSum(1-af + lca[c,i], af + ERR) -> S2[i]
        #   all other calls (k not in {i, j}, incl. unassigned) add ERR
        diag = lca.sum(axis=0)
        S1 = np.zeros(n)
        S2 = np.zeros(n)
        cntk = np.zeros(n, np.int64)
        if idxed.any():
            ks = index[idxed]
            lk = lca[idxed, ks]
            s1 = _log10_sum_arr(self.log_af + lk, self.log_1maf + LOG_ERROR_PROB_INDEL)
            s2 = _log10_sum_arr(self.log_1maf + lk, self.log_af + LOG_ERROR_PROB_INDEL)
            np.add.at(S1, ks, s1)
            np.add.at(S2, ks, s2)
            np.add.at(cntk, ks, 1)
        off = (
            S1[None, :]
            + S2[:, None]
            + LOG_ERROR_PROB_INDEL * (m - cntk[:, None] - cntk[None, :])
        )
        upd = np.where(np.eye(n, dtype=bool), diag, off)
        self.logcond += upd

    def update(self, call: SpanningCall) -> None:
        self.total += 1
        call_codes = call.codes
        q = np.minimum(call.qualities, self.max_base_qs).astype(np.int64)
        ok = q >= MIN_BASE_QS  # ref calculateLogCond skips q<3
        n = self.n
        log_cond_alleles = np.full(n, LOG_ERROR_PROB_INDEL)
        key = call_codes.astype(np.int8).tobytes()
        index = -1
        for i, ac in enumerate(self._allele_codes):
            if ac.tobytes() == key:
                index = i
                break
        best_index = -1
        for i in range(n):
            if self._lengths[i] == len(call_codes):
                match = self._allele_codes[i] == call_codes
                # logProbCacheGT[0][q][0]=log10(1-e); error: -0.1q - log10(3)
                e = 10.0 ** (-0.1 * q)
                # log10 only where q >= MIN_BASE_QS: at q = 0, 1 - e is 0
                # and the masked-out lanes would take log10(0)
                log_ok = np.log10(1 - e, out=np.zeros(q.shape), where=ok)
                per_base = np.where(match, log_ok, -0.1 * q - np.log10(3))
                lc = float(np.sum(np.where(ok, per_base, 0.0)))
                lc = max(LOG_ERROR_PROB_INDEL, lc)
                log_cond_alleles[i] = lc
                if lc > LOG_ERROR_PROB_INDEL and (
                    best_index == -1 or log_cond_alleles[best_index] < lc
                ):
                    best_index = i
        if index >= 0 and best_index >= 0 and best_index != index:
            index = min(index, best_index)
        elif index < 0 and best_index >= 0:
            index = best_index
        if index >= 0:
            self.counts[index] += 1
            self.strand_counts[index][1 if not call.negative_strand else 0] += 1
        for i in range(n):
            self.logcond[i][i] += log_cond_alleles[i]
            for j in range(n):
                if i != j:
                    if j == index:
                        self.logcond[i][j] += log10_sum(
                            self.log_af + log_cond_alleles[index],
                            self.log_1maf + LOG_ERROR_PROB_INDEL,
                        )
                    elif i == index:
                        self.logcond[i][j] += log10_sum(
                            self.log_1maf + log_cond_alleles[index],
                            self.log_af + LOG_ERROR_PROB_INDEL,
                        )
                    else:
                        self.logcond[i][j] += LOG_ERROR_PROB_INDEL

    def posteriors(self, het_rate: float) -> np.ndarray:
        n = self.n
        if n == 1:
            return np.ones((1, 1))
        prior = np.where(
            np.eye(n, dtype=bool),
            np.log10((1 - het_rate) / n),
            np.log10(het_rate / (n * (n - 1))),
        )
        ev = self.logcond + prior
        rel = ev - ev.max()
        p = np.where(rel < -20, 0.0, 10.0 ** rel)
        return p / p.sum()


def call_indel(
    sequence_name: str,
    position: int,
    calls: list[SpanningCall],
    alleles: list[str],
    het_rate: float,
    is_str: bool = False,
    max_base_qs: int = 30,
) -> CalledGenomicVariant | None:
    """Port of VariantDiscoverySNVQAlgorithm.callIndel discovery mode."""
    helper = IndelCountsHelper(alleles, 0.5, max_base_qs)
    helper.update_batch(calls)
    if helper.total == 0:
        return None
    post = helper.posteriors(het_rate)
    n = len(alleles)
    # getIndexesMaxGenotype with default 0
    bi = bj = 0
    best = post[0][0]
    for i in range(n):
        for j in range(i, n):
            prob = post[i][j] + (post[j][i] if i != j else 0.0)
            if prob > best + 0.01:
                best, bi, bj = prob, i, j
    out_alleles = [alleles[0]]
    idxs = [0]
    length_change = False
    ref_len = len(alleles[0])
    if 0 < bi < n:
        out_alleles.append(alleles[bi])
        idxs.append(bi)
        if len(alleles[bi]) != ref_len:
            length_change = True
    if 0 < bj < n and bj != bi:
        out_alleles.append(alleles[bj])
        idxs.append(bj)
        if len(alleles[bj]) != ref_len:
            length_change = True
        if len(out_alleles) == 3 and len(alleles[bj]) != len(out_alleles[1]):
            length_change = True
    if not length_change and not is_str:
        return None
    if bi != bj:
        called = [1, 2] if len(out_alleles) == 3 else [0, 1]
    else:
        called = [0] if bi == 0 else [1]
    gq = phred_score(max(0.0, 1.0 - best))
    variant_qs = phred_score(post[0][0])
    return CalledGenomicVariant(
        sequence_name=sequence_name,
        first=position,
        alleles=out_alleles,
        variant_type=TYPE_STR if is_str else TYPE_INDEL,
        quality=variant_qs,
        indexes_called_alleles=called,
        genotype_quality=gq,
        total_read_depth=helper.total,
        allele_depths=[int(helper.counts[i]) for i in idxs],
    )
