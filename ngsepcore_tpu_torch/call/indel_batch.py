"""Batched indel-site genotyping: every conciliated site of a sequence in
one flat numpy pass.

Ref: the same semantics as call/indels.py (AlleleCallClustersBuilder.java:
41-270, CountsHelper.updateCountsIndel CountsHelper.java:253-304,
VariantDiscoverySNVQAlgorithm.callIndel :265-360) — the scalar path in
`SingleSampleVariantsDetector._call_indels` calls those per site.

TPU redesign note: indel sites are sparse (~1e-3 of positions) but a WGS
run still genotypes >10k of them; the per-site numpy of the scalar path
(tiny (calls x alleles x len) tensors, one Python iteration per site) was
~8s of a 35s bench run.  This module flattens ALL sites of a sequence into
pair tables — (site, spanning-call) rows, (site, allele) rows, and their
same-length join — so the per-base likelihood math, the per-call allele
assignment, the logcond accumulation, and the posterior/decision pass each
run as single vectorized operations over every site at once.  Sites that
need the haplotype-splitting allele discovery
(`indels._split_by_variant_sites`) or exceed the dense allele slots fall
back to the scalar path per site, keeping outputs byte-identical.
"""
from __future__ import annotations

import numpy as np

from ..core.sequences import decode_dna, encode_dna
from ..utils.profiling import stage
from ..math.phred import MAX_PHRED
from ..variants.model import CalledGenomicVariant, TYPE_INDEL, TYPE_STR
from ..vcf.io import VCFRecord
from .indels import (
    LOG_ERROR_PROB_INDEL,
    MIN_BASE_QS,
    MIN_RELATIVE_PROPORTION,
    NUM_FREQ,
    SpanningCall,
    _log10_sum_arr,
    _split_by_variant_sites,
    call_indel,
    cluster_allele_calls,
    lik_sel_lut,
)

A_MAX = 8  # dense allele slots per site (sites needing more -> scalar path)
LMAX_BAIL = 1024  # pair width beyond which the dense layout stops paying


def _phred_vec(p: np.ndarray) -> np.ndarray:
    """Vector mirror of math.phred.phred_score (round-half-even like
    Python's round; p<=0 -> 255, p>=1 -> 0)."""
    out = np.full(p.shape, MAX_PHRED, np.int64)
    pos = p > 0
    with np.errstate(divide="ignore"):
        sc = np.rint(-10.0 * np.log10(np.where(pos, p, 1.0)))
    out[pos] = np.minimum(sc[pos], MAX_PHRED).astype(np.int64)
    out[p >= 1] = 0
    return out


def _collect_host_pairs(sites_first, sites_last, table):
    """(site, alignment) spanning-call pairs from the columnar alignment
    table (call/aln_table.AlnTable) — the vectorized mirror of
    indels.spanning_call_for over every site at once."""
    A = table.n
    S = len(sites_first)
    empty = (
        np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.int64),
        np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.int8),
    )
    if A == 0 or S == 0:
        return empty
    firsts, lasts, lens = table.firsts, table.lasts, table.lens
    order = np.argsort(firsts, kind="stable")
    firsts_s = firsts[order]
    max_span = int((lasts - firsts).max() + 1)
    lo = np.searchsorted(firsts_s, sites_first - max_span, side="left")
    hi = np.searchsorted(firsts_s, sites_first, side="right")
    cnt = np.maximum(hi - lo, 0)
    tot = int(cnt.sum())
    if tot == 0:
        return empty
    ps = np.repeat(np.arange(S, dtype=np.int64), cnt)
    cum = np.zeros(S, np.int64)
    np.cumsum(cnt[:-1], out=cum[1:])
    k = np.arange(tot, dtype=np.int64) - cum[ps]
    pa = order[lo[ps] + k]

    f = sites_first[ps]
    l = sites_last[ps]
    keep = (lasts[pa] >= l) & (firsts[pa] <= f)
    ps, pa, f, l = ps[keep], pa[keep], f[keep], l[keep]

    rp_f = table.read_pos(pa, f)
    rp_l = table.read_pos(pa, l)
    scs, sce = table.scs, table.sce
    keep = (rp_f >= 0) & (rp_l >= 0) & (rp_l >= rp_f)
    keep &= ~((scs[pa] > 0) & (rp_f <= scs[pa] + 2))
    keep &= ~((sce[pa] > 0) & (rp_l >= lens[pa] - sce[pa] - 3))
    keep &= rp_f >= table.ig5[pa]
    keep &= rp_l < lens[pa] - table.ig3[pa]
    ps, pa, rp_f, rp_l = ps[keep], pa[keep], rp_f[keep], rp_l[keep]
    plen = rp_l - rp_f + 1
    src0 = table.off[pa] + rp_f
    return ps, src0, plen, firsts[pa], table.gorder[pa], table.neg[pa]


def _collect_array_pairs(sites_first, sites_last, arr, Lcap):
    """(site, array-read) spanning-call pairs from the gapless device-path
    registry (fused_pipeline._ArrayReads.spanning_calls, vectorized).
    Returns (site, sortkey_first, sortkey_gorder, neg, codes (P, Lcap),
    quals (P, Lcap), plen)."""
    S = len(sites_first)
    n_arr = len(arr)
    if n_arr == 0 or S == 0:
        z = np.empty(0, np.int64)
        return z, z, z, z.astype(np.int8), None, None, z
    lo = np.searchsorted(arr.first, sites_first - arr.max_span, side="left")
    hi = np.searchsorted(arr.first, sites_first, side="right")
    cnt = np.maximum(hi - lo, 0)
    tot = int(cnt.sum())
    if tot == 0:
        z = np.empty(0, np.int64)
        return z, z, z, z.astype(np.int8), None, None, z
    ps = np.repeat(np.arange(S, dtype=np.int64), cnt)
    cum = np.zeros(S, np.int64)
    np.cumsum(cnt[:-1], out=cum[1:])
    idx = lo[ps] + (np.arange(tot, dtype=np.int64) - cum[ps])
    f = sites_first[ps]
    l = sites_last[ps]
    af = arr.first[idx]
    al = arr.last[idx]
    cs = arr.cs[idx]
    ce = arr.ce[idx]
    n = arr.length[idx]
    keep = (al >= l) & (af <= f)
    rp_f = cs + (f - af)
    rp_l = cs + (l - af)
    keep &= ~((cs > 0) & (rp_f <= cs + 2))
    keep &= ~((ce > 0) & (rp_l >= n - ce - 3))
    # realigner end-trims, gathered per source batch
    ig5 = np.zeros(n_arr, np.int64)
    ig3 = np.zeros(n_arr, np.int64)
    bi_all = np.asarray(arr.bi)
    row_all = np.asarray(arr.row)
    for b in np.unique(bi_all):
        m = bi_all == b
        st = arr.batches[b]
        ig5[m] = st.ig5[row_all[m]]
        ig3[m] = st.ig3[row_all[m]]
    keep &= rp_f >= ig5[idx]
    keep &= rp_l < n - ig3[idx]
    ps, idx, rp_f, rp_l = ps[keep], idx[keep], rp_f[keep], rp_l[keep]
    n = arr.length[idx]
    rev = arr.strand[idx] == 1
    plen = rp_l - rp_f + 1
    P = len(ps)
    codes = np.zeros((P, Lcap), np.int8)
    quals = np.zeros((P, Lcap), np.int16)
    kk = np.arange(Lcap, dtype=np.int64)[None, :]
    fwd_i = rp_f[:, None] + kk
    rev_i = (n - 1 - rp_f)[:, None] - kk
    src = np.where(rev[:, None], rev_i, fwd_i)
    kmask = kk < plen[:, None]
    from ..core.sequences import ReadBlock

    for b in np.unique(bi_all[idx]) if P else []:
        m = bi_all[idx] == b
        st = arr.batches[b]
        mat = st.fwd_mat
        rows = row_all[idx[m]]
        sidx = np.clip(src[m], 0, mat.shape[1] - 1)
        g = mat[rows[:, None], sidx]
        rv = rev[m][:, None]
        codes[m] = np.where(rv & (g < 4), 3 - g, g)
        reads = st.reads
        if isinstance(reads, ReadBlock):
            if reads.quals is None:
                quals[m] = int(reads.default_quality)
            else:
                quals[m] = (
                    reads.quals[rows[:, None], sidx].astype(np.int16) - 33
                )
        else:
            # RawRead list: per-row quality bytes only for involved rows
            sub = np.nonzero(m)[0]
            for t in sub:
                r = reads[row_all[idx[t]]]
                if r.qualities:
                    qb = (
                        np.frombuffer(
                            r.qualities.encode("ascii"), np.uint8
                        ).astype(np.int16)
                        - 33
                    )
                    quals[t] = qb[np.clip(src[t], 0, len(qb) - 1)]
                else:
                    quals[t] = 20
    codes[~kmask] = 0
    quals[~kmask] = 0
    return (
        ps, arr.first[idx], arr.gorder[idx],
        rev.astype(np.int8), codes, quals, plen,
    )


def call_indels_batched(
    det,
    seq_idx: int,
    seq_name: str,
    alns,
    sites,
    gorder=None,
    array_reads=None,
    table=None,
) -> list[VCFRecord]:
    """Drop-in replacement for the per-site loop in
    SingleSampleVariantsDetector._call_indels: same records, one pass.
    `table` optionally reuses a prebuilt AlnTable (the fused pipeline
    shares one with the base-call expansion)."""
    if not sites:
        return []
    genome = det.genome
    seq_len = genome.sequence_length(seq_idx)
    S = len(sites)
    site_first = np.fromiter((s[0] for s in sites), np.int64, S)
    site_span = np.fromiter((s[1] for s in sites), np.int64, S)
    site_str = np.fromiter((s[2] for s in sites), bool, S)
    site_last = site_first + site_span - 1
    if table is None:
        from .aln_table import AlnTable

        table = AlnTable(alns, gorder)

    # ---- phase 1: collect spanning-call pairs ---------------------------
    with stage("indel.p1_collect"):
        hps, hsrc0, hplen, hfirst, hgord, hneg = _collect_host_pairs(
            site_first, site_last, table
        )
        codes_flat, qflat = table.codes_flat, table.qflat
        # width cap: the widest host pair bounds the dense layout
        Lmax_h = int(hplen.max()) if len(hplen) else 1
        arr_pairs = None
        Lmax_a = 1
        if array_reads is not None and len(array_reads):
            # array reads are gapless: call length == site span <= max_span
            Lmax_a = int(min(site_span.max(), array_reads.max_span))
        # allele rows include the reference (length == site span), so the
        # dense width must cover the widest site span too
        Lmax = max(Lmax_h, Lmax_a, int(site_span.max()), 1)
        if Lmax > LMAX_BAIL:
            return _scalar_all(det, seq_idx, seq_name, alns, sites, gorder,
                               array_reads)
        if array_reads is not None and len(array_reads):
            arr_pairs = _collect_array_pairs(
                site_first, site_last, array_reads, Lmax
            )

        # host pair codes/quals into the dense pad
        Ph = len(hps)
        Pa = len(arr_pairs[0]) if arr_pairs is not None else 0
        P = Ph + Pa
        if P == 0:
            return []
        codes_pad = np.zeros((P, Lmax), np.int8)
        quals_pad = np.zeros((P, Lmax), np.int16)
        kk = np.arange(Lmax, dtype=np.int64)[None, :]
        if Ph:
            srci = np.clip(hsrc0[:, None] + kk, 0, max(len(codes_flat) - 1, 0))
            kmask_h = kk < hplen[:, None]
            codes_pad[:Ph] = np.where(kmask_h, codes_flat[srci], 0)
            quals_pad[:Ph] = np.where(kmask_h, qflat[srci], 0)
        if Pa:
            codes_pad[Ph:] = arr_pairs[4][:, :Lmax]
            quals_pad[Ph:] = arr_pairs[5][:, :Lmax]
        ps = np.concatenate([hps, arr_pairs[0]]) if Pa else hps
        plen = np.concatenate([hplen, arr_pairs[6]]) if Pa else hplen
        sk_first = np.concatenate([hfirst, arr_pairs[1]]) if Pa else hfirst
        sk_gord = np.concatenate([hgord, arr_pairs[2]]) if Pa else hgord
        negp = np.concatenate([hneg, arr_pairs[3]]) if Pa else hneg
        # scalar call order — (site, first, gorder) — so every sequential
        # accumulation below adds the same values in the same order as the
        # per-site loop (differences would only be float-noise, but
        # determinism is free here)
        po = np.lexsort((sk_gord, sk_first, ps))
        ps, plen, sk_first, sk_gord, negp = (
            ps[po], plen[po], sk_first[po], sk_gord[po], negp[po]
        )
        codes_pad = codes_pad[po]
        quals_pad = quals_pad[po]

        m_s = np.bincount(ps, minlength=S)

    # ---- phase 2: per-site allele discovery -----------------------------
    with stage("indel.p2_alleles"):
        max_bq = 30
        # group pairs by (site, length)
        Lbig = Lmax + 2
        gkey = ps * Lbig + plen
        uk, g_of_pair, g_count = np.unique(
            gkey, return_inverse=True, return_counts=True
        )
        g_site = uk // Lbig
        g_len = uk % Lbig
        nlen_s = np.bincount(g_site, minlength=S)
        # severe-imbalance filter only when a site has >= 3 length groups
        g_kept = np.ones(len(uk), bool)
        many = nlen_s[g_site] >= 3
        g_kept[many] = (
            g_count[many] >= MIN_RELATIVE_PROPORTION * m_s[g_site[many]]
        )
        is_ref_len = g_len == site_span[g_site]
        # branch1: ref-length group with < 5 calls contributes only {reference}
        consensus_g = g_kept & ~(is_ref_len & (g_count < 5))
        split_g = consensus_g & (g_len >= 4) & (g_count >= 10)
        cons_only_g = consensus_g  # consensus needed for split path too

        with stage("indel.p2a_consensus"):
            cons_ids = np.nonzero(cons_only_g)[0]
            cons_local = np.full(len(uk), -1, np.int64)
            cons_local[cons_ids] = np.arange(len(cons_ids))
            Gn = len(cons_ids)
            consensus_codes = None
            if Gn:
                counts5 = np.zeros((Gn, Lmax, 5), np.int32)
                pin = cons_local[g_of_pair] >= 0
                pg = cons_local[g_of_pair[pin]]
                cpad = codes_pad[pin]
                kmask = kk < plen[pin][:, None]
                gb = np.broadcast_to(pg[:, None], cpad.shape)[kmask]
                kb = np.broadcast_to(kk, cpad.shape)[kmask]
                cb = np.clip(cpad[kmask], 0, 4)
                np.add.at(counts5, (gb, kb, cb), 1)
                consensus_codes = np.argmax(counts5, axis=2).astype(np.int8)

        with stage("indel.p2b_strings"):
            # reference string per site
            ref_codes_seq = genome.sequences[seq_idx].codes
            # per-site allele string lists (reference first)
            ref_strs = [
                decode_dna(ref_codes_seq[int(f) - 1 : int(lst)])
                for f, lst in zip(site_first, site_last)
            ]
            contrib: list[list[str]] = [[] for _ in range(S)]
            # consensus contributions (branch2); split groups go scalar below
            if Gn:
                dec_flat = decode_dna(
                    np.concatenate(
                        [
                            consensus_codes[i, : int(g_len[g])]
                            for i, g in enumerate(cons_ids)
                        ]
                    )
                    if Gn
                    else np.empty(0, np.int8)
                )
                o = 0
                for i, g in enumerate(cons_ids):
                    L = int(g_len[g])
                    s_ = int(g_site[g])
                    cstr = dec_flat[o : o + L]
                    o += L
                    if split_g[g]:
                        continue  # handled by the scalar split below
                    contrib[s_].append(cstr)
        with stage("indel.p2c_splits"):
            # scalar fallback for haplotype-splitting groups; one argsort gives
            # every group's row slice (903 per-group nonzero scans of the full
            # pair table were the phase-2 hot spot)
            split_ids = np.nonzero(split_g)[0]
            if len(split_ids):
                p_order = np.argsort(g_of_pair, kind="stable")
                g_sorted = g_of_pair[p_order]
                g_lo = np.searchsorted(g_sorted, split_ids, side="left")
                g_hi = np.searchsorted(g_sorted, split_ids, side="right")
            for i, g in enumerate(split_ids):
                s_ = int(g_site[g])
                rows = p_order[g_lo[i] : g_hi[i]]
                o2 = np.lexsort((sk_gord[rows], sk_first[rows]))
                calls_l = [
                    SpanningCall(
                        codes=codes_pad[r, : int(plen[r])].copy(),
                        qualities=quals_pad[r, : int(plen[r])].astype(np.int16),
                        negative_strand=bool(negp[r]),
                    )
                    for r in rows[o2]
                ]
                li = cons_local[g]
                cstr = decode_dna(consensus_codes[li, : int(g_len[g])])
                contrib[s_].extend(
                    sorted(_split_by_variant_sites(calls_l, cstr, max_bq))
                )

        with stage("indel.p2d_tables"):
            # assemble per-site allele lists: [ref] + sorted(others)
            allele_strs: list[list[str]] = []
            scalar_sites: list[int] = []
            for s_ in range(S):
                ref = ref_strs[s_]
                others = sorted(set(contrib[s_]) - {ref})
                al = [ref] + others
                if len(al) > A_MAX:
                    scalar_sites.append(s_)
                allele_strs.append(al)
            scalar_set = set(scalar_sites)

            # dense allele tables
            a_site_l, a_local_l, a_len_l, a_str_l = [], [], [], []
            for s_ in range(S):
                if s_ in scalar_set:
                    continue
                for j, astr in enumerate(allele_strs[s_]):
                    a_site_l.append(s_)
                    a_local_l.append(j)
                    a_len_l.append(len(astr))
                    a_str_l.append(astr)
            T = len(a_site_l)
            a_site = np.asarray(a_site_l, np.int64)
            a_local = np.asarray(a_local_l, np.int64)
            a_len = np.asarray(a_len_l, np.int64)
            n_s = np.bincount(a_site, minlength=S)
            a_codes = np.zeros((T, Lmax), np.int8)
            if T:
                enc = encode_dna("".join(a_str_l))
                o = 0
                for t in range(T):
                    L = int(a_len[t])
                    a_codes[t, :L] = enc[o : o + L]
                    o += L

    # ---- phase 3: likelihoods + assignment + logcond --------------------
    with stage("indel.p3_lik"):
        ERR = LOG_ERROR_PROB_INDEL
        q8 = np.minimum(quals_pad, max_bq).astype(np.int16)
        okq = (q8 >= MIN_BASE_QS) & (kk < plen[:, None])
        # per-pair LUT index halves (match bit added per join row below); the
        # fused gather is bit-identical to the former inline pow/log10 pass
        sel_lut = lik_sel_lut(max_bq)
        qsel = q8 | (okq.astype(np.int16) << 6)

        # same-length (pair x allele) join via sorted allele keys
        a_key = a_site * Lbig + a_len
        a_order = np.argsort(a_key, kind="stable")
        a_key_s = a_key[a_order]
        jlo = np.searchsorted(a_key_s, gkey, side="left")
        jhi = np.searchsorted(a_key_s, gkey, side="right")
        jcnt = jhi - jlo
        J = int(jcnt.sum())
        lca = np.full((P, A_MAX), ERR)
        exact_ix = np.full(P, -1, np.int64)
        if J:
            jp = np.repeat(np.arange(P, dtype=np.int64), jcnt)
            cum = np.zeros(P, np.int64)
            np.cumsum(jcnt[:-1], out=cum[1:])
            ja = a_order[jlo[jp] + (np.arange(J, dtype=np.int64) - cum[jp])]
            # chunk so the (rows x Lmax) float64 intermediate stays cache-sized
            CH = max(4096, (1 << 21) // max(int(Lmax), 1))
            for c0 in range(0, J, CH):
                c1 = min(J, c0 + CH)
                jpc = jp[c0:c1]
                jac = ja[c0:c1]
                match = codes_pad[jpc] == a_codes[jac]
                lc = sel_lut[
                    qsel[jpc] | (match.astype(np.int16) << 5)
                ].sum(axis=1)
                np.maximum(lc, ERR, out=lc)
                lca[jpc, a_local[jac]] = lc
                km = kk < plen[jpc][:, None]
                ex = (match | ~km).all(axis=1)
                exact_ix[jpc[ex]] = a_local[jac[ex]]

        above = lca > ERR
        has = above.any(axis=1)
        best = np.where(has, np.argmax(lca, axis=1), -1)
        ix = exact_ix.copy()
        both = (ix >= 0) & (best >= 0) & (best != ix)
        ix[both] = np.minimum(ix, best)[both]
        only_b = (exact_ix < 0) & (best >= 0)
        ix[only_b] = best[only_b]

        counts = np.zeros((S, A_MAX), np.int64)
        strand_counts = np.zeros((S, A_MAX, 2), np.int64)
        asg = ix >= 0
        np.add.at(counts, (ps[asg], ix[asg]), 1)
        np.add.at(
            strand_counts,
            (ps[asg], ix[asg], np.where(negp[asg] == 1, 0, 1)),
            1,
        )

        diag = np.zeros((S, A_MAX))
        np.add.at(diag, ps, lca)
        # af mirror of IndelCountsHelper.__init__ (het_proportion = 0.5)
        f_ = int(np.floor(0.5 * NUM_FREQ + 0.5))
        af = min(f_ / (NUM_FREQ - 1), 1.0)
        log_af = float(np.log10(af))
        log_1maf = float(np.log10(1 - af))
        lk = lca[np.arange(P), np.maximum(ix, 0)]
        s1 = _log10_sum_arr(log_af + lk, log_1maf + ERR)
        s2 = _log10_sum_arr(log_1maf + lk, log_af + ERR)
        S1 = np.zeros((S, A_MAX))
        S2 = np.zeros((S, A_MAX))
        cntk = np.zeros((S, A_MAX), np.int64)
        np.add.at(S1, (ps[asg], ix[asg]), s1[asg])
        np.add.at(S2, (ps[asg], ix[asg]), s2[asg])
        np.add.at(cntk, (ps[asg], ix[asg]), 1)
        off = (
            S1[:, None, :]
            + S2[:, :, None]
            + ERR * (m_s[:, None, None] - cntk[:, :, None] - cntk[:, None, :])
        )
        eye = np.eye(A_MAX, dtype=bool)
        logcond = off
        logcond[:, eye] = diag

    # ---- phase 4: posteriors + decision ---------------------------------
    with stage("indel.p4_post"):
        ns = np.maximum(n_s, 1)
        het = det.heterozygosity_rate
        with np.errstate(divide="ignore", invalid="ignore"):
            prior_d = np.log10((1 - het) / ns)
            prior_o = np.where(
                ns > 1, np.log10(het / np.maximum(ns * (ns - 1), 1)), 0.0
            )
        prior = np.where(eye[None], prior_d[:, None, None], prior_o[:, None, None])
        valid = (np.arange(A_MAX)[None, :] < n_s[:, None])
        vpair = valid[:, :, None] & valid[:, None, :]
        ev = np.where(vpair, logcond + prior, -np.inf)
        evmax = ev.reshape(S, -1).max(axis=1)[:, None, None]
        rel = ev - evmax
        with np.errstate(invalid="ignore"):
            p = np.where(rel < -20.0, 0.0, 10.0 ** rel)
        p = np.where(vpair, p, 0.0)
        psum = p.reshape(S, -1).sum(axis=1)
        psum = np.where(psum > 0, psum, 1.0)
        post = p / psum[:, None, None]
        one_site = n_s == 1
        post[one_site, 0, 0] = 1.0

        bestp = post[:, 0, 0].copy()
        bi = np.zeros(S, np.int64)
        bj = np.zeros(S, np.int64)
        for i in range(A_MAX):
            for j in range(i, A_MAX):
                pv = post[:, i, j] + (post[:, j, i] if i != j else 0.0)
                upd = (j < n_s) & (pv > bestp + 0.01)
                bestp = np.where(upd, pv, bestp)
                bi = np.where(upd, i, bi)
                bj = np.where(upd, j, bj)
        gq = _phred_vec(np.maximum(0.0, 1.0 - bestp))
        vqs = _phred_vec(post[:, 0, 0])

    # ---- phase 5: records in site order (lastIndelEnd walk) -------------
    with stage("indel.p5_records"):
        records: list[VCFRecord] = []
        last_indel_end = 0
        min_q = det.min_quality
        for s_ in range(S):
            first = int(site_first[s_])
            span = int(site_span[s_])
            if first < 1 or first + span - 1 > seq_len or first <= last_indel_end:
                continue
            if s_ in scalar_set:
                rec = _scalar_site(
                    det, seq_name, s_, first, bool(site_str[s_]), ref_strs[s_],
                    ps, codes_pad, quals_pad, plen, negp, sk_first, sk_gord,
                )
                if rec is not None:
                    rec.variant.sample_id = det.sample_id
                    rec.variant.copy_number = det.ploidy
                    last_indel_end = rec.variant.last
                    records.append(rec)
                continue
            if m_s[s_] == 0:
                continue
            n = int(n_s[s_])
            bi_, bj_ = int(bi[s_]), int(bj[s_])
            alleles = allele_strs[s_]
            out_alleles = [alleles[0]]
            idxs = [0]
            length_change = False
            ref_len = len(alleles[0])
            if 0 < bi_ < n:
                out_alleles.append(alleles[bi_])
                idxs.append(bi_)
                if len(alleles[bi_]) != ref_len:
                    length_change = True
            if 0 < bj_ < n and bj_ != bi_:
                out_alleles.append(alleles[bj_])
                idxs.append(bj_)
                if len(alleles[bj_]) != ref_len:
                    length_change = True
                if len(out_alleles) == 3 and len(alleles[bj_]) != len(out_alleles[1]):
                    length_change = True
            if not length_change and not site_str[s_]:
                continue
            if bi_ != bj_:
                called = [1, 2] if len(out_alleles) == 3 else [0, 1]
            else:
                called = [0] if bi_ == 0 else [1]
            gq_ = int(gq[s_])
            cal = CalledGenomicVariant(
                sequence_name=seq_name,
                first=first,
                alleles=out_alleles,
                variant_type=TYPE_STR if site_str[s_] else TYPE_INDEL,
                quality=int(vqs[s_]),
                indexes_called_alleles=called,
                genotype_quality=gq_,
                total_read_depth=int(m_s[s_]),
                allele_depths=[int(counts[s_, i]) for i in idxs],
            )
            if (
                cal.is_undecided
                or cal.is_homozygous_reference
                or gq_ < min_q
            ):
                continue
            cal.sample_id = det.sample_id
            cal.copy_number = det.ploidy
            last_indel_end = cal.last
            records.append(VCFRecord(variant=cal, calls=[cal]))
    return records


def _scalar_site(
    det, seq_name, s_, first, is_str, reference,
    ps, codes_pad, quals_pad, plen, negp, sk_first, sk_gord,
):
    """Full scalar path for one site (rare: > A_MAX alleles)."""
    rows = np.nonzero(ps == s_)[0]
    if not len(rows):
        return None
    o = np.lexsort((sk_gord[rows], sk_first[rows]))
    calls = [
        SpanningCall(
            codes=codes_pad[r, : int(plen[r])].copy(),
            qualities=quals_pad[r, : int(plen[r])].astype(np.int16),
            negative_strand=bool(negp[r]),
        )
        for r in rows[o]
    ]
    alleles = cluster_allele_calls(calls, reference)
    cal = call_indel(
        seq_name, first, calls, alleles, det.heterozygosity_rate,
        is_str=is_str,
    )
    if (
        cal is None
        or cal.is_undecided
        or cal.is_homozygous_reference
        or cal.genotype_quality < det.min_quality
    ):
        return None
    return VCFRecord(variant=cal, calls=[cal])


def _scalar_all(det, seq_idx, seq_name, alns, sites, gorder, array_reads):
    """Bail-out: width beyond the dense layout — the scalar per-site loop."""
    from .single_sample import SingleSampleVariantsDetector  # noqa: F401

    return det._call_indels_scalar(
        seq_idx, seq_name, alns, sites, gorder=gorder, array_reads=array_reads
    )
