"""Fused on-device seeding: canonical minimizers -> table lookup ->
strand-aware diagonal clustering -> tier-1 ungapped screen, per read batch.

Ref: the short-read seeding stack
 - ShortKmerCodesTable.matchCompressed (ShortKmerCodesTable.java:344-420)
 - UngappedSearchHitsClusterBuilder.clusterRegionKmerAlns
   (UngappedSearchHitsClusterBuilder.java:43-375)
 - ShortReadsUngappedSearchHitsClusterAligner.countMismatches
   (ShortReadsUngappedSearchHitsClusterAligner.java:157-192)

Design (same as ngsepcore_tpu/kernels/seeding.py): k-mer codes are
canonical, so one forward-strand pass finds matches on both genome
strands; lookup is one bucket-row gather of the bucketized table
(index/minimizer_table.py), or a search of the sorted-key table's lookup
hashes, with an exact (hi, lo) compare; diagonal
clustering is two per-row sorts plus segmented cumsum statistics; the
tier-1 screen compares 16-base bit-packed words.

uint32 words live in int64 tensors and are masked to 32 bits after every
left shift.  The multi-key sorts pack their keys into one int64 so a
single stable torch.sort gives jax.lax.sort's lexicographic order.
"""
from __future__ import annotations

import torch

from .kmers import kmer_codes_canonical_2x32
from .minimizers import lookup_hash32, minimizer_hash30, select_minimizers
from .tier1 import tier1_stats_from_mask

BIG32 = 1 << 30
# entry-row width of the bucketized table layout (index/minimizer_table.py
# builds one aligned (U, SEED_HITS_PER_KMER) row per code)
SEED_HITS_PER_KMER = 4
_M32 = 0xFFFFFFFF


def pack_codes_words(codes: torch.Tensor):
    """(R, L) int8 codes -> (packed, n2) (R, L//16) words (uint32 values in
    int64): base j of word w at bit 2*j, non-ACGT flagged at the same bit
    of n2.  L must be a multiple of 16."""
    R, L = codes.shape
    W = L // 16
    c = codes.to(torch.int64).reshape(R, W, 16)
    sh = 2 * torch.arange(16, dtype=torch.int64, device=codes.device)
    base = torch.where(c < 4, c, 0)
    # the 2-bit fields are disjoint, so the sum is the bitwise or
    packed = (base << sh).sum(dim=2)
    n2 = ((c >= 4).to(torch.int64) << sh).sum(dim=2)
    return packed, n2


def _bitrev_groups(x: torch.Tensor) -> torch.Tensor:
    """Reverse the sixteen 2-bit groups within each 32-bit word."""
    m2, m4, m8 = 0x33333333, 0x0F0F0F0F, 0x00FF00FF
    x = ((x & m2) << 2) | ((x >> 2) & m2)
    x = ((x & m4) << 4) | ((x >> 4) & m4)
    x = ((x & m8) << 8) | ((x >> 8) & m8)
    return ((x << 16) & _M32) | (x >> 16)


def reverse_packed_rows(packed, n2, lengths, const_len: int | None = None):
    """Reverse(-complement) packed read rows entirely in the packed bit
    domain: group-reversal within words + word flip reverses the padded row;
    a per-row left shift of (L - qlen) bases re-aligns the read to offset 0;
    complement is a plain XOR (N positions stay flagged in n2).

    const_len: when every row has this length the realigning shift is
    static."""
    R, W = packed.shape
    L = W * 16
    pr = torch.flip(_bitrev_groups(packed), dims=[1]) ^ _M32
    nr = torch.flip(_bitrev_groups(n2), dims=[1])

    if const_len is not None:
        s = L - const_len
        wsh, ob = s >> 4, 2 * (s & 15)

        def shift_static(x):
            if wsh:
                x = torch.cat([x[:, wsh:], torch.zeros_like(x[:, :wsh])], dim=1)
            if ob:
                hi = torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1)
                x = (x >> ob) | ((hi << (32 - ob)) & _M32)
            return x

        return shift_static(pr), shift_static(nr)

    s = (L - lengths).to(torch.int64)  # bases to shift out
    wsh = (s >> 4)[:, None]
    o = (2 * (s & 15))[:, None]
    t = torch.arange(W, dtype=torch.int64, device=packed.device)[None, :]
    idx0 = torch.clamp(t + wsh, 0, W - 1)
    idx1 = torch.clamp(t + wsh + 1, 0, W - 1)
    in1 = (t + wsh + 1) < W

    def shift(x):
        w0 = x.gather(1, idx0)
        w1 = torch.where(in1, x.gather(1, idx1), 0)
        return torch.where(o == 0, w0, (w0 >> o) | ((w1 << (32 - o)) & _M32))

    return shift(pr), shift(nr)


def gather_aligned_words(packed: torch.Tensor, start: torch.Tensor, n_words: int):
    """Gather `n_words` 16-base words beginning at arbitrary base offset
    `start` (any shape, may be negative) from a packed genome, realigned
    in the packed domain.  Out-of-range words clamp; callers mask
    out-of-genome positions separately."""
    Wg = packed.shape[0]
    start = start.to(torch.int64)
    base_w = start >> 4  # arithmetic shift: floor division, negatives ok
    o = start & 15
    t = torch.arange(n_words + 1, dtype=torch.int64, device=packed.device)
    idx = torch.clamp(base_w[..., None] + t, 0, Wg - 1)
    words = packed[idx]  # (..., n_words+1)
    sh = (2 * o)[..., None]
    w0 = words[..., :-1]
    w1 = words[..., 1:]
    combined = (w0 >> sh) | ((w1 << (32 - sh)) & _M32)
    return torch.where(sh == 0, w0, combined)


def seed_cluster_screen(
    codes: torch.Tensor,  # (B, L) int8 forward-strand read codes, OR uint8
    # packed (code | clamped_qual << 3) bytes (quality bits masked off here)
    lengths: torch.Tensor,  # (B,) int32
    table,  # MinimizerTable.device_arrays: (NB, 4W + W*KH) int32 bucket
    # rows, or a SortedKeyTable (keys, ver_hi, ver_lo, row_offsets, entries)
    packed_genome: torch.Tensor,  # (Wg,) 16-base packed genome words
    genome_n2: torch.Tensor,  # (Wg,) per-base non-ACGT flags (bit 2j)
    *,
    k: int,
    window: int,
    genome_len: int,
    max_minimizers: int = 16,
    hits_per_kmer: int = 4,
    max_clusters: int = 4,
    const_len: int | None = None,  # uniform read length (static shift)
    genome_has_n: bool = True,  # False skips the n2 word gather entirely
):
    """Seed, cluster and tier-1 screen one read batch.  Returns a dict of
    (B, C) int32 tensors: pred_start (concat coords, BIG32 = none), weight,
    strand, num_hits, mismatches, clip_start, clip_end."""
    if codes.dtype == torch.uint8:
        codes = (codes & 7).to(torch.int8)
    B, L = codes.shape
    dev = codes.device
    M, K, C = max_minimizers, hits_per_kmer, max_clusters
    H = M * K
    lengths = lengths.to(torch.int32)

    # ---- stage 1: canonical minimizer selection --------------------------
    khi, klo, kflag, valid = kmer_codes_canonical_2x32(codes, lengths, k)
    sel = select_minimizers(minimizer_hash30(khi, klo), valid, window)
    # compact selected positions to M slots (position order preserved)
    rank = torch.cumsum(sel.to(torch.int32), dim=1, dtype=torch.int32) - 1
    seli = torch.stack(
        [
            torch.argmax((sel & (rank == s)).to(torch.int8), dim=1)
            for s in range(M)
        ],
        dim=1,
    )  # (B, M) int64
    # slots past the selected count point at argmax's fallback index 0
    n_sel = 1 + torch.amax(torch.where(sel, rank, -1), dim=1)
    msel = sel.gather(1, seli) & (
        torch.arange(M, device=dev)[None, :] < n_sel[:, None]
    )
    mhi = khi.gather(1, seli)
    mlo = klo.gather(1, seli)
    mflag = kflag.gather(1, seli)
    mpos = seli.to(torch.int32)

    # ---- stage 2: table lookup -------------------------------------------
    KH = SEED_HITS_PER_KMER
    assert K <= KH, f"hits-per-kmer K={K} exceeds inline slots {KH}"
    qhash = lookup_hash32(mhi, mlo)
    kk = torch.arange(K, dtype=torch.int32, device=dev)[None, None, :]
    if isinstance(table, torch.Tensor):
        # bucket rows: ONE row gather of a combined [hi | lo | code-row |
        # cnt | entries] bucket row, exact (hi, lo) compare, then the
        # matching slot's entry block selected with the same match mask
        NB = table.shape[0]
        W = table.shape[1] // (4 + KH)
        rows = table[qhash & (NB - 1)]  # (B, M, 4W + W*KH)
        match = (rows[..., :W] == mhi[..., None]) & (
            rows[..., W : 2 * W] == mlo[..., None]
        )
        found = msel & match.any(dim=-1)
        mi = match.to(torch.int32)
        cnt = torch.where(
            found, (rows[..., 3 * W : 4 * W] * mi).sum(dim=-1, dtype=torch.int32), 0
        )
        cnt = torch.clamp(cnt, max=K)
        hit_valid = kk < cnt[..., None]
        ent = rows[..., 4 * W :].reshape(B, M, W, KH)
        entry = (ent[..., :K] * mi[..., None]).sum(dim=-2, dtype=torch.int32)
        entry = torch.where(hit_valid, entry, 0)
    else:
        # sorted keys: the first key >= the query hash; the (hi, lo)
        # compare alone decides membership (an absent hash lands on another
        # code's row, or is clipped onto the last one)
        keys, ver_hi, ver_lo, row_offsets, entry_packed = table
        U = keys.shape[0]
        if U == 0:
            hit_valid = torch.zeros((B, M, K), dtype=torch.bool, device=dev)
            entry = torch.zeros((B, M, K), dtype=torch.int32, device=dev)
        else:
            r = torch.clamp(torch.searchsorted(keys, qhash), max=U - 1)
            found = msel & (ver_hi[r] == mhi) & (ver_lo[r] == mlo)
            start = torch.where(found, row_offsets[r], 0)
            cnt = torch.where(found, row_offsets[r + 1] - row_offsets[r], 0)
            cnt = torch.clamp(cnt, max=K)
            hit_valid = kk < cnt[..., None]
            eidx = torch.where(hit_valid, start[..., None] + kk, 0)
            entry = torch.where(hit_valid, entry_packed[eidx], 0)
    spos = entry & 0x7FFFFFFF
    sflag = (entry >> 31) & 1
    # match strand = query canonical flag XOR entry canonical flag; on the
    # reverse strand the read coordinate of the anchor is qlen - k - qpos
    mstr = mflag[..., None] ^ sflag
    qpos_f = mpos[..., None].expand(B, M, K)
    qpos_eff = torch.where(
        mstr == 0, qpos_f, lengths[:, None, None] - k - qpos_f
    )
    est = torch.where(hit_valid, spos - qpos_eff, BIG32)  # diagonal start
    strand_h = torch.where(hit_valid, mstr, 2)  # invalid sorts last

    est = est.reshape(B, H)
    qpos = qpos_eff.reshape(B, H)
    strand_h = strand_h.reshape(B, H)

    # ---- stage 3: per-strand diagonal clustering -------------------------
    # sort hits by (strand, est, qpos); clusters become contiguous runs.
    # Valid hits have qpos in [0, L-k]; invalid ones (strand 2) only need
    # to sort last, so their qpos is clamped into the key's 16-bit field
    key1 = (
        (strand_h.to(torch.int64) << 50)
        | ((est.to(torch.int64) + (1 << 31)) << 16)
        | torch.clamp(qpos, 0, 0xFFFF).to(torch.int64)
    )
    o1 = torch.sort(key1, dim=1, stable=True).indices
    str_s = strand_h.gather(1, o1)
    est_s = est.gather(1, o1)
    qpos_s = qpos.gather(1, o1)
    valid_s = str_s < 2
    tol = torch.clamp(lengths // 10, min=10)[:, None]
    first_col = lambda v: torch.full((B, 1), v, dtype=torch.int32, device=dev)
    prev = torch.cat([first_col(-(1 << 30)), est_s[:, :-1]], dim=1)
    prev_str = torch.cat([first_col(-1), str_s[:, :-1]], dim=1)
    brk = ((est_s - prev) > tol) | (str_s != prev_str)
    cid = torch.cumsum(brk.to(torch.int32), dim=1, dtype=torch.int32) - 1
    cid = torch.clamp(cid, 0, H - 1)
    # re-sort by (cluster, query pos): runs stay contiguous, and the first
    # element of each run is the cluster's earliest query anchor
    key2 = torch.where(valid_s, cid * 65536 + qpos_s, BIG32)
    o2 = torch.sort(
        (key2.to(torch.int64) << 32) | (est_s.to(torch.int64) + (1 << 31)),
        dim=1,
        stable=True,
    ).indices
    key2_s = key2.gather(1, o2)
    est2 = est_s.gather(1, o2)
    str2 = str_s.gather(1, o2)
    valid2 = key2_s < BIG32
    prev2 = torch.cat([first_col(-1), key2_s[:, :-1]], dim=1)
    distinct = (key2_s != prev2) & valid2  # first of each (cluster, qpos)
    dcid = key2_s >> 16
    prev_dcid = torch.cat([first_col(-1), dcid[:, :-1]], dim=1)
    run_start = (dcid != prev_dcid) & valid2
    pos_idx = torch.arange(H, dtype=torch.int32, device=dev)[None, :].expand(B, H)
    start_idx = torch.cummax(torch.where(run_start, pos_idx, 0), dim=1).values
    next_start = torch.cat(
        [run_start[:, 1:], torch.ones((B, 1), dtype=torch.bool, device=dev)], dim=1
    )
    is_end = valid2 & (
        next_start
        | ~torch.cat(
            [valid2[:, 1:], torch.zeros((B, 1), dtype=torch.bool, device=dev)],
            dim=1,
        )
    )
    # segmented sums over contiguous runs via cumsum differences
    di = distinct.to(torch.int32)
    cs = torch.cumsum(di, dim=1, dtype=torch.int32)
    cs_excl_at_start = torch.cummax(
        torch.where(run_start, cs - di, -1), dim=1
    ).values
    seg_weight = cs - cs_excl_at_start
    weights_slot = torch.where(is_end, seg_weight, 0)  # distinct qpos/cluster
    nh_slot = torch.where(is_end, pos_idx - start_idx + 1, 0)

    # top-C clusters by weight (first index wins ties)
    w_rem = weights_slot
    slots = []
    ws = []
    hidx = torch.arange(H, device=dev)[None, :]
    for _ in range(C):
        s = torch.argmax(w_rem, dim=1)
        slots.append(s)
        ws.append(w_rem.gather(1, s[:, None])[:, 0])
        w_rem = w_rem * (hidx != s[:, None])
    slot = torch.stack(slots, dim=1)  # (B, C)
    w_top = torch.stack(ws, dim=1)
    nh = nh_slot.gather(1, slot)
    sidx = start_idx.gather(1, slot).to(torch.int64)  # run start of winner
    pred = est2.gather(1, sidx)
    strand = str2.gather(1, sidx)
    pred = torch.where(w_top > 0, pred, BIG32)
    strand = torch.clamp(strand, 0, 1)

    # ---- stage 4: tier-1 ungapped screen on packed words -----------------
    Wr = L // 16
    pred_c = torch.clamp(pred, -BIG32, BIG32)
    s_words = gather_aligned_words(packed_genome, pred_c, Wr)  # (B, C, Wr)
    s_n2 = gather_aligned_words(genome_n2, pred_c, Wr) if genome_has_n else 0
    q_packed, q_n2 = pack_codes_words(codes)  # (B, Wr)
    qr_packed, qr_n2 = reverse_packed_rows(q_packed, q_n2, lengths, const_len)
    rev = (strand == 1)[..., None]
    q_words = torch.where(rev, qr_packed[:, None, :], q_packed[:, None, :])
    qn2 = torch.where(rev, qr_n2[:, None, :], q_n2[:, None, :])
    x = q_words ^ s_words
    mism_bits = ((x | (x >> 1)) & 0x55555555) | s_n2 | qn2
    # expand bit 2j of each word to a (B, C, L) bool mismatch mask
    jsh_l = 2 * (torch.arange(L, dtype=torch.int64, device=dev) % 16)
    m = (
        (torch.repeat_interleave(mism_bits, 16, dim=-1)[..., :L] >> jsh_l) & 1
    ).to(torch.bool)
    # out-of-genome placements mismatch everywhere
    gpos = pred_c[..., None] + torch.arange(L, dtype=torch.int32, device=dev)
    m = m | (gpos < 0) | (gpos >= genome_len)
    l3 = lengths[:, None].expand(B, C)
    t_mm, t_cs, t_ce = tier1_stats_from_mask(m.reshape(B * C, L), l3.reshape(B * C))

    return {
        "pred_start": pred,  # (B, C) concat coords
        "weight": w_top,
        "strand": strand,  # 0 = forward, 1 = reverse
        "num_hits": nh,
        "mismatches": t_mm.reshape(B, C),
        "clip_start": t_cs.reshape(B, C),
        "clip_end": t_ce.reshape(B, C),
    }


def classify_candidates(
    pred: torch.Tensor,  # (B, C) int32 predicted concat starts (BIG32 = none)
    weight: torch.Tensor,  # (B, C) int32
    strand: torch.Tensor,  # (B, C) int32
    mm: torch.Tensor,  # (B, C) int32 tier-1 mismatches
    cs: torch.Tensor,  # (B, C) int32 tier-1 clip start
    ce: torch.Tensor,  # (B, C) int32 tier-1 clip end
    lengths: torch.Tensor,  # (B,) int32
    offs: torch.Tensor,  # (S+1,) int64 sequence concat offsets
    min_mq: int,
    iv_lo: torch.Tensor | None = None,  # (R,) int64 known-STR neighborhood
    iv_hi: torch.Tensor | None = None,  # bounds, sorted and merged
):
    """Device-side candidate classification for the fused pipeline:
    fused/unique tier-1 accept, multi-candidate resolution, known-STR
    demotion (when iv_lo/iv_hi are given: reads with a kept candidate near
    a known STR go to the host tier-2 path) and the dense host-cell lanes.

    Mirrored thresholds: MIN_PROPORTION_BEST=0.2, MIN_WEIGHTED_COUNT=1
    (SingleReadsAligner.java:16-18), tier-1 accept mm<5%/clip<10%
    (ShortReadsUngappedSearchHitsClusterAligner.java:81-95), q=100-5*mm
    and the 0.8*best multi-alignment threshold
    (SingleReadsAligner.filterAlignments:118-143)."""
    B, C = pred.shape
    dev = pred.device
    qlen = lengths.to(torch.int32)[:, None]
    valid_c = (weight > 0) & (pred < (1 << 29)) & (pred >= 0)
    si = torch.clamp(
        torch.searchsorted(offs, torch.clamp(pred, min=0).to(offs.dtype), right=True)
        - 1,
        0,
        offs.shape[0] - 2,
    )
    w = weight
    # float64 threshold math mirrors the host path bit for bit
    limit = torch.clamp(0.2 * w[:, :1].to(torch.float64), max=1.0)
    keep_tail = valid_c[:, 1:] & (w[:, 1:].to(torch.float64) >= limit)
    keep = torch.cat([valid_c[:, :1], keep_tail], dim=1)
    keep = torch.cumprod(keep.to(torch.int32), dim=1).to(torch.bool)
    in_b = (pred >= offs[si]) & (pred + qlen <= offs[si + 1])
    t1 = keep & in_b & (w > 2) & (mm * 20 < qlen) & ((cs + ce) * 10 < qlen)
    n_kept = keep.sum(dim=1)
    minq = max(1, int(min_mq))
    fused = (n_kept == 1) & t1[:, 0] & (100 - mm[:, 0] * 5 >= minq)
    # ---- multi-candidate tier-1 resolution ------------------------------
    multi = (n_kept >= 2) & torch.all(t1 | ~keep, dim=1)
    q = torch.where(keep, 100 - 5 * mm, -(10**9))
    best = torch.amax(q, dim=1)
    thr = torch.trunc(0.8 * best.to(torch.float64)).to(torch.int32)
    n_final = (q > thr[:, None]).sum(dim=1)
    win = torch.argmax(q, dim=1)
    has_strs = iv_lo is not None and iv_lo.numel() > 0

    def near_str(first, last):
        k = torch.clamp(
            torch.searchsorted(iv_lo, last.to(iv_lo.dtype), right=True) - 1,
            0,
            iv_lo.shape[0] - 1,
        )
        return (iv_lo[k] <= last) & (iv_hi[k] >= first)

    if has_strs:
        # any kept candidate near a known STR forces the host tier-2 path
        multi = multi & ~(keep & near_str(pred, pred + qlen)).any(dim=1)
    one = multi & (n_final == 1) & (best >= minq)
    resolved_drop = multi & ~one
    sel_col = torch.where(one, win, 0)
    fused = fused | one
    aligned_extra = (resolved_drop & ((n_final >= 2) | (best > 0))).sum()
    if has_strs:
        spred = pred.gather(1, sel_col[:, None])[:, 0]
        fused = fused & ~near_str(spred, spred + qlen[:, 0])
    fused_count = fused.sum()

    def take(a):
        return a.gather(1, sel_col[:, None])[:, 0]

    sel_pred = take(pred)
    # one packed word per read: mm(10) | strand(1)<<10 | cs(10)<<11 |
    # ce(10)<<21
    sel_ab = (
        torch.clamp(take(mm), 0, 0x3FF)
        | (torch.clamp(take(strand), 0, 1) << 10)
        | (torch.clamp(take(cs), 0, 0x3FF) << 11)
        | (torch.clamp(take(ce), 0, 0x3FF) << 21)
    )

    # ---- host cells: dense lanes + mask (the host compacts) -------------
    hostrow = keep.any(dim=1) & ~fused & ~resolved_drop
    cell = hostrow[:, None] & keep & in_b
    cols = torch.arange(C, dtype=torch.int32, device=dev)[None, :]
    lane2 = (
        torch.clamp(w, 0, 0xFFFF)
        | (cols << 16)
        | (t1.to(torch.int32) << 20)
        | (torch.clamp(strand, 0, 1) << 21)
    )
    lane3 = (
        torch.clamp(mm, 0, 0x3FF)
        | (torch.clamp(cs, 0, 0x3FF) << 10)
        | (torch.clamp(ce, 0, 0x3FF) << 20)
    )
    return {
        "fused": fused.to(torch.int8),
        "sel_pred": sel_pred,
        "sel_ab": sel_ab,
        "cell_mask": cell.reshape(-1).to(torch.int8),
        "cell_pred": pred.reshape(-1),
        "cell_l2": lane2.reshape(-1),
        "cell_l3": lane3.reshape(-1),
        "aligned_extra": aligned_extra,
        "fused_count": fused_count,
    }
