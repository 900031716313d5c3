"""Batched affine-gap (Gotoh) pairwise alignment on device: the tier-3 DP.

Ref: src/ngsep/alignments/PairwiseAlignerAffineGap.java:29-292 — 3-matrix
Gotoh with match=+1 mismatch=-1 openGap=3 extGap=1 (subtracted), "force"
flags for free subject ends, and a deterministic traceback preference order
(M then I then D, PairwiseAlignerAffineGap.java:228-259).

The forward pass (kernels/pairwise_cuda.gotoh_forward_plane: the CUDA
kernel on the card, its plain version on the CPU) emits a packed
run/pointer plane; a run-jump traceback walks it emitting one CIGAR run
per step, a post-pass derives the tier-3 statistics and left-aligns the
gap runs.  Every integer tensor here has its dtype written out; the plane
is int32 holding uint32 bits, so every right shift is masked.
"""
from __future__ import annotations

import torch

from .pairwise_cuda import gotoh_forward_plane

# alignment ops emitted by traceback
OP_NONE = 0
OP_MATCH = 1  # diagonal (match or mismatch)
OP_INS = 2  # query base consumed, gap in subject (CIGAR I)
OP_DEL = 3  # subject base consumed, gap in query (CIGAR D)

LA_LMAX = 16  # max indel length left-aligned on device; longer runs (and
# RLE overflows) raise la_fallback and the host runs the exact pass

_I32 = torch.int32


def _walk_runs_for(Lq: int) -> int:
    """Walk-step budget: any alignment acceptable under the tier-3 10%
    mismatch cap has <= 0.1*Lq + 3 runs (each internal gap run costs 2
    mismatches); the +8 margin covers boundary runs and saturation splits.
    Rows needing more steps are flagged (walk_ok=False) and carry a huge
    mismatch count, so accept/reject behavior is unchanged."""
    return Lq // 8 + 8


def affine_gap_align_runs(
    query: torch.Tensor,  # (B, Lq) int8 codes, padded
    qlen: torch.Tensor,  # (B,) int32
    subject: torch.Tensor,  # (B, Ls) int8 codes, padded
    slen: torch.Tensor,  # (B,) int32
    match: int = 1,
    mismatch: int = 1,
    open_gap: int = 3,
    ext_gap: int = 1,
    free_start1: bool = False,
    free_end1: bool = False,
    free_start2: bool = True,
    free_end2: bool = True,
    walk_runs: int | None = None,
):
    """Gotoh alignment emitting CIGAR RUNS directly (run-jump traceback).

    Returns dict with:
      score    (B,) int32
      rop      (B, R) int32 — op per run (OP_MATCH/OP_INS/OP_DEL), forward order
      rlen     (B, R) int32 — run lengths (adjacent same-op runs merged)
      n_runs   (B,) int32
      n_ops    (B,) int32 — total alignment columns
      start_j  (B,) int32
      end_j    (B,) int32
      end_i    (B,) int32
      walk_ok  (B,) bool — False when the run budget was exhausted
    """
    B, Lq = query.shape
    R = walk_runs if walk_runs is not None else _walk_runs_for(Lq)
    plane, score, end_i, end_j, start_k = gotoh_forward_plane(
        query, qlen, subject, slen,
        match=match, mismatch=mismatch, open_gap=open_gap, ext_gap=ext_gap,
        free_start1=free_start1, free_end1=free_end1,
        free_start2=free_start2, free_end2=free_end2,
    )
    return _runs_from_plane(plane, score, end_i, end_j, start_k, B, R, free_start2)


def _runs_from_plane(plane, score, end_i, end_j, start_k, B, R, free_start2):
    """Run-jump traceback + merge over a (Lq, B, Ls) int32 pointer/run
    plane.  Each step reads one plane cell per row: the current matrix's
    run length (saturated runs jump 254 cells and continue in the same
    matrix) and the pointer to the matrix the run came from."""
    dev = plane.device
    emit_lead_del = not free_start2
    bb = torch.arange(B, device=dev)
    i = end_i.to(_I32)
    j = end_j.to(_I32)
    k = start_k.to(_I32)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    lns, ops = [], []
    for _ in range(R):
        in_aln = (i > 0) & (j > 0) & ~done
        w = plane[
            torch.clamp(i - 1, min=0).long(), bb, torch.clamp(j - 1, min=0).long()
        ]
        src = (w >> (2 * k)) & 3
        run = (w >> (8 * k + 8)) & 255
        sat = run == 255
        r = torch.where(sat, 254, run)
        only_i = (i > 0) & (j == 0) & ~done
        only_j = (i == 0) & (j > 0) & ~done & emit_lead_del
        op = torch.where(
            in_aln,
            k + 1,
            torch.where(only_i, OP_INS, torch.where(only_j, OP_DEL, OP_NONE)),
        )
        ln = torch.where(
            in_aln, r, torch.where(only_i, i, torch.where(only_j, j, 0))
        )
        di = torch.where(in_aln & ((k == 0) | (k == 1)), r, torch.where(only_i, i, 0))
        dj = torch.where(in_aln & ((k == 0) | (k == 2)), r, torch.where(only_j, j, 0))
        k = torch.where(in_aln & ~sat, src, k)
        done = done | (~in_aln & ~only_i & ~only_j)
        i = i - di
        j = j - dj
        lns.append(ln)
        ops.append(op)
    rlen_rev = torch.stack(lns, dim=1).to(_I32)  # (B, R)
    rop_rev = torch.stack(ops, dim=1).to(_I32)
    start_j = j
    walk_ok = (i == 0) & ((j == 0) | (not emit_lead_del))

    # reverse the emitted prefix into forward order
    n_raw = (rlen_rev > 0).sum(dim=1, dtype=_I32)
    idx = torch.arange(R, dtype=_I32, device=dev)[None, :]
    src_idx = torch.clamp(n_raw[:, None] - 1 - idx, min=0).long()
    fwd = idx < n_raw[:, None]
    rlen_f = torch.where(fwd, rlen_rev.gather(1, src_idx), 0)
    rop_f = torch.where(fwd, rop_rev.gather(1, src_idx), 0)
    # merge adjacent same-op runs (saturation splits, boundary joins)
    prev_op = torch.cat(
        [torch.full((B, 1), -1, dtype=_I32, device=dev), rop_f[:, :-1]], dim=1
    )
    is_new = (rlen_f > 0) & (rop_f != prev_op)
    rank = torch.cumsum(is_new.to(_I32), dim=1, dtype=_I32) - 1
    ok = rank >= 0
    slot = torch.where(ok, rank, 0).long()
    rlen = torch.zeros((B, R), dtype=_I32, device=dev).scatter_add_(
        1, slot, torch.where(ok, rlen_f, 0)
    )
    rop = torch.zeros((B, R), dtype=_I32, device=dev).scatter_add_(
        1, slot, torch.where(ok & is_new, rop_f, 0)
    )
    return {
        "score": score.to(_I32),
        "rop": rop,
        "rlen": rlen,
        "n_runs": is_new.sum(dim=1, dtype=_I32),
        "n_ops": rlen_f.sum(dim=1, dtype=_I32),
        "start_j": start_j,
        "end_j": end_j.to(_I32),
        "end_i": end_i.to(_I32),
        "walk_ok": walk_ok,
    }


def dp_stats_runs(out: dict, query: torch.Tensor, subject: torch.Tensor):
    """Tier-3 stats from run-jump traceback output: mism (+1 per
    substitution, +2 per internal gap run,
    ShortReadsUngappedSearchHitsClusterAligner.java:140-156), has_gap,
    device-left-aligned rle (int16, op | len<<2), n_runs, n_ops, start_j,
    la_fallback.  Rows whose walk exhausted the run budget report
    mism=32000 (their exact count already exceeds any accept threshold)."""
    rop, rlen = out["rop"], out["rlen"]
    n_runs, n_ops = out["n_runs"], out["n_ops"]
    score, start_j = out["score"], out["start_j"]
    B, R = rop.shape
    dev = rop.device
    slot = torch.arange(R, dtype=_I32, device=dev)[None, :]
    valid = slot < n_runs[:, None]
    is_m = (rop == OP_MATCH) & valid
    is_gap = ((rop == OP_INS) | (rop == OP_DEL)) & valid
    m_cnt = torch.where(is_m, rlen, 0).sum(dim=1, dtype=_I32)
    gap_len = torch.where(is_gap, rlen, 0).sum(dim=1, dtype=_I32)
    k_all = is_gap.sum(dim=1, dtype=_I32)
    # substitutions from the score decomposition: with the tier-3 defaults
    # score = eq - neq - sum over gap runs (open + ext*len), open = 2+ext,
    # so neq = (#M - score - 2*K - gap_len) / 2
    sub_mm = (m_cnt - score - 2 * k_all - gap_len) >> 1
    prev_is_m = torch.cat(
        [torch.zeros((B, 1), dtype=torch.bool, device=dev), is_m[:, :-1]], dim=1
    )
    k_runs = (is_gap & prev_is_m).sum(dim=1, dtype=_I32)
    last_op = rop.gather(1, torch.clamp(n_runs - 1, min=0).long()[:, None])[:, 0]
    ends_gap = (n_runs > 0) & ((last_op == OP_INS) | (last_op == OP_DEL))
    mism = sub_mm + 2 * k_runs - 2 * ends_gap.to(_I32)
    mism = torch.where(out["walk_ok"], mism, 32000)
    has_gap = (k_all > 0).to(torch.int8)
    rlen_la, la_fallback = _left_align_rle(rop, rlen, n_runs, start_j, query, subject)
    rle = torch.where(valid, rop | (rlen_la << 2), 0).to(torch.int16)
    return {
        "mism": mism,
        "has_gap": has_gap,
        "rle": rle,
        "n_runs": n_runs,
        "n_ops": n_ops,
        "start_j": start_j,
        "la_fallback": la_fallback,
    }


def dp_gather_inputs(
    bigpq: torch.Tensor,  # (R, Lp) uint8 packed code|qual<<3, run-wide reads
    lengths: torch.Tensor,  # (R,) int32 read lengths
    concat: torch.Tensor,  # (G,) int8 concatenated genome codes
    rows: torch.Tensor,  # (B,) int64 global read row per DP job
    strand: torch.Tensor,  # (B,) int32 1 = align the reverse complement
    firsts: torch.Tensor,  # (B,) int64 subject window start (concat coords)
    slen: torch.Tensor,  # (B,) int32 subject window length
    *,
    Lq: int,
    Ls: int,
):
    """Build the DP query/subject matrices on device from the uploaded
    packed reads and genome; reverse queries are derived by
    flip+complement here."""
    dev = bigpq.device
    sub = (bigpq[rows] & 7).to(torch.int8)  # (B, Lp)
    ln = lengths[rows].to(_I32)
    Lp = sub.shape[1]
    j = torch.arange(Lq, dtype=_I32, device=dev)[None, :]
    rev = (strand == 1)[:, None]
    idx = torch.where(rev, ln[:, None] - 1 - j, j)
    g = sub.gather(1, torch.clamp(idx, 0, Lp - 1).long())
    g = torch.where(rev & (g < 4), 3 - g, g)
    qc = torch.where(j < ln[:, None], g, 4).to(torch.int8)
    js = torch.arange(Ls, dtype=torch.int64, device=dev)[None, :]
    sidx = torch.clamp(firsts.to(torch.int64)[:, None] + js, 0, concat.shape[0] - 1)
    sc = torch.where(js < slen[:, None], concat[sidx], 4).to(torch.int8)
    return qc, ln, sc


def dp_run_all(
    bigpq, lengths, concat, rows, strand, firsts, slen,
    *, CH: int, Lq: int, Ls: int, n_chunks: int,
):
    """The whole tier-3 sweep: per CH-row chunk of the job arrays, gather
    the query/subject matrices (dp_gather_inputs), run the Gotoh DP and the
    stats/RLE post-pass.  Returns the stats dict with a leading chunk axis
    (n_chunks, CH, ...)."""
    outs = []
    for ci in range(n_chunks):
        s = slice(ci * CH, (ci + 1) * CH)
        qc, ln, sc = dp_gather_inputs(
            bigpq, lengths, concat, rows[s], strand[s], firsts[s], slen[s],
            Lq=Lq, Ls=Ls,
        )
        out = affine_gap_align_runs(
            qc, ln, sc, slen[s], free_start2=True, free_end2=True
        )
        outs.append(dp_stats_runs(out, qc, sc))
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _left_align_rle(rop, rlen, n_runs, start_j, query, subject):
    """Shift I/D runs in the device RLE to their leftmost equivalent
    placement — the normalization read_alignment.left_align_indels applies
    on the host (ref: IndelRealignerPileupListener.moveIndelStarts:274).

    A gap run of length l at cursor p (in the consumed sequence: query for
    I, subject for D) shifts k steps iff x[p-1-j] == x[p+l-1-j] for all
    j < k, bounded by the preceding M run.  The first mismatching j is the
    backward run length of eq_l[t] = (x[t] == x[t+l]) ending at t = p-1,
    tabulated for every position and every lag 1..LA_LMAX.  Cursor
    positions are invariant under the shifts, so they come from the
    original RLE.

    Returns (new_rlen, la_fallback int8): la_fallback flags rows whose
    exact normalization needs the host pass (a gap run longer than
    LA_LMAX, more runs than slots, or a shift whose following run is not M).
    """
    B, R = rop.shape
    dev = rop.device
    slot = torch.arange(R, dtype=_I32, device=dev)[None, :]
    valid_slot = slot < n_runs[:, None]
    is_m = rop == OP_MATCH
    is_i = rop == OP_INS
    is_d = rop == OP_DEL
    gap = (is_i | is_d) & valid_slot
    qcons = torch.where(is_i | is_m, rlen, 0)
    scons = torch.where(is_d | is_m, rlen, 0)
    pq = torch.cumsum(qcons, dim=1, dtype=_I32) - qcons  # query offset at slot
    ps = start_j[:, None] + torch.cumsum(scons, dim=1, dtype=_I32) - scons

    def brl_tables(x):
        # (B, LA_LMAX * L): for lag l (block l-1), the count of consecutive
        # t' <= t with x[t'] == x[t'+l], evaluated at every t
        Bx, L = x.shape
        idxs = torch.arange(L, dtype=_I32, device=dev)[None, :]
        tabs = []
        for l in range(1, LA_LMAX + 1):
            eq = torch.cat(
                [
                    x[:, l:] == x[:, : L - l],
                    torch.zeros((Bx, min(l, L)), dtype=torch.bool, device=dev),
                ],
                dim=1,
            )[:, :L]
            nf = torch.where(eq, -1, idxs)
            tabs.append(idxs - torch.cummax(nf, dim=1).values)
        return torch.cat(tabs, dim=1)

    Lq = query.shape[1]
    Ls = subject.shape[1]
    lidx = torch.clamp(rlen, 1, LA_LMAX) - 1
    kq = brl_tables(query).gather(
        1, (lidx * Lq + torch.clamp(pq - 1, 0, Lq - 1)).long()
    )
    kd = brl_tables(subject).gather(
        1, (lidx * Ls + torch.clamp(ps - 1, 0, Ls - 1)).long()
    )
    k_raw = torch.where(is_i, kq, kd)
    k_raw = torch.where(gap & (rlen >= 1) & (rlen <= LA_LMAX), k_raw, 0)
    fallback = torch.any(gap & (rlen > LA_LMAX), dim=1) | (n_runs > R)

    lens = rlen.clone()
    zero_b = torch.zeros(B, dtype=torch.bool, device=dev)
    for t in range(1, R):
        next_m = is_m[:, t + 1] & (n_runs > t + 1) if t + 1 < R else zero_b
        can = gap[:, t] & is_m[:, t - 1]
        p_t = torch.where(is_i[:, t], pq[:, t], ps[:, t])
        k = torch.minimum(k_raw[:, t], torch.minimum(lens[:, t - 1], p_t))
        k = torch.where(can, k, 0)
        fallback = fallback | ((k > 0) & ~next_m)
        k = torch.where(next_m, k, 0)
        lens[:, t - 1] -= k
        if t + 1 < R:
            lens[:, t + 1] += k
    return lens, fallback.to(torch.int8)
