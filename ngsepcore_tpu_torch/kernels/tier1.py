"""Tier-1 ungapped mismatch screen for read alignment.

Ref: ShortReadsUngappedSearchHitsClusterAligner.countMismatches(query,
subject, aln) (ShortReadsUngappedSearchHitsClusterAligner.java:157-192):
count mismatches between read and the reference window at the predicted
ungapped placement, plus how many leading/trailing bases should be
soft-clipped (clip grows until 3+ net matches observed).  Accepted when
total < 5% of read length and clips < 10% (":81-95").
"""
from __future__ import annotations

import torch


def _first_true(x: torch.Tensor) -> torch.Tensor:
    """Index of the first True per row (0 for rows with none)."""
    return torch.argmax(x.to(torch.int8), dim=1)


def tier1_stats_from_mask(m: torch.Tensor, qlen: torch.Tensor):
    """Closed-form tier-1 stats from a precomputed mismatch mask
    m (B, L) bool (True = mismatch at an in-query position).  Built from
    cumulative sums/maxima instead of sequential scans.

    Clip semantics (countMismatches): walking in from an end, the clip ends
    at the first position i that matches and has seen fewer than i-3
    mismatches so far; the clip is everything up to the last mismatch
    strictly before i.  Returns (total, clip_start, clip_end), (B,) int32.
    """
    B, L = m.shape
    dev = m.device
    qlen = qlen.to(torch.int32)
    idx = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    neg1 = torch.full((B, 1), -1, dtype=torch.int32, device=dev)
    inq = idx < qlen[:, None]
    m = m & inq
    total = m.sum(dim=1, dtype=torch.int32)

    mi = m.to(torch.int32)
    cnt_excl = torch.cumsum(mi, dim=1, dtype=torch.int32) - mi
    lastmm_incl = torch.cummax(torch.where(m, idx, -1), dim=1).values
    lastmm_excl = torch.cat([neg1, lastmm_incl[:, :-1]], dim=1)
    fire = inq & ~m & (cnt_excl + 3 < idx)
    has = fire.any(dim=1)
    first_fire = _first_true(fire)
    clip_start = torch.where(
        has, lastmm_excl.gather(1, first_fire[:, None])[:, 0] + 1, 0
    ).to(torch.int32)

    # backward pass on the flipped mask: flipped slot j' maps to original
    # position L-1-j'; real read positions start at pad = L - qlen, and the
    # reversed read coordinate is j' - pad
    mf = torch.flip(m, dims=[1])
    rstep = idx - (L - qlen)[:, None]
    mi_f = mf.to(torch.int32)
    cnt_f_excl = torch.cumsum(mi_f, dim=1, dtype=torch.int32) - mi_f
    lastf_incl = torch.cummax(torch.where(mf, idx, -1), dim=1).values
    lastf_excl = torch.cat([neg1, lastf_incl[:, :-1]], dim=1)
    minmm_excl = torch.where(lastf_excl >= 0, L - 1 - lastf_excl, 1 << 30)
    minmm_excl = torch.minimum(minmm_excl, qlen[:, None])  # lastMismatch=qlen
    fire_r = (rstep >= 0) & ~mf & (cnt_f_excl + 3 < rstep)
    has_r = fire_r.any(dim=1)
    first_r = _first_true(fire_r)
    clip_end = torch.where(
        has_r, qlen - minmm_excl.gather(1, first_r[:, None])[:, 0], 0
    ).to(torch.int32)
    return total, clip_start, clip_end


def tier1_stats(query: torch.Tensor, qlen: torch.Tensor, subject: torch.Tensor):
    """query/subject (B, L) int8; qlen (B,).  Subject window is the same
    length as the read (ungapped placement).  The reference's sequential
    countMismatches[0..2] walk, one position per step.

    Returns (total_mismatches, clip_start, clip_end) each (B,) int32.
    """
    B, L = query.shape
    dev = query.device
    qlen = qlen.to(torch.int32)
    mism = query != subject
    count = torch.zeros(B, dtype=torch.int32, device=dev)
    last_mm = torch.full((B,), -1, dtype=torch.int32, device=dev)
    assigned = torch.zeros(B, dtype=torch.bool, device=dev)
    clip_start = torch.zeros(B, dtype=torch.int32, device=dev)
    for i in range(L):
        valid = i < qlen
        mm = mism[:, i] & valid
        count = count + mm.to(torch.int32)
        last_mm = torch.where(mm, i, last_mm)
        fire = valid & ~mm & ~assigned & (count + 3 < i)
        clip_start = torch.where(fire, last_mm + 1, clip_start)
        assigned |= fire
    numm = torch.zeros(B, dtype=torch.int32, device=dev)
    last_mm = qlen.clone()  # ref: lastMismatch starts at refSeq.length
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    clip_end = torch.zeros(B, dtype=torch.int32, device=dev)
    for step in range(L):
        i = qlen - 1 - step
        valid = i >= 0
        m = mism.gather(1, torch.clamp(i, min=0).long()[:, None])[:, 0] & valid
        last_mm = torch.where(m, i, last_mm)
        numm = numm + m.to(torch.int32)
        fire = valid & ~m & ~done & (numm + 3 < step)
        clip_end = torch.where(fire, qlen - last_mm, clip_end)
        done |= fire
    return count, clip_start, clip_end
