"""Gotoh affine-gap forward pass: CUDA kernel for Hopper and its plain
PyTorch version.

Replaces the Pallas kernel `gotoh_forward_plane_pallas`
(ngsepcore_tpu/kernels/pairwise_pallas.py:243, body `_gotoh_kernel_factory`
:53, `pl.pallas_call` :274).  Semantics: PairwiseAlignerAffineGap.java
:29-292 (scores match/mismatch/open/ext = 1/1/3/1 by default, tie order
M > I > D).  Both versions emit the packed run/pointer plane the run-jump
walk reads (kernels/pairwise._runs_from_plane):

    plane[i-1, b, j-1] = sm | si<<2 | sd<<4 | em<<8 | ei<<16 | ed<<24

(M/I/D run-start pointers and saturating M/I/D run lengths of cell
(i, j)), stored as int32 holding the same 32 bits as the TPU's uint32;
readers mask after every right shift.  Rows past qlen freeze M/I/D and
the em/ei/sm/si carries; sd/ed are recomputed there, so plane cells past
qlen (and columns past slen) hold values the walk never reads.

CUDA design (csrc/gotoh_forward.cu): one block per alignment, one thread
per subject column (Ls <= 1024); the block loops over query rows, which
takes the place of the TPU's sequential row grid axis.  Each row needs
the diagonal neighbour (shared memory) and two block-wide inclusive
max-scans: D from cummax(A[h] + ext*h) and the packed D-run source from
cummax(col*4 + dp).  What bounds it on the H100: the ~7 block barriers per
row and the plane write of 4 bytes per cell (Lq*B*Ls*4 bytes per call,
written once, coalesced per row); the arithmetic is a few dozen integer
ops per cell.  The walk reads the plane back from L2/HBM.
"""
from __future__ import annotations

import torch

from .cuda_build import check, library

NEG = -(10**7)  # "banned" score


def gotoh_forward_plane_ref(
    query: torch.Tensor,  # (B, Lq) int8 codes, padded
    qlen: torch.Tensor,  # (B,) int32
    subject: torch.Tensor,  # (B, Ls) int8 codes, padded
    slen: torch.Tensor,  # (B,) int32
    *,
    match: int = 1,
    mismatch: int = 1,
    open_gap: int = 3,
    ext_gap: int = 1,
    free_start1: bool = False,
    free_end1: bool = False,
    free_start2: bool = True,
    free_end2: bool = True,
):
    """Plain PyTorch Gotoh forward pass: one vectorized row per query
    position, D solved in closed form with a cumulative max

        D[i][j] = cummax( A[h] + ext*h )[j-1] - ext*(j-1),  A = max(M, I) - open

    Covers all four free-end configurations.  Returns (plane (Lq, B, Ls)
    int32, score, end_i, end_j, start_k) with (B,) int32 vectors."""
    assert not (free_end1 and free_end2), "free_end1 with free_end2 unsupported"
    B, Lq = query.shape
    Ls = subject.shape[1]
    dev = query.device
    i32 = torch.int32
    qlen = qlen.to(i32)
    slen = slen.to(i32)
    jj = torch.arange(Ls + 1, dtype=i32, device=dev)
    ext_j = ext_gap * jj

    m_prev = torch.where(jj == 0, 0, NEG).to(i32)[None, :].expand(B, Ls + 1)
    i_prev = m_prev
    if free_start2:
        d_prev = torch.zeros((B, Ls + 1), dtype=i32, device=dev)
    else:
        d_prev = (
            torch.where(jj == 0, 0, -open_gap - ext_gap * (jj - 1))
            .to(i32)[None, :]
            .expand(B, Ls + 1)
        )
    zrow = torch.zeros((B, Ls + 1), dtype=i32, device=dev)
    em_prev = ei_prev = sm_prev = si_prev = zrow
    col_bound = lambda v: torch.full((B, 1), v, dtype=i32, device=dev)
    plane = torch.empty((Lq, B, Ls), dtype=i32, device=dev)
    m_cols = []

    for r in range(1, Lq + 1):
        q_char = query[:, r - 1]
        sub = torch.where(subject == q_char[:, None], match, -mismatch).to(i32)
        mpd, ipd, dpd = m_prev[:, :-1], i_prev[:, :-1], d_prev[:, :-1]
        m_inner = torch.maximum(torch.maximum(mpd, ipd), dpd) + sub
        mp = torch.where(
            mpd >= torch.maximum(ipd, dpd), 0, torch.where(ipd >= dpd, 1, 2)
        ).to(i32)
        m_row = torch.cat([col_bound(NEG), m_inner], dim=1)
        # M-run length + run-start pointer (diagonal recurrences)
        em_inner = torch.clamp(1 + torch.where(mp == 0, em_prev[:, :-1], 0), max=255)
        em_row = torch.cat([col_bound(0), em_inner], dim=1)
        sm_row = torch.cat(
            [col_bound(0), torch.where(mp != 0, mp, sm_prev[:, :-1])], dim=1
        )

        i_cand_m = m_prev - open_gap
        i_cand_i = i_prev - ext_gap
        i_cand_d = d_prev - open_gap
        i_row = torch.maximum(torch.maximum(i_cand_m, i_cand_i), i_cand_d)
        ip = torch.where(
            i_cand_m >= torch.maximum(i_cand_i, i_cand_d),
            0,
            torch.where(i_cand_i >= i_cand_d, 1, 2),
        ).to(i32)
        i0 = 0 if free_start1 else -open_gap - ext_gap * (r - 1)
        i_row = torch.cat([col_bound(i0), i_row[:, 1:]], dim=1)
        # I-run length + run-start pointer (vertical recurrences)
        ei_row = torch.clamp(1 + torch.where(ip == 1, ei_prev, 0), max=255)
        si_row = torch.where(ip != 1, ip, si_prev)

        a_m = m_row - open_gap
        a_i = i_row - open_gap
        a = torch.maximum(a_m, a_i)
        run = torch.cummax((a + ext_j)[:, :-1], dim=1).values
        d_row = torch.cat([col_bound(NEG), run - ext_j[1:] + ext_gap], dim=1)
        opened = a[:, :-1] >= (d_row[:, :-1] - ext_gap)
        dp = torch.where(
            opened, torch.where(a_m[:, :-1] >= a_i[:, :-1], 0, 1), 2
        ).to(i32)
        dp = torch.cat([col_bound(0), dp], dim=1)
        # D-run length + source via ONE packed cummax: j*4+dp is monotone in
        # j, so the running max is the latest non-extend cell and its low
        # bits are that cell's pointer
        open_run = torch.cummax(torch.where(dp != 2, jj * 4 + dp, -1), dim=1).values
        sd_row = open_run & 3
        ed_row = torch.clamp(jj - (open_run >> 2) + 1, max=255)

        active = (r <= qlen)[:, None]
        m_row = torch.where(active, m_row, m_prev)
        i_row = torch.where(active, i_row, i_prev)
        d_row = torch.where(active, d_row, d_prev)
        em_row = torch.where(active, em_row, em_prev)
        ei_row = torch.where(active, ei_row, ei_prev)
        sm_row = torch.where(active, sm_row, sm_prev)
        si_row = torch.where(active, si_row, si_prev)

        plane[r - 1] = (
            sm_row[:, 1:]
            | (si_row[:, 1:] << 2)
            | (sd_row[:, 1:] << 4)
            | (em_row[:, 1:] << 8)
            | (ei_row[:, 1:] << 16)
            | (ed_row[:, 1:] << 24)
        )
        if free_end1:
            m_at = m_row.gather(1, slen.long()[:, None])[:, 0]
            m_cols.append(torch.where(r <= qlen, m_at, NEG))
        m_prev, i_prev, d_prev = m_row, i_row, d_row
        em_prev, ei_prev, sm_prev, si_prev = em_row, ei_row, sm_row, si_row

    zeros = torch.zeros(B, dtype=i32, device=dev)
    cols = jj[None, :]
    if free_end2:
        masked = torch.where(cols <= slen[:, None], m_prev, NEG)
        best = torch.amax(masked, dim=1)
        # ties go to the largest column
        end_j = torch.amax(torch.where(masked == best[:, None], cols, -1), dim=1)
        return plane, best, qlen, end_j.to(i32), zeros
    if free_end1:
        h0 = torch.where(slen == 0, 0, NEG).to(i32)
        mstack = torch.stack([h0] + m_cols, dim=0)  # (Lq+1, B)
        best = torch.amax(mstack, dim=0)
        rows = torch.arange(Lq + 1, dtype=i32, device=dev)[:, None]
        end_i = torch.amax(torch.where(mstack == best[None, :], rows, -1), dim=0)
        return plane, best, end_i.to(i32), slen, zeros
    sl = slen.long()[:, None]
    mc = m_prev.gather(1, sl)[:, 0]
    ic = i_prev.gather(1, sl)[:, 0]
    dc = d_prev.gather(1, sl)[:, 0]
    score = torch.where(ic > mc, ic, mc)
    start_k = torch.where(ic > mc, 1, zeros)
    score = torch.where(dc > score, dc, score)
    start_k = torch.where(dc > torch.maximum(mc, ic), 2, start_k).to(i32)
    return plane, score, qlen, slen, start_k


def gotoh_forward_plane(
    query: torch.Tensor,
    qlen: torch.Tensor,
    subject: torch.Tensor,
    slen: torch.Tensor,
    *,
    match: int = 1,
    mismatch: int = 1,
    open_gap: int = 3,
    ext_gap: int = 1,
    free_start1: bool = False,
    free_end1: bool = False,
    free_start2: bool = True,
    free_end2: bool = True,
):
    """Forward Gotoh pass, same contract as gotoh_forward_plane_ref.

    CPU tensors run the plain version.  CUDA tensors launch the CUDA
    kernel (which covers the free_start2/free_end2 configurations the
    tier-3 aligner and the long-read segments use) or raise."""
    cfg = dict(
        match=match, mismatch=mismatch, open_gap=open_gap, ext_gap=ext_gap,
        free_start1=free_start1, free_end1=free_end1,
        free_start2=free_start2, free_end2=free_end2,
    )
    if query.device.type == "cpu":
        return gotoh_forward_plane_ref(query, qlen, subject, slen, **cfg)
    if query.device.type != "cuda":
        raise ValueError(f"unsupported device {query.device}")
    if free_start1 or free_end1:
        raise NotImplementedError(
            "free_start1/free_end1 (tier-2 STR alignment) on CUDA: "
            "ROADMAP.md Queue 1, \"Tier-2 STR\""
        )
    B, Lq = query.shape
    Ls = subject.shape[1]
    if subject.shape[0] != B or qlen.shape != (B,) or slen.shape != (B,):
        raise ValueError("query/subject/qlen/slen batch sizes differ")
    if query.dtype != torch.int8 or subject.dtype != torch.int8:
        raise TypeError("query and subject must be int8 codes")
    if not 1 <= Ls <= 1024:
        raise ValueError(f"subject width {Ls} outside the kernel's 1..1024")
    dev = query.device
    for t in (subject, qlen, slen):
        if t.device != dev:
            raise ValueError("all inputs must lie on one device")
    query = query.contiguous()
    subject = subject.contiguous()
    qlen = qlen.to(torch.int32).contiguous()
    slen = slen.to(torch.int32).contiguous()
    plane = torch.empty((Lq, B, Ls), dtype=torch.int32, device=dev)
    fin = torch.empty((3, B), dtype=torch.int32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gotoh_forward_launch(
            query.data_ptr(), qlen.data_ptr(), subject.data_ptr(),
            slen.data_ptr(), plane.data_ptr(), fin[0].data_ptr(),
            fin[1].data_ptr(), fin[2].data_ptr(),
            B, Lq, Ls, match, mismatch, open_gap, ext_gap,
            int(free_start2), int(free_end2), stream,
        )
    check("gotoh_forward", rc)
    gotoh_forward_plane.launches += 1
    return plane, fin[0], qlen, fin[1], fin[2]


gotoh_forward_plane.launches = 0
