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

What bounds the function on the H100 (3.35 TB/s; 64 INT32 lanes on each of
132 SMs, about 16.7 T integer operations a second; no tensor-core work):

    bytes       B*(Lq+Ls+8) read + Lq*B*Ls*4 written, each once
                (2048x192x192: 302.0 MB, 0.090 ms);
    operations  45 integer operations a cell as the warp kernel does the
                arithmetic: M with its pointer and run carry 12, I 12, D
                with both scans 13, run fields, packing and store 8
                (2048x192x192: 75.5 M cells, 0.203 ms).  This is the larger
                bound at every shape.

CUDA design (csrc/gotoh_forward.cu), four kernels picked by Ls:

    Ls <= 256   one WARP per alignment, four alignments a block.  A lane
                owns ceil(Ls/32) contiguous columns and keeps their
                previous-row M/I/D and run carries (the masked previous
                plane word) in registers; the diagonal neighbour crosses
                lanes by shuffle; D and the D-run source are two blocked
                max-scans (pass over the lane's columns, 5-step warp scan
                of the lane totals, prefix applied).  No block barrier and
                no shared state in the row loop; the row leaves through a
                per-warp shared tile as whole 128-byte lines.  Rows past
                qlen are warp-uniform.
    Ls <= SEG_MAX_LS (3,584)
                the SEG kernel: the warp kernel's row split over the W =
                ceil(Ls/256) warps of one block (ceil(Ls/224) with a free
                query end), K = ceil(Ls/(32W)) columns a lane
                (seg_layout), state in registers, no global scratch.
                Between neighbouring warps only four ints cross a row (the
                y and D-run prefixes over every column to the left, the
                last column's diagonal hand-off), through a shared ring of
                8 rows with release/acquire flags, so warp w works on row r
                while warp w-1 is already ahead: no block barrier in the
                row loop.  Like the warp kernel it is bound by INT32 issue;
                SEG_MAX_LS is the widest row whose 16 warps a block fit
                the register file (128 a thread) without spills in every
                configuration.
    Ls <= CLUSTER_MAX_LS (24,576)
                the CLUSTER kernel: the seg kernel's chain of warps over
                the N blocks of a thread-block cluster (N <= 8, W <= 16
                warps a block, K columns a lane: cluster_layout), one
                alignment a cluster, so a batch too small to fill the
                card's SMs with one block an alignment (the MSA's 69
                alignments of 3,936 columns under its 4 GiB of plane)
                still does.  Inside a block the seg kernel's rings; across
                a block boundary the same four ints a row, written by the
                producer into the consumer block's shared memory
                (distributed shared memory) with a cluster-scope release,
                polled there with a cluster-scope acquire.  State in
                registers, no global scratch.  cluster_layout picks the
                blocks a cluster from the busiest SM's load and the
                clusters the card holds at once.  At the MSA's
                69x3936x3936: N 3, W 6, K 7, 7.4730 ms against the wide
                kernel's 23.9262, 38.5% of the 2.8758 ms bound (gotoh_bench.py
                --kernels on an NVIDIA H100 80GB HBM3, 700.00 W).
    Ls > CLUSTER_MAX_LS
                the WIDE kernel: one block per alignment, a thread owning
                C = ceil(Ls/1024) contiguous columns, their state in a
                global scratch of 8 ints a column (the wrapper allocates
                B x 8 x C x threads ints); block barriers with the warp
                kernel's blocked max-scans.  No width limit short of the
                plane's size; no path of chip_smoke.py reaches it.

The plane is (Lq, B, Ls) int32: 1.34 GB at the tier-2 chunk of 256 rows,
Lq 160 and Ls 8,192, so a caller with long subjects bounds its rows
(align/str_tier2.py halves its chunk above a cap).

All kernels take the four free-end flags.  The tier-2 STR flank
alignments (align/str_tier2.py) use the free QUERY ends: free_start1 sets
column 0 of the I state to 0 in every row; with free_end1 the thread that
owns column slen keeps a running (best M, row) maximum in registers, ties
to the largest row, and the launch returns it as (score, end_i).

The walk reads the plane back from L2/HBM.
"""
from __future__ import annotations

from collections import Counter

import torch

from .cuda_build import check, library

NEG = -(10**7)  # "banned" score
FREE_END_FLAGS = ("free_start1", "free_end1", "free_start2", "free_end2")
# widest subject of the warp-per-alignment kernel (32 lanes x kMaxLaneCols
# of csrc/gotoh_forward.cu); wider ones take the seg kernel
WARP_KERNEL_MAX_LS = 256
# widest subject of the seg kernel (kSegMaxLs: 16 warps of 7 columns a
# lane, the most a free query end takes); wider ones take the cluster kernel
SEG_MAX_LS = 3584
CLUSTER_MAX_CTAS = 8  # the portable thread-block cluster size
# widest subject of the cluster kernel (kClusterMaxLs: 8 blocks of 16 warps
# of 6 columns a lane, the most a free query end takes there: its 7-column
# variants spill registers); wider ones take the wide kernel
CLUSTER_MAX_LS = CLUSTER_MAX_CTAS * 16 * 32 * 6
H100_SMS = 132
_KERNEL_CODES = {None: 0, "seg": 1, "wide": 2, "cluster": 3}
WIDE_FIELDS = 8  # scratch ints an owned column of the wide kernel
WIDE_THREADS = 1024  # the wide kernel's most threads a block


def seg_layout(Ls: int, free_end1: bool = False) -> tuple[int, int]:
    """(columns a lane K, warps W) of the seg kernel at Ls, as
    gotoh_forward_launch computes them: the fewest warps of at most 8
    columns a lane (7 with a free query end, whose 8-column variants spill
    registers), then the fewest columns a lane, at least 4."""
    W = -(-Ls // (32 * (7 if free_end1 else 8)))
    return max(4, -(-Ls // (32 * W))), W


def cluster_shape(Ls: int, free_end1: bool, n: int) -> tuple[int, int] | None:
    """(warps a block W, columns a lane K) of a cluster of n blocks at Ls,
    as csrc/gotoh_forward.cu:cluster_shape computes them: the fewest warps
    (at most 16), then the fewest columns a lane (4 to 8, 6 with a free
    query end), such that every column is owned and every block owns one;
    None where no such shape exists."""
    most = 6 if free_end1 else 8
    for W in range(1, 17):
        K = max(4, -(-Ls // (32 * n * W)))
        if K <= most and 32 * K * W * (n - 1) < Ls:
            return W, K
    return None


def cluster_layout(B: int, Ls: int, free_end1: bool = False, n_sms: int = H100_SMS, *,
                   ctas: int | None = None, min_ctas: int = 1,
                   held=None) -> tuple[int, int, int]:
    """(blocks a cluster N, warps a block W, columns a lane K) of the
    cluster kernel, as gotoh_forward_launch computes them on a card of
    n_sms SMs: over N = min_ctas..8 (or `ctas` alone), each with
    cluster_shape's (W, K), the least time of the busiest SM.  The B
    clusters run in ceil(B / h) waves of the h = held(N, W, K) clusters
    the card holds at once, a wave puts ceil(min(B, h) N / n_sms) blocks
    on an SM, and a block's row costs K (3W + 4): its warps' columns and a
    fixed 4/3 of a warp's row, measured on the H100.  Then the fewest
    blocks a cluster.  `held` is the card's cudaOccupancyMaxActiveClusters
    (cluster_occupancy; the kernel asks it itself), by default the SM
    arithmetic n_sms (16 // W) // N of blocks of 128 registers a thread,
    which GPC boundaries can make larger than the card's.  Raises
    ValueError where no N has a layout.  Warps past the row's end (only
    in the last block) sit the rows out."""
    if held is None:
        def held(n, W, K):
            return n_sms * (16 // W) // n
    best, best_cost = None, None
    for n in [ctas] if ctas else range(min_ctas, CLUSTER_MAX_CTAS + 1):
        shape = cluster_shape(Ls, free_end1, n)
        if shape is None:
            continue
        W, K = shape
        h = held(n, W, K)
        if h <= 0:
            continue
        cost = -(-B // h) * -(-min(B, h) * n // n_sms) * K * (3 * W + 4)
        if best is None or cost < best_cost:
            best, best_cost = (n, W, K), cost
    if best is None:
        raise ValueError(f"the cluster kernel has no layout at Ls {Ls} "
                         f"(free_end1 {free_end1}, blocks a cluster {ctas or min_ctas}+)")
    return best


def device_cluster_layout(B: int, Ls: int, free_start1: bool = False,
                          free_end1: bool = False, device=None, *,
                          min_ctas: int = 1) -> tuple[int, int, int]:
    """cluster_layout with the current card's SMs and the clusters it holds
    at once: the layout gotoh_forward_launch picks there."""
    props = torch.cuda.get_device_properties(device or torch.cuda.current_device())
    return cluster_layout(
        B, Ls, free_end1, props.multi_processor_count, min_ctas=min_ctas,
        held=lambda n, W, K: cluster_occupancy(n, W, K, free_start1, free_end1))


def wide_layout(Ls: int) -> tuple[int, int]:
    """(columns a thread C, threads a block) of the wide kernel at Ls, as
    gotoh_forward_launch computes them."""
    C = -(-Ls // WIDE_THREADS)
    return C, -(-(-(-Ls // C)) // 32) * 32


def kernel_for(Ls: int) -> str:
    """The kernel gotoh_forward_plane launches at subject width Ls."""
    if Ls <= WARP_KERNEL_MAX_LS:
        return "warp"
    if Ls <= SEG_MAX_LS:
        return "seg"
    return "cluster" if Ls <= CLUSTER_MAX_LS else "wide"


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


def _check_args(query, qlen, subject, slen, free_end1, free_end2):
    """Shapes, types and devices both versions take; raises otherwise."""
    if query.dim() != 2 or subject.dim() != 2:
        raise ValueError("query and subject must be (B, L) matrices")
    B = query.shape[0]
    if subject.shape[0] != B or qlen.shape != (B,) or slen.shape != (B,):
        raise ValueError("query/subject/qlen/slen batch sizes differ")
    if query.dtype != torch.int8 or subject.dtype != torch.int8:
        raise TypeError("query and subject must be int8 codes")
    if subject.shape[1] < 1:
        raise ValueError("the kernels need a subject width of at least 1")
    if any(t.device != query.device for t in (subject, qlen, slen)):
        raise ValueError("all inputs must lie on one device")
    if free_end1 and free_end2:
        raise ValueError("free_end1 with free_end2 unsupported")


def _launch(query, qlen, subject, slen, cfg, kernel: str | None):
    """Launch csrc/gotoh_forward.cu on checked CUDA tensors (kernel by Ls,
    or the "seg", "wide" or "cluster" kernel when asked, the last in
    clusters of the layout's size among two to eight) or raise."""
    dev = query.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    B, Lq = query.shape
    Ls = subject.shape[1]
    if kernel == "seg" and Ls > SEG_MAX_LS:
        raise ValueError(f"the seg kernel takes Ls <= {SEG_MAX_LS}, got {Ls}")
    code = _KERNEL_CODES[kernel]
    if kernel == "cluster":
        if Ls <= WARP_KERNEL_MAX_LS:
            raise ValueError(f"the cluster kernel takes Ls > {WARP_KERNEL_MAX_LS}, got {Ls}")
        with torch.cuda.device(dev):
            code |= device_cluster_layout(B, Ls, bool(cfg["free_start1"]),
                                          bool(cfg["free_end1"]), dev, min_ctas=2)[0] << 8
    name = kernel or kernel_for(Ls)
    query = query.contiguous()
    subject = subject.contiguous()
    qlen = qlen.to(torch.int32).contiguous()
    slen = slen.to(torch.int32).contiguous()
    plane = torch.empty((Lq, B, Ls), dtype=torch.int32, device=dev)
    fin = torch.empty((4, B), dtype=torch.int32, device=dev)
    scratch = None
    if name == "wide":
        C, threads = wide_layout(Ls)
        scratch = torch.empty(B * WIDE_FIELDS * C * threads, dtype=torch.int32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gotoh_forward_launch(
            query.data_ptr(), qlen.data_ptr(), subject.data_ptr(),
            slen.data_ptr(), plane.data_ptr(), fin[0].data_ptr(),
            fin[1].data_ptr(), fin[2].data_ptr(), fin[3].data_ptr(),
            B, Lq, Ls, cfg["match"], cfg["mismatch"], cfg["open_gap"],
            cfg["ext_gap"], int(cfg["free_start1"]), int(cfg["free_end1"]),
            int(cfg["free_start2"]), int(cfg["free_end2"]),
            code, None if scratch is None else scratch.data_ptr(),
            stream,
        )
    check("gotoh_forward", rc)
    gotoh_forward_plane.launches += 1
    gotoh_forward_plane.launch_shapes[(
        tuple(bool(cfg[f]) for f in FREE_END_FLAGS), B, Lq, Ls, name,
    )] += 1
    # the kernels write end_i only with a free query end; else it is qlen
    end_i = fin[1] if cfg["free_end1"] else qlen
    return plane, fin[0], end_i, fin[2], fin[3]


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
    """Forward Gotoh pass, same contract as gotoh_forward_plane_ref, for
    int8 codes and Ls >= 1.  The (Lq, B, Ls) int32 plane is the memory to
    budget: 1.34 GB at B 256, Lq 160, Ls 8,192.

    CPU tensors run the plain version.  CUDA tensors launch a CUDA kernel
    (every free-end configuration: free subject ends for the tier-3 aligner,
    free query ends for the tier-2 STR flanks) or raise: the
    warp-per-alignment kernel for Ls <= 256, the seg kernel up to
    SEG_MAX_LS, the cluster kernel up to CLUSTER_MAX_LS, the wide kernel
    above, a dispatch on the shape alone."""
    cfg = dict(
        match=match, mismatch=mismatch, open_gap=open_gap, ext_gap=ext_gap,
        free_start1=free_start1, free_end1=free_end1,
        free_start2=free_start2, free_end2=free_end2,
    )
    _check_args(query, qlen, subject, slen, free_end1, free_end2)
    if query.device.type == "cpu":
        return gotoh_forward_plane_ref(query, qlen, subject, slen, **cfg)
    return _launch(query, qlen, subject, slen, cfg, kernel=None)


gotoh_forward_plane.launches = 0  # launches of any of the kernels
# the same launches by ((free_start1, free_end1, free_start2, free_end2), B,
# Lq, Ls, "warp", "seg", "cluster" or "wide"): what a path asked of which
# kernel
gotoh_forward_plane.launch_shapes = Counter()


def _forced(kernel, query, qlen, subject, slen, **cfg):
    cfg = dict(dict(match=1, mismatch=1, open_gap=3, ext_gap=1,
                    free_start1=False, free_end1=False,
                    free_start2=True, free_end2=True), **cfg)
    _check_args(query, qlen, subject, slen, cfg["free_end1"], cfg["free_end2"])
    return _launch(query, qlen, subject, slen, cfg, kernel=kernel)


def gotoh_forward_plane_seg(query, qlen, subject, slen, **cfg):
    """The seg kernel at any Ls <= SEG_MAX_LS, CUDA tensors only: lets a
    check reach it at shapes that gotoh_forward_plane gives to the warp
    kernel (seg_layout: one or two warps, 4-8 columns a lane).  Same
    keywords as gotoh_forward_plane."""
    return _forced("seg", query, qlen, subject, slen, **cfg)


def gotoh_forward_plane_wide(query, qlen, subject, slen, **cfg):
    """The wide kernel at any Ls, CUDA tensors only (a check at the
    narrow shapes of the other two kernels)."""
    return _forced("wide", query, qlen, subject, slen, **cfg)


def gotoh_forward_plane_cluster(query, qlen, subject, slen, **cfg):
    """The cluster kernel at any Ls > 256, CUDA tensors only, in clusters
    of the layout rule's size among two to eight: lets a check reach it
    at the seg kernel's widths and hold it across a block boundary where
    the rule would take one block.  Same keywords as gotoh_forward_plane."""
    return _forced("cluster", query, qlen, subject, slen, **cfg)


def cluster_occupancy(N: int, W: int, K: int, free_start1: bool = False,
                      free_end1: bool = False) -> int:
    """Clusters of N blocks of W warps (K columns a lane) of the cluster
    kernel's variant that the current card holds at once
    (cudaOccupancyMaxActiveClusters)."""
    import ctypes

    out = ctypes.c_int(0)
    check("gotoh_cluster_occupancy", library().gotoh_cluster_occupancy(
        N, W, K, int(free_start1), int(free_end1), ctypes.addressof(out)))
    return out.value
