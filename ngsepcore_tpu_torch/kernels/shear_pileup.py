"""Scatter-free pileup accumulation: shear + per-position histogram.

Ref behavior being replaced: AlignmentsPileupGenerator.java:377-403 walks
one alignment at a time and SingleSampleVariantPileupListener counts each
base call into per-position allele/quality tallies.

Reads are compacted once per run into genome-oriented "col byte" rows
(call/fused_pipeline.py, build_colg below):

    colg[r, o] = col | (strand << 7)        (uint8)

where o indexes GENOME offsets from the read's predicted start (reverse
reads are flipped and complemented at compaction), and col is the count
column: al*nq + qbin for a usable SNV base call, COL_N for N bases,
COL_LOW for base quality <= 3 (CountsHelper.java:214-218), 127 for lanes
outside the aligned span.  nq is the number of DISTINCT clamped base
qualities in the run, so the column space is exact and narrow.

Rank-0 rows (first read at each start position) are row-scattered into a
position-indexed stage and transposed once per genome chunk:

    stage_T[o, HALO + s - chunk0] = colg[row starting at s][o]   else 0xFF

so the per-position histogram is a SHEAR: position p receives lane o of
the read starting at p - o.  `shear_hist` computes it with the CUDA
kernel csrc/shear_hist.cu on the card and `shear_hist_ref` on the CPU.

Reads beyond rank 0 at a start position (rare) and host-path packed calls
are added afterwards with small scatters.
"""
from __future__ import annotations

import torch

from .cuda_build import check, library

# combined output layout (W, 128): count columns first, strand counts last
STRAND_COL0 = 120  # strand counts at cols 120..127: al*2 + strand
COL_INVALID = 127  # col bits of an empty stage byte (0xFF & 127)
MIN_BASE_QS_SP = 3  # CountsHelper.java:214-216 (mirrors genotyping.MIN_BASE_QS)


def col_layout(nq: int) -> tuple[int, int, int]:
    """(COL_N, COL_LOW, n_count_cols) for an nq-bin column space."""
    return 4 * nq, 4 * nq + 1, 4 * nq + 2


def _check_shear_args(stage_t, w0s, window, nq, lanes):
    if stage_t.dtype != torch.uint8 or stage_t.dim() != 2:
        raise TypeError("stage_t must be a (lanes, S) uint8 tensor")
    if not 1 <= nq <= 29:
        raise ValueError(f"nq={nq} outside 1..29 (7-bit stage columns)")
    if stage_t.shape[0] < lanes:
        raise ValueError(f"stage has {stage_t.shape[0]} rows < lanes={lanes}")
    S = stage_t.shape[1]
    if w0s < lanes - 1 or w0s + window > S:
        raise ValueError(
            f"window [{w0s}, {w0s + window}) with halo {lanes - 1} "
            f"outside the stage's {S} columns"
        )


def shear_hist_ref(stage_t: torch.Tensor, w0s: int, *, window: int, nq: int,
                   lanes: int) -> torch.Tensor:
    """Plain PyTorch shear histogram (the semantics of the Pallas kernel
    and of ngsepcore_tpu's `_shear_hist_xla`): for each lane o, the
    (window,) slice stage_t[o, w0s-o : w0s-o+window] adds one count to its
    count column and, for SNV bytes, one to its strand column.
    Returns (window, 128) int32."""
    _check_shear_args(stage_t, w0s, window, nq, lanes)
    dev = stage_t.device
    col_n, col_low, ncnt = col_layout(nq)
    trash = ncnt + 8  # sentinel column for bytes that count nowhere
    acc = torch.zeros((window, trash + 1), dtype=torch.int32, device=dev)
    ones = torch.ones((window, 1), dtype=torch.int32, device=dev)
    for o in range(lanes):
        v = stage_t[o, w0s - o : w0s - o + window].to(torch.int64)
        col = v & 127
        al = (col >= nq).long() + (col >= 2 * nq).long() + (col >= 3 * nq).long()
        scol = torch.where(col < 4 * nq, ncnt + al * 2 + (v >> 7), trash)
        ccol = torch.where(col < ncnt, col, trash)
        acc.scatter_add_(1, ccol[:, None], ones)
        acc.scatter_add_(1, scol[:, None], ones)
    out = torch.zeros((window, 128), dtype=torch.int32, device=dev)
    out[:, :ncnt] = acc[:, :ncnt]
    out[:, STRAND_COL0:] = acc[:, ncnt : ncnt + 8]
    return out


def shear_hist(stage_t: torch.Tensor, w0s: int, *, window: int, nq: int,
               lanes: int) -> torch.Tensor:
    """Combined (window, 128) int32 count tensor: cols [0, 4*nq+2) are
    allele-by-quality-bin counts (+N +low), cols 120..127 strand counts.
    CPU tensors run shear_hist_ref; CUDA tensors launch the kernel."""
    if stage_t.device.type == "cpu":
        return shear_hist_ref(stage_t, w0s, window=window, nq=nq, lanes=lanes)
    if stage_t.device.type != "cuda":
        raise ValueError(f"unsupported device {stage_t.device}")
    w0s = int(w0s)
    _check_shear_args(stage_t, w0s, window, nq, lanes)
    stage_t = stage_t.contiguous()
    dev = stage_t.device
    out = torch.empty((window, 128), dtype=torch.int32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.shear_hist_launch(
            stage_t.data_ptr(), stage_t.shape[1], w0s, window, nq, lanes,
            out.data_ptr(), stream,
        )
    check("shear_hist", rc)
    shear_hist.launches += 1
    return out


shear_hist.launches = 0


def concat_reads(*parts: torch.Tensor, lanes: int) -> torch.Tensor:
    """Concatenate per-batch packed-read matrices, trimmed/padded to a
    common lane width."""
    padded = []
    for p in parts:
        p = p[:, :lanes]
        if p.shape[1] < lanes:
            p = torch.nn.functional.pad(p, (0, lanes - p.shape[1]))
        padded.append(p)
    return torch.cat(padded, dim=0)


def build_colg(
    pq: torch.Tensor,  # (R, >=lanes) uint8 packed code|qual<<3, READ orientation
    rev: torch.Tensor,  # (R,) uint8 1 = reverse strand
    alo: torch.Tensor,  # (R,) int32 valid genome-offset lane range [alo, ahi)
    ahi: torch.Tensor,  # (R,) int32 (0,0 marks rows that never contribute)
    thresholds: torch.Tensor,  # (nq,) int32 sorted distinct clamped qualities
    *,
    nq: int,
    lanes: int,
) -> torch.Tensor:
    """Genome-oriented col bytes for every read row, all elementwise.

    Reverse reads are complemented and flipped with ONE full-width reverse:
    lane a of the flipped row holds genome offset a - (lanes-len), which
    callers absorb into the adjusted start pred' = pred - (lanes-len).
    Bounds are therefore expressed in flipped array space: fwd (cs, len-ce),
    rev (lanes-len+ce, lanes-cs)."""
    dev = pq.device
    b = pq[:, :lanes]
    c = (b & 7).to(torch.int32)
    q = (b >> 3).to(torch.int32)
    rv = (rev > 0)[:, None]
    al = torch.where(rv & (c < 4), 3 - c, c)
    qbin = torch.zeros_like(q)
    for k in range(1, nq):
        qbin += (q >= thresholds[k]).to(torch.int32)
    low = q <= MIN_BASE_QS_SP
    col_n, col_low, ncnt = col_layout(nq)
    col = torch.where(low, col_low, torch.where(c < 4, al * nq + qbin, col_n))
    byte = (col | (rev.to(torch.int32)[:, None] << 7)).to(torch.uint8)
    byte = torch.where(rv, torch.flip(byte, dims=[1]), byte)
    a = torch.arange(lanes, dtype=torch.int32, device=dev)[None, :]
    ok = (a >= alo[:, None]) & (a < ahi[:, None])
    return torch.where(ok, byte, 255).to(torch.uint8)


def build_stage(
    colg: torch.Tensor,  # (R, Lp) uint8 col bytes
    rows: torch.Tensor,  # (Rb,) int64 rank-0 row indices
    pos: torch.Tensor,  # (Rb,) int64 stage column of each row (distinct)
    *,
    s_cols: int,
) -> torch.Tensor:
    """Position-indexed stage, transposed to a contiguous (Lp, s_cols) so
    the shear kernel's slices are lane-contiguous.  Row-granular scatter:
    cost scales with the number of reads, not genome length."""
    stage = torch.full((s_cols, colg.shape[1]), 255, dtype=torch.uint8,
                       device=colg.device)
    stage[pos] = colg[rows]
    return stage.t().contiguous()


def hist_residual_scatter(
    hist: torch.Tensor,  # (W, 128) int32 combined counts (updated in place)
    colg_rows: torch.Tensor,  # (R, Lp) uint8 residual reads, genome-oriented
    pred_rel: torch.Tensor,  # (R,) int32 start relative to window (may be <0)
    nq: int,
) -> torch.Tensor:
    """Rank>=1 reads (same predicted start as an earlier read): bounded
    scatter onto the combined tensor, in place."""
    W = hist.shape[0]
    col_n, col_low, ncnt = col_layout(nq)
    v = colg_rows.to(torch.int64)
    col = v & 127
    o = torch.arange(colg_rows.shape[1], dtype=torch.int64, device=hist.device)
    pos = pred_rel.to(torch.int64)[:, None] + o[None, :]
    ok = (col != COL_INVALID) & (pos >= 0) & (pos < W)
    pos = torch.where(ok, pos, 0)
    al = (col >= nq).long() + (col >= 2 * nq).long() + (col >= 3 * nq).long()
    snv = ok & (col < 4 * nq)
    ccol = torch.where(col < ncnt, col, 0)
    hist.index_put_((pos, ccol), ok.to(torch.int32), accumulate=True)
    scol = STRAND_COL0 + al * 2 + (v >> 7)
    hist.index_put_(
        (pos, torch.where(snv, scol, 0)), snv.to(torch.int32), accumulate=True
    )
    return hist


def hist_packed_scatter(
    hist: torch.Tensor,  # (W, 128) int32 combined counts (updated in place)
    packed: torch.Tensor,  # (N,) int32 packed host calls (-1 = skip):
    # bits 0-19 pos, 20-24 qual (clamped 0..30), 25-27 allele, 28 strand
    qual_bin: torch.Tensor,  # (31,) int64 quality -> bin map
    nq: int,
    min_base_q: int,
) -> torch.Tensor:
    """Host-path allele calls onto the combined tensor, in place."""
    col_n, col_low, ncnt = col_layout(nq)
    packed = packed.to(torch.int64)
    ok = packed >= 0
    rel = packed & 0xFFFFF
    q = (packed >> 20) & 31
    al = (packed >> 25) & 7
    st = (packed >> 28) & 1
    low = q <= min_base_q
    qb = qual_bin[torch.clamp(q, 0, 30)]
    pos = torch.where(ok, rel, 0)
    col = torch.where(low, col_low, torch.where(al < 4, al * nq + qb, col_n))
    hist.index_put_((pos, col), ok.to(torch.int32), accumulate=True)
    snv = ok & ~low & (al < 4)
    scol = STRAND_COL0 + torch.clamp(al, max=3) * 2 + st
    hist.index_put_(
        (pos, torch.where(snv, scol, 0)), snv.to(torch.int32), accumulate=True
    )
    return hist
