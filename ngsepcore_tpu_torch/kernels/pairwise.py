"""Batched affine-gap (Gotoh) pairwise alignment on device: the tier-3 DP.

Ref: src/ngsep/alignments/PairwiseAlignerAffineGap.java:29-292 — 3-matrix
Gotoh with match=+1 mismatch=-1 openGap=3 extGap=1 (subtracted), "force"
flags for free subject ends, and a deterministic traceback preference order
(M then I then D, PairwiseAlignerAffineGap.java:228-259).

The forward pass (kernels/pairwise_cuda.gotoh_forward_plane: the CUDA
kernel on the card, its plain version on the CPU) emits a packed
run/pointer plane; a run-jump traceback walks it emitting one CIGAR run
per step.  On the card one launch of csrc/run_walk.cu walks and, by its
mode, returns the runs (_runs_from_plane), or the tier-3 statistics with
left-aligned gap runs (tier3_walk_stats), or the long-read segment
statistics (segment_walk_stats); on the CPU the plain walk
(_runs_from_plane_ref) and the plain post-passes (dp_stats_runs,
dp_stats_runs_hamming) compute the same.  The tier-2 STR flanks
(align/str_tier2.py) take per-column ops from the runs
(affine_gap_align_batch); tier 3 the statistics (dp_run_all); the
long-read segments the Hamming-style statistics (dp_run_segments).  Every integer
tensor here has its dtype written out; the plane is int32 holding uint32
bits, so every right shift is masked.
"""
from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from .cuda_build import check, library
from .pairwise_cuda import gotoh_forward_plane

# alignment ops emitted by traceback
OP_NONE = 0
OP_MATCH = 1  # diagonal (match or mismatch)
OP_INS = 2  # query base consumed, gap in subject (CIGAR I)
OP_DEL = 3  # subject base consumed, gap in query (CIGAR D)

LA_LMAX = 16  # max indel length left-aligned on device; longer runs (and
# RLE overflows) raise la_fallback and the host runs the exact pass

_I32 = torch.int32

# the plain run-jump walk asks whether every row is done from this step on,
# every so many steps: the tier-3 budget (28 steps for 160 rows) never gets
# there, the tier-2 one (Lq + Ls) ends after a few asks
WALK_CHECK_FROM = 32
WALK_CHECK_EVERY = 8


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


def affine_gap_align_batch(
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
):
    """Gotoh alignment emitting one op per alignment column, the contract
    of ngsepcore_tpu.kernels.pairwise.affine_gap_align_batch (the tier-2
    STR flank aligners, ShortReadsUngappedSearchHitsClusterAligner.java
    :338-349, use it with free QUERY ends).

    The forward pass is the same plane as affine_gap_align_runs (the CUDA
    kernel on the card); the ops are the run-jump walk's runs expanded, with
    a walk budget of Lq + Ls runs, which no path exceeds, so the walk is
    exact.  With free_end1 the unaligned query tail [end_i, qlen) is NOT
    emitted; with free_start1 the unaligned head IS, as leading OP_INS.

    Returns dict with:
      score   (B,) int32
      ops     (B, Lq+Ls) uint8 — forward order, the first n_ops entries;
              OP_NONE after them
      n_ops   (B,) int32
      start_j (B,) int32 — 0-based subject offset where the alignment begins
      end_j   (B,) int32 — 0-based subject offset one past its end
      end_i   (B,) int32 — query length consumed (== qlen unless free_end1)
    """
    B, Lq = query.shape
    Ls = subject.shape[1]
    out = affine_gap_align_runs(
        query, qlen, subject, slen,
        match=match, mismatch=mismatch, open_gap=open_gap, ext_gap=ext_gap,
        free_start1=free_start1, free_end1=free_end1,
        free_start2=free_start2, free_end2=free_end2,
        walk_runs=Lq + Ls,
    )
    # expand (rop, rlen) into per-column ops: column t belongs to the run
    # whose cumulative length first exceeds t
    ends = torch.cumsum(out["rlen"], dim=1, dtype=_I32)
    t = torch.arange(Lq + Ls, dtype=_I32, device=query.device)[None, :]
    run_of = torch.searchsorted(ends, t.expand(B, -1).contiguous(), right=True)
    run_of = torch.clamp(run_of, max=ends.shape[1] - 1)
    ops = torch.where(t < out["n_ops"][:, None], out["rop"].gather(1, run_of), OP_NONE)
    return {
        "score": out["score"],
        "ops": ops.to(torch.uint8),
        "n_ops": out["n_ops"],
        "start_j": out["start_j"],
        "end_j": out["end_j"],
        "end_i": out["end_i"],
    }


def ops_to_cigar_and_strings(
    ops: np.ndarray, n_ops: int, query: np.ndarray, subject: np.ndarray, start_j: int
) -> tuple[list[tuple[int, str]], int]:
    """Host: run-length encode ops into CIGAR tuples and count mismatches.

    Mismatch counting follows the reference's countMismatches(String[])
    (ShortReadsUngappedSearchHitsClusterAligner.java:140-156): +1 per
    mismatched pair, +2 per *internal* gap run (leading/trailing free).
    Returns ([(length, op_char)...], mismatches).
    """
    ops = ops[:n_ops]
    cigar: list[tuple[int, str]] = []
    mismatches = 0
    qi = 0
    sj = start_j
    last_is_gap = True
    for op in ops:
        ch = "M" if op == OP_MATCH else ("I" if op == OP_INS else "D")
        if cigar and cigar[-1][1] == ch:
            cigar[-1] = (cigar[-1][0] + 1, ch)
        else:
            cigar.append((1, ch))
        if op == OP_MATCH:
            if query[qi] != subject[sj]:
                mismatches += 1
            qi += 1
            sj += 1
            last_is_gap = False
        else:
            if not last_is_gap:
                mismatches += 2
            last_is_gap = True
            if op == OP_INS:
                qi += 1
            else:
                sj += 1
    if last_is_gap and cigar:
        mismatches -= 2
    return cigar, mismatches


WALK_MODES = {"runs": 0, "tier3": 1, "hamming": 2}  # csrc/run_walk.cu's Mode


def _walk_launch(mode, plane, score, end_i, end_j, start_k, B, R, free_start2,
                 query=None, subject=None):
    """Launch csrc/run_walk.cu in `mode` (WALK_MODES; query and subject
    for "tier3" only) on CUDA tensors: one launch, no host sync.  Returns
    {name: tensor} of what the mode writes (the kernel's header): "runs"
    rop, rlen (B, R) int32, n_runs, n_ops, start_j (B,) int32, walk_ok
    (B,) bool; "tier3" mism, n_runs, n_ops, start_j (B,) int32, rle (B, R)
    int16, has_gap, la_fallback (B,) int8; "hamming" rle, n_runs, mism,
    start_j, walk_ok.  Only these are allocated, beside the (B, R) rop and
    rlen rows in which the other two modes merge their runs."""
    dev = plane.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if plane.dim() != 3 or plane.dtype != _I32 or plane.shape[1] != B:
        raise ValueError("plane must be an int32 (Lq, B, Ls) tensor")
    Lq, Ls = plane.shape[0], plane.shape[2]
    vecs = [t.to(_I32).contiguous() for t in (end_i, end_j, start_k, score)]
    if any(t.shape != (B,) or t.device != dev for t in vecs):
        raise ValueError("end_i, end_j, start_k and score must be (B,) on the plane's device")
    codes = [None, None]
    if mode == "tier3":
        codes = [x.to(torch.int8).contiguous() for x in (query, subject)]
        if (codes[0].shape != (B, Lq) or codes[1].shape != (B, Ls)
                or any(x.device != dev for x in codes)):
            raise ValueError("query and subject must be (B, Lq) and (B, Ls) on the plane's device")
    plane = plane.contiguous()
    new = lambda shape, dtype=_I32: torch.empty(shape, dtype=dtype, device=dev)
    rop, rlen = new((B, R)), new((B, R))
    out = {"n_runs": new(B), "start_j": new(B)}
    if mode != "hamming":
        out["n_ops"] = new(B)
    if mode != "tier3":
        out["walk_ok"] = new(B, torch.bool)
    if mode != "runs":
        out["mism"] = new(B)
        out["rle"] = new((B, R), torch.int16)
    if mode == "tier3":
        out["has_gap"] = new(B, torch.int8)
        out["la_fallback"] = new(B, torch.int8)
    ptr = lambda name: out[name].data_ptr() if name in out else None
    if B:
        lib = library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.run_walk_launch(
                plane.data_ptr(), *(v.data_ptr() for v in vecs),
                *(None if x is None else x.data_ptr() for x in codes),
                B, Lq, Ls, R, int(free_start2), WALK_MODES[mode],
                rop.data_ptr(), rlen.data_ptr(), ptr("n_runs"), ptr("n_ops"),
                ptr("start_j"), ptr("walk_ok"), ptr("mism"), ptr("rle"),
                ptr("has_gap"), ptr("la_fallback"), stream,
            )
        check("run_walk", rc)
        _runs_from_plane.launches += 1
        _runs_from_plane.launch_shapes[(mode, B, Lq, Ls, R, bool(free_start2))] += 1
    if mode == "runs":
        out.update(rop=rop, rlen=rlen)
    return out


def _runs_from_plane(plane, score, end_i, end_j, start_k, B, R, free_start2):
    """Run-jump traceback + merge over a (Lq, B, Ls) int32 pointer/run
    plane, R steps at most.  CPU tensors run the plain version
    (_runs_from_plane_ref); CUDA tensors launch csrc/run_walk.cu (one
    thread an alignment, no host sync) or raise.  Returns the dict of
    affine_gap_align_runs."""
    if plane.device.type == "cpu":
        return _runs_from_plane_ref(plane, score, end_i, end_j, start_k, B, R, free_start2)
    out = _walk_launch("runs", plane, score, end_i, end_j, start_k, B, R, free_start2)
    return dict(out, score=score.to(_I32), end_j=end_j.to(_I32), end_i=end_i.to(_I32))


# launches of csrc/run_walk.cu in every mode (_runs_from_plane,
# tier3_walk_stats, segment_walk_stats)
_runs_from_plane.launches = 0
# the same by (mode, B, Lq, Ls, R, free_start2)
_runs_from_plane.launch_shapes = Counter()


def tier3_walk_stats(plane, score, end_i, end_j, start_k, B, R, query, subject,
                     free_start2=True):
    """The walk and the tier-3 statistics in one step: the dict of
    dp_stats_runs.  CPU tensors run the plain composite,
    dp_stats_runs(_runs_from_plane_ref(...), query, subject); CUDA tensors
    launch csrc/run_walk.cu's tier-3 epilogue (walk, statistics and
    left-alignment in one launch, no host sync) or raise."""
    if plane.device.type == "cpu":
        out = _runs_from_plane_ref(plane, score, end_i, end_j, start_k, B, R, free_start2)
        return dp_stats_runs(out, query, subject)
    return _walk_launch("tier3", plane, score, end_i, end_j, start_k, B, R, free_start2,
                        query, subject)


def segment_walk_stats(plane, score, end_i, end_j, start_k, B, R, free_start2):
    """The walk and the long-read segment statistics in one step: the dict
    of dp_stats_runs_hamming.  CPU tensors run the plain composite,
    dp_stats_runs_hamming(_runs_from_plane_ref(...)); CUDA tensors launch
    csrc/run_walk.cu's hamming epilogue (no host sync) or raise."""
    if plane.device.type == "cpu":
        return dp_stats_runs_hamming(
            _runs_from_plane_ref(plane, score, end_i, end_j, start_k, B, R, free_start2))
    out = _walk_launch("hamming", plane, score, end_i, end_j, start_k, B, R, free_start2)
    return dict(out, end_j=end_j.to(_I32))


def _runs_from_plane_ref(plane, score, end_i, end_j, start_k, B, R, free_start2):
    """Plain version of _runs_from_plane on the tensors' device.  Each step
    reads one plane cell per row: the current matrix's run length
    (saturated runs jump 254 cells and continue in the same matrix) and the
    pointer to the matrix the run came from.  The walk stops early once
    every row is done (WALK_CHECK_FROM, WALK_CHECK_EVERY; a host sync on
    CUDA); the steps left would emit nothing."""
    dev = plane.device
    emit_lead_del = not free_start2
    bb = torch.arange(B, device=dev)
    i = end_i.to(_I32)
    j = end_j.to(_I32)
    k = start_k.to(_I32)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    lns, ops = [], []
    for step in range(R):
        if step >= WALK_CHECK_FROM and step % WALK_CHECK_EVERY == 0 and bool(
            (done | ((i == 0) & ((j == 0) | (not emit_lead_del)))).all()
        ):
            break
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
    if len(lns) < R:
        zero = torch.zeros(B, dtype=_I32, device=dev)
        lns.extend([zero] * (R - len(lns)))
        ops.extend([zero] * (R - len(ops)))
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


def plane_from_runs(rows, Lq, Ls):
    """The inverse of the walk, for tests: a (Lq, B, Ls) plane that the
    walk turns into given runs.  rows is a list of (forward runs [(op,
    length)], subject start).  Each run's last cell holds its length in
    its matrix's field (255, a saturated piece, for every 254 cells past
    the first 254) and, in the pointer field, the matrix of the run
    before it; every other cell is 0.  Returns plane (int32 holding uint32
    bits), end_i, end_j, start_k as CPU tensors."""
    B = len(rows)
    plane = np.zeros((Lq, B, Ls), np.uint32)
    ends = np.zeros((3, B), np.int32)
    for b, (runs, sj) in enumerate(rows):
        i = sum(ln for op, ln in runs if op in (OP_MATCH, OP_INS))
        j = sj + sum(ln for op, ln in runs if op in (OP_MATCH, OP_DEL))
        ends[:, b] = i, j, runs[-1][0] - 1
        for idx in range(len(runs) - 1, -1, -1):
            op, left = runs[idx]
            k = op - 1
            src = runs[idx - 1][0] - 1 if idx else 0
            while left > 0 and i > 0 and j > 0:
                field = 255 if left > 254 else left
                piece = min(left, 254)
                w = int(plane[i - 1, b, j - 1]) | (field << (8 * k + 8))
                if field != 255:
                    w |= src << (2 * k)
                plane[i - 1, b, j - 1] = w
                i -= piece if op in (OP_MATCH, OP_INS) else 0
                j -= piece if op in (OP_MATCH, OP_DEL) else 0
                left -= piece
    return (torch.from_numpy(plane.view(np.int32)),) + tuple(
        torch.from_numpy(e.copy()) for e in ends)


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


RLE_MAX = 16  # CIGAR runs a row in dp_stats_pack's RLE (mism <= 0.1*len caps
# gap runs at ~7); n_runs reports overflow and la_fallback flags the row


def dp_stats_pack(ops, n_ops, start_j, score, query, subject):
    """Post-pass over affine_gap_align_batch's per-column ops, plain
    PyTorch on the tensors' device (counterpart of
    ngsepcore_tpu/kernels/pairwise.py:dp_stats_pack, which only an entry
    script calls there; the port's paths take dp_stats_runs on the walk's
    runs instead).

    Per row: the tier-3 mismatch statistic (+1 per mismatched pair, +2 per
    internal gap run, -2 when the alignment ends in a gap —
    ShortReadsUngappedSearchHitsClusterAligner.java:140-156) from the score
    decomposition of the tier-3 costs (match +1, mismatch -1, open 3,
    ext 1: neq = (#M - score - 2*K_runs - gap_len) / 2), a gap flag, the
    ops 2-bit-packed 16 a uint32, and the left-aligned RLE of the op runs
    ((op | len<<2) as int16, RLE_MAX slots)."""
    B, S = ops.shape
    dev = ops.device
    col = torch.arange(S, dtype=_I32, device=dev)[None, :]
    n_ops = n_ops.to(_I32)
    valid = col < n_ops[:, None]
    m = (ops == OP_MATCH) & valid
    g = ((ops == OP_INS) | (ops == OP_DEL)) & valid
    z = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    run_start = g & ~torch.cat([z, g[:, :-1]], dim=1)
    m_cnt = m.sum(dim=1, dtype=_I32)
    gap_len = g.sum(dim=1, dtype=_I32)
    k_all = run_start.sum(dim=1, dtype=_I32)
    sub_mm = (m_cnt - score - 2 * k_all - gap_len) >> 1
    after_m = torch.cat([z, m[:, :-1]], dim=1)
    k_runs = (run_start & after_m).sum(dim=1, dtype=_I32)
    last_op = ops.gather(1, (n_ops - 1).clamp(min=0).long()[:, None])[:, 0]
    ends_gap = (n_ops > 0) & ((last_op == OP_INS) | (last_op == OP_DEL))
    mism = sub_mm + 2 * k_runs - 2 * ends_gap.to(_I32)
    has_gap = g.any(dim=1).to(torch.int8)
    o = torch.nn.functional.pad(ops.to(torch.int64), (0, (-S) % 16)).reshape(B, -1, 16)
    sh = 2 * torch.arange(16, dtype=torch.int64, device=dev)
    packed = (o << sh).sum(dim=2).to(torch.uint32)  # disjoint bit fields: sum = or
    prev = torch.cat([torch.full((B, 1), 255, dtype=ops.dtype, device=dev), ops[:, :-1]], dim=1)
    is_start = valid & (ops != prev)
    rank = torch.cumsum(is_start.to(_I32), dim=1) - 1
    n_runs = is_start.sum(dim=1, dtype=_I32)
    starts = torch.stack(
        [torch.where(is_start & (rank == k), col, S).amin(dim=1) for k in range(RLE_MAX)],
        dim=1,
    ).to(_I32)
    starts = torch.where(starts == S, 0, starts)
    slot = torch.arange(RLE_MAX, dtype=_I32, device=dev)[None, :]
    nxt = torch.cat([starts[:, 1:], torch.zeros((B, 1), dtype=_I32, device=dev)], dim=1)
    end = torch.where(slot + 1 < n_runs[:, None], nxt, n_ops[:, None])
    rlen = torch.where(slot < n_runs[:, None], end - starts, 0).to(_I32)
    rop = ops.gather(1, starts.clamp(max=S - 1).long()).to(_I32)
    rlen, la_fallback = _left_align_rle(rop, rlen, n_runs, start_j, query, subject)
    rle = torch.where(slot < n_runs[:, None], rop | (rlen << 2), 0).to(torch.int16)
    return {
        "mism": mism,
        "has_gap": has_gap,
        "packed": packed,
        "rle": rle,
        "n_runs": n_runs,
        "n_ops": n_ops,
        "start_j": start_j,
        "la_fallback": la_fallback,
    }


def dp_stats_runs_hamming(out: dict):
    """Long-read segment stats from run-jump traceback output.  The
    long-read chain walk counts mismatches Hamming-style: +1 per mismatched
    pair and +1 per gap COLUMN (ref: HammingSequenceDistanceMeasure over
    aligned fragments, LongReadsUngappedSearchHitsClusterAligner.java
    :127-156), so mism = substitutions (score decomposition, tier-3 default
    scores) + gap columns, 30000 where the walk ran out of budget.
    Returns rle (int16, op | len<<2), n_runs, mism, start_j, end_j,
    walk_ok."""
    rop, rlen = out["rop"], out["rlen"]
    n_runs = out["n_runs"]
    B, R = rop.shape
    slot = torch.arange(R, dtype=_I32, device=rop.device)[None, :]
    valid = slot < n_runs[:, None]
    is_m = (rop == OP_MATCH) & valid
    is_gap = ((rop == OP_INS) | (rop == OP_DEL)) & valid
    m_cnt = torch.where(is_m, rlen, 0).sum(dim=1, dtype=_I32)
    gap_len = torch.where(is_gap, rlen, 0).sum(dim=1, dtype=_I32)
    k_all = is_gap.sum(dim=1, dtype=_I32)
    sub_mm = (m_cnt - out["score"] - 2 * k_all - gap_len) >> 1
    return {
        "rle": torch.where(valid, rop | (rlen << 2), 0).to(torch.int16),
        "n_runs": n_runs,
        "mism": torch.where(out["walk_ok"], sub_mm + gap_len, 30000),
        "start_j": out["start_j"],
        "end_j": out["end_j"],
        "walk_ok": out["walk_ok"],
    }


def dp_run_segments(
    readmat: torch.Tensor,  # (rows, Lp) int8 packed batch read rows (fwd + rev)
    concat: torch.Tensor,  # (G,) int8 concatenated genome codes
    rows: torch.Tensor,  # (B,) int32 read row per segment job
    q0: torch.Tensor,  # (B,) int32 query slice start within the row
    qlen: torch.Tensor,  # (B,) int32 query slice length
    sfirst: torch.Tensor,  # (B,) int32 subject window start (concat coords)
    slen: torch.Tensor,  # (B,) int32 subject window length
    *,
    CH: int,
    Lq: int,
    Ls: int,
    fs2: bool,
    fe2: bool,
):
    """Long-read segment sweep: every inter-anchor alignment of one bucket
    in CH-row chunks (the last one may be shorter).  Each chunk gathers
    its query slices readmat[row, q0:q0+qlen] and subject slices
    concat[sfirst:sfirst+slen] on the tensors' device (padding code 4),
    runs the Gotoh forward pass with free subject ends fs2/fe2 and
    segment_walk_stats (dp_stats_runs_hamming's dict; one walk launch a
    chunk on the card).  A chunk's plane (512 MiB at 512x512x512) is freed
    before the next chunk runs.  Returns the stats of all B jobs, concatenated."""
    dev = readmat.device
    Lp = readmat.shape[1]
    j = torch.arange(Lq, dtype=_I32, device=dev)[None, :]
    js = torch.arange(Ls, dtype=torch.int64, device=dev)[None, :]
    outs = []
    for off in range(0, rows.shape[0], CH):
        s = slice(off, off + CH)
        ql, sl = qlen[s], slen[s]
        sub = readmat[rows[s].long()]
        idx = torch.clamp(q0[s][:, None] + j, 0, Lp - 1).long()
        qc = torch.where(j < ql[:, None], sub.gather(1, idx), 4).to(torch.int8)
        sidx = torch.clamp(sfirst[s].long()[:, None] + js, 0, concat.shape[0] - 1)
        sc = torch.where(js < sl[:, None], concat[sidx], 4).to(torch.int8)
        fwd = gotoh_forward_plane(qc, ql, sc, sl, free_start2=fs2, free_end2=fe2)
        outs.append(segment_walk_stats(*fwd, qc.shape[0], _walk_runs_for(Lq), fs2))
        del fwd
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


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
    walk with its statistics and left-aligned RLE (tier3_stats).  Returns
    the stats dict with a leading chunk axis (n_chunks, CH, ...)."""
    outs = []
    for ci in range(n_chunks):
        s = slice(ci * CH, (ci + 1) * CH)
        qc, ln, sc = dp_gather_inputs(
            bigpq, lengths, concat, rows[s], strand[s], firsts[s], slen[s],
            Lq=Lq, Ls=Ls,
        )
        outs.append(tier3_stats(qc, ln, sc, slen[s]))
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def tier3_stats(query, qlen, subject, slen):
    """One tier-3 chunk: the Gotoh plane with free subject ends, then its
    walk, statistics and left-alignment (tier3_walk_stats: one walk launch
    on the card); the plane is freed on return.  Returns dp_stats_runs's
    dict."""
    fwd = gotoh_forward_plane(query, qlen, subject, slen, free_start2=True, free_end2=True)
    B, Lq = query.shape
    return tier3_walk_stats(*fwd, B, _walk_runs_for(Lq), query, subject)


def _brl_tables(x):
    """(B, LA_LMAX * L) int32 for codes x (B, L): for lag l (block l-1),
    the count of consecutive t' <= t with eq_l[t'] = x[t'] == x[t'+l],
    evaluated at every t; eq_l[t] is False where t + l >= L (every t when
    the lag reaches past the row)."""
    Bx, L = x.shape
    idxs = torch.arange(L, dtype=_I32, device=x.device)[None, :]
    tabs = []
    for l in range(1, LA_LMAX + 1):
        eq = torch.zeros((Bx, L), dtype=torch.bool, device=x.device)
        if l < L:
            eq[:, : L - l] = x[:, l:] == x[:, : L - l]
        nf = torch.where(eq, -1, idxs)
        tabs.append(idxs - torch.cummax(nf, dim=1).values)
    return torch.cat(tabs, dim=1)


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

    Lq = query.shape[1]
    Ls = subject.shape[1]
    lidx = torch.clamp(rlen, 1, LA_LMAX) - 1
    kq = _brl_tables(query).gather(
        1, (lidx * Lq + torch.clamp(pq - 1, 0, Lq - 1)).long()
    )
    kd = _brl_tables(subject).gather(
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
