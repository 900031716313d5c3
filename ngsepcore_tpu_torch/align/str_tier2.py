"""Tier-2 STR-aware split alignment.

Ref: ShortReadsUngappedSearchHitsClusterAligner.java:194-345 — when a
read's predicted ungapped span overlaps a known tandem repeat, the read is
split around the repeat: the left flank aligns with a free query END
(createAlignerLeftTR:338-342 sets forceEnd1=false), the right flank with a
free query START (createAlignerRightTR:344-349), and the composed alignment
spells the repeat-length difference as one indel between the flanks.  This
sits between the tier-1 ungapped screen and the tier-3 full DP: a found
repeat is tried FIRST (buildAlignment:71-80), and only a null result falls
through to the other tiers.

The reference runs two per-read DP objects; here all left flanks of a
batch run as batched Gotoh launches with a free query END (free_end1) and
all right flanks with a free query START (free_start1), on the aligner's
device: the CUDA kernel of csrc/gotoh_forward.cu on the card, its plain
version on the CPU (kernels/pairwise.affine_gap_align_batch).  Same
results as ngsepcore_tpu/align/str_tier2.py.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.sequences import pack_reads
from ..kernels.pairwise import affine_gap_align_batch, ops_to_cigar_and_strings
from .read_alignment import ReadAlignment

MIN_MATCH_LENGTH = 15  # ref: ShortReadsUngappedSearchHitsClusterAligner.java:41


def _merge_cigar(cigar: list[tuple[int, str]]) -> list[tuple[int, str]]:
    """Coalesce adjacent same-op runs after flank concatenation."""
    out: list[tuple[int, str]] = []
    for ln, op in cigar:
        if ln <= 0:
            continue
        if out and out[-1][1] == op:
            out[-1] = (out[-1][0] + ln, op)
        else:
            out.append((ln, op))
    return out


def find_tandem_repeat(regions: list, first: int, last: int):
    """Binary descent for a known STR overlapping [first, last] (ref
    findTandemRepeat:194-215 binaryContains — returns the region found by
    the descent, not necessarily the leftmost overlap)."""
    left, right = 0, len(regions) - 1
    while right >= left:
        middle = left + (right - left) // 2
        r = regions[middle]
        if r.first <= last and first <= r.last:
            return r
        if r.first > first:
            right = middle - 1
        else:
            left = middle + 1
    return None


class _Tier2Job:
    __slots__ = (
        "cand", "qcodes", "first", "region", "seq_idx",
        "left_idx", "right_idx", "end_read_segment", "start_read_segment",
        "left_ref_start",
    )

    def __init__(self, cand, qcodes, first, region, seq_idx):
        self.cand = cand
        self.qcodes = qcodes
        self.first = first  # 1-based within-sequence predicted start
        self.region = region
        self.seq_idx = seq_idx
        self.left_idx = -1
        self.right_idx = -1
        self.end_read_segment = 0
        self.start_read_segment = 0
        self.left_ref_start = 1


class Tier2STRAligner:
    """Batched verifyShortTandemRepeats over one read batch."""

    DP_ROWS = 256
    # most bytes of one launch's (rows, Lq, Ls) int32 Gotoh plane: a chunk
    # of long regions halves its rows until its plane fits (the rows of a
    # launch are independent, so the chunking changes no output)
    PLANE_CAP_BYTES = 1 << 30

    def __init__(self, genome, known_strs: dict[str, list], *, device):
        self.genome = genome
        self.device = torch.device(device)
        # per-sequence sorted region lists (detector convention)
        self.known_strs = known_strs or {}
        self._by_idx: dict[int, list] = {}
        for si in range(genome.num_sequences):
            lst = self.known_strs.get(genome.sequence_name(si))
            if lst:
                self._by_idx[si] = lst

    def has_strs(self, seq_idx: int) -> bool:
        return seq_idx in self._by_idx

    def region_for(self, seq_idx: int, first: int, last: int):
        lst = self._by_idx.get(seq_idx)
        if not lst:
            return None
        return find_tandem_repeat(lst, first, last)

    # ------------------------------------------------------------------
    def align_batch(self, jobs: list[_Tier2Job]) -> None:
        """Run every job's flank DPs in two batched kernels and compose;
        success sets job.cand.aln/quality, failure leaves cand.aln None.

        Deviation from the reference (documented): the reference sizes the
        flank windows from the hit cluster's predicted START AND END
        (UngappedSearchHitsCluster tracks both); the seeding pass
        exports only the collapsed start, which can sit on either flank's
        diagonal when the individual's repeat length differs from the
        reference's.  Both flank windows therefore get `region.length()`
        of slop on their OUTER side with a free outer subject end, which
        yields the same flank alignments for any repeat-length change up
        to one full region length."""
        left_jobs: list[tuple[_Tier2Job, np.ndarray, np.ndarray]] = []
        right_jobs: list[tuple[_Tier2Job, np.ndarray, np.ndarray]] = []
        for job in jobs:
            qlen = len(job.qcodes)
            region = job.region
            slop = region.last - region.first + 1
            first = job.first
            last = first + qlen - 1
            seq = self.genome.sequences[job.seq_idx].codes
            if first < region.first - 5:
                left_ref_start = max(first - slop, 1)  # 1-based
                job.left_ref_start = left_ref_start
                ref = seq[left_ref_start - 1 : region.first - 1]
                job.end_read_segment = min(qlen, region.first - first + 5 + slop)
                rd = job.qcodes[: job.end_read_segment]
                if len(ref) and len(rd):
                    job.left_idx = len(left_jobs)
                    left_jobs.append((job, rd, ref))
            if last > region.last + 5:
                right_ref_end = min(last + slop, len(seq))  # 1-based incl.
                ref = seq[region.last : right_ref_end]
                job.start_read_segment = max(
                    0, qlen - (last - region.last) - 5 - slop
                )
                rd = job.qcodes[job.start_read_segment :]
                if len(ref) and len(rd):
                    job.right_idx = len(right_jobs)
                    right_jobs.append((job, rd, ref))
        left_res = self._run_flank(left_jobs, side="left")
        right_res = self._run_flank(right_jobs, side="right")
        for job in jobs:
            self._compose(job, left_res, right_res)

    # ------------------------------------------------------------------
    def _run_flank(self, flank_jobs: list, side: str) -> list:
        """Batched Gotoh launches for one flank side, DP_ROWS jobs each, or
        fewer where the plane would pass PLANE_CAP_BYTES (one device->host
        fetch a chunk); returns per-job (cigar_ops, mismatches, soft_clip,
        ok).  Rows pad to a power of two from 32 and widths to multiples of
        32, the reference's buckets: padding rows are empty and change no
        result.  A flank window is up to the read plus the region wide, of
        any length: over 1,024 columns the launch takes the wide Gotoh
        kernel (kernels/pairwise_cuda.py)."""
        dev = self.device
        out = [None] * len(flank_jobs)
        c0 = 0
        while c0 < len(flank_jobs):
            rows = min(self.DP_ROWS, len(flank_jobs) - c0)
            while True:
                chunk = flank_jobs[c0 : c0 + rows]
                bucket = 32
                while bucket < rows:
                    bucket *= 2
                max_q = max(len(j[1]) for j in chunk)
                max_s = max(len(j[2]) for j in chunk)
                plane_bytes = 4 * bucket * (-(-max_q // 32) * 32) * (-(-max_s // 32) * 32)
                if rows == 1 or plane_bytes <= self.PLANE_CAP_BYTES:
                    break
                rows //= 2
            pad = [np.empty(0, np.int8)] * (bucket - rows)
            qc, ql, _ = pack_reads(
                [j[1] for j in chunk] + pad, pad_to=max_q, pad_multiple=32
            )
            sc, sl, _ = pack_reads(
                [j[2] for j in chunk] + pad, pad_to=max_s, pad_multiple=32
            )
            res = affine_gap_align_batch(
                torch.from_numpy(qc).to(dev),
                torch.from_numpy(ql.astype(np.int32)).to(dev),
                torch.from_numpy(sc).to(dev),
                torch.from_numpy(sl.astype(np.int32)).to(dev),
                # left flank: query END free (ref forceEnd1 false) + slop
                # subject HEAD free; right flank: query START free (ref
                # forceStart1 false) + slop subject TAIL free
                free_start1=(side == "right"),
                free_end1=(side == "left"),
                free_start2=(side == "left"),
                free_end2=(side == "right"),
            )
            ops = res["ops"].cpu().numpy()
            n_ops = res["n_ops"].cpu().numpy()
            end_i = res["end_i"].cpu().numpy()
            start_j = res["start_j"].cpu().numpy()
            for i, (job, rd, ref) in enumerate(chunk):
                cigar, mism = ops_to_cigar_and_strings(
                    ops[i], int(n_ops[i]), rd, ref, int(start_j[i])
                )
                if side == "left":
                    # unaligned query tail = trailing insertion (ref checks
                    # the last op is an insertion and strips it :246-251)
                    tail = len(rd) - int(end_i[i])
                    ok = mism <= len(rd) // 10 and tail > 0
                    out[c0 + i] = (cigar, mism, tail, ok, int(start_j[i]))
                else:
                    # leading insertion run = unaligned query head (:266-272)
                    head = cigar[0][0] if cigar and cigar[0][1] == "I" else 0
                    ok = mism <= len(rd) // 10 and head > 0
                    if ok:
                        cigar = cigar[1:]
                    out[c0 + i] = (cigar, mism, head, ok)
            c0 += rows
        return out

    # ------------------------------------------------------------------
    def _compose(self, job: _Tier2Job, left_res: list, right_res: list) -> None:
        """Mirror of verifyShortTandemRepeats composition (:278-334)."""
        cand = job.cand
        region = job.region
        qlen = len(job.qcodes)
        read_len = qlen
        left = left_res[job.left_idx] if job.left_idx >= 0 else None
        right = right_res[job.right_idx] if job.right_idx >= 0 else None
        left_ok = left is not None and left[3]
        right_ok = right is not None and right[3]
        if not left_ok and not right_ok:
            return
        if left_ok:
            lcigar, lmism, tail, _, lstart_j = left
            soft_clip_left = tail + (read_len - job.end_read_segment)
            left_first = job.left_ref_start + lstart_j
        if right_ok:
            rcigar, rmism, head, _ = right
            soft_clip_right = head + job.start_read_segment
        name = self.genome.sequence_name(job.seq_idx)
        if left_ok and not right_ok:
            cigar = list(lcigar)
            if soft_clip_left > 0:
                cigar.append((soft_clip_left, "S"))
            aln = ReadAlignment(
                sequence_name=name, first=left_first, cigar=cigar,
                num_mismatches=lmism,
            )
            if not aln.clip_borders(MIN_MATCH_LENGTH):
                return
            aln.alignment_quality = max(0, 90 - 5 * lmism)
            cand.aln = aln
            cand.quality = aln.alignment_quality
            return
        if right_ok and not left_ok:
            cigar = list(rcigar)
            if soft_clip_right > 0:
                cigar.insert(0, (soft_clip_right, "S"))
            aln = ReadAlignment(
                sequence_name=name, first=region.last + 1, cigar=cigar,
                num_mismatches=rmism,
            )
            if not aln.clip_borders(MIN_MATCH_LENGTH):
                return
            aln.alignment_quality = max(0, 90 - 5 * rmism)
            cand.aln = aln
            cand.quality = aln.alignment_quality
            return
        # both flanks aligned: spell the repeat-length difference as one
        # indel between them (:305-327)
        aligned_left = read_len - soft_clip_left
        aligned_right = read_len - soft_clip_right
        middle_length = read_len - aligned_left - aligned_right
        if middle_length < 0:
            return
        region_length = region.last - region.first + 1
        difference = region_length - middle_length
        cigar = list(lcigar)
        if difference > 0:
            cigar.append((difference, "D"))
            if middle_length > 0:
                cigar.append((middle_length, "M"))
        elif difference < 0:
            cigar.append((-difference, "I"))
            if region_length > 0:
                cigar.append((region_length, "M"))
        elif middle_length > 0:
            cigar.append((middle_length, "M"))
        cigar.extend(rcigar)
        cigar = _merge_cigar(cigar)
        mism = lmism + rmism
        aln = ReadAlignment(
            sequence_name=name, first=left_first, cigar=cigar,
            num_mismatches=mism,
        )
        if not aln.clip_borders(MIN_MATCH_LENGTH):
            return
        aln.alignment_quality = max(0, min(255, 100 - 5 * mism))
        cand.aln = aln
        cand.quality = aln.alignment_quality
