"""Long-read aligner — minimizer anchor chaining with batched segment DP.

Ref: src/ngsep/alignments/LongReadsUngappedSearchHitsClusterAligner.java:33-245
(anchor walk: consume kmer hits in query order, extend match runs through
equal-length low-divergence gaps, pairwise-align unequal inter-anchor
segments, soft-clip unalignable ends) and
ReadAlignmentObjectsFactory.java:119-124 (long-read platforms use the
minimizer seed finder with the same k/w as short reads).

The reference aligns inter-anchor segments one at a time with per-object
CPU DP (or the recursive "dynamic kmers" scheme,
PairwiseAlignerDynamicKmers.java:16-279, which exists purely to cap CPU DP
cost).  Here every read in the batch contributes its segments to shared
size-bucketed batches on the aligner's device (kernels/pairwise
.dp_run_segments: the CUDA Gotoh and run-walk kernels on the card), so
segments from different reads and different clusters align in the same
launch.  Seeding is the canonical minimizer selection on the device; the
hit lookup, clustering, the anchor walk and the assembly are integer work
on host numpy, the anchor walk emitting a "skeleton" whose DP slots are
spliced after the batched DP returns.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.genome import ReferenceGenome
from ..core.sequences import (
    RawRead,
    pack_reads,
    reverse_complement_codes,
)
from ..index.minimizer_table import MinimizerTable
from ..kernels.kmers import rc_code_int64
from ..kernels.minimizers import extract_minimizers_compact
from ..kernels.pairwise import dp_run_segments
from ..utils.profiling import stage
from .hits_clustering import cluster_hits
from .read_alignment import ReadAlignment
from .reads_aligner import (
    DEF_KMER_LENGTH,
    DEF_WINDOW_LENGTH,
    MIN_PROPORTION_BEST,
    MIN_WEIGHTED_COUNT,
    _Candidate,
    select_final_alignments,
)

# ref: LongReadsUngappedSearchHitsClusterAligner.java:35-36
MAX_LENGTH_FULL_PW = 4000
MAX_LENGTH_ENDS_PW = 500
# ref: equal-length gap fast path ":127-129"
MAX_HAMMING_GAP = 50
HAMMING_FRACTION = 0.03


def _hamming(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.count_nonzero(a != b))


def _naive_runs(
    q_seg: np.ndarray, s_seg: np.ndarray
) -> tuple[list[tuple[int, str]], int]:
    """Single leading gap + match run (ref: PairwiseAlignerNaive.java with
    gapsLeft=true); mismatches counted Hamming-style over aligned columns
    (gap columns count)."""
    dq, ds = len(q_seg), len(s_seg)
    mn = min(dq, ds)
    runs: list[tuple[int, str]] = []
    if ds > dq:
        runs.append((ds - dq, "D"))
    elif dq > ds:
        runs.append((dq - ds, "I"))
    if mn > 0:
        runs.append((mn, "M"))
    mism = abs(ds - dq) + (_hamming(q_seg[dq - mn :], s_seg[ds - mn :]) if mn else 0)
    return runs, mism


def _kmer_chain_anchors(
    q: np.ndarray, s: np.ndarray, k: int, band: int = 400, per_kmer: int = 4
) -> list[tuple[int, int]] | None:
    """Collinear exact-k-mer anchor chain between two segments whose
    endpoints are already aligned (ref: PairwiseAlignerDynamicKmers.
    findBestKmersCluster:140 picks the best diagonal k-mer cluster; here a
    greedy monotone chain with bounded diagonal drift, anchored at the
    segment start, serves the same role: splitting a large segment into
    small DP gaps).  Returns [(qpos, spos), ...] or None if no usable
    chain exists."""
    nq = len(q) - k + 1
    ns = len(s) - k + 1
    if nq <= 0 or ns <= 0:
        return None
    qk = _rolling_codes(q, k)
    sk = _rolling_codes(s, k)
    order = np.argsort(sk, kind="stable")
    sk_sorted = sk[order]
    left = np.searchsorted(sk_sorted, qk, side="left")
    right = np.searchsorted(sk_sorted, qk, side="right")
    counts = np.minimum(right - left, per_kmer)
    total = int(counts.sum())
    if total == 0:
        return None
    qpos = np.repeat(np.arange(nq), counts)
    take = np.concatenate(
        [np.arange(left[i], left[i] + counts[i]) for i in np.nonzero(counts)[0]]
    )
    spos = order[take]
    # invalid k-mers (containing N) sort together; drop them
    okm = (qk[qpos] >= 0) & (sk[spos] >= 0)
    qpos, spos = qpos[okm], spos[okm]
    if not len(qpos):
        return None
    o = np.lexsort((spos, qpos))
    qpos, spos = qpos[o], spos[o]
    anchors: list[tuple[int, int]] = []
    last_q = -k
    last_s = -k
    last_d = 0
    for t in range(len(qpos)):
        qp, sp = int(qpos[t]), int(spos[t])
        d = qp - sp
        if qp >= last_q + k and sp >= last_s + k and abs(d - last_d) <= band:
            anchors.append((qp, sp))
            last_q, last_s, last_d = qp, sp, d
    if len(anchors) < 1:
        return None
    return anchors


def _rolling_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """2-bit rolling k-mer codes; -1 where the window contains N."""
    n = len(codes) - k + 1
    valid = codes < 4
    c = np.where(valid, codes, 0).astype(np.int64)
    out = np.zeros(n, np.int64)
    ok = np.ones(n, bool)
    for i in range(k):
        out |= c[i : i + n] << (2 * (k - 1 - i))
        ok &= valid[i : i + n]
    return np.where(ok, out, np.int64(-1))


def merge_runs(runs: list[tuple[int, str]]) -> list[tuple[int, str]]:
    out: list[tuple[int, str]] = []
    for n, ch in runs:
        if n <= 0:
            continue
        if out and out[-1][1] == ch:
            out[-1] = (out[-1][0] + n, ch)
        else:
            out.append((n, ch))
    return out


def collapse_complementary_indels(
    runs: list[tuple[int, str]],
) -> tuple[list[tuple[int, str]], int]:
    """Merge I,M,D / D,M,I sandwiches into longer matches
    (ref: ReadAlignment.collapseComplementaryIndels:1314-1349).
    Returns (new_runs, collapsed_length) — callers subtract
    collapsed_length from the mismatch count like the reference."""
    if len(runs) < 5:
        return runs, 0
    out: list[tuple[int, str]] = []
    collapsed = 0
    i = 0
    n = len(runs)
    while i < n:
        if 0 < i < n - 3:
            l1, op1 = runs[i]
            lm, opm = runs[i + 1]
            l2, op2 = runs[i + 2]
            if (
                op1 != op2
                and op1 in "ID"
                and op2 in "ID"
                and opm == "M"
            ):
                diff = abs(l1 - l2)
                min_len = min(l1, l2)
                if min_len > 10 and l1 > 1.5 * lm and l2 > 1.5 * lm and diff < max(
                    5, 0.5 * lm
                ):
                    out.append((lm + min_len, "M"))
                    if l1 > l2:
                        out.append((diff, op1))
                    elif l2 > l1:
                        out.append((diff, op2))
                    collapsed += min_len
                    i += 3
                    continue
        out.append(runs[i])
        i += 1
    return merge_runs(out), collapsed


# max inter-anchor segment the batched DP aligns directly; larger center
# segments are re-anchored with interior k-mers (the reference's dynamic
# kmers scheme, PairwiseAlignerDynamicKmers.java:16-279) so DP only ever
# runs on small gaps
SEG_LIMIT = 512
REANCHOR_K = 13


@dataclass
class _SegJob:
    """One inter-anchor alignment slot, held as COORDINATES into the
    batch read matrix (row, q0:q1) and the genome concat (s0:s1): the
    device sweep gathers the sequences itself (dp_run_segments)."""

    row: int
    q0: int
    q1: int
    s0: int
    s1: int
    kind: str  # 'center' | 'start' | 'end'
    runs: list[tuple[int, str]] | None = None
    mism: int = 0
    start_j: int = 0
    end_j: int = 0
    # set by re-anchoring: a mix of (n, op) runs and ('SEG', _SegJob)
    # slots replacing this job's direct DP
    sub_items: list | None = None


@dataclass
class _Skeleton:
    """Chain-walk output for one candidate: CIGAR runs with unresolved DP
    slots ('SEG', job) plus bookkeeping for final assembly."""
    items: list = field(default_factory=list)  # (n, op) | ('SEG', _SegJob)
    mismatches: int = 0
    aln_start: int = -1  # concat 0-based; adjusted by start-seg start_j
    start_seg: _SegJob | None = None
    end_seg: _SegJob | None = None
    aln_end: int = -1  # concat 0-based exclusive (before end seg splice)
    query_start: int = 0
    query_next: int = 0
    failed: bool = False


class LongReadsAligner:
    """Batched long-read alignment (PACBIO / ONT platforms)."""

    def __init__(
        self,
        genome: ReferenceGenome,
        table: MinimizerTable | None = None,
        kmer_length: int = DEF_KMER_LENGTH,
        window_length: int = DEF_WINDOW_LENGTH,
        max_alns_per_read: int = 1,
        *,
        device,
    ):
        self.genome = genome
        self.device = torch.device(device)
        self.kmer_length = kmer_length
        self.window_length = window_length
        self.max_alns_per_read = max_alns_per_read
        if table is None:
            table = MinimizerTable.build_from_genome(
                genome, kmer_length, window_length, device=self.device
            )
        self.table = table
        self.total_reads = 0
        self.aligned_reads = 0

    # ------------------------------------------------------------------
    def align_batch(self, reads: list[RawRead]) -> list[list[ReadAlignment]]:
        B = len(reads)
        self.total_reads += B
        fwd = [r.codes for r in reads]
        rev = [reverse_complement_codes(c) for c in fwd]
        all_codes = fwd + rev
        with stage("lr.seed"):
            # the row width decides which tail windows exist, so it is the
            # reference's: the longest read rounded up to 1024
            codes, lengths, _ = pack_reads(all_codes, pad_multiple=1024)
            # canonical minimizer selection is strand-symmetric, so the
            # reverse rows' minimizers are exact mirrors of the forward
            # rows': extract (and fetch) only the forward half, derive the
            # reverse half by position mirror + code revcomp on host
            k = self.kmer_length
            dev = self.device
            codes_dev = torch.from_numpy(codes).to(dev)
            f_row, f_pos, f_codes = extract_minimizers_compact(
                codes_dev[:B], torch.from_numpy(lengths[:B]).to(dev), k,
                self.window_length,
            )
            lens_f = lengths[:B].astype(np.int64)
            # reverse WITHIN each row so the derived entries stay
            # row-major with ascending (mirrored) positions
            bounds = np.searchsorted(f_row, np.arange(B + 1))
            rev_idx = (
                bounds[f_row]
                + (bounds[f_row + 1] - 1 - np.arange(len(f_row)))
            )
            r_row = (f_row + B).astype(f_row.dtype)
            r_pos = (lens_f[f_row] - k - f_pos)[rev_idx].astype(f_pos.dtype)
            r_codes = rc_code_int64(f_codes, k)[rev_idx]
            mrow = np.concatenate([f_row, r_row])
            mpos = np.concatenate([f_pos, r_pos])
            mcodes = np.concatenate([f_codes, r_codes])

        per_read: dict[int, list[_Candidate]] = {}
        with stage("lr.cluster"):
            h_spos, h_qp, h_rows = self.table.collect_hits_batch(
                mcodes, mpos.astype(np.int64), mrow.astype(np.int64)
            )
            hit_bounds = np.searchsorted(h_rows, np.arange(2 * B + 1))
            for row in range(2 * B):
                ridx = row % B
                rv = row >= B
                qlen = int(lengths[row])
                a, b = int(hit_bounds[row]), int(hit_bounds[row + 1])
                if a == b:
                    continue
                clusters = cluster_hits(
                    h_spos[a:b], h_qp[a:b], qlen, with_members=True
                )
                for cl in clusters:
                    seq_idx, _ = self.genome.split_concat_pos(
                        min(max(cl.subject_concat_start, 0), self.genome.total_length - 1)
                    )
                    c = _Candidate(
                        read_idx=ridx,
                        reverse=rv,
                        cluster=cl,
                        seq_idx=seq_idx,
                        pred_start=cl.subject_concat_start,
                    )
                    per_read.setdefault(ridx, []).append(c)

        # candidate filtering per read (ref: SingleReadsAligner:84-99)
        selected: list[_Candidate] = []
        for ridx, cands in per_read.items():
            cands.sort(key=lambda c: -c.cluster.weighted_count)
            max_count = cands[0].cluster.weighted_count
            limit_count = min(MIN_WEIGHTED_COUNT, MIN_PROPORTION_BEST * max_count)
            limit_clusters = min(len(cands), max(5, 3 * self.max_alns_per_read))
            for i, c in enumerate(cands[:limit_clusters]):
                if i > 0 and c.cluster.weighted_count < limit_count:
                    break
                selected.append(c)

        # anchor walk -> skeleton + DP jobs
        jobs: list[_SegJob] = []
        work: list[tuple[_Candidate, _Skeleton]] = []
        with stage("lr.chain"):
            for c in selected:
                row = c.read_idx + (B if c.reverse else 0)
                qcodes = all_codes[row]
                sk = self._chain(c, qcodes, jobs, row)
                if sk is not None and not sk.failed:
                    work.append((c, sk))

        with stage("lr.reanchor"):
            self._reanchor_large(jobs, codes)

        self._run_dp_jobs(jobs, codes, codes_dev)

        # splice + finalize each candidate
        with stage("lr.assemble"):
            for c, sk in work:
                aln = self._assemble(c, sk)
                if aln is not None:
                    c.aln = aln
                    c.quality = aln.alignment_quality

        out, n_aligned = select_final_alignments(reads, selected, self.max_alns_per_read)
        self.aligned_reads += n_aligned
        return out

    # ------------------------------------------------------------------
    def _chain(
        self, c: _Candidate, qcodes: np.ndarray, jobs: list[_SegJob],
        row: int,
    ) -> _Skeleton | None:
        """The reference's hit walk (LongReadsUngappedSearchHitsClusterAligner
        .buildAlignment:69-245), emitting DP slots instead of aligning
        inline."""
        cl = c.cluster
        hq, hs = cl.member_qpos, cl.member_spos
        if hq is None or len(hq) == 0:
            return None
        k = self.kmer_length
        qlen = len(qcodes)
        concat = self.genome.concat
        s0 = int(self.genome.offsets[c.seq_idx])
        s1 = int(self.genome.offsets[c.seq_idx + 1])
        sk = _Skeleton()
        subject_next = -1
        query_next = 0
        next_match = 0
        pred_start = cl.subject_concat_start

        for qs, ss in zip(hq.tolist(), hs.tolist()):
            if sk.aln_start == -1:
                # inconsistent early hit (ref ":93")
                if ss < pred_start:
                    continue
                sk.aln_start = ss
                sk.query_start = qs
                start_aligned = qs <= 0
                if not start_aligned and qs < ss - s0:
                    q_seg = qcodes[:qs]
                    possible_start = max(s0, ss - qs - 5)
                    s_seg = concat[possible_start:ss]
                    if len(q_seg) <= 5 or len(s_seg) <= 5:
                        runs, mism = _naive_runs(q_seg, s_seg)
                        sk.items.extend(runs)
                        sk.mismatches += mism
                        start_aligned = True
                        sk.query_start = 0
                        sk.aln_start = possible_start
                    elif (
                        len(q_seg) < MAX_LENGTH_ENDS_PW
                        and len(s_seg) < MAX_LENGTH_ENDS_PW
                    ):
                        job = _SegJob(row, 0, qs, possible_start, ss, "start")
                        jobs.append(job)
                        sk.start_seg = job
                        sk.items.append(("SEG", job))
                        start_aligned = True
                        sk.query_start = 0
                        sk.aln_start = possible_start
                if not start_aligned:
                    sk.items.append((qs, "S"))
                next_match += k
                subject_next = ss + k
                query_next = qs + k
            elif qs > query_next and subject_next < ss:
                s_gap = ss - subject_next
                q_gap = qs - query_next
                good = s_gap == q_gap and s_gap < MAX_HAMMING_GAP
                if good:
                    ham = _hamming(
                        concat[subject_next:ss], qcodes[query_next:qs]
                    )
                    good = ham < HAMMING_FRACTION * q_gap
                if good:
                    next_match += s_gap
                    sk.mismatches += ham
                else:
                    mn, mx = min(s_gap, q_gap), max(s_gap, q_gap)
                    if mx > mn + 3 and 0.95 * mx > mn:
                        # possible invalid kmer hit: delay (ref ":138-142")
                        continue
                    if next_match > 0:
                        sk.items.append((next_match, "M"))
                        next_match = 0
                    q_seg = qcodes[query_next:qs]
                    s_seg = concat[subject_next:ss]
                    if mx <= MAX_LENGTH_FULL_PW:
                        job = _SegJob(
                            row, query_next, qs, subject_next, ss, "center"
                        )
                        jobs.append(job)
                        sk.items.append(("SEG", job))
                    elif mn < 0.1 * mx:
                        # large indel event: naive single-gap (ref ":153-156")
                        runs, mism = _naive_runs(q_seg, s_seg)
                        sk.items.extend(runs)
                        sk.mismatches += mism
                    elif mx > 0.2 * qlen:
                        sk.failed = True  # ref ":166 return null"
                        return sk
                    else:
                        # default encoding: mismatch run + indel (ref ":167-170")
                        sk.items.append((mn, "M"))
                        if s_gap > q_gap:
                            sk.items.append((s_gap - q_gap, "D"))
                        else:
                            sk.items.append((q_gap - s_gap, "I"))
                        sk.mismatches += mx
                next_match += k
                subject_next = ss + k
                query_next = qs + k
            else:
                # overlapping hit (ref ":188-200")
                d_s = ss + k - subject_next
                d_q = qs + k - query_next
                if d_s > 0 and d_s == d_q:
                    next_match += d_s
                    subject_next = ss + k
                    query_next = qs + k
        if sk.aln_start == -1:
            return None
        if next_match > 0:
            sk.items.append((next_match, "M"))
        sk.aln_end = subject_next
        remainder = qlen - query_next
        if remainder > 0 and remainder + 5 < MAX_LENGTH_ENDS_PW:
            end = min(subject_next + remainder + 5, s1)
            if s1 - subject_next >= remainder:
                job = _SegJob(
                    row, query_next, qlen, subject_next, end, "end"
                )
                jobs.append(job)
                sk.end_seg = job
                sk.items.append(("SEG", job))
                remainder = 0
        if remainder > 0:
            sk.items.append((remainder, "S"))
        sk.query_next = query_next
        return sk

    # ------------------------------------------------------------------
    # ------------------------------------------------------------------
    def _reanchor_large(
        self, jobs: list[_SegJob], codes_mat: np.ndarray
    ) -> None:
        """Dynamic-kmers re-anchoring: center segments larger than
        SEG_LIMIT are re-anchored with interior exact k-mer matches so DP
        only runs on small gaps (ref: PairwiseAlignerDynamicKmers.java:
        16-279, findBestKmersCluster:140 — the reference's recursive
        scheme exists purely to cap DP cost).  The job becomes a composite
        of (n, op) runs for anchors/balanced gaps and sub-_SegJobs (each
        <= SEG_LIMIT) for unbalanced gaps; a segment whose interior yields
        no collinear anchors falls back to the chain walk's default
        encoding (mismatch run + net indel, ref ":167-170")."""
        concat = self.genome.concat
        new_jobs: list[_SegJob] = []
        for j in jobs:
            if j.kind != "center":
                continue
            dq = j.q1 - j.q0
            ds = j.s1 - j.s0
            if max(dq, ds) <= SEG_LIMIT:
                continue
            q = codes_mat[j.row, j.q0 : j.q1]
            s = concat[j.s0 : j.s1]
            anchors = _kmer_chain_anchors(q, s, REANCHOR_K)
            items: list = []
            mism = 0

            def emit_gap(q0, q1, s0, s1):
                nonlocal mism
                gq, gs = q1 - q0, s1 - s0
                if gq == 0 and gs == 0:
                    return
                if gq == gs:
                    items.append((gq, "M"))
                    mism += int(np.count_nonzero(q[q0:q1] != s[s0:s1]))
                elif gq == 0:
                    items.append((gs, "D"))
                    mism += gs
                elif gs == 0:
                    items.append((gq, "I"))
                    mism += gq
                elif max(gq, gs) <= SEG_LIMIT:
                    sub = _SegJob(
                        j.row, j.q0 + q0, j.q0 + q1,
                        j.s0 + s0, j.s0 + s1, "center",
                    )
                    new_jobs.append(sub)
                    items.append(("SEG", sub))
                else:
                    mn, mx = min(gq, gs), max(gq, gs)
                    items.append((mn, "M"))
                    items.append((gq - gs, "I") if gq > gs else (gs - gq, "D"))
                    mism += mx

            if anchors is None:
                # whole segment default-encoded
                mn, mx = min(dq, ds), max(dq, ds)
                items.append((mn, "M"))
                items.append((dq - ds, "I") if dq > ds else (ds - dq, "D"))
                mism = mx
            else:
                qc, sc = 0, 0
                for aq, asp in anchors:
                    emit_gap(qc, aq, sc, asp)
                    items.append((REANCHOR_K, "M"))
                    mism += int(
                        np.count_nonzero(
                            q[aq : aq + REANCHOR_K]
                            != s[asp : asp + REANCHOR_K]
                        )
                    )
                    qc, sc = aq + REANCHOR_K, asp + REANCHOR_K
                emit_gap(qc, dq, sc, ds)
            j.sub_items = items
            j.mism = mism
        jobs.extend(new_jobs)

    # ------------------------------------------------------------------
    def _run_dp_jobs(
        self, jobs: list[_SegJob], codes_mat: np.ndarray, codes_dev: torch.Tensor
    ) -> None:
        """All segments of all reads as a few device sweeps
        (kernels/pairwise.dp_run_segments): jobs bucket by (free-end flags,
        128 or 512 query and subject width), every bucket is enqueued, then
        one fetch per bucket delivers the RLE rows that ARE the segment
        CIGARs."""
        real = [j for j in jobs if j.sub_items is None]
        if not real:
            return
        # square 128 / 512 widths and 512-row chunks: the widths set the
        # walk budget (Lq // 8 + 8 runs), and a segment whose walk runs out
        # of it takes the naive encoding below, so results depend on them
        groups: dict[tuple[bool, bool, int], list[_SegJob]] = {}
        for j in real:
            span = max(j.q1 - j.q0, j.s1 - j.s0, 1)
            bq = 128 if span <= 128 else SEG_LIMIT
            flags = (j.kind == "start", j.kind == "end")
            groups.setdefault((flags[0], flags[1], bq), []).append(j)
        dev = self.device
        concat_dev = self.genome.device_concat(dev)
        pend = []
        with stage("lr.dp_dispatch"):
            for (fs2, fe2, bq), group in groups.items():
                spec = torch.tensor(
                    [[j.row, j.q0, j.q1 - j.q0, j.s0, j.s1 - j.s0] for j in group],
                    dtype=torch.int32,
                ).to(dev)
                stats = dp_run_segments(
                    codes_dev, concat_dev, *spec.T,
                    CH=512, Lq=bq, Ls=bq, fs2=fs2, fe2=fe2,
                )
                pend.append((group, stats))
        with stage("lr.dp_fetch"):
            fetched = [{k: v.cpu().numpy() for k, v in st.items()} for _, st in pend]
        with stage("lr.decode"):
            concat = self.genome.concat
            mid = "MID"
            for (group, _), st in zip(pend, fetched):
                rle, n_runs, mism = st["rle"], st["n_runs"], st["mism"]
                start_j, end_j, walk_ok = st["start_j"], st["end_j"], st["walk_ok"]
                for i, j in enumerate(group):
                    if not walk_ok[i]:
                        # run-budget overflow (pathological segment):
                        # single-gap naive encoding keeps the read alive
                        runs, m = _naive_runs(
                            codes_mat[j.row, j.q0 : j.q1],
                            concat[j.s0 : j.s1],
                        )
                        j.runs = runs
                        j.mism = m
                        j.start_j = 0
                        j.end_j = j.s1 - j.s0
                        continue
                    runs = []
                    for v in rle[i, : n_runs[i]]:
                        v = int(v)
                        ln = v >> 2
                        if ln:
                            runs.append((ln, mid[(v & 3) - 1]))
                    j.runs = runs
                    j.mism = int(mism[i])
                    j.start_j = int(start_j[i])
                    j.end_j = int(end_j[i])

    # ------------------------------------------------------------------
    def _assemble(self, c: _Candidate, sk: _Skeleton) -> ReadAlignment | None:
        runs: list[tuple[int, str]] = []
        mism = sk.mismatches

        def splice(items) -> bool:
            nonlocal mism
            for item in items:
                if item[0] == "SEG":
                    job: _SegJob = item[1]
                    if job.sub_items is not None:
                        mism += job.mism
                        if not splice(job.sub_items):
                            return False
                    elif job.runs is None:
                        return False
                    else:
                        runs.extend(job.runs)
                        mism += job.mism
                else:
                    runs.append(item)
            return True

        if not splice(sk.items):
            return None
        runs = merge_runs(runs)
        if not any(op == "M" for _, op in runs):
            return None
        runs, collapsed = collapse_complementary_indels(runs)
        mism = max(0, mism - collapsed)
        aln_start = sk.aln_start
        if sk.start_seg is not None and sk.start_seg.runs is not None:
            aln_start += sk.start_seg.start_j
        aln_end = sk.aln_end
        if sk.end_seg is not None and sk.end_seg.runs is not None:
            aln_end += sk.end_seg.end_j
        seq_idx, pos1 = self.genome.split_concat_pos(aln_start)
        aln = ReadAlignment(
            sequence_name=self.genome.sequence_name(seq_idx),
            first=pos1,
            cigar=runs,
            num_mismatches=mism,
        )
        # quality = 100 * aligned coverage of the query
        # (ref: ":236-238" setAlignmentQuality(100*cov))
        qlen = sum(n for n, op in runs if op in "MIS")
        cov = (sk.query_next - sk.query_start) / max(1, qlen)
        aln.alignment_quality = max(0, min(255, int(round(100 * cov))))
        if not aln.clip_borders(5):
            return None
        return aln


def is_long_read_platform(platform: str | None) -> bool:
    """Ref: ReadAlignment.Platform.isLongReads (ReadAlignment.java:75-84)."""
    return (platform or "").upper() in ("PACBIO", "ONT")
