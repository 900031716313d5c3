"""ReadsAligner — batched seed-and-extend short-read mapping.

Ref: src/ngsep/alignments/ReadsAligner.java:53-534 (command
orchestration), SingleReadsAligner.java:46-145 (fwd+revcomp, candidate
filtering), ShortReadsUngappedSearchHitsClusterAligner.java:62-121
(3-tier alignment).

Two flows share the seed table, parameters, counters and the tier-3
decode:

- the classic `align_batch`: one device pass (seed -> cluster -> tier-1
  screen, kernels/seeding.seed_cluster_screen) per read batch, host-side
  candidate selection, the tier-2 STR split alignment for candidates over
  a known STR (align/str_tier2.py), the tier-3 affine-gap DP over host-packed query and
  subject rows (kernels/pairwise.tier3_stats: the CUDA Gotoh kernel, then
  the CUDA walk with its statistics, on the card), then select_final_alignments;
- the fused align+call pipeline (call/fused_pipeline.py), which drives the
  tier-3 sweep over device-gathered inputs (kernels/pairwise.dp_run_all)
  and decodes into an array store.
"""
from __future__ import annotations

import numpy as np
import torch

from dataclasses import dataclass

from ..core.genome import ReferenceGenome
from ..core.sequences import (
    RawRead,
    decode_dna,
    pack_reads,
    reverse_complement_codes,
)
from ..index.minimizer_table import MinimizerTable
from .read_alignment import FLAG_READ_REVERSE, ReadAlignment

DEF_KMER_LENGTH = 25  # ref: ReadsAligner.java:62
DEF_WINDOW_LENGTH = 20  # ref: ReadsAligner.java:63
DEF_MAX_ALNS_PER_READ = 1  # ref: ReadsAligner.java:61
MIN_MATCH_LENGTH = 15  # ref: ShortReadsUngappedSearchHitsClusterAligner.java:41
MIN_PROPORTION_BEST = 0.2  # ref: SingleReadsAligner.java:16
MIN_WEIGHTED_COUNT = 1.0  # ref: SingleReadsAligner.java:17


def _row_bucket(n: int, minimum: int = 256) -> int:
    """Pow2 row bucket so kernel shapes repeat across batches (compile once)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def select_final_alignments(
    reads: list[RawRead],
    candidates: list["_Candidate"],
    max_alns_per_read: int,
    rev_mat: np.ndarray | None = None,
) -> tuple[list[list[ReadAlignment]], int]:
    """Per-read combine + filter of finished candidates into primary and
    secondary alignments (ref: SingleReadsAligner.filterAlignments:118-143).
    `rev_mat` optionally provides precomputed reverse-complement code rows
    (row i = read i, left-aligned) so reverse alignments skip a per-read
    revcomp pass.

    Candidate order decides ties: callers append tier-2, then tier-1 cells
    in np.nonzero order, then DP jobs; the sort by quality is stable, so
    that order picks the primary alignment among equal qualities.
    Sequence materialization (codes, decoded string, qualities) is
    batched: all kept alignments decode through ONE decode_dna pass."""
    from ..core.sequences import ReadBlock

    B = len(reads)
    out: list[list[ReadAlignment]] = [[] for _ in range(B)]
    finals: dict[int, list["_Candidate"]] = {}
    n_aligned = 0
    is_block = isinstance(reads, ReadBlock)
    names = reads.names if is_block else None
    mat_jobs: list[tuple[ReadAlignment, int, bool]] = []
    for c in candidates:
        if c.aln is not None:
            finals.setdefault(c.read_idx, []).append(c)
    for ridx, cands in finals.items():
        if len(cands) == 1:
            # single candidate: q > 0.8*q holds for any positive quality
            kept = cands if cands[0].quality > 0 else []
        else:
            cands.sort(key=lambda c: -c.quality)
            best = cands[0].quality
            threshold = int(0.8 * best)
            kept = []
            for i, c in enumerate(cands):
                if c.quality <= threshold:
                    break
                kept.append(c)
        n = len(kept)
        for i, c in enumerate(kept):
            aln = c.aln
            if not is_block:
                aln.read_name = reads[ridx].name
            elif names is not None:
                aln.read_name = names[ridx]
            else:
                aln.read_name = f"read_{ridx}"
            if c.reverse:
                aln.flags |= FLAG_READ_REVERSE
            mat_jobs.append((aln, ridx, c.reverse))
            if i > 0:
                aln.set_secondary(True)
            q = c.quality
            if n > 1:
                q = int(round(0.3 * q / n))
            aln.alignment_quality = max(0, min(255, q))
        kept = kept[:max_alns_per_read]
        out[ridx] = [c.aln for c in kept]
        if out[ridx]:
            n_aligned += 1
    _materialize_sequences(reads, mat_jobs, rev_mat, is_block)
    return out, n_aligned


def _materialize_sequences(reads, mat_jobs, rev_mat, is_block) -> None:
    """Attach codes / decoded string / qualities to each kept alignment,
    with one concatenated decode_dna pass over every row."""
    if not mat_jobs:
        return
    arrs: list[np.ndarray] = []
    quals: list[str | None] = []
    if is_block:
        codes_m = reads.codes
        lengths = reads.lengths
        qmat = reads.quals
        dq = chr(33 + reads.default_quality)
        for aln, ridx, rev in mat_jobs:
            L = int(lengths[ridx])
            row = codes_m[ridx, :L]
            if rev:
                if rev_mat is not None:
                    row = rev_mat[ridx, :L]
                else:
                    row = reverse_complement_codes(row)
            arrs.append(row)
            if qmat is None:
                quals.append(dq * L)
            else:
                qs = qmat[ridx, :L].tobytes().decode("ascii")
                quals.append(qs[::-1] if rev else qs)
    else:
        # RawRead path: forward alignments keep the ORIGINAL sequence
        # string (case preserved); only reverse rows join the decode batch
        fwd_jobs = []
        rev_jobs = mat_jobs.__class__()
        for job in mat_jobs:
            (rev_jobs if job[2] else fwd_jobs).append(job)
        for aln, ridx, _ in fwd_jobs:
            read = reads[ridx]
            aln.read_chars = read.sequence
            aln._read_codes = read.codes
            aln.qualities = read.qualities or "5" * len(read.sequence)
        mat_jobs = rev_jobs
        for aln, ridx, _ in mat_jobs:
            read = reads[ridx]
            L = len(read.sequence)
            if rev_mat is not None:
                row = rev_mat[ridx, :L]
            else:
                row = reverse_complement_codes(read.codes)
            arrs.append(np.asarray(row))
            quals.append(read.qualities[::-1] if read.qualities else "5" * L)
    flat = np.concatenate(arrs) if arrs else np.empty(0, np.int8)
    big = decode_dna(flat)
    off = 0
    for (aln, ridx, rev), row, q in zip(mat_jobs, arrs, quals):
        L = len(row)
        aln._read_codes = row
        aln.read_chars = big[off : off + L]
        aln.qualities = q
        off += L


@dataclass
class _Candidate:
    read_idx: int
    reverse: bool
    seq_idx: int
    # 0-based concat coords of predicted ungapped placement
    pred_start: int
    weight: float = 0.0
    aln: ReadAlignment | None = None
    quality: int = 0
    # the hits cluster (the long-read anchor chainer walks its members)
    cluster: object = None


class ReadsAligner:
    def __init__(
        self,
        genome: ReferenceGenome,
        table: MinimizerTable | None = None,
        kmer_length: int = DEF_KMER_LENGTH,
        window_length: int = DEF_WINDOW_LENGTH,
        max_alns_per_read: int = DEF_MAX_ALNS_PER_READ,
        read_pad: int = 16,  # pad_multiple for packed read rows (the
        # packed-word tier-1 screen needs L % 16 == 0)
        known_strs: dict[str, list] | None = None,  # tier-2 STR regions per
        # sequence name (ref: ReadsAligner -knownSTRs; same dict shape as
        # SingleSampleVariantsDetector.known_strs)
        *,
        device,
    ):
        self.genome = genome
        self.device = torch.device(device)
        self.kmer_length = kmer_length
        self.window_length = window_length
        self.max_alns_per_read = max_alns_per_read
        self.read_pad = read_pad
        if table is None:
            table = MinimizerTable.build_from_genome(
                genome, kmer_length, window_length, device=self.device
            )
        self.table = table
        self.known_strs = known_strs
        self._tier2 = None
        # the tier-3 sweep (kernels/pairwise.dp_run_all when None;
        # distribute/pipeline.py sets the sharded one)
        self.dp_run_all_fn = None
        # stats (ref: ReadsAligner printStatistics)
        self.total_reads = 0
        self.aligned_reads = 0
        self.few_mismatches_alns = 0
        self.complete_alns = 0
        self.dp_cells = 0  # DP cell updates issued to the device
        self.tier2_reads = 0  # candidate cells that tried the tier-2 STR split

    @property
    def tier2(self):
        """Lazy tier-2 STR split aligner (align/str_tier2.py); rebuilt when
        known_strs is (re)assigned after construction."""
        if self.known_strs and (
            self._tier2 is None or self._tier2.known_strs is not self.known_strs
        ):
            from .str_tier2 import Tier2STRAligner

            self._tier2 = Tier2STRAligner(
                self.genome, self.known_strs, device=self.device
            )
        return self._tier2 if self.known_strs else None

    def _tier2_pass(
        self,
        cells,  # iterable of (ridx, c, si, pred, strand, weight) records
        lengths: np.ndarray,
        fwd_mat: np.ndarray,
        rev_mat: np.ndarray | None,
    ) -> dict:
        """Tier-2 attempt for every candidate cell whose predicted span
        overlaps a known STR (ref buildAlignment:71-80: the repeat check
        runs BEFORE the tier-1 mismatch accept).  Returns
        {(ridx, c): _Candidate-with-aln} for successes plus the set of
        attempted cells under key None (failures fall through to
        tier-1/tier-3 exactly like the reference's null return)."""
        t2 = self.tier2
        result: dict = {None: set()}
        if t2 is None:
            return result
        from .str_tier2 import _Tier2Job

        offs = self.genome.offsets
        jobs = []
        for ridx, c, si, pred, strand, weight in cells:
            if not t2.has_strs(si):
                continue
            qlen = int(lengths[ridx])
            first = pred - int(offs[si]) + 1
            region = t2.region_for(si, first, first + qlen - 1)
            if region is None:
                continue
            if strand:
                if rev_mat is not None:
                    qcodes = rev_mat[ridx, :qlen]
                else:
                    r = fwd_mat[ridx, :qlen][::-1]
                    qcodes = np.where(r < 4, 3 - r, r).astype(np.int8)
            else:
                qcodes = fwd_mat[ridx, :qlen]
            cand = _Candidate(
                read_idx=ridx,
                reverse=bool(strand),
                seq_idx=si,
                pred_start=pred,
                weight=float(weight),
            )
            jobs.append(((ridx, c), _Tier2Job(cand, qcodes, first, region, si)))
            result[None].add((ridx, c))
        if jobs:
            self.tier2_reads += len(jobs)
            t2.align_batch([j for _, j in jobs])
            for cell, job in jobs:
                if job.cand.aln is not None:
                    result[cell] = job.cand
        return result

    def align_batch(self, reads: list[RawRead]) -> list[list[ReadAlignment]]:
        """One device pass (seed -> cluster -> tier-1 screen) for the whole
        batch, then host-side candidate selection, the tier-3 DP for the
        candidates the screen did not accept, and the per-read final
        selection.  Syncs once per batch to fetch the (B, C) seed result."""
        from ..utils.profiling import stage

        B = len(reads)
        self.total_reads += B
        with stage("align.seed"):
            fwd_mat, lengths_h, rev_mat, res = self._seed(reads)
        with stage("align.candidates"):
            pred = res["pred_start"].astype(np.int64)  # (B, C) — strands merged
            weight = res["weight"]
            strand = res["strand"]
            mm = res["mismatches"]
            cs = res["clip_start"]
            ce = res["clip_end"]
            offs = self.genome.offsets
            # ---- candidate selection, vectorized ----------------------------
            pred_b = pred[:B]
            valid_c = (weight[:B] > 0) & (pred_b < (1 << 29)) & (pred_b >= 0)
            seq_idx_m = np.clip(
                np.searchsorted(offs, np.clip(pred_b, 0, None), side="right") - 1,
                0,
                self.genome.num_sequences - 1,
            )
            qlen = lengths_h[:B].astype(np.int64)[:, None]
            w = weight[:B].astype(np.float64)
            # weights are sorted descending per read; the reference breaks at
            # the first candidate below the limit, so the kept set is the
            # prefix where every earlier candidate was kept too
            limit = np.minimum(MIN_WEIGHTED_COUNT, MIN_PROPORTION_BEST * w[:, :1])
            keep = valid_c.copy()
            keep[:, 1:] &= w[:, 1:] >= limit
            keep = np.logical_and.accumulate(keep, axis=1)
            in_b = (pred_b >= offs[seq_idx_m]) & (
                pred_b + qlen <= offs[seq_idx_m + 1]
            )
            mmb, csb, ceb = mm[:B], cs[:B], ce[:B]
            t1 = (
                keep
                & in_b
                & (w > 2)
                & (mmb < 0.05 * qlen)
                & ((csb + ceb) < 0.1 * qlen)
            )
            dp = keep & in_b & ~t1

            # candidate order is part of the result (select_final_alignments
            # breaks quality ties by it): tier-2 hits, tier-1 cells, then DP
            # jobs, each in row-major np.nonzero order
            selected: list[_Candidate] = []
            strand_b = strand[:B]
            # tier-2: STR-overlapping candidates try the split aligner FIRST
            t2_hits: dict = {None: set()}
            if self.tier2 is not None:
                with stage("align.tier2_str"):
                    t2_hits = self._tier2_pass(
                        (
                            (
                                int(r), int(c), int(seq_idx_m[r, c]),
                                int(pred_b[r, c]), int(strand_b[r, c]),
                                float(w[r, c]),
                            )
                            for r, c in zip(*np.nonzero(keep & in_b))
                        ),
                        lengths_h, fwd_mat, rev_mat,
                    )
                for cell, cand in t2_hits.items():
                    if cell is not None:
                        selected.append(cand)
            names = [self.genome.sequence_name(i) for i in range(self.genome.num_sequences)]
            for ridx, c in zip(*np.nonzero(t1)):
                if (int(ridx), int(c)) in t2_hits:
                    continue  # replaced by the tier-2 alignment
                # tier-1 accept straight from the screen
                si = int(seq_idx_m[ridx, c])
                p = int(pred_b[ridx, c])
                tcs, tce = int(csb[ridx, c]), int(ceb[ridx, c])
                t = int(mmb[ridx, c])
                ql = int(qlen[ridx, 0])
                cigar = []
                if tcs > 0:
                    cigar.append((tcs, "S"))
                cigar.append((ql - tcs - tce, "M"))
                if tce > 0:
                    cigar.append((tce, "S"))
                selected.append(
                    _Candidate(
                        read_idx=int(ridx),
                        reverse=bool(strand_b[ridx, c]),
                        seq_idx=si,
                        pred_start=p,
                        weight=float(w[ridx, c]),
                        aln=ReadAlignment(
                            sequence_name=names[si],
                            first=p + tcs - int(offs[si]) + 1,
                            cigar=cigar,
                            num_mismatches=t,
                        ),
                        quality=int(round(100 - 5 * t)),
                    )
                )
            self.few_mismatches_alns += len(selected)

            dp_cands = [
                _Candidate(
                    read_idx=int(ridx),
                    reverse=bool(strand_b[ridx, c]),
                    seq_idx=int(seq_idx_m[ridx, c]),
                    pred_start=int(pred_b[ridx, c]),
                    weight=float(w[ridx, c]),
                )
                for ridx, c in zip(*np.nonzero(dp))
                if (int(ridx), int(c)) not in t2_hits
            ]
        # affine-gap DP for candidates the screen did not accept
        with stage("align.tier3_dp"):
            self._tier3(dp_cands, fwd_mat, rev_mat, lengths_h)
        selected.extend(dp_cands)

        # per-read combine + filter (ref: filterAlignments:118-143)
        with stage("align.select_final"):
            out, n_aligned = select_final_alignments(
                reads, selected, self.max_alns_per_read, rev_mat=rev_mat
            )
        self.aligned_reads += n_aligned
        return out

    def _seed(self, reads):
        """Pack one batch, run the seeding/tier-1 screen on the aligner's
        device and fetch its (B, C) result.  Returns (fwd_mat, lengths,
        rev_mat, result dict of numpy arrays); the host rev matrix (DP
        queries and SAM emit) is one vectorized pass, while the screen
        derives the reverse complement itself in the packed bit domain."""
        from ..kernels.seeding import seed_cluster_screen

        B = len(reads)
        dev = self.device
        bucket = _row_bucket(B, minimum=128)
        pad_blk = [np.empty(0, np.int8)] * (bucket - B)
        fwd_mat, lengths_h, _ = pack_reads(
            [r.codes for r in reads] + pad_blk, pad_multiple=self.read_pad
        )
        Lp = fwd_mat.shape[1]
        ridx_rev = lengths_h[:, None].astype(np.int64) - 1 - np.arange(Lp)[None, :]
        g = np.take_along_axis(fwd_mat, np.clip(ridx_rev, 0, Lp - 1), axis=1)
        rev_mat = np.where(
            ridx_rev >= 0, np.where(g < 4, 3 - g, g), np.int8(4)
        ).astype(np.int8)
        gp, gn2 = self.genome.device_packed(dev)
        cl = (
            int(lengths_h[0])
            if B and np.all(lengths_h[:B] == lengths_h[0])
            else None
        )
        res = seed_cluster_screen(
            torch.from_numpy(fwd_mat).to(dev),
            torch.from_numpy(lengths_h.astype(np.int32)).to(dev),
            self.table.device_arrays(dev),
            gp,
            gn2,
            k=self.kmer_length,
            window=self.window_length,
            genome_len=self.genome.total_length,
            const_len=cl,
            genome_has_n=self.genome.has_n,
        )
        return fwd_mat, lengths_h, rev_mat, {
            k: v.cpu().numpy() for k, v in res.items()
        }

    # ------------------------------------------------------------------
    # classic tier-3: rows per DP launch; small job sets pad to the next
    # power of two >= DP_ROWS_MIN
    DP_ROWS_MIN = 256

    def _tier3(
        self,
        dp_cands: list[_Candidate],
        fwd_mat: np.ndarray,
        rev_mat: np.ndarray,
        lengths: np.ndarray,
    ) -> None:
        """Affine-gap DP with free subject ends (ref tier-3, :97-121)."""
        if not dp_cands:
            return
        self._tier3_run(self._tier3_jobs(dp_cands, fwd_mat, rev_mat, lengths))

    def _tier3_jobs(
        self,
        dp_cands: list[_Candidate],
        fwd_mat: np.ndarray,
        rev_mat: np.ndarray,
        lengths: np.ndarray,
    ) -> list:
        """DP jobs (candidate, query codes, subject range) for the
        affine-gap fallback; rejects windows too distorted to align.

        The subject window is at most qlen + 6 wide, so the CUDA Gotoh
        kernel's 1..1024 subject width (kernels/pairwise_cuda.py) covers
        reads up to 1018 bp; longer reads belong to the long-read aligner
        (align/long_reads.py, ReadsAligner -p PACBIO|ONT)."""
        offs = self.genome.offsets
        jobs = []
        for c in dp_cands:
            qlen = int(lengths[c.read_idx])
            qcodes = (rev_mat if c.reverse else fwd_mat)[c.read_idx, :qlen]
            s0, s1 = int(offs[c.seq_idx]), int(offs[c.seq_idx + 1])
            first = max(s0, c.pred_start - 3)
            last = min(s1, c.pred_start + qlen + 3)
            d = last - first
            if d > 1.5 * qlen or d < 0.5 * qlen:
                continue
            jobs.append((c, qcodes, first, last))
        return jobs

    def _tier3_run(self, jobs: list) -> None:
        """Run prebuilt DP jobs in chunks of at most DP_ROWS rows.  Every
        chunk is launched before any result is fetched, so on the card the
        kernels of later chunks overlap the host packing and decode."""
        if not jobs:
            return
        concat = self.genome.concat
        self.complete_alns += len(jobs)
        pend = [
            self._tier3_dispatch(jobs[c0 : c0 + self.DP_ROWS], concat)
            for c0 in range(0, len(jobs), self.DP_ROWS)
        ]
        for chunk, stats in pend:
            out = {k: v.cpu().numpy() for k, v in stats.items()}
            cands = [j[0] for j in chunk]
            qlens = np.fromiter((len(j[1]) for j in chunk), np.int64, len(chunk))
            firsts = np.fromiter((j[2] for j in chunk), np.int64, len(chunk))
            self._tier3_decode_arrays(
                cands, qlens, firsts, lambda i, c=chunk: c[i][1], out, concat
            )

    def _tier3_dispatch(self, jobs: list, concat: np.ndarray):
        """Pack one chunk on the host and launch the DP with its walk and
        statistics (kernels/pairwise.tier3_stats) on the aligner's device.
        Returns (jobs, stats tensors).

        Query and subject widths round up to 64 and rows to a power of two
        in DP_ROWS_MIN..DP_ROWS (150 bp reads: up to 2048 x 192 x 192).
        Subject rows pack through one strided gather over the concatenated
        genome."""
        from ..kernels.pairwise import tier3_stats

        n = len(jobs)
        max_q = max(len(j[1]) for j in jobs)
        max_s = max(j[3] - j[2] for j in jobs)
        rows = _row_bucket(n, minimum=self.DP_ROWS_MIN)
        Lq = -(-max_q // 64) * 64
        Ls = -(-max_s // 64) * 64
        qc = np.full((rows, Lq), 4, np.int8)
        ql = np.zeros(rows, np.int32)
        firsts = np.fromiter((j[2] for j in jobs), np.int64, n)
        lasts = np.fromiter((j[3] for j in jobs), np.int64, n)
        for i, j in enumerate(jobs):
            q = j[1]
            qc[i, : len(q)] = q
            ql[i] = len(q)
        sl = np.zeros(rows, np.int32)
        sl[:n] = (lasts - firsts).astype(np.int32)
        idx = firsts[:, None] + np.arange(Ls, dtype=np.int64)[None, :]
        np.clip(idx, 0, len(concat) - 1, out=idx)
        sc = np.full((rows, Ls), 4, np.int8)
        sc[:n] = concat[idx]
        sc[:n][np.arange(Ls)[None, :] >= sl[:n, None]] = 4
        self.dp_cells += rows * Lq * Ls
        dev = self.device
        qc_d, sc_d = torch.from_numpy(qc).to(dev), torch.from_numpy(sc).to(dev)
        return jobs, tier3_stats(
            qc_d, torch.from_numpy(ql).to(dev), sc_d, torch.from_numpy(sl).to(dev)
        )

    # max DP rows per forward-kernel launch; the last chunk is padded to
    # CH rows (padded rows are discarded after the fetch)
    DP_ROWS = 2048

    def _tier3_dispatch_dev(
        self, rows, strand, qlen, firsts, lasts, bigpq, lengths_dev,
    ):
        """Run the tier-3 sweep on bigpq's device (kernels/pairwise
        .dp_run_all) and return a pending dict (device results + chunking)
        for _tier3_finish_dev.  Job inputs are gathered on the device from
        the run-wide packed-read matrix and the resident genome, so each
        job crosses to the device as ~20 bytes of metadata."""
        n = len(rows)
        if n == 0:
            return None

        from ..kernels.pairwise import dp_run_all as plain_dp_run_all
        from ..utils.profiling import stage

        dp_run_all = self.dp_run_all_fn or plain_dp_run_all
        dev = bigpq.device
        concat_dev = self.genome.device_concat(dev)
        self.complete_alns += n
        CH = self.DP_ROWS
        n_chunks = -(-n // CH)
        pad = n_chunks * CH
        sl_all = (lasts - firsts).astype(np.int32)
        # Lq sets the walk-step budget (kernels/pairwise._walk_runs_for),
        # so it keeps the reference's 16-granular rounding; the subject
        # width only needs whole warps
        Lq = -(-int(qlen.max()) // 16) * 16
        Ls = -(-int(sl_all.max()) // 32) * 32
        self.dp_cells += pad * Lq * Ls

        def padded(a, dtype):
            out = np.zeros(pad, dtype)
            out[:n] = a
            return torch.from_numpy(out).to(dev)

        with stage("align.tier3_dispatch"):
            stats = dp_run_all(
                bigpq, lengths_dev, concat_dev,
                padded(rows, np.int64), padded(strand, np.int32),
                padded(firsts, np.int64), padded(sl_all, np.int32),
                CH=CH, Lq=Lq, Ls=Ls, n_chunks=n_chunks,
            )
        return {
            "stats": stats, "n": n, "CH": CH, "n_chunks": n_chunks,
            "qlen": qlen, "firsts": firsts,
        }

    def _tier3_finish_dev(self, pend, qget, sink: dict) -> None:
        """Fetch + decode a _tier3_dispatch_dev launch into `sink`."""
        if pend is None:
            return
        from ..utils.profiling import stage

        stats, n = pend["stats"], pend["n"]
        CH, n_chunks = pend["CH"], pend["n_chunks"]
        qlen, firsts = pend["qlen"], pend["firsts"]
        concat = self.genome.concat
        with stage("align.tier3_fetch"):
            keys = (
                "mism", "has_gap", "rle", "n_runs", "n_ops", "start_j",
                "la_fallback",
            )
            host = {k: stats[k].cpu().numpy() for k in keys}
        with stage("align.tier3_decode"):
            for ci in range(n_chunks):
                c0 = ci * CH
                c1 = min(n, c0 + CH)
                out = {k: host[k][ci] for k in keys}
                self._tier3_decode_arrays(
                    None,
                    qlen[c0:c1].astype(np.int64),
                    firsts[c0:c1].astype(np.int64),
                    qget, out, concat, sink=sink, sink_off=c0,
                )

    @staticmethod
    def _rle_runs(out: dict, gsel, n_ops) -> dict:
        """Per-row cigar run lists from the fetched device-side RLE.

        The run-jump traceback (kernels/pairwise.tier3_walk_stats)
        sizes its RLE slots to cover every row acceptable under the 10%
        mismatch cap, and rows that exhausted the run budget carry a huge
        mismatch count so they never reach the accepted set — the former
        packed-ops overflow fetch is gone."""
        runs_by_row: dict[int, list] = {}
        if not len(gsel):
            return runs_by_row
        n_runs = np.asarray(out["n_runs"])
        rle = np.asarray(out["rle"])
        mid = "MID"
        for gi in gsel:
            nr = int(n_runs[gi])
            row = rle[gi]
            # device left-align can zero an M run between two gaps:
            # drop empty runs and merge adjacent equal ops
            runs: list[tuple[int, str]] = []
            for u in range(nr):
                v = int(row[u])
                ln = v >> 2
                if ln == 0:
                    continue
                op = mid[(v & 3) - 1]
                if runs and runs[-1][1] == op:
                    runs[-1] = (runs[-1][0] + ln, op)
                else:
                    runs.append((ln, op))
            runs_by_row[gi] = runs
        return runs_by_row

    def _tier3_decode_store(
        self, store, off0, ok, has_gap, n_ops, start_j, mism_all,
        qual_all, si_all, pos1_all, firsts, out, concat, qget,
    ) -> None:
        """Store-mode decode: vectorized slice writes into the DP result
        store; per-row Python only for gapped rows (left-align + cigar)
        and for rows whose borders need a real clip pass."""
        from .read_alignment import left_align_indels

        gl = ~has_gap[ok]
        # gapless rows shorter than the anchor minimum cannot survive
        # clip_borders([(n, M)]) — treat as rejected
        gl_ok = ok[gl & (n_ops[ok] >= MIN_MATCH_LENGTH)]
        idx = off0 + gl_ok
        store["acc"][idx] = True
        store["q"][idx] = qual_all[gl_ok]
        store["mism"][idx] = mism_all[gl_ok]
        store["gapless"][idx] = True
        store["mlen"][idx] = n_ops[gl_ok]
        # si/pos1 are indexed by position within ok
        sel_gl = np.nonzero(gl & (n_ops[ok] >= MIN_MATCH_LENGTH))[0]
        store["si"][idx] = si_all[sel_gl]
        store["pos1"][idx] = pos1_all[sel_gl]
        pos_in_ok = {int(i): t for t, i in enumerate(ok)}

        gsel = ok[has_gap[ok]]
        if not len(gsel):
            return
        runs_by_row = self._rle_runs(out, gsel, n_ops)
        la_fb = np.asarray(out["la_fallback"]).astype(bool)
        names = [
            self.genome.sequence_name(i)
            for i in range(self.genome.num_sequences)
        ]
        for i in gsel:
            t = pos_in_ok[int(i)]
            first = int(firsts[i])
            # the RLE comes left-aligned from the device (the walk
            # kernel's tier-3 mode, kernels/pairwise._left_align_rle on
            # the CPU); only rows the device
            # pass could not normalize exactly re-run the host pass
            if la_fb[i]:
                cigar = left_align_indels(
                    runs_by_row[i], qget(off0 + i),
                    concat[first : first + int(start_j[i]) + int(n_ops[i])],
                    int(start_j[i]),
                )
            else:
                cigar = runs_by_row[i]
            si = int(si_all[t])
            pos1 = int(pos1_all[t])
            if not (
                cigar[0][1] == "M" and cigar[0][0] >= MIN_MATCH_LENGTH
                and cigar[-1][1] == "M" and cigar[-1][0] >= MIN_MATCH_LENGTH
            ):
                aln = ReadAlignment(
                    sequence_name=names[si], first=pos1, cigar=cigar,
                    num_mismatches=int(mism_all[i]),
                )
                if not aln.clip_borders(MIN_MATCH_LENGTH):
                    continue
                cigar = aln.cigar
                pos1 = aln.first
            j = off0 + int(i)
            store["acc"][j] = True
            store["q"][j] = int(qual_all[i])
            store["mism"][j] = int(mism_all[i])
            store["si"][j] = si
            store["pos1"][j] = pos1
            ops_ = [op for _, op in cigar]
            if "I" not in ops_ and "D" not in ops_ and ops_.count("M") == 1:
                store["gapless"][j] = True
                store["cs"][j] = cigar[0][0] if ops_[0] == "S" else 0
                store["ce"][j] = (
                    cigar[-1][0] if len(ops_) > 1 and ops_[-1] == "S" else 0
                )
                store["mlen"][j] = next(l for l, op in cigar if op == "M")
            store["cigar"][j] = cigar

    def _tier3_decode_arrays(
        self, cands, qlens, firsts, qget, out: dict, concat: np.ndarray,
        sink: dict | None = None, sink_off: int = 0,
    ) -> None:
        """Decode one fetched stats chunk: mismatch accept, then CIGARs.
        The mismatch statistic, gap flag and the left-aligned RLE come
        precomputed from the device (kernels/pairwise.tier3_walk_stats);
        per-row math is vectorized over the chunk.  With `sink` set the
        rows land in the fused pipeline's DP result store; otherwise each
        accepted row becomes `cands[i].aln`, and a gapless row takes a
        single-run path with no clip_borders call (a single >=15 bp M run
        is clip-invariant)."""
        from .read_alignment import left_align_indels

        n = len(qlens)
        mism_all = np.asarray(out["mism"])[:n].astype(np.int64)
        has_gap = np.asarray(out["has_gap"])[:n].astype(bool)
        n_ops = np.asarray(out["n_ops"])[:n].astype(np.int64)
        start_j = np.asarray(out["start_j"])[:n].astype(np.int64)
        ok = np.nonzero(mism_all <= 0.1 * qlens)[0]
        if not len(ok):
            return
        # concat coordinate -> (sequence idx, 1-based pos) for accepted rows
        offs = self.genome.offsets
        aln_first = firsts[ok] + start_j[ok]
        si_all = np.clip(
            np.searchsorted(offs, aln_first, side="right") - 1,
            0, self.genome.num_sequences - 1,
        )
        pos1_all = (aln_first - offs[si_all] + 1).astype(np.int64)
        qual_all = np.rint(100 - 5 * mism_all).astype(np.int64)

        if sink is not None:
            # store mode (array-native selection): all per-row fields land
            # as vectorized slice writes; Python survives only for gapped
            # cigars (left-align) and sub-minimum-anchor rows
            self._tier3_decode_store(
                sink, sink_off, ok, has_gap, n_ops, start_j, mism_all,
                qual_all, si_all, pos1_all, firsts, out, concat, qget,
            )
            return

        # gapped accepted rows: the fetched RLE is the cigar, left-aligned
        # on the device; rows the device pass could not normalize exactly
        # re-run the host pass
        names = [
            self.genome.sequence_name(i)
            for i in range(self.genome.num_sequences)
        ]
        gsel = ok[has_gap[ok]]
        runs_by_row = self._rle_runs(out, gsel, n_ops)
        la_fb = np.asarray(out["la_fallback"]).astype(bool)
        for t, i in enumerate(ok):
            if has_gap[i]:
                first = int(firsts[i])
                if la_fb[i]:
                    cigar = left_align_indels(
                        runs_by_row[i], qget(i),
                        concat[first : first + int(start_j[i]) + int(n_ops[i])],
                        int(start_j[i]),
                    )
                else:
                    cigar = runs_by_row[i]
                clip_ok = (
                    cigar[0][1] == "M" and cigar[0][0] >= MIN_MATCH_LENGTH
                    and cigar[-1][1] == "M" and cigar[-1][0] >= MIN_MATCH_LENGTH
                )
            else:
                cigar = [(int(n_ops[i]), "M")]
                clip_ok = int(n_ops[i]) >= MIN_MATCH_LENGTH
            si = int(si_all[t])
            pos1 = int(pos1_all[t])
            if not clip_ok:
                # unsafe borders: run the real clip on a temp alignment
                aln = ReadAlignment(
                    sequence_name=names[si],
                    first=pos1,
                    cigar=cigar,
                    num_mismatches=int(mism_all[i]),
                )
                if not aln.clip_borders(MIN_MATCH_LENGTH):
                    continue
                cigar = aln.cigar
                pos1 = aln.first
            c = cands[i]
            c.aln = ReadAlignment(
                sequence_name=names[si],
                first=pos1,
                cigar=cigar,
                num_mismatches=int(mism_all[i]),
            )
            c.quality = int(qual_all[i])
