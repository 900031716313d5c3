"""ReadsAligner — the short-read aligner state and its tier-3 DP stage.

Ref: src/ngsep/alignments/ReadsAligner.java:53-534 (command
orchestration), SingleReadsAligner.java:46-145 (fwd+revcomp, candidate
filtering), ShortReadsUngappedSearchHitsClusterAligner.java:62-121
(3-tier alignment).

This holds what the fused align+call pipeline (call/fused_pipeline.py)
drives: the seed table, parameters and counters, the tier-3 affine-gap
sweep over device-gathered inputs (kernels/pairwise.dp_run_all) and its
host decode, and the batched sequence materialization of kept
alignments.  The classic `align_batch` flow (with
`select_final_alignments`) and tier-2 STR alignment are not part of
this slice (ROADMAP.md Queue 1, "Classic two-stage path" and "Tier-2
STR").
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.genome import ReferenceGenome
from ..core.sequences import RawRead, decode_dna, reverse_complement_codes
from ..index.minimizer_table import MinimizerTable
from .read_alignment import ReadAlignment

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


def _materialize_sequences(reads, mat_jobs, is_block) -> None:
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
            arrs.append(np.asarray(reverse_complement_codes(read.codes)))
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
        known_strs: dict[str, list] | None = None,
        *,
        device,
    ):
        if known_strs:
            raise NotImplementedError(
                "known STRs (tier-2 STR alignment): ROADMAP.md Queue 1, "
                "\"Tier-2 STR\""
            )
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
        self.known_strs = None
        # stats (ref: ReadsAligner printStatistics)
        self.total_reads = 0
        self.aligned_reads = 0
        self.few_mismatches_alns = 0
        self.complete_alns = 0
        self.dp_cells = 0  # DP cell updates issued to the device

    def align_batch(self, reads: list[RawRead]):
        raise NotImplementedError(
            "classic align_batch flow: ROADMAP.md Queue 1, "
            "\"Classic two-stage path\""
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

        from ..kernels.pairwise import dp_run_all
        from ..utils.profiling import stage

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
                    qlen[c0:c1].astype(np.int64),
                    firsts[c0:c1].astype(np.int64),
                    qget, out, concat, sink=sink, sink_off=c0,
                )

    @staticmethod
    def _rle_runs(out: dict, gsel, n_ops) -> dict:
        """Per-row cigar run lists from the fetched device-side RLE.

        The run-jump traceback (kernels/pairwise.affine_gap_align_runs)
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
            # the RLE comes left-aligned from the device
            # (kernels/pairwise._left_align_rle); only rows the device
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
        self, qlens, firsts, qget, out: dict, concat: np.ndarray,
        sink: dict, sink_off: int = 0,
    ) -> None:
        """Decode one fetched stats chunk into the DP result store:
        mismatch accept, then CIGARs.  The mismatch statistic, gap flag and
        the left-aligned RLE come precomputed from the device
        (kernels/pairwise.dp_stats_runs); per-row math is vectorized over
        the chunk."""
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

        # store mode (array-native selection): all per-row fields land
        # as vectorized slice writes; Python survives only for gapped
        # cigars (left-align) and sub-minimum-anchor rows
        self._tier3_decode_store(
            sink, sink_off, ok, has_gap, n_ops, start_j, mism_all,
            qual_all, si_all, pos1_all, firsts, out, concat, qget,
        )
