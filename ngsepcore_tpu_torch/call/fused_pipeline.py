"""Fused align+call pipeline: reads -> variant records with the hot path
on the device the caller names.

Ref: the reference runs ReadsAligner (ReadsAligner.java:53-534) to a BAM,
then SingleSampleVariantsDetector (SingleSampleVariantsDetector.java:589-656)
streams it back through the per-position pileup listener chain.

Here the two stages share one device-resident dataflow, the same as
ngsepcore_tpu/call/fused_pipeline.py: the packed read batch uploaded for
seeding (kernels/seeding.seed_cluster_screen) feeds the tier-3 DP gather
(kernels/pairwise.dp_run_all) and the shear-histogram pileup
(kernels/shear_pileup, kernels/genotyping.genotype_window_hist).  Reads
with a unique gapless placement away from indel evidence never become
host objects; gapped, ambiguous or indel-adjacent reads take the exact
host path (realigner, indel genotyper), and the records equal the JAX
package's.

The fused path needs `max_alns_per_read == 1` and `15 < min_mq <= 60`;
other settings run the classic two-stage flow (ReadsAligner.align_batch
then SingleSampleVariantsDetector.find_variants).  Runs with at most 29
distinct base qualities genotype through the shear histogram; runs with
more, or with no device-path reads, through the span-scatter genotyper
(kernels/genotyping.genotype_window_span).  With a known-STR catalogue
on the detector, reads near an STR take the host path: the tier-2 split
alignment (align/str_tier2.py, Gotoh launches with free query ends) and
the realigner's STR conciliation.

Host syncs on CUDA (each a device->host copy): the seeding/classify
fetch per batch, the tier-2 flank fetch per 256 jobs, the tier-3 stats
fetch per group, nonzero in the
genotyper, the per-sequence window bounds and the per-window result
fetch.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..align.read_alignment import ReadAlignment
from ..align.reads_aligner import ReadsAligner, _Candidate, _row_bucket
from ..core.genome import ReferenceGenome
from ..core.sequences import RawRead, pack_reads
from ..utils.profiling import enabled as profiling_enabled, stage
from ..vcf.io import VCFRecord

# a read whose single accepted placement might interact with indel
# realignment is demoted to the host path when it overlaps an indel or
# known-STR neighborhood padded by this many bases on each side (covers
# event-start moves, STR-span extension, and end trimming, all of which
# stay within one read length of the raw event: call/realigner.py)
INDEL_PAD = 16

# ASCII quality byte -> (clamped 0..30 quality) << 3, ready to OR into the
# packed code|qual byte (kernels/genotyping.MAX_BASE_QS clamp)
_QUAL_LUT3 = (
    np.clip(np.arange(256, dtype=np.int16) - 33, 0, 30) << 3
).astype(np.uint8)


@dataclass
class _BatchState:
    """Device handles + compact per-read arrays for one aligned batch."""

    reads: list[RawRead]
    fwd_mat: np.ndarray  # (Bk, Lp) int8 forward-strand codes (host)
    pq_dev: torch.Tensor  # (Bk, Lp) uint8 packed code|qual<<3, on the device
    lengths: np.ndarray  # (Bk,) int32
    # per-read accepted tier-1 placement (row i = read i; -1 where not fused)
    pred: np.ndarray
    cs: np.ndarray
    ce: np.ndarray
    mm: np.ndarray
    strand: np.ndarray
    fused: np.ndarray  # bool: unique tier-1 accept, candidate for device path
    host_alns: list[list[ReadAlignment]] = field(default_factory=list)
    cand_t2: list = field(default_factory=list)  # tier-2 STR candidates
    t1_cells: dict | None = None  # tier-1 host-cell arrays
    dp_meta: dict | None = None  # deferred tier-3 job arrays (device gather)
    read0: int = 0  # global index of this batch's first read (chunks vary)
    # realigner end-trims for fused reads inside indel neighborhoods
    # (alignment-space bases to ignore; folded into cs/ce at compaction)
    ig5: np.ndarray | None = None
    ig3: np.ndarray | None = None


class _ArrayReads:
    """Per-sequence registry of gapless fused reads inside indel/STR
    neighborhoods.  These reads STAY on the device pileup path; the
    realigner's end-trim pass and the indel genotyper's spanning calls
    operate on these arrays instead of per-read ReadAlignment objects.
    Sorted by (first, gorder)."""

    __slots__ = (
        "batches", "bi", "row", "gorder", "first", "last", "cs", "ce",
        "length", "strand", "max_span",
    )

    def __init__(self, batches, bi, row, gorder, first, last, cs, ce,
                 length, strand):
        self.batches = batches
        self.bi = bi
        self.row = row
        self.gorder = gorder
        self.first = first
        self.last = last
        self.cs = cs
        self.ce = ce
        self.length = length
        self.strand = strand
        self.max_span = int((last - first).max() + 1) if len(first) else 0

    def __len__(self):
        return len(self.first)

    def ig5(self, i: int) -> int:
        return int(self.batches[self.bi[i]].ig5[self.row[i]])

    def ig3(self, i: int) -> int:
        return int(self.batches[self.bi[i]].ig3[self.row[i]])

    def trim(self, first: int, last: int) -> None:
        """processEndsOfAlignments trim branch for gapless array reads
        (ref: IndelRealignerPileupListener.java:420-530; the has_indel
        branches are always False for gapless reads)."""
        from ..call.realigner import MIN_BP_GOOD_REF_ALN

        if not len(self.first):
            return
        lo = np.searchsorted(self.first, first - self.max_span, side="left")
        hi = np.searchsorted(self.first, last, side="right")
        for i in range(lo, hi):
            if self.last[i] < first:
                continue
            st = self.batches[self.bi[i]]
            r = self.row[i]
            if first - self.first[i] < MIN_BP_GOOD_REF_ALN:
                ig = last - self.first[i] + 1 + self.cs[i]
                if ig > st.ig5[r]:
                    st.ig5[r] = ig
            if self.last[i] - last < MIN_BP_GOOD_REF_ALN:
                ig = self.last[i] - first + 1 + self.ce[i]
                if ig > st.ig3[r]:
                    st.ig3[r] = ig

    def spanning_calls(self, first: int, last: int):
        """(first, gorder, SpanningCall) tuples for array reads reliably
        spanning [first, last] — mirrors indels.spanning_call_for for the
        gapless S/M/S case."""
        from .indels import SpanningCall

        out = []
        if not len(self.first):
            return out
        lo = np.searchsorted(self.first, first - self.max_span, side="left")
        hi = np.searchsorted(self.first, first, side="right")
        for i in range(lo, hi):
            af, al = int(self.first[i]), int(self.last[i])
            if al < last or af > first:
                continue
            cs, ce = int(self.cs[i]), int(self.ce[i])
            n = int(self.length[i])
            rp_f = cs + (first - af)
            rp_l = cs + (last - af)
            if cs and rp_f <= cs + 2:
                continue
            if ce and rp_l >= n - ce - 3:
                continue
            if rp_f < self.ig5(i):
                continue
            if rp_l >= n - self.ig3(i):
                continue
            st = self.batches[self.bi[i]]
            r = int(self.row[i])
            codes, quals = _read_slice_aln_space(
                st, r, n, rp_f, rp_l + 1, bool(self.strand[i])
            )
            out.append(
                (
                    af,
                    int(self.gorder[i]),
                    SpanningCall(
                        codes=np.ascontiguousarray(codes),
                        qualities=quals,
                        negative_strand=bool(self.strand[i]),
                    ),
                )
            )
        return out


def _read_slice_aln_space(st, row: int, n: int, a: int, b: int, rev: bool):
    """(codes, phred quals) of read `row` over alignment-space [a, b).

    The batch stores forward-orientation codes (fwd_mat) and the source
    ReadBlock/RawRead qualities; negative-strand alignment space is the
    reverse complement."""
    from ..core.sequences import ReadBlock, reverse_complement_codes

    if rev:
        fa, fb = n - b, n - a
        codes = reverse_complement_codes(st.fwd_mat[row, fa:fb])
    else:
        codes = st.fwd_mat[row, a:b]
    reads = st.reads
    if isinstance(reads, ReadBlock):
        if reads.quals is None:
            quals = np.full(b - a, reads.default_quality, np.int8)
        else:
            q = reads.quals[row]
            qs = q[n - b : n - a][::-1] if rev else q[a:b]
            quals = (qs.astype(np.int16) - 33).astype(np.int8)
    else:
        qstr = reads[row].qualities
        if qstr:
            qs = qstr[n - b : n - a][::-1] if rev else qstr[a:b]
            quals = (
                np.frombuffer(qs.encode("ascii"), np.uint8).astype(np.int16)
                - 33
            ).astype(np.int8)
        else:
            quals = np.full(b - a, 20, np.int8)
    return codes, quals


class AlignCallPipeline:
    """Single-sample align + SNV/indel call without the BAM roundtrip.

    Produces the same VCFRecord list as ngsepcore_tpu's AlignCallPipeline
    on the same reads.  `device` is where every tensor of the run lives:
    "cuda" launches the CUDA kernels, "cpu" runs their plain versions.
    """

    def __init__(
        self,
        genome: ReferenceGenome,
        aligner: ReadsAligner | None = None,
        detector=None,
        batch_size: int = 32768,
        *,
        device,
    ):
        from .single_sample import SingleSampleVariantsDetector

        self.genome = genome
        self.device = torch.device(device)
        self.aligner = aligner or ReadsAligner(genome, device=self.device)
        self.detector = detector or SingleSampleVariantsDetector(
            genome, device=self.device
        )
        self.batch_size = batch_size
        # cooperative cancellation (ref: ProgressNotifier.keepRunning
        # polled in run() loops); polled at batch and window boundaries
        self.progress_notifier = None
        # per-run distinct base qualities (raw ASCII histogram; clamped and
        # folded at compaction) for the adaptive shear-histogram binning
        self._qual_ascii_counts = np.zeros(256, np.int64)
        # known STRs drive both the aligner's tier-2 split alignment and
        # the realigner; the pipeline shares the detector's region lists
        # into the aligner so fused and classic flows see the same tiers
        if self.detector.known_strs and self.aligner.known_strs is None:
            self.aligner.known_strs = self.detector.known_strs
        # concat-coordinate STR neighborhoods: fused reads overlapping them
        # are demoted to the exact host path (tier-2 alignment + realigner
        # STR conciliation both need host alignment objects)
        self._str_iv_lo, self._str_iv_hi = self._build_str_intervals()
        self._str_iv_dev = None
        if len(self._str_iv_lo):
            self._str_iv_dev = (
                torch.from_numpy(self._str_iv_lo).to(self.device),
                torch.from_numpy(self._str_iv_hi).to(self.device),
            )
        # fused path preconditions: default single best alignment and a
        # mapping-quality threshold that multi-placement reads (MAPQ<=15)
        # and unique tier-1 reads fall on opposite sides of
        self._fusable = (
            self.aligner.max_alns_per_read == 1
            and 15 < self.detector.min_mq <= 60
        )
        self._offs_dev = torch.from_numpy(
            np.asarray(genome.offsets, np.int64)
        ).to(self.device)
        # the window genotyper; distribute/pipeline.py sets the sharded one
        self._span_kernel = None

    # ------------------------------------------------------------------
    def run_reads(self, reads: list[RawRead]) -> list[VCFRecord]:
        if not self._fusable:
            # classic two-stage flow: align every batch, then call
            alns: list[ReadAlignment] = []
            for i in range(0, len(reads), self.batch_size):
                for r in self.aligner.align_batch(reads[i : i + self.batch_size]):
                    alns.extend(r)
            return self.detector.find_variants(alns)
        # Chunks are descending powers of two (capped at batch_size), so
        # the tail chunk is not padded to a large row bucket
        spans: list[tuple[int, int]] = []
        i = 0
        n = len(reads)
        while n - i >= 4096:
            size = min(self.batch_size, 1 << ((n - i).bit_length() - 1))
            spans.append((i, i + size))
            i += size
        if i < n:
            spans.append((i, n))
        from ..utils.progress import check as _progress_check

        with stage("align.seed_dispatch"):
            seeded = []
            for bi, (a, b) in enumerate(spans):
                _progress_check(self.progress_notifier, bi)
                seeded.append(self._seed_batch(reads[a:b]))
        # groups of batches: each group's tier-3 sweep is issued before the
        # previous group's results are decoded on the host
        n_b = len(seeded)
        gsz = max(1, min(5, -(-n_b // 4)))
        groups = [
            list(range(a, min(a + gsz, n_b))) for a in range(0, n_b, gsz)
        ]
        batches: list[_BatchState] = []
        pending = None
        for gi, group in enumerate(groups):
            with stage("align.seed_fetch"):
                fetched = [self._fetch_seed_result(seeded[i]) for i in group]
            with stage("align.classify"):
                gbatches = []
                for i, clf in zip(group, fetched):
                    gbatches.append(self._classify_batch(*seeded[i][:4], clf))
                    gbatches[-1].read0 = spans[i][0]
            with stage("align.tier3_dp"):
                pend_g = self._tier3_dispatch_fused(gbatches)
            if pending is not None:
                self._tier3_finish_group(pending)
            pending = (gbatches, pend_g)
            batches.extend(gbatches)
        if pending is not None:
            self._tier3_finish_group(pending)
        return self._call(batches)

    # ------------------------------------------------------------------
    @staticmethod
    def _fetch_seed_result(seeded) -> dict:
        """Device classifier output of one seeded batch, as host numpy."""
        return {
            k: (v.cpu().numpy() if v.dim() else v.item())
            for k, v in seeded[4].items()
        }

    def _tier3_finish_group(self, pending) -> None:
        """Fetch + decode a group's tier-3 sweep and run final selection
        for its batches."""
        gbatches, pend_g = pending
        with stage("align.tier3_dp"):
            dp_store = self._tier3_finish_fused(pend_g)
        with stage("align.select_final"):
            j0 = 0
            for st in gbatches:
                j0 = self._select_batch(st, dp_store, j0)

    # ------------------------------------------------------------------
    def _tier3_dispatch_fused(self, batches: list[_BatchState]):
        """Launch tier-3 DP over the given batches' fallback candidates
        with inputs gathered on the device (kernels/pairwise
        .dp_gather_inputs) from the per-batch packed-read uploads
        concatenated into one group-wide matrix.  Returns a launch handle
        for _tier3_finish_fused, whose store (arrays + cigar dict) feeds
        the array-native selection (_select_batch)."""
        from ..kernels.shear_pileup import concat_reads

        metas = [st.dp_meta for st in batches]
        n_jobs = sum(len(m["row"]) for m in metas if m)
        if n_jobs == 0:
            return None
        Lp = max(st.fwd_mat.shape[1] for st in batches)
        bigpq = concat_reads(*[st.pq_dev for st in batches], lanes=Lp)
        row_off = np.cumsum(
            [0] + [st.fwd_mat.shape[0] for st in batches]
        )
        lengths_dev = torch.from_numpy(
            np.concatenate([st.lengths for st in batches]).astype(np.int32)
        ).to(self.device)
        bigpq, lengths_dev = self._prepare_tier3_arrays(bigpq, lengths_dev)
        rows_l, str_l, ql_l, f_l, l_l, bi_l = [], [], [], [], [], []
        for bi, m in enumerate(metas):
            if not m:
                continue
            rows_l.append(row_off[bi] + m["row"])
            str_l.append(m["strand"])
            ql_l.append(m["qlen"])
            f_l.append(m["first"])
            l_l.append(m["last"])
            bi_l.append(np.full(len(m["row"]), bi, np.int32))
        rows = np.concatenate(rows_l).astype(np.int64)
        strand = np.concatenate(str_l).astype(np.int32)
        qlen = np.concatenate(ql_l).astype(np.int64)
        firsts = np.concatenate(f_l).astype(np.int64)
        lasts = np.concatenate(l_l).astype(np.int64)
        bi_all = np.concatenate(bi_l)
        row_local = np.concatenate([m["row"] for m in metas if m])

        def qget(i: int) -> np.ndarray:
            # host query codes, only for rows the device left-align could
            # not normalize (la_fallback)
            st = batches[int(bi_all[i])]
            r = int(row_local[i])
            ql = int(qlen[i])
            row = st.fwd_mat[r, :ql]
            if not strand[i]:
                return row
            from ..core.sequences import reverse_complement_codes

            return reverse_complement_codes(row)

        store = {
            "acc": np.zeros(n_jobs, bool),
            "q": np.zeros(n_jobs, np.int64),
            "si": np.zeros(n_jobs, np.int64),
            "pos1": np.zeros(n_jobs, np.int64),
            "mism": np.zeros(n_jobs, np.int64),
            "cs": np.zeros(n_jobs, np.int64),
            "ce": np.zeros(n_jobs, np.int64),
            "mlen": np.zeros(n_jobs, np.int64),
            "gapless": np.zeros(n_jobs, bool),
            "cigar": {},
            "ridx": row_local,
            "strand": strand,
            "qlen": qlen,
            "bi": bi_all,
        }

        pend = self.aligner._tier3_dispatch_dev(
            rows, strand, qlen, firsts, lasts, bigpq, lengths_dev
        )
        return {"pend": pend, "store": store, "qget": qget}

    def _prepare_tier3_arrays(self, bigpq, lengths_dev):
        """Mesh seam: the sharded pipeline puts the DP gather operands on
        each of its devices (distribute/pipeline.py)."""
        return bigpq, lengths_dev

    def _tier3_finish_fused(self, launched) -> dict | None:
        """Fetch + decode a _tier3_dispatch_fused launch into its store."""
        if launched is None:
            return None
        self.aligner._tier3_finish_dev(
            launched["pend"], launched["qget"], sink=launched["store"]
        )
        return launched["store"]

    # ------------------------------------------------------------------
    def _select_batch(self, st: _BatchState, dp_store: dict | None,
                      j0: int) -> int:
        """Array-native candidate selection for one batch: the per-read
        combine+filter of select_final_alignments (ref:
        SingleReadsAligner.filterAlignments:118-143) over the tier-2
        object lane, the tier-1 cell arrays and the DP result store —
        then DIRECT fusion of single gapless winners onto the device
        pileup path (the role _late_fuse played), so candidate/alignment
        objects exist only for winners that genuinely need the host path
        (gapped reads, STR-overlapping reads, multi-alignments).

        Returns the store offset past this batch's DP jobs."""
        from ..align.read_alignment import FLAG_READ_REVERSE
        from ..align.reads_aligner import _materialize_sequences
        from ..core.sequences import ReadBlock

        al = self.aligner
        det = self.detector
        offs = self.genome.offsets
        nt2 = len(st.cand_t2)
        t1 = st.t1_cells
        nt1 = len(t1["ridx"]) if t1 else 0
        ndp = len(st.dp_meta["row"]) if st.dp_meta else 0
        j1 = j0 + ndp
        st.dp_meta = None
        if nt2 + nt1 + ndp == 0:
            return j1
        z = np.zeros(0, np.int64)
        t2_ridx = np.fromiter((c.read_idx for c in st.cand_t2), np.int64, nt2)
        t2_q = np.fromiter((c.quality for c in st.cand_t2), np.int64, nt2)
        ridx = np.concatenate([
            t2_ridx, t1["ridx"] if t1 else z,
            dp_store["ridx"][j0:j1] if ndp else z,
        ])
        q = np.concatenate([
            t2_q, t1["q"] if t1 else z,
            dp_store["q"][j0:j1] if ndp else z,
        ])
        valid = np.concatenate([
            np.ones(nt2, bool), np.ones(nt1, bool),
            dp_store["acc"][j0:j1] if ndp else np.zeros(0, bool),
        ])
        # kind 0 = tier-2 candidate, 1 = tier-1 cell, 2 = DP job
        kind = np.concatenate([
            np.zeros(nt2, np.int8), np.ones(nt1, np.int8),
            np.full(ndp, 2, np.int8),
        ])
        pay = np.concatenate([
            np.arange(nt2, dtype=np.int64),
            np.arange(nt1, dtype=np.int64),
            j0 + np.arange(ndp, dtype=np.int64),
        ])
        sel = np.nonzero(valid)[0]
        if not len(sel):
            return j1
        ridx, q, kind, pay = ridx[sel], q[sel], kind[sel], pay[sel]
        # (read, quality desc, arrival) — ties resolve by arrival order
        # exactly like the stable sort over the legacy candidate list
        order = np.lexsort((np.arange(len(sel)), -q, ridx))
        rs, qs, ks, ps = ridx[order], q[order], kind[order], pay[order]
        newg = np.ones(len(rs), bool)
        newg[1:] = rs[1:] != rs[:-1]
        gid = np.cumsum(newg) - 1
        gstart = np.nonzero(newg)[0]
        best = qs[gstart][gid]
        # unified accept rule: q > trunc(0.8*best) reproduces both the
        # multi-candidate threshold and the single-candidate q>0 check
        thr = np.trunc(0.8 * best).astype(np.int64)
        kept = qs > thr
        nk = np.zeros(len(gstart), np.int64)
        np.add.at(nk, gid, kept)
        rank = np.arange(len(rs)) - gstart[gid]
        capped = kept & (rank < al.max_alns_per_read)
        nkg = nk[gid]
        qf = np.where(
            nkg > 1,
            np.rint(0.3 * qs / np.maximum(nkg, 1)).astype(np.int64),
            qs,
        )
        qf = np.clip(qf, 0, 255)
        al.aligned_reads += int((nk > 0).sum())

        w = np.nonzero(capped)[0]
        # ---- direct fusion of single gapless winners --------------------
        single = (nkg[w] == 1) & (qf[w] >= det.min_mq)
        wk, wp, wr = ks[w], ps[w], rs[w]
        ln_w = st.lengths[wr].astype(np.int64)
        pred_w = np.zeros(len(w), np.int64)
        cs_w = np.zeros(len(w), np.int64)
        ce_w = np.zeros(len(w), np.int64)
        mm_w = np.zeros(len(w), np.int64)
        str_w = np.zeros(len(w), np.int64)
        fusable = np.zeros(len(w), bool)
        m1 = wk == 1
        if m1.any() and t1:
            p1 = wp[m1]
            pred_w[m1] = t1["pred"][p1]
            cs_w[m1] = t1["cs"][p1]
            ce_w[m1] = t1["ce"][p1]
            mm_w[m1] = t1["mm"][p1]
            str_w[m1] = t1["strand"][p1]
            fusable[m1] = True  # t1 cigars span the row by construction
        m2 = wk == 2
        if m2.any():
            p2 = wp[m2]
            gl = dp_store["gapless"][p2]
            cs2 = dp_store["cs"][p2]
            ce2 = dp_store["ce"][p2]
            pred_w[m2] = (
                offs[dp_store["si"][p2]] + dp_store["pos1"][p2] - 1 - cs2
            )
            cs_w[m2] = cs2
            ce_w[m2] = ce2
            mm_w[m2] = dp_store["mism"][p2]
            str_w[m2] = dp_store["strand"][p2]
            fusable[m2] = gl & (
                cs2 + dp_store["mlen"][p2] + ce2 == dp_store["qlen"][p2]
            )
        fusable &= single
        if len(self._str_iv_lo):
            first = pred_w
            last = pred_w + ln_w
            k = np.searchsorted(self._str_iv_lo, last, side="right") - 1
            k = np.clip(k, 0, len(self._str_iv_lo) - 1)
            overl = (self._str_iv_lo[k] <= last) & (self._str_iv_hi[k] >= first)
            fusable &= ~overl  # STR conciliation needs the host object
        fsel = np.nonzero(fusable)[0]
        if len(fsel):
            fr = wr[fsel]
            st.fused[fr] = True
            st.pred[fr] = pred_w[fsel]
            st.cs[fr] = cs_w[fsel]
            st.ce[fr] = ce_w[fsel]
            st.mm[fr] = mm_w[fsel]
            st.strand[fr] = str_w[fsel]

        # ---- host-object winners ---------------------------------------
        rest = np.nonzero(~fusable)[0]
        if len(rest):
            is_block = isinstance(st.reads, ReadBlock)
            names_blk = st.reads.names if is_block else None
            gnames = [
                self.genome.sequence_name(i)
                for i in range(self.genome.num_sequences)
            ]
            mat_jobs = []
            for t in rest:
                wi = w[t]
                k_, p_, r_ = int(ks[wi]), int(ps[wi]), int(rs[wi])
                if k_ == 0:
                    cand = st.cand_t2[p_]
                    aln = cand.aln
                    rev = cand.reverse
                elif k_ == 1:
                    tcs = int(t1["cs"][p_])
                    tce = int(t1["ce"][p_])
                    ql = int(st.lengths[r_])
                    cigar = []
                    if tcs > 0:
                        cigar.append((tcs, "S"))
                    cigar.append((ql - tcs - tce, "M"))
                    if tce > 0:
                        cigar.append((tce, "S"))
                    si = int(t1["si"][p_])
                    aln = ReadAlignment(
                        sequence_name=gnames[si],
                        first=int(t1["pred"][p_]) + tcs - int(offs[si]) + 1,
                        cigar=cigar,
                        num_mismatches=int(t1["mm"][p_]),
                    )
                    aln._indel_calls = []  # S/M/S by construction
                    rev = bool(t1["strand"][p_])
                else:
                    # gapless DP rows carry no cigar entry (the vectorized
                    # decode skips Python for them): single M run
                    cig = dp_store["cigar"].get(p_)
                    single_m = cig is None
                    if cig is None:
                        cig = [(int(dp_store["mlen"][p_]), "M")]
                    aln = ReadAlignment(
                        sequence_name=gnames[int(dp_store["si"][p_])],
                        first=int(dp_store["pos1"][p_]),
                        cigar=cig,
                        num_mismatches=int(dp_store["mism"][p_]),
                    )
                    if single_m:
                        aln._indel_calls = []
                    rev = bool(dp_store["strand"][p_])
                if is_block:
                    aln.read_name = (
                        names_blk[r_] if names_blk is not None
                        else f"read_{r_}"
                    )
                else:
                    aln.read_name = st.reads[r_].name
                if rev:
                    aln.flags |= FLAG_READ_REVERSE
                if rank[wi] > 0:
                    aln.set_secondary(True)
                aln.alignment_quality = int(qf[wi])
                st.host_alns[r_].append(aln)
                mat_jobs.append((aln, r_, rev))
            _materialize_sequences(st.reads, mat_jobs, None, is_block)
        st.cand_t2 = []
        st.t1_cells = None
        return j1

    # ------------------------------------------------------------------
    def _build_str_intervals(self):
        """Merged concat-coordinate [lo, hi] neighborhoods of the known STR
        regions (padded like the indel demotion intervals)."""
        strs = self.detector.known_strs
        if not strs:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        offs = self.genome.offsets
        ivs = []
        for si in range(self.genome.num_sequences):
            regions = strs.get(self.genome.sequence_name(si))
            if not regions:
                continue
            base = int(offs[si])
            for r in regions:
                ivs.append(
                    (base + r.first - 1 - INDEL_PAD, base + r.last + INDEL_PAD)
                )
        ivs.sort()
        merged = [list(ivs[0])]
        for lo, hi in ivs[1:]:
            if lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        return (
            np.array([m[0] for m in merged], np.int64),
            np.array([m[1] for m in merged], np.int64),
        )

    # ------------------------------------------------------------------
    def _put_reads(self, pq: np.ndarray):
        """Upload one packed read batch (mesh seam: the sharded pipeline
        uploads one row block a shard)."""
        return torch.from_numpy(pq).to(self.device)

    def _device_put_repl(self, x: np.ndarray) -> torch.Tensor:
        """Upload an array every window reads (mesh seam: the sharded
        pipeline also puts a copy on each of its devices)."""
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _seed_screen(self, pq_dev, lengths_h: np.ndarray, const_len):
        """seed_cluster_screen on an uploaded batch (mesh seam: the sharded
        pipeline seeds each row block on its shard).  Returns (the packed
        batch, its lengths and the seeding outputs) on the pipeline's
        device."""
        from ..kernels.seeding import seed_cluster_screen

        al = self.aligner
        lengths_dev = torch.from_numpy(lengths_h).to(self.device)
        gp, gn2 = self.genome.device_packed(self.device)
        res = seed_cluster_screen(
            pq_dev, lengths_dev, al.table.device_arrays(self.device), gp, gn2,
            k=al.kmer_length,
            window=al.window_length,
            genome_len=self.genome.total_length,
            const_len=const_len,
            genome_has_n=self.genome.has_n,
        )
        return pq_dev, lengths_dev, res

    def _seed_batch(self, reads):
        """Pack + upload one batch and run the seeding and classification
        on the pipeline's device; returns everything _classify_batch
        needs.  `reads` is a ReadBlock (dense matrices straight from
        IO/simulators) or a list of RawRead objects."""
        from ..core.sequences import ReadBlock

        al = self.aligner
        B = len(reads)
        al.total_reads += B
        bucket = _row_bucket(B, minimum=128)
        if isinstance(reads, ReadBlock):
            Lb = reads.codes.shape[1]
            Lp = -(-Lb // al.read_pad) * al.read_pad
            fwd_mat = np.full((bucket, Lp), 4, np.int8)
            fwd_mat[:B, :Lb] = reads.codes
            lengths_h = np.zeros(bucket, np.int32)
            lengths_h[:B] = reads.lengths
            if reads.quals is not None:
                qmat = np.zeros((bucket, Lp), np.uint8)
                qmat[:B, :Lb] = reads.quals
                # pad lanes hold byte 0 (never a real quality, ASCII >= 33)
                counts = np.bincount(qmat[:B].ravel(), minlength=256)
                counts[0] = 0
                self._qual_ascii_counts += counts
            else:
                qb = 33 + min(reads.default_quality, 93)
                qmat = np.full((bucket, Lp), qb, np.uint8)
                self._qual_ascii_counts[qb] += int(reads.lengths.sum())
            cl = (
                int(lengths_h[0])
                if B and np.all(reads.lengths == reads.lengths[0])
                else None
            )
        else:
            pad_blk = [np.empty(0, np.int8)] * (bucket - B)
            fwd_mat, lengths_h, _ = pack_reads(
                [r.codes for r in reads] + pad_blk, pad_multiple=al.read_pad
            )
            lengths_h = lengths_h.astype(np.int32)
            Lp = fwd_mat.shape[1]
            # quality rows in read orientation; '5' (q=20) when absent,
            # matching select_final_alignments' default
            qmat = np.full((bucket, Lp), ord("5"), np.uint8)
            qparts = [
                r.qualities if r.qualities else "5" * len(r.sequence)
                for r in reads
            ]
            qflat = np.frombuffer("".join(qparts).encode("ascii"), np.uint8)
            row_len = lengths_h[:B].astype(np.int64)
            rl0 = int(row_len[0]) if B else 0
            if B and len(qflat) == B * rl0:
                qmat[:B, :rl0] = qflat.reshape(B, rl0)
            else:
                row_start = np.repeat(np.arange(B, dtype=np.int64) * Lp, row_len)
                col = np.arange(len(qflat), dtype=np.int64) - np.repeat(
                    np.concatenate([[0], np.cumsum(row_len)[:-1]]), row_len
                )
                qmat.ravel()[row_start + col] = qflat
            if B:
                self._qual_ascii_counts += np.bincount(qflat, minlength=256)
            cl = (
                int(lengths_h[0])
                if B and np.all(lengths_h[:B] == lengths_h[0])
                else None
            )
        # one byte per base: bits 0-2 code, bits 3-7 quality pre-clamped to
        # 0..30 (kernels/genotyping.MAX_BASE_QS); the single upload serves
        # seeding (which masks the code bits), the tier-3 gather and the
        # pileup
        pq = (fwd_mat.view(np.uint8) & 7) | _QUAL_LUT3[qmat]
        pq_dev, lengths_dev, res = self._seed_screen(self._put_reads(pq), lengths_h, cl)
        clf = self._dispatch_classify(res, lengths_dev)
        return reads, fwd_mat, lengths_h, pq_dev, clf

    def _dispatch_classify(self, res_dev, lengths_dev):
        """On-device candidate classifier for one seeded batch
        (kernels/seeding.classify_candidates)."""
        from ..kernels.seeding import classify_candidates

        return classify_candidates(
            res_dev["pred_start"], res_dev["weight"], res_dev["strand"],
            res_dev["mismatches"], res_dev["clip_start"], res_dev["clip_end"],
            lengths_dev, self._offs_dev, int(self.detector.min_mq),
            *(self._str_iv_dev or ()),
        )

    # ------------------------------------------------------------------
    def _classify_batch(self, reads, fwd_mat, lengths_h, pq_dev, clf) -> _BatchState:
        """Build the batch state from the device classifier's output
        (`clf`, already fetched).  Host work reduces to the tier-2 jobs of
        the host cells over a known STR and to compacting the tier-1 cells
        and DP jobs of the rest, in row-major cell order."""
        al = self.aligner
        B = len(reads)
        offs = self.genome.offsets
        fused = np.array(clf["fused"][:B], dtype=bool)
        sel_pred = clf["sel_pred"][:B].astype(np.int64)
        sel_ab = clf["sel_ab"][:B]
        al.aligned_reads += int(clf["aligned_extra"])
        al.few_mismatches_alns += int(clf["fused_count"])
        al.aligned_reads += int(clf["fused_count"])

        # compact the dense cell lanes host-side (row-major order kept)
        C = clf["cell_mask"].shape[0] // clf["fused"].shape[0]
        sel = np.nonzero(clf["cell_mask"])[0]
        n_cells = len(sel)
        cand_t2: list[_Candidate] = []
        t1_cells = None
        dp_meta = None
        if n_cells:
            l2 = clf["cell_l2"][sel]
            l3 = clf["cell_l3"][sel]
            ridx_a = (sel // C).astype(np.int64)
            pred_a = clf["cell_pred"][sel].astype(np.int64)
            w_a = l2 & 0xFFFF
            col_a = (l2 >> 16) & 15
            t1_a = ((l2 >> 20) & 1).astype(bool)
            strand_a = (l2 >> 21) & 1
            mm_a = l3 & 0x3FF
            cs_a = (l3 >> 10) & 0x3FF
            ce_a = (l3 >> 20) & 0x3FF
            si_a = np.clip(
                np.searchsorted(offs, pred_a, side="right") - 1,
                0,
                self.genome.num_sequences - 1,
            )
            t2_hits: dict = {None: set()}
            if al.tier2 is not None:
                with stage("align.tier2_str"):
                    t2_hits = al._tier2_pass(
                        (
                            (
                                int(ridx_a[i]), int(col_a[i]), int(si_a[i]),
                                int(pred_a[i]), int(strand_a[i]), float(w_a[i]),
                            )
                            for i in range(n_cells)
                        ),
                        lengths_h, fwd_mat, None,
                    )
                for cell, cand in t2_hits.items():
                    if cell is not None:
                        cand_t2.append(cand)
            # tier-1 / DP cells stay ARRAYS: per-cell alignments
            # materialize only for selection winners that need the host
            # path (_select_batch)
            t1sel = np.nonzero(t1_a)[0]
            dpsel = np.nonzero(~t1_a)[0]
            if len(t2_hits) > 1:  # only the None sentinel when no STRs hit
                hitset = t2_hits.keys()
                t1sel = np.array(
                    [i for i in t1sel
                     if (int(ridx_a[i]), int(col_a[i])) not in hitset],
                    dtype=np.int64,
                )
                dpsel = np.array(
                    [i for i in dpsel
                     if (int(ridx_a[i]), int(col_a[i])) not in hitset],
                    dtype=np.int64,
                )
            if len(t1sel):
                t1_cells = {
                    "ridx": ridx_a[t1sel].astype(np.int64),
                    "pred": pred_a[t1sel],
                    "strand": strand_a[t1sel].astype(np.int32),
                    "mm": mm_a[t1sel].astype(np.int64),
                    "cs": cs_a[t1sel].astype(np.int64),
                    "ce": ce_a[t1sel].astype(np.int64),
                    "si": si_a[t1sel].astype(np.int64),
                    "q": np.rint(100 - 5 * mm_a[t1sel]).astype(np.int64),
                }
            # DP job meta arrays (windows too distorted to align are
            # rejected); query codes are gathered on the device
            if len(dpsel):
                ql = lengths_h[ridx_a[dpsel]].astype(np.int64)
                s0 = offs[si_a[dpsel]]
                s1 = offs[si_a[dpsel] + 1]
                jf = np.maximum(s0, pred_a[dpsel] - 3)
                jl = np.minimum(s1, pred_a[dpsel] + ql + 3)
                d = jl - jf
                jkeep = np.nonzero((d <= 1.5 * ql) & (d >= 0.5 * ql))[0]
                if len(jkeep):
                    dp_meta = {
                        "row": ridx_a[dpsel][jkeep].astype(np.int64),
                        "strand": strand_a[dpsel][jkeep].astype(np.int32),
                        "qlen": ql[jkeep],
                        "first": jf[jkeep],
                        "last": jl[jkeep],
                    }

        return _BatchState(
            reads=reads,
            fwd_mat=fwd_mat,
            pq_dev=pq_dev,
            lengths=lengths_h,
            pred=np.where(fused, sel_pred, -1).astype(np.int64),
            cs=((sel_ab >> 11) & 0x3FF).astype(np.int32),
            ce=((sel_ab >> 21) & 0x3FF).astype(np.int32),
            mm=(sel_ab & 0x3FF).astype(np.int32),
            strand=((sel_ab >> 10) & 1).astype(np.int32),
            fused=fused,
            host_alns=[[] for _ in range(B)],
            cand_t2=cand_t2,
            t1_cells=t1_cells,
            dp_meta=dp_meta,
        )

    # ------------------------------------------------------------------
    def _call(self, batches: list[_BatchState]) -> list[VCFRecord]:
        """Joint variant calling across the fused (device) and host paths."""
        det = self.detector
        min_mq = det.min_mq

        # host alignments tagged with global read order (batch-major), so
        # arrival order matches what the classic two-stage flow sees —
        # cap ties and indel-call ordering depend on it
        host_tagged: list[tuple[int, ReadAlignment]] = []
        for bi, st in enumerate(batches):
            b0 = st.read0
            for row, per_read in enumerate(st.host_alns):
                for a in per_read:
                    if not a.is_unmapped and a.alignment_quality >= min_mq:
                        host_tagged.append((b0 + row, a))
        host = [a for _, a in host_tagged]

        # indel/STR neighborhoods (concat coords) that demote fused reads
        # to the exact host path: raw indel events in any host alignment
        offs = self.genome.offsets
        name_to_idx = {
            self.genome.sequence_name(i): i
            for i in range(self.genome.num_sequences)
        }
        ivs: list[tuple[int, int]] = []
        with stage("call.indel_neighborhoods"):
            for a in host:
                calls = a.indel_calls()
                if not calls:
                    continue
                base = int(offs[name_to_idx[a.sequence_name]])
                read_len = len(a.read_chars) if a.read_chars else 256
                for c0, c1, length in calls:
                    lo = base + c0 - INDEL_PAD - max(length, c1 - c0 + 1)
                    hi = base + c1 + INDEL_PAD + max(length, c1 - c0 + 1) + read_len
                    ivs.append((lo, hi))
            if profiling_enabled():
                import sys as _sys

                print(
                    f"[nbh] host={len(host)} ivs={len(ivs)}", file=_sys.stderr
                )
        if ivs:
            ivs.sort()
            merged = [list(ivs[0])]
            for lo, hi in ivs[1:]:
                if lo <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], hi)
                else:
                    merged.append([lo, hi])
            iv_lo = np.array([m[0] for m in merged], dtype=np.int64)
            iv_hi = np.array([m[1] for m in merged], dtype=np.int64)
        else:
            iv_lo = iv_hi = np.empty(0, np.int64)

        # joint per-start cap in arrival order (AlignmentsPileupGenerator
        # caps 5 alignments per start position; pileup.cap_alignments_per_start)
        with stage("call.joint_cap"):
            self._joint_cap(batches, host_tagged)
        host = [a for _, a in host_tagged]

        # fused reads overlapping an indel neighborhood STAY on the device
        # pileup path; they are registered per sequence so the realigner
        # can trim their ends (st.ig5/ig3, folded into cs/ce at compaction)
        # and the indel genotyper can take spanning calls from the packed
        # arrays — no ReadAlignment objects are materialized
        offs = self.genome.offsets
        arr_by_seq: dict[int, _ArrayReads] = {}
        with stage("call.trim_registry"):
            parts: dict[int, list] = {}
            for bi, st in enumerate(batches):
                st.ig5 = np.zeros(len(st.fused), np.int32)
                st.ig3 = np.zeros(len(st.fused), np.int32)
                if not len(iv_lo):
                    continue
                rows = np.nonzero(st.fused)[0]
                if not len(rows):
                    continue
                first = st.pred[rows] + st.cs[rows]  # 0-based concat
                last = st.pred[rows] + st.lengths[rows].astype(np.int64) - st.ce[rows]
                k = np.searchsorted(iv_lo, last, side="right") - 1
                k = np.clip(k, 0, len(iv_lo) - 1)
                overl = (iv_lo[k] <= last) & (iv_hi[k] >= first)
                sel = rows[overl]
                if not len(sel):
                    continue
                si = np.clip(
                    np.searchsorted(offs, first[overl], side="right") - 1,
                    0,
                    self.genome.num_sequences - 1,
                )
                f1 = first[overl] - offs[si] + 1  # 1-based first aligned base
                l1 = last[overl] - offs[si]  # 1-based last aligned base
                for s in np.unique(si):
                    m = si == s
                    parts.setdefault(int(s), []).append(
                        (
                            np.full(m.sum(), bi, np.int32),
                            sel[m].astype(np.int64),
                            st.read0 + sel[m].astype(np.int64),
                            f1[m],
                            l1[m],
                            st.cs[sel[m]].astype(np.int64),
                            st.ce[sel[m]].astype(np.int64),
                            st.lengths[sel[m]].astype(np.int64),
                            st.strand[sel[m]].astype(np.int64),
                        )
                    )
            for s, chunks in parts.items():
                cols = [np.concatenate([c[j] for c in chunks]) for j in range(9)]
                o = np.lexsort((cols[2], cols[3]))  # by (first, gorder)
                arr_by_seq[s] = _ArrayReads(
                    batches, *(c[o] for c in cols[:2]), *(c[o] for c in cols[2:])
                )

        # per-sequence host work shared by both genotype paths: realign
        # (mutates host objects, writes array-read trims), indel-site
        # genotyping over merged host+array spanning calls, device
        # base-call expansion.  Precomputed HERE so compaction sees the
        # final trims.
        from .aln_table import AlnTable
        from .realigner import IndelRealigner

        det = self.detector
        by_seq: dict[str, list[tuple[int, ReadAlignment]]] = {}
        for go, a in host_tagged:
            by_seq.setdefault(a.sequence_name, []).append((go, a))
        self._seq_host = {}
        for si in range(self.genome.num_sequences):
            name = self.genome.sequence_name(si)
            tagged = by_seq.get(name, [])
            tagged.sort(key=lambda t: (t[1].first, t[0]))
            alns = [a for _, a in tagged]
            go = np.fromiter((g for g, _ in tagged), np.int64, len(tagged))
            arr = arr_by_seq.get(si)
            realigner = IndelRealigner(
                self.genome, si, det.known_strs.get(name)
            )
            with stage("call.realign"):
                sites = realigner.realign(alns, array_reads=arr) if alns else []
            # one columnar table per sequence (built AFTER realignment so
            # CIGAR moves and end-trims are final) feeds both the indel
            # genotyper and the base-call expansion
            with stage("call.aln_table"):
                table = AlnTable(alns, go)
            with stage("call.indel_genotype"):
                indel_records = (
                    det._call_indels(
                        si, name, alns, sites, gorder=go, array_reads=arr,
                        table=table,
                    )
                    if sites
                    else []
                )
            with stage("call.expand_host_calls"):
                # device expansion: the run table + flat codes/quals
                # upload once per sequence; per-base expansion, packing
                # and the position sort all happen on device
                # (kernels/genotyping.expand_mrun_calls)
                devc = table.device_calls(self.device)
            self._seq_host[si] = (indel_records, devc)

        # per-sequence windows: accumulate both paths into shared device
        # tensors, genotype sparsely
        return self._genotype(batches, host)

    # ------------------------------------------------------------------
    def _joint_cap(
        self,
        batches: list[_BatchState],
        host_tagged: list[tuple[int, ReadAlignment]],
    ):
        """Per-start cap over BOTH paths in global arrival order, exactly
        like cap_alignments_per_start over the classic merged alignment
        list (ref: AlignmentsPileupGenerator.java:415-420)."""
        cap = self.detector.max_alns_per_start
        offs = self.genome.offsets
        name_to_idx = {
            self.genome.sequence_name(i): i
            for i in range(self.genome.num_sequences)
        }
        # fused entries as flat arrays (one Python tuple per read at run
        # scale was a full second of wall-clock by itself)
        go_parts, st_parts, bi_parts, row_parts = [], [], [], []
        for bi, st in enumerate(batches):
            rows = np.nonzero(st.fused)[0]
            if not len(rows):
                continue
            go_parts.append(st.read0 + rows.astype(np.int64))
            st_parts.append(st.pred[rows] + st.cs[rows])
            bi_parts.append(np.full(len(rows), bi, np.int32))
            row_parts.append(rows.astype(np.int64))
        nf = sum(len(p) for p in go_parts)
        nh = len(host_tagged)
        if nf + nh == 0:
            return
        gorder = np.empty(nf + nh, np.int64)
        starts = np.empty(nf + nh, np.int64)
        if nf:
            gorder[:nf] = np.concatenate(go_parts)
            starts[:nf] = np.concatenate(st_parts)
        for ai, (go, a) in enumerate(host_tagged):
            base = int(offs[name_to_idx[a.sequence_name]])
            gorder[nf + ai] = go
            starts[nf + ai] = base + a.first - 1
        # arrival order = global read order; rank within each start group
        o1 = np.argsort(gorder, kind="stable")
        ss = starts[o1]
        order = np.argsort(ss, kind="stable")
        sss = ss[order]
        newgrp = np.concatenate([[True], sss[1:] != sss[:-1]])
        grp_start_pos = np.nonzero(newgrp)[0]
        gid = np.cumsum(newgrp) - 1
        rank = np.arange(len(sss)) - grp_start_pos[gid]
        keep_sorted = np.empty(len(sss), bool)
        keep_sorted[order] = rank < cap
        keep = np.empty(nf + nh, bool)
        keep[o1] = keep_sorted
        if keep.all():
            return
        if nf:
            bi_all = np.concatenate(bi_parts)
            row_all = np.concatenate(row_parts)
            fdrop = ~keep[:nf]
            for bi in np.unique(bi_all[fdrop]):
                m = fdrop & (bi_all == bi)
                batches[bi].fused[row_all[m]] = False  # dropped from counting
        hkeep = keep[nf:]
        if not hkeep.all():
            host_tagged[:] = [t for t, k in zip(host_tagged, hkeep) if k]

    # ------------------------------------------------------------------
    def _genotype(
        self, batches: list[_BatchState], host: list[ReadAlignment]
    ) -> list[VCFRecord]:
        """Dispatch: the shear-histogram path by default, the span-scatter
        path for runs with no device-path reads or more than 29 distinct
        base qualities (the 7-bit stage byte cannot bin those)."""
        with stage("call.compact_fused"):
            fused = self._compact_hist(batches)
        if fused is None:
            return self._genotype_span(batches, host)
        return self._genotype_hist(batches, host, fused)

    # ------------------------------------------------------------------
    def _compact_fused(self, batches: list[_BatchState]):
        """Place every batch's fused rows into one run-wide packed-read
        matrix on the device, sorted by predicted start, so each window's
        reads are one contiguous row range (genotype_window_span).  The
        read bytes come from the batch matrices already on the device; the
        per-read meta (final placements, realigner trims folded into the
        clips) comes from the host arrays."""
        from ..kernels.genotyping import (
            META_CE,
            META_COLS,
            META_CS,
            META_LEN,
            META_PRED,
            META_STRAND,
            place_fused_rows,
        )

        rows_per = [np.nonzero(st.fused)[0] for st in batches]
        F = sum(len(r) for r in rows_per)
        if F == 0:
            return None
        maxlen = max(
            int(st.lengths[r].max()) for st, r in zip(batches, rows_per) if len(r)
        )
        Lp = min(
            max(st.fwd_mat.shape[1] for st, r in zip(batches, rows_per) if len(r)),
            (maxlen + 15) & ~15,
        )
        pred_h = np.concatenate(
            [st.pred[r] for st, r in zip(batches, rows_per) if len(r)]
        )
        order = np.argsort(pred_h, kind="stable")
        inv = np.empty(F, np.int64)
        inv[order] = np.arange(F)
        dev = self.device
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        pq = torch.zeros((F, Lp), dtype=torch.uint8, device=dev)
        meta_h = np.zeros((F, META_COLS), np.int64)
        r0 = 0
        for st, rows in zip(batches, rows_per):
            if not len(rows):
                continue
            nb = len(rows)
            dst_rows = inv[r0 : r0 + nb]
            cs_eff = st.cs[rows].astype(np.int64)
            ce_eff = st.ce[rows].astype(np.int64)
            if st.ig5 is not None:  # realigner end-trims fold into clips
                ln = st.lengths[rows].astype(np.int64)
                cs_eff = np.maximum(cs_eff, st.ig5[rows])
                ce_eff = np.minimum(
                    np.maximum(ce_eff, st.ig3[rows]), ln - cs_eff
                )
            meta_h[dst_rows, META_PRED] = st.pred[rows]
            meta_h[dst_rows, META_CS] = cs_eff
            meta_h[dst_rows, META_CE] = ce_eff
            meta_h[dst_rows, META_STRAND] = np.clip(st.strand[rows], 0, 1)
            meta_h[dst_rows, META_LEN] = st.lengths[rows]
            place_fused_rows(pq, st.pq_dev, up(rows.astype(np.int64)), up(dst_rows))
            r0 += nb
        return {
            "pq": pq, "meta": self._device_put_repl(meta_h), "pred": pred_h[order],
            "Lp": Lp,
        }

    def _genotype_span(
        self, batches: list[_BatchState], host: list[ReadAlignment]
    ) -> list[VCFRecord]:
        """Span-scatter genotyper: per window, the fused reads whose
        predicted start can reach it (one row range of _compact_fused's
        matrix) plus the window's slice of the host calls."""
        from ..kernels.genotyping import (
            genotype_window_hist_resolve_batch,
            genotype_window_span,
            window_pk_slice,
        )
        from .single_sample import _window_for, merge_indel_records

        det = self.detector
        genome = self.genome
        offs = genome.offsets
        dev = self.device
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        with stage("call.compact_fused"):
            fused = self._compact_fused(batches)
        contribution = up(np.asarray(det._contribution))
        het = float(det.heterozygosity_rate)
        minq = int(det.min_quality)
        empty_pk = torch.empty(0, dtype=torch.int32, device=dev)
        span_kernel = self._span_kernel or genotype_window_span
        records: list[VCFRecord] = []
        pending = []
        for si in range(genome.num_sequences):
            name = genome.sequence_name(si)
            seq_len = genome.sequence_length(si)
            base = int(offs[si])
            # per-sequence host work precomputed in _call
            indel_records, devc = self._seq_host[si]
            window = _window_for(seq_len)
            w_starts = list(range(1, seq_len + 1, window))
            if devc is not None:
                # window bounds into the sorted call arrays: one
                # searchsorted + one small fetch per sequence
                edges = np.array(w_starts + [seq_len + 1], np.int32)
                bnd = torch.searchsorted(devc["pos"], up(edges)).cpu().numpy()
            seq_records: list[VCFRecord] = []
            for wi, w0 in enumerate(w_starts):
                w1 = min(seq_len, w0 + window - 1)
                w0_concat = base + w0 - 1
                # reads sorted by pred: the rows that can touch [w0, w1]
                # are contiguous (left-edge over-inclusion is masked by
                # the per-base bounds check)
                if fused is not None:
                    slo = int(np.searchsorted(
                        fused["pred"], w0_concat - fused["Lp"], side="left"
                    ))
                    shi = int(np.searchsorted(
                        fused["pred"], w0_concat + window, side="left"
                    ))
                    count = shi - slo
                else:
                    slo = count = 0
                lo, hi = (int(bnd[wi]), int(bnd[wi + 1])) if devc else (0, 0)
                if hi > lo:
                    pk = window_pk_slice(
                        devc["pos"], devc["attr"], lo, w0, hi - lo,
                        size=hi - lo,
                    )
                elif count == 0:
                    continue  # no evidence touches this window
                else:
                    pk = empty_pk
                ref_win = np.full(window, 4, dtype=np.int8)
                ref_win[: w1 - w0 + 1] = genome.sequences[si].codes[w0 - 1 : w1]
                with stage("call.window_dispatch"):
                    res = span_kernel(
                        fused["pq"] if fused else None,
                        fused["meta"] if fused else None,
                        slo, count, w0_concat, pk, up(ref_win), contribution,
                        het, minq, out_size=window,
                    )
                pending.append(
                    (name, w0, ref_win, res, indel_records, seq_records)
                )
            # a sequence with indel records but no window: its records go
            # out here, ahead of the windowed sequences (JAX order)
            if not any(p[0] == name for p in pending) and indel_records:
                seq_records.extend(indel_records)
                records.extend(sorted(seq_records, key=lambda r: r.variant.first))

        with stage("call.window_resolve"):
            resolved = genotype_window_hist_resolve_batch([p[3] for p in pending])
        handled: dict[str, tuple[list, list]] = {}
        with stage("call.build_records"):
            for (name, w0, ref_win, _, indel_records, seq_records), res in zip(
                pending, resolved
            ):
                seq_records.extend(det._window_records(name, w0, ref_win, res))
                handled[name] = (indel_records, seq_records)
            for name, (indel_records, seq_records) in handled.items():
                records.extend(merge_indel_records(seq_records, indel_records))
        return records

    # ------------------------------------------------------------------
    def _compact_hist(self, batches: list[_BatchState]):
        """Host bookkeeping + one elementwise device pass turning every
        uploaded read batch into genome-oriented col bytes (colg).  Reverse
        reads are flipped and their variable-length shift is absorbed into
        pred' (see build_colg)."""
        from ..kernels.genotyping import hist_tables
        from ..kernels.shear_pileup import build_colg, concat_reads

        rows_per = [np.nonzero(st.fused)[0] for st in batches]
        F = sum(len(r) for r in rows_per)
        if F == 0:
            return None
        counts31 = np.bincount(
            np.clip(np.arange(256) - 33, 0, 30),
            weights=self._qual_ascii_counts,
            minlength=31,
        )
        qlv = np.nonzero(counts31)[0].astype(np.int32)
        nq = max(1, len(qlv))
        if nq > 29:
            return None  # the 7-bit stage byte cannot bin more qualities
        if len(qlv) == 0:
            qlv = np.array([20], np.int32)
        maxlen = max(
            int(st.lengths[r].max()) for st, r in zip(batches, rows_per) if len(r)
        )
        Lp = min(
            max(st.fwd_mat.shape[1] for st in batches), (maxlen + 15) & ~15
        )
        row_off = np.cumsum([0] + [st.fwd_mat.shape[0] for st in batches])
        total_rows = int(row_off[-1])
        rev_h = np.zeros(total_rows, np.uint8)
        alo_h = np.zeros(total_rows, np.int32)
        ahi_h = np.zeros(total_rows, np.int32)  # 0-width: never contributes
        rows_global = []
        preds = []
        for st, rows, r0 in zip(batches, rows_per, row_off):
            if not len(rows):
                continue
            ln = st.lengths[rows].astype(np.int64)
            rv = st.strand[rows].astype(np.int64)
            cs = st.cs[rows].astype(np.int64)
            ce = st.ce[rows].astype(np.int64)
            if st.ig5 is not None:  # realigner end-trims fold into the clips
                cs = np.maximum(cs, st.ig5[rows].astype(np.int64))
                ce = np.maximum(ce, st.ig3[rows].astype(np.int64))
                ce = np.minimum(ce, ln - cs)  # never negative-width
            g = r0 + rows
            # read-lane bounds: fwd j in [cs, len-ce), rev j in [ce,
            # len-cs); flipped array index a = Lp-1-j maps the rev range
            # to [Lp-len+cs, Lp-ce)
            rev_h[g] = rv.astype(np.uint8)
            alo_h[g] = np.where(rv == 1, Lp - ln + cs, cs)
            ahi_h[g] = np.where(rv == 1, Lp - ce, ln - ce)
            rows_global.append(g.astype(np.int64))
            preds.append(np.where(rv == 1, st.pred[rows] - (Lp - ln), st.pred[rows]))
        rows_global = np.concatenate(rows_global)
        pred_adj = np.concatenate(preds)
        order = np.argsort(pred_adj, kind="stable")
        ps = pred_adj[order]
        rg = rows_global[order]
        first = np.ones(len(ps), bool)
        if len(ps) > 1:
            first[1:] = ps[1:] != ps[:-1]

        dev = self.device
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        bigpq = concat_reads(*[st.pq_dev for st in batches], lanes=Lp)
        colg = build_colg(
            bigpq, up(rev_h), up(alo_h), up(ahi_h), up(qlv), nq=nq, lanes=Lp
        )
        expand, cdb32, qual_bin = hist_tables(
            nq, qlv, np.asarray(self.detector._contribution)
        )
        return {
            "colg": colg,
            "Lp": Lp,
            "nq": nq,
            "r0_pred": ps[first],
            "r0_rows": rg[first],
            "res_pred": ps[~first],
            "res_rows": rg[~first],
            "expand": up(expand.astype(np.float64)),
            "cdb32": up(cdb32),
            "qual_bin": up(qual_bin.astype(np.int64)),
            "F": F,
        }

    def _genotype_hist(
        self,
        batches: list[_BatchState],
        host: list[ReadAlignment],
        fused: dict,
    ) -> list[VCFRecord]:
        from ..kernels.genotyping import (
            genotype_window_hist,
            genotype_window_hist_resolve_batch,
            window_pk_slice,
        )
        from ..kernels.shear_pileup import build_stage
        from ..utils.progress import check as _progress_check
        from .single_sample import _window_for, merge_indel_records

        det = self.detector
        genome = self.genome
        offs = genome.offsets
        dev = self.device
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        Lp, nq = fused["Lp"], fused["nq"]
        colg = fused["colg"]
        r0_pred, r0_rows = fused["r0_pred"], fused["r0_rows"]
        res_pred, res_rows = fused["res_pred"], fused["res_rows"]
        contribution = up(np.asarray(det._contribution))
        het = float(det.heterozygosity_rate)
        minq = int(det.min_quality)
        empty_pk = torch.empty(0, dtype=torch.int32, device=dev)

        # window descriptors first, then one stage per chunk of windows
        win_desc = []  # (seq idx, name, w0, w1, w0_concat, window)
        for si in range(genome.num_sequences):
            name = genome.sequence_name(si)
            seq_len = genome.sequence_length(si)
            window = _window_for(seq_len)
            base = int(offs[si])
            for w0 in range(1, seq_len + 1, window):
                w1 = min(seq_len, w0 + window - 1)
                win_desc.append((si, name, w0, w1, base + w0 - 1, window))
        # stage chunks of <= CHUNK_MAX positions (the stage is Lp bytes per
        # position), never spanning sequences
        CHUNK_MAX = 32 << 20
        max_win = max(w[5] for w in win_desc) if win_desc else 1 << 16
        chunk_cap = max(max_win, (CHUNK_MAX // max_win) * max_win)
        chunks = []  # (c0_concat, [win_desc...])
        cur = None
        cur_si = None
        for wd in win_desc:
            w0c, window = wd[4], wd[5]
            if (
                cur is None
                or wd[0] != cur_si
                or w0c + window - cur[0] > chunk_cap
            ):
                cur = (w0c, [])
                cur_si = wd[0]
                chunks.append(cur)
            cur[1].append(wd)
        # left halo: a window position p reads stage columns p-(Lp-1)..p
        halo = Lp
        max_span = max(
            (c[1][-1][4] + c[1][-1][5]) - c[0] for c in chunks
        )
        s_cols = halo + max_span

        # per-sequence host work precomputed in _call (trims must precede
        # compaction)
        seq_host = self._seq_host

        # per-window call-array bounds: one device searchsorted + one small
        # fetch per sequence
        win_bounds: dict[tuple[int, int], tuple[int, int]] = {}
        for si in range(genome.num_sequences):
            devc = seq_host[si][1]
            if devc is None:
                continue
            ws = [wd for wd in win_desc if wd[0] == si]
            if not ws:
                continue
            edges = np.array([w[2] for w in ws] + [ws[-1][3] + 1], np.int32)
            bnd = torch.searchsorted(devc["pos"], up(edges)).cpu().numpy()
            for t, w in enumerate(ws):
                win_bounds[(si, w[2])] = (int(bnd[t]), int(bnd[t + 1]))

        records: list[VCFRecord] = []
        seq_records_by_name: dict[str, list[VCFRecord]] = {}
        meta_list = []
        resolved = []
        for ci, (c0, wds) in enumerate(chunks):
            _progress_check(self.progress_notifier, ci)
            # rank-0 reads that can reach this chunk's windows: starts in
            # [c0 - Lp, c0 + max_span) (later starts, e.g. on the next
            # sequence, cover no position of this chunk)
            lo = np.searchsorted(r0_pred, c0 - Lp, side="left")
            hi = np.searchsorted(r0_pred, c0 + s_cols - halo, side="left")
            stage_t = build_stage(
                colg, up(r0_rows[lo:hi]), up(r0_pred[lo:hi] - c0 + halo),
                s_cols=s_cols,
            )

            pending = []
            for si, name, w0, w1, w0c, window in wds:
                indel_records, devc = seq_host[si]
                w1c = w0c + (w1 - w0)
                rlo = np.searchsorted(res_pred, w0c - Lp, side="right")
                rhi = np.searchsorted(res_pred, w1c, side="right")
                n_res = int(rhi - rlo)
                plo, phi = win_bounds.get((si, w0), (0, 0))
                # fused coverage of this window (rank-0 reads whose lanes
                # can reach it)
                flo = np.searchsorted(r0_pred, w0c - Lp, side="right")
                fhi = np.searchsorted(r0_pred, w1c, side="right")
                if phi == plo and n_res == 0 and fhi == flo:
                    continue  # no evidence touches this window
                if phi > plo:
                    pk = window_pk_slice(
                        devc["pos"], devc["attr"], plo, w0, phi - plo,
                        size=phi - plo,
                    )
                else:
                    pk = empty_pk
                ref_win = np.full(window, 4, dtype=np.int8)
                ref_win[: w1 - w0 + 1] = genome.sequences[si].codes[w0 - 1 : w1]
                with stage("call.window_dispatch"):
                    res = genotype_window_hist(
                        stage_t, w0c - c0 + halo, colg,
                        up(res_rows[rlo:rhi]),
                        up((res_pred[rlo:rhi] - w0c).astype(np.int32)),
                        pk, up(ref_win), contribution,
                        fused["expand"], fused["cdb32"], fused["qual_bin"],
                        het, minq, window=window, nq=nq, lanes=Lp,
                    )
                pending.append(res)
                meta_list.append((name, w0, ref_win, indel_records))
            with stage("call.window_resolve"):
                resolved.extend(genotype_window_hist_resolve_batch(pending))
            del stage_t

        handled: dict[str, list] = {}
        with stage("call.build_records"):
            for (name, w0, ref_win, indel_records), res in zip(meta_list, resolved):
                seq_records = seq_records_by_name.setdefault(name, [])
                seq_records.extend(det._window_records(name, w0, ref_win, res))
                handled[name] = indel_records
            # sequences with indel records but no dispatched windows
            for si in range(genome.num_sequences):
                name = genome.sequence_name(si)
                indel_records = seq_host[si][0]
                if indel_records and name not in handled:
                    handled[name] = indel_records
                    seq_records_by_name.setdefault(name, [])
            for name, indel_records in handled.items():
                records.extend(
                    merge_indel_records(
                        seq_records_by_name.get(name, []), indel_records
                    )
                )
        return records
