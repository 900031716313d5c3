"""De-novo long-read assembler (overlap-layout-consensus).

Ref: src/ngsep/assembly/Assembler.java:279-545 (command `Assembler`: kmer
spectrum -> minimizer overlap graph -> chimera/embedded filtering ->
layout -> consensus), GraphBuilderMinimizers.java:103-246 (table over
reads, KmerHitsAssemblyEdgesFinder overlap edges/embedded relations),
LayoutBuilderKruskalPath.java:71-460 (path building),
ConsensusBuilderBidirectionalSimple.java, NStatisticsCalculator.java.

Minimizers of all reads are extracted on the assembler's device in
batches (canonical-strand codes so both orientations match), one fetch a
batch; hit pairs come from one global sort of (code, read, pos, strand)
entries; the per-pair diagonal voting that the reference does with
per-read hashmap walks becomes sorted-array segment reductions on the
host.  The polishing, correction and phasing passes align reads with the
long-read aligner on the same device.  Same results as
ngsepcore_tpu/assembly/assembler.py.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.sequences import (
    QualifiedSequence,
    QualifiedSequenceList,
    decode_dna,
    pack_reads,
    reverse_complement_codes,
)
from ..kernels.kmers import kmer_codes_both_strands
from ..kernels.minimizers import default_kmer_hash, select_minimizers
from ..utils.profiling import stage
from .graph import AssemblyEdge, AssemblyEmbedded, AssemblyGraph

DEF_KMER_LENGTH = 15
DEF_WINDOW_LENGTH = 10
DEF_MIN_SHARED_MINIMIZERS = 6
DEF_MIN_OVERLAP = 200


class Assembler:
    def __init__(
        self,
        kmer_length: int = DEF_KMER_LENGTH,
        window_length: int = DEF_WINDOW_LENGTH,
        min_shared_minimizers: int = DEF_MIN_SHARED_MINIMIZERS,
        min_overlap: int = DEF_MIN_OVERLAP,
        batch_rows: int = 512,
        polish_rounds: int = 1,
        merge_ends: bool = True,
        circular: bool = False,
        ploidy: int = 1,
        min_score_proportion: float = 0.5,  # ref: Assembler.java:65
        graph_file: str | None = None,  # load a saved graph (ref -graphFile)
        save_graph_file: str | None = None,  # checkpoint after filtering
        remove_chimeras: bool = True,
        error_correction_rounds: int = 0,  # ref: Assembler.java:415 rounds
        *,
        device,
    ):
        self.device = torch.device(device)
        self.kmer_length = kmer_length
        self.window_length = window_length
        self.min_shared = min_shared_minimizers
        self.min_overlap = min_overlap
        self.batch_rows = batch_rows
        self.polish_rounds = polish_rounds
        self.merge_ends = merge_ends
        self.circular = circular
        self.ploidy = ploidy
        self.min_score_proportion = min_score_proportion
        self.graph_file = graph_file
        self.save_graph_file = save_graph_file
        self.remove_chimeras = remove_chimeras
        self.error_correction_rounds = error_correction_rounds
        self.corrections = 0
        self.read_indel_corrections = 0
        self.circularized = 0

    # ------------------------------------------------------------------
    def _read_minimizers(self, reads: list[np.ndarray]):
        """Canonical-strand minimizers of every read.

        Returns flat arrays (codes, read_idx, pos, strand) sorted by code
        (stable, so entries within one code group stay in read order).
        One device batch of up to `batch_rows` reads (fewer for long
        reads: rows x maxlen int64 tensors stay under 32 Mi cells), one
        2D nonzero and one fetch a batch.  The reference's zero-length pad
        rows up to the batch size are left out: rows are independent.
        """
        k = self.kmer_length
        dev = self.device
        codes_l, reads_l, pos_l, strand_l = [], [], [], []
        maxlen = max(len(r) for r in reads)
        rows_cap = max(8, min(self.batch_rows, (32 << 20) // max(1, maxlen)))
        for b0 in range(0, len(reads), rows_cap):
            batch = reads[b0 : b0 + rows_cap]
            codes, lengths, _ = pack_reads(batch, pad_to=maxlen)
            fwd, rev, ok = kmer_codes_both_strands(
                torch.from_numpy(codes).to(dev), torch.from_numpy(lengths).to(dev), k
            )
            canon = torch.minimum(fwd, rev)
            sel = select_minimizers(default_kmer_hash(canon), ok, self.window_length)
            rsel, csel = torch.nonzero(sel, as_tuple=True)
            picked = torch.stack([canon[rsel, csel].long(), rsel, csel,
                                  (fwd[rsel, csel] > rev[rsel, csel]).long()])
            picked = picked.cpu().numpy()  # one fetch a batch
            codes_l.append(picked[0].astype(np.int32 if canon.dtype == torch.int32 else np.int64))
            reads_l.append((b0 + picked[1]).astype(np.int32))
            pos_l.append(picked[2].astype(np.int32))
            strand_l.append(picked[3].astype(np.int8))
        codes = np.concatenate(codes_l)
        read_idx = np.concatenate(reads_l)
        pos = np.concatenate(pos_l)
        strand = np.concatenate(strand_l)
        order = np.argsort(codes, kind="stable")
        return codes[order], read_idx[order], pos[order], strand[order]

    # ------------------------------------------------------------------
    # Vectorized overlap-graph construction.
    #
    # A loop per minimizer group building O(g^2) pair indices, then again
    # per pair group, is superlinear in read count; these whole-array
    # passes compute the same statistics:
    #
    # 1. delta-pairing: entry i pairs with entries i+1..i+D of the same
    #    code group (D = PAIR_DELTAS, all pairs when the group is small).
    #    Groups are coverage-sized, so a true overlapping read pair is
    #    sampled with probability ~min(1, 2D/coverage) in EACH of its
    #    shared-minimizer groups — hundreds of chances per genuine overlap
    #    vs the >= min_shared votes needed.  This bounds total pair count
    #    at N_entries * D instead of N_groups * coverage^2 (the reference
    #    caps hits per kmer for the same reason,
    #    GraphBuilderMinimizers.java:103-246).
    # 2. one composite sort (pair-key << 21 | diagonal) replaces the
    #    per-group sort: group bounds, the median diagonal, and the +-100
    #    consistency window (two vectorized searchsorteds into the same
    #    sorted array) all come from index arithmetic.
    # 3. the exact MAD of consistent diagonals (ikbp) comes from a 7-step
    #    vectorized bisection over the window radius.
    # 4. a second sort over consistent entries keyed (pair-key << 21 | p1)
    #    yields unique-p1 counts (csk) and evidence spans per pair.
    # ------------------------------------------------------------------
    PAIR_DELTAS = 8
    EDGE_CAP = 32  # max edges kept per (read, side) before object creation

    def build_graph(self, reads: list[np.ndarray]) -> AssemblyGraph:
        with stage("asm.minimizers"):
            minimizers = self._read_minimizers(reads)
        with stage("asm.graph"):
            return self._graph_from_minimizers(reads, *minimizers)

    def _graph_from_minimizers(self, reads, codes, read_idx, pos, strand) -> AssemblyGraph:
        lens = np.array([len(r) for r in reads], np.int64)
        graph = AssemblyGraph(len(reads), [int(x) for x in lens])
        if len(codes) == 0:
            return graph
        n_reads = len(reads)
        k = self.kmer_length
        maxlen = int(lens.max())
        assert maxlen < (1 << 20), "read length exceeds diagonal field"
        assert 2 * n_reads * n_reads < (1 << 42), "read count exceeds key field"

        # ---- group bounds + coverage-scaled repeat cap ------------------
        new_grp = np.concatenate([[True], codes[1:] != codes[:-1]])
        gid = np.cumsum(new_grp) - 1
        gsize = np.bincount(gid)
        med_group = (
            int(np.median(gsize[gsize >= 2])) if np.any(gsize >= 2) else 2
        )
        max_group = max(12, 3 * med_group)
        size_of = gsize[gid]
        usable = (size_of >= 2) & (size_of <= max_group)

        # ---- delta pairing ---------------------------------------------
        N = len(codes)
        D = min(self.PAIR_DELTAS, max(1, max_group - 1))
        keys_l, diag_l, p1_l = [], [], []
        for d in range(1, D + 1):
            if d >= N:
                break
            a = np.arange(N - d)
            ok = usable[a] & (gid[a] == gid[a + d]) & (
                read_idx[a] != read_idx[a + d]
            )
            a = a[ok]
            if not len(a):
                continue
            b = a + d
            swap = read_idx[a] > read_idx[b]
            aa = np.where(swap, b, a)
            bb = np.where(swap, a, b)
            r1, r2 = read_idx[aa], read_idx[bb]
            p1, p2 = pos[aa], pos[bb]
            orient = (strand[aa] != strand[bb]).astype(np.int64)
            p2_eff = np.where(orient == 1, lens[r2] - (p2 + k), p2.astype(np.int64))
            diag = p1.astype(np.int64) - p2_eff
            keys_l.append((r1.astype(np.int64) * n_reads + r2) * 2 + orient)
            diag_l.append(diag)
            p1_l.append(p1.astype(np.int64))
        if not keys_l:
            return graph
        keys = np.concatenate(keys_l)
        diags = np.concatenate(diag_l)
        p1s = np.concatenate(p1_l)
        del keys_l, diag_l, p1_l

        # ---- composite sort by (pair key, diagonal) --------------------
        OFF = 1 << 20
        comp = (keys << 21) | (diags + OFF)
        order = np.argsort(comp)
        comp = comp[order]
        p1s = p1s[order]
        del keys, diags, order
        kb = comp >> 21
        dg = (comp & ((1 << 21) - 1)) - OFF
        gstart = np.flatnonzero(
            np.concatenate([[True], kb[1:] != kb[:-1]])
        )
        gend = np.concatenate([gstart[1:], [len(comp)]])
        n_hits = gend - gstart
        sel = n_hits >= self.min_shared
        gstart, gend, n_hits = gstart[sel], gend[sel], n_hits[sel]
        if not len(gstart):
            return graph
        gkey = kb[gstart]
        # median diagonal (sorted within group -> index arithmetic; even
        # counts truncate the two-middle average toward zero like
        # int(np.median(...)) did)
        dlo = dg[gstart + (n_hits - 1) // 2]
        dhi = dg[gstart + n_hits // 2]
        med = np.trunc((dlo + dhi) / 2.0).astype(np.int64)
        base = gkey << 21
        M21 = (1 << 21) - 1

        def _window(lo_d, hi_d):
            wl = np.searchsorted(
                comp, base | np.clip(lo_d + OFF, 0, M21), side="left"
            )
            wh = np.searchsorted(
                comp, base | np.clip(hi_d + OFF, 0, M21), side="right"
            )
            return wl, wh

        lo, hi = _window(med - 100, med + 100)
        n_cons = (hi - lo).astype(np.int64)
        sel = n_cons >= self.min_shared
        gstart, gend, gkey = gstart[sel], gend[sel], gkey[sel]
        med, base, lo, hi, n_cons = med[sel], base[sel], lo[sel], hi[sel], n_cons[sel]
        G = len(gkey)
        if G == 0:
            return graph

        # ---- exact MAD of consistent diagonals via radius bisection ----
        half = (n_cons + 1) // 2
        r_lo = np.zeros(G, np.int64)
        r_hi = np.full(G, 100, np.int64)
        for _ in range(7):
            r_mid = (r_lo + r_hi) // 2
            wl, wh = _window(med - r_mid, med + r_mid)
            ge = (wh - wl) >= half
            r_hi = np.where(ge, r_mid, r_hi)
            r_lo = np.where(ge, r_lo, r_mid + 1)
        mad = r_hi.astype(np.float64)

        # ---- second sort: unique p1 + evidence spans over consistent ---
        # interval painting marks entries inside their group's [lo, hi)
        flags = np.zeros(len(comp) + 1, np.int32)
        np.add.at(flags, lo, 1)
        np.add.at(flags, hi, -1)
        in_cons = np.cumsum(flags[:-1]) > 0
        comp2 = np.sort((kb[in_cons] << 21) | p1s[in_cons])
        kb2 = comp2 >> 21
        p2s = comp2 & ((1 << 21) - 1)
        c2start = np.flatnonzero(
            np.concatenate([[True], kb2[1:] != kb2[:-1]])
        )
        c2end = np.concatenate([c2start[1:], [len(comp2)]])
        # c2 groups are exactly the filtered groups in gkey order
        assert len(c2start) == G
        uniq = np.concatenate(
            [[True], comp2[1:] != comp2[:-1]]
        ).astype(np.int64)
        ucum = np.cumsum(uniq)
        n_uniq = ucum[c2end - 1] - ucum[c2start] + 1
        ev1_start = p2s[c2start]
        ev1_end = p2s[c2end - 1] + k

        # ---- vectorized relation classification ------------------------
        orient = (gkey & 1).astype(bool)
        pair = gkey >> 1
        r1 = (pair // n_reads).astype(np.int64)
        r2 = (pair % n_reads).astype(np.int64)
        L1, L2 = lens[r1], lens[r2]
        score = n_cons.astype(np.float64)
        csk = np.minimum(n_uniq * k, L1)
        ev2_start = np.where(
            orient,
            np.maximum(0, L2 - ev1_end + med),
            np.maximum(0, ev1_start - med),
        )
        ev2_end = np.where(
            orient,
            np.minimum(L2, L2 - ev1_start + med),
            np.minimum(L2, ev1_end - med),
        )
        emb_2in1 = (med >= 0) & (med + L2 <= L1)
        emb_1in2 = (med < 0) & (-med + L1 <= L2) & ~emb_2in1
        is_edge = ~emb_2in1 & ~emb_1in2
        edge_fwd = is_edge & (med > 0)  # r1 suffix -> r2 prefix
        overlap = np.where(edge_fwd, L1 - med, L2 + med)
        edge_ok = is_edge & (overlap >= self.min_overlap)
        ikbp = mad * 1000.0 / np.maximum(1, overlap)

        # ---- embedded: keep the best-scoring host per read -------------
        for sel_mask, rd, host, hstart, hev_s, hev_e, span in (
            (
                emb_2in1, r2, r1, med, ev1_start, ev1_end,
                np.maximum(1, L2),
            ),
            (
                emb_1in2, r1, r2, -med,
                np.where(
                    orient,
                    np.maximum(0, L2 - (ev1_end - med)),
                    np.maximum(0, ev1_start - med),
                ),
                np.where(
                    orient,
                    np.minimum(L2, L2 - (ev1_start - med)),
                    np.minimum(L2, ev1_end - med),
                ),
                np.maximum(1, L1),
            ),
        ):
            w = np.flatnonzero(sel_mask)
            if not len(w):
                continue
            # best score per embedded read: sort by (read, -score)
            o = np.lexsort((-score[w], rd[w]))
            w = w[o]
            first = np.concatenate([[True], rd[w][1:] != rd[w][:-1]])
            for t in np.flatnonzero(first):
                g = w[t]
                ev_prop = min(
                    1.0, (ev1_end[g] - ev1_start[g]) / float(span[g])
                )
                graph.add_embedded(
                    AssemblyEmbedded(
                        int(rd[g]), int(host[g]), int(hstart[g]),
                        bool(orient[g]), nshared=int(n_cons[g]),
                        csk=int(csk[g]), ev_prop=float(ev_prop),
                        host_evidence_start=int(hev_s[g]),
                        host_evidence_end=int(hev_e[g]),
                        score=float(score[g]),
                    )
                )

        # ---- edges: cap per (read, side) then materialize --------------
        w = np.flatnonzero(edge_ok)
        if len(w):
            # endpoint side keys match AssemblyGraph.filter vkeys:
            # exit end of the left read, entry end of the right read
            k1 = np.where(edge_fwd[w], r1[w] * 2 + 1, r2[w] * 2 + (~orient[w]))
            k2 = np.where(edge_fwd[w], r2[w] * 2 + orient[w], r1[w] * 2)
            keep = np.zeros(len(w), bool)
            for kk in (k1, k2):
                o = np.lexsort((-score[w], kk))
                rank = np.arange(len(w)) - np.maximum.accumulate(
                    np.where(
                        np.concatenate([[True], kk[o][1:] != kk[o][:-1]]),
                        np.arange(len(w)),
                        0,
                    )
                )
                keep[o[rank < self.EDGE_CAP]] = True
            w = w[keep]
            evp = np.where(
                edge_fwd[w],
                (ev1_end[w] - np.maximum(ev1_start[w], med[w]))
                / np.maximum(1, overlap[w]),
                (np.minimum(ev1_end[w], overlap[w]) - ev1_start[w])
                / np.maximum(1, overlap[w]),
            )
            evp = np.clip(evp, 0.0, 1.0)
            for t in range(len(w)):
                g = int(w[t])
                if edge_fwd[g]:
                    graph.add_edge(
                        AssemblyEdge(
                            int(r1[g]), False, int(r2[g]), bool(orient[g]),
                            int(overlap[g]), float(score[g]),
                            nshared=int(n_cons[g]),
                            csk=int(min(csk[g], overlap[g])),
                            ev_prop=float(evp[t]), ikbp=float(ikbp[g]),
                            ev1_start=int(ev1_start[g]),
                            ev1_end=int(ev1_end[g]),
                            ev2_start=int(ev2_start[g]),
                            ev2_end=int(ev2_end[g]),
                        )
                    )
                else:
                    graph.add_edge(
                        AssemblyEdge(
                            int(r2[g]), bool(orient[g]), int(r1[g]), False,
                            int(overlap[g]), float(score[g]),
                            nshared=int(n_cons[g]),
                            csk=int(min(csk[g], overlap[g])),
                            ev_prop=float(evp[t]), ikbp=float(ikbp[g]),
                            ev1_start=int(ev2_start[g]),
                            ev1_end=int(ev2_end[g]),
                            ev2_start=int(ev1_start[g]),
                            ev2_end=int(ev1_end[g]),
                        )
                    )
        return graph

    # ------------------------------------------------------------------
    def layout_and_consensus(
        self, reads: list[np.ndarray], graph: AssemblyGraph
    ) -> list[np.ndarray]:
        """Path layout + overlap-concatenation consensus.

        Layout defaults to the reference's MST-based KruskalPath algorithm
        (assembly/layout.py: safe reciprocal-best edges seed paths, path
        ends merge Kruskal-style under cost/IKBP constraints, small
        repeat-bubble paths are absorbed); `layout_algorithm` selects the
        greedy variants instead (ref LayoutBuilderGreedyMaxOverlap /
        MinCost / MaxCoverageSharedKmers)."""
        from .layout import LayoutBuilderGreedy, LayoutBuilderKruskalPath

        algo = getattr(self, "layout_algorithm", "KruskalPath")
        if algo == "KruskalPath":
            builder = LayoutBuilderKruskalPath()
        else:
            builder = LayoutBuilderGreedy(algo)
        paths = builder.find_paths(graph)
        contigs: list[np.ndarray] = []
        for p in paths:
            pieces = []
            prev_overlap = 0
            for (r, rev), ov in zip(p.reads, [0] + p.overlaps):
                prev_overlap = ov
                seq = (
                    reads[r]
                    if not rev
                    else reverse_complement_codes(reads[r])
                )
                pieces.append(
                    seq[prev_overlap:]
                    if prev_overlap < len(seq)
                    else seq[:0]
                )
            contigs.append(np.concatenate(pieces))
        contigs.sort(key=len, reverse=True)
        return contigs

    # ------------------------------------------------------------------
    def assemble(self, reads: list[np.ndarray]) -> QualifiedSequenceList:
        """Full pipeline: graph -> layout -> end merge -> polish ->
        circularize (ref: Assembler.run stages :285-545); for ploidy>=2 a
        phase-filter pass re-assembles each haplotype read cluster
        (ref: ploidy loop :461-484)."""
        self._polish_reads = None
        if self.ploidy >= 2:
            return self._assemble_phased(reads)
        if self.graph_file:
            # resume from a graph checkpoint (ref: Assembler.java:323 load
            # path skipping graph construction)
            graph = AssemblyGraph.load(self.graph_file)
        else:
            graph = self._build_filtered_graph(reads)
            # error-correction rounds (ref: Assembler.java:415 +
            # AlignmentBasedIndelErrorsCorrector): correct read INDEL
            # errors against a draft, then rebuild the graph from the
            # corrected reads — substitutions stay untouched so het
            # signal survives for phasing.  The ORIGINAL reads are kept
            # for consensus polishing: corrected reads are biased toward
            # the draft's own errors (deletions filled with draft bases),
            # so polishing with them would lock draft errors in as
            # unanimous evidence
            self._polish_reads = reads
            for _round in range(self.error_correction_rounds):
                from .read_correction import correct_reads_indels

                draft = self.layout_and_consensus(reads, graph)
                if not draft:
                    break
                reads, n_ev = correct_reads_indels(draft, reads, device=self.device)
                self.read_indel_corrections += n_ev
                if n_ev == 0:
                    break
                graph = self._build_filtered_graph(reads)
        if self.save_graph_file:
            # ref: Assembler.java:417-434 saves the filtered graph so later
            # runs skip construction
            graph.save(self.save_graph_file)
        with stage("asm.layout"):
            contigs = self.layout_and_consensus(reads, graph)
        return self._finish_contigs(contigs, reads)

    def _build_filtered_graph(self, reads: list[np.ndarray]) -> AssemblyGraph:
        graph = self.build_graph(reads)
        with stage("asm.filter"):
            if self.remove_chimeras:
                # ref: Assembler.java:455 removeVerticesChimericReads
                graph.remove_chimeric_reads()
            graph.update_scores()
            graph.filter_edges_and_embedded(self.min_score_proportion)
        return graph

    def _finish_contigs(
        self, contigs: list[np.ndarray], reads: list[np.ndarray]
    ) -> QualifiedSequenceList:
        # polish from the UNBIASED read set (see the error-correction note)
        reads = getattr(self, "_polish_reads", None) or reads
        raw = None
        if self.polish_rounds > 0 and contigs:
            from ..core.sequences import RawRead
            from .polishing import polish_contigs

            raw = [
                RawRead(name=f"r{i}", sequence=decode_dna(r))
                for i, r in enumerate(reads)
            ]
            # one polish round BEFORE merging: on high-error read sets the
            # raw consensus carries enough error that end-overlap /
            # containment detection (exact k-mer anchors + fixed-diagonal
            # identity) misses real overlaps; polishing first makes the
            # contig set mergeable (ref polishes during consensus:
            # ConsensusBuilderBidirectionalWithPolishing.java:82)
            with stage("asm.polish"):
                contigs, self.corrections = polish_contigs(
                    contigs, raw, rounds=1, device=self.device
                )
        # dedupe -> merge -> polish to convergence: a redundant contig
        # that survives one containment pass (noisy) steals the read
        # support of its region from the kept contig, starving the polish
        # there; the second pass sees POLISHED contigs and removes it
        for _pass in range(2):
            n_before = len(contigs)
            if self.merge_ends and len(contigs) > 1:
                from .polishing import (
                    drop_contained_contigs,
                    merge_contig_ends,
                )

                with stage("asm.merge"):
                    contigs = drop_contained_contigs(contigs)
                    contigs = merge_contig_ends(
                        contigs, min_overlap=self.min_overlap
                    )
            if self.polish_rounds > 0 and contigs:
                with stage("asm.polish"):
                    contigs, more = polish_contigs(
                        contigs, raw, rounds=self.polish_rounds, device=self.device
                    )
                self.corrections += more
            if len(contigs) == n_before:
                break
        if self.circular:
            from .polishing import circularize

            done = []
            for c in contigs:
                c2, was = circularize(c)
                self.circularized += was
                done.append(c2)
            contigs = done
        contigs = sorted(contigs, key=len, reverse=True)
        out = QualifiedSequenceList()
        for i, c in enumerate(contigs):
            out.add(QualifiedSequence(name=f"contig_{i + 1}", codes=c))
        return out

    # ------------------------------------------------------------------
    def _assemble_phased(self, reads: list[np.ndarray]) -> QualifiedSequenceList:
        """Diploid assembly: draft -> phase reads into haplotype clusters ->
        assemble each cluster."""
        from ..core.sequences import RawRead
        from .phasing import phase_reads

        # the draft exists only to DISCOVER het sites for phasing, so it
        # wants maximal contiguity, not conservative path building: the
        # greedy MaxOverlap layout chains reads of both haplotypes into
        # the longest possible backbone (cross-haplotype joins are fine
        # here — the het columns they expose are exactly the phasing
        # signal), while the conservative Kruskal reciprocal-best layout
        # fragments on diploid data because same-locus reads of the two
        # haplotypes compete for every junction
        draft_asm = Assembler(
            self.kmer_length,
            self.window_length,
            self.min_shared,
            self.min_overlap,
            self.batch_rows,
            polish_rounds=0,
            merge_ends=self.merge_ends,
            min_score_proportion=0.0,
            remove_chimeras=False,
            device=self.device,
        )
        draft_asm.layout_algorithm = "MaxOverlap"
        draft = draft_asm.assemble(reads)
        raw = [
            RawRead(name=f"r{i}", sequence=decode_dna(r))
            for i, r in enumerate(reads)
        ]
        with stage("asm.phase"):
            clusters = phase_reads([s.codes for s in draft], raw, device=self.device)
        out = QualifiedSequenceList()
        for h, cluster in enumerate(clusters):
            sub_reads = [reads[i] for i in sorted(cluster)]
            if not sub_reads:
                continue
            sub = Assembler(
                self.kmer_length,
                self.window_length,
                self.min_shared,
                self.min_overlap,
                self.batch_rows,
                polish_rounds=self.polish_rounds,
                merge_ends=self.merge_ends,
                circular=self.circular,
                min_score_proportion=self.min_score_proportion,
                remove_chimeras=self.remove_chimeras,
                device=self.device,
            )
            sub.layout_algorithm = getattr(self, "layout_algorithm", "KruskalPath")
            contigs = sub.assemble(sub_reads)
            self.corrections += sub.corrections
            self.circularized += sub.circularized
            for i, s in enumerate(contigs):
                out.add(
                    QualifiedSequence(
                        name=f"contig_{i + 1}_hap{h}", codes=s.codes
                    )
                )
        return out


def n_statistics(lengths: list[int]) -> dict:
    """N50/N90 and friends (ref: NStatisticsCalculator)."""
    ls = sorted(lengths, reverse=True)
    total = sum(ls)
    out = {"total": total, "count": len(ls), "max": ls[0] if ls else 0}
    acc = 0
    for l in ls:
        acc += l
        if "N50" not in out and acc * 2 >= total:
            out["N50"] = l
        if acc * 10 >= total * 9:
            out.setdefault("N90", l)
    return out
