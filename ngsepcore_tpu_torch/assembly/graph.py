"""Assembly overlap graph: relations with evidence statistics, score/cost
calculation, relationship filtering, chimera detection and serialization.

Ref: src/ngsep/assembly/AssemblyGraph.java (vertices = read ends, edges =
overlaps, embedded reads; chimera detection at :576-700, safe-edge
selection :783-830), AssemblyEdge.java / AssemblyEmbedded.java (evidence
spans, coverage shared kmers, indels/kbp),
AssemblySequencesRelationshipScoresCalculator.java (score = CSK *
evidence proportion; cost = summed -log10 p-values of the relation's
features against normal fits over current edges),
AssemblySequencesRelationshipFilter.java (drop relations below a
proportion of each vertex's best score),
assembly/io/AssemblyGraphFileHandler.java (gzipped text save/load).
"""
from __future__ import annotations

import gzip
import math
from dataclasses import dataclass


@dataclass
class AssemblyEdge:
    """Suffix of (read1, rev1) overlaps prefix of (read2, rev2) by `overlap` bp.

    Evidence fields mirror AssemblyEdge.java: the span of minimizer-hit
    evidence inside the overlap on each read, shared-kmer counts and an
    indels-per-kbp estimate from hit-diagonal spread."""

    read1: int
    rev1: bool
    read2: int
    rev2: bool
    overlap: int
    score: float  # shared-minimizer weight; recomputed by update_scores
    nshared: int = 0
    csk: int = 0  # coverage shared kmers (distinct covered bases)
    ev_prop: float = 1.0  # evidence span / overlap
    ikbp: float = 0.0  # indels per kbp proxy (diagonal MAD * 1000/overlap)
    cost: float = 0.0
    # minimizer-hit evidence spans in each read's FORWARD coordinates
    # (ref: AssemblyEdge vertex evidence start/end) — chimera detection
    # needs where the evidence actually stops, not the geometric overlap
    ev1_start: int = 0
    ev1_end: int = 0
    ev2_start: int = 0
    ev2_end: int = 0

    def key(self) -> tuple:
        return (self.read1, self.rev1, self.read2, self.rev2)


@dataclass
class AssemblyEmbedded:
    read: int
    host: int
    host_start: int
    reverse: bool
    nshared: int = 0
    csk: int = 0
    ev_prop: float = 1.0
    host_evidence_start: int = 0
    host_evidence_end: int = 0
    score: float = 0.0


def _norm_cdf(x: float, mean: float, var: float) -> float:
    sd = math.sqrt(max(var, 1e-9))
    return 0.5 * (1.0 + math.erf((x - mean) / (sd * math.sqrt(2.0))))


def _neg_log10_limited(p: float, limit: float = 10.0) -> float:
    """LogMath.negativeLog10WithLimit: -log10(p) capped."""
    if p <= 0:
        return limit
    return min(limit, -math.log10(p))


class AssemblyGraph:
    def __init__(self, n_reads: int, read_lengths: list[int] | None = None):
        self.n_reads = n_reads
        self.read_lengths = list(read_lengths) if read_lengths else [0] * n_reads
        self.edges: list[AssemblyEdge] = []
        self.embedded: dict[int, AssemblyEmbedded] = {}
        self.chimeric: set[int] = set()

    def add_edge(self, e: AssemblyEdge) -> None:
        self.edges.append(e)

    def add_embedded(self, emb: AssemblyEmbedded) -> None:
        self.embedded[emb.read] = emb

    def active_reads(self) -> list[int]:
        return [
            r
            for r in range(self.n_reads)
            if r not in self.embedded and r not in self.chimeric
        ]

    def filtered_edges(self, min_score: float = 0) -> list[AssemblyEdge]:
        """Edges between non-embedded, non-chimeric reads above a score."""
        drop = self.chimeric
        return [
            e
            for e in self.edges
            if e.score >= min_score
            and e.read1 not in self.embedded
            and e.read2 not in self.embedded
            and e.read1 not in drop
            and e.read2 not in drop
        ]

    # ------------------------------------------------------------------
    # chimera detection (ref: AssemblyGraph.removeVerticesChimericReads
    # :576-587 + calculateChimericStatus :608-700)
    # ------------------------------------------------------------------
    def remove_chimeric_reads(
        self, flank: int = 1000, min_side_relations: int = 2, rounds: int = 2
    ) -> set[int]:
        """Flag reads whose relation evidence leaves an internal uncovered
        junction: every overlap/embedded relation's evidence stops at a
        consistent internal breakpoint on one side while relations exist on
        both sides — the signature of a chimeric (mis-joined) read, since
        no genuine relation spans the false junction.  Mirrors the
        reference's two-round scan; the breakpoint statistic here is an
        uncovered internal window of the read's relation-evidence profile
        rather than the reference's median-of-endpoint lists (our
        relations keep the same evidence spans, the decision rule is the
        simpler equivalent)."""
        for _ in range(rounds):
            ivs_by_read = self._evidence_intervals_by_read()
            flagged = []
            for rid in range(self.n_reads):
                if rid in self.chimeric or rid in self.embedded:
                    continue
                if self._is_chimeric(
                    rid, flank, min_side_relations,
                    ivs_by_read.get(rid, []),
                ):
                    self.chimeric.add(rid)
                    flagged.append(rid)
            if flagged:
                drop = set(flagged)
                self.edges = [
                    e
                    for e in self.edges
                    if e.read1 not in drop and e.read2 not in drop
                ]
                self.embedded = {
                    r: emb
                    for r, emb in self.embedded.items()
                    if r not in drop and emb.host not in drop
                }
        return self.chimeric

    def _evidence_intervals_by_read(self) -> dict[int, list[tuple[int, int]]]:
        """One pass over all relations (the former per-read scan over the
        full edge list was O(reads x edges) — superlinear at scale)."""
        out: dict[int, list[tuple[int, int]]] = {}
        for e in self.edges:
            if e.ev1_end > e.ev1_start:
                out.setdefault(e.read1, []).append((e.ev1_start, e.ev1_end))
            if e.ev2_end > e.ev2_start:
                out.setdefault(e.read2, []).append((e.ev2_start, e.ev2_end))
        for emb in self.embedded.values():
            s = emb.host_evidence_start
            t = emb.host_evidence_end
            if t > s:
                out.setdefault(emb.host, []).append((s, t))
        return out

    def _read_evidence_intervals(self, rid: int) -> list[tuple[int, int]]:
        return self._evidence_intervals_by_read().get(rid, [])

    def _is_chimeric(
        self,
        rid: int,
        flank: int,
        min_side: int,
        ivs: list[tuple[int, int]] | None = None,
    ) -> bool:
        L = self.read_lengths[rid]
        if L < 3 * flank:
            return False
        if ivs is None:
            ivs = self._read_evidence_intervals(rid)
        if len(ivs) < 2 * min_side:
            return False
        left = [t for s, t in ivs if s < flank and t < L - flank]
        right = [s for s, t in ivs if t > L - flank and s > flank]
        if len(left) < min_side or len(right) < min_side:
            return False
        # spanning relations cover the candidate junction -> not chimeric
        left.sort()
        right.sort()
        end_left = left[len(left) // 2]
        start_right = right[len(right) // 2]
        lo, hi = min(end_left, start_right), max(end_left, start_right)
        for s, t in ivs:
            if s < lo - 50 and t > hi + 50:
                return False
        return True

    def _remove_read_relations(self, rid: int) -> None:
        self.edges = [e for e in self.edges if e.read1 != rid and e.read2 != rid]
        self.embedded = {
            r: emb
            for r, emb in self.embedded.items()
            if r != rid and emb.host != rid
        }

    # ------------------------------------------------------------------
    # relationship scores (ref: AssemblySequencesRelationshipScores
    # Calculator.calculateScore/calculateCost)
    # ------------------------------------------------------------------
    def update_scores(self) -> None:
        """score = CSK * evidence proportion (ref calculateScore); cost =
        weighted -log10 p-values of (CSK, evidence proportion, IKBP)
        against normal fits over current edges (ref calculateCost weights
        {0,1,0,0,0.5,0.5})."""
        rels = list(self.edges) + list(self.embedded.values())
        if not rels:
            return
        csks = [r.csk for r in rels]
        evs = [r.ev_prop for r in rels]
        ikbps = [getattr(r, "ikbp", 0.0) for r in rels]
        n = len(rels)
        mean_csk = sum(csks) / n
        var_csk = sum((x - mean_csk) ** 2 for x in csks) / max(1, n - 1)
        mean_ev = sum(evs) / n
        var_ev = sum((x - mean_ev) ** 2 for x in evs) / max(1, n - 1)
        mean_ik = sum(ikbps) / n
        var_ik = sum((x - mean_ik) ** 2 for x in ikbps) / max(1, n - 1)
        for r in rels:
            r.score = float(r.csk) * float(r.ev_prop)
            c_csk = _neg_log10_limited(
                min(1.0, _norm_cdf(r.csk, mean_csk, var_csk))
            )
            c_ev = _neg_log10_limited(
                min(0.5, _norm_cdf(r.ev_prop, mean_ev, var_ev))
            )
            ik = getattr(r, "ikbp", 0.0)
            c_ik = _neg_log10_limited(
                min(0.25, 1.0 - _norm_cdf(ik, mean_ik, var_ik))
            )
            cost = c_csk + 0.5 * c_ev + 0.5 * c_ik
            if isinstance(r, AssemblyEdge):
                r.cost = cost

    def filter_edges_and_embedded(self, min_score_proportion: float = 0.3) -> None:
        """Drop relations scoring below `min_score_proportion` of the best
        score at either endpoint vertex (ref:
        AssemblySequencesRelationshipFilter.filterEdgesAndEmbedded)."""
        best: dict[tuple[int, bool], float] = {}

        def vkey(e: AssemblyEdge, first: bool):
            if first:
                return (e.read1, not e.rev1)  # exit end of read1
            return (e.read2, e.rev2)  # entry end of read2

        for e in self.edges:
            for first in (True, False):
                k = vkey(e, first)
                if e.score > best.get(k, 0.0):
                    best[k] = e.score
        self.edges = [
            e
            for e in self.edges
            if e.score
            >= min_score_proportion * max(best[vkey(e, True)], best[vkey(e, False)])
        ]
        best_host: dict[int, float] = {}
        for emb in self.embedded.values():
            if emb.score > best_host.get(emb.read, 0.0):
                best_host[emb.read] = emb.score
        self.embedded = {
            r: emb
            for r, emb in self.embedded.items()
            if emb.score >= min_score_proportion * best_host.get(r, 0.0)
        }

    # ------------------------------------------------------------------
    # serialization (ref: assembly/io/AssemblyGraphFileHandler.java —
    # gzipped text; same information, line-oriented layout)
    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        with gzip.open(path, "wt") as fh:
            fh.write(f"#GRAPH\t{self.n_reads}\n")
            fh.write(
                "#LENGTHS\t" + ",".join(str(x) for x in self.read_lengths) + "\n"
            )
            if self.chimeric:
                fh.write(
                    "#CHIMERIC\t"
                    + ",".join(str(x) for x in sorted(self.chimeric))
                    + "\n"
                )
            for emb in self.embedded.values():
                fh.write(
                    f"E\t{emb.read}\t{emb.host}\t{emb.host_start}\t"
                    f"{int(emb.reverse)}\t{emb.nshared}\t{emb.csk}\t"
                    f"{emb.ev_prop:.6f}\t{emb.host_evidence_start}\t"
                    f"{emb.host_evidence_end}\t{emb.score:.6f}\n"
                )
            for e in self.edges:
                fh.write(
                    f"V\t{e.read1}\t{int(e.rev1)}\t{e.read2}\t{int(e.rev2)}\t"
                    f"{e.overlap}\t{e.score:.6f}\t{e.nshared}\t{e.csk}\t"
                    f"{e.ev_prop:.6f}\t{e.ikbp:.6f}\t{e.cost:.6f}\t"
                    f"{e.ev1_start}\t{e.ev1_end}\t{e.ev2_start}\t{e.ev2_end}\n"
                )

    @classmethod
    def load(cls, path: str) -> "AssemblyGraph":
        with gzip.open(path, "rt") as fh:
            header = fh.readline().rstrip("\n").split("\t")
            assert header[0] == "#GRAPH", "not an assembly graph file"
            g = cls(int(header[1]))
            for line in fh:
                f = line.rstrip("\n").split("\t")
                if f[0] == "#LENGTHS":
                    g.read_lengths = [int(x) for x in f[1].split(",")]
                elif f[0] == "#CHIMERIC":
                    g.chimeric = {int(x) for x in f[1].split(",")}
                elif f[0] == "E":
                    g.add_embedded(
                        AssemblyEmbedded(
                            read=int(f[1]), host=int(f[2]),
                            host_start=int(f[3]), reverse=bool(int(f[4])),
                            nshared=int(f[5]), csk=int(f[6]),
                            ev_prop=float(f[7]),
                            host_evidence_start=int(f[8]),
                            host_evidence_end=int(f[9]), score=float(f[10]),
                        )
                    )
                elif f[0] == "V":
                    g.add_edge(
                        AssemblyEdge(
                            read1=int(f[1]), rev1=bool(int(f[2])),
                            read2=int(f[3]), rev2=bool(int(f[4])),
                            overlap=int(f[5]), score=float(f[6]),
                            nshared=int(f[7]), csk=int(f[8]),
                            ev_prop=float(f[9]), ikbp=float(f[10]),
                            cost=float(f[11]),
                            ev1_start=int(f[12]), ev1_end=int(f[13]),
                            ev2_start=int(f[14]), ev2_end=int(f[15]),
                        )
                    )
        return g
