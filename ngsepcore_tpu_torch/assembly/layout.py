"""MST-based path layout (KruskalPath) + greedy variants.

Ref: src/ngsep/assembly/LayoutBuilderKruskalPath.java:71-460 — the layout
runs in stages: (1) SAFE edges (reciprocal-best at both endpoint vertices,
cost <= 3x average, indels/kbp <= 5x average; AssemblyGraph.selectSafeEdges
:783-830) seed initial paths; (2) connecting edges between path END
vertices are sorted by cost and selected Kruskal-style — each end vertex
used at most once, paths union-found into clusters, indels/kbp capped at
mean + 15*sd of the current path edges (selectEdgesToMergePaths :146-186);
(3) improvement rounds re-run the merge on the grown paths and absorb
small alternative paths whose two end connectors land inside one host path
(collectAlternativeSmallPaths :197-239 — repeat-induced bubbles).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from .graph import AssemblyEdge, AssemblyGraph


def _exit_end(r: int, rev: bool) -> tuple[int, str]:
    return (r, "L" if rev else "R")


def _entry_end(r: int, rev: bool) -> tuple[int, str]:
    return (r, "R" if rev else "L")


@dataclass
class AssemblyPath:
    """Ordered oriented reads with the overlap into each next read."""

    reads: list[tuple[int, bool]] = field(default_factory=list)  # (read, rev)
    overlaps: list[int] = field(default_factory=list)  # len == len(reads)-1

    def __len__(self) -> int:
        return len(self.reads)

    @property
    def left_end(self) -> tuple[int, str]:
        r, rev = self.reads[0]
        return _entry_end(r, rev)

    @property
    def right_end(self) -> tuple[int, str]:
        r, rev = self.reads[-1]
        return _exit_end(r, rev)

    def reversed(self) -> "AssemblyPath":
        return AssemblyPath(
            [(r, not rev) for r, rev in reversed(self.reads)],
            list(reversed(self.overlaps)),
        )


def _build_paths(
    edges: list[AssemblyEdge], active: list[int]
) -> list[AssemblyPath]:
    """Chain the given edges into simple paths; every physical read end is
    used at most once and cycles are broken (union-find).  Reads in
    `active` that no edge touches become single-read paths (the reference
    keeps isolated vertices as candidate path ends too)."""
    junction: dict[tuple[int, str], tuple[tuple[int, str], int]] = {}
    parent: dict[int, int] = {r: r for r in active}

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    in_any = set()
    for e in edges:
        if e.read1 not in parent or e.read2 not in parent:
            continue
        e1 = _exit_end(e.read1, e.rev1)
        e2 = _entry_end(e.read2, e.rev2)
        if e1 in junction or e2 in junction:
            continue
        if find(e.read1) == find(e.read2):
            continue
        junction[e1] = (e2, e.overlap)
        junction[e2] = (e1, e.overlap)
        parent[find(e.read2)] = find(e.read1)
        in_any.add(e.read1)
        in_any.add(e.read2)

    paths: list[AssemblyPath] = []
    visited: set[int] = set()

    def walk(r0: int, entry: str) -> AssemblyPath:
        p = AssemblyPath()
        r, ent = r0, entry
        while True:
            visited.add(r)
            p.reads.append((r, ent == "R"))
            ex = (r, "R" if ent == "L" else "L")
            nxt = junction.get(ex)
            if nxt is None:
                break
            (r2, ent2), ov = nxt
            if r2 in visited:
                break
            p.overlaps.append(ov)
            r, ent = r2, ent2
        return p

    for r in active:
        if r in visited or r not in in_any:
            continue
        lfree = (r, "L") not in junction
        rfree = (r, "R") not in junction
        if lfree:
            paths.append(walk(r, "L"))
        elif rfree:
            paths.append(walk(r, "R"))
    for r in active:  # circular leftovers
        if r in in_any and r not in visited:
            paths.append(walk(r, "L"))
    for r in active:  # isolated reads as 1-paths
        if r not in visited:
            visited.add(r)
            paths.append(AssemblyPath([(r, False)], []))
    return paths


class LayoutBuilderKruskalPath:
    """The reference's default layout algorithm."""

    def __init__(self, min_path_reads: int = 1, improvement_rounds: int = 2):
        self.min_path_reads = min_path_reads
        self.improvement_rounds = improvement_rounds

    # ---- stage 1: safe edges -----------------------------------------
    def select_safe_edges(self, graph: AssemblyGraph) -> list[AssemblyEdge]:
        edges = graph.filtered_edges()
        best: dict[tuple[int, str], AssemblyEdge] = {}
        for e in edges:
            for v in (_exit_end(e.read1, e.rev1), _entry_end(e.read2, e.rev2)):
                b = best.get(v)
                if b is None or e.score > b.score:
                    best[v] = e
        raw = [
            e
            for e in edges
            if best.get(_exit_end(e.read1, e.rev1)) is e
            and best.get(_entry_end(e.read2, e.rev2)) is e
        ]
        if not raw:
            return raw
        avg_cost = sum(e.cost for e in raw) / len(raw)
        avg_ikbp = sum(e.ikbp for e in raw) / len(raw)
        return [
            e
            for e in raw
            if e.cost <= 3 * avg_cost and e.ikbp <= 5 * avg_ikbp + 1e-9
        ]

    # ---- stage 2: Kruskal merge of path ends -------------------------
    def _connect_paths(
        self,
        graph: AssemblyGraph,
        paths: list[AssemblyPath],
        path_edges: list[AssemblyEdge],
    ) -> list[AssemblyEdge]:
        if len(paths) < 2:
            return []
        ik = [e.ikbp for e in path_edges] or [0.0]
        mean_ik = sum(ik) / len(ik)
        var_ik = sum((x - mean_ik) ** 2 for x in ik) / max(1, len(ik) - 1)
        limit_ikbp = mean_ik + 15 * math.sqrt(var_ik) + 1e-9
        end_pos: dict[tuple[int, str], int] = {}
        clusters: list[int] = []
        for i, p in enumerate(paths):
            end_pos[p.left_end] = 2 * i
            end_pos[p.right_end] = 2 * i + 1
            clusters.extend([i, i])
        used = [False] * (2 * len(paths))
        cands = []
        for e in graph.filtered_edges():
            v1 = _exit_end(e.read1, e.rev1)
            v2 = _entry_end(e.read2, e.rev2)
            if v1 in end_pos and v2 in end_pos:
                cands.append(e)
        cands.sort(key=lambda e: e.cost)
        selected = []
        for e in cands:
            p1 = end_pos[_exit_end(e.read1, e.rev1)]
            p2 = end_pos[_entry_end(e.read2, e.rev2)]
            if used[p1] or used[p2]:
                continue
            if e.ikbp > limit_ikbp:
                continue
            c1, c2 = clusters[p1], clusters[p2]
            if c1 == c2:
                continue
            selected.append(e)
            used[p1] = used[p2] = True
            for i in range(len(clusters)):
                if clusters[i] == c2:
                    clusters[i] = c1
        return selected

    # ---- stage 3: absorb small alternative paths ---------------------
    def _collect_small_paths(
        self, graph: AssemblyGraph, paths: list[AssemblyPath]
    ) -> list[AssemblyPath]:
        """Drop paths of <= 20 reads whose two end connectors land inside
        one long host path nearby — repeat bubbles duplicating host
        sequence (ref collectAlternativeSmallPaths: the reference keeps
        them as 'alternative small paths' of the host; the consensus here
        uses only the host copy)."""
        pos_in_path: dict[tuple[int, str], tuple[int, int]] = {}
        for pi, p in enumerate(paths):
            for ri, (r, rev) in enumerate(p.reads):
                pos_in_path[(r, "L")] = (pi, ri)
                pos_in_path[(r, "R")] = (pi, ri)
        by_end: dict[tuple[int, str], AssemblyEdge] = {}
        for e in graph.filtered_edges():
            for v in (_exit_end(e.read1, e.rev1), _entry_end(e.read2, e.rev2)):
                b = by_end.get(v)
                if b is None or e.cost < b.cost:
                    by_end[v] = e
        drop: set[int] = set()
        for pi, p in enumerate(paths):
            if len(p) > 20:
                continue
            le = by_end.get(p.left_end)
            re_ = by_end.get(p.right_end)
            if le is None or re_ is None:
                continue

            def other(e: AssemblyEdge, end: tuple[int, str]):
                v1 = _exit_end(e.read1, e.rev1)
                return (
                    _entry_end(e.read2, e.rev2) if v1 == end else v1
                )

            lo = pos_in_path.get(other(le, p.left_end))
            ro = pos_in_path.get(other(re_, p.right_end))
            if lo is None or ro is None:
                continue
            if lo[0] == pi or lo[0] != ro[0]:
                continue
            host = paths[lo[0]]
            if 0.1 * len(host) < len(p):
                continue
            if abs(lo[1] - ro[1]) > 1.5 * len(p):
                continue
            drop.add(pi)
        return [p for i, p in enumerate(paths) if i not in drop]

    # ---- entry point ----------------------------------------------------
    def find_paths(self, graph: AssemblyGraph) -> list[AssemblyPath]:
        active = graph.active_reads()
        path_edges = self.select_safe_edges(graph)
        paths = _build_paths(path_edges, active)
        for _ in range(max(1, self.improvement_rounds)):
            new_edges = self._connect_paths(graph, paths, path_edges)
            if not new_edges:
                break
            path_edges = path_edges + new_edges
            paths = _build_paths(path_edges, active)
        paths = self._collect_small_paths(graph, paths)
        return [p for p in paths if len(p) >= self.min_path_reads]


class LayoutBuilderGreedy:
    """Greedy variants (ref LayoutBuilderGreedyMaxOverlap / MinCost):
    single sorted pass over all edges with per-end usage constraints."""

    def __init__(self, sort_key: str = "MaxOverlap"):
        self.sort_key = sort_key

    def find_paths(self, graph: AssemblyGraph) -> list[AssemblyPath]:
        keys = {
            "MaxOverlap": lambda e: (-e.overlap, -e.score),
            "MinCost": lambda e: (e.cost, -e.score),
            "MaxCoverageSharedKmers": lambda e: (-e.csk, -e.score),
        }
        edges = sorted(
            graph.filtered_edges(), key=keys.get(self.sort_key, keys["MaxOverlap"])
        )
        return _build_paths(edges, graph.active_reads())
