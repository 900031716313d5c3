"""Distance-based tree building: Neighbor Joining and UPGMA with Newick
output.

Ref: src/ngsep/clustering/nj/NeighborJoining.java + FastNJ.java (326 LoC),
UPGMA.java (258 LoC), Dendrogram.java (Newick serialization),
DistanceClusteringService.java (dispatcher).  Vectorized numpy: the
O(n^2) Q-matrix per NJ step is one broadcasted matrix op.  A copy of
ngsepcore_tpu/clustering/trees.py (host numpy).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class TreeNode:
    name: str | None = None
    children: list[tuple["TreeNode", float]] = field(default_factory=list)

    def to_newick(self) -> str:
        return self._newick() + ";"

    def _newick(self) -> str:
        if not self.children:
            return self.name or ""
        inner = ",".join(
            f"{child._newick()}:{length:.6f}" for child, length in self.children
        )
        return f"({inner}){self.name or ''}"


@dataclass
class Dendrogram:
    root: TreeNode

    def to_newick(self) -> str:
        return self.root.to_newick()


def neighbor_joining(dist: np.ndarray, names: list[str]) -> Dendrogram:
    """Saitou-Nei neighbor joining (ref: clustering/nj/NeighborJoining.java)."""
    n = len(names)
    if n == 1:
        return Dendrogram(TreeNode(name=names[0]))
    D = dist.astype(np.float64).copy()
    nodes = [TreeNode(name=nm) for nm in names]
    active = list(range(n))
    while len(active) > 2:
        m = len(active)
        sub = D[np.ix_(active, active)]
        r = sub.sum(axis=1)
        Q = (m - 2) * sub - r[:, None] - r[None, :]
        np.fill_diagonal(Q, np.inf)
        i_loc, j_loc = np.unravel_index(np.argmin(Q), Q.shape)
        if i_loc > j_loc:
            i_loc, j_loc = j_loc, i_loc
        i, j = active[i_loc], active[j_loc]
        dij = sub[i_loc, j_loc]
        li = 0.5 * dij + (r[i_loc] - r[j_loc]) / (2 * (m - 2))
        lj = dij - li
        parent = TreeNode(children=[(nodes[i], max(0.0, li)), (nodes[j], max(0.0, lj))])
        # distances from the new node
        dnew = 0.5 * (D[i, active] + D[j, active] - dij)
        D = np.pad(D, ((0, 1), (0, 1)))
        k = D.shape[0] - 1
        D[k, active] = dnew
        D[active, k] = dnew
        D[k, k] = 0.0
        nodes.append(parent)
        active = [a for a in active if a not in (i, j)] + [k]
    i, j = active
    d = D[i, j]
    root = TreeNode(children=[(nodes[i], d / 2), (nodes[j], d / 2)])
    return Dendrogram(root)


def upgma(dist: np.ndarray, names: list[str]) -> Dendrogram:
    """UPGMA average-linkage clustering (ref: clustering/UPGMA.java)."""
    n = len(names)
    D = dist.astype(np.float64).copy()
    nodes: list[TreeNode] = [TreeNode(name=nm) for nm in names]
    heights = [0.0] * n
    sizes = [1] * n
    active = list(range(n))
    while len(active) > 1:
        sub = D[np.ix_(active, active)].copy()
        np.fill_diagonal(sub, np.inf)
        i_loc, j_loc = np.unravel_index(np.argmin(sub), sub.shape)
        if i_loc > j_loc:
            i_loc, j_loc = j_loc, i_loc
        i, j = active[i_loc], active[j_loc]
        h = sub[i_loc, j_loc] / 2
        parent = TreeNode(
            children=[(nodes[i], h - heights[i]), (nodes[j], h - heights[j])]
        )
        new_size = sizes[i] + sizes[j]
        dnew = (sizes[i] * D[i, active] + sizes[j] * D[j, active]) / new_size
        D = np.pad(D, ((0, 1), (0, 1)))
        k = D.shape[0] - 1
        D[k, active] = dnew
        D[active, k] = dnew
        nodes.append(parent)
        heights.append(h)
        sizes.append(new_size)
        active = [a for a in active if a not in (i, j)] + [k]
    return Dendrogram(nodes[active[0]])
