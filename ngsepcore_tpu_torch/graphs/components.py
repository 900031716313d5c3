"""Graph algorithms: strongly connected components and maximal cliques.

Ref: src/ngsep/graphs/StronglyConnectedComponents.java (Tarjan-style) and
MaximalCliquesFinder.java / CliquesFinder.java (used by the SV clustering
algorithms).
"""
from __future__ import annotations

import numpy as np


def strongly_connected_components(adj: list[list[int]]) -> list[list[int]]:
    """Iterative Tarjan SCC over an adjacency list."""
    n = len(adj)
    index = [-1] * n
    low = [0] * n
    on_stack = [False] * n
    stack: list[int] = []
    out: list[list[int]] = []
    counter = 0
    for root in range(n):
        if index[root] != -1:
            continue
        work = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = low[v] = counter
                counter += 1
                stack.append(v)
                on_stack[v] = True
            recurse = False
            for i in range(pi, len(adj[v])):
                w = adj[v][i]
                if index[w] == -1:
                    work[-1] = (v, i + 1)
                    work.append((w, 0))
                    recurse = True
                    break
                elif on_stack[w]:
                    low[v] = min(low[v], index[w])
            if recurse:
                continue
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == v:
                        break
                out.append(comp)
            work.pop()
            if work:
                u = work[-1][0]
                low[u] = min(low[u], low[v])
    return out


def maximal_cliques(
    adj_matrix: np.ndarray, max_cliques: int = 10000
) -> list[list[int]]:
    """Bron-Kerbosch with pivoting on a boolean adjacency matrix."""
    n = adj_matrix.shape[0]
    neighbors = [set(np.nonzero(adj_matrix[i])[0].tolist()) - {i} for i in range(n)]
    out: list[list[int]] = []

    def bk(r: set, p: set, x: set) -> None:
        if len(out) >= max_cliques:
            return
        if not p and not x:
            out.append(sorted(r))
            return
        pivot = max(p | x, key=lambda u: len(neighbors[u] & p))
        for v in list(p - neighbors[pivot]):
            bk(r | {v}, p & neighbors[v], x & neighbors[v])
            p.remove(v)
            x.add(v)

    bk(set(), set(range(n)), set())
    return out
