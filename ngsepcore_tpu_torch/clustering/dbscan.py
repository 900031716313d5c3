"""Standalone DBSCAN over a precomputed adjacency structure.

Ref: src/ngsep/clustering/DBSCANClusteringAlgorithm.java:30-100 — labels
are UNDEFINED(-1)/NOISE(0)/cluster ids; core points need >= minPts
neighbours; border points join the cluster of the core that reached them
but do not expand.  The adjacency list encodes the epsilon neighbourhood
(callers precompute it), exactly like the reference's rangeQuery.

A copy of ngsepcore_tpu/clustering/dbscan.py (host code).
"""
from __future__ import annotations

from collections import deque


class DBSCANClusteringAlgorithm:
    UNDEFINED_LABEL = -1
    NOISE_LABEL = 0

    def __init__(self):
        self.noise_points: list[int] = []

    def run_dbscan_clustering(
        self, idxs: list[int], adjacency: list[list[int]], min_pts: int
    ) -> list[list[int]]:
        labels = self._dbscan(idxs, adjacency, min_pts)
        clusters: dict[int, list[int]] = {}
        self.noise_points = []
        for i, c in enumerate(labels):
            if c == self.NOISE_LABEL:
                self.noise_points.append(idxs[i])
            else:
                clusters.setdefault(c, []).append(idxs[i])
        return [clusters[c] for c in sorted(clusters)]

    def _dbscan(
        self, idxs: list[int], adjacency: list[list[int]], min_pts: int
    ) -> list[int]:
        n = len(idxs)
        labels = [self.UNDEFINED_LABEL] * n
        c = 0
        for i in range(n):
            if labels[i] != self.UNDEFINED_LABEL:
                continue
            neighbors = adjacency[i]
            if len(neighbors) < min_pts:
                labels[i] = self.NOISE_LABEL
                continue
            c += 1
            labels[i] = c
            queue = deque(neighbors)
            while queue:
                j = queue.popleft()
                if labels[j] != self.UNDEFINED_LABEL:
                    continue
                nj = adjacency[j]
                labels[j] = c
                if len(nj) >= min_pts:
                    queue.extend(nj)
        return labels
