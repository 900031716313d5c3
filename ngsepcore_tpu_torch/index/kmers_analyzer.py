"""K-mer spectrum analysis: mode, average, expected genome size, rank tables.

Ref: src/ngsep/sequences/KmersMapAnalyzer.java:20-231 — computes the error
mode (first local minimum), coverage mode (local maximum after it), expected
assembly length, and count-rank tables used by the minimizer hash ranking
(ShortKmerCodesTable.java:309-335: rarer kmers rank first so they win
minimizer selection).
"""
from __future__ import annotations

import numpy as np

from .kmers_map import KmersMap


class KmersMapAnalyzer:
    def __init__(self, kmers_map: KmersMap, assembly: bool = False, max_count: int = 1000):
        self.kmers_map = kmers_map
        self.assembly = assembly
        dist = kmers_map.count_distribution(max_count).astype(np.float64)
        self.distribution = dist
        self.first_local_minimum = self._find_first_local_minimum(dist)
        self.local_mode = self._find_mode_after(dist, self.first_local_minimum)
        self.average = (
            float(np.sum(kmers_map.counts.astype(np.float64))) / max(1, len(kmers_map))
        )
        # expected genome length: distinct kmers with count around the mode
        self.expected_assembly_length = int(
            np.sum(dist[self.first_local_minimum :] )
        )

    @staticmethod
    def _find_first_local_minimum(dist: np.ndarray) -> int:
        for c in range(1, len(dist) - 1):
            if dist[c] <= dist[c + 1]:
                return c
        return 1

    @staticmethod
    def _find_mode_after(dist: np.ndarray, start: int) -> int:
        if start >= len(dist):
            return start
        return int(start + np.argmax(dist[start:]))

    def is_error_count(self, count: int) -> bool:
        """Counts below the first local minimum are sequencing errors."""
        return count < self.first_local_minimum

    def rank_of_count(self, counts: np.ndarray) -> np.ndarray:
        """Rank kmers by abundance: rarer (but non-error) kmers rank first.

        Used for count-aware minimizer hashing (ShortKmerCodesTable.java:309-335).
        Returns int64 rank scores; lower = more likely minimizer.
        """
        counts = np.asarray(counts, dtype=np.int64)
        err = counts < self.first_local_minimum
        # non-error: rank by |count - mode| (single-copy kmers near mode first);
        # errors and absent kmers get pushed to the top (large rank)
        base = np.abs(counts - self.local_mode)
        return np.where(err, 1 << 40, base)
