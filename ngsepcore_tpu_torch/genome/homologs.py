"""Homolog detection and orthogroup clustering.

Ref: src/ngsep/genome/HomologRelationshipsFinder.java:45-47 (6-mer
percentage similarity, min 11% shared k-mers),
HomologClustersCalculator.java:82-325 (orthogroups via MCL over the
homolog graph), CDNACatalogAligner.java (catalog mode), and the
GenomesAligner command orchestration (GenomesAligner.java:373-396).

Counterpart of ngsepcore_tpu/genome/homologs.py: per-sequence 6-mer sets
become one global sorted (kmer_hash, seq) array on the host; pair
similarity counts come from segment reductions over shared-hash groups;
MCL runs on the caller's device, one call a connected component of more
than two sequences.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..graphs.mcl import mcl_cluster
from ..utils.profiling import stage

DEF_KMER_LENGTH = 6  # ref: HomologRelationshipsFinder.java:45
DEF_MIN_PCT_KMERS = 11  # ref :46


def _sequence_kmer_hashes(seq: str, k: int) -> np.ndarray:
    """Distinct k-mer hashes of a protein/cDNA string."""
    if len(seq) < k:
        return np.empty(0, np.int64)
    b = np.frombuffer(seq.upper().encode("ascii"), np.uint8).astype(np.int64)
    n = len(b) - k + 1
    h = np.zeros(n, np.int64)
    for j in range(k):
        h = h * 131 + b[j : j + n]
    return np.unique(h)


@dataclass
class HomologRelationship:
    seq1: int
    seq2: int
    pct_shared: float


class HomologRelationshipsFinder:
    def __init__(self, k: int = DEF_KMER_LENGTH, min_pct: float = DEF_MIN_PCT_KMERS):
        self.k = k
        self.min_pct = min_pct

    def find_homologs(self, sequences: list[str]) -> list[HomologRelationship]:
        """All pairs with >= min_pct shared distinct k-mers (of the smaller
        set), computed from one global sorted hash array."""
        sets = [_sequence_kmer_hashes(s, self.k) for s in sequences]
        sizes = np.array([max(1, len(s)) for s in sets])
        hashes = np.concatenate(sets) if sets else np.empty(0, np.int64)
        owners = np.concatenate(
            [np.full(len(s), i, np.int32) for i, s in enumerate(sets)]
        ) if sets else np.empty(0, np.int32)
        order = np.argsort(hashes, kind="stable")
        hashes, owners = hashes[order], owners[order]
        starts = np.nonzero(np.concatenate([[True], hashes[1:] != hashes[:-1]]))[0]
        ends = np.concatenate([starts[1:], [len(hashes)]])
        pair_counts: dict[tuple[int, int], int] = {}
        MAX_GROUP = 50
        for s, e in zip(starts, ends):
            g = e - s
            if g < 2 or g > MAX_GROUP:
                continue
            mem = np.unique(owners[s:e])
            for i in range(len(mem)):
                for j in range(i + 1, len(mem)):
                    key = (int(mem[i]), int(mem[j]))
                    pair_counts[key] = pair_counts.get(key, 0) + 1
        out = []
        for (a, b), shared in pair_counts.items():
            pct = 100.0 * shared / min(sizes[a], sizes[b])
            if pct >= self.min_pct:
                out.append(HomologRelationship(a, b, pct))
        return out


def calculate_orthogroups(
    sequences: list[str],
    k: int = DEF_KMER_LENGTH,
    min_pct: float = DEF_MIN_PCT_KMERS,
    inflation: float = 2.0,
    *,
    device,
) -> list[list[int]]:
    """Homolog graph -> MCL clusters (ref: HomologClustersCalculator).
    Profiled stages: orthogroups.homologs (the graph), orthogroups.mcl."""
    with stage("orthogroups.homologs"):
        finder = HomologRelationshipsFinder(k, min_pct)
        rels = finder.find_homologs(sequences)
        n = len(sequences)
        sim = np.zeros((n, n), np.float32)
        for r in rels:
            sim[r.seq1, r.seq2] = sim[r.seq2, r.seq1] = r.pct_shared
    # cluster connected components separately (MCL partition strategy,
    # ref: HomologClustersCalculator.java:301-325)
    visited = np.zeros(n, bool)
    groups: list[list[int]] = []
    for i in range(n):
        if visited[i]:
            continue
        comp = [i]
        visited[i] = True
        stack = [i]
        while stack:
            u = stack.pop()
            for v in np.nonzero(sim[u] > 0)[0]:
                if not visited[v]:
                    visited[v] = True
                    comp.append(int(v))
                    stack.append(int(v))
        if len(comp) <= 2:
            groups.append(comp)
            continue
        sub = sim[np.ix_(comp, comp)]
        with stage("orthogroups.mcl"):
            clusters = mcl_cluster(sub, inflation=inflation, device=device)
        for cluster in clusters:
            groups.append([comp[c] for c in cluster])
    return groups
