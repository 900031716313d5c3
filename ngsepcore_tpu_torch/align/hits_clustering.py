"""Seed hit clustering: diagonal binning of minimizer hits.

Ref: src/ngsep/alignments/UngappedSearchHitsClusterBuilder.java:43-375
(estimate subject start per hit, sort, median/mode collapse, remove
disorganized hits) and UngappedSearchHitsCluster.java:36-330 (predicted
subject window).  Vectorized: hits arrive as flat numpy arrays
(subject_concat_pos, query_pos); clusters are runs of sorted estimated
starts within a tolerance.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class HitsCluster:
    subject_concat_start: int  # predicted 0-based concat start
    weighted_count: float  # distinct query kmer positions supporting
    num_hits: int
    all_consistent: bool
    query_evidence_start: int
    query_evidence_end: int
    # member hit arrays sorted by query position (filled only when
    # cluster_hits(..., with_members=True); used by the long-read
    # anchor-chaining aligner)
    member_qpos: np.ndarray | None = None
    member_spos: np.ndarray | None = None


def cluster_hits(
    subject_pos: np.ndarray,
    query_pos: np.ndarray,
    query_length: int,
    tolerance: int | None = None,
    with_members: bool = False,
) -> list[HitsCluster]:
    """Group hits by estimated subject start (subject_pos - query_pos)."""
    if len(subject_pos) == 0:
        return []
    if tolerance is None:
        # ref uses a query-length-scaled tolerance for collapsing estimates
        tolerance = max(10, query_length // 10)
    est = subject_pos - query_pos
    order = np.argsort(est, kind="stable")
    est_s = est[order]
    qpos_s = query_pos[order]
    breaks = np.nonzero(np.diff(est_s) > tolerance)[0] + 1
    bounds = np.concatenate([[0], breaks, [len(est_s)]])
    sub_s = subject_pos[order]
    clusters: list[HitsCluster] = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        seg_est = est_s[a:b]
        seg_q = qpos_s[a:b]
        distinct_q = np.unique(seg_q)
        # predicted start = early-weighted mean of estimates over hits sorted
        # by subject start, weight (n-i)/n, first 50 hits
        # (ref: UngappedSearchHitsCluster.predictSubjectStart:220-231)
        so = np.argsort(sub_s[a:b], kind="stable")[:50]
        n = b - a
        w = (n - np.arange(len(so), dtype=np.float64)) / n
        start = int(round(float(np.sum(w * seg_est[so])) / float(np.sum(w))))
        # consistent = hits appear in the same order on query and subject
        sub_order = np.argsort(subject_pos[order][a:b], kind="stable")
        consistent = bool(np.all(np.diff(seg_q[sub_order]) >= 0))
        mq = ms = None
        if with_members:
            qorder = np.lexsort((sub_s[a:b], seg_q))
            mq = seg_q[qorder]
            ms = sub_s[a:b][qorder]
        clusters.append(
            HitsCluster(
                subject_concat_start=start,
                weighted_count=float(len(distinct_q)),
                num_hits=int(b - a),
                all_consistent=consistent,
                query_evidence_start=int(distinct_q[0]),
                query_evidence_end=int(distinct_q[-1]),
                member_qpos=mq,
                member_spos=ms,
            )
        )
    return clusters
