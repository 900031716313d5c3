"""Codon-aware CDS pairwise alignment.

Ref: src/ngsep/transcriptome/CodonCDSPairwiseAlignment.java — a
codon-unit Needleman-Wunsch with free start (border scores 0),
semi-global end selection over the last half of each border row/column,
match +1 / mismatch -1 / indel -2 per codon.  Used by the comparative
reports to align coding sequences without frameshifting them.

A single CDS pair is a tiny DP; the row recurrence
s[j] = max(base[j], s[j-1] + p) is a prefix cummax of (base[j] - j*p),
so every row fills with two numpy passes instead of a scalar scan.

A copy of ngsepcore_tpu/transcriptome/codon_alignment.py (host code).
"""
from __future__ import annotations

import numpy as np

MATCH = 1
MISMATCH = -1
INDEL = -2


class CodonCDSPairwiseAlignment:
    """Mirrors the reference's public surface: calculateAlignment, then
    getAlignment1/2, getScore, getPctIdentity."""

    def __init__(self):
        self.alignment1 = ""
        self.alignment2 = ""
        self.score = 0
        self.pct_identity = 0.0

    # ------------------------------------------------------------------
    def calculate_alignment(self, cds1: str, cds2: str) -> None:
        n1 = len(cds1) // 3
        n2 = len(cds2) // 3
        c1 = np.frombuffer(
            cds1[: 3 * n1].encode("ascii"), np.uint8
        ).reshape(n1, 3) if n1 else np.zeros((0, 3), np.uint8)
        c2 = np.frombuffer(
            cds2[: 3 * n2].encode("ascii"), np.uint8
        ).reshape(n2, 3) if n2 else np.zeros((0, 3), np.uint8)
        R, C = n1 + 1, n2 + 1
        scores = np.zeros((R, C), np.int64)
        direction = np.zeros((R, C), np.int8)
        direction[0, 1:] = 1
        direction[1:, 0] = 2
        jcol = np.arange(1, C, dtype=np.int64)
        for i in range(1, R):
            eq = (c1[i - 1][None, :] == c2).all(axis=1)  # (n2,)
            diag = scores[i - 1, :-1] + np.where(eq, MATCH, MISMATCH)
            up = scores[i - 1, 1:] + INDEL
            base = np.maximum(diag, up)
            # s[j] = max(base[j], s[j-1] + INDEL) via prefix cummax
            t = base - jcol * INDEL
            s = np.maximum.accumulate(t) + jcol * INDEL
            scores[i, 1:] = s
            # direction precedence on ties mirrors the reference's
            # sequential overwrites: diag, then left if strictly greater,
            # then up if strictly greater
            left_path = np.empty(C - 1, np.int64)
            left_path[0] = scores[i, 0] + INDEL
            left_path[1:] = s[:-1] + INDEL
            d = np.zeros(C - 1, np.int8)
            d[left_path > diag] = 1
            d[up > np.maximum(diag, left_path)] = 2
            direction[i, 1:] = d
        # semi-global end: best over the last half of the final column,
        # then of the final row (ref :63-76)
        max_i, max_j = R - 1, C - 1
        score = int(scores[max_i, max_j])
        for i in range(R - 2, int(np.ceil(0.5 * R)) - 1, -1):
            if scores[i, C - 1] > score:
                max_i = i
                score = int(scores[i, C - 1])
        for j in range(C - 2, int(np.ceil(0.5 * C)) - 1, -1):
            if scores[R - 1, j] > score:
                max_i = R - 1
                max_j = j
                score = int(scores[max_i, max_j])
        self.score = score
        a1: list[str] = []
        a2: list[str] = []
        identical = 0
        i, j = max_i, max_j
        gap = "---"
        while i > 0 or j > 0:
            d = direction[i, j]
            if d == 0:
                codon1 = cds1[3 * (i - 1) : 3 * i]
                codon2 = cds2[3 * (j - 1) : 3 * j]
                if codon1 == codon2:
                    identical += 3
                a1.append(codon1)
                a2.append(codon2)
                i -= 1
                j -= 1
            elif d == 1:
                a1.append(gap)
                a2.append(cds2[3 * (j - 1) : 3 * j])
                j -= 1
            else:
                a1.append(cds1[3 * (i - 1) : 3 * i])
                a2.append(gap)
                i -= 1
        self.alignment1 = "".join(reversed(a1))
        self.alignment2 = "".join(reversed(a2))
        if self.alignment1:
            self.pct_identity = 100.0 * identical / len(self.alignment1)
        else:
            self.pct_identity = 0.0

    # Java-style accessors for API parity
    def get_alignment1(self) -> str:
        return self.alignment1

    def get_alignment2(self) -> str:
        return self.alignment2

    def get_score(self) -> int:
        return self.score

    def get_pct_identity(self) -> float:
        return self.pct_identity
