"""Phred score conversions.

Ref: src/ngsep/math/PhredScoreHelper.java:31-46.  The reference computes
`calculatePhredScore(p)` = round(-10*log10(p)) capped at 255 and
`calculateProbability(score)` = 10^(-score/10).
"""
from __future__ import annotations

import math

MAX_PHRED = 255


def phred_score(probability: float) -> int:
    """round(-10*log10(p)), capped; p<=0 maps to MAX_PHRED.

    Ref: PhredScoreHelper.java:31 (calculatePhredScore).
    """
    if probability <= 0:
        return MAX_PHRED
    if probability >= 1:
        return 0
    score = int(round(-10.0 * math.log10(probability)))
    return min(score, MAX_PHRED)


def phred_probability(score: int) -> float:
    """10^(-score/10) (ref: PhredScoreHelper.java:42)."""
    return 10.0 ** (-score / 10.0)
