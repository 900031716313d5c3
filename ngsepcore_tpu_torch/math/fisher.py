"""Fisher exact test on 2x2 tables (strand-bias test).

Ref: src/ngsep/math/FisherExactTest.java:65-119 — used for strand bias at
CountsHelper.java:563.  Two-tailed p-value by summing hypergeometric
probabilities <= the observed table's probability.
"""
from __future__ import annotations

import math
from functools import lru_cache


@lru_cache(maxsize=4096)
def _lfact(n: int) -> float:
    return math.lgamma(n + 1)


def _log_hyper(a: int, b: int, c: int, d: int) -> float:
    n = a + b + c + d
    return (
        _lfact(a + b)
        + _lfact(c + d)
        + _lfact(a + c)
        + _lfact(b + d)
        - _lfact(n)
        - _lfact(a)
        - _lfact(b)
        - _lfact(c)
        - _lfact(d)
    )


def fisher_exact_2x2(a: int, b: int, c: int, d: int) -> float:
    """Two-tailed Fisher exact p-value for table [[a,b],[c,d]]."""
    row1 = a + b
    col1 = a + c
    n = a + b + c + d
    if n == 0:
        return 1.0
    obs = _log_hyper(a, b, c, d)
    lo = max(0, col1 - (n - row1))
    hi = min(row1, col1)
    p = 0.0
    for x in range(lo, hi + 1):
        lp = _log_hyper(x, row1 - x, col1 - x, n - row1 - col1 + x)
        if lp <= obs + 1e-9:
            p += math.exp(lp)
    return min(1.0, p)
