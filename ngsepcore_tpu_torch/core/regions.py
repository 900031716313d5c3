"""Genomic coordinate model.

Ref: src/ngsep/genome/GenomicRegion.java (interface),
GenomicRegionImpl.java, GenomicRegionSortedCollection.java:33-240.
Coordinates are 1-based inclusive [first, last], as in the reference.
A copy of ngsepcore_tpu/core/regions.py (host numpy; vcf/analytics.py's
VCFFilter queries the sorted collection).
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Generic, Iterable, Iterator, Sequence, TypeVar

import numpy as np


@dataclass
class GenomicRegion:
    sequence_name: str
    first: int  # 1-based inclusive
    last: int  # 1-based inclusive
    negative_strand: bool = False

    def length(self) -> int:
        return self.last - self.first + 1

    def overlaps(self, other: "GenomicRegion") -> bool:
        return (
            self.sequence_name == other.sequence_name
            and self.first <= other.last
            and other.first <= self.last
        )

    def span_key(self) -> tuple[str, int, int]:
        return (self.sequence_name, self.first, self.last)


R = TypeVar("R", bound=GenomicRegion)


class GenomicRegionSortedCollection(Generic[R]):
    """Position-sorted region collection with spanning queries.

    Ref: src/ngsep/genome/GenomicRegionSortedCollection.java:33 (binary
    search + spanning queries at :224-240).  Backed by per-sequence sorted
    lists with numpy arrays of firsts/lasts for O(log n) queries.
    """

    def __init__(self, sequence_names: Sequence[str] | None = None):
        self._per_seq: dict[str, list[R]] = {}
        self._order: list[str] = list(sequence_names) if sequence_names else []
        self._sorted = True
        self._firsts: dict[str, np.ndarray] = {}
        self._maxlast: dict[str, np.ndarray] = {}

    def add(self, region: R) -> None:
        name = region.sequence_name
        if name not in self._per_seq:
            self._per_seq[name] = []
            if name not in self._order:
                self._order.append(name)
        self._per_seq[name].append(region)
        self._sorted = False

    def add_all(self, regions: Iterable[R]) -> None:
        for r in regions:
            self.add(r)

    def force_sort(self) -> None:
        if self._sorted:
            return
        for name, lst in self._per_seq.items():
            lst.sort(key=lambda r: (r.first, r.last))
            firsts = np.array([r.first for r in lst], dtype=np.int64)
            lasts = np.array([r.last for r in lst], dtype=np.int64)
            # running max of region ends enables spanning queries over
            # intervals that start earlier but extend past the query start
            maxlast = np.maximum.accumulate(lasts) if len(lasts) else lasts
            self._firsts[name] = firsts
            self._maxlast[name] = maxlast
        self._sorted = True

    def find_spanning(self, sequence_name: str, first: int, last: int | None = None) -> list[R]:
        """All regions overlapping [first, last] on sequence_name."""
        if last is None:
            last = first
        self.force_sort()
        lst = self._per_seq.get(sequence_name)
        if not lst:
            return []
        firsts = self._firsts[sequence_name]
        maxlast = self._maxlast[sequence_name]
        hi = bisect.bisect_right(firsts.tolist(), last)
        # walk back while the running-max end can still reach `first`
        out = []
        for i in range(hi - 1, -1, -1):
            if maxlast[i] < first:
                break
            r = lst[i]
            if r.last >= first:
                out.append(r)
        out.reverse()
        return out

    def as_list(self) -> list[R]:
        self.force_sort()
        out: list[R] = []
        for name in self._order:
            out.extend(self._per_seq.get(name, []))
        return out

    def sequence_names(self) -> list[str]:
        return list(self._order)

    def __len__(self) -> int:
        return sum(len(v) for v in self._per_seq.values())

    def __iter__(self) -> Iterator[R]:
        return iter(self.as_list())
