"""Genomic coordinate model.

Ref: src/ngsep/genome/GenomicRegion.java (interface),
GenomicRegionImpl.java.  Coordinates are 1-based inclusive [first, last],
as in the reference.  ngsepcore_tpu/core/regions.py's
GenomicRegionSortedCollection has no caller in the port yet.
"""
from __future__ import annotations

from dataclasses import dataclass


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
