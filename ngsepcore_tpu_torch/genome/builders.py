"""Genome region files.

Ref: SimpleGenomicRegionFileHandler (3-column text regions), read by
SingleSampleVariantsDetector's -knownSTRs and -knownRepeats options.  The
genome builders of ngsepcore_tpu/genome/builders.py (IndividualGenomeBuilder,
GenomeAssemblyMask) belong to ROADMAP.md Queue 1 item 17.
"""
from __future__ import annotations

from ..core.regions import GenomicRegion


def load_regions_file(path: str) -> list[GenomicRegion]:
    """3-column text regions (ref: SimpleGenomicRegionFileHandler)."""
    out = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            f = line.split()
            out.append(GenomicRegion(f[0], int(f[1]), int(f[2])))
    return out
