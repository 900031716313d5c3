"""Structural-variant GFF output.

Ref: src/ngsep/variants/io/GFFVariantsFileHandler.java (208 LoC) — the SV
GFF format the single-sample detector writes next to its VCF
(SingleSampleVariantsDetector.java:648-652).
"""
from __future__ import annotations

from ..variants.model import CalledGenomicVariant


def write_sv_gff(svs: list[CalledGenomicVariant], path: str) -> None:
    with open(path, "w") as fh:
        fh.write("##gff-version 3\n")
        for i, c in enumerate(svs):
            feature = c.variant_type
            attrs = f"ID=SV{i + 1};COPY_NUMBER={c.copy_number}"
            fh.write(
                f"{c.sequence_name}\tngsepcore_tpu_torch\t{feature}\t{c.first}\t{c.last}"
                f"\t{c.quality}\t.\t.\t{attrs}\n"
            )
