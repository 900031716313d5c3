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


def read_sv_gff(path: str) -> list[CalledGenomicVariant]:
    """The SV records of a GFF that write_sv_gff wrote (any source column)."""
    out = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 9:
                continue
            attrs = dict(
                kv.split("=", 1) for kv in f[8].split(";") if "=" in kv
            )
            out.append(
                CalledGenomicVariant(
                    sequence_name=f[0],
                    first=int(f[3]),
                    alleles=["N"],
                    variant_type=f[2],
                    quality=int(float(f[5])) if f[5] not in (".", "") else 0,
                    last_=int(f[4]),
                    copy_number=int(attrs.get("COPY_NUMBER", 2)),
                )
            )
    return out
