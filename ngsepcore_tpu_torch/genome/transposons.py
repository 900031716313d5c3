"""Transposable element annotation.

Ref: src/ngsep/genome/TransposableElementsFinder.java:145-438 (command
`TransposonsFinder`): de-novo repeat discovery from overrepresented
k-mers/minimizers plus similarity search against a known TE library.

Counterpart of ngsepcore_tpu/genome/transposons.py: genome minimizer
multiplicities come straight from the CSR minimizer table, built on the
caller's device (rows longer than a repeat threshold mark repetitive
positions); library search extracts each library sequence's minimizers on
the device, one call a sequence, and reuses the seed lookup of read
mapping on the host.  Profiled stages: te.table, te.extract, te.host.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.genome import ReferenceGenome
from ..core.regions import GenomicRegion
from ..core.sequences import QualifiedSequence
from ..index.minimizer_table import MinimizerTable
from ..utils.profiling import stage


@dataclass
class TransposonAnnotation(GenomicRegion):
    te_id: str = "denovo_repeat"
    score: float = 0.0


def find_repeats_denovo(
    genome: ReferenceGenome,
    k: int = 15,
    window: int = 10,
    min_multiplicity: int = 10,
    min_length: int = 200,
    merge_distance: int = 100,
    *,
    device,
) -> list[TransposonAnnotation]:
    """Regions whose minimizers occur >= min_multiplicity times genome-wide."""
    with stage("te.table"):
        table = MinimizerTable.build_from_genome(
            genome, k=k, window=window, max_hits_per_code=1 << 30, device=device
        )
    with stage("te.host"):
        return _denovo_regions(genome, table, k, min_multiplicity, min_length,
                               merge_distance)


def _denovo_regions(genome, table, k, min_multiplicity, min_length, merge_distance):
    row_sizes = np.diff(table.row_offsets)
    # positions covered by repetitive minimizers
    pos = np.sort(table.entry_pos[np.repeat(row_sizes >= min_multiplicity, row_sizes)])
    if len(pos) == 0:
        return []
    # merge into regions
    out: list[TransposonAnnotation] = []
    start = prev = int(pos[0])
    for p in pos[1:]:
        p = int(p)
        if p - prev <= merge_distance + k:
            prev = p
            continue
        _emit_region(genome, start, prev + k, min_length, out)
        start = prev = p
    _emit_region(genome, start, prev + k, min_length, out)
    return out


def _emit_region(genome, start_concat, end_concat, min_length, out):
    if end_concat - start_concat < min_length:
        return
    si, first = genome.split_concat_pos(start_concat)
    sj, last = genome.split_concat_pos(end_concat - 1)
    if si != sj:
        return
    out.append(
        TransposonAnnotation(
            sequence_name=genome.sequence_name(si),
            first=first,
            last=last,
            score=float(end_concat - start_concat),
        )
    )


def find_repeats_by_library(
    genome: ReferenceGenome,
    library: list[QualifiedSequence],
    k: int = 15,
    window: int = 10,
    min_hits: int = 5,
    merge_distance: int = 200,
    *,
    device,
) -> list[TransposonAnnotation]:
    """Similarity search of known TEs against the genome via minimizer hits.
    `find_repeats_by_library.extractions` counts the device extractions
    (one a library sequence)."""
    from ..core.sequences import pack_reads
    from ..kernels.minimizers import extract_minimizers

    with stage("te.table"):
        table = MinimizerTable.build_from_genome(genome, k=k, window=window, device=device)
    out: list[TransposonAnnotation] = []
    for te in library:
        with stage("te.extract"):
            codes, lengths, _ = pack_reads([te.codes], pad_multiple=128)
            kcodes, sel, _ = extract_minimizers(
                torch.from_numpy(codes).to(device),
                torch.from_numpy(lengths).to(device),
                k,
                window,
            )
            find_repeats_by_library.extractions += 1
        with stage("te.host"):
            _library_hits(genome, table, te, kcodes[0], sel[0], k, min_hits,
                          merge_distance, out)
    return out


find_repeats_by_library.extractions = 0


def _library_hits(genome, table, te, kcodes, sel, k, min_hits, merge_distance, out):
    qpos = np.nonzero(sel)[0]
    if len(qpos) == 0:
        return
    spos, _ = table.collect_hits(kcodes[qpos].astype(np.int64), qpos.astype(np.int64))
    if len(spos) < min_hits:
        return
    spos = np.sort(spos)
    start = prev = int(spos[0])
    n_hits = 1
    for p in spos[1:]:
        p = int(p)
        if p - prev <= max(merge_distance, len(te)):
            prev = p
            n_hits += 1
            continue
        _emit_te(genome, te, start, prev + k, n_hits, min_hits, out)
        start = prev = p
        n_hits = 1
    _emit_te(genome, te, start, prev + k, n_hits, min_hits, out)


def _emit_te(genome, te, start_concat, end_concat, n_hits, min_hits, out):
    if n_hits < min_hits:
        return
    si, first = genome.split_concat_pos(start_concat)
    sj, last = genome.split_concat_pos(end_concat - 1)
    if si != sj:
        return
    out.append(
        TransposonAnnotation(
            sequence_name=genome.sequence_name(si),
            first=first,
            last=last,
            te_id=te.name,
            score=float(n_hits),
        )
    )


def write_transposons_gff(annotations: list[TransposonAnnotation], path: str) -> None:
    with open(path, "w") as fh:
        fh.write("##gff-version 3\n")
        for i, a in enumerate(annotations):
            fh.write(
                f"{a.sequence_name}\tngsepcore_tpu_torch\ttransposable_element\t{a.first}"
                f"\t{a.last}\t{a.score:.0f}\t.\t.\tID=TE{i + 1};Name={a.te_id}\n"
            )
