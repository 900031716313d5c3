"""Read-path phasing for ploidy-aware assembly.

Ref: src/ngsep/assembly/HaplotypeReadsClusterCalculator.java (cluster reads
into haplotype groups from het variants discovered against the draft
backbone; used in the Assembler ploidy phase-filter loop,
Assembler.java:461-484) and ReadPathPhasingData.java.

Het-site discovery reuses the genotyping scatter over the read-vs-draft
pileup on the caller's device; fragment-vs-haplotype agreement scoring is
the dense masked reduction of the SIH RefHap engine (haplotyping/sih.py)
— one (reads, sites) int8 matrix per contig.  Same results as
ngsepcore_tpu/assembly/phasing.py.
"""
from __future__ import annotations

import numpy as np
import torch

from ..call.pileup import expand_batch_calls
from ..core.sequences import QualifiedSequence, QualifiedSequenceList
from ..core.genome import ReferenceGenome
from ..haplotyping.sih import RefhapSIHAlgorithm
from ..kernels.genotyping import scatter_allele_counts


def phase_reads(
    contigs: list[np.ndarray],
    reads: list,
    min_het_depth: int = 8,
    min_allele_fraction: float = 0.25,
    *,
    device,
) -> list[set[int]]:
    """Partition read indices into two haplotype clusters.

    Returns [cluster0, cluster1]; reads with no informative het site are
    placed in BOTH clusters (they belong to both haplotypes).
    reads: list of RawRead whose names are 'r<index>'.  Alignment and the
    count scatter run on `device`.
    """
    from ..align.long_reads import LongReadsAligner

    seqs = QualifiedSequenceList()
    for i, c in enumerate(contigs):
        seqs.add(QualifiedSequence(name=f"c{i}", codes=c))
    genome = ReferenceGenome(seqs)
    aligner = LongReadsAligner(genome, device=device)
    per_contig: dict[str, list] = {}
    B = 256
    for b0 in range(0, len(reads), B):
        for group in aligner.align_batch(reads[b0 : b0 + B]):
            for a in group:
                per_contig.setdefault(a.sequence_name, []).append(a)

    n_reads = len(reads)
    vote = np.zeros((n_reads, 2), np.int64)  # agreement with hap0 / hap1
    for ci, draft in enumerate(contigs):
        alns = per_contig.get(f"c{ci}", [])
        if len(alns) < min_het_depth:
            continue
        pos, allele, qual, strand, _ = expand_batch_calls(alns, collect_indels=False)
        L = len(draft)
        counts, _, _, total = scatter_allele_counts(
            *(torch.from_numpy(np.ascontiguousarray(a)).to(device)
              for a in ((pos - 1).astype(np.int32), allele, qual, strand)),
            out_size=L,
        )
        base_counts = counts.sum(dim=2).cpu().numpy()
        depth = base_counts.sum(axis=1)
        order = np.argsort(base_counts, axis=1)
        a1 = order[:, -1]
        a2 = order[:, -2]
        c1 = base_counts[np.arange(L), a1]
        c2 = base_counts[np.arange(L), a2]
        het = (
            (depth >= min_het_depth)
            & (c2 >= min_allele_fraction * depth)
            & (c1 + c2 >= 0.9 * depth)
        )
        sites = np.nonzero(het)[0]  # 0-based contig positions
        if len(sites) == 0:
            continue
        site_of = {int(p): s for s, p in enumerate(sites)}
        a1s, a2s = a1[sites], a2[sites]
        # fragment matrix: read x site, 0 = major allele, 1 = second, -1 = n/a
        frag = np.full((len(alns), len(sites)), -1, np.int8)
        for r, a in enumerate(alns):
            rp, codes, quals, _ = _expand_one(a)
            for p, code in zip(rp, codes):
                s = site_of.get(int(p) - 1)
                if s is None:
                    continue
                if code == a1s[s]:
                    frag[r, s] = 0
                elif code == a2s[s]:
                    frag[r, s] = 1
        hap, _ = RefhapSIHAlgorithm().phase(frag)
        # assign each alignment's read to the better-agreeing haplotype
        cover = frag >= 0
        agree0 = ((frag == hap[None, :]) & cover).sum(axis=1)
        agree1 = ((frag == (1 - hap)[None, :]) & cover).sum(axis=1)
        for r, a in enumerate(alns):
            ridx = _read_index(a.read_name)
            if ridx is None or ridx >= n_reads:
                continue
            vote[ridx, 0] += int(agree0[r])
            vote[ridx, 1] += int(agree1[r])
    cl0: set[int] = set()
    cl1: set[int] = set()
    for i in range(n_reads):
        if vote[i, 0] > vote[i, 1]:
            cl0.add(i)
        elif vote[i, 1] > vote[i, 0]:
            cl1.add(i)
        else:  # uninformative: both haplotypes
            cl0.add(i)
            cl1.add(i)
    return [cl0, cl1]


def _read_index(name: str) -> int | None:
    if name and name.startswith("r"):
        try:
            return int(name[1:])
        except ValueError:
            return None
    return None


def _expand_one(a):
    from ..call.pileup import expand_alignment_calls

    rp, codes, quals, _ = expand_alignment_calls(a)
    return rp, codes, quals, None
