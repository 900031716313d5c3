"""Pairwise synteny block detection from ortholog pairs.

Ref: src/ngsep/genome/LCSMainPairwiseSyntenyBlocksFinder.java (longest
common subsequence over gene orders), DAGChainerPairwiseSyntenyBlocksFinder
.java:375 (chaining alternative), used by the GenomesAligner command.
A copy of ngsepcore_tpu/genome/synteny.py (host code).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class SyntenyBlock:
    seq1: str
    first1: int
    last1: int
    seq2: str
    first2: int
    last2: int
    n_orthologs: int
    same_strand: bool = True


def find_synteny_blocks(
    gene_positions1: list[tuple[str, int]],
    gene_positions2: list[tuple[str, int]],
    ortholog_pairs: list[tuple[int, int]],
    min_block_genes: int = 3,
    max_gap_genes: int = 10,
) -> list[SyntenyBlock]:
    """Chain ortholog pairs collinear in both genomes into blocks.

    Genes are given as (sequence_name, position); ortholog_pairs are
    (gene1_idx, gene2_idx).  Pairs are grouped per (seq1, seq2), sorted by
    genome-1 order; increasing (or decreasing) runs in genome-2 rank with
    bounded rank gaps become blocks — the LCS/chaining structure of the
    reference collapsed to strand-split longest runs.
    """
    # rank genes along each sequence
    def ranks(gene_positions):
        per_seq: dict[str, list[tuple[int, int]]] = {}
        for gi, (seq, pos) in enumerate(gene_positions):
            per_seq.setdefault(seq, []).append((pos, gi))
        rank = {}
        for seq, lst in per_seq.items():
            for r, (pos, gi) in enumerate(sorted(lst)):
                rank[gi] = r
        return rank

    rank1 = ranks(gene_positions1)
    rank2 = ranks(gene_positions2)
    groups: dict[tuple[str, str], list[tuple[int, int, int, int]]] = {}
    for g1, g2 in ortholog_pairs:
        s1 = gene_positions1[g1][0]
        s2 = gene_positions2[g2][0]
        groups.setdefault((s1, s2), []).append((rank1[g1], rank2[g2], g1, g2))
    blocks: list[SyntenyBlock] = []
    for (s1, s2), pairs in groups.items():
        pairs.sort()
        for direction in (1, -1):
            chain: list[tuple[int, int, int, int]] = []
            prev_r2 = None
            for r1, r2, g1, g2 in pairs:
                ok = prev_r2 is None or (
                    0 < direction * (r2 - prev_r2) <= max_gap_genes
                )
                if ok:
                    chain.append((r1, r2, g1, g2))
                    prev_r2 = r2
                else:
                    blocks.extend(
                        _emit(chain, gene_positions1, gene_positions2, s1, s2,
                              min_block_genes, direction == 1)
                    )
                    chain = [(r1, r2, g1, g2)]
                    prev_r2 = r2
            blocks.extend(
                _emit(chain, gene_positions1, gene_positions2, s1, s2,
                      min_block_genes, direction == 1)
            )
    # deduplicate blocks found in both directions (pure runs of length>=min)
    uniq = {}
    for b in blocks:
        key = (b.seq1, b.first1, b.last1, b.seq2, b.first2, b.last2)
        if key not in uniq or uniq[key].n_orthologs < b.n_orthologs:
            uniq[key] = b
    return sorted(uniq.values(), key=lambda b: (b.seq1, b.first1))


def _emit(chain, gp1, gp2, s1, s2, min_genes, same_strand):
    if len(chain) < min_genes:
        return []
    pos1 = [gp1[g1][1] for _, _, g1, _ in chain]
    pos2 = [gp2[g2][1] for _, _, _, g2 in chain]
    return [
        SyntenyBlock(
            seq1=s1, first1=min(pos1), last1=max(pos1),
            seq2=s2, first2=min(pos2), last2=max(pos2),
            n_orthologs=len(chain), same_strand=same_strand,
        )
    ]
