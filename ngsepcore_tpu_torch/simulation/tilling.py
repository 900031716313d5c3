"""TILLING pool simulation and individual genotyping.

Ref: src/ngsep/simulation/TillingPopulationSimulator.java (command
`TillingPopulationSimulator`: simulate mutations across a TILLING
population arranged in pools) and
src/ngsep/discovery/TillingPoolsIndividualGenotyper.java (command
`TillingPoolsIndividualGenotyper`: assign variants detected in pooled
sequencing back to individuals via pool-intersection).

In a TILLING design every individual belongs to a known set of pools
(e.g. row+column+plate); a mutation observed in exactly the pools of one
individual is assigned to that individual.  A copy of
ngsepcore_tpu/simulation/tilling.py (host numpy, the same Generator draws
in the same order, so a seed simulates the same pools).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.genome import ReferenceGenome
from ..variants.model import CalledGenomicVariant, TYPE_BIALLELIC_SNV
from ..vcf.io import VCFRecord


@dataclass
class TillingDesign:
    """individual -> set of pool ids."""

    pools_per_individual: dict[str, frozenset]

    def individuals_for_pools(self, pools: frozenset) -> list[str]:
        return [
            ind
            for ind, p in self.pools_per_individual.items()
            if p == pools
        ]


class TillingPopulationSimulator:
    def __init__(self, genome: ReferenceGenome, n_individuals: int = 96, seed: int = 1):
        self.genome = genome
        self.n_individuals = n_individuals
        self.rng = np.random.default_rng(seed)
        self.design: TillingDesign | None = None
        self.mutations: list[tuple[str, int, str, str, str]] = []  # ind, pos...

    def build_design(self, n_rows: int = 8, n_cols: int = 12) -> TillingDesign:
        pools = {}
        for i in range(self.n_individuals):
            r, c = divmod(i, n_cols)
            pools[f"ind{i}"] = frozenset({f"R{r}", f"C{c}"})
        self.design = TillingDesign(pools)
        return self.design

    def simulate_mutations(self, mutations_per_individual: float = 2.0) -> None:
        g = self.genome
        L = g.sequence_length(0)
        seq_name = g.sequence_name(0)
        self.mutations = []
        for ind in self.design.pools_per_individual:
            n = self.rng.poisson(mutations_per_individual)
            for p in self.rng.integers(1, L, size=n):
                ref = g.reference_string(0, int(p), int(p))
                if ref not in "ACGT":
                    continue
                alt = "ACGT"[(("ACGT".index(ref)) + int(self.rng.integers(1, 4))) % 4]
                self.mutations.append((ind, seq_name, int(p), ref, alt))

    def pool_variant_records(self) -> dict[str, list[VCFRecord]]:
        """Per-pool VCFs of the mutations carried by the pool's members."""
        per_pool: dict[str, list[VCFRecord]] = {}
        for ind, seq, pos, ref, alt in self.mutations:
            for pool in self.design.pools_per_individual[ind]:
                call = CalledGenomicVariant(
                    sequence_name=seq, first=pos, alleles=[ref, alt],
                    variant_type=TYPE_BIALLELIC_SNV, quality=100,
                    sample_id=pool, indexes_called_alleles=[0, 1],
                    genotype_quality=80,
                )
                per_pool.setdefault(pool, []).append(
                    VCFRecord(variant=call, calls=[call])
                )
        for recs in per_pool.values():
            recs.sort(key=lambda r: r.variant.first)
        return per_pool


class TillingPoolsIndividualGenotyper:
    def __init__(self, design: TillingDesign):
        self.design = design

    def genotype(
        self, pool_records: dict[str, list[VCFRecord]]
    ) -> list[tuple[str, VCFRecord]]:
        """Assign each variant to the individual whose pool set equals the
        set of pools where the variant was observed."""
        by_site: dict[tuple, set[str]] = {}
        site_rec: dict[tuple, VCFRecord] = {}
        for pool, recs in pool_records.items():
            for r in recs:
                key = (r.variant.sequence_name, r.variant.first, tuple(r.variant.alleles))
                by_site.setdefault(key, set()).add(pool)
                site_rec[key] = r
        out = []
        for key, pools in by_site.items():
            inds = self.design.individuals_for_pools(frozenset(pools))
            if len(inds) == 1:
                out.append((inds[0], site_rec[key]))
        out.sort(key=lambda t: (t[1].variant.sequence_name, t[1].variant.first))
        return out


def load_pool_configuration(path: str) -> dict[str, list[str]]:
    """individual -> pool-id list from a semicolon-separated descriptor
    (ref: TillingPoolsIndividualGenotyper.loadPools:146-163; optional
    'Individual...' header line)."""
    out: dict[str, list[str]] = {}
    with open(path) as fh:
        lines = fh.read().splitlines()
    if lines and lines[0].startswith("Individual"):
        lines = lines[1:]
    for line in lines:
        if not line.strip():
            continue
        parts = line.split(";")
        out[parts[0]] = list(parts[1:])
    return out


class TillingIndividualVCF2PoolVCF:
    """Convert a per-individual VCF into the pooled-sample VCF a TILLING
    sequencing run would produce.

    Ref: src/ngsep/simulation/TillingIndividualVCF2PoolVCF.java:35-111 —
    pool ploidy = 2 x (members); per biallelic variant each non-homoref
    individual adds 1 (het) or 2 (hom alt) alternative allele copies to
    every pool it belongs to; pools with no copies emit homozygous-
    reference calls; all pool calls carry GQ 100 and ACN = (ploidy-count,
    count)."""

    def __init__(self, pools_data: dict[str, list[str]]):
        self.pools_data = pools_data
        # TreeMap semantics: pools sorted by id; ploidy 2 per member
        ploidy: dict[str, int] = {}
        for ind in pools_data:
            for pid in pools_data[ind]:
                ploidy[pid] = ploidy.get(pid, 0) + 2
        self.pool_ids = sorted(ploidy)
        self.pool_ploidy = ploidy

    def convert(self, records: list[VCFRecord]) -> list[VCFRecord]:
        from ..variants.model import CalledGenomicVariant

        out: list[VCFRecord] = []
        for rec in records:
            if len(rec.variant.alleles) != 2:
                continue
            pool_alt: dict[str, int] = {}
            for call in rec.calls:
                if call.is_undecided or call.is_homozygous_reference:
                    continue
                alt = 1 if call.is_heterozygous else 2
                for pid in self.pools_data.get(call.sample_id or "", ()):
                    pool_alt[pid] = pool_alt.get(pid, 0) + alt
            pool_calls = []
            for pid in self.pool_ids:
                ploidy = self.pool_ploidy[pid]
                count = pool_alt.get(pid)
                if count is None:
                    idxs = [0]
                    acn = [ploidy, 0]
                else:
                    idxs = [0, 1]
                    acn = [ploidy - count, count]
                pool_calls.append(
                    CalledGenomicVariant(
                        sequence_name=rec.variant.sequence_name,
                        first=rec.variant.first,
                        alleles=list(rec.variant.alleles),
                        variant_type=rec.variant.variant_type,
                        quality=rec.variant.quality,
                        sample_id=pid,
                        indexes_called_alleles=idxs,
                        genotype_quality=100,
                        copy_number=ploidy,
                        allele_copy_numbers=acn,
                    )
                )
            out.append(
                VCFRecord(
                    variant=rec.variant,
                    calls=pool_calls,
                    format_str="GT:GQ:ACN",
                )
            )
        return out
