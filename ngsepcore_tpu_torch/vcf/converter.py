"""VCFConverter — export genotypes to population-genetics formats.

Ref: src/ngsep/vcf/VCFConverter.java:57-75 — 19 output formats
(Structure/Fasta/rrBLUP/Matrix/Hapmap/GWASPoly/Spagedi/Plink/Haploview/
Emma/PowerMarker/Eigensoft/Flapjack/Darwin/TreeMix/JoinMap/Phase/
FineStructure/GenePop).  All are projections of the same genotype matrix;
each printer below consumes the biallelic-SNV record list + dosage matrix.
A copy of ngsepcore_tpu/vcf/converter.py (host text).
"""
from __future__ import annotations

import numpy as np

from .analytics import dosage_matrix
from .io import VCFRecord

IUPAC_HET = {
    frozenset("AC"): "M",
    frozenset("AG"): "R",
    frozenset("AT"): "W",
    frozenset("CG"): "S",
    frozenset("CT"): "Y",
    frozenset("GT"): "K",
}


def _biallelic_snvs(records: list[VCFRecord]) -> list[VCFRecord]:
    return [r for r in records if r.variant.is_snv and r.variant.is_biallelic]


def _genotype_chars(r: VCFRecord, dosage: int) -> str:
    ref, alt = r.variant.alleles[0], r.variant.alleles[1]
    if dosage == 0:
        return ref
    if dosage == 2:
        return alt
    if dosage == 1:
        return IUPAC_HET.get(frozenset((ref, alt)), "N")
    return "N"


def convert_matrix(records, out_prefix: str) -> None:
    """Simple genotype matrix (ref: printMatrix)."""
    recs = _biallelic_snvs(records)
    dos, samples = dosage_matrix(recs)
    with open(out_prefix + "_genotypes.txt", "w") as fh:
        fh.write("CHROM\tPOS\t" + "\t".join(samples) + "\n")
        for i, r in enumerate(recs):
            row = ["-" if d < 0 else str(d) for d in dos[i]]
            fh.write(f"{r.variant.sequence_name}\t{r.variant.first}\t" + "\t".join(row) + "\n")


def convert_fasta(records, out_prefix: str) -> None:
    """Concatenated IUPAC consensus per sample (ref: printFasta)."""
    recs = _biallelic_snvs(records)
    dos, samples = dosage_matrix(recs)
    with open(out_prefix + "_aln.fa", "w") as fh:
        for s, name in enumerate(samples):
            seq = "".join(_genotype_chars(recs[i], int(dos[i, s])) for i in range(len(recs)))
            fh.write(f">{name}\n")
            for i in range(0, len(seq), 80):
                fh.write(seq[i : i + 80] + "\n")


def convert_plink(records, out_prefix: str) -> None:
    """PLINK .ped/.map (ref: printPlink)."""
    recs = _biallelic_snvs(records)
    dos, samples = dosage_matrix(recs)
    with open(out_prefix + ".map", "w") as fh:
        for r in recs:
            v = r.variant
            chrom = v.sequence_name.replace("chr", "")
            fh.write(f"{chrom}\t{v.var_id or f'{v.sequence_name}_{v.first}'}\t0\t{v.first}\n")
    with open(out_prefix + ".ped", "w") as fh:
        for s, name in enumerate(samples):
            fields = [name, name, "0", "0", "0", "-9"]
            for i, r in enumerate(recs):
                ref, alt = r.variant.alleles[:2]
                d = int(dos[i, s])
                pair = {0: (ref, ref), 1: (ref, alt), 2: (alt, alt)}.get(d, ("0", "0"))
                fields.extend(pair)
            fh.write("\t".join(fields) + "\n")


def convert_structure(records, out_prefix: str) -> None:
    """STRUCTURE two-row-per-sample format (ref: printStructure)."""
    recs = _biallelic_snvs(records)
    dos, samples = dosage_matrix(recs)
    with open(out_prefix + "_structure.txt", "w") as fh:
        for s, name in enumerate(samples):
            rows = [[], []]
            for i in range(len(recs)):
                d = int(dos[i, s])
                a = {0: (1, 1), 1: (1, 2), 2: (2, 2)}.get(d, (-9, -9))
                rows[0].append(str(a[0]))
                rows[1].append(str(a[1]))
            fh.write(name + " " + " ".join(rows[0]) + "\n")
            fh.write(name + " " + " ".join(rows[1]) + "\n")


def convert_hapmap(records, out_prefix: str) -> None:
    """HapMap format (ref: printHapmap)."""
    recs = _biallelic_snvs(records)
    dos, samples = dosage_matrix(recs)
    with open(out_prefix + "_hmp.txt", "w") as fh:
        header = [
            "rs#", "alleles", "chrom", "pos", "strand", "assembly#", "center",
            "protLSID", "assayLSID", "panelLSID", "QCcode",
        ] + samples
        fh.write("\t".join(header) + "\n")
        for i, r in enumerate(recs):
            v = r.variant
            row = [
                v.var_id or f"{v.sequence_name}_{v.first}",
                f"{v.alleles[0]}/{v.alleles[1]}",
                v.sequence_name,
                str(v.first),
                "+", "NA", "NA", "NA", "NA", "NA", "NA",
            ]
            for s in range(len(samples)):
                d = int(dos[i, s])
                ref, alt = v.alleles[:2]
                g = {0: ref + ref, 1: ref + alt, 2: alt + alt}.get(d, "NN")
                row.append(g)
            fh.write("\t".join(row) + "\n")


def convert_rrblup(records, out_prefix: str) -> None:
    """rrBLUP -1/0/1 coding (ref: printrrBLUP)."""
    recs = _biallelic_snvs(records)
    dos, samples = dosage_matrix(recs)
    with open(out_prefix + "_rrBLUP.in", "w") as fh:
        fh.write("MARKER\tCHR\tPOS\t" + "\t".join(samples) + "\n")
        for i, r in enumerate(recs):
            v = r.variant
            vals = ["NA" if d < 0 else str(int(d) - 1) for d in dos[i]]
            fh.write(
                f"{v.var_id or f'{v.sequence_name}_{v.first}'}\t{v.sequence_name}\t{v.first}\t"
                + "\t".join(vals) + "\n"
            )


def convert_emma(records, out_prefix: str) -> None:
    """EMMA 0/0.5/1 matrix (ref: printEmma)."""
    recs = _biallelic_snvs(records)
    dos, _ = dosage_matrix(recs)
    with open(out_prefix + "_emma.in", "w") as fh:
        for i in range(len(recs)):
            vals = ["NA" if d < 0 else str(d / 2.0) for d in dos[i]]
            fh.write(" ".join(vals) + "\n")


def convert_treemix(records, populations: dict[str, str], out_prefix: str) -> None:
    """TreeMix allele counts per population (ref: printTreeMix)."""
    recs = _biallelic_snvs(records)
    dos, samples = dosage_matrix(recs)
    pops = sorted(set(populations.values()))
    import gzip

    with gzip.open(out_prefix + "_treemix.txt.gz", "wt") as fh:
        fh.write(" ".join(pops) + "\n")
        for i in range(len(recs)):
            cols = []
            for p in pops:
                alt = ref = 0
                for s, name in enumerate(samples):
                    if populations.get(name) != p:
                        continue
                    d = int(dos[i, s])
                    if d >= 0:
                        alt += d
                        ref += 2 - d
                cols.append(f"{ref},{alt}")
            fh.write(" ".join(cols) + "\n")


def convert_eigensoft(records, out_prefix: str) -> None:
    """EIGENSOFT geno/snp/ind files (ref: printEigensoft)."""
    recs = _biallelic_snvs(records)
    dos, samples = dosage_matrix(recs)
    with open(out_prefix + ".eigenstratgeno", "w") as fh:
        for i in range(len(recs)):
            fh.write(
                "".join("9" if d < 0 else str(2 - int(d)) for d in dos[i]) + "\n"
            )
    with open(out_prefix + ".snp", "w") as fh:
        for r in recs:
            v = r.variant
            fh.write(
                f"{v.var_id or f'{v.sequence_name}_{v.first}'}\t{v.sequence_name}\t0.0\t{v.first}\t{v.alleles[0]}\t{v.alleles[1]}\n"
            )
    with open(out_prefix + ".ind", "w") as fh:
        for s in samples:
            fh.write(f"{s}\tU\tControl\n")


def convert_genepop(records, populations: dict[str, str], out_prefix: str) -> None:
    """GenePop format (ref: printGenePop)."""
    recs = _biallelic_snvs(records)
    dos, samples = dosage_matrix(recs)
    pops: dict[str, list[int]] = {}
    for s, name in enumerate(samples):
        pops.setdefault(populations.get(name, "pop1"), []).append(s)
    with open(out_prefix + "_genepop.txt", "w") as fh:
        fh.write("Converted by ngsepcore_tpu\n")
        for r in recs:
            v = r.variant
            fh.write(f"{v.var_id or f'{v.sequence_name}_{v.first}'}\n")
        for pop, members in pops.items():
            fh.write("Pop\n")
            for s in members:
                codes = []
                for i in range(len(recs)):
                    d = int(dos[i, s])
                    g = {0: "0101", 1: "0102", 2: "0202"}.get(d, "0000")
                    codes.append(g)
                fh.write(f"{samples[s]}, " + " ".join(codes) + "\n")


def convert_darwin(records, out_prefix: str) -> None:
    """DARwin .don/.var files (ref: printDarwin)."""
    recs = _biallelic_snvs(records)
    dos, samples = dosage_matrix(recs)
    with open(out_prefix + ".don", "w") as fh:
        fh.write(f"@DARwin 5.0 - DON\n{len(samples)}\t1\nN°\tName\n")
        for s, name in enumerate(samples):
            fh.write(f"{s + 1}\t{name}\n")
    with open(out_prefix + ".var", "w") as fh:
        fh.write(f"@DARwin 5.0 - ALLELIC - 2\n{len(samples)}\t{len(recs)}\n")
        fh.write("N°\t" + "\t".join(
            f"{r.variant.sequence_name}_{r.variant.first}" for r in recs
        ) + "\n")
        for s in range(len(samples)):
            vals = []
            for i in range(len(recs)):
                d = int(dos[i, s])
                vals.append({0: "1/1", 1: "1/2", 2: "2/2"}.get(d, "?/?"))
            fh.write(f"{s + 1}\t" + "\t".join(vals) + "\n")


def convert_flapjack(records, out_prefix: str) -> None:
    """Flapjack map + genotype files (ref: printFlapjack)."""
    recs = _biallelic_snvs(records)
    dos, samples = dosage_matrix(recs)
    with open(out_prefix + ".fjmap", "w") as fh:
        for r in recs:
            v = r.variant
            fh.write(
                f"{v.var_id or f'{v.sequence_name}_{v.first}'}\t{v.sequence_name}\t{v.first}\n"
            )
    with open(out_prefix + ".fjgenotype", "w") as fh:
        fh.write(
            "\t" + "\t".join(
                r.variant.var_id or f"{r.variant.sequence_name}_{r.variant.first}"
                for r in recs
            ) + "\n"
        )
        for s, name in enumerate(samples):
            vals = []
            for i, r in enumerate(recs):
                ref, alt = r.variant.alleles[:2]
                d = int(dos[i, s])
                vals.append({0: ref, 1: ref + "/" + alt, 2: alt}.get(d, "-"))
            fh.write(name + "\t" + "\t".join(vals) + "\n")


def convert_phase(records, out_prefix: str) -> None:
    """PHASE input (ref: printPhase)."""
    recs = _biallelic_snvs(records)
    dos, samples = dosage_matrix(recs)
    with open(out_prefix + "_phase.inp", "w") as fh:
        fh.write(f"{len(samples)}\n{len(recs)}\n")
        fh.write("P " + " ".join(str(r.variant.first) for r in recs) + "\n")
        fh.write("S" * len(recs) + "\n")
        for s, name in enumerate(samples):
            fh.write(f"#{name}\n")
            rows = [[], []]
            for i, r in enumerate(recs):
                ref, alt = r.variant.alleles[:2]
                d = int(dos[i, s])
                a = {0: (ref, ref), 1: (ref, alt), 2: (alt, alt)}.get(d, ("?", "?"))
                rows[0].append(a[0])
                rows[1].append(a[1])
            fh.write(" ".join(rows[0]) + "\n")
            fh.write(" ".join(rows[1]) + "\n")


def convert_gwaspoly(records, out_prefix: str) -> None:
    """GWASPoly CSV: genotype = called alleles repeated by copy number
    (ref: printGWASPoly:814-835)."""
    recs = _biallelic_snvs(records)
    dos, samples = dosage_matrix(recs)
    with open(out_prefix + "_GWASPoly.csv", "w") as fh:
        fh.write("Marker,Chrom,Position," + ",".join(samples) + "\n")
        for i, r in enumerate(recs):
            ref, alt = r.variant.alleles[:2]
            vals = []
            for s in range(len(samples)):
                d = int(dos[i, s])
                vals.append(
                    {0: ref + ref, 1: ref + alt, 2: alt + alt}.get(d, "NA")
                )
            fh.write(
                f"{i + 1},{r.variant.sequence_name},{r.variant.first},"
                + ",".join(vals)
                + "\n"
            )


def convert_spagedi(records, out_prefix: str) -> None:
    """SPAGeDi input (ref: printSpagedi:703-738)."""
    recs = _biallelic_snvs(records)
    dos, samples = dosage_matrix(recs)
    with open(out_prefix + "_spagedi.in", "w") as fh:
        fh.write(f"{len(samples)}\t0\t0\t{len(recs)}\t1\t2\n0\n")
        fh.write("Ind" + "".join(f"\tSNP_{i + 1}" for i in range(len(recs))) + "\n")
        for s, name in enumerate(samples):
            vals = []
            for i in range(len(recs)):
                d = int(dos[i, s])
                vals.append({0: "1,1", 1: "1,2", 2: "2,2"}.get(d, "0,0"))
            fh.write(name + "\t" + "\t".join(vals) + "\n")
        fh.write("END\n")


def convert_powermarker(records, out_prefix: str) -> None:
    """PowerMarker .in + .snp files (ref: printPowerMarker:566-605)."""
    recs = _biallelic_snvs(records)
    dos, samples = dosage_matrix(recs)
    with open(out_prefix + "_powermarker.snp", "w") as snp:
        for i, r in enumerate(recs):
            snp.write(f"{i + 1}\t{r.variant.sequence_name}\t{r.variant.first}\n")
    with open(out_prefix + "_powermarker.in", "w") as fh:
        fh.write(
            "Sample"
            + "".join(f"\t{i + 1}\t{i + 1}" for i in range(len(recs)))
            + "\n"
        )
        for s, name in enumerate(samples):
            vals = []
            for i in range(len(recs)):
                d = int(dos[i, s])
                vals.append({0: "0\t0", 1: "0\t1", 2: "1\t1"}.get(d, "-9\t-9"))
            fh.write(name + "\t" + "\t".join(vals) + "\n")


def convert_haploview(records, out_prefix: str) -> None:
    """Haploview = PLINK-style ped with a .info map without chromosome
    numbers (ref: VCFConverter.java:514 printPlink(...,false))."""
    recs = _biallelic_snvs(records)
    dos, samples = dosage_matrix(recs)
    with open(out_prefix + "_haploview.info", "w") as fh:
        for r in recs:
            v = r.variant
            fh.write(f"{v.sequence_name}_{v.first}\t{v.first}\n")
    with open(out_prefix + "_haploview.ped", "w") as fh:
        for s, name in enumerate(samples):
            fields = [name, name, "0", "0", "0", "0"]
            for i, r in enumerate(recs):
                ref, alt = r.variant.alleles[:2]
                d = int(dos[i, s])
                pair = {0: (ref, ref), 1: (ref, alt), 2: (alt, alt)}.get(
                    d, ("0", "0")
                )
                fields.append(pair[0] + " " + pair[1])
            fh.write("\t".join(fields) + "\n")


def convert_joinmap(
    records, out_prefix: str, parent1: str | None = None, parent2: str | None = None
) -> None:
    """JoinMap CP-population segregation file (ref: printJoinMap:1176-1235).

    Only variants where at least one parent is heterozygous segregate;
    codes lm/ll (P1 het), nn/np (P2 het), hk/hh/kk (both het)."""
    recs = _biallelic_snvs(records)
    dos, samples = dosage_matrix(recs)
    if not samples:
        return
    i1 = samples.index(parent1) if parent1 in samples else 0
    i2 = samples.index(parent2) if parent2 in samples else min(1, len(samples) - 1)
    with open(out_prefix + "_joinmap.txt", "w") as fh:
        others = [s for s in range(len(samples)) if s not in (i1, i2)]
        fh.write(
            "SNPID\tSegregation\tClasification\t"
            + samples[i1]
            + "\t"
            + samples[i2]
            + "".join("\t" + samples[s] for s in others)
            + "\n"
        )
        for i, r in enumerate(recs):
            d1, d2 = int(dos[i, i1]), int(dos[i, i2])
            if d1 < 0 or d2 < 0:
                continue
            if d1 != 1 and d2 != 1:
                continue  # both homozygous: not segregating
            v = r.variant
            # the homozygous parent's allele class maps to ll/nn; offspring
            # homozygous for the OTHER allele are inconsistent -> unknown
            # (ref warns and prints the unknown code)
            if d1 == 1 and d2 != 1:
                seg, cls = "<lmxll>", "(ll,lm)"
                p1s, p2s = "lm", "ll"
                if d2 == 0:
                    mapping = {1: "lm", 0: "ll", 2: "--"}
                else:
                    mapping = {1: "lm", 0: "--", 2: "ll"}
            elif d2 == 1 and d1 != 1:
                seg, cls = "<nnxnp>", "(nn,np)"
                p1s, p2s = "nn", "np"
                if d1 == 0:
                    mapping = {1: "np", 0: "nn", 2: "--"}
                else:
                    mapping = {1: "np", 0: "--", 2: "nn"}
            else:
                seg, cls = "<hkxhk>", "(hh,hk,kk)"
                p1s = p2s = "hk"
                mapping = {1: "hk", 0: "hh", 2: "kk"}
            row = [f"{v.sequence_name}_{v.first}", seg, cls, p1s, p2s]
            for s in others:
                d = int(dos[i, s])
                row.append(mapping.get(d, "--") if d >= 0 else "--")
            fh.write("\t".join(row) + "\n")


def convert_finestructure(
    records, out_prefix: str, sequence_name: str | None = None
) -> None:
    """fineSTRUCTURE/ChromoPainter haplotype input for one chromosome
    (ref: printFineStructure:1033-1088); unphased hets default to 0|1."""
    recs = _biallelic_snvs(records)
    if sequence_name is None and recs:
        sequence_name = recs[0].variant.sequence_name
    recs = [r for r in recs if r.variant.sequence_name == sequence_name]
    if not recs:
        raise ValueError("No biallelic variants found for the given sequence")
    dos, samples = dosage_matrix(recs)
    n = len(samples)
    rows = [[] for _ in range(2 * n)]
    positions = []
    for i, r in enumerate(recs):
        positions.append(str(r.variant.first))
        for s in range(n):
            d = int(dos[i, s])
            a1, a2 = {0: ("0", "0"), 1: ("0", "1"), 2: ("1", "1")}.get(
                d, ("0", "0")
            )
            rows[2 * s].append(a1)
            rows[2 * s + 1].append(a2)
    with open(out_prefix + "_fineStructure.phase", "w") as fh:
        fh.write(f"{2 * n}\n{len(recs)}\n")
        fh.write("P " + " ".join(positions) + "\n")
        for row in rows:
            fh.write("".join(row) + "\n")


CONVERTERS = {
    "Matrix": convert_matrix,
    "Fasta": convert_fasta,
    "Plink": convert_plink,
    "Structure": convert_structure,
    "Hapmap": convert_hapmap,
    "rrBLUP": convert_rrblup,
    "Emma": convert_emma,
    "Eigensoft": convert_eigensoft,
    "Darwin": convert_darwin,
    "Flapjack": convert_flapjack,
    "Phase": convert_phase,
    "GWASPoly": convert_gwaspoly,
    "Spagedi": convert_spagedi,
    "PowerMarker": convert_powermarker,
    "Haploview": convert_haploview,
    "JoinMap": convert_joinmap,
    "FineStructure": convert_finestructure,
}

POPULATION_CONVERTERS = {
    "TreeMix": convert_treemix,
    "GenePop": convert_genepop,
}
