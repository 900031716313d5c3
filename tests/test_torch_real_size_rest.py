"""Assembly, repeat annotation with orthogroups, the k-mer commands and the
rice-sized run at the sizes users run, against the JAX package.

chip_smoke.py's phase 17 (Assembler() defaults on 30x of 10 kb reads from
the first 100 kb of bench.py's 12 Mbp genome), phase 21 (TransposonsFinder
by library and de novo on that genome with its 30 family segments as the
library; orthogroups of three catalogs of 2,000 proteins), phase 11
(KmersExtractor -k 15 on phase 5's 345,000 reads and on its genome,
ReadsFileErrorsCorrector on the first 20,000 reads, each through the
package's CLI) and phase 24 (phase 5's reads against a 373.2 Mbp,
12-sequence reference: the seed table takes the sorted-key layout by size;
AlignCallPipeline.run_reads at batch 65,536) go through each package on the
CPU: the port's plain kernels against JAX under JAX_PLATFORMS=cpu.  Each
side runs in its own process, one after the other (this file run as a
script: `python tests/test_torch_real_size_rest.py jax|torch <workload>
<out dir>`).  A side builds the inputs with its own classes and writes every
output a user reads with its own code; the test holds the inputs equal,
then each output line for line, and the JAX package's digests to
chip_smoke's PHASE17_CONTIGS, PHASE21_*, PHASE11_* and PHASE24_RECORDS,
which the card's phases are held to.  These cases are marked slow:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_real_size_rest.py -m slow -q -s

The orthogroups' JAX side is the JAX package's calculate_orthogroups on the
catalogs' text, written in its CLI runner's line format: that runner reads
a catalog through the DNA encoder, which turns amino acids into N (a known
difference; the port's runner reads text).  The unmarked tests hold the
helpers at small sizes.
"""
import hashlib
import json
import os
import resource
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (ROOT, os.path.dirname(os.path.abspath(__file__))):
    if path not in sys.path:
        sys.path.insert(0, path)

import chip_smoke  # noqa: E402
from test_torch_bench_workload import _sha  # noqa: E402
from test_torch_paths_workload import _block_digests, _cli, _first_difference  # noqa: E402
from test_torch_paths_workload import package as _paths_package  # noqa: E402
from test_torch_real_size_more import run_known_strs  # noqa: E402

SIDE_TIMEOUT_S = 3600
ASM = chip_smoke.ASM_ROWS["lin100"]  # phase 17's row
KMER_K = 15
CORRECTED_READS = 20_000  # phase 11's


def package(side: str):
    """test_torch_paths_workload.package(side) with the assembler, the
    repeat finders, the orthogroups and each package's CLI entry; its
    classes carry its reverse complement."""
    pkg = _paths_package(side)
    if side == "jax":
        from ngsepcore_tpu.__main__ import main
        from ngsepcore_tpu.assembly.assembler import Assembler
        from ngsepcore_tpu.core.sequences import reverse_complement_codes
        from ngsepcore_tpu.genome import transposons
        from ngsepcore_tpu.genome.homologs import calculate_orthogroups
    else:
        from ngsepcore_tpu_torch.__main__ import main
        from ngsepcore_tpu_torch.assembly.assembler import Assembler
        from ngsepcore_tpu_torch.core.sequences import reverse_complement_codes
        from ngsepcore_tpu_torch.genome import transposons
        from ngsepcore_tpu_torch.genome.homologs import calculate_orthogroups
    classes = types.SimpleNamespace(
        **{**vars(pkg.classes), "reverse_complement_codes": reverse_complement_codes})
    return types.SimpleNamespace(
        **{**vars(pkg), "classes": classes}, Assembler=Assembler, main=main,
        find_repeats_by_library=transposons.find_repeats_by_library,
        find_repeats_denovo=transposons.find_repeats_denovo,
        write_transposons_gff=transposons.write_transposons_gff,
        calculate_orthogroups=calculate_orthogroups,
    )


def _file_sha(path) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


# ---------------------------------------------------------------------------
# the runs: each package's own code makes each output's lines


def asm_reads(pkg, L=ASM["L"], cov=ASM["cov"], rl=ASM["rl"]):
    """Phase 17's reads from the first L bp of bench.py's genome."""
    return chip_smoke._sim_asm_reads(chip_smoke._bench_genome_codes(), L, cov, rl,
                                     classes=pkg.classes)


def run_assembly(pkg, reads, d) -> dict:
    """Assembler() defaults on the reads; the contigs as save_fasta
    writes them."""
    t0 = time.perf_counter()
    contigs = pkg.Assembler(**pkg.dev).assemble(reads)
    walls = {"assemble_s": time.perf_counter() - t0}
    path = os.path.join(d, "contigs.fa")
    pkg.save_fasta(contigs, path)
    return {"lines": {"contigs": chip_smoke.file_lines(path)}, "walls": walls,
            "digests": {"contigs": chip_smoke.fasta_digest(path)},
            "lengths": [len(c.codes) for c in contigs]}


def repeat_inputs(pkg, bp=12_000_000, n_families=30, n_tandem=400):
    """Phase 21's genome (build_repeat_genome(rng 2024), bench.py's at 12
    Mbp) and its family segments as the library, in `pkg`'s classes."""
    codes, _, _, families = chip_smoke.build_repeat_genome(
        np.random.default_rng(2024), bp, n_families, n_tandem)
    k = pkg.classes
    seqs = k.QualifiedSequenceList()
    seqs.add(k.QualifiedSequence(name="chr1", codes=codes))
    library = [k.QualifiedSequence(name=f"family{i}", codes=f[2]) for i, f in enumerate(families)]
    return k.ReferenceGenome(seqs), library, codes


def run_transposons(pkg, genome, library, d) -> dict:
    """TransposonsFinder's two modes; each GFF body without its source
    column."""
    lines, digests, walls = {}, {}, {}
    for mode in ("library", "denovo"):
        t0 = time.perf_counter()
        anns = (pkg.find_repeats_by_library(genome, library, **pkg.dev) if mode == "library"
                else pkg.find_repeats_denovo(genome, **pkg.dev))
        walls[f"{mode}_s"] = time.perf_counter() - t0
        path = os.path.join(d, f"{mode}.gff")
        pkg.write_transposons_gff(anns, path)
        lines[f"gff_{mode}"] = chip_smoke.gff_body(path)
        digests[f"gff_{mode}"] = chip_smoke.lines_digest(lines[f"gff_{mode}"])
    return {"lines": lines, "digests": digests, "walls": walls}


def read_catalog_text(path) -> list:
    """(name, sequence) of each record of a FASTA file, letters as written."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith(">"):
                out.append([line[1:].split()[0], []])
            elif line:
                out[-1][1].append(line)
    return [(name, "".join(chunks)) for name, chunks in out]


def write_orthogroups(groups, names, path) -> None:
    """The JAX CLI runner's line format (ngsepcore_tpu/cli/commands.py,
    _run_cdna_catalog_aligner): OG<i> and the members' names, tab-separated."""
    with open(path, "w") as fh:
        for i, g in enumerate(groups):
            fh.write(f"OG{i + 1}\t" + "\t".join(names[x] for x in g) + "\n")


def run_orthogroups(pkg, paths, d) -> dict:
    """The port: its CLI's CDNACatalogAligner.  JAX: calculate_orthogroups
    on the catalogs' text in its runner's line format."""
    out = os.path.join(d, "catalogs")
    t0 = time.perf_counter()
    if pkg.side == "jax":
        names, seqs = [], []
        for ci, p in enumerate(paths):
            for name, seq in read_catalog_text(p):
                names.append(f"c{ci}:{name}")
                seqs.append(seq)
        write_orthogroups(pkg.calculate_orthogroups(seqs), names, out + "_orthogroups.txt")
    else:
        pkg.main(["--device", "cpu", "CDNACatalogAligner", "-o", out] + list(paths))
    walls = {"orthogroups_s": time.perf_counter() - t0}
    lines = chip_smoke.file_lines(out + "_orthogroups.txt")
    return {"lines": {"orthogroups": lines}, "walls": walls,
            "digests": {"orthogroups": chip_smoke.lines_digest(lines)},
            "largest": max(len(l.split("\t")) - 1 for l in lines)}


def write_kmer_inputs(pkg, genome, reads, d, n_corrected=CORRECTED_READS) -> dict:
    """Phase 11's files, written by `pkg`'s writers: the genome's FASTA, the
    reads' FASTQ and the FASTQ of the first n_corrected reads."""
    paths = {"fasta": os.path.join(d, "genome.fa"), "fastq": os.path.join(d, "reads.fastq"),
             "first": os.path.join(d, "first.fastq")}
    pkg.save_fasta(genome.sequences, paths["fasta"])
    pkg.write_fastq(reads, paths["fastq"])
    pkg.write_fastq(reads[:n_corrected], paths["first"])
    return paths


def kmer_jobs(paths, d) -> dict:
    """Phase 11's three commands, by output name."""
    return {
        "reads_kmers": ["KmersExtractor", "-k", str(KMER_K), "-o", os.path.join(d, "kr"),
                        paths["fastq"]],
        "genome_kmers": ["KmersExtractor", "-k", str(KMER_K), "-o", os.path.join(d, "kg"),
                         paths["fasta"]],
        "corrected": ["ReadsFileErrorsCorrector", paths["first"], os.path.join(d, "corr.fastq")],
    }


def kmer_outputs(d) -> dict:
    """The digests of phase 11's outputs in `d` and their text lines (the
    distributions and the corrected FASTQ)."""
    lines = {"reads_kmers": chip_smoke.file_lines(os.path.join(d, "kr_kmers_distribution.txt")),
             "genome_kmers": chip_smoke.file_lines(os.path.join(d, "kg_kmers_distribution.txt")),
             "corrected": chip_smoke.file_lines(os.path.join(d, "corr.fastq"))}
    digests = {"reads_kmers": chip_smoke.kmers_digest(os.path.join(d, "kr")),
               "genome_kmers": chip_smoke.kmers_digest(os.path.join(d, "kg")),
               "corrected": chip_smoke.lines_digest(lines["corrected"])}
    return {"lines": lines, "digests": digests}


def _kmer_arrays(d, prefix) -> dict:
    with np.load(os.path.join(d, prefix + "_kmers.npz")) as z:
        return {key: z[key] for key in ("k", "codes", "counts")}


def genome_digests(genome) -> dict:
    return {"names": [s.name for s in genome.sequences],
            "codes": [_sha(np.asarray(s.codes)) for s in genome.sequences]}


# ---------------------------------------------------------------------------
# tier 1: the input helpers, the GFF body, the orthogroup line format and the
# k-mer files, both packages at small size


@pytest.mark.parametrize("seed", [31, 5])
def test_sim_asm_reads_equal_jax_30kb(seed):
    codes = np.random.default_rng(2024).integers(0, 4, size=30_000).astype(np.int8)
    j, t = (chip_smoke._sim_asm_reads(codes, 30_000, 10, 3000, seed=seed,
                                      classes=package(side).classes)
            for side in ("jax", "torch"))
    assert len(j) == len(t) == 100
    assert all(np.array_equal(a, b) for a, b in zip(j, t))
    assert sum(map(len, j)) > 0.98 * 300_000


def test_rice_sized_genome_equal_jax_3mbp():
    """rice_sized_genome with each package's classes: a 30 kb chr1 and 11
    fillers to 3 Mbp."""
    chr1 = np.random.default_rng(1).integers(0, 4, size=30_000, dtype=np.int8)
    j, t = (chip_smoke.rice_sized_genome(chr1, total_bp=3_000_000,
                                         classes=package(side).classes)
            for side in ("jax", "torch"))
    assert type(j).__module__.startswith("ngsepcore_tpu.")
    assert type(t).__module__.startswith("ngsepcore_tpu_torch.")
    assert genome_digests(t) == genome_digests(j)
    assert j.num_sequences == 12 and j.total_length == 3_000_000
    assert np.array_equal(j.sequences[0].codes, chr1)


@pytest.fixture(scope="module")
def small_repeats(tmp_path_factory):
    """Both packages' GFFs on a 200 kb repeat genome (4 families, 40
    tandem arrays)."""
    import torch

    torch.set_num_threads(1)
    out = {}
    for side in ("jax", "torch"):
        pkg = package(side)
        d = str(tmp_path_factory.mktemp(f"te_{side}"))
        genome, library, _ = repeat_inputs(pkg, 200_000, 4, 40)
        out[side] = dict(run=run_transposons(pkg, genome, library, d), d=d)
    return out


@pytest.mark.parametrize("mode", ["library", "denovo"])
def test_gff_body_equal_jax_200kb(small_repeats, mode):
    j, t = small_repeats["jax"], small_repeats["torch"]
    name = f"gff_{mode}"
    assert t["run"]["lines"][name] == j["run"]["lines"][name]
    assert t["run"]["digests"][name] == j["run"]["digests"][name]
    assert len(j["run"]["lines"][name]) >= 3
    # only the source column differs between the packages' files
    jl, tl = (chip_smoke.file_lines(os.path.join(r["d"], f"{mode}.gff")) for r in (j, t))
    assert {l.split("\t")[1] for l in jl[1:]} == {"ngsepcore_tpu"}
    assert {l.split("\t")[1] for l in tl[1:]} == {"ngsepcore_tpu_torch"}


def _small_catalogs(d, letters):
    rng = np.random.default_rng(7)
    cats = chip_smoke.protein_catalogs(rng, 12, 3, lengths=(60, 90))
    if letters == "dna":
        # DNA letters: the JAX runner's DNA reader keeps them as written
        cats = [[(n, "".join("ACGT"[chip_smoke.AMINO.index(c) % 4] for c in s)) for n, s in cat]
                for cat in cats]
    return chip_smoke.write_catalogs(d, cats)


@pytest.mark.parametrize("letters", ["dna", "protein"])
def test_orthogroup_lines_equal_jax_runner_format(tmp_path, letters):
    """write_orthogroups on the JAX package's calculate_orthogroups of the
    catalogs' text equals the port's CLI file; on a DNA catalog, which the
    JAX runner reads without loss, it also equals the JAX runner's file."""
    paths = _small_catalogs(str(tmp_path), letters)
    for side in ("jax", "torch"):
        (tmp_path / side).mkdir()
    j, t = (run_orthogroups(package(side), paths, str(tmp_path / side))
            for side in ("jax", "torch"))
    assert t["lines"] == j["lines"] and t["digests"] == j["digests"]
    assert len(j["lines"]["orthogroups"]) >= 12
    if letters == "dna":
        runner = str(tmp_path / "runner")
        package("jax").main(["CDNACatalogAligner", "-o", runner] + paths)
        assert chip_smoke.file_lines(runner + "_orthogroups.txt") == j["lines"]["orthogroups"]


@pytest.fixture(scope="module")
def small_kmers(tmp_path_factory):
    """Phase 11's files and commands on a 30 kb genome and 2,000 reads
    (500 corrected), each package's writers and CLI in process."""
    import torch

    torch.set_num_threads(1)
    out = {}
    for side in ("jax", "torch"):
        pkg = package(side)
        d = str(tmp_path_factory.mktemp(f"kmers_{side}"))
        inp = chip_smoke.real_size_inputs(0.03, 2000, pkg.classes)
        paths = write_kmer_inputs(pkg, inp["genome"], inp["reads"], d, n_corrected=500)
        for args in kmer_jobs(paths, d).values():
            pkg.main((["--device", "cpu"] if pkg.dev else []) + args)
        out[side] = dict(d=d, inputs={k: _file_sha(p) for k, p in paths.items()},
                         **kmer_outputs(d))
    return out


def test_kmer_inputs_byte_equal(small_kmers):
    assert small_kmers["torch"]["inputs"] == small_kmers["jax"]["inputs"]


@pytest.mark.parametrize("output", ["reads_kmers", "genome_kmers", "corrected"])
def test_kmer_outputs_byte_equal_jax_30kb(small_kmers, output):
    j, t = small_kmers["jax"], small_kmers["torch"]
    names = {"reads_kmers": ["kr_kmers.npz", "kr_kmers_distribution.txt"],
             "genome_kmers": ["kg_kmers.npz", "kg_kmers_distribution.txt"],
             "corrected": ["corr.fastq"]}[output]
    for name in names:
        if name.endswith(".npz"):
            ja, ta = (_kmer_arrays(r["d"], name[:2]) for r in (j, t))
            assert all(ta[k].dtype == ja[k].dtype and np.array_equal(ta[k], ja[k]) for k in ja)
        else:
            assert _file_sha(os.path.join(t["d"], name)) == _file_sha(os.path.join(j["d"], name))
    assert t["lines"][output] == j["lines"][output]
    assert t["digests"][output] == j["digests"][output]
    if output == "corrected":
        assert j["digests"][output][0] == 4 * 500
    else:
        assert j["digests"][output][0] > 1000


# ---------------------------------------------------------------------------
# the side runner: one package, one workload, in its own process


def run_side(side: str, workload: str, out_dir: str) -> None:
    """Build `workload`'s inputs with `side`'s package, run it on the CPU
    and write each output's lines to out_dir/<output>.txt and a JSON of the
    input digests, output digests, walls and figures to out_dir/out.json."""
    pkg = package(side)
    work = os.path.join(out_dir, "work")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    extra = {}
    if workload == "assembly":
        reads = asm_reads(pkg)
        inputs = {"reads": _sha(*reads), "n": len(reads)}
        t_inputs = time.perf_counter() - t0
        out = run_assembly(pkg, reads, work)
        extra["lengths"] = out.pop("lengths")
    elif workload == "transposons":
        genome, library, codes = repeat_inputs(pkg)
        inputs = {"codes": _sha(codes), "library": _sha(*[s.codes for s in library]),
                  "bench": bool(np.array_equal(codes, chip_smoke._bench_genome_codes()))}
        t_inputs = time.perf_counter() - t0
        out = run_transposons(pkg, genome, library, work)
    elif workload == "orthogroups":
        paths = chip_smoke.write_catalogs(
            work, chip_smoke.protein_catalogs(np.random.default_rng(5), 1600, 100))
        inputs = {os.path.basename(p): _file_sha(p) for p in paths}
        t_inputs = time.perf_counter() - t0
        out = run_orthogroups(pkg, paths, work)
        extra["largest"] = out.pop("largest")
    elif workload == "kmers":
        inp = chip_smoke.real_size_inputs(chip_smoke.GENOME_MBP, chip_smoke.N_READS,
                                          pkg.classes)
        paths = write_kmer_inputs(pkg, inp["genome"], inp["reads"], work)
        inputs = {k: _file_sha(p) for k, p in paths.items()}
        t_inputs = time.perf_counter() - t0
        walls = {name: _cli(pkg, args) for name, args in kmer_jobs(paths, work).items()}
        out = dict(kmer_outputs(work), walls=walls)
    else:
        inp = chip_smoke.real_size_inputs(chip_smoke.GENOME_MBP, chip_smoke.N_READS,
                                          pkg.classes)
        genome = chip_smoke.rice_sized_genome(inp["genome"].sequences[0].codes,
                                              classes=pkg.classes)
        inputs = {"genome": genome_digests(genome), "reads": _block_digests(inp["reads"])}
        t_inputs = time.perf_counter() - t0
        t0 = time.perf_counter()
        table = pkg.MinimizerTable.build_from_genome(genome, **pkg.dev)
        t_index = time.perf_counter() - t0
        extra["codes"] = len(table.unique_codes)
        # phase 24's run: no known STRs
        out = run_known_strs(pkg, genome, inp["reads"], {}, table)
        out["walls"]["index_s"] = t_index
        out.pop("tier2_reads")
    out["walls"]["inputs_s"] = t_inputs
    for name, lines in out.pop("lines").items():
        with open(os.path.join(out_dir, name + ".txt"), "w") as fh:
            fh.write("".join(l + "\n" for l in lines))
    shutil.rmtree(work)
    out.update(extra, side=side, workload=workload, inputs=inputs,
               max_rss_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20)
    with open(os.path.join(out_dir, "out.json"), "w") as fh:
        json.dump(out, fh)


# ---------------------------------------------------------------------------
# slow: both packages at real size


def expected(workload: str) -> dict:
    """chip_smoke's constants, by run_side's output names."""
    return {"assembly": {"contigs": chip_smoke.PHASE17_CONTIGS},
            "transposons": {"gff_library": chip_smoke.PHASE21_GFF_LIBRARY,
                            "gff_denovo": chip_smoke.PHASE21_GFF_DENOVO},
            "orthogroups": {"orthogroups": chip_smoke.PHASE21_ORTHOGROUPS},
            "kmers": {"reads_kmers": chip_smoke.PHASE11_READS_KMERS,
                      "genome_kmers": chip_smoke.PHASE11_GENOME_KMERS,
                      "corrected": chip_smoke.PHASE11_CORRECTED},
            "rice": {"keys": chip_smoke.PHASE24_RECORDS}}[workload]


def _side(side, workload, tmp_path):
    out_dir = tmp_path / f"{side}_{workload}"
    out_dir.mkdir()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, os.path.abspath(__file__), side, workload, str(out_dir)],
                   cwd=ROOT, env=env, check=True, timeout=SIDE_TIMEOUT_S)
    with open(out_dir / "out.json") as fh:
        return json.load(fh), out_dir


@pytest.mark.slow
@pytest.mark.parametrize("workload", ["assembly", "transposons", "orthogroups", "kmers", "rice"])
def test_real_size_outputs_equal_jax(workload, tmp_path):
    (j, jdir), (t, tdir) = (_side(side, workload, tmp_path) for side in ("jax", "torch"))
    for r in (j, t):
        walls = ", ".join(f"{k} {v:.1f}" for k, v in r["walls"].items())
        print(f"[{workload}] {r['side']}: {walls}; max RSS {r['max_rss_gib']:.2f} GiB; "
              f"digests {json.dumps(r['digests'])}")
    assert t["inputs"] == j["inputs"]
    for name in j["digests"]:
        if t["digests"][name] != j["digests"][name]:
            print(f"[{workload}] {name}: first difference (line, JAX, port): "
                  f"{_first_difference(jdir / (name + '.txt'), tdir / (name + '.txt'))}")
    for key in ("lengths", "largest", "codes"):
        if key in j:
            print(f"[{workload}] {key}: JAX {j[key]}, port {t[key]}")
            assert t[key] == j[key]
    assert t["digests"] == j["digests"]
    for name in j["digests"]:
        assert (jdir / f"{name}.txt").read_text() == (tdir / f"{name}.txt").read_text()
    want = expected(workload)
    assert {k: tuple(j["digests"][k]) for k in want} == {k: tuple(v) for k, v in want.items()}


if __name__ == "__main__":
    run_side(*sys.argv[1:4])
