"""The population run, the long-read run and the classic CLI at the sizes users
run, against the JAX package.

chip_smoke.py's phase 13 (3 individuals x 184,000 reads on phase 5's 4.6 Mbp
genome: ReadsAligner.align_batch in 32,768-read batches, the joint caller at
min_quality 10, the CNV algorithms on ind2), phase 15 (600 reads of 10 kb
against 4 Mbp, LongReadsAligner in 128-read batches, the long-read SV caller)
and phase 8 (the CLI's ReadsAligner and SingleSampleVariantsDetector on phase
5's FASTA and FASTQ) go through each package on the CPU: the port's plain
kernels against JAX under JAX_PLATFORMS=cpu.  Each side runs in its own
process, one after the other (this file run as a script): two torch
processes side by side on one host's cores slow each other many times over.
A side builds the inputs with its own classes and writes every output a user
reads as text lines made by its own code; the test holds the inputs equal,
then each output line for line, and the JAX package's digests to
chip_smoke's PHASE13_*, PHASE15_* and PHASE8_*, which the card's phases are
held to.  These cases are marked slow (about 30 minutes in all on 8 cores):

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_paths_workload.py -m slow -q -s

The unmarked tests hold the input builders and the digests on a 30 kb genome.
"""
import hashlib
import json
import os
import resource
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
from test_torch_bench_workload import _sha, jax_classes  # noqa: E402

SIDE_TIMEOUT_S = 3600
CLI_TIMEOUT_S = 3000


def package(side: str):
    """`side`'s ("jax" or "torch") classes that the runs below call, its
    package name for `python -m`, and the keyword that puts it on the CPU."""
    if side == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from ngsepcore_tpu.align.long_reads import LongReadsAligner
        from ngsepcore_tpu.align.reads_aligner import ReadsAligner
        from ngsepcore_tpu.call.fused_pipeline import AlignCallPipeline
        from ngsepcore_tpu.call.long_read_sv import LongReadStructuralVariantDetector
        from ngsepcore_tpu.call.multisample import MultisampleVariantsDetector
        from ngsepcore_tpu.call.single_sample import SingleSampleVariantsDetector
        from ngsepcore_tpu.index.minimizer_table import MinimizerTable
        from ngsepcore_tpu.io.fasta import save_fasta
        from ngsepcore_tpu.io.fastq import write_fastq
        from ngsepcore_tpu.vcf.io import VCFFileWriter

        classes, name, dev = jax_classes(), "ngsepcore_tpu", {}
    else:
        from ngsepcore_tpu_torch.align.long_reads import LongReadsAligner
        from ngsepcore_tpu_torch.align.reads_aligner import ReadsAligner
        from ngsepcore_tpu_torch.call.fused_pipeline import AlignCallPipeline
        from ngsepcore_tpu_torch.call.long_read_sv import LongReadStructuralVariantDetector
        from ngsepcore_tpu_torch.call.multisample import MultisampleVariantsDetector
        from ngsepcore_tpu_torch.call.single_sample import SingleSampleVariantsDetector
        from ngsepcore_tpu_torch.index.minimizer_table import MinimizerTable
        from ngsepcore_tpu_torch.io.fasta import save_fasta
        from ngsepcore_tpu_torch.io.fastq import write_fastq
        from ngsepcore_tpu_torch.vcf.io import VCFFileWriter

        classes, name, dev = chip_smoke.port_classes(), "ngsepcore_tpu_torch", {"device": "cpu"}
    return types.SimpleNamespace(
        side=side, name=name, dev=dev, classes=classes, ReadsAligner=ReadsAligner,
        LongReadsAligner=LongReadsAligner, AlignCallPipeline=AlignCallPipeline,
        LongReadStructuralVariantDetector=LongReadStructuralVariantDetector,
        MultisampleVariantsDetector=MultisampleVariantsDetector,
        SingleSampleVariantsDetector=SingleSampleVariantsDetector,
        MinimizerTable=MinimizerTable, save_fasta=save_fasta, write_fastq=write_fastq,
        VCFFileWriter=VCFFileWriter,
    )


# ---------------------------------------------------------------------------
# digests of the inputs


def _block_digests(reads) -> dict:
    return {
        "codes": _sha(reads.codes, reads.lengths),
        "quals": None if reads.quals is None else _sha(reads.quals),
        "default_quality": int(reads.default_quality),
        "names": chip_smoke.lines_digest(reads.names),
    }


def population_input_digests(genome, pop) -> dict:
    truths = [sorted((p, tuple(c.alleles), c.genotype_state) for p, c in t.items())
              for t in pop["truths"]]
    return {
        "codes": _sha(genome.sequences[0].codes), "samples": pop["samples"],
        "windows": [list(pop["dup"]), list(pop["dele"])],
        "truths": [chip_smoke.lines_digest(map(repr, t)) for t in truths],
        "reads": [_block_digests(b) for b in pop["blocks"]],
    }


def long_read_input_digests(genome, reads) -> dict:
    return {
        "codes": _sha(genome.sequences[0].codes),
        "reads": chip_smoke.lines_digest(f"{r.name}\t{r.sequence}\t{r.qualities}"
                                         for r in reads),
        "bases": sum(len(r.sequence) for r in reads),
    }


# ---------------------------------------------------------------------------
# the runs: each package's own code makes each output's lines and digest


def run_population(pkg, genome, in_repeat, pop, table, batch=chip_smoke.POP_BATCH) -> dict:
    """Phase 13's steps in its order: align each sample, joint calling at
    min_quality 10 (its realigner edits the alignments), then ind2's CNV
    calls by each of POP_CNV_RUNS from one detector.  Returns lines and
    digests by output, the accuracy figures and the walls."""
    samples = pop["samples"]
    lines, digests, walls = {}, {}, {}
    t0 = time.perf_counter()
    aligner = pkg.ReadsAligner(genome, table=table, **pkg.dev)
    alns = [chip_smoke._align_all(aligner, b, batch) for b in pop["blocks"]]
    walls["align_s"] = time.perf_counter() - t0
    for name, sample_alns in zip(samples, alns):
        lines[f"sam {name}"] = ["\t".join(a.to_sam_fields()) for a in sample_alns]
        digests[f"sam {name}"] = chip_smoke.sam_digest(lines[f"sam {name}"])
    t0 = time.perf_counter()
    records = pkg.MultisampleVariantsDetector(
        genome, min_quality=chip_smoke.POP_MIN_QUALITY, **pkg.dev).find_variants(alns, samples)
    walls["find_variants_s"] = time.perf_counter() - t0
    lines["vcf"] = chip_smoke._vcf_body(records, samples, pkg.VCFFileWriter)
    digests["vcf"] = chip_smoke.vcf_body_digest(lines["vcf"])
    t0 = time.perf_counter()
    det = pkg.SingleSampleVariantsDetector(
        genome, sample_id=samples[2], alg_cnv=chip_smoke.ALL_CNV_ALGORITHMS, **pkg.dev)
    for alg in chip_smoke.POP_CNV_RUNS:
        det.alg_cnv = alg
        calls = det.find_cnv_calls(alns[2])
        lines[f"cnv {alg}"] = [repr(f) for f in chip_smoke._call_fields(calls)]
        digests[f"cnv {alg}"] = chip_smoke.cnv_digest(calls)
    walls["cnv_s"] = time.perf_counter() - t0
    acc = chip_smoke.population_accuracy(records, pop["truths"], in_repeat)
    return {"lines": lines, "digests": digests, "accuracy": acc, "walls": walls}


def run_long_reads(pkg, genome, reads) -> dict:
    """Phase 15's steps: the seed table, LongReadsAligner in LR_BATCH
    batches, the long-read SV caller on every group's alignments."""
    t0 = time.perf_counter()
    table = pkg.MinimizerTable.build_from_genome(genome, **pkg.dev)
    al = pkg.LongReadsAligner(genome, table=table, **pkg.dev)
    B = chip_smoke.LR_BATCH
    groups = [g for i in range(0, len(reads), B) for g in al.align_batch(reads[i : i + B])]
    walls = {"align_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    svs = pkg.LongReadStructuralVariantDetector(genome).find_variants(
        [a for g in groups for a in g])
    walls["svs_s"] = time.perf_counter() - t0
    lines = {"sam": ["\t".join(a.to_sam_fields()) for g in groups for a in g],
             "sv": [repr(f) for f in chip_smoke.sv_fields(svs)]}
    digests = {"sam": chip_smoke.sam_digest(lines["sam"]), "sv": chip_smoke.sv_digest(svs)}
    return {"lines": lines, "digests": digests, "walls": walls,
            "aligned": [al.aligned_reads, al.total_reads]}


def _cli(pkg, args):
    cmd = [sys.executable, "-m", pkg.name] + (["--device", "cpu"] if pkg.dev else []) + args
    t0 = time.perf_counter()
    subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu"),
                   check=True, timeout=CLI_TIMEOUT_S, stdout=subprocess.DEVNULL)
    return time.perf_counter() - t0


def run_classic_cli(pkg, genome, reads, d, fused=False) -> dict:
    """Phase 8's steps: the genome and reads written with `pkg`'s own
    writers, then its CLI's ReadsAligner and SingleSampleVariantsDetector
    as subprocesses.  With `fused`, the fused pipeline's VCF body on the
    same reads too (AlignCallPipeline at batch 65,536, as phase 5 runs it)
    and the lines in which the two bodies differ."""
    g, fq = os.path.join(d, "genome.fa"), os.path.join(d, "reads.fastq")
    sam, vcf = os.path.join(d, "alns.sam"), os.path.join(d, "calls")
    pkg.save_fasta(genome.sequences, g)
    pkg.write_fastq(reads, fq)
    inputs = {}
    for key, path in (("fasta", g), ("fastq", fq)):
        with open(path, "rb") as fh:
            inputs[key] = hashlib.sha256(fh.read()).hexdigest()
    walls = {"ReadsAligner_s": _cli(pkg, ["ReadsAligner", "-r", g, "-o", sam, "-s", "s1", fq])}
    walls["SingleSampleVariantsDetector_s"] = _cli(
        pkg, ["SingleSampleVariantsDetector", "-r", g, "-i", sam, "-o", vcf, "-sampleId", "s1"])
    lines = {"sam": chip_smoke.sam_file_body(sam), "vcf": chip_smoke.vcf_file_body(vcf + ".vcf")}
    out = {"inputs": inputs, "lines": lines, "walls": walls, "digests": {
        "sam": chip_smoke.sam_digest(lines["sam"]), "vcf": chip_smoke.vcf_body_digest(lines["vcf"]),
    }}
    if fused:
        t0 = time.perf_counter()
        table = pkg.MinimizerTable.build_from_genome(genome, **pkg.dev)
        pipe = pkg.AlignCallPipeline(
            genome, aligner=pkg.ReadsAligner(genome, table=table, **pkg.dev),
            detector=pkg.SingleSampleVariantsDetector(genome, sample_id="s1", **pkg.dev),
            batch_size=65536, **pkg.dev)
        records = pipe.run_reads(reads)
        walls["fused_s"] = time.perf_counter() - t0
        body = chip_smoke._vcf_body(records, ["s1"], pkg.VCFFileWriter)
        cli_set, fused_set = set(lines["vcf"]), set(body)
        out["fused"] = {
            "records_digest": list(chip_smoke.records_digest(records)),
            "vcf_body_digest": list(chip_smoke.vcf_body_digest(body)),
            "equal": body == lines["vcf"],
            "cli_only": [l for l in lines["vcf"] if l not in fused_set],
            "fused_only": [l for l in body if l not in cli_set],
        }
    return out


# ---------------------------------------------------------------------------
# tier 1: the builders and the digests on a 30 kb genome

SMALL_MBP = 0.03
SMALL = dict(n_reads=2000, dup_len=2000, del_len=1000)


def _small_population(pkg):
    inp = chip_smoke.real_size_inputs(SMALL_MBP, 2, pkg.classes, with_reads=False)
    return inp, chip_smoke.population_inputs(inp["genome"], inp["in_repeat"], pkg.classes,
                                             **SMALL)


@pytest.fixture(scope="module")
def small():
    """Both packages' population inputs at 30 kb, 3 x 2,000 reads, and
    run_population's outputs on them (1,024-read batches)."""
    import torch

    torch.set_num_threads(1)
    out = {}
    for side in ("jax", "torch"):
        pkg = package(side)
        inp, pop = _small_population(pkg)
        table = pkg.MinimizerTable.build_from_genome(inp["genome"], **pkg.dev)
        out[side] = dict(inp=inp, pop=pop, digests=population_input_digests(inp["genome"], pop),
                         run=run_population(pkg, inp["genome"], inp["in_repeat"], pop, table,
                                            batch=1024))
    return out


@pytest.mark.parametrize("key", ["codes", "samples", "windows", "truths", "reads"])
def test_population_inputs_equal_jax(small, key):
    j, t = small["jax"]["digests"], small["torch"]["digests"]
    assert t[key] == j[key]
    assert min(n for n, _ in j["truths"]) > 10
    assert [r["names"][0] for r in j["reads"]] == [SMALL["n_reads"]] * 3


def test_with_svs_on_every_haplotype_equals_jax():
    """The duplication and the deletion of population_inputs' third
    sample, applied to each haplotype by each package's classes."""
    out = []
    for side in ("jax", "torch"):
        k = package(side).classes
        inp = chip_smoke.real_size_inputs(SMALL_MBP, 2, k, with_reads=False)
        sim = k.SingleIndividualSimulator(inp["genome"], snv_rate=0.001, indel_rate=0.0001,
                                          seed=103)
        sim.simulate()
        haps = sim.build_haplotype_genomes()
        dup, dele = (6000, 8000), (18000, 19000)
        out.append([(np.asarray(h.sequences[0].codes),
                     np.asarray(chip_smoke._with_svs(h, dup, dele, k).sequences[0].codes))
                    for h in haps])
    for (jh, js), (th, ts) in zip(*out):
        assert np.array_equal(th, jh) and np.array_equal(ts, js)
        assert len(js) == len(jh) + 2000 - 1000
        assert np.array_equal(js[8000:10000], jh[6000:8000])


def test_long_read_inputs_equal_jax():
    j, t = (long_read_input_digests(*chip_smoke.long_read_inputs(
        package(side).classes, length=30_000, n_reads=12)) for side in ("jax", "torch"))
    assert t == j and j["reads"][0] == 12 and j["bases"] > 100_000


@pytest.mark.parametrize("output", ["sam ind0", "sam ind1", "sam ind2", "vcf"]
                         + [f"cnv {alg}" for alg in chip_smoke.POP_CNV_RUNS])
def test_population_digests_equal_jax(small, output):
    """sam_digest, vcf_body_digest and cnv_digest of each package's own
    lines agree on the small aligned case, and agree with the lines."""
    j, t = small["jax"]["run"], small["torch"]["run"]
    assert t["lines"][output] == j["lines"][output]
    assert t["digests"][output] == j["digests"][output]
    assert j["digests"][output] == chip_smoke.lines_digest(j["lines"][output])
    if output.startswith("sam"):
        assert len(j["lines"][output]) > 0.95 * SMALL["n_reads"]
    if output == "vcf":
        assert len(j["lines"]["vcf"]) > 10


def test_population_accuracy_equal_jax(small):
    j, t = small["jax"]["run"], small["torch"]["run"]
    assert t["accuracy"] == j["accuracy"]
    assert j["accuracy"]["called"] > 10 and len(j["accuracy"]["concordance"]) == 3


def test_long_read_digests_equal_jax():
    out = []
    for side in ("jax", "torch"):
        pkg = package(side)
        out.append(run_long_reads(pkg, *chip_smoke.long_read_inputs(
            pkg.classes, length=30_000, n_reads=12)))
    j, t = out
    assert t["lines"] == j["lines"] and t["digests"] == j["digests"]
    assert t["aligned"] == j["aligned"] and j["aligned"][0] >= 11


# ---------------------------------------------------------------------------
# the side runner: one package, one workload, in its own process


def run_side(side: str, workload: str, out_dir: str) -> None:
    """Build `workload`'s inputs with `side`'s package, run it on the CPU
    and write each output's lines to out_dir/<output>.txt and a JSON of the
    input digests, output digests, walls and figures to out_dir/out.json."""
    pkg = package(side)
    t0 = time.perf_counter()
    if workload == "population":
        inp = chip_smoke.real_size_inputs(chip_smoke.GENOME_MBP, chip_smoke.N_READS,
                                          pkg.classes, with_reads=False)
        genome = inp["genome"]
        pop = chip_smoke.population_inputs(genome, inp["in_repeat"], pkg.classes)
        inputs = population_input_digests(genome, pop)
        t_inputs = time.perf_counter() - t0
        t0 = time.perf_counter()
        table = pkg.MinimizerTable.build_from_genome(genome, **pkg.dev)
        t_index = time.perf_counter() - t0
        out = run_population(pkg, genome, inp["in_repeat"], pop, table)
        out["walls"]["index_s"] = t_index
    elif workload == "long_reads":
        genome, reads = chip_smoke.long_read_inputs(pkg.classes)
        inputs = long_read_input_digests(genome, reads)
        t_inputs = time.perf_counter() - t0
        out = run_long_reads(pkg, genome, reads)
    else:
        inp = chip_smoke.real_size_inputs(chip_smoke.GENOME_MBP, chip_smoke.N_READS,
                                          pkg.classes)
        t_inputs = time.perf_counter() - t0
        work = os.path.join(out_dir, "work")
        os.makedirs(work, exist_ok=True)
        out = run_classic_cli(pkg, inp["genome"], inp["reads"], work, fused=side == "jax")
        inputs = out.pop("inputs")
        inputs["reads"] = _block_digests(inp["reads"])
    out["walls"]["inputs_s"] = t_inputs
    for name, lines in out.pop("lines").items():
        with open(os.path.join(out_dir, name.replace(" ", "_").replace(",", "+") + ".txt"),
                  "w") as fh:
            fh.write("".join(l + "\n" for l in lines))
    out.update(side=side, workload=workload, inputs=inputs,
               max_rss_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20)
    with open(os.path.join(out_dir, "out.json"), "w") as fh:
        json.dump(out, fh)


# ---------------------------------------------------------------------------
# slow: both packages at real size


def expected(workload: str) -> dict:
    """chip_smoke's constants, by run_side's output names."""
    if workload == "population":
        out = {f"sam ind{i}": d for i, d in enumerate(chip_smoke.PHASE13_SAM)}
        out["vcf"] = chip_smoke.PHASE13_VCF
        out.update({f"cnv {alg}": d for alg, d in chip_smoke.PHASE13_CNVS.items()})
        return out
    if workload == "long_reads":
        return {"sam": chip_smoke.PHASE15_SAM, "sv": chip_smoke.PHASE15_SVS}
    return {"sam": chip_smoke.PHASE8_SAM, "vcf": chip_smoke.PHASE8_VCF}


def _side(side, workload, tmp_path):
    out_dir = tmp_path / f"{side}_{workload}"
    out_dir.mkdir()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, os.path.abspath(__file__), side, workload, str(out_dir)],
                   cwd=ROOT, env=env, check=True, timeout=SIDE_TIMEOUT_S)
    with open(out_dir / "out.json") as fh:
        return json.load(fh), out_dir


def _first_difference(jpath, tpath):
    """(line number, JAX's line, the port's line) of the first lines in which
    two output files differ."""
    with open(jpath) as a, open(tpath) as b:
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return i, x.rstrip("\n"), y.rstrip("\n")
    return None


@pytest.mark.slow
@pytest.mark.parametrize("workload", ["population", "long_reads", "classic_cli"])
def test_real_size_outputs_equal_jax(workload, tmp_path):
    (j, jdir), (t, tdir) = (_side(side, workload, tmp_path) for side in ("jax", "torch"))
    for r in (j, t):
        walls = ", ".join(f"{k} {v:.1f}" for k, v in r["walls"].items())
        print(f"[{workload}] {r['side']}: {walls}; max RSS {r['max_rss_gib']:.2f} GiB; "
              f"digests {json.dumps(r['digests'])}")
    assert t["inputs"] == j["inputs"]
    for name in j["digests"]:
        if t["digests"][name] != j["digests"][name]:
            fname = name.replace(" ", "_").replace(",", "+") + ".txt"
            print(f"[{workload}] {name}: first difference (line, JAX, port): "
                  f"{_first_difference(jdir / fname, tdir / fname)}")
    assert t["digests"] == j["digests"]
    want = expected(workload)
    assert {k: tuple(v) for k, v in j["digests"].items()} == {
        k: tuple(v) for k, v in want.items()}
    if workload == "population":
        print(f"[population] accuracy {json.dumps(j['accuracy'])}")
        assert t["accuracy"] == j["accuracy"] and j["accuracy"]["passed"]
    elif workload == "long_reads":
        print(f"[long_reads] aligned {j['aligned']}")
        assert t["aligned"] == j["aligned"]
    else:
        f = j["fused"]
        print(f"[classic_cli] JAX CLI VCF body equal to the JAX fused one: {f['equal']}; "
              f"fused records {f['records_digest']}; lines only in the CLI's "
              f"{len(f['cli_only'])}, only in the fused {len(f['fused_only'])}")
        for l in f["cli_only"][:10]:
            print(f"  CLI only:   {l}")
        for l in f["fused_only"][:10]:
            print(f"  fused only: {l}")
        assert tuple(f["records_digest"]) == chip_smoke.PHASE5_RECORDS


if __name__ == "__main__":
    run_side(*sys.argv[1:4])
