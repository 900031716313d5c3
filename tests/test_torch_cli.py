"""ngsepcore_tpu_torch's CLI (python -m ngsepcore_tpu_torch) against the
JAX package's: ReadsAligner must write the same SAM records and
SingleSampleVariantsDetector the same VCF records on the same files
(CPU, --device cpu).  Also: the SAM and BAM round trips give the
in-memory flow's records, the entry point imports no jax, and a CUDA
run without a card fails instead of falling back."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ngsepcore_tpu.__main__ import main as jmain
from ngsepcore_tpu.io.fasta import save_fasta
from ngsepcore_tpu.io.fastq import write_fastq
from ngsepcore_tpu_torch.__main__ import main as tmain
from test_fused_pipeline import _simulate

# one torch thread per pytest-xdist worker: one per core oversubscribes the CPU
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _body(path, mark):
    with open(path) as fh:
        return [line for line in fh if not line.startswith(mark)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    genome, reads = _simulate(True)
    save_fasta(genome.sequences, str(d / "g.fa"))
    write_fastq(reads, str(d / "r.fastq"))
    g, r = str(d / "g.fa"), str(d / "r.fastq")
    jmain(["ReadsAligner", "-r", g, "-o", str(d / "j.sam"), r])
    jmain(["SingleSampleVariantsDetector", "-r", g, "-i", str(d / "j.sam"),
           "-o", str(d / "j")])
    for ext in ("sam", "bam"):
        tmain(["--device", "cpu", "ReadsAligner", "-r", g, "-o",
               str(d / f"t.{ext}"), r])
        tmain(["--device", "cpu", "SingleSampleVariantsDetector", "-r", g,
               "-i", str(d / f"t.{ext}"), "-o", str(d / f"t_{ext}")])
    return d


def test_cli_sam_and_vcf_bodies_equal_jax(files):
    jsam = _body(files / "j.sam", "@")
    assert len(jsam) > 4000
    assert _body(files / "t.sam", "@") == jsam
    jvcf = _body(files / "j.vcf", "#")
    assert len(jvcf) > 10
    assert _body(files / "t_sam.vcf", "#") == jvcf


def test_sam_and_bam_round_trips_equal_in_memory_flow(files):
    """FASTQ -> SAM/BAM -> run() gives the records of align_batch ->
    find_variants in memory."""
    from ngsepcore_tpu_torch.align.reads_aligner import ReadsAligner
    from ngsepcore_tpu_torch.call.single_sample import SingleSampleVariantsDetector
    from ngsepcore_tpu_torch.core.genome import ReferenceGenome
    from ngsepcore_tpu_torch.io.fastq import FastqFileReader
    from ngsepcore_tpu_torch.vcf.io import VCFFileWriter

    genome = ReferenceGenome.load(str(files / "g.fa"))
    aligner = ReadsAligner(genome, device="cpu")
    alns = []
    for batch in FastqFileReader(str(files / "r.fastq")).iter_batches(4096):
        for per_read in aligner.align_batch(batch):
            alns.extend(per_read)
    det = SingleSampleVariantsDetector(genome, device="cpu")
    with VCFFileWriter(str(files / "mem.vcf"), [det.sample_id]) as w:
        for rec in det.find_variants(alns):
            w.write(rec)
    mem = _body(files / "mem.vcf", "#")
    assert len(mem) > 10
    assert _body(files / "t_sam.vcf", "#") == mem
    assert _body(files / "t_bam.vcf", "#") == mem


def test_genome_indexer_writes_the_jax_index(files):
    g = str(files / "g.fa")
    jmain(["GenomeIndexer", "-o", str(files / "j"), g])
    tmain(["--device", "cpu", "GenomeIndexer", "-o", str(files / "t"), g])
    with np.load(files / "j_minimizers.npz") as j, \
            np.load(files / "t_minimizers.npz") as t:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_help_runs_without_jax(tmp_path):
    """The entry point must not import jax (the GPU machine has none): a
    jax that raises on import is first on the path."""
    fake = tmp_path / "jax"
    fake.mkdir()
    (fake / "__init__.py").write_text(
        "raise ImportError('ngsepcore_tpu_torch imported jax')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), ROOT])
    out = subprocess.run(
        [sys.executable, "-m", "ngsepcore_tpu_torch", "--help"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "ReadsAligner" in out.stdout
    assert "SingleSampleVariantsDetector" in out.stdout


def test_device_cuda_without_card_exits_nonzero(files):
    out = subprocess.run(
        [sys.executable, "-m", "ngsepcore_tpu_torch", "--device", "cuda",
         "ReadsAligner", "-r", str(files / "g.fa"), "-o",
         str(files / "cuda.sam"), str(files / "r.fastq")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert "no usable CUDA device" in out.stderr
    assert not os.path.exists(files / "cuda.sam")


@pytest.mark.parametrize(
    "argv,item",
    [
        (["DeNovoGBS"], "Queue 1 item 17"),
        (["VCFAnnotate", "-i", "x.vcf"], "Queue 1 item 17"),
        (["TranscriptomeAnalyzer"], "Queue 1 item 17"),
    ],
)
def test_unported_commands_name_their_roadmap_item(argv, item):
    """The ids that were pending last (ROADMAP.md item 17) are ported: they
    reach their runner, whose usage message answers missing arguments,
    and no message names the ROADMAP item any more."""
    with pytest.raises(SystemExit) as e:
        tmain(["--device", "cpu"] + argv)
    assert str(e.value.code).startswith(f"Usage: {argv[0]}")
    assert item not in str(e.value.code)


def test_every_command_id_is_ported():
    """All 46 ids of the JAX package's registry are registered in the port
    with a runner, with the same group, former id and hidden flag."""
    import ngsepcore_tpu.cli.commands  # noqa: F401
    import ngsepcore_tpu_torch.cli.commands  # noqa: F401
    from ngsepcore_tpu.cli.registry import all_commands as jax_commands
    from ngsepcore_tpu_torch.cli.registry import all_commands, get_command

    want = {c.id: (c.group, c.former_id, c.hidden) for c in jax_commands()}
    got = {c.id: (c.group, c.former_id, c.hidden) for c in all_commands()}
    assert len(got) == 46 and got == want
    assert all(callable(c.runner) for c in all_commands())
    assert get_command("Annotate").id == "VCFAnnotate"


def test_unported_detector_options_name_their_roadmap_item(files):
    """Every detector option is ported now: -runLongReadSVs runs and writes
    its own VCF (records: tests/test_torch_long_reads.py)."""
    from ngsepcore_tpu_torch.call.single_sample import SingleSampleVariantsDetector
    from ngsepcore_tpu_torch.core.genome import ReferenceGenome

    genome = ReferenceGenome.load(str(files / "g.fa"))
    det = SingleSampleVariantsDetector(
        genome, device="cpu", run_long_read_svs=True, find_cnvs=True, find_svs=True)
    assert det.run_long_read_svs and det.find_cnvs and det.find_svs
    det = SingleSampleVariantsDetector(genome, device="cpu", run_long_read_svs=True)
    det.run(str(files / "t.sam"), str(files / "lr.vcf"))
    assert _body(files / "lr.vcf", "#") == _body(files / "t_sam.vcf", "#")
    with open(files / "lr_SVsLongReads.vcf") as fh:
        assert fh.readline().startswith("##fileformat=VCF")


# ---- the CLI of items 17c-17e ----------------------------------------------

def _gff_rows(path):
    """GFF lines without the source column (each package names itself)."""
    with open(path) as fh:
        return [l.split("\t")[:1] + l.split("\t")[2:] for l in fh]


@pytest.fixture(scope="module")
def long_tail_dir(tmp_path_factory):
    """chip_smoke.py phase 20's and phase 22's inputs
    (write_long_tail_inputs, write_transcriptome_gbs_inputs)."""
    from chip_smoke import write_long_tail_inputs, write_transcriptome_gbs_inputs

    d = tmp_path_factory.mktemp("long_tail")
    write_long_tail_inputs(str(d))
    write_transcriptome_gbs_inputs(str(d))
    return d


LONG_TAIL_LABELS = [
    "TillingIndividualVCF2PoolVCF", "TillingPopulationSimulator",
    "TillingPoolsIndividualGenotyper", "VCFGoldStandardComparator", "Demultiplex",
    "GenomesAligner", "CDNACatalogAligner", "CDNACatalogAligner cdna",
    "TransposonsFinder", "TransposonsFinder -d",
    # items 17f and 17g (phase 22's commands)
    "VCFAnnotate", "TranscriptomeAnalyzer", "TranscriptomeFilter", "MutatedPeptidesExtractor",
    "DeNovoGBS", "VCFRelativeCoordinatesTranslator", "UneakToVCFConverter",
]


def _jax_orthogroups_of_text(paths, out):
    """The JAX package's calculate_orthogroups on catalogs read as text,
    written as CDNACatalogAligner writes them (its runner reads a catalog
    through the DNA encoder, which turns amino acids into N)."""
    from ngsepcore_tpu.genome.homologs import calculate_orthogroups
    from ngsepcore_tpu_torch.io.fasta import read_fasta_text

    named = [(f"c{ci}:{n}", s) for ci, p in enumerate(paths) for n, s in read_fasta_text(p)]
    groups = calculate_orthogroups([s for _, s in named])
    with open(out + "_orthogroups.txt", "w") as fh:
        for i, g in enumerate(groups):
            fh.write(f"OG{i + 1}\t" + "\t".join(named[x][0] for x in g) + "\n")


@pytest.mark.parametrize("label", LONG_TAIL_LABELS)
def test_long_tail_cli_outputs_equal_jax(long_tail_dir, label, capsys):
    """Each new id through both packages' main() on phase 20's inputs: the
    same files with the same content (GFF but for its source column).  The
    JAX package's VCFGoldStandardComparator passes -o on to the comparator,
    which takes no such argument, so it runs without -o there and its
    standard output is the port's -o file.  On protein catalogs the port's
    CDNACatalogAligner is held against the JAX package's orthogroups of the
    catalogs read as text (_jax_orthogroups_of_text); on cDNA catalogs
    against the JAX CLI.  The seven commands of items 17f and 17g run on
    phase 22's inputs; what they print is one of their outputs."""
    from chip_smoke import long_tail_jobs, transcriptome_gbs_jobs

    jobs = {**long_tail_jobs(str(long_tail_dir)), **transcriptome_gbs_jobs(str(long_tail_dir))}
    args = jobs[label]
    cid = label.split()[0]
    got = {}
    for tag, main, pre in (("j", jmain, []), ("t", tmain, ["--device", "cpu"])):
        out = long_tail_dir / f"{label.replace(' ', '_')}_{tag}"
        out.mkdir()
        argv = [a.replace("{o}", str(out / "out")) for a in args]
        if tag == "j" and cid == "VCFGoldStandardComparator":
            argv = argv[: argv.index("-o")]
        capsys.readouterr()
        if tag == "j" and label == "CDNACatalogAligner":
            _jax_orthogroups_of_text(argv[2:], argv[1])
        else:
            assert main(pre + [cid] + argv) == 0
        printed = capsys.readouterr().out
        got[tag] = {p.name: (_gff_rows(p) if p.suffix == ".gff" else p.read_text())
                    for p in sorted(out.iterdir())}
        if tag == "j" and cid == "VCFGoldStandardComparator":
            got[tag]["out.txt"] = printed
        if label in transcriptome_gbs_jobs(str(long_tail_dir)):
            got[tag]["standard output"] = printed
    assert got["t"] == got["j"]
    files = got["t"]
    if files.pop("standard output", None) is not None and cid == "TranscriptomeAnalyzer":
        assert printed.startswith("Genes\t11\nTranscripts\t12\nCoding transcripts\t11\n")
        return
    assert files and all(files.values())
    if cid == "Demultiplex":
        assert sorted(files) == ["out_3x.fastq", "out_s1.fastq", "out_s2.fastq", "out_s4.fastq"]
    elif cid == "GenomesAligner":
        assert sorted(files) == ["out_linearOrthologView.html", "out_orthogroups.txt",
                                 "out_synteny.txt"]
        groups = [l.split("\t")[1:] for l in files["out_orthogroups.txt"].splitlines()]
        assert sum(len(g) == 3 for g in groups) >= 8 and "\t+\n" in files["out_synteny.txt"]
    elif cid == "TillingPopulationSimulator":
        assert len(files) > 5 and "out_design.txt" in files
    elif cid == "TransposonsFinder":
        assert len(files["out.gff"]) > 5
    elif cid == "DeNovoGBS":
        assert files["out.vcf"].count("\nCluster_") >= 20
    elif cid == "VCFRelativeCoordinatesTranslator":
        assert sorted(files) == ["out.info", "out.vcf"] and files["out.vcf"].count("\nchrG\t") > 20
    elif cid == "VCFAnnotate":
        assert all(f"TA={t}" in files["out.vcf"] for t in (
            "missense_variant", "synonymous_variant", "splice_donor_variant",
            "splice_acceptor_variant", "non_coding_transcript_exon_variant",
            "5_prime_UTR_variant", "frameshift_variant", "intergenic_variant"))
    elif label == "CDNACatalogAligner":
        groups = [l.split("\t")[1:] for l in files["out_orthogroups.txt"].splitlines()]
        triples = sum(len(g) == 3 and len({m.split(":")[1] for m in g}) == 1 for g in groups)
        assert triples >= 20 and max(map(len, groups)) <= 12


def test_cdna_catalog_aligner_keeps_amino_acids(long_tail_dir):
    """Known difference (ROADMAP.md Queue 3): the JAX package's
    CDNACatalogAligner reads protein catalogs through the DNA encoder, so
    every amino acid but A, C, G and T becomes N and unrelated proteins
    merge; the port reads them as text."""
    paths = [str(long_tail_dir / f"cat{c}.fa") for c in range(3)]
    out = {}
    for tag, main, pre in (("j", jmain, []), ("t", tmain, ["--device", "cpu"])):
        prefix = str(long_tail_dir / f"amino_{tag}")
        assert main(pre + ["CDNACatalogAligner", "-o", prefix] + paths) == 0
        with open(prefix + "_orthogroups.txt") as fh:
            out[tag] = [len(line.split("\t")) - 1 for line in fh]
    assert max(out["j"]) > 100 and max(out["t"]) <= 12 and len(out["t"]) > len(out["j"])


def test_gold_standard_comparator_output_file_equals_stdout(long_tail_dir, capsys):
    """The port's VCFGoldStandardComparator writes -o's file (the JAX
    package's runner raises a TypeError there) with what it prints
    without -o."""
    gold, test = str(long_tail_dir / "gold.vcf"), str(long_tail_dir / "test.vcf")
    capsys.readouterr()
    assert tmain(["--device", "cpu", "VCFGoldStandardComparator", gold, test]) == 0
    printed = capsys.readouterr().out
    out = long_tail_dir / "gold_report.txt"
    assert tmain(["--device", "cpu", "VCFGoldStandardComparator", gold, test,
                  "-o", str(out)]) == 0
    assert out.read_text() == printed and printed.startswith("MinGQ")
    with pytest.raises(TypeError):
        jmain(["VCFGoldStandardComparator", gold, test, "-o", str(out)])
