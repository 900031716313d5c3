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
        (["KmersExtractor", "x.fa"], "Queue 1 item 10"),
        (["VCFFilter", "-i", "x.vcf"], "Queue 1 item 17"),
        (["ReadsAligner", "-r", "g.fa", "-p", "ONT", "x.fastq"], "Queue 1 item 12"),
    ],
)
def test_unported_commands_name_their_roadmap_item(argv, item):
    with pytest.raises(SystemExit) as e:
        tmain(["--device", "cpu"] + argv)
    assert item in str(e.value.code)


def test_unported_detector_options_name_their_roadmap_item():
    from ngsepcore_tpu_torch.call.single_sample import SingleSampleVariantsDetector

    for kw, item in (
        ({"find_cnvs": True}, "item 11"),
        ({"find_svs": True}, "item 11"),
        ({"run_long_read_svs": True}, "item 12"),
        ({"known_strs_file": "strs.txt"}, "Tier-2 STR"),
    ):
        with pytest.raises(NotImplementedError, match=item):
            SingleSampleVariantsDetector(None, device="cpu", **kw)
