"""The port's CLI for the population and read-depth commands against the
JAX package's, in process on the CPU (--device cpu): the same alignment
files go through MultisampleVariantsDetector, ReadDepthComparator,
CoverageStats, BasePairQualStats and SingleSampleVariantsDetector
-cnvs/-svs of both packages and the outputs must be equal as text (the
_SV.gff but for its source column, which names the package)."""
import numpy as np
import pytest
import torch

from ngsepcore_tpu.__main__ import main as jmain
from ngsepcore_tpu.core.genome import ReferenceGenome as JGenome
from ngsepcore_tpu.core.sequences import QualifiedSequence as JQS
from ngsepcore_tpu.core.sequences import QualifiedSequenceList as JQSL
from ngsepcore_tpu.core.sequences import RawRead, reverse_complement
from ngsepcore_tpu.io.fasta import save_fasta
from ngsepcore_tpu.io.fastq import write_fastq
from ngsepcore_tpu.simulation.individual_simulator import SingleIndividualSimulator
from ngsepcore_tpu.simulation.reads_simulator import SingleReadsSimulator
from ngsepcore_tpu_torch.__main__ import main as tmain
from test_torch_multisample import gq_differences

# one torch thread per pytest-xdist worker: one per core oversubscribes the CPU
torch.set_num_threads(1)

L = 30000
DUP = (8000, 12000)  # 0-based, tandem duplication in the CNV sample
DEL = (20000, 23000)  # 0-based, homozygous deletion in the CNV sample
PAIR_DEL = (15000, 17000)  # 0-based, deletion under the paired reads


def _genome_of(name, seq):
    seqs = JQSL()
    seqs.add(JQS.from_string(name, seq))
    return JGenome(seqs)


def _body(path, mark="#"):
    with open(path) as fh:
        return [line for line in fh if not line.startswith(mark)]


def _gff_but_source(path):
    return [l.split("\t")[:1] + l.split("\t")[2:] for l in _body(path)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 30 kb genome; three samples' reads aligned by the JAX CLI into
    s0..s2.sam (read groups s0..s2); cnv.sam from a sample with a 4 kb
    tandem duplication and a 3 kb deletion; pairs.sam from paired reads
    over a 2 kb deletion."""
    d = tmp_path_factory.mktemp("cli_population")
    rng = np.random.default_rng(77)
    ref = "".join(rng.choice(list("ACGT"), size=L))
    genome = _genome_of("chr1", ref)
    g = str(d / "g.fa")
    save_fasta(genome.sequences, g)

    def align(reads, sample, *extra):
        write_fastq(reads, str(d / f"{sample}.fastq"))
        jmain(["ReadsAligner", "-r", g, "-s", sample, "-o", str(d / f"{sample}.sam"),
               str(d / f"{sample}.fastq"), *extra])

    for si in range(3):
        sim = SingleIndividualSimulator(
            genome, snv_rate=0.001, indel_rate=0.0001, het_fraction=0.4, seed=100 + si)
        sim.simulate()
        reads = []
        for h, hg in enumerate(sim.build_haplotype_genomes()):
            reads.extend(SingleReadsSimulator(
                hg, read_length=100, substitution_error_rate=0.002,
                seed=200 + 10 * si + h).simulate(2500))
        align(reads, f"s{si}")
    cnv_seq = ref[: DUP[1]] + ref[DUP[0] : DEL[0]] + ref[DEL[1] :]
    align(SingleReadsSimulator(
        _genome_of("chr1", cnv_seq), read_length=100,
        substitution_error_rate=0.002, seed=7).simulate(6000), "cnv")
    del_seq = ref[: PAIR_DEL[0]] + ref[PAIR_DEL[1] :]
    r1, r2 = [], []
    for i in range(1200):
        s = int(rng.integers(0, len(del_seq) - 400))
        frag = del_seq[s : s + 400]
        r1.append(RawRead(f"p{i}/1", frag[:100], "I" * 100))
        r2.append(RawRead(f"p{i}/2", reverse_complement(frag[-100:]), "I" * 100))
    write_fastq(r1, str(d / "p1.fastq"))
    write_fastq(r2, str(d / "p2.fastq"))
    jmain(["ReadsAligner", "-r", g, "-s", "pairs", "-o", str(d / "pairs.sam"),
           str(d / "p1.fastq"), str(d / "p2.fastq")])
    return d


def test_multisample_detector_cli_equals_jax(files):
    g = str(files / "g.fa")
    sams = [str(files / f"s{i}.sam") for i in range(3)]
    jmain(["MultisampleVariantsDetector", "-r", g, "-o", str(files / "j_pop.vcf"), *sams])
    tmain(["--device", "cpu", "MultisampleVariantsDetector", "-r", g, "-o",
           str(files / "t_pop.vcf"), *sams])
    with open(files / "j_pop.vcf") as fh:
        header = [l for l in fh if l.startswith("#CHROM")][0].split()
    assert header[-3:] == ["s0", "s1", "s2"]
    want = _body(files / "j_pop.vcf")
    assert len(want) > 40
    assert any("TYPE=INDEL" in l for l in want)
    assert _body(files / "t_pop.vcf") == want
    # options reach the engine
    for main, out in ((jmain, "j_pop2.vcf"), (tmain, "t_pop2.vcf")):
        argv = ["MultisampleVariantsDetector", "-r", g, "-o", str(files / out),
                "-minQuality", "80", "-h", "0.01", "-minMQ", "30", *sams[:2]]
        main(argv if main is jmain else ["--device", "cpu"] + argv)
    want2 = _body(files / "j_pop2.vcf")
    assert 0 < len(want2) < len(want)
    assert gq_differences(want2, _body(files / "t_pop2.vcf")) == []


def test_read_depth_comparator_cli_equals_jax(files, capsys):
    g = str(files / "g.fa")
    case, control = str(files / "cnv.sam"), str(files / "s0.sam")
    jmain(["ReadDepthComparator", "-r", g, "-o", str(files / "j_rd.txt"), case, control])
    tmain(["--device", "cpu", "ReadDepthComparator", "-r", g, "-o",
           str(files / "t_rd.txt"), case, control])
    want = _body(files / "j_rd.txt", mark="\0")
    assert want[0] == "CHROM\tFIRST\tLAST\tCOPY_NUMBER\tQUALITY\n"
    assert len(want) >= 3  # the duplication and the deletion
    assert _body(files / "t_rd.txt", mark="\0") == want
    # without -o the table goes to stdout; -b and -x reach the engine
    capsys.readouterr()
    jmain(["ReadDepthComparator", "-r", g, "-b", "200", "-x", "1.7", case, control])
    jout = capsys.readouterr().out
    tmain(["--device", "cpu", "ReadDepthComparator", "-r", g, "-b", "200", "-x", "1.7",
           case, control])
    assert capsys.readouterr().out == jout
    assert jout.startswith("CHROM\t") and jout != "".join(want)


@pytest.mark.parametrize("command", ["CoverageStats", "BasePairQualStats"])
def test_statistics_cli_equals_jax(files, capsys, command):
    g, sam = str(files / "g.fa"), str(files / "s1.sam")
    jmain([command, "-r", g, "-i", sam, "-o", str(files / f"j_{command}.txt")])
    tmain(["--device", "cpu", command, "-r", g, "-i", sam, "-o",
           str(files / f"t_{command}.txt")])
    want = _body(files / f"j_{command}.txt", mark="\0")
    assert len(want) > 10
    assert _body(files / f"t_{command}.txt", mark="\0") == want
    capsys.readouterr()
    tmain(["--device", "cpu", command, "-r", g, sam])  # positional input, stdout
    assert capsys.readouterr().out == "".join(want)


def test_detector_cnvs_cli_equals_jax(files):
    g, sam = str(files / "g.fa"), str(files / "cnv.sam")
    algs = "CNVnator,EWT,PoissonHMM,MAXIMUMLIKELIHOOD"
    jmain(["SingleSampleVariantsDetector", "-r", g, "-i", sam, "-o", str(files / "j_cnv"),
           "-cnvs", "-algCNV", algs])
    tmain(["--device", "cpu", "SingleSampleVariantsDetector", "-r", g, "-i", sam, "-o",
           str(files / "t_cnv"), "-cnvs", "-algCNV", algs])
    want = _body(files / "j_cnv.vcf")
    cnv_lines = [l for l in want if "TYPE=CNV" in l]
    assert any("SVTYPE=DUP" in l for l in cnv_lines)
    assert any("SVTYPE=DEL" in l for l in cnv_lines)
    assert all("END=" in l and "SVLEN=" in l for l in cnv_lines)
    assert _body(files / "t_cnv.vcf") == want
    gff = _gff_but_source(files / "j_cnv_SV.gff")
    assert len(gff) == len(cnv_lines)
    assert _gff_but_source(files / "t_cnv_SV.gff") == gff


def test_detector_svs_cli_equals_jax(files):
    g, sam = str(files / "g.fa"), str(files / "pairs.sam")
    jmain(["SingleSampleVariantsDetector", "-r", g, "-i", sam, "-o", str(files / "j_sv"),
           "-svs"])
    tmain(["--device", "cpu", "SingleSampleVariantsDetector", "-r", g, "-i", sam, "-o",
           str(files / "t_sv"), "-svs"])
    want = _body(files / "j_sv.vcf")
    dels = [l.split("\t") for l in want if "SVTYPE=DEL" in l]
    assert any(abs(int(f[1]) - PAIR_DEL[0]) < 500 for f in dels)
    assert _body(files / "t_sv.vcf") == want
    gff = _gff_but_source(files / "j_sv_SV.gff")
    assert gff
    assert _gff_but_source(files / "t_sv_SV.gff") == gff


@pytest.mark.parametrize(
    "argv,usage",
    [
        (["MultisampleVariantsDetector", "-r", "g.fa"], "Usage: MultisampleVariantsDetector"),
        (["ReadDepthComparator", "-r", "g.fa", "one.sam"], "Usage: ReadDepthComparator"),
        (["CoverageStats", "-r", "g.fa"], "Usage: CoverageStats"),
        (["BasePairQualStats", "-i", "x.sam"], "Usage: BasePairQualStats"),
    ],
)
def test_population_commands_print_usage_like_jax(argv, usage):
    with pytest.raises(SystemExit) as je:
        jmain(argv)
    with pytest.raises(SystemExit) as te:
        tmain(["--device", "cpu"] + argv)
    assert str(te.value.code) == str(je.value.code)
    assert usage in str(te.value.code)


def test_former_ids_reach_the_ported_commands(files, capsys):
    g, sam = str(files / "g.fa"), str(files / "s2.sam")
    capsys.readouterr()
    tmain(["--device", "cpu", "QualStats", "-r", g, "-i", sam])
    former = capsys.readouterr().out
    tmain(["--device", "cpu", "BasePairQualStats", "-r", g, "-i", sam])
    assert capsys.readouterr().out == former != ""
