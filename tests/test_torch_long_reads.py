"""The port's long-read path against the JAX package's, on the CPU.

A 36 kb genome; its reads carry an 80 bp insertion and a 100 bp deletion
(as tests/test_long_reads.py plants them in 120 kb), 1% substitutions and
1% indels.  Three more reads send segments to the 512-wide DP: one with a
random 300 bp head (a start segment), one with a random 300 bp tail (an
end segment) and one with 250 bp of 50% substitutions (a centre segment).
Held equal: the seed table, minimizers, hits, clusters, graph components,
dp_run_segments' stats, LongReadsAligner's SAM lines, the long-read SV
records of the three clustering algorithms, the read simulator, and the
CLI (ReadsAligner -p PACBIO|ONT, SingleSampleVariantsDetector
-runLongReadSVs) as text, on the first 30 reads.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ngsepcore_tpu.__main__ import main as jmain
from ngsepcore_tpu.align.hits_clustering import cluster_hits as jcluster
from ngsepcore_tpu.align.long_reads import LongReadsAligner as JAligner
from ngsepcore_tpu.call.long_read_sv import LongReadStructuralVariantDetector as JSV
from ngsepcore_tpu.core.genome import ReferenceGenome as JGenome
from ngsepcore_tpu.core.sequences import QualifiedSequence as JQS
from ngsepcore_tpu.core.sequences import QualifiedSequenceList as JQSL
from ngsepcore_tpu.core.sequences import RawRead, pack_reads
from ngsepcore_tpu.graphs import components as jgraphs
from ngsepcore_tpu.io.fasta import save_fasta
from ngsepcore_tpu.io.fastq import write_fastq
from ngsepcore_tpu.kernels import minimizers as jmin
from ngsepcore_tpu.kernels import pairwise as jpw
from ngsepcore_tpu.simulation.reads_simulator import SingleReadsSimulator as JSim
from ngsepcore_tpu_torch.__main__ import main as tmain
from ngsepcore_tpu_torch.align.hits_clustering import cluster_hits as tcluster
from ngsepcore_tpu_torch.align.long_reads import LongReadsAligner as TAligner
from ngsepcore_tpu_torch.call.long_read_sv import LongReadStructuralVariantDetector as TSV
from ngsepcore_tpu_torch.core.genome import ReferenceGenome as TGenome
from ngsepcore_tpu_torch.core.sequences import QualifiedSequence as TQS
from ngsepcore_tpu_torch.core.sequences import QualifiedSequenceList as TQSL
from ngsepcore_tpu_torch.graphs import components as tgraphs
from ngsepcore_tpu_torch.kernels import minimizers as tmin
from ngsepcore_tpu_torch.kernels import pairwise as tpw
from ngsepcore_tpu_torch.simulation.reads_simulator import SingleReadsSimulator as TSim

# one torch thread per pytest-xdist worker: one per core oversubscribes the CPU
torch.set_num_threads(1)

L = 36_000
INS_AT, INS_LEN = 9_000, 80  # 0-based insertion point in the reads' genome
DEL_AT, DEL_LEN = 27_000, 100  # 0-based first deleted base
T = torch.from_numpy


def _genomes(seq):
    out = []
    for qsl, qs, genome in ((JQSL, JQS, JGenome), (TQSL, TQS, TGenome)):
        seqs = qsl()
        seqs.add(qs.from_string("chr1", seq))
        out.append(genome(seqs))
    return out


def _special_reads(rng, reads):
    """Reads whose segments take the 512-wide DP."""
    rnd = lambda n: "".join(rng.choice(list("ACGT"), size=n))
    out = []
    for t, r in enumerate(reads):
        sq = r.sequence
        if t == 0:
            sq = rnd(300) + sq
        elif t == 1:
            sq = sq + rnd(300)
        else:
            mid = np.array(list(sq[2000:2250]))
            flip = rng.random(250) < 0.5
            mid[flip] = rng.choice(list("ACGT"), size=int(flip.sum()))
            sq = sq[:2000] + "".join(mid) + sq[2250:]
        out.append(RawRead(name=f"{r.name}_x{t}", sequence=sq, qualities="5" * len(sq)))
    return out


@pytest.fixture(scope="module")
def lr(tmp_path_factory):
    rng = np.random.default_rng(4)
    ref = "".join(rng.choice(list("ACGT"), size=L))
    mut = (ref[:INS_AT] + "".join(rng.choice(list("ACGT"), size=INS_LEN))
           + ref[INS_AT:DEL_AT] + ref[DEL_AT + DEL_LEN :])
    jg, tg = _genomes(ref)
    mg, _ = _genomes(mut)
    plain = JSim(mg, read_length=6000, substitution_error_rate=0.01,
                 indel_error_rate=0.01, seed=11).simulate(60)
    reads = plain + _special_reads(rng, plain[:3])
    ja = JAligner(jg)
    jout = ja.align_batch(reads)
    ta = TAligner(tg, device="cpu")
    tout = ta.align_batch(reads)
    d = tmp_path_factory.mktemp("long_reads")
    save_fasta(jg.sequences, str(d / "g.fa"))
    write_fastq(plain[:30], str(d / "r.fastq"))  # 5x: both events still called
    return dict(jg=jg, tg=tg, reads=reads, ja=ja, ta=ta, jout=jout, tout=tout, d=d)


def _sam(groups):
    return ["\t".join(a.to_sam_fields()) for g in groups for a in g]


def test_seed_table_equal_jax(lr):
    for key in ("unique_codes", "row_offsets", "entry_pos", "entry_strand"):
        np.testing.assert_array_equal(
            getattr(lr["ta"].table, key), getattr(lr["ja"].table, key), err_msg=key)


def test_minimizers_equal_jax(lr):
    """extract_minimizers_compact and extract_minimizers on reads with N."""
    codes = [r.codes[:2500].copy() for r in lr["reads"][:4]]
    codes[1][100:140] = 4
    codes[2][7] = 4
    codes[3] = codes[3][:1800]
    mat, lengths, _ = pack_reads(codes, pad_multiple=1024)
    j = jmin.extract_minimizers_compact(mat, lengths, 25, 20)
    t = tmin.extract_minimizers_compact(T(mat), T(lengths), 25, 20)
    for a, b, name in zip(t, j, ("row", "pos", "kcodes")):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert len(j[0]) > 300
    jd = jmin.extract_minimizers(jnp.asarray(mat), jnp.asarray(lengths), 25, 20)
    td = tmin.extract_minimizers(T(mat), T(lengths), 25, 20)
    for a, b, name in zip(td, jd, ("kcodes", "sel", "valid")):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_collect_hits_equal_jax(lr):
    """collect_hits_batch (and collect_hits) over both tables' CSR arrays."""
    codes = [r.codes for r in lr["reads"][:6]]
    mat, lengths, _ = pack_reads(codes, pad_multiple=1024)
    row, pos, kc = jmin.extract_minimizers_compact(mat, lengths, 25, 20)
    j = lr["ja"].table.collect_hits_batch(kc, pos.astype(np.int64), row.astype(np.int64))
    t = lr["ta"].table.collect_hits_batch(kc, pos.astype(np.int64), row.astype(np.int64))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    assert len(j[0]) > 1000
    one = row == 2
    for a, b in zip(lr["ta"].table.collect_hits(kc[one], pos[one]),
                    lr["ja"].table.collect_hits(kc[one], pos[one])):
        np.testing.assert_array_equal(a, b)


def test_cluster_hits_with_members_equal_jax():
    rng = np.random.default_rng(5)
    for trial in range(6):
        n = int(rng.integers(1, 400))
        diag = rng.choice([1000, 1013, 5000, 20000], size=n)
        qpos = rng.integers(0, 6000, n).astype(np.int64)
        spos = (qpos + diag + rng.integers(-8, 9, n)).astype(np.int64)
        j = jcluster(spos, qpos, 6000, with_members=True)
        t = tcluster(spos, qpos, 6000, with_members=True)
        assert len(t) == len(j) > 0
        for a, b in zip(t, j):
            for key, v in vars(b).items():
                np.testing.assert_array_equal(getattr(a, key), v, err_msg=f"{trial} {key}")


def test_graph_components_equal_jax():
    rng = np.random.default_rng(6)
    for n in (1, 7, 30, 60):
        adj = [list(np.nonzero(rng.random(n) < 3.0 / n)[0]) for _ in range(n)]
        assert (tgraphs.strongly_connected_components(adj)
                == jgraphs.strongly_connected_components(adj))
        m = rng.random((n, n)) < 0.3
        m = m | m.T
        assert tgraphs.maximal_cliques(m) == jgraphs.maximal_cliques(m)


def _segment_jobs(rng, concat, n, Lq, Ls):
    """Read rows cut from the genome with 2% substitutions (and, for the
    last, every seventh base dropped: more runs than the walk budget), and
    a segment job on each, aligned at its start: ragged lengths, the full
    widths on the last row."""
    G = len(concat)
    rows = []
    jobs = []
    for t in range(n):
        s0 = int(rng.integers(0, G - Ls - 10))
        seg = concat[s0 : s0 + Ls + 10].copy()
        if t == n - 1:
            seg = seg[np.arange(len(seg)) % 7 != 6]
        sub = rng.random(len(seg)) < 0.02
        seg[sub] = (seg[sub] + 1) % 4
        rows.append(np.concatenate([rng.integers(0, 4, 40).astype(np.int8), seg]))
        full = t == n - 1
        jobs.append((t, 40, Lq if full else int(rng.integers(Lq // 2, Lq + 1)), s0,
                     Ls if full else int(rng.integers(Ls // 2, Ls + 1))))
    mat, _, _ = pack_reads(rows, pad_multiple=1024)
    return mat, np.array(jobs, np.int32)


@pytest.mark.parametrize("fs2,fe2,width", [
    (False, False, 128), (True, False, 128), (False, True, 128), (True, False, 512),
])
def test_dp_run_segments_equal_jax(lr, fs2, fe2, width):
    """The port's chunks of 5 rows (the last one shorter) against JAX's one
    512-row chunk, the aligner's own shape."""
    rng = np.random.default_rng([width, fs2, fe2])
    concat = lr["jg"].concat
    n = 12
    mat, jobs = _segment_jobs(rng, concat, n, width, width)
    pad = np.zeros((512, 5), np.int32)
    pad[:n] = jobs
    j = jpw.dp_run_segments(
        jnp.asarray(mat), lr["jg"].device_concat(), *pad.T,
        CH=512, Lq=width, Ls=width, n_chunks=1, fs2=fs2, fe2=fe2)
    t = tpw.dp_run_segments(T(mat), T(concat), *T(jobs).T, CH=5, Lq=width, Ls=width,
                            fs2=fs2, fe2=fe2)
    for key, v in t.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(j[key])[0, :n], err_msg=key)
    assert not t["walk_ok"][-1] and t["walk_ok"][:-1].all()


def test_align_batch_sam_lines_equal_jax(lr):
    jsam, tsam = _sam(lr["jout"]), _sam(lr["tout"])
    assert len(jsam) == len(lr["reads"])
    assert tsam == jsam
    assert lr["ta"].aligned_reads == lr["ja"].aligned_reads == len(lr["reads"])
    # every free-end configuration at both widths took part
    assert len(lr["ja"].dp_groups) == 6


def _sv_fields(variants):
    return [(v.sequence_name, v.first, v.last, v.length(), tuple(v.alleles),
             v.variant_type, v.var_id, v.quality, v.genotype_quality,
             tuple(v.indexes_called_alleles), v.total_read_depth) for v in variants]


@pytest.mark.parametrize("algorithm", ["MCC", "SCC", "DBSCAN"])
def test_long_read_sv_records_equal_jax(lr, algorithm):
    j = JSV(lr["jg"], algorithm=algorithm).find_variants([a for g in lr["jout"] for a in g])
    t = TSV(lr["tg"], algorithm=algorithm).find_variants([a for g in lr["tout"] for a in g])
    assert _sv_fields(t) == _sv_fields(j)
    dels = [v for v in t if v.variant_type == "DEL"]
    assert any(abs(v.first - (DEL_AT + 1)) < 150 for v in dels)
    if algorithm == "MCC":
        inss = [v for v in t if v.variant_type == "INS"]
        assert any(abs(v.first - INS_AT) < 150 and 50 <= v.length() <= 110 for v in inss)


def test_reads_simulator_equal_jax():
    """The simulator at the full-size long-read run's parameters."""
    rng = np.random.default_rng(8)
    jg, tg = _genomes("".join(rng.choice(list("ACGT"), size=30_000)))
    kw = dict(read_length=10_000, substitution_error_rate=0.01,
              indel_error_rate=0.01, seed=77)
    j = JSim(jg, **kw).simulate(20)
    t = TSim(tg, **kw).simulate(20)
    assert [(r.name, r.sequence, r.qualities) for r in t] == [
        (r.name, r.sequence, r.qualities) for r in j]


def _body(path, mark="#"):
    with open(path) as fh:
        return [line for line in fh if not line.startswith(mark)]


@pytest.mark.parametrize("platform", ["PACBIO", "ONT"])
def test_cli_long_reads_equal_jax(lr, platform):
    """ReadsAligner -p PACBIO|ONT, then SingleSampleVariantsDetector
    -runLongReadSVs: SAM, VCF and _SVsLongReads.vcf bodies equal; the GFF
    of the SVs equal but for its source column, which names the package."""
    d = lr["d"]
    g, r = str(d / "g.fa"), str(d / "r.fastq")
    for name, run, pre in (("j", jmain, []), ("t", tmain, ["--device", "cpu"])):
        sam = str(d / f"{name}_{platform}.sam")
        run(pre + ["ReadsAligner", "-r", g, "-o", sam, "-p", platform, r])
        run(pre + ["SingleSampleVariantsDetector", "-r", g, "-i", sam, "-o",
                   str(d / f"{name}_{platform}"), "-runLongReadSVs"])
    out = lambda name, ext: d / f"{name}_{platform}{ext}"
    assert len(_body(out("j", ".sam"), "@")) == 30
    assert _body(out("t", ".sam"), "@") == _body(out("j", ".sam"), "@")
    assert _body(out("t", ".vcf")) == _body(out("j", ".vcf"))
    svs = _body(out("j", "_SVsLongReads.vcf"))
    assert len(svs) >= 2
    assert _body(out("t", "_SVsLongReads.vcf")) == svs
    gff = lambda name: [l.split("\t")[:1] + l.split("\t")[2:]
                        for l in _body(out(name, "_SV.gff"))]
    assert gff("t") == gff("j")
