"""The port's de-novo GBS caller, coordinate translator and UNEAK converter
against the JAX package on the CPU (ROADMAP.md item 17g).

The cases of tests/test_gbs.py, tests/test_gbs_translator.py,
tests/test_uneak.py and test_long_tail.py's translation case run through
both packages: clusters, records, statistics and written files must be
equal, and the port's must also pass those files' own checks.  Beyond
them: a seeded lane harder than test_gbs.py's (6 samples x 200 loci,
qualities 0-40, Ns, reads of unequal length, consensus ties, up to 40
reads a cell, a cluster over the depth limit) whose VCF must equal the
JAX package's byte for byte, and the host decision (decide_cells,
phred_scores) held bit for bit against the JAX package's per-cell
arithmetic on 10^5 cells.  Everything is exact."""
import math

import numpy as np
import pytest
import torch

import ngsepcore_tpu.align.read_alignment as jra
import ngsepcore_tpu.core.genome as jgen
import ngsepcore_tpu.core.sequences as jseq
import ngsepcore_tpu.gbs.denovo as jden
import ngsepcore_tpu.gbs.translator as jtr
import ngsepcore_tpu.gbs.uneak as jun
import ngsepcore_tpu.variants.model as jvar
import ngsepcore_tpu.vcf.io as jvcf
import ngsepcore_tpu_torch.align.read_alignment as tra
import ngsepcore_tpu_torch.core.genome as tgen
import ngsepcore_tpu_torch.core.sequences as tseq
import ngsepcore_tpu_torch.gbs.denovo as tden
import ngsepcore_tpu_torch.gbs.translator as ttr
import ngsepcore_tpu_torch.gbs.uneak as tun
import ngsepcore_tpu_torch.variants.model as tvar
import ngsepcore_tpu_torch.vcf.io as tvcf
from chip_smoke import _random_dna, genotype_haps, write_gbs_fastq
from ngsepcore_tpu.kernels.genotyping import snv_contribution_table
from ngsepcore_tpu.math.phred import phred_score
from test_gbs import _make_gbs_data
from test_uneak import _write_inputs as _uneak_inputs

torch.set_num_threads(1)

PKGS = {"j": (jra, jgen, jseq, jtr, jvar, jvcf), "t": (tra, tgen, tseq, ttr, tvar, tvcf)}


def _state(x):
    if isinstance(x, dict):
        return {k: _state(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_state(v) for v in x]
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.tolist())
    if hasattr(x, "__dict__"):
        return (type(x).__name__, _state(vars(x)))
    return x


def _port_reads(reads_per_sample):
    return [[tseq.RawRead(r.name, r.sequence, r.qualities) for r in rs]
            for rs in reads_per_sample]


# ---- tests/test_gbs.py ------------------------------------------------------

@pytest.fixture(scope="module")
def gbs_data():
    loci, reads = _make_gbs_data()
    jc = jden.KmerPrefixReadsClusteringAlgorithm().cluster_reads(reads)
    tc = tden.KmerPrefixReadsClusteringAlgorithm(device="cpu").cluster_reads(_port_reads(reads))
    return reads, jc, tc


def test_clustering_by_prefix(gbs_data):
    _, jc, tc = gbs_data
    assert len(tc) == 5 and all(c.depth == 36 for c in tc)
    assert _state(tc) == _state(jc)


def test_cluster_variant_calls(gbs_data):
    _, jc, tc = gbs_data
    ja = jden.KmerPrefixReadsClusteringAlgorithm()
    ta = tden.KmerPrefixReadsClusteringAlgorithm(device="cpu")
    jrecs = [r for c in jc for r in ja.call_cluster_variants(c, 3)]
    trecs = [r for c in tc for r in ta.call_cluster_variants(c, 3)]
    assert _state(trecs) == _state(jrecs)
    by_pos = {r.variant.first: r for r in trecs}
    assert sorted(by_pos) == [41, 51]
    assert [c.genotype_state for c in by_pos[41].calls] == [0, 2, 0]
    assert by_pos[51].calls[2].genotype_state == 1


def test_run_writes_vcf(gbs_data, tmp_path):
    reads, _, _ = gbs_data
    paths = []
    for si, rs in enumerate(reads):
        p = str(tmp_path / f"s{si}.fastq")
        jseq_write(rs, p)
        paths.append(p)
    ids = ["s0", "s1", "s2"]
    assert jden.KmerPrefixReadsClusteringAlgorithm().run(paths, ids, str(tmp_path / "j")) == 2
    assert tden.KmerPrefixReadsClusteringAlgorithm(device="cpu").run(
        paths, ids, str(tmp_path / "t")) == 2
    text = (tmp_path / "t.vcf").read_text()
    assert "Cluster_" in text and text == (tmp_path / "j.vcf").read_text()


def jseq_write(reads, path):
    from ngsepcore_tpu.io.fastq import write_fastq

    write_fastq(reads, path)


# ---- a harder lane ----------------------------------------------------------

def hard_lane(d, seed=15, n_samples=6, n_loci=200):
    """FASTQs of `n_samples` diploid samples over `n_loci` loci of 90 bp:
    0-40 reads a (sample, locus) cell, reads of 20-90 bp (some shorter
    than the 31-base prefix), qualities 0-40, 0.5% errors, 0.5% Ns (some
    in the prefix), 0-2 SNVs a locus past the prefix; loci 1-20 carry one
    SNV at column 50 for which three samples are homozygous reference and
    three homozygous alternative at 10 reads each (a tie in the consensus
    counts); locus 0 has 200 reads a sample (over the depth limit of 100 a
    sample)."""
    rng = np.random.default_rng(seed)
    loci = np.stack([tseq.encode_dna(_random_dna(rng, 90)) for _ in range(n_loci)])
    n_snv = rng.integers(0, 3, n_loci)
    n_snv[1:21] = 1
    snv_locus = np.repeat(np.arange(n_loci), n_snv)
    snv_col = rng.integers(31, 90, len(snv_locus))
    tie = (snv_locus >= 1) & (snv_locus <= 20)
    snv_col[tie] = 50
    snv_alt = (loci[snv_locus, snv_col] + rng.integers(1, 4, len(snv_locus))) % 4
    paths = []
    for si in range(n_samples):
        genos = rng.integers(0, 3, len(snv_locus))
        genos[tie] = 0 if si < 3 else 2
        depth = rng.integers(0, 41, size=n_loci)
        depth[0] = 200
        depth[1:21] = 10
        paths.append(str(d / f"lane_s{si}.fastq"))
        write_gbs_fastq(paths[-1], rng, loci, snv_locus, snv_col, snv_alt,
                        genotype_haps(rng, genos), depth, length=(20, 91), error=0.005,
                        quality=(0, 41), n_rate=0.005)
    return paths


@pytest.fixture(scope="module")
def hard_vcfs(tmp_path_factory):
    d = tmp_path_factory.mktemp("gbs_lane")
    paths = hard_lane(d)
    ids = [f"s{i}" for i in range(len(paths))]
    n = {"j": jden.KmerPrefixReadsClusteringAlgorithm().run(paths, ids, str(d / "j")),
         "t": tden.KmerPrefixReadsClusteringAlgorithm(device="cpu").run(paths, ids,
                                                                        str(d / "t"))}
    return d, paths, n


def test_hard_lane_vcf_equals_jax(hard_vcfs):
    d, _, n = hard_vcfs
    assert n["t"] == n["j"] >= 50
    assert (d / "t.vcf").read_bytes() == (d / "j.vcf").read_bytes()


def test_hard_lane_reaches_its_edges(hard_vcfs):
    """The lane reaches what it is built for: a tie in the consensus, a
    dropped deep cluster, unusable and capped qualities, reads shorter
    than the prefix, N in the prefix and in variable columns."""
    _, paths, _ = hard_vcfs
    algo = tden.KmerPrefixReadsClusteringAlgorithm(device="cpu")
    reads = tden.GBSReads.concatenate([tden.read_fastq_sample(p, i) for i, p in enumerate(paths)])
    valid, code = algo.prefix_codes(reads)
    rows, starts = algo._cluster_layout(reads, len(paths))
    assert int((reads.lengths < 31).sum()) > 0
    head = reads.codes[:, :31]
    assert int(((head == 4).any(axis=1) & (reads.lengths >= 31)).sum()) > 0
    q = reads.quals[reads.codes >= 0]
    assert (q <= 3).sum() > 0 and (q > 30).sum() > 0
    kept = set(code[rows].tolist())
    _, counts = np.unique(code[valid].numpy(), return_counts=True)
    assert counts.max() > 600 and len(kept) < len(counts)
    # a consensus tie: equal counts of the two alleles at column 50
    c = reads.codes[rows.numpy()][:, 50]
    ties = 0
    for s, e in zip(starts.tolist(), starts.tolist()[1:] + [len(rows)]):
        k = np.bincount(c[s:e][c[s:e] >= 0], minlength=5)
        ties += int(np.sort(k)[-1] == np.sort(k)[-2] > 0)
    assert ties > 0


def test_irregular_fastq_reads_as_fastq_reader(tmp_path):
    """A FASTQ that the bulk parser does not take (a blank line, a '+name'
    separator, no qualities) reads as FastqFileReader reads it."""
    text = "@a\nACGTACGTAA\n+\nIIIIIIIIII\n\n@b desc\nNNACG\n+b\n!!#$%\n@c\nACG\n+\n\n"
    (tmp_path / "x.fastq").write_text(text)
    got = tden.read_fastq_sample(str(tmp_path / "x.fastq"), 2)
    want = tden.reads_from_samples(
        [[], [], list(tden.FastqFileReader(str(tmp_path / "x.fastq")))])
    assert _state(vars(got)) == _state(vars(want))
    assert got.lengths.tolist() == [10, 5, 3] and got.quals[2, :3].tolist() == [30, 30, 30]


# ---- the host decision ------------------------------------------------------

def _jax_cell(logcond, ref, prior):
    """denovo.py:153-165 for one cell, verbatim."""
    ev = logcond + prior
    rel = ev - ev.max()
    p = np.where(rel < -20, 0.0, 10.0 ** rel)
    post = p / p.sum() if p.sum() > 0 else p
    bi = bj = ref
    best = post[ref][ref]
    for i2 in range(4):
        for j2 in range(i2, 4):
            prob = post[i2][j2] + (post[j2][i2] if i2 != j2 else 0)
            if prob > best + 0.01:
                best, bi, bj = prob, i2, j2
    return bi, bj, phred_score(max(0.0, 1 - best)), best


def _random_cells(rng, n):
    """(n, 16) log-conditionals as reads make them: 1-40 reads (50 cells
    2,000) of a random genotype with 1% errors, qualities 4-30, summed in
    read order; 20 all-zero cells."""
    C = snv_contribution_table(4, 0.5)

    def sums(m, depth):
        gt = rng.integers(0, 4, (m, 2))
        out = np.zeros((m, 4, 4))
        for k in range(int(depth.max())):
            live = depth > k
            a = gt[np.arange(m), rng.integers(0, 2, m)]
            a = np.where(rng.random(m) < 0.01, rng.integers(0, 4, m), a)
            q = rng.integers(4, 31, m)
            out[live] += C[a[live], q[live]]
        return out.reshape(m, 16)

    deep = sums(50, np.full(50, 2000))
    return np.concatenate([deep, sums(n - 70, rng.integers(1, 41, n - 70)), np.zeros((20, 16))])


def test_decide_cells_equals_jax_per_cell_bit_for_bit():
    rng = np.random.default_rng(4)
    n = 100_000
    logcond = _random_cells(rng, n)
    ref = rng.integers(0, 4, n)
    prior = tden.KmerPrefixReadsClusteringAlgorithm(device="cpu")._prior
    bi, bj, gq, best = tden.decide_cells(logcond, ref, prior)
    want = [_jax_cell(logcond[i].reshape(4, 4), int(ref[i]), prior) for i in range(n)]
    assert bi.tolist() == [w[0] for w in want]
    assert bj.tolist() == [w[1] for w in want]
    assert gq.tolist() == [w[2] for w in want]
    assert best.view(np.int64).tolist() == np.array([w[3] for w in want]).view(np.int64).tolist()
    assert len(set(gq.tolist())) > 50  # GQs across the range, not one value


def test_phred_scores_equal_phred_score_at_the_rounding_boundaries():
    """phred_scores (np.log10, math.log10 within PHRED_RECHECK of a
    boundary) against phred_score (math.log10) at probabilities around
    every boundary k + 0.5 and at random ones; and the measured distance
    between the two logs stays far inside PHRED_RECHECK."""
    rng = np.random.default_rng(6)
    k = np.arange(0, 256) + 0.5
    mid = 10.0 ** (-k / 10)
    near = (mid[:, None] * (1 + np.array([-1e-12, -1e-15, 0, 1e-15, 1e-12]))[None, :]).ravel()
    ulps = np.concatenate([np.nextafter(mid, 0), np.nextafter(mid, 1)])
    p = np.concatenate([near, ulps, rng.random(100_000) ** 8, [0.0, 1.0, -0.5, 2.0, 1e-300]])
    assert tden.phred_scores(p).tolist() == [phred_score(float(x)) for x in p]
    inside = p[(p > 0) & (p < 1)]
    dist = np.abs(-10.0 * np.log10(inside) - np.array([-10.0 * math.log10(x) for x in inside]))
    assert dist.max() < tden.PHRED_RECHECK / 1000


# ---- tests/test_gbs_translator.py and test_long_tail.py ---------------------

def _genome(pkg, seq):
    _, gen, sq, *_ = PKGS[pkg]
    seqs = sq.QualifiedSequenceList()
    seqs.add(sq.QualifiedSequence(name="chr1", codes=sq.encode_dna(seq)))
    return gen.ReferenceGenome(seqs)


def _aln(pkg, first, cigar, read, reverse=False, name=None):
    ra = PKGS[pkg][0]
    a = ra.ReadAlignment(sequence_name="chr1", first=first, cigar=cigar, read_chars=read,
                         read_name=name)
    if reverse:
        a.flags |= ra.FLAG_READ_REVERSE
    return a


def _snv_record(pkg, cluster, pos, alleles, called, acgt=None, acn=None, vtype="SNV"):
    var, vcf = PKGS[pkg][4], PKGS[pkg][5]
    call = var.CalledGenomicVariant(
        sequence_name=cluster, first=pos, alleles=list(alleles), variant_type=vtype,
        sample_id="s1", indexes_called_alleles=called, genotype_quality=60,
        total_read_depth=10, acgt_depths=acgt or [], allele_copy_numbers=acn or [1, 1],
        copy_number=2)
    v = var.CalledGenomicVariant(sequence_name=cluster, first=pos, alleles=list(alleles),
                                 variant_type=vtype, quality=90)
    return vcf.VCFRecord(variant=v, calls=[call])


def _translate(case):
    """(records, stats) of both packages on one of the translator cases."""
    out = {}
    for pkg in PKGS:
        tr = PKGS[pkg][3]
        if case == "forward":
            args = ([_snv_record(pkg, "c0", 3, "GT", [0, 1])],
                    {"c0": _aln(pkg, 11, [(5, "M")], "AAGCC")}, _genome(pkg, "A" * 12 + "G" + "C" * 10))
        elif case == "swap":
            args = ([_snv_record(pkg, "c0", 3, "GT", [0], acn=[2, 0])],
                    {"c0": _aln(pkg, 11, [(5, "M")], "AAGCC")}, _genome(pkg, "A" * 12 + "T" + "C" * 10))
        elif case == "reverse":
            args = ([_snv_record(pkg, "c0", 3, "GA", [0, 1], acgt=[4, 0, 6, 0])],
                    {"c0": _aln(pkg, 11, [(5, "M")], "GGGGG", reverse=True)},
                    _genome(pkg, "A" * 12 + "C" * 10))
        elif case == "triallelic":
            args = ([_snv_record(pkg, "c0", 3, "ATC", [1, 2], acn=[0, 1, 1], vtype="MULTISNV")],
                    {"c0": _aln(pkg, 11, [(5, "M")], "AAGCC")}, _genome(pkg, "A" * 12 + "G" + "C" * 10))
        elif case == "unmapped":
            args = ([_snv_record(pkg, "c9", 3, "GT", [0, 1])], {}, _genome(pkg, "A" * 30))
        else:  # test_long_tail: no genome, 80M at 5000
            args = ([_snv_record(pkg, "Cluster_1", 10, "AG", [0, 1])],
                    {"Cluster_1": PKGS[pkg][0].ReadAlignment(
                        "chr2", 5000, [(80, "M")], read_chars="A" * 80, read_name="Cluster_1")},
                    None)
        recs, stats = tr.translate_records(args[0], args[1], genome=args[2])
        out[pkg] = (recs, stats)
    assert _state(out["t"][0]) == _state(out["j"][0])
    assert _state(out["t"][1]) == _state(out["j"][1])
    assert out["t"][1].report() == out["j"][1].report()
    return out["t"]


def test_reference_position_forward_and_reverse():
    for pkg in PKGS:
        rp = PKGS[pkg][3].reference_position
        a = _aln(pkg, 11, [(3, "M"), (2, "D"), (4, "M")], "AAACCCC")
        assert [rp(a, p) for p in (0, 2, 3, 6, 7)] == [11, 13, 16, 19, -1]
        r = _aln(pkg, 11, [(7, "M")], "AAACCCC", reverse=True)
        assert [rp(r, p) for p in (0, 6)] == [17, 11]
        s = _aln(pkg, 11, [(2, "S"), (3, "M"), (1, "I"), (3, "M")], "GGAAATCCC")
        assert [rp(s, p) for p in range(9)] == [-1, -1, 11, 12, 13, -1, 14, 15, 16]


def test_forward_translation_keeps_ref():
    recs, stats = _translate("forward")
    assert stats.translated == 1 and stats.biallelic == 1
    v = recs[0].variant
    assert (v.sequence_name, v.first, v.alleles) == ("chr1", 13, ["G", "T"])
    assert recs[0].calls[0].indexes_called_alleles == [0, 1]
    assert recs[0].info["DENOVOCLUSTER"] == "c0"


def test_refbase_swap_when_consensus_carries_alt():
    recs, stats = _translate("swap")
    assert stats.translated == 1 and recs[0].variant.alleles == ["T", "G"]
    c = recs[0].calls[0]
    assert c.indexes_called_alleles == [1] and c.allele_copy_numbers == [0, 2]


def test_reverse_strand_flips_alleles_and_depths():
    recs, stats = _translate("reverse")
    assert stats.translated == 1
    assert (recs[0].variant.first, recs[0].variant.alleles) == (13, ["C", "T"])
    assert recs[0].calls[0].acgt_depths == [0, 6, 0, 4]


def test_triallelic_counted_and_dropped():
    recs, stats = _translate("triallelic")
    assert recs == [] and stats.triallelic == 1 and stats.untranslated == 1


def test_unmapped_and_stats_report():
    recs, stats = _translate("unmapped")
    assert recs == [] and stats.record_without_align == 1
    assert "Total number of records in relative VCF: 1" in stats.report()


def test_gbs_coordinate_translation():
    recs, stats = _translate("long_tail")
    assert stats.untranslated == 0 and stats.translated == 1
    assert (recs[0].variant.sequence_name, recs[0].variant.first) == ("chr2", 5009)


# ---- tests/test_uneak.py ----------------------------------------------------

def test_uneak_conversion(tmp_path):
    hap, fa = _uneak_inputs(tmp_path)
    for tag, mod in (("j", jun), ("t", tun)):
        assert mod.convert_uneak(hap, fa, str(tmp_path / tag)) == (2, 3)
    for suffix in (".vcf", "_consensus.fa"):
        assert (tmp_path / f"t{suffix}").read_text() == (tmp_path / f"j{suffix}").read_text()
    reader = tvcf.VCFFileReader(str(tmp_path / "t.vcf"))
    r1, r2 = reader.load_all()
    assert reader.sample_ids == ["S1", "S2", "S3"]
    assert (r1.variant.sequence_name, r1.variant.first, r1.variant.alleles) == ("TP1", 3, ["A", "G"])
    assert [c.indexes_called_alleles for c in r1.calls] == [[0, 0], [1, 1], [0, 1]]
    assert (r2.variant.first, r2.calls[0].is_undecided) == (5, True)
    assert [c.indexes_called_alleles for c in r2.calls[1:]] == [[0, 0], [1, 1]]
    fa_lines = (tmp_path / "t_consensus.fa").read_text().split()
    assert fa_lines == [">TP1", "TTACGT", ">TP2", "GGGGC"]


def test_uneak_cli_registered():
    import ngsepcore_tpu_torch.cli.commands  # noqa: F401  (populates registry)
    from ngsepcore_tpu_torch.cli.registry import get_command

    cmd = get_command("UneakToVCFConverter")
    assert cmd is not None and cmd.hidden and cmd.runner is not None
