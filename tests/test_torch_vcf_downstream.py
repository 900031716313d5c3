"""The port's VCF downstream layer, genome builders and their CLI against the
JAX package on the CPU (ROADMAP.md items 17a, 17b).

The cases of tests/test_vcf_analytics.py (9), test_vcf_converter.py (10),
test_popgen.py (4) and the builder and mask cases of
test_reads_processing.py run on the port with the JAX tests' own checks,
and each output is held against the JAX package's on the same input:
records, reports, Newick text and converter files identical (gzip files
compared decompressed: their header holds a time stamp); the distance
matrix identical bit for bit (float32 counts of 0/1 terms are exact);
r^2 within 1e-12 absolute (float64 products whose sums may take another
order).  Every CLI id of items 17a and 17b runs through both packages'
main() on one small population VCF, genome and SAM, and its files (or
standard output) are compared byte for byte."""
import gzip
import io
import os
import re

import numpy as np
import pytest
import torch

import ngsepcore_tpu.clustering.trees as jtrees
import ngsepcore_tpu.core.genome as jgenome
import ngsepcore_tpu.core.regions as jregions
import ngsepcore_tpu.core.sequences as jseq
import ngsepcore_tpu.genome.builders as jbuild
import ngsepcore_tpu.variants.model as jmodel
import ngsepcore_tpu.vcf.analytics as jan
import ngsepcore_tpu.vcf.converter as jconv
import ngsepcore_tpu.vcf.io as jio
import ngsepcore_tpu.vcf.popgen as jpop
import ngsepcore_tpu_torch.clustering.trees as ttrees
import ngsepcore_tpu_torch.core.genome as tgenome
import ngsepcore_tpu_torch.core.regions as tregions
import ngsepcore_tpu_torch.core.sequences as tseq
import ngsepcore_tpu_torch.genome.builders as tbuild
import ngsepcore_tpu_torch.variants.model as tmodel
import ngsepcore_tpu_torch.vcf.analytics as tan
import ngsepcore_tpu_torch.vcf.converter as tconv
import ngsepcore_tpu_torch.vcf.io as tio
import ngsepcore_tpu_torch.vcf.popgen as tpop
from ngsepcore_tpu.__main__ import main as jmain
from ngsepcore_tpu_torch.__main__ import main as tmain

torch.set_num_threads(1)

J = dict(model=jmodel, io=jio)
T = dict(model=tmodel, io=tio)


def _rec(pkg, pos, genotypes, alleles=("A", "C"), gq=60, seq="chr1", vtype="SNV",
         qual=100, samples=None):
    """tests/test_vcf_analytics.py's record, built with one package's classes."""
    calls = []
    for i, g in enumerate(genotypes):
        idxs = [] if g is None else ([0, 0] if g == 0 else [0, 1] if g == 1 else [1, 1])
        calls.append(
            pkg["model"].CalledGenomicVariant(
                sequence_name=seq, first=pos, alleles=list(alleles), variant_type=vtype,
                quality=qual, sample_id=(samples[i] if samples else f"s{i}"),
                indexes_called_alleles=idxs, genotype_quality=gq if g is not None else 0,
                total_read_depth=20,
            )
        )
    return pkg["io"].VCFRecord(variant=calls[0], calls=calls)


def _both(make):
    """The same records built once with each package's classes."""
    return make(J), make(T)


def _lines(records, samples):
    """VCF body lines of records, as the port's writer prints them."""
    buf = io.StringIO()
    w = tio.VCFFileWriter.__new__(tio.VCFFileWriter)
    w.fh, w.sample_ids = buf, list(samples)
    for r in records:
        w.write(r)
    return buf.getvalue().splitlines()


# ---- tests/test_vcf_analytics.py ------------------------------------------

def test_dosage_matrix():
    jr, tr = _both(lambda p: [_rec(p, 10, [0, 1, 2, None])])
    dos, samples = tan.dosage_matrix(tr)
    assert list(dos[0]) == [0, 1, 2, -1]
    assert samples == ["s0", "s1", "s2", "s3"]
    want, want_s = jan.dosage_matrix(jr)
    assert dos.dtype == want.dtype and np.array_equal(dos, want) and samples == want_s


def test_site_diversity():
    jr, tr = _both(lambda p: _rec(p, 10, [0, 1, 1, 2]))
    d = tan.site_diversity(tr)
    assert d.genotyped == 4
    assert abs(d.maf - 0.5) < 1e-12
    assert abs(d.observed_het - 0.5) < 1e-12
    assert abs(d.expected_het - 0.5) < 1e-12
    assert abs(d.f) < 1e-12
    assert vars(d) == vars(jan.site_diversity(jr))


def test_filter_by_maf_and_quality():
    def make(p):
        return [
            _rec(p, 10, [0, 0, 0, 1]),   # maf 1/8
            _rec(p, 20, [1, 1, 1, 1]),   # maf 0.5
            _rec(p, 30, [0, 0, 0, 0], qual=5),  # low site quality
        ]

    jr, tr = _both(make)
    kept = tan.VCFFilter(min_maf=0.2, min_quality=40).apply(tr)
    assert [r.variant.first for r in kept] == [20]
    want = jan.VCFFilter(min_maf=0.2, min_quality=40).apply(jr)
    samples = [c.sample_id for c in tr[0].calls]
    assert _lines(kept, samples) == _lines(want, samples)


def _report(calc_cls, pkg):
    calc = calc_cls()
    calc.process(_rec(pkg, 10, [0, 1], alleles=("A", "G")))  # transition
    calc.process(_rec(pkg, 20, [2, 2], alleles=("A", "T")))  # transversion
    buf = io.StringIO()
    calc.print_report(buf)
    return buf.getvalue()


def test_summary_stats():
    text = _report(tan.VCFSummaryStatisticsCalculator, T)
    assert "SNV\t2" in text
    assert "Ts/Tv\t1.0000" in text
    assert text == _report(jan.VCFSummaryStatisticsCalculator, J)


def test_variant_density():
    jr, tr = _both(lambda p: [_rec(p, 10, [1]), _rec(p, 99999, [1]), _rec(p, 100001, [1])])
    dens = tan.variant_density(tr, window=100000)
    assert dens == [("chr1", 1, 2), ("chr1", 100001, 1)]
    assert dens == jan.variant_density(jr, window=100000)


def test_distance_matrix_and_trees():
    def make(p):
        return [
            _rec(p, 10, [0, 0, 2, 2]),
            _rec(p, 20, [0, 0, 2, 2]),
            _rec(p, 30, [0, 1, 1, 2]),
            _rec(p, 40, [0, 0, 2, 2]),
        ]

    jr, tr = _both(make)
    dist, samples = tan.distance_matrix(tr, device="cpu")
    assert dist.shape == (4, 4)
    assert dist[0, 1] < dist[0, 2]  # s0,s1 similar; s0,s2 distant
    assert np.allclose(dist, dist.T)
    want, want_s = jan.distance_matrix(jr)
    assert dist.dtype == np.asarray(want).dtype == np.float32
    np.testing.assert_array_equal(dist, want)
    assert samples == want_s
    buf = io.StringIO()
    tan.write_distance_matrix(dist, samples, buf)
    jbuf = io.StringIO()
    jan.write_distance_matrix(want, want_s, jbuf)
    assert buf.getvalue() == jbuf.getvalue()
    buf.seek(0)
    d2, names2 = tan.load_distance_matrix(buf)
    assert np.allclose(d2, dist, atol=1e-6)
    nwk = ttrees.neighbor_joining(dist, samples).to_newick()
    assert nwk.endswith(";") and all(s in nwk for s in samples)
    assert nwk == jtrees.neighbor_joining(want, want_s).to_newick()
    nwk2 = ttrees.upgma(dist, samples).to_newick()
    assert all(s in nwk2 for s in samples)
    assert nwk2 == jtrees.upgma(want, want_s).to_newick()


def test_nj_recovers_clades():
    # two clear pairs: (a,b) and (c,d)
    dist = np.array(
        [
            [0.0, 0.1, 1.0, 1.0],
            [0.1, 0.0, 1.0, 1.0],
            [1.0, 1.0, 0.0, 0.1],
            [1.0, 1.0, 0.1, 0.0],
        ]
    )
    nwk = ttrees.neighbor_joining(dist, ["a", "b", "c", "d"]).to_newick()
    assert nwk == jtrees.neighbor_joining(dist, ["a", "b", "c", "d"]).to_newick()
    pair = re.findall(r"\(([a-d]):[\d.]+,([a-d]):[\d.]+\)", nwk)
    assert ("a", "b") in pair or ("b", "a") in pair or ("c", "d") in pair or ("d", "c") in pair


def test_compare_vcfs():
    ja, ta = _both(lambda p: [_rec(p, 10, [0, 1]), _rec(p, 20, [2, 2])])
    jb, tb = _both(lambda p: [_rec(p, 10, [0, 1]), _rec(p, 20, [2, 1]), _rec(p, 30, [1, 1])])
    res = tan.compare_vcfs(ta, tb)
    assert res.both_genotyped == 4
    assert res.concordant == 3
    assert res.only_second >= 1
    assert vars(res) == vars(jan.compare_vcfs(ja, jb))


def test_merge_vcfs():
    ja, ta = _both(lambda p: [_rec(p, 10, [1]), _rec(p, 20, [2])])
    jb, tb = _both(lambda p: [_rec(p, 20, [0]), _rec(p, 30, [1])])
    merged = tan.merge_vcfs([ta, tb], ["sampleA", "sampleB"])
    assert [r.variant.first for r in merged] == [10, 20, 30]
    r10 = merged[0]
    assert len(r10.calls) == 2
    assert not r10.calls[0].is_undecided
    assert r10.calls[1].is_undecided
    want = jan.merge_vcfs([ja, jb], ["sampleA", "sampleB"])
    assert _lines(merged, ["sampleA", "sampleB"]) == _lines(want, ["sampleA", "sampleB"])


# ---- tests/test_popgen.py -------------------------------------------------

def test_ld_perfect_and_none():
    g1 = [0, 0, 2, 2, 0, 2, 0, 2]
    g3 = [0, 2, 2, 0, 0, 2, 2, 0]  # orthogonal to g1
    jr, tr = _both(lambda p: [_rec(p, 100, g1), _rec(p, 200, g1), _rec(p, 300, g3)])
    r2, positions = tpop.ld_matrix(tr, device="cpu")
    assert abs(r2[0, 1] - 1.0) < 1e-9
    assert r2[0, 2] < 0.2
    want, want_pos = jpop.ld_matrix(jr)
    assert positions == want_pos
    np.testing.assert_allclose(r2, want, rtol=0, atol=1e-12)


def test_ld_matrix_random_population_within_rounding_of_jax():
    """r^2 of 30 random sites over 25 samples with missing calls: within
    1e-12 absolute of the JAX package's."""
    rng = np.random.default_rng(5)
    geno = rng.integers(0, 3, size=(30, 25)).tolist()
    geno = [[None if rng.random() < 0.1 else g for g in row] for row in geno]
    jr, tr = _both(lambda p: [_rec(p, 100 * (i + 1), g) for i, g in enumerate(geno)])
    r2, _ = tpop.ld_matrix(tr, device="cpu")
    want, _ = jpop.ld_matrix(jr)
    np.testing.assert_allclose(r2, want, rtol=0, atol=1e-12)
    pairs = tpop.ld_pairs(tr, max_distance=500, min_r2=0.01, device="cpu")
    want_pairs = jpop.ld_pairs(jr, max_distance=500, min_r2=0.01)
    assert [(p.pos1, p.pos2) for p in pairs] == [(p.pos1, p.pos2) for p in want_pairs]


def test_allele_sharing_groups():
    samples = ["a1", "a2", "b1", "b2"]
    groups = {"a1": "A", "a2": "A", "b1": "B", "b2": "B"}
    jr, tr = _both(lambda p: [_rec(p, 1000 * i, [0, 0, 2, 2], samples=samples)
                              for i in range(1, 11)])
    stats = tpop.allele_sharing_stats(tr, groups)
    assert stats
    s = stats[0]
    assert s["between"] > 0.9
    assert s["within_a"] < 0.1 and s["within_b"] < 0.1
    assert stats == jpop.allele_sharing_stats(jr, groups)


def test_introgression_detects_migrant_window():
    samples = ["a1", "a2", "a3", "b1", "b2", "b3"]
    groups = {s: ("A" if s.startswith("a") else "B") for s in samples}
    jr, tr = _both(lambda p: [_rec(p, i * 1000, [0, 0, 2, 2, 2, 2], samples=samples)
                              for i in range(1, 21)])
    hits = tpop.introgression_analysis(tr, groups, window=100000, min_diff_af=0.6)
    names = {h["sample"] for h in hits}
    assert "a3" in names
    assert "a1" not in names and "b1" not in names
    assert hits == jpop.introgression_analysis(jr, groups, window=100000, min_diff_af=0.6)


def test_relative_allele_counts():
    depths = [(10, 10), (15, 5), (20, 0), (9, 11)]
    hist = tpop.relative_allele_counts(depths)
    assert hist[10] == 1  # (10,10) at 0.5
    assert hist[9] == 1   # (9,11) -> 0.45
    assert hist[5] == 1   # (15,5) -> 0.25
    assert hist[0] == 1   # (20,0) monomorphic
    np.testing.assert_array_equal(hist, jpop.relative_allele_counts(depths))


# ---- tests/test_vcf_converter.py ------------------------------------------

def _conv_records(pkg):
    recs = []
    for pos, genos in [(100, [0, 1, 2]), (200, [2, 2, 0]), (300, [1, None, 0])]:
        calls = []
        for i, g in enumerate(genos):
            idxs = [] if g is None else ([0, 0] if g == 0 else [0, 1] if g == 1 else [1, 1])
            calls.append(
                pkg["model"].CalledGenomicVariant(
                    sequence_name="chr1", first=pos, alleles=["A", "G"],
                    sample_id=f"s{i}", indexes_called_alleles=idxs,
                )
            )
        recs.append(pkg["io"].VCFRecord(variant=calls[0], calls=calls))
    return recs


def _read(path):
    """A file's bytes; a gzip file's decompressed bytes."""
    if str(path).endswith(".gz"):
        with gzip.open(path, "rb") as fh:
            return fh.read()
    with open(path, "rb") as fh:
        return fh.read()


def _files_equal(jdir, tdir):
    """Every file of the two directories has the same name and content."""
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    for name in names:
        assert _read(os.path.join(tdir, name)) == _read(os.path.join(jdir, name)), name
    return names


POPS = {"s0": "p1", "s1": "p1", "s2": "p2"}


def test_all_converters_produce_output(tmp_path):
    assert list(tconv.CONVERTERS) == list(jconv.CONVERTERS)
    assert list(tconv.POPULATION_CONVERTERS) == list(jconv.POPULATION_CONVERTERS)
    out = {}
    for tag, conv, pkg in (("j", jconv, J), ("t", tconv, T)):
        d = tmp_path / tag
        d.mkdir()
        recs = _conv_records(pkg)
        for name, fn in conv.CONVERTERS.items():
            fn(recs, str(d / name))
            produced = [p for p in d.iterdir() if p.name.startswith(name)]
            assert produced, f"{name} produced no files"
            for p in produced:
                assert p.stat().st_size > 0, f"{name}: {p.name} empty"
        for name, fn in conv.POPULATION_CONVERTERS.items():
            fn(recs, POPS, str(d / name))
        conv.convert_joinmap(recs, str(d / "jm"), parent1="s0", parent2="s1")
        conv.convert_finestructure(recs, str(d / "fs"))
        out[tag] = d
    names = _files_equal(out["j"], out["t"])
    assert len(names) >= 19


def _convert(tmp_path, fmt, prefix="o", **kw):
    recs = _conv_records(T)
    fn = getattr(tconv, fmt) if fmt.startswith("convert_") else tconv.CONVERTERS[fmt]
    fn(recs, str(tmp_path / prefix), **kw)
    return recs


def test_plink_ped_contents(tmp_path):
    _convert(tmp_path, "Plink", "out")
    ped = (tmp_path / "out.ped").read_text().splitlines()
    assert len(ped) == 3
    f0 = ped[0].split("\t")
    assert f0[6:8] == ["A", "A"]  # s0 at pos100: hom ref
    assert f0[8:10] == ["G", "G"]  # s0 at pos200: hom alt
    mapf = (tmp_path / "out.map").read_text().splitlines()
    assert len(mapf) == 3


def test_fasta_iupac(tmp_path):
    _convert(tmp_path, "Fasta")
    text = (tmp_path / "o_aln.fa").read_text()
    assert ">s0\nAGR" in text


def test_treemix_counts(tmp_path):
    tconv.POPULATION_CONVERTERS["TreeMix"](_conv_records(T), POPS, str(tmp_path / "t"))
    with gzip.open(tmp_path / "t_treemix.txt.gz", "rt") as fh:
        lines = fh.read().splitlines()
    assert lines[0].split() == ["p1", "p2"]
    assert lines[1].split() == ["3,1", "0,2"]


def test_gwaspoly_contents(tmp_path):
    _convert(tmp_path, "GWASPoly", "g")
    lines = (tmp_path / "g_GWASPoly.csv").read_text().splitlines()
    assert lines[0] == "Marker,Chrom,Position,s0,s1,s2"
    assert lines[1] == "1,chr1,100,AA,AG,GG"
    assert lines[3].endswith("AG,NA,AA")


def test_spagedi_contents(tmp_path):
    _convert(tmp_path, "Spagedi", "sp")
    lines = (tmp_path / "sp_spagedi.in").read_text().splitlines()
    assert lines[0] == "3\t0\t0\t3\t1\t2"
    assert lines[-1] == "END"
    s1 = [line for line in lines if line.startswith("s1\t")][0]
    assert s1 == "s1\t1,2\t2,2\t0,0"


def test_powermarker_contents(tmp_path):
    _convert(tmp_path, "PowerMarker", "pm")
    snp = (tmp_path / "pm_powermarker.snp").read_text().splitlines()
    assert snp == ["1\tchr1\t100", "2\tchr1\t200", "3\tchr1\t300"]
    rows = (tmp_path / "pm_powermarker.in").read_text().splitlines()
    s2 = [line for line in rows if line.startswith("s2\t")][0]
    assert s2 == "s2\t1\t1\t0\t0\t0\t0"


def test_joinmap_contents(tmp_path):
    _convert(tmp_path, "convert_joinmap", "jm", parent1="s0", parent2="s1")
    lines = (tmp_path / "jm_joinmap.txt").read_text().splitlines()
    assert lines[0].startswith("SNPID\tSegregation\tClasification\ts0\ts1\ts2")
    l100 = [line for line in lines if line.startswith("chr1_100")][0]
    assert "<nnxnp>" in l100 and l100.split("\t")[3:] == ["nn", "np", "--"]
    assert not any(line.startswith("chr1_200") for line in lines)
    assert not any(line.startswith("chr1_300") for line in lines)


def test_finestructure_contents(tmp_path):
    _convert(tmp_path, "convert_finestructure", "fs")
    lines = (tmp_path / "fs_fineStructure.phase").read_text().splitlines()
    assert lines[:5] == ["6", "3", "P 100 200 300", "010", "011"]


def test_haploview_contents(tmp_path):
    _convert(tmp_path, "Haploview", "hv")
    info = (tmp_path / "hv_haploview.info").read_text().splitlines()
    assert info[0] == "chr1_100\t100"
    ped = (tmp_path / "hv_haploview.ped").read_text().splitlines()
    assert len(ped) == 3


# ---- tests/test_reads_processing.py: the genome builders --------------------

def _genome(seq_mod, genome_mod, text):
    return genome_mod.ReferenceGenome(
        seq_mod.QualifiedSequenceList([seq_mod.QualifiedSequence.from_string("chr1", text)])
    )


def test_individual_genome_builder():
    def recs(pkg):
        call = pkg["model"].CalledGenomicVariant(
            sequence_name="chr1", first=3, alleles=["A", "G"], indexes_called_alleles=[1, 1])
        call2 = pkg["model"].CalledGenomicVariant(
            sequence_name="chr1", first=6, alleles=["CC", "C"], indexes_called_alleles=[1, 1])
        return [pkg["io"].VCFRecord(variant=c, calls=[c]) for c in (call, call2)]

    seqs = tbuild.build_individual_genome(_genome(tseq, tgenome, "AAAAACCCCC"), recs(T))
    assert seqs[0].characters == "AAGAACCCC"
    want = jbuild.build_individual_genome(_genome(jseq, jgenome, "AAAAACCCCC"), recs(J))
    assert [s.characters for s in seqs] == [s.characters for s in want]


def test_genome_mask():
    masked = tbuild.mask_genome_regions(
        _genome(tseq, tgenome, "ACGTACGTAC"), [tregions.GenomicRegion("chr1", 3, 5)])
    assert masked[0].characters == "ACNNNCGTAC"
    want = jbuild.mask_genome_regions(
        _genome(jseq, jgenome, "ACGTACGTAC"), [jregions.GenomicRegion("chr1", 3, 5)])
    assert masked[0].characters == want[0].characters


def test_region_collection_spanning_queries_equal_jax():
    """GenomicRegionSortedCollection (VCFFilter's -frs/-srs) against the JAX
    package's on random regions and queries."""
    rng = np.random.default_rng(3)
    regions = [(f"chr{rng.integers(1, 3)}", int(a), int(a + rng.integers(0, 300)))
               for a in rng.integers(1, 5000, size=60)]
    colls = []
    for mod in (jregions, tregions):
        coll = mod.GenomicRegionSortedCollection()
        coll.add_all(mod.GenomicRegion(*r) for r in regions)
        colls.append(coll)
    key = lambda rs: [r.span_key() for r in rs]
    assert key(colls[1].as_list()) == key(colls[0].as_list()) and len(colls[1]) == 60
    for q in rng.integers(1, 5400, size=40):
        for name in ("chr1", "chr2", "chr3"):
            got = colls[1].find_spanning(name, int(q), int(q) + 50)
            assert key(got) == key(colls[0].find_spanning(name, int(q), int(q) + 50))


# ---- the CLI of items 17a and 17b -----------------------------------------

def _write_cli_inputs(d):
    """A 2 x 3 kb genome, a 12-sample population VCF over it (40 SNVs with
    missing calls, GQ and DP, an indel and a multi-allelic SNV), two
    single-sample VCFs, a SAM of reads with two alleles at some sites,
    region, group and population files."""
    rng = np.random.default_rng(17)
    seqs = {name: "".join(rng.choice(list("ACGT"), size=3000)) for name in ("chr1", "chr2")}
    with open(d / "g.fa", "w") as fh:
        for name, s in seqs.items():
            fh.write(f">{name}\n{s}\n")
    samples = [f"s{i}" for i in range(12)]
    records = []
    for name in ("chr1", "chr2"):
        for pos in sorted(rng.choice(np.arange(150, 2850), size=20, replace=False)):
            ref = seqs[name][pos - 1]
            alt = "ACGT"[("ACGT".index(ref) + int(rng.integers(1, 4))) % 4]
            records.append((name, int(pos), [ref, alt], "SNV"))
    records.insert(5, ("chr1", 1200, [seqs["chr1"][1199], "ACGTA"[:2]], "INDEL"))
    third = [b for b in "ACGT" if b not in records[7][2]][0]
    records[7] = records[7][:2] + (records[7][2] + [third], "MULTISNV")
    with jio.VCFFileWriter(str(d / "pop.vcf"), samples) as w:
        for name, pos, alleles, vtype in records:
            calls = []
            for s in samples:
                g = int(rng.integers(0, 3))
                missing = rng.random() < 0.15
                idxs = [] if missing else [[0, 0], [0, 1], [1, 1]][g]
                calls.append(jmodel.CalledGenomicVariant(
                    sequence_name=name, first=pos, alleles=list(alleles), variant_type=vtype,
                    quality=int(rng.integers(10, 100)), sample_id=s,
                    indexes_called_alleles=idxs, genotype_quality=int(rng.integers(5, 99)),
                    total_read_depth=int(rng.integers(1, 40)),
                ))
            w.write(jio.VCFRecord(variant=calls[0], calls=calls))
    for k, s in enumerate(("x1", "x2")):
        with jio.VCFFileWriter(str(d / f"{s}.vcf"), [s]) as w:
            for name, pos, alleles, vtype in records[k::2][:15]:
                c = jmodel.CalledGenomicVariant(
                    sequence_name=name, first=pos, alleles=list(alleles), variant_type=vtype,
                    quality=50, sample_id=s, indexes_called_alleles=[0, 1], genotype_quality=40,
                )
                w.write(jio.VCFRecord(variant=c, calls=[c]))
    (d / "regions.txt").write_text("chr1\t100\t900\nchr2\t2000\t2600\n")
    (d / "groups.txt").write_text("".join(f"{s}\t{'A' if i < 6 else 'B'}\n"
                                          for i, s in enumerate(samples)))
    # reads of 60 bp: every third carries a substitution at its 20th base
    lines = ["@HD\tVN:1.6\tSO:coordinate"]
    lines += [f"@SQ\tSN:{n}\tLN:{len(s)}" for n, s in seqs.items()]
    for i, start in enumerate(range(101, 2800, 7)):
        read = list(seqs["chr1"][start - 1 : start + 59])
        if i % 3 == 0:
            read[19] = "ACGT"[("ACGT".index(read[19]) + 1) % 4]
        lines.append(f"r{i}\t0\tchr1\t{start}\t60\t60M\t*\t0\t0\t{''.join(read)}\t{'I' * 60}")
    (d / "alns.sam").write_text("\n".join(lines) + "\n")


# id -> (arguments with {d} the input directory and {o} the output prefix,
# output files relative to the prefix; "stdout" compares the printed text)
CLI_CASES = {
    "IndividualGenomeBuilder": ("{d}/g.fa {d}/x1.vcf {o}.fa", [".fa"]),
    "GenomeAssemblyMask": ("{d}/g.fa {d}/regions.txt {o}.fa", [".fa"]),
    "SingleReadsSimulator": ("{d}/g.fa {o}.fastq -n 40 -l 80 -s 9", [".fastq"]),
    "SingleIndividualSimulator": ("{d}/g.fa {o} -s 0.01 -i 0.002 -seed 4",
                                  ["_truth.vcf", "_hap0.fa", "_hap1.fa"]),
    "VCFFilter": ("-i {d}/pop.vcf -o {o}.vcf -q 20 -minMAF 0.1 -frs {d}/regions.txt -s", [".vcf"]),
    "VCFSummaryStats": ("-i {d}/pop.vcf -o {o}.txt", [".txt"]),
    "VCFDiversityStats": ("-i {d}/pop.vcf -o {o}.txt", [".txt"]),
    "VCFVariantDensityCalculator": ("-i {d}/pop.vcf -o {o}.txt -w 500", [".txt"]),
    "VCFDistanceMatrixCalculator": ("-i {d}/pop.vcf -o {o}.txt", [".txt"]),
    "NeighborJoining": ("-i {d}/dist.txt -o {o}.nwk", [".nwk"]),
    "DistanceClusteringService": ("-i {d}/dist.txt -o {o}.nwk -t UPGMA", [".nwk"]),
    "VCFComparator": ("{d}/pop.vcf {d}/x1.vcf", ["stdout"]),
    "VCFConverter": ("-i {d}/pop.vcf -o {o} -p {d}/groups.txt -p1 s0 -p2 s1 -f "
                     + ",".join(list(jconv.CONVERTERS) + list(jconv.POPULATION_CONVERTERS)
                                + ["JoinMap", "FineStructure"]), ["*"]),
    "VCFMerge": ("-o {o}.vcf {d}/x1.vcf {d}/x2.vcf", [".vcf"]),
    "MergeVariants": ("-o {o}.vcf {d}/x1.vcf {d}/x2.vcf {d}/pop.vcf", [".vcf"]),
    "RelativeAlleleCountsCalculator": ("-i {d}/alns.sam -o {o}.txt", [".txt"]),
    "VCFAlleleSharingStats": ("-i {d}/pop.vcf -g {d}/groups.txt -w 1000 -o {o}.txt", [".txt"]),
    "VCFIntrogressionAnalysis": ("-i {d}/pop.vcf -g {d}/groups.txt -w 1000 -o {o}.txt",
                                 [".txt"]),
}


@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("downstream")
    _write_cli_inputs(d)
    # the trees' input: the JAX package's distance matrix of the population
    jmain(["VCFDistanceMatrixCalculator", "-i", str(d / "pop.vcf"), "-o", str(d / "dist.txt")])
    return d


@pytest.mark.parametrize("cid", sorted(CLI_CASES))
def test_cli_outputs_equal_jax(cli_dir, cid, capsys):
    args, outs = CLI_CASES[cid]
    got = {}
    for tag, main, pre in (("j", jmain, []), ("t", tmain, ["--device", "cpu"])):
        out_dir = cli_dir / f"{cid}_{tag}"
        out_dir.mkdir()
        argv = args.format(d=cli_dir, o=out_dir / "out").split()
        capsys.readouterr()
        assert main(pre + [cid] + argv) == 0
        got[tag] = (out_dir, capsys.readouterr().out)
    if outs == ["stdout"]:
        assert got["t"][1] == got["j"][1] and "Concordance" in got["t"][1]
        return
    names = _files_equal(got["j"][0], got["t"][0])
    if outs == ["*"]:
        assert len(names) >= 19
    else:
        assert names == sorted("out" + o for o in outs)
    for name in names:
        assert os.path.getsize(got["t"][0] / name) > 0, name
